// Per-sample softmax cross-entropy and its logits gradient in one pass:
// loss_i = logsumexp(l_i) - l_i[label_i], dlogits_i = softmax(l_i) -
// onehot(label_i), max-subtracted, fp32.
//
// Replaces: src/repro/kernels/fc.py softmax_xent_fwd (_softmax_xent_kernel),
// the Pallas TPU kernel that produces both outputs from one VMEM residency
// of a batch block of logits.
//
// Bound on the H100: bytes.  (B, C) logits in, (B,) loss and (B, C)
// dlogits out, a handful of operations per element; at B=256, C=10 it moves
// 21 KB and launch latency is all that is left.
//
// Design: one warp per row.  Lanes stride over the classes, and the max, the
// exp-sum and the picked logit are combined across the warp with shuffles,
// so no shared memory and no second pass over device memory.  A label
// outside [0, C) matches no class (loss = logsumexp, no -1 in dlogits), as
// the onehot of the Pallas kernel does.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__global__ void softmax_xent_fwd_kernel(const float* __restrict__ logits,
                                        const int* __restrict__ labels,
                                        float* __restrict__ loss,
                                        float* __restrict__ dl, int B,
                                        int C) {
  const int row = (int)(((size_t)blockIdx.x * blockDim.x + threadIdx.x) / 32);
  const int lane = threadIdx.x % 32;
  if (row >= B) return;  // whole warps leave together
  const float* l = logits + (size_t)row * C;
  const int lab = labels[row];

  float m = -INFINITY;
  for (int c = lane; c < C; c += 32) m = fmaxf(m, l[c]);
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));

  float s = 0.f, picked = 0.f;
  for (int c = lane; c < C; c += 32) {
    s += expf(l[c] - m);
    if (c == lab) picked += l[c];
  }
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(kFull, s, off);
    picked += __shfl_xor_sync(kFull, picked, off);
  }
  if (lane == 0) loss[row] = (logf(s) + m) - picked;
  for (int c = lane; c < C; c += 32)
    dl[(size_t)row * C + c] = expf(l[c] - m) / s - (c == lab ? 1.f : 0.f);
}

}  // namespace

extern "C" int repro_softmax_xent_fwd(const float* logits, const int* labels,
                                      float* loss, float* dl, int B, int C,
                                      void* stream) {
  const int threads = 256;  // 8 rows per block
  const int blocks = (int)(((size_t)B * 32 + threads - 1) / threads);
  softmax_xent_fwd_kernel<<<blocks, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      logits, labels, loss, dl, B, C);
  return static_cast<int>(cudaGetLastError());
}
