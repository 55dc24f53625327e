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
// 22.5 KB (6.7 ns at 3.35 TB/s), so what is left is the launch, one round
// trip to memory and the chain of dependent steps between them.
//
// Design: a lane per class.  For C <= 16, every model's case
// (softmax_xent_lanes_kernel), a row takes 16 lanes, two rows a warp; each
// lane loads its logit once, beside the row's label, takes exp once and
// keeps it for dlogits, and the max, the exp-sum and the picked logit are
// combined over the 16 lanes with xor shuffles (offsets 8, 4, 2, 1).  Past
// 16 classes a warp takes a row and its lanes stride over the classes
// (softmax_xent_warp_kernel), which reads each logit three times and takes
// exp twice.  For C <= 16 both give the same bits: lane j's partials are
// fmaxf(-inf, l_j), 0 + e_j and 0 + l_j at the label (-inf, 0, 0 past C),
// combined by the xor tree with offsets 16, 8, 4, 2, 1.  The warp kernel's
// first step, offset 16, only meets lanes past C: fmaxf(m, -inf) = m (m is
// no NaN), and s + 0 = s (s is no -0; a NaN stays a NaN, and the card
// returns one NaN), so the lanes kernel leaves it out.  Every lane ends with
// lane 0's sums (a + b = b + a, and fmaxf only differs in the sign of a zero
// m, which reaches no output: l - m and exp give the same bits for either
// sign, and log(s) + m = log(s) when m is a zero).  A label outside [0, C)
// matches no class (loss = logsumexp, no -1 in dlogits), as the onehot of
// the Pallas kernel does.  expf, logf and IEEE division, nothing contracted.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLanes = 16;    // a row of the lanes kernel, C <= 16
constexpr int kThreads = 64;  // a block of the lanes kernel: 4 rows

// 16 lanes a row, one class a lane.  Rows past B run the shuffles with no
// loads or stores, so every lane of a warp takes part.
__global__ void __launch_bounds__(kThreads)
    softmax_xent_lanes_kernel(const float* __restrict__ logits,
                              const int* __restrict__ labels,
                              float* __restrict__ loss,
                              float* __restrict__ dl, int B, int C) {
  const long long row =
      ((long long)blockIdx.x * kThreads + threadIdx.x) / kLanes;
  const int lane = threadIdx.x % kLanes;
  const bool live = row < B, mine = live && lane < C;
  const int lab = live ? __ldg(labels + row) : -1;
  const float x = mine ? __ldg(logits + row * C + lane) : 0.f;
  float m = mine ? fmaxf(-INFINITY, x) : -INFINITY;
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  const float e = mine ? expf(x - m) : 0.f;
  float s = mine ? 0.f + e : 0.f;
  float picked = mine && lane == lab ? 0.f + x : 0.f;
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    s += __shfl_xor_sync(kFull, s, off);
    picked += __shfl_xor_sync(kFull, picked, off);
  }
  if (live && lane == 0) loss[row] = (logf(s) + m) - picked;
  if (mine) dl[row * C + lane] = e / s - (lane == lab ? 1.f : 0.f);
}

// C > 16: one warp per row, lanes striding over the classes.
__global__ void softmax_xent_warp_kernel(const float* __restrict__ logits,
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= kLanes) {
    const int blocks =
        static_cast<int>(((long long)B * kLanes + kThreads - 1) / kThreads);
    softmax_xent_lanes_kernel<<<blocks, kThreads, 0, s>>>(logits, labels,
                                                          loss, dl, B, C);
  } else {
    const int threads = 256;  // 8 rows per block
    const int blocks = (int)(((size_t)B * 32 + threads - 1) / threads);
    softmax_xent_warp_kernel<<<blocks, threads, 0, s>>>(logits, labels, loss,
                                                        dl, B, C);
  }
  return static_cast<int>(cudaGetLastError());
}
