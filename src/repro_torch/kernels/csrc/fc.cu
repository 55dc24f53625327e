// Fully connected layer y = act(x @ w + b), x (B, Din), w (Din, Dout), fp32
// on CUDA cores, with the bias and the optional tanh in the epilogue.
//
// Replaces: src/repro/kernels/fc.py fc_fwd (_fc_fwd_kernel), the Pallas TPU
// kernel that runs one MXU dot per (batch block, Dout block) with an fp32
// accumulator and a fused bias + tanh epilogue.
//
// Bound on the H100: bytes at the Table-2 shapes.  chaos-large's 900 -> 150
// layer at B=256 does 69 MFLOP on 1.5 MB (45 FLOP/byte counted once each,
// near the fp32 ridge of 20 FLOP/byte) and finishes in about a microsecond
// either way; launch latency dominates both FC layers.
//
// Design: a classic shared-memory tiled SIMT GEMM.  A 16x16 block stages a
// 16x16 tile of x and of w per step of the contraction, each thread owns one
// output, and the ragged edges (900, 150 and 10 are not tile multiples) are
// masked by loading zeros.  The tile of x is padded by one column so the
// threads of a half-warp that read down its column hit distinct banks.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;

__global__ void fc_fwd_kernel(const float* __restrict__ x,
                              const float* __restrict__ w,
                              const float* __restrict__ b,
                              float* __restrict__ y, int B, int Din, int Dout,
                              int act) {
  __shared__ float xs[kTile][kTile + 1];
  __shared__ float ws[kTile][kTile];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int row = blockIdx.y * kTile + ty;
  const int col = blockIdx.x * kTile + tx;
  float acc = 0.f;
  for (int k0 = 0; k0 < Din; k0 += kTile) {
    xs[ty][tx] = (row < B && k0 + tx < Din) ? x[(size_t)row * Din + k0 + tx]
                                            : 0.f;
    ws[ty][tx] = (k0 + ty < Din && col < Dout)
                     ? w[(size_t)(k0 + ty) * Dout + col]
                     : 0.f;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTile; ++kk) acc = fmaf(xs[ty][kk], ws[kk][tx], acc);
    __syncthreads();
  }
  if (row < B && col < Dout) {
    float v = acc + (b ? b[col] : 0.f);
    if (act) v = tanhf(v);
    y[(size_t)row * Dout + col] = v;
  }
}

}  // namespace

// act: 0 = none, 1 = tanh.  b may be null (no bias).
extern "C" int repro_fc_fwd(const float* x, const float* w, const float* b,
                            float* y, int B, int Din, int Dout, int act,
                            void* stream) {
  const dim3 block(kTile, kTile);
  const dim3 grid((Dout + kTile - 1) / kTile, (B + kTile - 1) / kTile);
  fc_fwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, b, y, B, Din, Dout, act);
  return static_cast<int>(cudaGetLastError());
}
