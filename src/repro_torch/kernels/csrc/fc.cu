// Fully connected layer y = act(x @ w + b), x (B, Din), w (Din, Dout), fp32
// on CUDA cores, with the bias and the optional tanh in the epilogue.
//
// Replaces: src/repro/kernels/fc.py fc_fwd (_fc_fwd_kernel), the Pallas TPU
// kernel that runs one MXU dot per (batch block, Dout block) with an fp32
// accumulator and a fused bias + tanh epilogue.
//
// Bound on the H100: the chain of each output.  chaos-large's 900 -> 150
// layer at B=256 does 69 MFLOP on 1.5 MB, about a microsecond of either
// operations or bytes; but every output is one thread's fmaf chain of 900
// dependent steps, each fed by shared loads, and the order of that chain is
// what keeps the outputs' bits.
//
// Design: a register-tiled GEMM fed by a deep cp.async ring.  A block of 64
// threads computes a 16 x 16 tile of y; each thread holds 4 rows of one
// column, reads the 4 rows of x as one float4 from shared memory (x's chunk
// is stored k-major) and w's entry as one float, so two shared loads feed 4
// FMAs per k.  Few outputs a thread keep each step of the chain short, and
// the 4 independent chains hide one another's FMA latency.  Small tiles
// spread chaos-large's 256 x 150 over 160 blocks.  The reduction is walked
// in chunks of 16 entries, kStagesFc chunks in shared memory: the copies of
// 11 chunks are in flight while one is multiplied, with one barrier per
// chunk (a chunk is a few hundred cycles of work; fewer stages left the
// copies' latency exposed on the card).
//
// Bits: every output is one thread's fmaf(x, w, acc) chain over k = 0 ...
// in order from 0, then + bias (+0 without one), then tanhf: the parent
// kernel's order.  Copies outside x and w are zero-filled, and chunks of 16
// pad Din to the parent's tile multiple with the same fmaf(0, 0, acc) steps,
// so the outputs equal the parent's bit for bit.  The reduction is not
// split: split-K would change the bits.
//
// The loop is this file's own and not conv2d_common.cuh's tile_loop: that
// loop reads float4 from both tiles (4 columns a thread at least) and double-
// buffers, while the FC's chain wants one column a thread and a deep ring.
// Only the header's cp.async helpers are shared, so the conv kernels' code
// does not move.
#include <cuda_runtime.h>

#include "conv2d_common.cuh"

namespace {

constexpr int kBMFc = 16, kBNFc = 16;  // a block's tile of y
constexpr int kTMFc = 4;               // rows a thread holds
constexpr int kBKFc = 16;              // reduction entries per chunk
constexpr int kStagesFc = 12;          // chunks in shared memory
constexpr int kThreadsFc = kBMFc / kTMFc * kBNFc;  // 64

struct __align__(16) FcSmem {
  float x[kStagesFc][kBKFc][kBMFc + 4];  // k-major; rows 16-byte aligned
  float w[kStagesFc][kBKFc][kBNFc];
};

// Copy chunk c of the block's rows of x and columns of w into stage st.
// Consecutive threads copy consecutive k of one row of x (and consecutive
// columns of one row of w), so the global reads are coalesced.
__device__ __forceinline__ void load_chunk(FcSmem& sm, int st, int c,
                                           const float* __restrict__ x,
                                           const float* __restrict__ w,
                                           int m0, int n0, int B, int Din,
                                           int Dout) {
  const int k0 = c * kBKFc;
#pragma unroll
  for (int i = 0; i < kBMFc * kBKFc / kThreadsFc; ++i) {
    const int e = threadIdx.x + i * kThreadsFc;
    const int m = e / kBKFc, kk = e % kBKFc;
    const bool ok = m0 + m < B && k0 + kk < Din;
    cp_async4(&sm.x[st][kk][m],
              ok ? x + (size_t)(m0 + m) * Din + k0 + kk : x, ok);
  }
#pragma unroll
  for (int i = 0; i < kBKFc * kBNFc / kThreadsFc; ++i) {
    const int e = threadIdx.x + i * kThreadsFc;
    const int kk = e / kBNFc, n = e % kBNFc;
    const bool ok = k0 + kk < Din && n0 + n < Dout;
    cp_async4(&sm.w[st][kk][n],
              ok ? w + (size_t)(k0 + kk) * Dout + n0 + n : w, ok);
  }
}

// Wait until at most kStagesFc - 2 groups of copies are in flight.
__device__ __forceinline__ void cp_async_wait_fc() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStagesFc - 2));
}

// Row blocks on grid.x, column blocks on grid.y.  Chunk c lands in stage
// c % kStagesFc; before chunk c is multiplied, the copies of chunk c +
// kStagesFc - 1 start, into the stage every thread finished with before
// this iteration's barrier.
__global__ void __launch_bounds__(kThreadsFc)
    fc_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, float* __restrict__ y, int B,
                  int Din, int Dout, int act) {
  __shared__ FcSmem sm;
  const int m0 = blockIdx.x * kBMFc, n0 = blockIdx.y * kBNFc;
  const int tc = threadIdx.x % kBNFc, tr = threadIdx.x / kBNFc;
  const int nchunks = (Din + kBKFc - 1) / kBKFc;
  float acc[kTMFc] = {0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < kStagesFc - 1; ++c) {
    if (c < nchunks) load_chunk(sm, c, c, x, w, m0, n0, B, Din, Dout);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait_fc();
    __syncthreads();
    const int nc = c + kStagesFc - 1;
    if (nc < nchunks)
      load_chunk(sm, nc % kStagesFc, nc, x, w, m0, n0, B, Din, Dout);
    cp_async_commit();
    const int st = c % kStagesFc;
#pragma unroll
    for (int k = 0; k < kBKFc; ++k) {
      const float4 a =
          *reinterpret_cast<const float4*>(&sm.x[st][k][kTMFc * tr]);
      const float v = sm.w[st][k][tc];
      acc[0] = fmaf(a.x, v, acc[0]);
      acc[1] = fmaf(a.y, v, acc[1]);
      acc[2] = fmaf(a.z, v, acc[2]);
      acc[3] = fmaf(a.w, v, acc[3]);
    }
  }
  const int col = n0 + tc;
  if (col >= Dout) return;
  const float bias = b ? b[col] : 0.f;
#pragma unroll
  for (int i = 0; i < kTMFc; ++i) {
    const int row = m0 + kTMFc * tr + i;
    if (row < B) {
      float v = acc[i] + bias;
      if (act) v = tanhf(v);
      y[(size_t)row * Dout + col] = v;
    }
  }
}

}  // namespace

// act: 0 = none, 1 = tanh.  b may be null (no bias).
extern "C" int repro_fc_fwd(const float* x, const float* w, const float* b,
                            float* y, int B, int Din, int Dout, int act,
                            void* stream) {
  const dim3 grid((B + kBMFc - 1) / kBMFc, (Dout + kBNFc - 1) / kBNFc);
  fc_fwd_kernel<<<grid, kThreadsFc, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, b, y, B, Din, Dout, act);
  return static_cast<int>(cudaGetLastError());
}
