// Fused backward of the fully connected layer y = act(x @ w + b): dx, dw
// and db from one launch, with the tanh derivative fused when the forward
// output y is given (dz = dy * (1 - y^2), else dz = dy), fp32 on CUDA
// cores.
//
// Replaces: src/repro/kernels/fc.py fc_bwd_fused (_fc_bwd_body,
// _fc_bwd_kernel, _fc_bwd_tanh_kernel), the Pallas TPU kernel that writes
// dx = dz @ w^T per batch block and sums dw = x^T @ dz and db = sum(dz)
// across the sequential batch grid in VMEM scratch.
//
// Bound on the H100: operations at chaos-large's 900 -> 150 layer (4 * B *
// Din * Dout = 138 MFLOP at B=256 against 3.2 MB), though at these sizes
// the launch itself takes longer than either bound.
//
// Design: one launch over a heterogeneous grid of 16x16-thread blocks, each
// a shared-memory tiled SIMT product: dx blocks own a 16x16 tile of dx and
// reduce over Dout; dw blocks own a 16x16 tile of dw and reduce over the
// batch in order; db blocks own 256 outputs and sum the batch in order.
// The ragged edges (900, 150 and 10 are not tile multiples) load zeros.
// Every sum runs in an order fixed by the shapes alone, with no atomics, so
// two runs give the same bits.  dz is recomputed where it is staged,
// rounded as dy * (1 - y*y) with no contraction, as the plain version
// rounds it.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;

struct Args {
  const float* x;
  const float* dy;
  const float* y;
  const float* w;
  float* dx;
  float* dw;
  float* db;
  int B, Din, Dout;
  int n_dx, n_dw;
};

__device__ __forceinline__ float dz_at(const Args& a, int b, int o) {
  const size_t i = (size_t)b * a.Dout + o;
  const float g = a.dy[i];
  if (a.y == nullptr) return g;
  const float v = a.y[i];
  return __fmul_rn(g, __fsub_rn(1.f, __fmul_rn(v, v)));
}

__global__ void __launch_bounds__(kThreads) fc_bwd_kernel(Args a) {
  __shared__ float s0[kTile][kTile + 1];
  __shared__ float s1[kTile][kTile + 1];
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;
  int bid = blockIdx.x;
  const int n_in_t = (a.Din + kTile - 1) / kTile;
  const int n_out_t = (a.Dout + kTile - 1) / kTile;
  if (bid < a.n_dx) {  // dx[b, i] = sum_o dz[b, o] * w[i, o]
    const int b0 = (bid / n_in_t) * kTile, i0 = (bid % n_in_t) * kTile;
    float acc = 0.f;
    for (int o0 = 0; o0 < a.Dout; o0 += kTile) {
      const int o = o0 + tx;
      s0[ty][tx] = (b0 + ty < a.B && o < a.Dout) ? dz_at(a, b0 + ty, o) : 0.f;
      s1[ty][tx] = (i0 + ty < a.Din && o < a.Dout)
                       ? a.w[(size_t)(i0 + ty) * a.Dout + o]
                       : 0.f;
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kTile; ++kk)
        acc = fmaf(s0[ty][kk], s1[tx][kk], acc);
      __syncthreads();
    }
    if (b0 + ty < a.B && i0 + tx < a.Din)
      a.dx[(size_t)(b0 + ty) * a.Din + i0 + tx] = acc;
    return;
  }
  bid -= a.n_dx;
  if (bid < a.n_dw) {  // dw[i, o] = sum_b x[b, i] * dz[b, o]
    const int i0 = (bid / n_out_t) * kTile, o0 = (bid % n_out_t) * kTile;
    float acc = 0.f;
    for (int b0 = 0; b0 < a.B; b0 += kTile) {
      const int b = b0 + ty;
      s0[ty][tx] = (b < a.B && i0 + tx < a.Din)
                       ? a.x[(size_t)b * a.Din + i0 + tx]
                       : 0.f;
      s1[ty][tx] = (b < a.B && o0 + tx < a.Dout) ? dz_at(a, b, o0 + tx) : 0.f;
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kTile; ++kk)
        acc = fmaf(s0[kk][ty], s1[kk][tx], acc);
      __syncthreads();
    }
    if (i0 + ty < a.Din && o0 + tx < a.Dout)
      a.dw[(size_t)(i0 + ty) * a.Dout + o0 + tx] = acc;
    return;
  }
  bid -= a.n_dw;  // db[o] = sum_b dz[b, o]
  const int o = bid * kThreads + threadIdx.x;
  if (o < a.Dout) {
    float acc = 0.f;
    for (int b = 0; b < a.B; ++b) acc += dz_at(a, b, o);
    a.db[o] = acc;
  }
}

}  // namespace

// y may be null (linear layer, no tanh factor).
extern "C" int repro_fc_bwd(const float* x, const float* dy, const float* y,
                            const float* w, float* dx, float* dw, float* db,
                            int B, int Din, int Dout, void* stream) {
  Args a;
  a.x = x; a.dy = dy; a.y = y; a.w = w; a.dx = dx; a.dw = dw; a.db = db;
  a.B = B; a.Din = Din; a.Dout = Dout;
  const int n_in_t = (Din + kTile - 1) / kTile;
  const int n_out_t = (Dout + kTile - 1) / kTile;
  a.n_dx = ((B + kTile - 1) / kTile) * n_in_t;
  a.n_dw = n_in_t * n_out_t;
  const int n_db = (Dout + kThreads - 1) / kThreads;
  fc_bwd_kernel<<<a.n_dx + a.n_dw + n_db, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
