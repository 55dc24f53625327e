// Valid, stride-1 convolution NHWC x HWIO -> NHWC with an optional fused
// bias + tanh epilogue, fp32 on CUDA cores.
//
// Replaces: src/repro/kernels/conv2d.py conv2d_fwd (_conv_fwd_kernel), the
// Pallas TPU forward conv that unrolls the KxK taps into MXU dots over a
// halo'd row slab held in VMEM.
//
// Bound on the H100: operations.  chaos-large at B=256 does 2*B*Ho*Wo*Cout*
// K*K*Cin = 3.7-4.0 GFLOP in each of its two inner layers against ~5-9 MB of
// activations, i.e. ~450-800 FLOP/byte, far above the fp32 ridge of
// 67 TFLOP/s / 3.35 TB/s = 20 FLOP/byte.  TF32 tensor cores would lose the
// digits that the parity tests hold, so the kernel stays in fp32 FMAs.
//
// Design: one block per (image, block of output rows).  The block copies the
// rb + K - 1 input rows it needs (the K - 1 row halo included) into shared
// memory once, so every input element is read from device memory about
// (rb + K - 1) / rb times instead of K*K*Cout times.  Threads are laid out
// (Cout lane) x (pixel group): a warp shares its pixels and spans Cout, so
// its shared-memory reads are broadcasts and its weight reads and output
// writes are coalesced along Cout.  Each thread keeps kPx output pixels in
// registers and reuses each weight it loads kPx times.  The weights stay in
// device memory (chaos-large's third conv holds 864 KB of them) and are read
// through the read-only cache, where a whole layer's weights stay resident.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPx = 4;  // output pixels per thread

__global__ void __launch_bounds__(kThreads)
conv2d_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, float* __restrict__ y,
                  int H, int W, int Cin, int K, int Cout, int rb, int act) {
  extern __shared__ float slab[];  // (rows + K - 1) x W x Cin of image n
  const int n = blockIdx.x;
  const int r0 = blockIdx.y * rb;
  const int Ho = H - K + 1, Wo = W - K + 1;
  const int rows = min(rb, Ho - r0);
  const int row_elems = W * Cin;
  const int slab_elems = (rows + K - 1) * row_elems;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  const float* xs = x + ((size_t)n * H + r0) * row_elems;
  for (int i = tid; i < slab_elems; i += nthreads) slab[i] = xs[i];
  __syncthreads();

  const int npix = rows * Wo;
  float* yb = y + ((size_t)n * Ho + r0) * Wo * Cout;
  for (int co0 = 0; co0 < Cout; co0 += blockDim.x) {
    const int co = co0 + threadIdx.x;
    if (co >= Cout) continue;
    const float bias = b ? b[co] : 0.f;
    for (int p0 = threadIdx.y * kPx; p0 < npix; p0 += blockDim.y * kPx) {
      int base[kPx];
      float acc[kPx];
#pragma unroll
      for (int j = 0; j < kPx; ++j) {
        const int p = min(p0 + j, npix - 1);  // tail lanes recompute the last
        base[j] = ((p / Wo) * W + p % Wo) * Cin;
        acc[j] = 0.f;
      }
      for (int kh = 0; kh < K; ++kh) {
        for (int kw = 0; kw < K; ++kw) {
          const float* wt = w + (size_t)(kh * K + kw) * Cin * Cout + co;
          const int off = (kh * W + kw) * Cin;
          for (int ci = 0; ci < Cin; ++ci) {
            const float wv = __ldg(wt + (size_t)ci * Cout);
#pragma unroll
            for (int j = 0; j < kPx; ++j)
              acc[j] = fmaf(slab[base[j] + off + ci], wv, acc[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kPx; ++j) {
        if (p0 + j < npix) {
          float v = acc[j] + bias;
          if (act) v = tanhf(v);
          yb[(size_t)(p0 + j) * Cout + co] = v;
        }
      }
    }
  }
}

}  // namespace

// act: 0 = none, 1 = tanh.  b may be null (no bias).  rb output rows per
// block; the caller keeps (rb + K - 1) * W * Cin floats within 48 KB.
extern "C" int repro_conv2d_fwd(const float* x, const float* w,
                                const float* b, float* y, int B, int H, int W,
                                int Cin, int K, int Cout, int rb, int act,
                                void* stream) {
  const int Ho = H - K + 1;
  const int cb = Cout > 16 ? 32 : (Cout > 8 ? 16 : 8);
  const dim3 block(cb, kThreads / cb);
  const dim3 grid(B, (Ho + rb - 1) / rb);
  const size_t smem = (size_t)(rb + K - 1) * W * Cin * sizeof(float);
  conv2d_fwd_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w, b, y, H, W, Cin, K, Cout, rb, act);
  return static_cast<int>(cudaGetLastError());
}
