// VALID max pool, stride = window k, NHWC; the tail that does not fill a
// window is cropped (Ho = H / k).
//
// Replaces: src/repro/kernels/pool.py maxpool2d_fwd (_maxpool_fwd_kernel),
// the Pallas TPU kernel that crops, reshapes and reduces a batch block in
// VMEM.
//
// Bound on the H100: bytes.  It reads each input once and writes each output
// once with under one compare per byte, far below the fp32 ridge of
// 20 FLOP/byte; chaos-large's 22x22x60 pool moves 37 MB at B=256.
//
// Design: one thread per output element, channel fastest, so a warp reads
// and writes consecutive channels of one pixel (coalesced along C); the k*k
// window reads of neighbouring outputs share cache lines through L1/L2.  The
// max propagates NaN, as torch.amax and jnp.max do.
#include <cuda_runtime.h>

namespace {

__global__ void maxpool2d_fwd_kernel(const float* __restrict__ x,
                                     float* __restrict__ y, int H, int W,
                                     int C, int k, int Ho, int Wo,
                                     size_t total) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    size_t t = i / C;
    const int ox = (int)(t % Wo);
    t /= Wo;
    const int oy = (int)(t % Ho);
    const size_t n = t / Ho;
    const float* src = x + ((n * H + (size_t)oy * k) * W + (size_t)ox * k) * C + c;
    float m = src[0];
    for (int dy = 0; dy < k; ++dy) {
      for (int dx = 0; dx < k; ++dx) {
        const float v = src[((size_t)dy * W + dx) * C];
        if (v > m || v != v) m = v;
      }
    }
    y[i] = m;
  }
}

}  // namespace

extern "C" int repro_maxpool2d_fwd(const float* x, float* y, int B, int H,
                                   int W, int C, int k, void* stream) {
  const int Ho = H / k, Wo = W / k;
  const size_t total = (size_t)B * Ho * Wo * C;
  const int threads = 256;
  const size_t want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 65535 ? want : 65535);
  maxpool2d_fwd_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      x, y, H, W, C, k, Ho, Wo, total);
  return static_cast<int>(cudaGetLastError());
}
