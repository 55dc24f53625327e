// Backward of the VALID max pool with stride = window k, NHWC: dx from the
// saved input x, the saved output y and the upstream gradient dy.  The
// gradient of a window is split evenly over its tied maxima, and the
// cropped tail (rows and columns past Ho * k, Wo * k) gets 0.
//
// Replaces: src/repro/kernels/pool.py maxpool2d_bwd (_maxpool_bwd_kernel),
// the Pallas TPU kernel that builds the (x == y) mask of a batch block in
// VMEM, counts the ties per window and scatters mask * (dy / ties).
//
// Bound on the H100: bytes.  It reads x and writes dx once and reads y and
// dy once per window, with at most k*k compares per element; chaos-large's
// 22x22x60 pool moves about 74 MB at B=256.
//
// Design: one thread per input element, channel fastest, so a warp reads
// and writes consecutive channels (coalesced along C).  Each thread finds
// its window, compares its x with the window's y exactly, counts the ties
// among the window's k*k inputs and writes mask * (dy / ties) in the order
// the Pallas kernel computes it, with round-to-nearest intrinsics so that
// nothing is contracted: the result equals the plain version bit for bit.
#include <cuda_runtime.h>

namespace {

__global__ void maxpool2d_bwd_kernel(const float* __restrict__ x,
                                     const float* __restrict__ y,
                                     const float* __restrict__ dy,
                                     float* __restrict__ dx, int H, int W,
                                     int C, int k, int Ho, int Wo,
                                     size_t total) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    size_t t = i / C;
    const int col = (int)(t % W);
    t /= W;
    const int row = (int)(t % H);
    const size_t n = t / H;
    const int oy = row / k, ox = col / k;
    if (oy >= Ho || ox >= Wo) {  // the cropped tail
      dx[i] = 0.f;
      continue;
    }
    const size_t o = ((n * Ho + oy) * Wo + ox) * C + c;
    const float m = y[o];
    const float* src =
        x + ((n * H + (size_t)oy * k) * W + (size_t)ox * k) * C + c;
    float ties = 0.f;
    for (int wy = 0; wy < k; ++wy)
      for (int wx = 0; wx < k; ++wx)
        ties = __fadd_rn(ties, src[((size_t)wy * W + wx) * C] == m ? 1.f : 0.f);
    const float mask = x[i] == m ? 1.f : 0.f;
    dx[i] = __fmul_rn(mask, __fdiv_rn(dy[o], ties));
  }
}

}  // namespace

extern "C" int repro_maxpool2d_bwd(const float* x, const float* y,
                                   const float* dy, float* dx, int B, int H,
                                   int W, int C, int k, void* stream) {
  const int Ho = H / k, Wo = W / k;
  const size_t total = (size_t)B * H * W * C;
  const int threads = 256;
  const size_t want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 65535 ? want : 65535);
  maxpool2d_bwd_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      x, y, dy, dx, H, W, C, k, Ho, Wo, total);
  return static_cast<int>(cudaGetLastError());
}
