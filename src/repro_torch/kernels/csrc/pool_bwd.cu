// Backward of the VALID max pool with stride = window k, NHWC: dx from the
// saved input x, the saved output y and the upstream gradient dy.  The
// gradient of a window is split evenly over its tied maxima, and the
// cropped tail (rows and columns past Ho * k, Wo * k) gets 0.
//
// Replaces: src/repro/kernels/pool.py maxpool2d_bwd (_maxpool_bwd_kernel),
// the Pallas TPU kernel that builds the (x == y) mask of a batch block in
// VMEM, counts the ties per window and scatters mask * (dy / ties).
//
// Bound on the H100: bytes.  x is read and dx written once, y and dy read
// once per window, with k*k compares and one division per window and
// channel; chaos-large's 22x22x60 pool moves about 74 MB at B=256.
//
// Design: one thread per (image, window, group of channels), channel groups
// fastest, so a warp reads and writes consecutive channels of one pixel
// (coalesced along C).  Its indices are decomposed once, in 32-bit
// arithmetic.  The thread reads its window's y and dy once, counts the ties
// over the window's k*k inputs, divides once, q = dy / ties, then reads the
// inputs again (from L1) and writes mask * q at each.  Windows at the right
// and bottom edges also write the cropped tail's zeros, coalesced along C.
// The vector instance takes 4 channels a thread as float4, where C % 4 == 0
// and every pointer is 16-byte aligned; the scalar instance takes one
// channel a thread otherwise.  The choice follows the shape and the
// pointers alone.  Ties are counted in the window's row-major order and
// every step is rounded to nearest (__fadd_rn, __fdiv_rn, __fmul_rn), so
// nothing is contracted and dx equals the plain version bit for bit.
//
// Offsets inside a launch are 32-bit, so tensors of 2^31 elements or more
// go in launches of whole images (one image must stay below that).
#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int V>
__device__ __forceinline__ void load(float (&v)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    p[0] = v[0];
}

// V channels a thread; windows = (images of the launch) * Ho * Wo * C / V.
template <int V>
__global__ void __launch_bounds__(kThreads)
    maxpool2d_bwd_kernel(const float* __restrict__ x,
                         const float* __restrict__ y,
                         const float* __restrict__ dy,
                         float* __restrict__ dx, int H, int W, int C, int k,
                         int Ho, int Wo, int windows) {
  const long long id = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (id >= windows) return;
  const int i = static_cast<int>(id), G = C / V;
  const int c = (i % G) * V;
  int t = i / G;
  const int ox = t % Wo;
  t /= Wo;
  const int oy = t % Ho, n = t / Ho;
  const int row0 = n * H + oy * k;  // the window's first row of x
  // The cropped tail first, so that its indices are dead by the divisions
  // (each a call on its slow path): the last window of a row of windows
  // zeroes the columns past Wo * k beside it, the last row of windows the
  // rows past Ho * k below it (and the corner, from the last window).
  float v[V];
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = 0.f;
  const bool right = ox == Wo - 1;
  if (right)
    for (int wy = 0; wy < k; ++wy)
      for (int cx = Wo * k; cx < W; ++cx)
        store<V>(dx + ((row0 + wy) * W + cx) * C + c, v);
  if (oy == Ho - 1)
    for (int r = Ho * k; r < H; ++r)
      for (int cx = ox * k; cx < (right ? W : ox * k + k); ++cx)
        store<V>(dx + ((n * H + r) * W + cx) * C + c, v);
  const int at = (row0 * W + ox * k) * C + c;
  float m[V], q[V], ties[V];
  load<V>(m, y + i * V);
  load<V>(q, dy + i * V);
#pragma unroll
  for (int j = 0; j < V; ++j) ties[j] = 0.f;
  for (int wy = 0; wy < k; ++wy)
    for (int wx = 0; wx < k; ++wx) {
      load<V>(v, x + at + (wy * W + wx) * C);
#pragma unroll
      for (int j = 0; j < V; ++j)
        ties[j] = __fadd_rn(ties[j], v[j] == m[j] ? 1.f : 0.f);
    }
#pragma unroll
  for (int j = 0; j < V; ++j) q[j] = __fdiv_rn(q[j], ties[j]);
  for (int wy = 0; wy < k; ++wy)
    for (int wx = 0; wx < k; ++wx) {
      const int e = at + (wy * W + wx) * C;
      load<V>(v, x + e);
#pragma unroll
      for (int j = 0; j < V; ++j)
        v[j] = __fmul_rn(v[j] == m[j] ? 1.f : 0.f, q[j]);
      store<V>(dx + e, v);
    }
}

template <int V>
cudaError_t launch(const float* x, const float* y, const float* dy,
                   float* dx, int nb, int H, int W, int C, int k,
                   cudaStream_t s) {
  const int Ho = H / k, Wo = W / k;
  const int windows = nb * Ho * Wo * (C / V);
  const int blocks =
      static_cast<int>(((long long)windows + kThreads - 1) / kThreads);
  maxpool2d_bwd_kernel<V><<<blocks, kThreads, 0, s>>>(x, y, dy, dx, H, W, C,
                                                      k, Ho, Wo, windows);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<size_t>(p) % 16 == 0;
}

}  // namespace

extern "C" int repro_maxpool2d_bwd(const float* x, const float* y,
                                   const float* dy, float* dx, int B, int H,
                                   int W, int C, int k, void* stream) {
  const long long img = (long long)H * W * C;
  const long long y_img = (long long)(H / k) * (W / k) * C;
  if (img > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int per = static_cast<int>(INT_MAX / img < B ? INT_MAX / img : B);
  const bool vec = C % 4 == 0 && aligned16(x) && aligned16(y) &&
                   aligned16(dy) && aligned16(dx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int n0 = 0; n0 < B; n0 += per) {
    const int nb = B - n0 < per ? B - n0 : per;
    const cudaError_t err =
        vec ? launch<4>(x + n0 * img, y + n0 * y_img, dy + n0 * y_img,
                        dx + n0 * img, nb, H, W, C, k, s)
            : launch<1>(x + n0 * img, y + n0 * y_img, dy + n0 * y_img,
                        dx + n0 * img, nb, H, W, C, k, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
