// VALID max pool, stride = window k, NHWC; the tail that does not fill a
// window is cropped (Ho = H / k, Wo = W / k).
//
// Replaces: src/repro/kernels/pool.py maxpool2d_fwd (_maxpool_fwd_kernel),
// the Pallas TPU kernel that crops, reshapes and reduces a batch block in
// VMEM.
//
// Bound on the H100: bytes.  It reads each input of a window once and
// writes each output once, with under one compare per byte, far below the
// fp32 ridge of 20 FLOP/byte; chaos-large's 22x22x60 pool moves 37 MB at
// B=256, 11.1 us at 3.35 TB/s.  That bound holds for an input read from
// DRAM: an input that the conv before left in the 50 MB L2 reads faster.
//
// Design: one thread per (image, output pixel, group of V channels), in
// row-major (n, oy, ox, group) order, so a warp reads and writes consecutive
// channels of neighbouring pixels (coalesced along C).  The vector instance
// takes V = 4 channels as float4, where C % 4 == 0 and x and y are 16-byte
// aligned; the scalar instance takes one channel otherwise.  A thread's
// index is 32-bit and is split into (n, oy, ox, group) by multiplying with
// reciprocals the host computes, so the card divides nothing; its window's
// first input is one size_t offset and the taps lie at 32-bit offsets from
// it (inside one image), so tensors of 2^31 elements or more work.  k = 2,
// the CNN's window, is fixed at compile time, so the loop over the taps
// unrolls and its four loads are issued before the first compare; other k
// are taken at run time.  The max starts at the first tap and takes each
// tap in row-major order, if (v > m || v != v) m = v: a NaN wins (the
// window's last NaN), and of equal values (ties, +0 and -0) the first
// stays, whatever the layout of the threads.
#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// n / d for 0 <= n < 2^31 without a division: umulhi(n, mul) >> shr with
// l = ceil(log2 d), mul = ceil(2^(31 + l) / d) < 2^32, shr = l - 1.  The
// error n * (mul * d - 2^(31 + l)) / (d * 2^(31 + l)) stays below
// 2^-l <= 1 / d, so the floor is exact.  d = 1 keeps n.
struct Divisor {
  unsigned d, mul, shr;
};

Divisor divisor(unsigned d) {
  if (d == 1) return {1u, 0u, 0u};
  unsigned l = 0;
  while ((1ull << l) < d) ++l;
  const unsigned long long p = 1ull << (31 + l);
  return {d, static_cast<unsigned>((p + d - 1) / d), l - 1};
}

__device__ __forceinline__ unsigned divide(unsigned n, Divisor v) {
  return v.d == 1 ? n : __umulhi(n, v.mul) >> v.shr;
}

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
__device__ __forceinline__ void take(float (&m)[V], const float (&v)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (v[j] > m[j] || v[j] != v[j]) m[j] = v[j];
}

struct Args {
  const float* x;
  float* y;
  int H, W, C, k, items;
  Divisor groups, wo, ho;  // C / V, Wo, Ho
};

// V channels a thread; K = the window (0: a.k at run time).
template <int V, int K>
__global__ void __launch_bounds__(kThreads) maxpool2d_fwd_kernel(Args a) {
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= static_cast<unsigned>(a.items)) return;
  const int k = K ? K : a.k;
  const unsigned p = divide(i, a.groups), c = (i - p * a.groups.d) * V;
  const unsigned r = divide(p, a.wo), ox = p - r * a.wo.d;
  const unsigned n = divide(r, a.ho), oy = r - n * a.ho.d;
  const float* src =
      a.x + (((size_t)n * a.H + oy * k) * a.W + ox * k) * a.C + c;
  const int row = a.W * a.C;
  float m[V];
  load<V>(m, src);
  // unrolled in full where K fixes k: the loads read memory that nothing
  // writes, so the compiler issues them all before the first compare
#pragma unroll
  for (int dy = 0; dy < k; ++dy)
#pragma unroll 4
    for (int dx = dy == 0 ? 1 : 0; dx < k; ++dx) {
      float v[V];
      load<V>(v, src + dy * row + dx * a.C);
      take<V>(m, v);
    }
  float* dst = a.y + (size_t)i * V;
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(dst) = make_float4(m[0], m[1], m[2], m[3]);
  else
    dst[0] = m[0];
}

template <int V>
cudaError_t launch(Args a, cudaStream_t s) {
  const int blocks = static_cast<int>(
      ((long long)a.items + kThreads - 1) / kThreads);
  if (a.k == 2)
    maxpool2d_fwd_kernel<V, 2><<<blocks, kThreads, 0, s>>>(a);
  else
    maxpool2d_fwd_kernel<V, 0><<<blocks, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<size_t>(p) % 16 == 0;
}

}  // namespace

extern "C" int repro_maxpool2d_fwd(const float* x, float* y, int B, int H,
                                   int W, int C, int k, void* stream) {
  const int Ho = H / k, Wo = W / k;
  const long long img = (long long)H * W * C;
  const bool vec = C % 4 == 0 && aligned16(x) && aligned16(y);
  const int V = vec ? 4 : 1;
  const long long items_img = (long long)Ho * Wo * (C / V);
  if (items_img == 0) return static_cast<int>(cudaSuccess);
  if (img > INT_MAX || items_img > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  // whole images a launch, so that a thread's index stays 32-bit
  const int per = static_cast<int>(
      INT_MAX / items_img < B ? INT_MAX / items_img : B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a{x, y, H, W, C, k, 0, divisor(C / V), divisor(Wo), divisor(Ho)};
  for (int n0 = 0; n0 < B; n0 += per) {
    const int nb = B - n0 < per ? B - n0 : per;
    a.x = x + n0 * img;
    a.y = y + n0 * items_img * V;
    a.items = static_cast<int>(nb * items_img);
    const cudaError_t err = vec ? launch<4>(a, s) : launch<1>(a, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
