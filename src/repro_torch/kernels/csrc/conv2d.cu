// Valid, stride-1 convolution NHWC x HWIO -> NHWC with an optional fused
// bias + tanh epilogue, fp32 on CUDA cores, as a register-tiled implicit
// GEMM.
//
// Replaces: src/repro/kernels/conv2d.py conv2d_fwd (:92, body
// _conv_fwd_kernel :74), the Pallas TPU forward conv that unrolls the KxK
// taps into MXU dots over a halo'd row slab held in VMEM.
//
// Bound on the H100: operations.  A layer does 2*B*Ho*Wo*Cout*K*K*Cin FLOP;
// at chaos-large's B=256 that is 0.11 GFLOP at conv0, 7.43 at conv2 and
// 3.98 at conv4, against 67 TFLOP/s of fp32 FMAs: 0.17 ms for the three
// layers.  Only conv0 (K*K*Cin = 16) moves more bytes than it computes; the
// inner layers do several hundred FLOP per byte of activations, far above
// the fp32 ridge of 67 TFLOP/s / 3.35 TB/s = 20 FLOP/byte.  TF32 tensor
// cores would lose the digits that the parity tests hold, so the kernel
// stays in fp32 FMAs, and the design is about feeding the FMA pipes.
//
// The GEMM view: C[M = B*Ho*Wo, Cout] = A[M, Kd = K*K*Cin] . Wm[Kd, Cout].
// Wm is w's HWIO memory as it lies.  A is gathered on the fly: row m is the
// output pixel (n, oh, ow), column kd is the tap (kh, kw, ci), and the
// entry is x[n, oh + kh, ow + kw, ci].  Within one kernel row kh the K*Cin
// columns are contiguous in x, so a column's offset from its row's base is
// kh*W*Cin + (kd - kh*K*Cin); each thread keeps its pixels' row bases in
// registers (one divide per pixel, at the start) and walks kh and the
// remainder forward chunk by chunk, so no divide runs in the loop.  M runs
// across images, so a layer with few pixels per image (conv4: 36) still
// fills its tiles.
//
// Tiles (the loop is tile_loop in conv2d_common.cuh, which the backward
// shares): a block computes BM x BN outputs, stepping along Kd in chunks of
// kBK.  Both the A chunk (stored k-major, padded so the stores and the
// float4 reads are free of bank conflicts) and the Wm chunk are staged in
// shared memory with cp.async, double-buffered, so the next chunk loads
// while this one is multiplied, with one barrier per chunk.  Wm goes in
// 16-byte copies where Cout is a multiple of 4 (4-byte copies otherwise);
// A always goes in 4-byte copies, as four adjacent channels of one pixel
// are four columns of one row and k-major storage puts them apart.  Each
// thread keeps TM x TN outputs in registers as an outer product, TM/4
// groups of 4 pixels by TN/4 groups of 4 output channels, the groups
// BM/(TM/4) and BN/(TN/4) apart so that a warp's float4 reads are
// contiguous: per kd, TM + TN shared loads feed TM*TN FMAs (an 8 x 8
// tile: 4 float4 loads for 64 FMAs).  The epilogue adds the bias, applies
// tanhf and stores along Cout, masking the ragged edges of M and Cout.
// Ragged chunks are zero-filled by the copies.  No instance needs more
// than the default 48 KB of shared memory (the largest, 128 x 64, takes 25
// KB), so none opts in.  The launch bounds keep each instance within 128
// registers a thread (four 128-thread blocks or eight 64-thread blocks an
// SM).
//
// The plan (conv2d_fwd_plan) picks the tile from the shapes out of a fixed
// menu, in order: 128 x 64 (8 x 8 a thread; only where Cout > 32), 32 x 128
// (4 x 8; only where Cout > 64), 128 x 32 (8 x 4), 32 x 32 (4 x 4).  It
// takes the first that launches two blocks per SM (min_blocks, the conv
// kernels' one launch-geometry rule), else the last.  A 32 x 128 tile
// spans up to 128 output channels in one block column, so each pixel's A
// row, the 4-byte gather that costs the most copies, is staged once and
// not once per 32 channels: per chunk of a 4096-output tile 512 A copies
// and 512 Wm copies, against 2048 and 128 for 128 x 32.  At chaos-large's
// B=256 the plan takes 128 x 32 at conv0 (Cout 20), 128 x 64 at conv2 (Cout
// 60) and 32 x 128 at conv4 (Cout 100, 288 blocks, where 128 x 64 would
// fill only 144); at B=8 it takes 32 x 32 everywhere.  Tensors of 2^31
// elements or more are cut into launches of whole images.
//
// Order of sums: every output is one thread's fmaf chain over kd = 0 ..
// Kd - 1 in (kh, kw, ci) order from 0, then + bias, then tanhf; the zero
// padding of a ragged chunk adds exact zeros.  The order is the same in
// every tile instance and in every launch, with no split-K and no atomics,
// so two runs give the same bits whatever tile the plan picks.
#include <cuda_runtime.h>

#include <climits>

#include "conv2d_common.cuh"

namespace {

struct Args {
  const float* x;
  const float* w;
  const float* b;
  float* y;
  int M;  // output pixels of this launch
  int H, W, Cin, K, Cout, Ho, Wo, act;
};

// kVec: Cout is a multiple of 4 and w, y are 16-byte aligned, so Wm moves
// in 16-byte copies and y in float4 stores.
template <int BM, int BN, int TM, int TN, bool kVec>
__global__ void __launch_bounds__((BM / TM) * (BN / TN),
                                  512 / ((BM / TM) * (BN / TN)))
conv2d_fwd_kernel(Args a) {
  using S = TileShape<BM, BN, TM, TN>;
  constexpr int NT = S::NT;
  constexpr int MS = 8 * BM / NT;  // pixels a thread gathers
  constexpr int NW = kVec ? kBK * BN / 4 / NT : kBK * BN / NT;
  static_assert(MS * NT == 8 * BM && kBK == 16, "gather");
  static_assert(NW * NT * (kVec ? 4 : 1) == kBK * BN, "weight copies");
  __shared__ TileSmem<BM, BN> sm;

  const int t = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int KC = a.K * a.Cin;  // the contiguous columns of one kernel row
  const int rowW = a.W * a.Cin;
  const int Kd = a.K * KC;

  // Gather: this thread copies column lanes kk and kk + 8 of every chunk
  // for MS pixels, NT / 8 apart.
  const int kk = t & 7;
  int rowbase[MS];
#pragma unroll
  for (int s = 0; s < MS; ++s) {
    const int m = m0 + (t >> 3) + s * (NT / 8);
    if (m < a.M) {
      const int hw = a.Ho * a.Wo;
      const int n = m / hw, p = m - n * hw;
      const int oh = p / a.Wo, ow = p - oh * a.Wo;
      rowbase[s] = (n * a.H + oh) * rowW + ow * a.Cin;
    } else {
      rowbase[s] = -1;
    }
  }
  // Column kd = kh * KC + rem of lane j in the current chunk.
  int kh[2], rem[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    kh[j] = (kk + 8 * j) / KC;
    rem[j] = kk + 8 * j - kh[j] * KC;
  }

  auto load = [&](int chunk, int st) {
    if (chunk > 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        rem[j] += kBK;
        while (rem[j] >= KC) {
          rem[j] -= KC;
          ++kh[j];
        }
      }
    }
    const int k0 = chunk * kBK;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = kh[j] * rowW + rem[j];
      const bool kin = kh[j] < a.K;
#pragma unroll
      for (int s = 0; s < MS; ++s) {
        const bool ok = kin && rowbase[s] >= 0;
        cp_async4(&sm.a[st][kk + 8 * j][(t >> 3) + s * (NT / 8)],
                  ok ? a.x + rowbase[s] + col : a.x, ok);
      }
    }
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const int f = t + i * NT;
      if (kVec) {
        const int k = f / (BN / 4), c = 4 * (f % (BN / 4));
        const int kd = k0 + k, n = n0 + c;
        const bool ok = kd < Kd && n < a.Cout;
        cp_async16(&sm.b[st][k][c], ok ? a.w + kd * a.Cout + n : a.w, ok);
      } else {
        const int k = f / BN, c = f % BN;
        const int kd = k0 + k, n = n0 + c;
        const bool ok = kd < Kd && n < a.Cout;
        cp_async4(&sm.b[st][k][c], ok ? a.w + kd * a.Cout + n : a.w, ok);
      }
    }
  };

  float acc[TM][TN];
  tile_loop<BM, BN, TM, TN>(sm, (Kd + kBK - 1) / kBK, load, acc);

  const int tc = t % S::TC, tr = t / S::TC;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + S::row(i, tr);
    if (m >= a.M) continue;
    float* yr = a.y + m * a.Cout;
#pragma unroll
    for (int g = 0; g < S::GN; ++g) {
      const int n = n0 + S::col(4 * g, tc);
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float bias = (a.b && n + q < a.Cout) ? a.b[n + q] : 0.f;
        v[q] = acc[i][4 * g + q] + bias;
        if (a.act) v[q] = tanhf(v[q]);
      }
      if (kVec) {
        if (n < a.Cout)
          *reinterpret_cast<float4*>(yr + n) =
              make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (n + q < a.Cout) yr[n + q] = v[q];
      }
    }
  }
}

struct Tile {
  int bm, bn, tm, tn;
};
// The menu in order of preference; launch_plan instantiates the same tiles.
constexpr Tile kTiles[] = {
    {128, 64, 8, 8}, {32, 128, 4, 8}, {128, 32, 8, 4}, {32, 32, 4, 4}};
constexpr int kLast = sizeof(kTiles) / sizeof(kTiles[0]) - 1;

// The first tile of the menu that launches `want` blocks, skipping a tile
// wider than 32 where half its columns or more would idle.
int conv2d_fwd_plan(int M, int Cout, int want) {
#ifdef REPRO_CONV2D_FWD_TILE  // a build of conv2d_tiles.py: one tile only
  return REPRO_CONV2D_FWD_TILE;
#endif
  for (int i = 0; i < kLast; ++i) {
    const Tile& t = kTiles[i];
    if (t.bn > 32 && 2 * Cout <= t.bn) continue;
    const long long blocks = (long long)((M + t.bm - 1) / t.bm) *
                             ((Cout + t.bn - 1) / t.bn);
    if (blocks >= want) return i;
  }
  return kLast;
}

template <int BM, int BN, int TM, int TN>
cudaError_t launch_tile(const Args& a, bool vec, cudaStream_t s) {
  constexpr int NT = (BM / TM) * (BN / TN);
  const dim3 grid((a.M + BM - 1) / BM, (a.Cout + BN - 1) / BN);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  if (vec)
    conv2d_fwd_kernel<BM, BN, TM, TN, true><<<grid, NT, 0, s>>>(a);
  else
    conv2d_fwd_kernel<BM, BN, TM, TN, false><<<grid, NT, 0, s>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_plan(int plan, const Args& a, bool vec, cudaStream_t s) {
  switch (plan) {
    case 0: return launch_tile<128, 64, 8, 8>(a, vec, s);
    case 1: return launch_tile<32, 128, 4, 8>(a, vec, s);
    case 2: return launch_tile<128, 32, 8, 4>(a, vec, s);
    default: return launch_tile<32, 32, 4, 4>(a, vec, s);
  }
}

}  // namespace

// act: 0 = none, 1 = tanh.  b may be null (no bias).  Offsets inside a
// launch are 32-bit, so tensors of 2^31 elements or more go in launches of
// whole images (one image must stay below that; w always).
extern "C" int repro_conv2d_fwd(const float* x, const float* w,
                                const float* b, float* y, int B, int H, int W,
                                int Cin, int K, int Cout, int act,
                                void* stream) {
  const int Ho = H - K + 1, Wo = W - K + 1;
  const long long x_img = (long long)H * W * Cin;
  const long long y_img = (long long)Ho * Wo * Cout;
  const long long img = x_img > y_img ? x_img : y_img;
  if (img > INT_MAX || (long long)K * K * Cin * Cout > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per = static_cast<int>(INT_MAX / img < B ? INT_MAX / img : B);
  const bool vec = Cout % 4 == 0 && reinterpret_cast<size_t>(w) % 16 == 0 &&
                   reinterpret_cast<size_t>(y) % 16 == 0;
  int blocks = 0;
  cudaError_t err = min_blocks(&blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int n0 = 0; n0 < B; n0 += per) {
    const int nb = B - n0 < per ? B - n0 : per;
    const Args a{x + n0 * x_img, w, b, y + n0 * y_img, nb * Ho * Wo,
                 H, W, Cin, K, Cout, Ho, Wo, act};
    err = launch_plan(conv2d_fwd_plan(a.M, Cout, blocks), a, vec, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
