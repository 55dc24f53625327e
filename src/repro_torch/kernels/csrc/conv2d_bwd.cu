// Backward of the valid, stride-1 convolution NHWC x HWIO -> NHWC, fp32 on
// CUDA cores, as two register-tiled implicit GEMMs, from three entry
// points: the fused backward (dx, dw and db, with the tanh derivative fused
// when the forward output y is given: dz = dy * (1 - y^2), else dz = dy),
// and the split pair, dx alone and dw alone (dz = dy).
//
// Replaces: src/repro/kernels/conv2d.py conv2d_bwd_fused (:197, body
// _bwd_body :133-182), the Pallas TPU kernel that walks K-1-padded dz slabs
// once, writes dx per slab and sums dw/db across the sequential batch grid
// in VMEM scratch; and conv2d_dx (:281, body _conv_dx_kernel :262) and
// conv2d_dw (:330, body _conv_dw_kernel :303), its un-fused baseline: dx as
// the K-1-padded dy correlated with the flipped taps over a grid of batch
// blocks, dw as each batch block's patch^T . dy added in block order into
// one VMEM accumulator.
//
// Bound on the H100: operations.  dx and dw each cost the forward's
// 2*B*Ho*Wo*Cout*K*K*Cin FLOP, and dz 4 FLOP an element; at chaos-large's
// B=256 that is 23.1 GFLOP over its three conv layers against 67 TFLOP/s
// of fp32 FMAs, and with conv0's bytes (it moves more than it computes)
// 0.350 ms a step.  The inner layers do hundreds of FLOP per byte, so the
// design is about feeding the FMA pipes.  TF32 would lose the
// digits the parity limits hold, so the kernels stay in fp32 FMAs.
//
// The fused backward issues four device kernels on the caller's stream,
// one wrapper launch:
//  1. prep: dz = dy * (1 - y*y), rounded as __fmul_rn(dy, __fsub_rn(1,
//     __fmul_rn(y, y))) with no contraction, as the plain version rounds
//     it, into scratch (skipped without y: dz is dy); and w transposed per
//     tap to wt (K, K, Cout, Cin).
//  2. dx as C[M = B*H*W, N = Cin] = A[M, (kh, kw, co)] . wt[(kh, kw, co),
//     Cin], where A's entry is dz[n, i - kh, j - kw, co] for input pixel
//     (i, j) of image n.  M is ordered (input pixel, image), so the rows of
//     a tile share one pixel, or a few consecutive ones where B is smaller
//     than the tile (B=8) or no multiple of it.  A tile walks only the
//     taps (kh, kw) that reach one of its pixels (the box from its first
//     pixel's to its last's; rows outside a tap's reach are zero-filled),
//     so no FMA goes to the K-1 padding of the full correlation (at
//     chaos-large's conv2 26^2 input pixels against 22^2 outputs, 1.4x the
//     useful work; at conv4 3.4x).  Each thread keeps its rows' pixel and
//     dz offset in registers and walks (kh, kw, co) forward chunk by chunk.
//  3. dw and db as C[(kh, kw, ci) + 1, Cout] = X^T . DZ, reduced over M' =
//     B*Ho*Wo: row (kh, kw, ci) of X^T at position (n, oh, ow) is x[n, oh +
//     kh, ow + kw, ci], and the last row is all ones, so that row's sums
//     are db (fmaf(1, dz, acc) is acc + dz exactly).  The rows are dw's own
//     (K, K, Cin, Cout) layout.  Within one tap Cin is contiguous in x, so
//     X^T moves in 16-byte copies where Cin % 4 == 0 and 4-byte copies
//     otherwise; DZ in 16-byte copies where Cout % 4 == 0.  M' is cut into
//     slices of L positions, L a function of the shapes alone (about
//     kDwBlocks blocks in all, at least kSliceMin positions, a multiple of
//     kBK), and each block writes its tile's partial sums over its slice to
//     scratch.
//  4. Each dw and db entry is the sum of its slices' partials: lane y of 8
//     sums slices y, y + 8, ... in order, then the 8 lane sums are added in
//     lane order.
// The split dx (repro_conv2d_dx) is steps 1 and 2 with dz = dy: prep only
// transposes w, and dx is the fused dx bit for bit.  The split dw
// (repro_conv2d_dw) is step 3 without db's row, over slices that stay
// inside the reference's batch blocks of bb images: each block's bb*Ho*Wo
// positions are cut into S slices of L positions by the same rule (the
// fused call is one block of B images), and a fixed-order sum adds each
// block's S partials in slice order, then the block sums from zero in
// block order, as the reference's sequential grid adds them.
// The GEMM loop is conv2d_common.cuh's (cp.async double buffering in
// chunks of kBK, float4 register tiles), shared with the forward.
//
// The tile plan.  The menu is the forward's four tiles (128 x 64, 32 x 128,
// 128 x 32, 32 x 32) and a 128 x 8 tile (4 x 4 a thread) for narrow N (dx
// at Cin 1).  dx takes the first tile that launches eight blocks an SM
// (four times min_blocks, conv2d_common.cuh's rule), skipping a tile wider
// than 8 where half its columns or more would idle and the 8-wide one
// where N > 8; else the fit tile with the most blocks.  Its tiles run
// centre-out (dx_tile_start): a tile's work follows the taps that reach
// its pixels, so the heavy middle starts first and many blocks let the
// card even out the rest.  At chaos-large's B=256 dx takes 128 x 8 at conv0,
// 128 x 32 at conv2 and 32 x 32 at conv4 (1936 blocks, where 128 x 32 gave
// 484 and was 12 % slower; kernels/conv2d_tiles.py times every tile); at
// B=8 32 x 32 at conv2 and conv4.  dw takes the first of the forward's four
// tiles whose rows and columns are not half idle, else 32 x 32, from the
// shapes alone: 32 x 32 at conv0, 128 x 64 at conv2 and conv4.  Every
// kernel size and row width runs: K enters only the gathers.  No instance
// needs more than the default 48 KB of shared memory; the launch bounds
// keep each within 128 registers.
//
// Order of sums.  dx: each element is one thread's fmaf chain over (kh,
// kw, co) in that order from 0, zero-filled taps adding exact zeros, so its
// bits do not depend on the tile.  dw, db: one thread's fmaf chain over its
// slice's positions in (n, oh, ow) order, then the slices (and, split, the
// batch blocks) in the fixed orders above.  The slices and the dw tile come
// from the shapes (and bb) alone; nothing reads the SM count or occupancy
// into any sum, nothing uses atomics or a cooperative launch, so two runs
// give the same bits on any card.  Offsets are 32-bit: the wrappers refuse
// shapes that do not fit.
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "conv2d_common.cuh"

namespace {

constexpr int kPrepThreads = 256;
constexpr int kDwBlocks = 512;  // dw: blocks the slices aim at, in all
constexpr int kSliceMin = 512;  // dw: least positions a slice
constexpr int kSumLanes = 8;    // the sums: slice or batch-block lanes

struct Shapes {
  int B, H, W, Cin, K, Cout, Ho, Wo;
};

struct Tile {
  int bm, bn, tm, tn;
};
// The menu: the forward's four tiles, then one for narrow N (dx only).
constexpr Tile kTiles[] = {{128, 64, 8, 8},
                           {32, 128, 4, 8},
                           {128, 32, 8, 4},
                           {32, 32, 4, 4},
                           {128, 8, 4, 4}};
constexpr int kTileCount = sizeof(kTiles) / sizeof(kTiles[0]);
constexpr int kDwTiles = 4;     // dw takes the first four
constexpr int kCatchAll = 3;   // 32 x 32

// ----------------------------------------------------------------- prep
__global__ void __launch_bounds__(kPrepThreads)
    prep_kernel(const float* __restrict__ dy, const float* __restrict__ y,
                float* __restrict__ dz, int n_dz, bool vec,
                const float* __restrict__ w, float* __restrict__ wt,
                int taps, int Cin, int Cout) {
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  if (y != nullptr) {
    const int n4 = vec ? n_dz / 4 : 0;
    for (int i = first; i < n4; i += stride) {
      const float4 g = __ldg(reinterpret_cast<const float4*>(dy) + i);
      const float4 v = __ldg(reinterpret_cast<const float4*>(y) + i);
      reinterpret_cast<float4*>(dz)[i] =
          make_float4(__fmul_rn(g.x, __fsub_rn(1.f, __fmul_rn(v.x, v.x))),
                      __fmul_rn(g.y, __fsub_rn(1.f, __fmul_rn(v.y, v.y))),
                      __fmul_rn(g.z, __fsub_rn(1.f, __fmul_rn(v.z, v.z))),
                      __fmul_rn(g.w, __fsub_rn(1.f, __fmul_rn(v.w, v.w))));
    }
    for (int i = 4 * n4 + first; i < n_dz; i += stride) {
      const float g = __ldg(dy + i), v = __ldg(y + i);
      dz[i] = __fmul_rn(g, __fsub_rn(1.f, __fmul_rn(v, v)));
    }
  }
  const int n_w = taps * Cin * Cout;
  for (int i = first; i < n_w; i += stride) {
    const int co = i % Cout;
    const int t = i / Cout;
    const int ci = t % Cin;
    const int tap = t / Cin;
    wt[(tap * Cout + co) * Cin + ci] = __ldg(w + i);
  }
}

// ------------------------------------------------------------------- dx
struct DxArgs {
  const float* dz;  // (B, Ho, Wo, Cout)
  const float* wt;  // (K, K, Cout, Cin)
  float* dx;
  int M;            // B*H*W rows, in (input pixel, image) order
  Shapes s;
};

// Row n of a centre-out walk over n rows: the middle row first, then
// outward, alternating sides.
__device__ __forceinline__ int centre_out(int r, int n) {
  return r % 2 == 0 ? (n - 1) / 2 - r / 2 : (n - 1) / 2 + 1 + r / 2;
}

// The first row of dx tile x.  Tiles that hold whole pixels (B % BM == 0)
// or whole pixel rows (W*B % BM == 0) run centre-out, as the middle
// pixels reach the most taps: the heaviest tiles start first and the
// lightest finish the launch.  dx's bits do not depend on the order.
template <int BM>
__device__ __forceinline__ int dx_tile_start(int x, const Shapes& s) {
  if (s.B % BM == 0) {
    const int per = s.B / BM, p = x / per;
    const int r = p / s.W, c = p - r * s.W;
    return ((centre_out(r, s.H) * s.W + centre_out(c, s.W)) * s.B) +
           (x - p * per) * BM;
  }
  if (s.W * s.B % BM == 0) {
    const int per = s.W * s.B / BM, r = x / per;
    return centre_out(r, s.H) * s.W * s.B + (x - r * per) * BM;
  }
  return x * BM;
}

// kVec: Cin % 4 == 0 and dx is 16-byte aligned, so wt moves in 16-byte
// copies and dx in float4 stores.
template <int BM, int BN, int TM, int TN, bool kVec>
__global__ void __launch_bounds__((BM / TM) * (BN / TN),
                                  512 / ((BM / TM) * (BN / TN)))
    dx_kernel(DxArgs a) {
  using S = TileShape<BM, BN, TM, TN>;
  constexpr int NT = S::NT;
  constexpr int NG = NT / 8;       // row groups: 8 threads a row
  constexpr int MS = (BM + NG - 1) / NG;  // rows a thread gathers
  constexpr bool kRagged = MS * NG > BM;   // the last slot not in every thread
  constexpr int VW = kVec ? 4 : 1;
  static_assert(kBK == 16, "gather");
  __shared__ TileSmem<BM, BN> sm;

  const int t = threadIdx.x, kk = t & 7, grp = t >> 3;
  const int B = a.s.B, W = a.s.W, K = a.s.K, Cin = a.s.Cin;
  const int Cout = a.s.Cout, Ho = a.s.Ho, Wo = a.s.Wo;
  const int m0 = dx_tile_start<BM>(blockIdx.x, a.s), n0 = blockIdx.y * BN;

  // The taps that reach a pixel of the tile: the box from its first
  // pixel's taps to its last's (all kw where it spans more than one row).
  const int p0 = m0 / B, p1 = (min(m0 + BM, a.M) - 1) / B;
  const int i0 = p0 / W, i1 = p1 / W;
  const int kh0 = max(0, i0 - Ho + 1), kh1 = min(K - 1, i1);
  const int kw0 = i0 == i1 ? max(0, p0 - i0 * W - Wo + 1) : 0;
  const int kw1 = i0 == i1 ? min(K - 1, p1 - i1 * W) : K - 1;
  const int nkw = kw1 - kw0 + 1;
  const int ncols = (kh1 - kh0 + 1) * nkw * Cout;

  // Rows: pixel (i, j) packed as i << 16 | j (-1 past M), and the dz
  // offset of image n at (i, j), which tap (kh, kw) moves back by (kh * Wo
  // + kw) * Cout.
  int zoff[MS], zij[MS];
#pragma unroll
  for (int s = 0; s < MS; ++s) {
    const int m = m0 + grp + s * NG;
    zoff[s] = 0;
    zij[s] = -1;
    if (m < a.M && !(kRagged && grp + s * NG >= BM)) {
      const int p = m / B, n = m - p * B;
      const int i = p / W, j = p - i * W;
      zoff[s] = ((n * Ho + i) * Wo + j) * Cout;
      zij[s] = i << 16 | j;
    }
  }
  // Column lanes kk and kk + 8 of the current chunk: tap (kh, kw), channel
  // co; past the last tap when kh > kh1.
  int ckh[2], ckw[2], cco[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int tap = (kk + 8 * j) / Cout;
    cco[j] = kk + 8 * j - tap * Cout;
    ckh[j] = kh0 + tap / nkw;
    ckw[j] = kw0 + tap % nkw;
  }

  auto load = [&](int chunk, int st) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (chunk > 0) {
        cco[j] += kBK;
        while (cco[j] >= Cout) {
          cco[j] -= Cout;
          if (++ckw[j] > kw1) {
            ckw[j] = kw0;
            ++ckh[j];
          }
        }
      }
      const bool kin = ckh[j] <= kh1;
      const int back = (ckh[j] * Wo + ckw[j]) * Cout - cco[j];
#pragma unroll
      for (int s = 0; s < MS; ++s) {
        if (kRagged && grp + s * NG >= BM) continue;
        const int i = zij[s] >> 16, jj = zij[s] & 0xffff;
        const bool ok = kin && zij[s] >= 0 &&
                        (unsigned)(i - ckh[j]) < (unsigned)Ho &&
                        (unsigned)(jj - ckw[j]) < (unsigned)Wo;
        cp_async4(&sm.a[st][kk + 8 * j][grp + s * NG],
                  ok ? a.dz + (zoff[s] - back) : a.dz, ok);
      }
      const int wrow = ((ckh[j] * K + ckw[j]) * Cout + cco[j]) * Cin + n0;
      for (int c = VW * grp; c < BN; c += VW * NG) {
        const bool ok = kin && n0 + c < Cin;
        if (kVec)
          cp_async16(&sm.b[st][kk + 8 * j][c], ok ? a.wt + wrow + c : a.wt,
                     ok);
        else
          cp_async4(&sm.b[st][kk + 8 * j][c], ok ? a.wt + wrow + c : a.wt,
                    ok);
      }
    }
  };

  float acc[TM][TN];
  tile_loop<BM, BN, TM, TN>(sm, (ncols + kBK - 1) / kBK, load, acc);

  const int tc = t % S::TC, tr = t / S::TC;
  const int HW = a.s.H * W;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + S::row(i, tr);
    if (m >= a.M) continue;
    const int p = m / B, n = m - p * B;
    float* out = a.dx + (n * HW + p) * Cin;
#pragma unroll
    for (int g = 0; g < S::GN; ++g) {
      const int c = n0 + S::col(4 * g, tc);
      if (kVec) {
        if (c < Cin)
          *reinterpret_cast<float4*>(out + c) =
              make_float4(acc[i][4 * g], acc[i][4 * g + 1],
                          acc[i][4 * g + 2], acc[i][4 * g + 3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (c + q < Cin) out[c + q] = acc[i][4 * g + q];
      }
    }
  }
}

// ------------------------------------------------------------------- dw
struct DwArgs {
  const float* x;   // (B, H, W, Cin)
  const float* dz;  // (B, Ho, Wo, Cout)
  float* part;      // (slices, Mw, Cout) partial sums
  int Mw;           // K*K*Cin rows of dw, then db's row of ones if fused
  int P;            // positions a batch block: bb*Ho*Wo (fused: B*Ho*Wo)
  int S;            // slices a batch block
  int L;            // positions a slice (the block's last may be shorter)
  bool vecB;        // Cout % 4 == 0, dz and part 16-byte aligned
  Shapes s;
};

// kVecA: Cin % 4 == 0 and x is 16-byte aligned, so X^T moves in 16-byte
// copies of four channels of one tap.
template <int BM, int BN, int TM, int TN, bool kVecA>
__global__ void __launch_bounds__((BM / TM) * (BN / TN),
                                  512 / ((BM / TM) * (BN / TN)))
    dw_kernel(DwArgs a) {
  using S = TileShape<BM, BN, TM, TN>;
  constexpr int NT = S::NT;
  constexpr int NG = NT / 8;  // row groups: 8 threads a row (or quad)
  constexpr int VA = kVecA ? 4 : 1;
  constexpr int RS = (BM / VA + NG - 1) / NG;  // row slots a thread copies
  __shared__ TileSmem<BM, BN> sm;

  const int t = threadIdx.x, kk = t & 7, grp = t >> 3;
  const int H = a.s.H, W = a.s.W, K = a.s.K, Cin = a.s.Cin;
  const int Cout = a.s.Cout, Ho = a.s.Ho, Wo = a.s.Wo;
  const int r0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  // Slice z: slice z % S of batch block z / S.
  const int bz = blockIdx.z / a.S, sz = blockIdx.z - bz * a.S;
  const int q0 = bz * a.P + sz * a.L;           // the slice's first position
  const int len = min(a.L, a.P - sz * a.L);     // and its length
  const int KKC = K * K * Cin;

  // Row slot s: rows r .. r + VA - 1 of the tile; its offset in x from a
  // position's pixel, -2 for db's row of ones (fused only), -1 past the
  // rows.
  int xoff[RS];
#pragma unroll
  for (int s = 0; s < RS; ++s) {
    const int r = r0 + VA * (grp + s * NG);
    xoff[s] = -1;
    if (VA * (grp + s * NG) < BM && r < KKC) {
      const int tap = r / Cin, ci = r - tap * Cin;
      const int kh = tap / K, kw = tap - kh * K;
      xoff[s] = (kh * W + kw) * Cin + ci;
    } else if (r == KKC && a.Mw > KKC) {
      xoff[s] = -2;
    }
  }
  // Position lanes kk and kk + 8 of the current chunk: q within the slice,
  // (n, oh, ow) of position q0 + q.
  int lq[2], ln[2], loh[2], low[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    lq[j] = kk + 8 * j;
    const int m = q0 + lq[j];
    const int hw = Ho * Wo;
    ln[j] = m / hw;
    loh[j] = (m - ln[j] * hw) / Wo;
    low[j] = m - ln[j] * hw - loh[j] * Wo;
  }

  auto load = [&](int chunk, int st) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (chunk > 0) {
        lq[j] += kBK;
        low[j] += kBK;
        while (low[j] >= Wo) {
          low[j] -= Wo;
          if (++loh[j] == Ho) {
            loh[j] = 0;
            ++ln[j];
          }
        }
      }
      const bool kin = lq[j] < len;
      const int pb = ((ln[j] * H + loh[j]) * W + low[j]) * Cin;
#pragma unroll
      for (int s = 0; s < RS; ++s) {
        const int rr = VA * (grp + s * NG);
        if (rr >= BM) continue;
        float* dst = &sm.a[st][kk + 8 * j][rr];
        const int o = xoff[s];
        if (o == -2) {  // db's row (the quad's other rows lie past Mw)
          const float one = kin ? 1.f : 0.f;
          if (kVecA)
            *reinterpret_cast<float4*>(dst) = make_float4(one, 0.f, 0.f, 0.f);
          else
            *dst = one;
        } else {
          const bool ok = kin && o >= 0;
          if (kVecA)
            cp_async16(dst, ok ? a.x + (pb + o) : a.x, ok);
          else
            cp_async4(dst, ok ? a.x + (pb + o) : a.x, ok);
        }
      }
      const int zrow = (q0 + lq[j]) * Cout + n0;
      if (a.vecB) {
        for (int c = 4 * grp; c < BN; c += 4 * NG) {
          const bool ok = kin && n0 + c < Cout;
          cp_async16(&sm.b[st][kk + 8 * j][c], ok ? a.dz + zrow + c : a.dz,
                     ok);
        }
      } else {
        for (int c = grp; c < BN; c += NG) {
          const bool ok = kin && n0 + c < Cout;
          cp_async4(&sm.b[st][kk + 8 * j][c], ok ? a.dz + zrow + c : a.dz,
                    ok);
        }
      }
    }
  };

  float acc[TM][TN];
  tile_loop<BM, BN, TM, TN>(sm, (len + kBK - 1) / kBK, load, acc);

  const int tc = t % S::TC, tr = t / S::TC;
  float* part = a.part + blockIdx.z * a.Mw * Cout;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + S::row(i, tr);
    if (r >= a.Mw) continue;
    float* pr = part + r * Cout;
#pragma unroll
    for (int g = 0; g < S::GN; ++g) {
      const int c = n0 + S::col(4 * g, tc);
      if (a.vecB) {
        if (c < Cout)
          *reinterpret_cast<float4*>(pr + c) =
              make_float4(acc[i][4 * g], acc[i][4 * g + 1],
                          acc[i][4 * g + 2], acc[i][4 * g + 3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (c + q < Cout) pr[c + q] = acc[i][4 * g + q];
      }
    }
  }
}

// Entry e of (dw, db) flattened: lane y sums slices y, y + kSumLanes, ...
// in order, then thread y == 0 adds the lanes' sums in lane order.
__global__ void __launch_bounds__(32 * kSumLanes)
    slice_sum_kernel(const float* __restrict__ part, float* __restrict__ dw,
                  float* __restrict__ db, int n_out, int n_dw, int slices) {
  __shared__ float red[kSumLanes][32];
  const int e = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (e < n_out)
    for (int sl = threadIdx.y; sl < slices; sl += kSumLanes)
      s += __ldcg(part + (size_t)sl * n_out + e);
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || e >= n_out) return;
  s = red[0][threadIdx.x];
#pragma unroll
  for (int y = 1; y < kSumLanes; ++y) s += red[y][threadIdx.x];
  if (e < n_dw)
    dw[e] = s;
  else
    db[e - n_dw] = s;
}

// Entry e of the split dw: each batch block's sum is its S slices'
// partials added from zero in slice order, and dw[e] is the block sums
// added from zero in block order.  Lane y takes block b0 + y of each run
// of kSumLanes blocks, and thread y == 0 adds the run's sums in order.
__global__ void __launch_bounds__(32 * kSumLanes)
    block_sum_kernel(const float* __restrict__ part, float* __restrict__ dw,
                     int n_dw, int blocks, int S) {
  __shared__ float red[kSumLanes][32];
  const int e = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.f;
  for (int b0 = 0; b0 < blocks; b0 += kSumLanes) {
    const int b = b0 + threadIdx.y;
    float s = 0.f;
    if (e < n_dw && b < blocks)
      for (int sl = 0; sl < S; ++sl)
        s += __ldcg(part + ((size_t)b * S + sl) * n_dw + e);
    red[threadIdx.y][threadIdx.x] = s;
    __syncthreads();
    if (threadIdx.y == 0)
      for (int y = 0; y < kSumLanes && b0 + y < blocks; ++y)
        acc += red[y][threadIdx.x];
    __syncthreads();
  }
  if (threadIdx.y == 0 && e < n_dw) dw[e] = acc;
}

// ----------------------------------------------------------------- plan
long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// The first tile of the menu (of its first `count`) that leaves neither
// half its rows nor half its columns idle (a tile wider than 16), else
// `fallback`: dw's, from the shapes alone.
int fit_tile(long long M, int N, int count, int fallback) {
  for (int i = 0; i < count; ++i) {
    const Tile& t = kTiles[i];
    if ((t.bn > 16 && 2 * N <= t.bn) || (t.bm > 32 && 2 * M <= t.bm))
      continue;
    return i;
  }
  return fallback;
}

// dx's: the first tile that launches `want` blocks, skipping a tile wider
// than 8 where half its columns or more would idle and the 8-wide tile
// where N > 8; else the fit tile with the most blocks, else 32 x 32.  dx's
// bits do not depend on it.
int dx_tile_for(long long M, int N, int want) {
#ifdef REPRO_CONV2D_BWD_DX_TILE  // a build of conv2d_tiles.py: one tile only
  return REPRO_CONV2D_BWD_DX_TILE;
#endif
  int best = kCatchAll;
  long long best_blocks = -1;
  for (int i = 0; i < kTileCount; ++i) {
    const Tile& t = kTiles[i];
    if ((t.bn > 8 && 2 * N <= t.bn) || (t.bn <= 8 && N > t.bn)) continue;
    const long long blocks = cdiv(M, t.bm) * cdiv(N, t.bn);
    if (blocks >= want) return i;
    if (blocks > best_blocks) {
      best = i;
      best_blocks = blocks;
    }
  }
  return best;
}

// The shapes of one valid conv whose 32-bit offsets reach every element:
// x with 16 images to spare (dw's position lanes run up to 15 positions
// past the last), dz's virtual offsets of input pixels, and (K*K*Cin + 1)
// * Cout.  Returns 0 or a CUDA error.
int make_shapes(Shapes& s, int B, int H, int W, int Cin, int K, int Cout) {
  if (B < 1 || Cin < 1 || Cout < 1 || K < 1 || K > H || K > W ||
      H >= (1 << 15) || W >= (1 << 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const int Ho = H - K + 1, Wo = W - K + 1;
  const long long x_span = (long long)(B + 16) * H * W * Cin;
  const long long z_span =
      ((long long)B * Ho + H) * Wo * Cout + (long long)W * Cout;
  if (x_span > INT_MAX || z_span > INT_MAX ||
      ((long long)K * K * Cin + 1) * Cout > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  s = Shapes{B, H, W, Cin, K, Cout, Ho, Wo};
  return 0;
}

// dw's GEMM: its tile, and its slices over batch blocks of bb images.
struct DwPlan {
  int tile, n_rt, n_ct;  // dw's tile, row tiles, column tiles
  int Mw, P, S, L;       // rows; positions, slices a batch block; slice
  int slices;            // in all: B / bb * S
  long long floats;      // partial sums: slices * Mw * Cout
};

// Mw rows (K*K*Cin, + 1 for db's row in the fused call) over batch blocks
// of bb images (the fused call: one block of B).  Each block's P = bb*Ho*Wo
// positions are cut into S slices of L, the last shorter; L is a multiple
// of kBK (or the whole block) from the shapes and bb alone, about
// kDwBlocks blocks in all and at least kSliceMin positions.  Returns 0 or
// a CUDA error.
int dw_plan(DwPlan& d, const Shapes& s, int Mw, int bb) {
  if (bb < 1 || s.B % bb != 0) return static_cast<int>(cudaErrorInvalidValue);
  d.Mw = Mw;
  d.tile = fit_tile(Mw, s.Cout, kDwTiles, kCatchAll);
  const Tile& t = kTiles[d.tile];
  d.n_rt = (int)cdiv(Mw, t.bm);
  d.n_ct = (int)cdiv(s.Cout, t.bn);
  const long long blocks = s.B / bb;
  d.P = bb * s.Ho * s.Wo;
  const long long per = cdiv(cdiv((long long)s.B * s.Ho * s.Wo * d.n_rt *
                                  d.n_ct, kDwBlocks), kBK) * kBK;
  const long long L = per > kSliceMin ? per : kSliceMin;
  d.S = (int)cdiv(d.P, L);
  d.L = (int)(L < d.P ? L : d.P);  // one slice takes the whole block
  const long long slices = blocks * d.S;
  d.floats = slices * Mw * s.Cout;
  if (slices > 65535 || d.floats > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  d.slices = (int)slices;
  return 0;
}

// The fused call's plan: shapes, dw's, and the scratch layout, from the
// shapes alone.
struct Plan {
  Shapes s;
  DwPlan dw;
  long long dz_at, part_at, floats;  // scratch: wt, dz, partial sums
};

int make_plan(Plan& p, int B, int H, int W, int Cin, int K, int Cout,
              bool has_y) {
  int err = make_shapes(p.s, B, H, W, Cin, K, Cout);
  if (!err) err = dw_plan(p.dw, p.s, K * K * Cin + 1, B);
  if (err) return err;
  const long long wt = (long long)K * K * Cin * Cout;
  const long long dz = has_y ? (long long)B * p.s.Ho * p.s.Wo * Cout : 0;
  p.dz_at = cdiv(wt, 4) * 4;  // each part 16-byte aligned
  p.part_at = p.dz_at + cdiv(dz, 4) * 4;
  p.floats = p.part_at + p.dw.floats;
  if (p.floats > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

bool aligned16(const void* q) {
  return reinterpret_cast<uintptr_t>(q) % 16 == 0;
}

template <int BM, int BN, int TM, int TN>
cudaError_t launch_dx(const DxArgs& a, bool vec, cudaStream_t st) {
  constexpr int NT = TileShape<BM, BN, TM, TN>::NT;
  const dim3 grid((unsigned)cdiv(a.M, BM), (unsigned)cdiv(a.s.Cin, BN));
  if (grid.y > 65535) return cudaErrorInvalidValue;
  if (vec)
    dx_kernel<BM, BN, TM, TN, true><<<grid, NT, 0, st>>>(a);
  else
    dx_kernel<BM, BN, TM, TN, false><<<grid, NT, 0, st>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_dx_plan(int tile, const DxArgs& a, bool vec,
                           cudaStream_t st) {
  switch (tile) {
    case 0: return launch_dx<128, 64, 8, 8>(a, vec, st);
    case 1: return launch_dx<32, 128, 4, 8>(a, vec, st);
    case 2: return launch_dx<128, 32, 8, 4>(a, vec, st);
    case 3: return launch_dx<32, 32, 4, 4>(a, vec, st);
    default: return launch_dx<128, 8, 4, 4>(a, vec, st);
  }
}

// dx = the dz correlation with wt: dx tiles' work follows the taps that
// reach their pixels (at conv4 the middle pixel's 36 against a mean of
// 10.7), so dx aims at four times the rule's blocks, for the card to even
// out.  The tile does not enter dx's bits.
cudaError_t launch_dx_gemm(const float* dz, const float* wt, float* dx,
                           const Shapes& s, cudaStream_t st) {
  int want = 0;
  const cudaError_t e = min_blocks(&want);
  if (e != cudaSuccess) return e;
  const DxArgs a{dz, wt, dx, s.B * s.H * s.W, s};
  return launch_dx_plan(dx_tile_for(a.M, s.Cin, 4 * want), a,
                        s.Cin % 4 == 0 && aligned16(dx), st);
}

template <int BM, int BN, int TM, int TN>
cudaError_t launch_dw(const DwArgs& a, const DwPlan& d, bool vec,
                      cudaStream_t st) {
  constexpr int NT = TileShape<BM, BN, TM, TN>::NT;
  const dim3 grid(d.n_rt, d.n_ct, d.slices);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  if (vec)
    dw_kernel<BM, BN, TM, TN, true><<<grid, NT, 0, st>>>(a);
  else
    dw_kernel<BM, BN, TM, TN, false><<<grid, NT, 0, st>>>(a);
  return cudaGetLastError();
}

// dw's partial sums over d's slices into `part` (16-byte aligned).
cudaError_t launch_dw_gemm(const float* x, const float* dz, float* part,
                           const Shapes& s, const DwPlan& d,
                           cudaStream_t st) {
  const DwArgs a{x,   dz,  part, d.Mw, d.P,
                 d.S, d.L, s.Cout % 4 == 0 && aligned16(dz), s};
  const bool vec = s.Cin % 4 == 0 && aligned16(x);
  switch (d.tile) {
    case 0: return launch_dw<128, 64, 8, 8>(a, d, vec, st);
    case 1: return launch_dw<32, 128, 4, 8>(a, d, vec, st);
    case 2: return launch_dw<128, 32, 8, 4>(a, d, vec, st);
    default: return launch_dw<32, 32, 4, 4>(a, d, vec, st);
  }
}

int stride_grid(long long total) {
  const long long blocks = cdiv(total, kPrepThreads);
  return blocks < 1 ? 1 : (blocks > 2048 ? 2048 : (int)blocks);
}

}  // namespace

// Floats of scratch repro_conv2d_bwd needs for these shapes (has_y: y is
// given, so dz gets a buffer of its own), or a negative CUDA error.  The
// shapes alone decide it.
extern "C" int repro_conv2d_bwd_scratch(int B, int H, int W, int Cin, int K,
                                        int Cout, int has_y) {
  Plan p;
  const int err = make_plan(p, B, H, W, Cin, K, Cout, has_y != 0);
  return err ? -err : static_cast<int>(p.floats);
}

// y may be null (no tanh factor).  `scratch` holds
// repro_conv2d_bwd_scratch(..., y != null) floats, 16-byte aligned.
extern "C" int repro_conv2d_bwd(const float* x, const float* dy,
                                const float* y, const float* w, float* dx,
                                float* dw, float* db, float* scratch, int B,
                                int H, int W, int Cin, int K, int Cout,
                                void* stream) {
  Plan p;
  const int err = make_plan(p, B, H, W, Cin, K, Cout, y != nullptr);
  if (err) return err;
  if (!aligned16(scratch)) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wt = scratch;
  const float* dz = dy;
  const int n_dz = B * p.s.Ho * p.s.Wo * Cout;
  if (y != nullptr) dz = scratch + p.dz_at;
  const bool vec_dz = aligned16(dy) && aligned16(y) && n_dz % 4 == 0;
  const long long n_w = (long long)K * K * Cin * Cout;
  const long long n_prep = y == nullptr ? 0 : vec_dz ? n_dz / 4 : n_dz;
  prep_kernel<<<stride_grid(n_prep > n_w ? n_prep : n_w), kPrepThreads, 0,
                st>>>(
      dy, y, scratch + p.dz_at, n_dz, vec_dz, w, wt, K * K, Cin, Cout);
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) e = launch_dx_gemm(dz, wt, dx, p.s, st);
  float* part = scratch + p.part_at;
  if (e == cudaSuccess) e = launch_dw_gemm(x, dz, part, p.s, p.dw, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_out = p.dw.Mw * Cout;
  slice_sum_kernel<<<(unsigned)cdiv(n_out, 32), dim3(32, kSumLanes), 0, st>>>(
      part, dw, db, n_out, n_out - Cout, p.dw.slices);
  return static_cast<int>(cudaGetLastError());
}

// dx alone (dz = dy): w transposed into `wt` (K*K*Cin*Cout floats, 16-byte
// aligned), then the fused backward's dx GEMM.
extern "C" int repro_conv2d_dx(const float* dy, const float* w, float* wt,
                               float* dx, int B, int H, int W, int Cin,
                               int K, int Cout, void* stream) {
  Shapes s;
  const int err = make_shapes(s, B, H, W, Cin, K, Cout);
  if (err) return err;
  if (!aligned16(wt)) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  prep_kernel<<<stride_grid((long long)K * K * Cin * Cout), kPrepThreads, 0,
                st>>>(dy, nullptr, nullptr, 0, false, w, wt, K * K, Cin,
                      Cout);
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) e = launch_dx_gemm(dy, wt, dx, s, st);
  return static_cast<int>(e);
}

// Floats of partial sums repro_conv2d_dw needs for these shapes and batch
// blocks of bb images (a divisor of B), or a negative CUDA error.  The
// shapes and bb alone decide it.
extern "C" int repro_conv2d_dw_scratch(int B, int H, int W, int Cin, int K,
                                       int Cout, int bb) {
  Shapes s;
  DwPlan d;
  int err = make_shapes(s, B, H, W, Cin, K, Cout);
  if (!err) err = dw_plan(d, s, K * K * Cin, bb);
  return err ? -err : static_cast<int>(d.floats);
}

// dw alone (dz = dy), summed over batch blocks of bb images in block order;
// `part` holds repro_conv2d_dw_scratch(...) floats, 16-byte aligned.
extern "C" int repro_conv2d_dw(const float* x, const float* dy, float* dw,
                               float* part, int B, int H, int W, int Cin,
                               int K, int Cout, int bb, void* stream) {
  Shapes s;
  DwPlan d;
  int err = make_shapes(s, B, H, W, Cin, K, Cout);
  if (!err) err = dw_plan(d, s, K * K * Cin, bb);
  if (err) return err;
  if (!aligned16(part)) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = launch_dw_gemm(x, dy, part, s, d, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_dw = d.Mw * Cout;
  block_sum_kernel<<<(unsigned)cdiv(n_dw, 32), dim3(32, kSumLanes), 0, st>>>(
      part, dw, n_dw, B / bb, d.S);
  return static_cast<int>(cudaGetLastError());
}
