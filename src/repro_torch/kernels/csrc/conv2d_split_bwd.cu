// Split backward of the valid, stride-1 convolution NHWC x HWIO -> NHWC:
// dx alone and dw alone, each from one entry point, fp32 on CUDA cores, no
// bias and no tanh factor.
//
// Replaces: src/repro/kernels/conv2d.py conv2d_dx (:281, body
// _conv_dx_kernel :262) and conv2d_dw (:330, body _conv_dw_kernel :303),
// the TPU's un-fused baseline of conv2d_bwd_fused.  conv2d_dx correlates
// the K-1-padded dy with the flipped taps over a grid of batch blocks;
// conv2d_dw sums patch^T . dy over the sequential grid of batch blocks in
// VMEM scratch.
//
// Bound on the H100: operations.  Each of dx and dw costs the forward's
// 2*B*Ho*Wo*Cout*K*K*Cin FLOP; at chaos-large's B=256 that is 11.5 GFLOP
// per gradient over its three conv layers, against some 100 MB of
// activations and gradients.
//
// Design: each entry point issues two device kernels on the caller's
// stream.
//  * repro_conv2d_dx: the first kernel copies w transposed to (K*K, Cout,
//    Cin) into the caller's scratch, so that a warp's weight loads are
//    contiguous.  The second runs one 256-thread block per (image, block
//    of input rows): the dy rows the block needs, the K-1 halo and the K-1
//    column margins on both sides, are staged in shared memory once, zero
//    where they fall outside dy (bounds checks here, no padding in device
//    memory; up to kDxSmem bytes, opted in above the default 48 KB).  The
//    rows per block are as many as fit in kDxSmem, fewer where that leaves
//    less than min_blocks (two an SM, conv2d_common.cuh) blocks, spread
//    evenly (dx_plan).  Threads span
//    Cin; each keeps 4 input pixels x 4 input channels in registers (one
//    channel where Cin is no multiple of 4) and reads the flipped taps, so
//    that each float4 weight load feeds 16 FMAs.  Each dx element is
//    written by one thread, its sum taken over taps, then output channels,
//    in that order.
//  * repro_conv2d_dw: the sum over batch blocks, which the TPU kernel
//    carries across its sequential grid, becomes fixed-order partials.
//    The first kernel runs one 256-thread block per (batch block, Cin tile
//    of up to 8, Cout tile of 32): each warp owns one input channel and
//    each lane one output channel, and keeps all K*K taps' partial sums in
//    registers.  Along an output row it slides a K x K window of x through
//    registers, so each position costs K loads of x and one of dy for K*K
//    FMAs.  Where a block has fewer channels than warps, the spare warps
//    take interleaved rows of the batch block and are summed in shared
//    memory in warp order; the Cin tiles are halved toward min_blocks
//    blocks.  Each block writes its batch block's partial
//    for every tap of its tile to the caller's scratch.  The second kernel
//    sums each dw entry's partials in batch-block order.
// dx's order is fixed by the shapes alone.  dw's follows the shapes, the
// batch block and, through the Cin tiles' warp split, min_blocks, which is
// the SM count: on every 132-SM H100 it is what the former constant 264
// gave.  Nothing uses atomics: two runs on one card give the same bits, and
// the batch block groups the sum on the card as it does in the reference.
// One wrapper call is one counted launch and two device kernels.  The
// redesign of this pair (ROADMAP 11r) takes the SM count out of dw's order,
// as conv2d_bwd.cu's GEMMs do.
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <utility>

#include "conv2d_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPx = 4;      // dx: input pixels per thread
constexpr int kMaxK = 8;    // kernel sizes with a compiled dw path
// Shared memory a dx block's dy slab may take (opted in per kernel).
constexpr int kDxSmem = 100 * 1024;

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// -------------------------------------------------------------------- dx
struct DxArgs {
  const float* dy;
  const float* wt;  // w transposed to (K*K, Cout, Cin)
  float* dx;
  int H, W, Cin, K, Cout, Ho, Wo;
  int rb, n_rblk;   // input rows per block, blocks per image
  int lanes;        // threads along Cin
};

// w (K*K, Cin, Cout) -> wt (K*K, Cout, Cin).
__global__ void __launch_bounds__(kThreads)
    transpose_w_kernel(const float* __restrict__ w, float* __restrict__ wt,
                       int taps, int Cin, int Cout) {
  const size_t total = (size_t)taps * Cin * Cout;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int co = (int)(i % Cout);
    const size_t t = i / Cout;
    const int ci = (int)(t % Cin);
    const size_t tap = t / Cin;
    wt[(tap * Cout + co) * Cin + ci] = __ldg(w + i);
  }
}

// Fills a's shapes and picks the input rows per block: as many as keep the
// slab of rows + K - 1 dy rows, each W + K - 1 wide, within kDxSmem, and
// no more than leave B*H/min_blk rows to a block; as few blocks per image
// as that allows, rows spread evenly.  Returns the slab's bytes, or a
// negative CUDA error.
long long dx_plan(DxArgs& a, int B, int H, int W, int Cin, int K, int Cout,
                  int min_blk) {
  if (K < 1 || K > H || K > W || B < 1 || Cin < 1 || Cout < 1)
    return -static_cast<long long>(cudaErrorInvalidValue);
  a.H = H; a.W = W; a.Cin = Cin; a.K = K; a.Cout = Cout;
  a.Ho = H - K + 1;
  a.Wo = W - K + 1;
  const long long row = (long long)(W + K - 1) * Cout * 4;  // bytes
  const long long fit = kDxSmem / row - (K - 1);
  if (fit < 1) return -static_cast<long long>(cudaErrorInvalidValue);
  const long long want = ((long long)B * H + min_blk - 1) / min_blk;
  long long most = fit < want ? fit : want;
  if (most > H) most = H;
  a.n_rblk = (int)((H + most - 1) / most);
  a.rb = (H + a.n_rblk - 1) / a.n_rblk;
  return (a.rb + K - 1) * row;
}

// kCi input channels per thread: 4 (one float4 of the transposed weights)
// when Cin is a multiple of 4, else 1.
template <int kCi>
__global__ void __launch_bounds__(kThreads) conv2d_dx_kernel(DxArgs a) {
  extern __shared__ __align__(16) float slab[];
  const int n = blockIdx.x / a.n_rblk;
  const int r0 = (blockIdx.x % a.n_rblk) * a.rb;
  const int rows = min(a.rb, a.H - r0);
  const int K = a.K, Cout = a.Cout, Cin = a.Cin;
  const int Wp = a.W + K - 1;
  const int slab_elems = (rows + K - 1) * Wp * Cout;
  for (int i = threadIdx.x; i < slab_elems; i += blockDim.x) {
    const int co = i % Cout;
    const int t = (i / Cout) % Wp;
    const int s = i / (Cout * Wp);
    const int g = r0 - (K - 1) + s;  // dy row
    const int c = t - (K - 1);       // dy column
    float v = 0.f;
    if (g >= 0 && g < a.Ho && c >= 0 && c < a.Wo)
      v = __ldg(a.dy + (((size_t)n * a.Ho + g) * a.Wo + c) * Cout + co);
    slab[i] = v;
  }
  __syncthreads();

  const int lanes = a.lanes;  // kCi channels each
  const int lane = threadIdx.x % lanes;
  const int grp = threadIdx.x / lanes;
  const int ngrp = blockDim.x / lanes;
  if (grp >= ngrp) return;  // the threads past the last whole group idle
  const int npix = rows * a.W;
  float* dxb = a.dx + ((size_t)n * a.H + r0) * a.W * Cin;
  for (int ci = lane * kCi; ci < Cin; ci += lanes * kCi) {
    for (int p0 = grp * kPx; p0 < npix; p0 += ngrp * kPx) {
      int base[kPx];
      float acc[kPx][kCi];
#pragma unroll
      for (int j = 0; j < kPx; ++j) {
        const int p = min(p0 + j, npix - 1);  // tail lanes recompute the last
        base[j] = ((p / a.W) * Wp + p % a.W) * Cout;
#pragma unroll
        for (int v = 0; v < kCi; ++v) acc[j][v] = 0.f;
      }
      for (int kh = 0; kh < K; ++kh) {
        for (int kw = 0; kw < K; ++kw) {
          const float* wt = a.wt + (size_t)(kh * K + kw) * Cout * Cin + ci;
          const float* sb = slab + ((K - 1 - kh) * Wp + (K - 1 - kw)) * Cout;
          for (int co = 0; co < Cout; ++co) {
            float wv[kCi];
            if constexpr (kCi == 4) {
              const float4 q =
                  __ldg(reinterpret_cast<const float4*>(wt + (size_t)co * Cin));
              wv[0] = q.x;
              wv[1] = q.y;
              wv[2] = q.z;
              wv[3] = q.w;
            } else {
              wv[0] = __ldg(wt + (size_t)co * Cin);
            }
#pragma unroll
            for (int j = 0; j < kPx; ++j) {
              const float sv = sb[base[j] + co];
#pragma unroll
              for (int v = 0; v < kCi; ++v)
                acc[j][v] = fmaf(sv, wv[v], acc[j][v]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kPx; ++j) {
        if (p0 + j >= npix) continue;
        float* out = dxb + (size_t)(p0 + j) * Cin + ci;
        if constexpr (kCi == 4)
          *reinterpret_cast<float4*>(out) =
              make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
        else
          *out = acc[j][0];
      }
    }
  }
}

// -------------------------------------------------------------------- dw
struct DwArgs {
  const float* x;
  const float* dy;
  float* dw;
  float* part;        // one partial per (batch block, tile, tap, ci, lane)
  int B, H, W, Cin, K, Cout, Ho, Wo;
  int bb, n_bb;       // images per batch block, batch blocks
  int tci, wsl;       // channels per Cin tile, warps per channel
  int n_ci_t, n_co_t; // Cin tiles, Cout tiles of 32
  int tile_entries;   // partials per (batch block, tile)
};

// Cin tiles are halved toward min_blk blocks.
int dw_plan(DwArgs& a, int B, int H, int W, int Cin, int K, int Cout,
            int bb, int min_blk) {
  if (K < 1 || K > kMaxK || K > H || K > W || B < 1 || Cin < 1 ||
      Cout < 1 || bb < 1 || B % bb != 0)
    return -static_cast<int>(cudaErrorInvalidValue);
  a.B = B; a.H = H; a.W = W; a.Cin = Cin; a.K = K; a.Cout = Cout;
  a.Ho = H - K + 1;
  a.Wo = W - K + 1;
  a.bb = bb;
  a.n_bb = B / bb;
  a.n_co_t = (Cout + 31) / 32;
  a.tci = 1;
  while (a.tci * 2 <= kWarps && a.tci * 2 <= Cin) a.tci *= 2;
  while (a.tci > 1 &&
         (long long)a.n_bb * ((Cin + a.tci - 1) / a.tci) * a.n_co_t <
             min_blk)
    a.tci /= 2;
  a.wsl = kWarps / a.tci;
  a.n_ci_t = (Cin + a.tci - 1) / a.tci;
  a.tile_entries = K * K * a.tci * 32;
  const long long floats =
      (long long)a.n_bb * a.n_ci_t * a.n_co_t * a.tile_entries;
  if (floats > INT_MAX) return -static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(floats);
}

// Position oj = oj0 + S of an output row: the window holds x[oi+kh, oj+kw]
// for all taps in slot (oj + kw) % K, so sliding by one column loads one
// column and moves nothing.  S is a constant, so every slot index is.
template <int K, int S>
__device__ __forceinline__ void dw_pos(const DwArgs& a, const float* xr,
                                       const float* zr, int oj,
                                       float (&win)[K][K],
                                       float (&acc)[K * K]) {
  const size_t rs = (size_t)a.W * a.Cin;
#pragma unroll
  for (int kh = 0; kh < K; ++kh)
    win[kh][(S + K - 1) % K] =
        __ldg(xr + kh * rs + (size_t)(oj + K - 1) * a.Cin);
  const float z = __ldg(zr + (size_t)oj * a.Cout);
#pragma unroll
  for (int kh = 0; kh < K; ++kh)
#pragma unroll
    for (int kw = 0; kw < K; ++kw)
      acc[kh * K + kw] = fmaf(win[kh][(S + kw) % K], z, acc[kh * K + kw]);
}

// K positions from oj0; with kTail, only those before Wo.  Whole groups
// carry no bounds checks, so their loads can all be issued up front.
template <int K, bool kTail, int... S>
__device__ __forceinline__ void dw_group(const DwArgs& a, const float* xr,
                                         const float* zr, int oj0,
                                         float (&win)[K][K],
                                         float (&acc)[K * K],
                                         std::integer_sequence<int, S...>) {
  ((!kTail || oj0 + S < a.Wo ? dw_pos<K, S>(a, xr, zr, oj0 + S, win, acc)
                             : void()),
   ...);
}

// One output row of dy against the K x K window of x sliding along it.
template <int K>
__device__ __forceinline__ void dw_row(const DwArgs& a, const float* xr,
                                       const float* zr, float (&acc)[K * K]) {
  const size_t rs = (size_t)a.W * a.Cin;
  float win[K][K];
#pragma unroll
  for (int kh = 0; kh < K; ++kh)
#pragma unroll
    for (int kw = 0; kw < K - 1; ++kw)
      win[kh][kw] = __ldg(xr + kh * rs + (size_t)kw * a.Cin);
  constexpr auto seq = std::make_integer_sequence<int, K>{};
  int oj0 = 0;
  for (; oj0 + K <= a.Wo; oj0 += K)
    dw_group<K, false>(a, xr, zr, oj0, win, acc, seq);
  if (oj0 < a.Wo) dw_group<K, true>(a, xr, zr, oj0, win, acc, seq);
}

// The sum over the wsl warps that split one channel's rows, in warp order;
// meaningful in the warps with wsub == 0.  Every thread of the block calls it.
__device__ __forceinline__ float sum_warps(const DwArgs& a, float* red,
                                           float v, int wsub) {
  if (a.wsl == 1) return v;
  red[threadIdx.x] = v;
  __syncthreads();
  if (wsub == 0)
    for (int k = 1; k < a.wsl; ++k) v += red[threadIdx.x + k * a.tci * 32];
  __syncthreads();
  return v;
}

// One block per (batch block, tile); blockIdx.x = bblk * tiles + tile.
template <int K>
__global__ void __launch_bounds__(kThreads) dw_partial_kernel(DwArgs a) {
  __shared__ float red[kThreads];
  const int tiles = a.n_ci_t * a.n_co_t;
  const int bblk = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int ci_t = tile / a.n_co_t, co_t = tile % a.n_co_t;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int cil = warp % a.tci, wsub = warp / a.tci;
  const int co = co_t * 32 + lane, ci = ci_t * a.tci + cil;
  float acc[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) acc[t] = 0.f;
  if (co < a.Cout && ci < a.Cin) {
    const int r_end = (bblk + 1) * a.bb * a.Ho;
    for (int r = bblk * a.bb * a.Ho + wsub; r < r_end; r += a.wsl) {
      const int n = r / a.Ho, oi = r - n * a.Ho;
      const float* xr = a.x + (((size_t)n * a.H + oi) * a.W) * a.Cin + ci;
      dw_row<K>(a, xr, a.dy + (size_t)r * a.Wo * a.Cout + co, acc);
    }
  }
  // entry e of a (batch block, tile): (tap * tci + cil) * 32 + lane
  float* part = a.part + (size_t)blockIdx.x * a.tile_entries;
#pragma unroll
  for (int t = 0; t < K * K; ++t) {
    const float v = sum_warps(a, red, acc[t], wsub);
    if (wsub == 0) part[(t * a.tci + cil) * 32 + lane] = v;
  }
}

// Each dw entry (tap, ci, co) is the sum of its batch blocks' partials in
// batch-block order.
__global__ void __launch_bounds__(kThreads) dw_sum_kernel(DwArgs a) {
  const size_t total = (size_t)a.K * a.K * a.Cin * a.Cout;
  const size_t bstride =
      (size_t)a.n_ci_t * a.n_co_t * a.tile_entries;  // one batch block
  for (size_t g = (size_t)blockIdx.x * blockDim.x + threadIdx.x; g < total;
       g += (size_t)gridDim.x * blockDim.x) {
    const int co = (int)(g % a.Cout);
    const size_t t = g / a.Cout;
    const int ci = (int)(t % a.Cin);
    const int tap = (int)(t / a.Cin);
    const int tile = (ci / a.tci) * a.n_co_t + co / 32;
    const int e = (tap * a.tci + ci % a.tci) * 32 + co % 32;
    const float* p = a.part + (size_t)tile * a.tile_entries + e;
    float s = 0.f;
    for (int b = 0; b < a.n_bb; ++b) s += p[(size_t)b * bstride];
    a.dw[g] = s;
  }
}

const void* dw_kernel_for(int K) {
  switch (K) {
    case 1: return (const void*)dw_partial_kernel<1>;
    case 2: return (const void*)dw_partial_kernel<2>;
    case 3: return (const void*)dw_partial_kernel<3>;
    case 4: return (const void*)dw_partial_kernel<4>;
    case 5: return (const void*)dw_partial_kernel<5>;
    case 6: return (const void*)dw_partial_kernel<6>;
    case 7: return (const void*)dw_partial_kernel<7>;
    case 8: return (const void*)dw_partial_kernel<8>;
    default: return nullptr;
  }
}

// Blocks for a grid-stride loop over `total` entries.
int stride_grid(size_t total) {
  const size_t blocks = (total + kThreads - 1) / kThreads;
  return blocks < 1024 ? (blocks > 0 ? (int)blocks : 1) : 1024;
}

}  // namespace

// `wt` holds K*K*Cin*Cout floats, 16-byte aligned.
extern "C" int repro_conv2d_dx(const float* dy, const float* w, float* wt,
                               float* dx, int B, int H, int W, int Cin,
                               int K, int Cout, void* stream) {
  DxArgs a;
  int min_blk = 0;
  cudaError_t err = min_blocks(&min_blk);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long smem = dx_plan(a, B, H, W, Cin, K, Cout, min_blk);
  if (smem < 0) return static_cast<int>(-smem);
  a.dy = dy; a.wt = wt; a.dx = dx;
  const int ci_per = Cin % 4 == 0 ? 4 : 1;
  a.lanes = Cin / ci_per < 32 ? Cin / ci_per : 32;
  const void* fn = ci_per == 4 ? (const void*)conv2d_dx_kernel<4>
                               : (const void*)conv2d_dx_kernel<1>;
  if (!aligned16(wt) || (ci_per == 4 && !aligned16(dx)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kDxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t w_elems = (size_t)K * K * Cin * Cout;
  transpose_w_kernel<<<stride_grid(w_elems), kThreads, 0, s>>>(w, wt, K * K,
                                                                Cin, Cout);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  void* params[] = {&a};
  err = cudaLaunchKernel(fn, dim3(B * a.n_rblk), dim3(kThreads), params,
                         (size_t)smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Floats of scratch repro_conv2d_dw needs for these shapes and bb images
// per batch block on the current device, or a negative CUDA error.
extern "C" int repro_conv2d_dw_scratch(int B, int H, int W, int Cin, int K,
                                       int Cout, int bb) {
  DwArgs a;
  int min_blk = 0;
  const cudaError_t err = min_blocks(&min_blk);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return dw_plan(a, B, H, W, Cin, K, Cout, bb, min_blk);
}

// bb images per batch block (a divisor of B); `part` holds
// repro_conv2d_dw_scratch(...) floats.
extern "C" int repro_conv2d_dw(const float* x, const float* dy, float* dw,
                               float* part, int B, int H, int W, int Cin,
                               int K, int Cout, int bb, void* stream) {
  DwArgs a;
  int min_blk = 0;
  cudaError_t err = min_blocks(&min_blk);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int floats = dw_plan(a, B, H, W, Cin, K, Cout, bb, min_blk);
  if (floats < 0) return -floats;
  a.x = x; a.dy = dy; a.dw = dw; a.part = part;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* params[] = {&a};
  const int blocks = a.n_bb * a.n_ci_t * a.n_co_t;
  err = cudaLaunchKernel(dw_kernel_for(K), dim3(blocks),
                                     dim3(kThreads), params, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  dw_sum_kernel<<<stride_grid((size_t)K * K * Cin * Cout), kThreads, 0, s>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}
