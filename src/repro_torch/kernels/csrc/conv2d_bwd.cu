// Fused backward of the valid, stride-1 convolution NHWC x HWIO -> NHWC:
// dx, dw and db from one launch, with the tanh derivative fused when the
// forward output y is given (dz = dy * (1 - y^2), else dz = dy), fp32 on
// CUDA cores.
//
// Replaces: src/repro/kernels/conv2d.py conv2d_bwd_fused (_bwd_body,
// _conv_bwd_kernel, _conv_bwd_tanh_kernel), the Pallas TPU kernel that
// walks K-1-padded dz slabs once, writes dx per slab and sums dw/db across
// the sequential batch grid in VMEM scratch.
//
// Bound on the H100: operations.  dx and dw each cost the forward's
// 2*B*Ho*Wo*Cout*K*K*Cin FLOP; at chaos-large's B=256 that is 7-8 GFLOP per
// inner layer against ~10-20 MB of activations and gradients.
//
// Design: one cooperative launch of as many 256-thread blocks as the card
// holds at once.  The blocks copy w transposed, meet at a grid-wide
// barrier, walk a list of work items, meet at a second barrier and finish
// the weight gradient:
//  * dw items, one per (Cin tile of up to 8, Cout tile of 32, chunk of the
//    B*Ho output rows): each warp owns one input channel and each lane one
//    output channel, and keeps all K*K taps' partial sums in registers.
//    Along an output row it slides a K x K window of x through registers,
//    so each position costs K loads of x and one of dz for K*K FMAs.  With
//    fewer than 8 input channels the spare warps take interleaved rows and
//    are summed in shared memory in warp order.  The item's partial sums
//    of dw (and of db, from the same dz loads) go to a scratch buffer.
//  * dx items, one per (image, block of input rows): the dz rows the block
//    needs, the K-1 halo and the K-1 column margins on both sides, are
//    staged in shared memory once, zero where they fall outside dz (bounds
//    checks here, no padding in device memory; up to kDxSmem bytes, opted
//    in above the default 48 KB).  Threads span Cin; each keeps 4 input
//    pixels x 4 input channels in registers (one channel where Cin is no
//    multiple of 4) and reads the flipped taps of w from a copy
//    transposed to (tap, Cout, Cin), so that a warp's weight loads are
//    contiguous and each float4 load feeds 16 FMAs.
//  * after the second barrier, each dw and db entry is the sum of its
//    chunks' partials in chunk order.
// The TPU kernel instead carries dw/db across its sequential grid; here the
// chunks run in parallel and the barrier replaces that order.  Every sum
// runs in an order fixed by the shapes and the card's SM count alone, with
// no atomics, so two runs on one card give the same bits.  dz is
// recomputed where it is read, rounded as dy * (1 - y*y) with no
// contraction, as the plain version rounds it.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPx = 4;      // dx: input pixels per thread
constexpr int kMaxK = 8;    // kernel sizes with a compiled dw path
// Shared memory a dx item's dz slab may take (opted in per kernel); the
// caller picks the rows per item to fit it.
constexpr int kDxSmem = 100 * 1024;

struct Args {
  const float* x;
  const float* dy;
  const float* y;
  const float* w;
  float* dx;
  float* dw;
  float* db;
  float* part;                // dw items' partial sums
  float* wt;                  // w transposed to (K*K, Cout, Cin)
  int B, H, W, Cin, K, Cout, Ho, Wo;
  int rb, n_rblk, cb;         // dx: rows per block, blocks per image, lanes
  int tci, wsl;               // dw: channels per Cin tile, warps per channel
  int n_ci_t, n_co_t;         // dw: Cin tiles, Cout tiles of 32
  int rpc, n_chunks;          // dw: output rows per chunk, chunks
  int tile_entries;           // dw: partials per (tile, chunk)
  int n_dw, n_dx;             // work items of each kind, in list order
};

__device__ __forceinline__ float dz_at(const Args& a, size_t i) {
  const float g = a.dy[i];
  if (a.y == nullptr) return g;
  const float v = a.y[i];
  return __fmul_rn(g, __fsub_rn(1.f, __fmul_rn(v, v)));
}

// ---------------------------------------------------------------- dw, db
// Position oj = oj0 + S of an output row: the window holds x[oi+kh, oj+kw]
// for all taps in slot (oj + kw) % K, so sliding by one column loads one
// column and moves nothing.  S is a constant, so every slot index is.
template <int K, int S>
__device__ __forceinline__ void dw_pos(const Args& a, const float* xr,
                                       size_t zr, int oj, float (&win)[K][K],
                                       float (&acc)[K * K], float& accb) {
  const size_t rs = (size_t)a.W * a.Cin;
#pragma unroll
  for (int kh = 0; kh < K; ++kh)
    win[kh][(S + K - 1) % K] =
        __ldg(xr + kh * rs + (size_t)(oj + K - 1) * a.Cin);
  const float z = dz_at(a, zr + (size_t)oj * a.Cout);
  accb += z;
#pragma unroll
  for (int kh = 0; kh < K; ++kh)
#pragma unroll
    for (int kw = 0; kw < K; ++kw)
      acc[kh * K + kw] = fmaf(win[kh][(S + kw) % K], z, acc[kh * K + kw]);
}

// K positions from oj0; with `tail`, only those before Wo.  Whole groups
// carry no bounds checks, so their loads can all be issued up front.
template <int K, bool kTail, int... S>
__device__ __forceinline__ void dw_group(const Args& a, const float* xr,
                                         size_t zr, int oj0,
                                         float (&win)[K][K],
                                         float (&acc)[K * K], float& accb,
                                         std::integer_sequence<int, S...>) {
  ((!kTail || oj0 + S < a.Wo
        ? dw_pos<K, S>(a, xr, zr, oj0 + S, win, acc, accb)
        : void()),
   ...);
}

// One output row of dz against the K x K window of x sliding along it.
template <int K>
__device__ __forceinline__ void dw_row(const Args& a, const float* xr,
                                       size_t zr, float (&acc)[K * K],
                                       float& accb) {
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
    dw_group<K, false>(a, xr, zr, oj0, win, acc, accb, seq);
  if (oj0 < a.Wo) dw_group<K, true>(a, xr, zr, oj0, win, acc, accb, seq);
}

// The sum over the wsl warps that split one channel's rows, in warp order;
// meaningful in the warps with wsub == 0.  Every thread of the block calls it.
__device__ __forceinline__ float sum_warps(const Args& a, float* red, float v,
                                           int wsub) {
  if (a.wsl == 1) return v;
  red[threadIdx.x] = v;
  __syncthreads();
  if (wsub == 0)
    for (int k = 1; k < a.wsl; ++k) v += red[threadIdx.x + k * a.tci * 32];
  __syncthreads();
  return v;
}

template <int K>
__device__ void dw_item(const Args& a, int item, float* red) {
  const int tile = item / a.n_chunks, chunk = item % a.n_chunks;
  const int ci_t = tile / a.n_co_t, co_t = tile % a.n_co_t;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int cil = warp % a.tci, wsub = warp / a.tci;
  const int co = co_t * 32 + lane, ci = ci_t * a.tci + cil;
  float acc[K * K];
  float accb = 0.f;
#pragma unroll
  for (int t = 0; t < K * K; ++t) acc[t] = 0.f;
  if (co < a.Cout && ci < a.Cin) {
    const int r_end = min(a.B * a.Ho, (chunk + 1) * a.rpc);
    for (int r = chunk * a.rpc + wsub; r < r_end; r += a.wsl) {
      const int n = r / a.Ho, oi = r - n * a.Ho;
      const float* xr = a.x + (((size_t)n * a.H + oi) * a.W) * a.Cin + ci;
      dw_row<K>(a, xr, (size_t)r * a.Wo * a.Cout + co, acc, accb);
    }
  }
  // entry e of a (tile, chunk): (tap * tci + cil) * 32 + lane, then 32 db
  float* part =
      a.part + ((size_t)tile * a.n_chunks + chunk) * a.tile_entries;
#pragma unroll
  for (int t = 0; t < K * K; ++t) {
    const float v = sum_warps(a, red, acc[t], wsub);
    if (wsub == 0) part[(t * a.tci + cil) * 32 + lane] = v;
  }
  const float vb = sum_warps(a, red, accb, wsub);
  if (wsub == 0 && cil == 0) part[K * K * a.tci * 32 + lane] = vb;
}

// After the second barrier: each entry is the sum of its chunks in chunk
// order.
__device__ void finish_dw(const Args& a) {
  const int KK = a.K * a.K;
  const size_t total = (size_t)a.n_ci_t * a.n_co_t * a.tile_entries;
  for (size_t g = (size_t)blockIdx.x * blockDim.x + threadIdx.x; g < total;
       g += (size_t)gridDim.x * blockDim.x) {
    const int tile = (int)(g / a.tile_entries);
    const int e = (int)(g % a.tile_entries);
    const int ci_t = tile / a.n_co_t, co_t = tile % a.n_co_t;
    const int lane = e % 32;
    const int co = co_t * 32 + lane;
    const int db_at = KK * a.tci * 32;
    int ci = 0, tap = 0;
    bool dw_entry = e < db_at;
    if (dw_entry) {
      tap = e / (a.tci * 32);
      ci = ci_t * a.tci + (e / 32) % a.tci;
      if (ci >= a.Cin || co >= a.Cout) continue;
    } else if (ci_t != 0 || co >= a.Cout) {
      continue;
    }
    const float* p = a.part + (size_t)tile * a.n_chunks * a.tile_entries + e;
    float s = 0.f;
    for (int c = 0; c < a.n_chunks; ++c)
      s += __ldcg(p + (size_t)c * a.tile_entries);
    if (dw_entry)
      a.dw[((size_t)tap * a.Cin + ci) * a.Cout + co] = s;
    else
      a.db[co] = s;
  }
}

// -------------------------------------------------------------------- dx
// kCi input channels per thread: 4 (one float4 of the transposed weights)
// when Cin is a multiple of 4, else 1.
template <int kCi>
__device__ void dx_item(const Args& a, int item, float* slab) {
  const int n = item / a.n_rblk;
  const int r0 = (item % a.n_rblk) * a.rb;
  const int rows = min(a.rb, a.H - r0);
  const int K = a.K, Cout = a.Cout, Cin = a.Cin;
  const int Wp = a.W + K - 1;
  const int slab_elems = (rows + K - 1) * Wp * Cout;
  for (int i = threadIdx.x; i < slab_elems; i += blockDim.x) {
    const int co = i % Cout;
    const int t = (i / Cout) % Wp;
    const int s = i / (Cout * Wp);
    const int g = r0 - (K - 1) + s;  // dz row
    const int c = t - (K - 1);       // dz column
    float v = 0.f;
    if (g >= 0 && g < a.Ho && c >= 0 && c < a.Wo)
      v = dz_at(a, (((size_t)n * a.Ho + g) * a.Wo + c) * Cout + co);
    slab[i] = v;
  }
  __syncthreads();

  const int lanes = a.cb;  // threads along Cin, kCi channels each
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
            // plain loads, cached in L1: this SM has not read wt before
            // the barrier after which it was written, so no line is stale
            if constexpr (kCi == 4) {
              const float4 q =
                  *reinterpret_cast<const float4*>(wt + (size_t)co * Cin);
              wv[0] = q.x;
              wv[1] = q.y;
              wv[2] = q.z;
              wv[3] = q.w;
            } else {
              wv[0] = wt[(size_t)co * Cin];
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

// w (K*K, Cin, Cout) -> wt (K*K, Cout, Cin), by the whole grid.
__device__ void transpose_w(const Args& a) {
  const size_t total = (size_t)a.K * a.K * a.Cin * a.Cout;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int co = (int)(i % a.Cout);
    const size_t t = i / a.Cout;
    const int ci = (int)(t % a.Cin);
    const size_t tap = t / a.Cin;
    a.wt[(tap * a.Cout + co) * a.Cin + ci] = __ldg(a.w + i);
  }
}

// Every block reaches both barriers: the item functions return to the loop,
// nothing returns out of the kernel.
template <int K, int kCi>
__global__ void __launch_bounds__(kThreads) conv2d_bwd_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  transpose_w(a);
  grid.sync();
  const int items = a.n_dw + a.n_dx;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    if (it < a.n_dw)
      dw_item<K>(a, it, smem);
    else
      dx_item<kCi>(a, it - a.n_dw, smem);
    __syncthreads();  // shared memory is reused by the next item
  }
  grid.sync();
  finish_dw(a);
}

template <int kCi>
const void* kernel_for(int K) {
  switch (K) {
    case 1: return (const void*)conv2d_bwd_kernel<1, kCi>;
    case 2: return (const void*)conv2d_bwd_kernel<2, kCi>;
    case 3: return (const void*)conv2d_bwd_kernel<3, kCi>;
    case 4: return (const void*)conv2d_bwd_kernel<4, kCi>;
    case 5: return (const void*)conv2d_bwd_kernel<5, kCi>;
    case 6: return (const void*)conv2d_bwd_kernel<6, kCi>;
    case 7: return (const void*)conv2d_bwd_kernel<7, kCi>;
    case 8: return (const void*)conv2d_bwd_kernel<8, kCi>;
    default: return nullptr;
  }
}

// Fill in the launch plan; returns the grid size, or a negative CUDA error.
int plan(Args& a, int B, int H, int W, int Cin, int K, int Cout, int rb,
         const void** fn, size_t* smem) {
  if (K < 1 || K > kMaxK) return -static_cast<int>(cudaErrorInvalidValue);
  a.B = B; a.H = H; a.W = W; a.Cin = Cin; a.K = K; a.Cout = Cout;
  a.Ho = H - K + 1;
  a.Wo = W - K + 1;
  a.rb = rb;
  a.n_rblk = (H + rb - 1) / rb;
  const int ci_per = Cin % 4 == 0 ? 4 : 1;  // dx channels per thread
  a.cb = Cin / ci_per < 32 ? Cin / ci_per : 32;
  *fn = ci_per == 4 ? kernel_for<4>(K) : kernel_for<1>(K);
  *smem = (size_t)(rb + K - 1) * (W + K - 1) * Cout * sizeof(float);
  if (*smem < kThreads * sizeof(float)) *smem = kThreads * sizeof(float);
  if (*smem > (size_t)kDxSmem)
    return -static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      *fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kDxSmem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, *fn,
                                                        kThreads, *smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (per_sm < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
  const int cap = per_sm * sms;
  a.tci = 1;
  while (a.tci * 2 <= kWarps && a.tci * 2 <= Cin) a.tci *= 2;
  a.wsl = kWarps / a.tci;
  a.n_ci_t = (Cin + a.tci - 1) / a.tci;
  a.n_co_t = (Cout + 31) / 32;
  const int tiles = a.n_ci_t * a.n_co_t;
  const int rows = B * a.Ho;
  // about two dw items per block, each chunk at least one row
  int chunks = (2 * cap + tiles - 1) / tiles;
  if (chunks > rows) chunks = rows;
  a.rpc = (rows + chunks - 1) / chunks;
  a.n_chunks = (rows + a.rpc - 1) / a.rpc;
  a.tile_entries = (K * K * a.tci + 1) * 32;
  a.n_dw = tiles * a.n_chunks;
  a.n_dx = B * a.n_rblk;
  const int items = a.n_dw + a.n_dx;
  return items < cap ? items : cap;
}

// The scratch holds the transposed weights first (rounded up to whole
// float4s), then the dw items' partials.
size_t wt_floats(const Args& a) {
  return ((size_t)a.K * a.K * a.Cin * a.Cout + 3) / 4 * 4;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Floats of scratch the launch below needs for these shapes on the current
// device, or a negative CUDA error.
extern "C" int repro_conv2d_bwd_scratch(int B, int H, int W, int Cin, int K,
                                        int Cout, int rb) {
  Args a;
  const void* fn;
  size_t smem;
  const int grid = plan(a, B, H, W, Cin, K, Cout, rb, &fn, &smem);
  if (grid < 0) return grid;
  return (int)(wt_floats(a) +
               (size_t)a.n_ci_t * a.n_co_t * a.n_chunks * a.tile_entries);
}

// y may be null (no tanh factor).  rb input rows per dx item; the caller
// keeps (rb + K - 1) * (W + K - 1) * Cout floats within kDxSmem bytes and
// passes `part` with repro_conv2d_bwd_scratch(...) floats.
extern "C" int repro_conv2d_bwd(const float* x, const float* dy,
                                const float* y, const float* w, float* dx,
                                float* dw, float* db, float* part, int B,
                                int H, int W, int Cin, int K, int Cout,
                                int rb, void* stream) {
  Args a;
  const void* fn;
  size_t smem;
  const int grid = plan(a, B, H, W, Cin, K, Cout, rb, &fn, &smem);
  if (grid < 0) return -grid;
  if (!aligned16(part) || (Cin % 4 == 0 && !aligned16(dx)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  a.x = x; a.dy = dy; a.y = y; a.w = w; a.dx = dx; a.dw = dw; a.db = db;
  a.wt = part;
  a.part = part + wt_floats(a);
  void* params[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel(
      fn, dim3(grid), dim3(kThreads), params, smem,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
