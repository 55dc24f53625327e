// Fused backward of the fully connected layer y = act(x @ w + b): dx, dw
// and db from one call, with the tanh derivative fused when the forward
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
// Design: two register-tiled GEMMs in one launch, after dz is computed once.
//   * dz: with y given, a first kernel writes dz (B, Dout) into a workspace
//     the wrapper allocates, rounded as dy * (1 - y*y) with no contraction,
//     as the plain version rounds it; without y the GEMMs read dy itself.
//   * dw = x^T dz and dx = dz w^T: one grid of 64-thread blocks, each a tile
//     of dw (the first blocks: their chain over the batch is the longer
//     one) or a 32 x 32 tile of dx.  A thread holds a 4 x 4 tile of outputs
//     and reads its operands as float4 from shared memory, two 16-byte
//     loads for 16 FMAs; the reduction comes in chunks of 16 entries
//     through a kStagesFb-stage cp.async ring with one barrier per chunk,
//     as fc.cu feeds fc_fwd.  dw's operands are k-major in memory (rows of
//     x and dz over the batch) and are staged so; dx's (rows of dz and w
//     over Dout) are staged row by row with a padded stride, and a thread
//     reads four k of each of its rows at a time.  Where 32 x 32 dw tiles
//     would leave SMs without a block, dw takes 16 x 16 tiles of 2 x 2 a
//     thread instead: each thread's chain of FMAs over the batch is then a
//     quarter as long, and that chain, not the card's FMA rate, sets the
//     time of a small layer.  Each copying thread keeps one column (dw) or
//     one set of rows (dx) for the whole reduction and steps a pointer.
//   * db inside the dw pass: the dw blocks of the first Din tile stage dz
//     over the batch in order anyway; the threads of their first row add
//     db's chain from the same float4 of dz, so no block walks B after the
//     GEMMs.
// At chaos-large's (256, 900) -> 150 the grid is 145 dw blocks (29 Din
// tiles x 5 Dout tiles of 32) and 232 dx blocks (8 batch tiles x 29 Din
// tiles): 377 blocks of 2 warps for 132 SMs; at (256, 150) -> 10, 10 dw
// blocks of 16 x 16 and 40 dx blocks.  Ragged edges load zeros (cp.async
// with no source bytes).
//
// Bits: every dx[b, i] is one thread's fmaf(dz, w, acc) chain over o = 0 ...
// Dout-1 in order, every dw[i, o] one fmaf(x, dz, acc) chain over b in
// order, db[o] one chain of adds over b in order: the parent kernel's
// orders.  Chunks of 16 pad each chain to the parent's tile multiple with
// the same fmaf(0, 0, acc) steps (db with + 0 steps, which leave a sum
// that started at +0 unchanged), so the outputs equal the parent's bit for
// bit.  No reduction is split and nothing is atomic.
#include <cuda_runtime.h>

#include "conv2d_common.cuh"

namespace {

constexpr int kThreadsFb = 64;  // 8 x 8 threads a block
constexpr int kTSideFb = 8;
constexpr int kBKFb = 16;       // reduction entries per chunk
constexpr int kStagesFb = 6;    // chunks in shared memory
constexpr int kDxTile = 32;     // dx: 32 x 32 outputs, 4 x 4 a thread
constexpr int kLdFb = kBKFb + 4;  // dx rows' stride: rows 8 apart, distinct banks

// dw: x and dz k-major (batch rows), as they lie in memory; at most 32 wide.
struct DwStage {
  float x[kBKFb][32];
  float dz[kBKFb][32];
};
// dx: rows of dz (batch) and of w (Din), each over a chunk of Dout.
struct DxStage {
  float dz[kDxTile][kLdFb];
  float w[kDxTile][kLdFb];
};
union __align__(16) FbStage {
  DwStage dw;
  DxStage dx;
};

struct Args {
  const float* x;
  const float* dz;  // the workspace, or dy when there is no tanh factor
  const float* w;
  float* dx;
  float* dw;
  float* db;
  int B, Din, Dout;
  int n_in_t, n_out_t;  // dw's tiles along Din and Dout
  int n_dw, n_dx_in;    // dw blocks (first in the grid); dx tiles along Din
};

__global__ void __launch_bounds__(256)
    fc_dz_kernel(const float* __restrict__ dy, const float* __restrict__ y,
                 float* __restrict__ dz, long long n) {
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  if (i < n) {
    const float v = y[i];
    dz[i] = __fmul_rn(dy[i], __fsub_rn(1.f, __fmul_rn(v, v)));
  }
}

// Wait until at most kStagesFb - 2 groups of copies are in flight.
__device__ __forceinline__ void cp_async_wait_fb() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStagesFb - 2));
}

// Chunk c lands in stage c % kStagesFb; before chunk c is multiplied, the
// copies of chunk c + kStagesFb - 1 start, into the stage every thread
// finished with before this iteration's barrier.  load(stage, k0) copies
// the chunk that starts at reduction entry k0.
template <class Load, class Step>
__device__ __forceinline__ void ring(FbStage* st, int nchunks, Load& load,
                                     Step& step) {
  for (int c = 0; c < kStagesFb - 1; ++c) {
    if (c < nchunks) load(st[c], c * kBKFb);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait_fb();
    __syncthreads();
    const int nc = c + kStagesFb - 1;
    if (nc < nchunks) load(st[nc % kStagesFb], nc * kBKFb);
    cp_async_commit();
    step(st[c % kStagesFb]);
  }
}

template <int T>
struct Vec;  // T consecutive floats of shared memory as one load
template <>
struct Vec<4> {
  float v[4];
  __device__ __forceinline__ explicit Vec(const float* p) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  }
};
template <>
struct Vec<2> {
  float v[2];
  __device__ __forceinline__ explicit Vec(const float* p) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  }
};

// dw[i, o] = sum_b x[b, i] * dz[b, o] over an 8T x 8T tile; thread (tr, tc)
// holds rows T tr .. T tr + T - 1 and columns T tc .. T tc + T - 1.  The
// blocks of the first Din tile also give db[o] = sum_b dz[b, o], from the
// threads of row 0.  Thread t copies column t % 8T of rows t / 8T + j
// (64 / 8T) of each chunk, so its columns' bounds hold for every chunk.
template <int T>
__device__ __forceinline__ void dw_block(const Args& a, FbStage* st, int bid) {
  constexpr int kW = kTSideFb * T;             // tile width
  constexpr int kRows = kThreadsFb / kW;       // rows a copy pass covers
  const int i0 = (bid / a.n_out_t) * kW, o0 = (bid % a.n_out_t) * kW;
  const int tr = threadIdx.x / kTSideFb, tc = threadIdx.x % kTSideFb;
  const bool with_db = i0 == 0 && tr == 0;
  const int cm = threadIdx.x % kW, r0 = threadIdx.x / kW;
  const bool okx = i0 + cm < a.Din, okz = o0 + cm < a.Dout;
  const float* px = a.x + (size_t)r0 * a.Din + i0 + cm;
  const float* pz = a.dz + (size_t)r0 * a.Dout + o0 + cm;
  const size_t sx = (size_t)kRows * a.Din, sz = (size_t)kRows * a.Dout;
  float acc[T][T] = {};
  float db[T] = {};
  auto load = [&](FbStage& s, int k0) {
#pragma unroll
    for (int j = 0; j < kBKFb / kRows; ++j) {
      const int kk = r0 + j * kRows;
      const bool okb = k0 + kk < a.B;
      cp_async4(&s.dw.x[kk][cm], okb && okx ? px : a.x, okb && okx);
      cp_async4(&s.dw.dz[kk][cm], okb && okz ? pz : a.dz, okb && okz);
      px += sx;
      pz += sz;
    }
  };
  auto step = [&](const FbStage& s) {
#pragma unroll
    for (int kk = 0; kk < kBKFb; ++kk) {
      const Vec<T> xv(&s.dw.x[kk][T * tr]);
      const Vec<T> zv(&s.dw.dz[kk][T * tc]);
#pragma unroll
      for (int p = 0; p < T; ++p)
#pragma unroll
        for (int q = 0; q < T; ++q)
          acc[p][q] = fmaf(xv.v[p], zv.v[q], acc[p][q]);
      if (with_db) {
#pragma unroll
        for (int q = 0; q < T; ++q) db[q] = __fadd_rn(db[q], zv.v[q]);
      }
    }
  };
  ring(st, (a.B + kBKFb - 1) / kBKFb, load, step);
#pragma unroll
  for (int p = 0; p < T; ++p) {
    const int i = i0 + T * tr + p;
#pragma unroll
    for (int q = 0; q < T; ++q) {
      const int o = o0 + T * tc + q;
      if (i < a.Din && o < a.Dout) a.dw[(size_t)i * a.Dout + o] = acc[p][q];
    }
  }
  if (with_db) {
#pragma unroll
    for (int q = 0; q < T; ++q) {
      const int o = o0 + T * tc + q;
      if (o < a.Dout) a.db[o] = db[q];
    }
  }
}

// dx[b, i] = sum_o dz[b, o] * w[i, o] over a 32 x 32 tile; thread (tr, tc)
// holds rows tr + 8 p and columns tc + 8 q, whose staged rows fall in
// distinct banks.  Thread t copies entry t % 16 of rows t / 16 + 4 j of
// each chunk, so its rows' bounds hold for every chunk.
__device__ __forceinline__ void dx_block(const Args& a, FbStage* st, int bid) {
  const int b0 = (bid / a.n_dx_in) * kDxTile, i0 = (bid % a.n_dx_in) * kDxTile;
  const int tr = threadIdx.x / kTSideFb, tc = threadIdx.x % kTSideFb;
  const int ck = threadIdx.x % kBKFb, r0 = threadIdx.x / kBKFb;
  constexpr int kRows = kThreadsFb / kBKFb;  // 4
  const float* pz = a.dz + (size_t)(b0 + r0) * a.Dout + ck;
  const float* pw = a.w + (size_t)(i0 + r0) * a.Dout + ck;
  const size_t sz = (size_t)kRows * a.Dout;
  float acc[4][4] = {};
  auto load = [&](FbStage& s, int k0) {
    const bool oko = k0 + ck < a.Dout;
#pragma unroll
    for (int j = 0; j < kDxTile / kRows; ++j) {
      const int m = r0 + j * kRows;
      const bool okz = oko && b0 + m < a.B, okw = oko && i0 + m < a.Din;
      cp_async4(&s.dx.dz[m][ck], okz ? pz + k0 + j * sz : a.dz, okz);
      cp_async4(&s.dx.w[m][ck], okw ? pw + k0 + j * sz : a.w, okw);
    }
  };
  auto step = [&](const FbStage& s) {
#pragma unroll
    for (int k4 = 0; k4 < kBKFb; k4 += 4) {
      float4 zv[4], wv[4];
#pragma unroll
      for (int p = 0; p < 4; ++p)
        zv[p] = *reinterpret_cast<const float4*>(
            &s.dx.dz[tr + kTSideFb * p][k4]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        wv[q] = *reinterpret_cast<const float4*>(
            &s.dx.w[tc + kTSideFb * q][k4]);
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[p][q] = fmaf(zv[p].x, wv[q].x, acc[p][q]);
          acc[p][q] = fmaf(zv[p].y, wv[q].y, acc[p][q]);
          acc[p][q] = fmaf(zv[p].z, wv[q].z, acc[p][q]);
          acc[p][q] = fmaf(zv[p].w, wv[q].w, acc[p][q]);
        }
    }
  };
  ring(st, (a.Dout + kBKFb - 1) / kBKFb, load, step);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int b = b0 + tr + kTSideFb * p;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + tc + kTSideFb * q;
      if (b < a.B && i < a.Din) a.dx[(size_t)b * a.Din + i] = acc[p][q];
    }
  }
}

// dw blocks first (their chain over the batch is the longer one), then dx.
template <int T>
__global__ void __launch_bounds__(kThreadsFb) fc_bwd_kernel(Args a) {
  __shared__ FbStage st[kStagesFb];
  if (static_cast<int>(blockIdx.x) < a.n_dw)
    dw_block<T>(a, st, blockIdx.x);
  else
    dx_block(a, st, blockIdx.x - a.n_dw);
}

}  // namespace

// y may be null (linear layer, no tanh factor); dz is a (B, Dout) f32
// workspace when y is given, else unused and may be null.
extern "C" int repro_fc_bwd(const float* x, const float* dy, const float* y,
                            const float* w, float* dx, float* dw, float* db,
                            float* dz, int B, int Din, int Dout, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a;
  a.x = x; a.dz = dy; a.w = w; a.dx = dx; a.dw = dw; a.db = db;
  a.B = B; a.Din = Din; a.Dout = Dout;
  if (y != nullptr) {
    if (dz == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const long long n = (long long)B * Dout;
    fc_dz_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(dy, y, dz, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    a.dz = dz;
  }
  // dw tiles of 32 x 32 (4 x 4 a thread) where they give every SM a block,
  // else of 16 x 16 (2 x 2 a thread): a shorter chain of FMAs per thread.
  int blocks = 0;
  const cudaError_t err = min_blocks(&blocks);  // two an SM
  if (err != cudaSuccess) return static_cast<int>(err);
  const int wide = ((Din + 31) / 32) * ((Dout + 31) / 32) * 2 >= blocks;
  const int tile = wide ? 32 : 16;
  a.n_in_t = (Din + tile - 1) / tile;
  a.n_out_t = (Dout + tile - 1) / tile;
  a.n_dw = a.n_in_t * a.n_out_t;
  a.n_dx_in = (Din + kDxTile - 1) / kDxTile;
  const int grid = a.n_dw + ((B + kDxTile - 1) / kDxTile) * a.n_dx_in;
  if (wide)
    fc_bwd_kernel<4><<<grid, kThreadsFb, 0, st>>>(a);
  else
    fc_bwd_kernel<2><<<grid, kThreadsFb, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
