// Causal GQA flash-attention backward: (dq, dk, dv) from the saved out and
// per-row log-sum-exp, at q_offset 0, without recomputing the forward.
//
// Replaces: the backward of src/repro/kernels/flash_attention.py
// flash_attention_train (the custom VJP _flash_train, :205), which runs the
// blockwise jnp src/repro/models/layers.py _flash_bwd (:230) and leaves its
// fusion to XLA.  Same arithmetic here: q, k, v, out and dout widened to
// f32; Dsum = sum_d do·o per query row; s = q·kᵀ·scale with the masked
// scores dropped before the exp; p = exp(s − lse); dv = pᵀ·do;
// dp = do·vᵀ; ds = p·(dp − Dsum)·scale; dq = ds·k; dk = dsᵀ·q; every sum in
// f32, dq, dk and dv cast once at the end to the inputs' dtype.
//
// Bound on the H100: operations.  At the qwen3-14b training shape (B=2,
// T=2048, Hq 40 over Hkv 8, D=128, bf16) the function needs 10·D FLOP per
// visible (query, key) pair (the five products above), 214.8 GFLOP over
// 168 M causal pairs, against 2·B·T·D·(4·Hq + 4·Hkv) bytes = 201 MB of q,
// out, dout, dq, k, v, dk and dv (and 1.3 MB of lse): about 1.1 kFLOP per
// byte, far above the bf16 tensor-core ridge (~295 FLOP/byte), so its
// least time is 0.217 ms at 989 TFLOP/s.
//
// Two designs, one per dtype, both the FA2 split into two kernels on the
// caller's stream (deterministic: no atomics, every sum in an order fixed
// by the shapes alone):
//  1. dq pass: a block per (64 query rows, query head, b).  At its head it
//     computes Dsum of its rows and writes it to a (B, Hq, Tq) f32 scratch;
//     then it loops over the 64-key tiles its last row can see, recomputes
//     s, p, dp and ds from the saved lse, and accumulates dq in registers,
//     written once.
//  2. dk/dv pass: a block per (64 keys, kv head, b) that loops over the G
//     query heads of its group (hq = hkv·G + g) and, for each, over the
//     query tiles that can see its keys (causal: from the tile holding key
//     k0 on), reading Dsum from the scratch; dk and dv of its 64 keys stay
//     in registers and are written once.
// Rows past Tq and keys past Tk are staged as zeros, masked (p = 0) and not
// written.  q, k, v, out and dout are read through their (b, h, t) strides
// with a contiguous last dim; dq, dk and dv are written contiguous
// (B, T, H, D).
//
// bf16 (namespace tc): tensor cores.  The instruction is the warp-level
// mma.sync.m16n8k16 bf16 MMA with f32 accumulators, its operands loaded by
// ldmatrix (.trans for the B operands held as rows of k), rather than
// Hopper's wgmma: the rate of mma.sync is below wgmma's peak, but its
// fragments are registers of one warp, so the FA2 register trick (an S-type
// accumulator, packed to bf16, is the A operand of the next product) needs
// no descriptors, no asynchronous completion and no shared-memory round
// trip for p or ds.  A block is 4 warps; each owns 16 query rows (pass 1)
// or 16 keys (pass 2) of the 64-wide tile.
//  - Pass 1, per key tile: S = Q·Kᵀ and dP = dO·Vᵀ (16 x 64 a warp, f32
//    accumulators), p and ds in f32 registers, dq += dS·K (16 x D a warp).
//  - Pass 2, per query tile, in two halves of 32 rows (to keep dk, dv and
//    the score fragments in registers): Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, so that
//    Pᵀ and dSᵀ land as A fragments; dv += Pᵀ·dO, dk += dSᵀ·Q.
//  - Precision.  q, k, v and dout are bf16, so S and dP are exact products
//    with f32 sums, as in the reference.  p and ds are f32; each is split
//    into hi = bf16_rn(x) and lo = bf16_rn(x − hi) (hi + lo is x within
//    2^-16 |x|), and each product that takes one (dS·K, Pᵀ·dO, dSᵀ·Q) runs
//    on hi and then on lo into the same f32 accumulator: ten 2·D-FLOP MMAs
//    per visible pair in all, twice the bound's count.
//  - Staging: every tile stays bf16 in shared memory, rows of D + 8
//    elements (16 bytes of padding put the 8 rows of an ldmatrix on 8
//    distinct 16-byte bank groups), filled by 16-byte cp.async copies with
//    zero fill past Tq / Tk into a double-buffered ring: the next K and V
//    tile (pass 1), the next Q and dO tile with their lse and Dsum rows
//    (pass 2), while the current one is consumed.
//  - Shared memory a block: Q, dO and two K/V buffers (pass 1), K, V and
//    two Q/dO buffers (pass 2), six tiles of 64 x (D + 8) bf16, plus the
//    rows' lse and Dsum: pass 1 18,944 / 31,232 / 55,808 / 104,960 bytes,
//    pass 2 19,456 / 31,744 / 56,320 / 105,472 at D = 16 / 32 / 64 / 128,
//    so two blocks an SM fit at D=128 (228 KB an SM).
//  - Order: pass 1's blocks run the longest causal rows first, pass 2's the
//    longest key tiles first, across every head and batch row.
//
// f32 (T = float): the CUDA cores, in f32 (67 TFLOP/s), as before the bf16
// redesign: thread (ty, tx) of a 16 x 16 grid owns a 4 x 4 patch of the
// 64 x 64 score tile (float4 of a transposed f32 tile of q or do, and four
// keys of a transposed tile of k or v, per step of D) and 4 output rows x
// D/16 columns of dq (pass 1) or of dk and dv (pass 2).  The tiles of p and
// ds go through shared memory (64 x 68 f32, padded); in pass 2 they share
// one buffer.  Shared memory at D=128: 181 KB in pass 1, 214 KB in pass 2,
// above the 48 KB default, so each launch opts in.  Dsum: 4 threads a row,
// a fixed order, xor shuffles.
#include <type_traits>

#include "flash_common.cuh"
#include "mma_common.cuh"

namespace {

using flash::from_f;
using flash::load_vec;
using flash::stage_rows;
using flash::stage_transposed;

constexpr int kB = 64;                        // query rows and keys per tile
constexpr int kThreads = flash::kTileThreads;  // 16 x 16
constexpr int kPS = kB + 4;                   // row stride of the p/ds tiles

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, Hq, Tq): (B, Hkv, G, Tq) contiguous
  void* dq;
  void* dk;
  void* dv;
  float* dsum;       // (B, Hq, Tq) scratch, written by pass 1
  int Hq, Hkv, Tq, Tk, causal;
  float scale;
  // (b, h, t) strides in elements
  long long sqb, sqh, sqt, skb, skh, skt, svb, svh, svt, sob, soh, sot, sdb,
      sdh, sdt;
};

template <typename T, int D>
constexpr int dq_smem() {
  return 2 * D * kB * 4 + kB * kPS * 4 + 2 * kB * 4 +
         3 * D * kB * (int)sizeof(T);
}

template <typename T, int D>
constexpr int dkdv_smem() {
  return 2 * D * kB * 4 + kB * kPS * 4 + 2 * kB * 4 +
         4 * D * kB * (int)sizeof(T);
}

// Pass 1: Dsum, then dq.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a) {
  constexpr int kDPT = D / 16;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* qT = reinterpret_cast<float*>(smem);  // D x 64 rows
  float* doT = qT + D * kB;                    // D x 64 rows
  float* dsT = doT + D * kB;                   // 64 keys x kPS
  float* rowv = dsT + kB * kPS;                // lse[64], Dsum[64]
  T* kT = reinterpret_cast<T*>(rowv + 2 * kB);  // D x 64 keys
  T* vT = kT + D * kB;                          // D x 64 keys
  T* ks = vT + D * kB;                          // 64 keys x D

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hkv = hq / (a.Hq / a.Hkv);
  const int q0 = qt * kB;
  const T* qp = static_cast<const T*>(a.q) + b * a.sqb + hq * a.sqh;
  const T* op = static_cast<const T*>(a.o) + b * a.sob + hq * a.soh;
  const T* dop = static_cast<const T*>(a.dout) + b * a.sdb + hq * a.sdh;
  const T* kp = static_cast<const T*>(a.k) + b * a.skb + hkv * a.skh;
  const T* vp = static_cast<const T*>(a.v) + b * a.svb + hkv * a.svh;
  const long long row_base = ((long long)b * a.Hq + hq) * a.Tq;

  stage_transposed<T, float, D>(qp, a.sqt, q0, a.Tq, qT);
  stage_transposed<T, float, D>(dop, a.sdt, q0, a.Tq, doT);
  {  // Dsum of the 64 rows: 4 threads a row, D/4 values each
    const int r = tid / 4, part = tid % 4;
    float acc = 0.f;
    if (q0 + r < a.Tq) {
      float ov[D / 4], dv[D / 4];
      load_vec<T, D / 4>(op + (long long)(q0 + r) * a.sot + part * (D / 4),
                         ov);
      load_vec<T, D / 4>(dop + (long long)(q0 + r) * a.sdt + part * (D / 4),
                         dv);
#pragma unroll
      for (int i = 0; i < D / 4; ++i) acc = fmaf(dv[i], ov[i], acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      const bool valid = q0 + r < a.Tq;
      rowv[r] = valid ? a.lse[row_base + q0 + r] : 0.f;
      rowv[kB + r] = acc;
      if (valid) a.dsum[row_base + q0 + r] = acc;
    }
  }
  __syncthreads();
  float lse[4], dsum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse[i] = rowv[ty * 4 + i];
    dsum[i] = rowv[kB + ty * 4 + i];
  }

  // kv tiles that start at or before the last valid row (q_offset 0)
  int n_kt = (a.Tk + kB - 1) / kB;
  if (a.causal) n_kt = min(n_kt, (min(q0 + kB, a.Tq) - 1) / kB + 1);

  float acc[4][kDPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDPT; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();  // the previous tile's kT, vT, ks and dsT are consumed
    stage_transposed<T, T, D>(kp, a.skt, k0, a.Tk, kT);
    stage_transposed<T, T, D>(vp, a.svt, k0, a.Tk, vT);
    stage_rows<T, D>(kp, a.skt, k0, a.Tk, ks);
    __syncthreads();

    // s (rows 4ty+i, keys 4tx+j) and dp over the same patch
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], da[4], kb[4], vb[4];
      load_vec<float, 4>(qT + d * kB + ty * 4, qa);
      load_vec<float, 4>(doT + d * kB + ty * 4, da);
      load_vec<T, 4>(kT + d * kB + tx * 4, kb);
      load_vec<T, 4>(vT + d * kB + tx * 4, vb);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(da[i], vb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        const bool ok = kpos < a.Tk && row < a.Tq && (!a.causal || kpos <= row);
        const float p = ok ? expf(s[i][j] * a.scale - lse[i]) : 0.f;
        s[i][j] = p * (dp[i][j] - dsum[i]) * a.scale;  // ds
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(dsT + (tx * 4 + j) * kPS + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // dq[rows 4ty+i][cols tx*kDPT + j] += sum_c ds[row][c] * k[c][col]
#pragma unroll 4
    for (int c = 0; c < kB; ++c) {
      float da[4], kb[kDPT];
      load_vec<float, 4>(dsT + c * kPS + ty * 4, da);
      load_vec<T, kDPT>(ks + c * D + tx * kDPT, kb);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kDPT; ++j) acc[i][j] = fmaf(da[i], kb[j], acc[i][j]);
    }
  }

  T* dqp = static_cast<T*>(a.dq) + (long long)b * a.Tq * a.Hq * D + hq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= a.Tq) continue;
#pragma unroll
    for (int j = 0; j < kDPT; ++j)
      dqp[(long long)row * a.Hq * D + tx * kDPT + j] = from_f<T>(acc[i][j]);
  }
}

// Pass 2: dk and dv of one kv tile, over the G heads and the query tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(Args a) {
  constexpr int kDPT = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qT = reinterpret_cast<float*>(smem);  // D x 64 rows
  float* doT = qT + D * kB;                    // D x 64 rows
  float* pS = doT + D * kB;                    // 64 rows x kPS: p, then ds
  float* rowv = pS + kB * kPS;                 // lse[64], Dsum[64]
  T* kT = reinterpret_cast<T*>(rowv + 2 * kB);  // D x 64 keys
  T* vT = kT + D * kB;                          // D x 64 keys
  T* qs = vT + D * kB;                          // 64 rows x D
  T* dos = qs + kB * D;                         // 64 rows x D

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int kt = blockIdx.x, hkv = blockIdx.y, b = blockIdx.z;
  const int G = a.Hq / a.Hkv;
  const int k0 = kt * kB;
  const T* kp = static_cast<const T*>(a.k) + b * a.skb + hkv * a.skh;
  const T* vp = static_cast<const T*>(a.v) + b * a.svb + hkv * a.svh;

  stage_transposed<T, T, D>(kp, a.skt, k0, a.Tk, kT);
  stage_transposed<T, T, D>(vp, a.svt, k0, a.Tk, vT);

  float dk[4][kDPT], dv[4][kDPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDPT; ++j) dk[i][j] = dv[i][j] = 0.f;

  // query tiles that can see a key of this tile: with q_offset 0 and equal
  // tile sizes, those from the tile holding key k0 on
  const int qt0 = a.causal ? k0 / kB : 0;
  const int n_qt = (a.Tq + kB - 1) / kB;
  for (int g = 0; g < G; ++g) {
    const int hq = hkv * G + g;
    const T* qp = static_cast<const T*>(a.q) + b * a.sqb + hq * a.sqh;
    const T* dop = static_cast<const T*>(a.dout) + b * a.sdb + hq * a.sdh;
    const long long row_base = ((long long)b * a.Hq + hq) * a.Tq;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kB;
      __syncthreads();  // the previous tile's smem is consumed
      stage_transposed<T, float, D>(qp, a.sqt, q0, a.Tq, qT);
      stage_transposed<T, float, D>(dop, a.sdt, q0, a.Tq, doT);
      stage_rows<T, D>(qp, a.sqt, q0, a.Tq, qs);
      stage_rows<T, D>(dop, a.sdt, q0, a.Tq, dos);
      if (tid < kB) {
        const bool valid = q0 + tid < a.Tq;
        rowv[tid] = valid ? a.lse[row_base + q0 + tid] : 0.f;
        rowv[kB + tid] = valid ? a.dsum[row_base + q0 + tid] : 0.f;
      }
      __syncthreads();

      // s (keys 4ty+i, rows 4tx+j) and dp over the same patch
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kb[4], vb[4], qa[4], da[4];
        load_vec<T, 4>(kT + d * kB + ty * 4, kb);
        load_vec<T, 4>(vT + d * kB + ty * 4, vb);
        load_vec<float, 4>(qT + d * kB + tx * 4, qa);
        load_vec<float, 4>(doT + d * kB + tx * 4, da);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qa[j], kb[i], s[i][j]);
            dp[i][j] = fmaf(da[j], vb[i], dp[i][j]);
          }
      }
      float lse[4], dsum[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lse[j] = rowv[tx * 4 + j];
        dsum[j] = rowv[kB + tx * 4 + j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = q0 + tx * 4 + j;
          const bool ok =
              kpos < a.Tk && row < a.Tq && (!a.causal || kpos <= row);
          s[i][j] = ok ? expf(s[i][j] * a.scale - lse[j]) : 0.f;  // p
          dp[i][j] = s[i][j] * (dp[i][j] - dsum[j]) * a.scale;    // ds
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(pS + (tx * 4 + j) * kPS + ty * 4) =
            make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      __syncthreads();

      // dv[keys 4ty+i][cols tx*kDPT + c] += sum_r p[r][key] * do[r][col]
#pragma unroll 4
      for (int r = 0; r < kB; ++r) {
        float pa[4], db[kDPT];
        load_vec<float, 4>(pS + r * kPS + ty * 4, pa);
        load_vec<T, kDPT>(dos + r * D + tx * kDPT, db);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < kDPT; ++c) dv[i][c] = fmaf(pa[i], db[c], dv[i][c]);
      }
      __syncthreads();  // p is consumed; the buffer takes ds
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(pS + (tx * 4 + j) * kPS + ty * 4) =
            make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
      __syncthreads();

      // dk[keys 4ty+i][cols] += sum_r ds[r][key] * q[r][col]
#pragma unroll 4
      for (int r = 0; r < kB; ++r) {
        float da[4], qb[kDPT];
        load_vec<float, 4>(pS + r * kPS + ty * 4, da);
        load_vec<T, kDPT>(qs + r * D + tx * kDPT, qb);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < kDPT; ++c) dk[i][c] = fmaf(da[i], qb[c], dk[i][c]);
      }
    }
  }

  const long long base = (long long)b * a.Tk * a.Hkv * D + hkv * D;
  T* dkp = static_cast<T*>(a.dk) + base;
  T* dvp = static_cast<T*>(a.dv) + base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= a.Tk) continue;
#pragma unroll
    for (int c = 0; c < kDPT; ++c) {
      const long long at = (long long)key * a.Hkv * D + tx * kDPT + c;
      dkp[at] = from_f<T>(dk[i][c]);
      dvp[at] = from_f<T>(dv[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
using mma::load_b_nk;
using mma::load_rows16;
using mma::mma_bf16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kB = 64;  // query rows and keys per tile, 16 a warp

template <int D>
constexpr int kRS = D + 8;  // row stride of a staged tile, in elements
template <int D>
constexpr int kTile = kB * kRS<D>;

template <int D>
constexpr int dq_smem() {
  return 6 * kTile<D> * 2 + 2 * kB * 4;
}
template <int D>
constexpr int dkdv_smem() {
  return 6 * kTile<D> * 2 + 4 * kB * 4;
}

// Rows [t0, t0 + 64) of one head (row stride st) into dst, 16 bytes a copy,
// asynchronously; rows at or past T are zero.
template <int D>
__device__ __forceinline__ void stage(const bf16* src, long long st, int t0,
                                      int T, bf16* dst) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < kB * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    const bool ok = t0 + r < T;
    mma::cp_async16(dst + r * kRS<D> + c * 8,
                    ok ? src + (long long)(t0 + r) * st + c * 8 : src, ok);
  }
}

// A warp's 16 rows x D of f32 accumulators in C-fragment layout (n-tile j:
// cols 8j..8j+7), cast to bf16 and written to rows r0.. (those below T) of
// an output with the given row stride.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4],
                                           bf16* out, long long row_stride,
                                           int r0, int T, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + g + 8 * half;
    if (row >= T) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + row * row_stride + j * 8 +
                                         2 * t) =
          __floats2bfloat162_rn(acc[j][2 * half], acc[j][2 * half + 1]);
  }
}

// Pass 1: Dsum, then dq.
template <int D>
__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dq_mma_kernel(Args a) {
  constexpr int RS = kRS<D>, NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // 64 rows x RS
  bf16* dos = qs + kTile<D>;                 // 64 rows x RS
  bf16* kv = dos + kTile<D>;                 // [2 buffers][k, v] 64 x RS
  float* rowv = reinterpret_cast<float*>(kv + 4 * kTile<D>);  // lse, Dsum

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int hq = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // longest causal rows first
  const int hkv = hq / (a.Hq / a.Hkv);
  const int q0 = qt * kB;
  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.sqb + hq * a.sqh;
  const bf16* op = static_cast<const bf16*>(a.o) + b * a.sob + hq * a.soh;
  const bf16* dop = static_cast<const bf16*>(a.dout) + b * a.sdb + hq * a.sdh;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.skb + hkv * a.skh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.svb + hkv * a.svh;
  const long long row_base = ((long long)b * a.Hq + hq) * a.Tq;

  // kv tiles that start at or before the last valid row (q_offset 0)
  int n_kt = (a.Tk + kB - 1) / kB;
  if (a.causal) n_kt = min(n_kt, (min(q0 + kB, a.Tq) - 1) / kB + 1);

  stage<D>(qp, a.sqt, q0, a.Tq, qs);
  stage<D>(dop, a.sdt, q0, a.Tq, dos);
  stage<D>(kp, a.skt, 0, a.Tk, kv);
  stage<D>(vp, a.svt, 0, a.Tk, kv + kTile<D>);
  mma::cp_async_commit();

  {  // Dsum of the 64 rows: 2 threads a row, D/2 values each, in order
    const int r = tid / 2, part = tid % 2;
    float acc = 0.f;
    if (q0 + r < a.Tq) {
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        float ov[8], dv[8];
        const int col = part * (D / 2) + c;
        load_vec<bf16, 8>(op + (long long)(q0 + r) * a.sot + col, ov);
        load_vec<bf16, 8>(dop + (long long)(q0 + r) * a.sdt + col, dv);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc = fmaf(dv[i], ov[i], acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (part == 0) {
      const bool valid = q0 + r < a.Tq;
      rowv[r] = valid ? a.lse[row_base + q0 + r] : 0.f;
      rowv[kB + r] = acc;
      if (valid) a.dsum[row_base + q0 + r] = acc;
    }
  }
  __syncthreads();
  const int wr = warp * 16;  // the warp's first row in the tile
  const float lse[2] = {rowv[wr + g], rowv[wr + g + 8]};
  const float dsum[2] = {rowv[kB + wr + g], rowv[kB + wr + g + 8]};

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {  // the next K, V tile into the other buffer
      bf16* nb = kv + ((kt + 1) & 1) * 2 * kTile<D>;
      stage<D>(kp, a.skt, (kt + 1) * kB, a.Tk, nb);
      stage<D>(vp, a.svt, (kt + 1) * kB, a.Tk, nb + kTile<D>);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();  // tile kt has landed for every thread
    const bf16* ks = kv + (kt & 1) * 2 * kTile<D>;
    const bf16* vs = ks + kTile<D>;
    const int k0 = kt * kB;

    // s (rows wr + g, + 8; keys 8j + 2t, + 1) and dp over the same patch
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      load_rows16<RS, false>(qa, qs, wr, kk * 16, lane);
      load_rows16<RS, false>(da, dos, wr, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4], vb[4];
        load_b_nk<RS>(kb, ks, np * 16, kk * 16, lane);
        load_b_nk<RS>(vb, vs, np * 16, kk * 16, lane);
        mma_bf16(s[2 * np], qa, kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
        mma_bf16(dp[2 * np], da, vb[0], vb[1]);
        mma_bf16(dp[2 * np + 1], da, vb[2], vb[3]);
      }
    }
    // the causal diagonal or a ragged edge: mask element by element
    const bool edge = (a.causal && k0 + kB - 1 > q0) || k0 + kB > a.Tk ||
                      q0 + kB > a.Tq;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int row = q0 + wr + g + 8 * h, kpos = k0 + 8 * j + 2 * t + e % 2;
        const bool ok = !edge || (kpos < a.Tk && row < a.Tq &&
                                  (!a.causal || kpos <= row));
        const float p = ok ? expf(s[j][e] * a.scale - lse[h]) : 0.f;
        s[j][e] = p * (dp[j][e] - dsum[h]) * a.scale;  // ds
      }

    // dq += ds·k, 16 keys a step, ds as hi and lo bf16 halves
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t hi[4], lo[4];
      mma::split_a(s[2 * kk], s[2 * kk + 1], hi, lo);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kb[4];
        load_rows16<RS, true>(kb, ks, kk * 16, np * 16, lane);
        mma_bf16(acc[2 * np], hi, kb[0], kb[1]);
        mma_bf16(acc[2 * np], lo, kb[0], kb[1]);
        mma_bf16(acc[2 * np + 1], hi, kb[2], kb[3]);
        mma_bf16(acc[2 * np + 1], lo, kb[2], kb[3]);
      }
    }
    __syncthreads();  // this buffer is consumed before it is staged again
  }

  store_rows<D>(acc,
                static_cast<bf16*>(a.dq) + (long long)b * a.Tq * a.Hq * D +
                    hq * D,
                (long long)a.Hq * D, q0 + wr, a.Tq, lane);
}

// Pass 2: dk and dv of one kv tile, over the G heads and the query tiles.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dkdv_mma_kernel(Args a) {
  constexpr int RS = kRS<D>, NT = D / 8;
  constexpr int QC = 32;  // query rows a chunk
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // 64 keys x RS
  bf16* vs = ks + kTile<D>;                  // 64 keys x RS
  bf16* qd = vs + kTile<D>;                  // [2 buffers][q, do] 64 x RS
  float* rowv = reinterpret_cast<float*>(qd + 4 * kTile<D>);  // [2][lse, Dsum]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int hkv = blockIdx.x, b = blockIdx.y;
  const int kt = blockIdx.z;  // the longest key tiles (kt = 0) first
  const int G = a.Hq / a.Hkv;
  const int k0 = kt * kB;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.skb + hkv * a.skh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.svb + hkv * a.svh;

  // query tiles that can see a key of this tile: with q_offset 0 and equal
  // tile sizes, those from the tile holding key k0 on; items in (g, qt) order
  const int qt0 = a.causal ? kt : 0;
  const int per_g = max((a.Tq + kB - 1) / kB - qt0, 0);
  const int n_items = G * per_g;

  auto stage_item = [&](int i, int buf) {
    const int hq = hkv * G + i / per_g, q0 = (qt0 + i % per_g) * kB;
    bf16* dst = qd + buf * 2 * kTile<D>;
    stage<D>(static_cast<const bf16*>(a.q) + b * a.sqb + hq * a.sqh, a.sqt,
             q0, a.Tq, dst);
    stage<D>(static_cast<const bf16*>(a.dout) + b * a.sdb + hq * a.sdh,
             a.sdt, q0, a.Tq, dst + kTile<D>);
    const long long row_base = ((long long)b * a.Hq + hq) * a.Tq;
    const int r = tid % kB;  // threads 0-63 take lse, 64-127 Dsum
    const float* src = (tid < kB ? a.lse : a.dsum) + row_base + q0 + r;
    const bool ok = q0 + r < a.Tq;
    mma::cp_async4(rowv + buf * 2 * kB + tid, ok ? src : a.lse, ok);
  };

  stage<D>(kp, a.skt, k0, a.Tk, ks);
  stage<D>(vp, a.svt, k0, a.Tk, vs);
  if (n_items > 0) stage_item(0, 0);
  mma::cp_async_commit();

  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  const int wk = warp * 16;  // the warp's first key in the tile
  for (int i = 0; i < n_items; ++i) {
    if (i + 1 < n_items) {
      stage_item(i + 1, (i + 1) & 1);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();  // item i has landed for every thread
    const bf16* qs = qd + (i & 1) * 2 * kTile<D>;
    const bf16* dos = qs + kTile<D>;
    const float* lse = rowv + (i & 1) * 2 * kB;
    const float* dsum = lse + kB;
    const int q0 = (qt0 + i % per_g) * kB;
    const bool edge = (a.causal && k0 + kB - 1 > q0) || k0 + kB > a.Tk ||
                      q0 + kB > a.Tq;

#pragma unroll 1  // unrolled, pass 2 spills at D=128
    for (int c = 0; c < kB / QC; ++c) {  // QC query rows at a time
      // sᵀ (keys wk + g, + 8; rows QC·c + 8j + 2t, + 1) and dpᵀ
      float s[QC / 8][4], dp[QC / 8][4];
#pragma unroll
      for (int j = 0; j < QC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        load_rows16<RS, false>(ka, ks, wk, kk * 16, lane);
        load_rows16<RS, false>(va, vs, wk, kk * 16, lane);
#pragma unroll
        for (int np = 0; np < QC / 16; ++np) {
          uint32_t qb[4], db[4];
          load_b_nk<RS>(qb, qs, QC * c + 16 * np, kk * 16, lane);
          load_b_nk<RS>(db, dos, QC * c + 16 * np, kk * 16, lane);
          mma_bf16(s[2 * np], ka, qb[0], qb[1]);
          mma_bf16(s[2 * np + 1], ka, qb[2], qb[3]);
          mma_bf16(dp[2 * np], va, db[0], db[1]);
          mma_bf16(dp[2 * np + 1], va, db[2], db[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < QC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + wk + g + 8 * (e / 2);
          const int r = QC * c + 8 * j + 2 * t + e % 2, row = q0 + r;
          const bool ok = !edge || (kpos < a.Tk && row < a.Tq &&
                                    (!a.causal || kpos <= row));
          const float p = ok ? expf(s[j][e] * a.scale - lse[r]) : 0.f;
          dp[j][e] = p * (dp[j][e] - dsum[r]) * a.scale;  // ds
          s[j][e] = p;
        }

      // dv += pᵀ·do and dk += dsᵀ·q, 16 rows a step, p and ds as hi and lo
#pragma unroll
      for (int kk = 0; kk < QC / 16; ++kk) {
        uint32_t phi[4], plo[4], dhi[4], dlo[4];
        mma::split_a(s[2 * kk], s[2 * kk + 1], phi, plo);
        mma::split_a(dp[2 * kk], dp[2 * kk + 1], dhi, dlo);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t ob[4], qb[4];
          load_rows16<RS, true>(ob, dos, QC * c + 16 * kk, np * 16, lane);
          load_rows16<RS, true>(qb, qs, QC * c + 16 * kk, np * 16, lane);
          mma_bf16(dv[2 * np], phi, ob[0], ob[1]);
          mma_bf16(dv[2 * np], plo, ob[0], ob[1]);
          mma_bf16(dv[2 * np + 1], phi, ob[2], ob[3]);
          mma_bf16(dv[2 * np + 1], plo, ob[2], ob[3]);
          mma_bf16(dk[2 * np], dhi, qb[0], qb[1]);
          mma_bf16(dk[2 * np], dlo, qb[0], qb[1]);
          mma_bf16(dk[2 * np + 1], dhi, qb[2], qb[3]);
          mma_bf16(dk[2 * np + 1], dlo, qb[2], qb[3]);
        }
      }
    }
    __syncthreads();  // this buffer is consumed before it is staged again
  }
  mma::cp_async_wait<0>();  // nothing in flight at exit (no item: K, V)

  const long long base = (long long)b * a.Tk * a.Hkv * D + hkv * D;
  store_rows<D>(dk, static_cast<bf16*>(a.dk) + base, (long long)a.Hkv * D,
                k0 + wk, a.Tk, lane);
  store_rows<D>(dv, static_cast<bf16*>(a.dv) + base, (long long)a.Hkv * D,
                k0 + wk, a.Tk, lane);
}

template <int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  auto dq_fn = flash_bwd_dq_mma_kernel<D>;
  auto dkdv_fn = flash_bwd_dkdv_mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_fn, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem<D>());
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      dkdv_fn, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_smem<D>());
  if (err != cudaSuccess) return err;
  dq_fn<<<dim3(a.Hq, B, (a.Tq + kB - 1) / kB), kThreads, dq_smem<D>(),
          stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_fn<<<dim3(a.Hkv, B, (a.Tk + kB - 1) / kB), kThreads, dkdv_smem<D>(),
            stream>>>(a);
  return cudaGetLastError();
}

}  // namespace tc

template <typename T, int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  auto dq_fn = flash_bwd_dq_kernel<T, D>;
  auto dkdv_fn = flash_bwd_dkdv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_fn, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem<T, D>());
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkdv_fn,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkdv_smem<T, D>());
  if (err != cudaSuccess) return err;
  dq_fn<<<dim3((a.Tq + kB - 1) / kB, a.Hq, B), kThreads, dq_smem<T, D>(),
          stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_fn<<<dim3((a.Tk + kB - 1) / kB, a.Hkv, B), kThreads,
            dkdv_smem<T, D>(), stream>>>(a);
  return cudaGetLastError();
}

// f32 on the CUDA cores, bf16 on the tensor cores.
template <typename T, int D>
int launch_dtype(const Args& a, int B, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value)
    return launch<float, D>(a, B, stream);
  else
    return tc::launch<D>(a, B, stream);
}

template <typename T>
int launch_d(const Args& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_dtype<T, 16>(a, B, stream);
    case 32: return launch_dtype<T, 32>(a, B, stream);
    case 64: return launch_dtype<T, 64>(a, B, stream);
    case 128: return launch_dtype<T, 128>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype code: 0 = f32, 1 = bf16, for q, k, v, out, dout and the outputs
// alike.  Strides are in elements, for the (b, h, t) dims of q, k, v, out
// and dout (the last dim contiguous); dq (B, Tq, Hq, D), dk and dv
// (B, Tk, Hkv, D) are written contiguous; dsum is a (B, Hq, Tq) f32 scratch.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* dsum, int dtype, int B, int Hq, int Hkv, int Tq, int Tk, int D,
    int causal, float scale, long long sqb, long long sqh, long long sqt,
    long long skb, long long skh, long long skt, long long svb, long long svh,
    long long svt, long long sob, long long soh, long long sot, long long sdb,
    long long sdh, long long sdt, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Tq <= 0 || Tk <= 0 ||
      B > 65535 || Hq > 65535)
    return cudaErrorInvalidValue;
  Args a{q, k, v, out, dout, static_cast<const float*>(lse), dq, dk, dv,
         static_cast<float*>(dsum), Hq, Hkv, Tq, Tk, causal, scale,
         sqb, sqh, sqt, skb, skh, skt, svb, svh, svt, sob, soh, sot,
         sdb, sdh, sdt};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(a, B, D, st);
  if (dtype == 1) return launch_d<__nv_bfloat16>(a, B, D, st);
  return cudaErrorInvalidValue;
}
