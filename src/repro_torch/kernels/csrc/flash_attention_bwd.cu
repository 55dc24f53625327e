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
// least time is 0.217 ms at 989 TFLOP/s.  This kernel runs the products on
// the CUDA cores in f32 (67 TFLOP/s), as the forward kernel does: the f32 p
// and ds of the reference are not bf16 tensor-core operands without a split
// or TF32.  A tensor-core version is later work.
//
// Design (the FA2 split; deterministic, no atomics).  One call launches two
// kernels on the caller's stream:
//  1. dq pass: a block of 256 threads per (64 query rows, query head, b).
//     At its head it computes Dsum of its rows (4 threads a row, a fixed
//     order, xor shuffles) and writes it to a (B, Hq, Tq) f32 scratch; then
//     it loops over the 64-key tiles its last row can see, recomputes s, p,
//     dp and ds from the saved lse, and accumulates dq in registers, written
//     once.
//  2. dk/dv pass: a block per (64 keys, kv head, b) that loops over the G
//     query heads of its group (hq = hkv·G + g) and, for each, over the
//     query tiles that can see its keys (causal: from the tile holding key
//     k0 on), reading Dsum from the scratch; dk and dv of its 64 keys stay in
//     registers and are written once.
// Every sum runs in a fixed order, so two runs give the same bits.  Thread
// (ty, tx) of a 16 x 16 grid owns a 4 x 4 patch of the 64 x 64 score tile
// (float4 of a transposed f32 tile of q or do, and four keys of a
// transposed tile of k or v, per step of D) and 4 output rows x D/16
// columns of dq (pass 1) or of dk and dv (pass 2).  The tiles of p and ds go
// through shared memory (64 x 68 f32, padded); in pass 2 they share one
// buffer.  Shared memory at D=128: 133 KB (bf16) / 181 KB (f32) in pass 1,
// 149 KB / 214 KB in pass 2, above the 48 KB default, so each launch opts in.
// Rows past Tq and keys past Tk are staged as zeros, masked (p = 0) and not
// written.  q, k, v, out and dout are read through their (b, h, t) strides
// with a contiguous last dim; dq, dk and dv are written contiguous
// (B, T, H, D).
#include "flash_common.cuh"

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

template <typename T>
int launch_d(const Args& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(a, B, stream);
    case 32: return launch<T, 32>(a, B, stream);
    case 64: return launch<T, 64>(a, B, stream);
    case 128: return launch<T, 128>(a, B, stream);
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
