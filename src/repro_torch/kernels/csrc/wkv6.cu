// RWKV-6 WKV recurrence in chunked form, forward: y (B, T, H, D) from r, k,
// v and the decay w (B, T, H, D) and the bonus u (H, D), with the (D, D) f32
// state starting at zero.  Per chunk of Q tokens:
//   lw  = log(max(w, 1e-12));  seg = inclusive cumsum of lw over the chunk
//   ri  = r e^{seg - lw};      kj  = k e^{-seg}
//   y   = tril_{-1}(ri kjᵀ) v + (Σ_d r u k) v + ri S
//   S  <- diag(e^{seg_last}) S + (k e^{seg_last - seg})ᵀ v
//
// Replaces: src/repro/kernels/wkv6.py _wkv_kernel (:32) under wkv6_chunked
// (:71), the Pallas TPU kernel that walks the grid (B, H, T/Q) with the chunk
// axis innermost and sequential, and carries S in a VMEM scratch across it.
// Same arithmetic here, all in f32 with the accurate expf / logf (the build
// has no --use_fast_math: at the model's clamp, lw >= -1, so e^{-seg} reaches
// e^64 and needs full precision).
//
// Bound on the H100: operations.  At the rwkv6-1.6b scoring shape (B=4,
// T=2048, H=32, D=64, Q=64; 4096 (b, h, chunk) tasks) each task does two
// strictly causal products (ri kjᵀ, scores times v) of 2·D FLOP for each of
// the Q(Q-1)/2 visible pairs and two state products (ri S, kᵀ v) of 2·Q·D²:
// 1,564,672 FLOP, 6.41 GFLOP per launch, 0.0957 ms at the 67 TFLOP/s f32
// CUDA-core rate.  Its bytes (r, k, v in bf16, w and y in f32: 234.9 MB)
// take 0.070 ms at 3.35 TB/s.  The
// products need f32 operands scaled by e^{±seg}, which bf16 tensor cores
// cannot hold exactly, so the kernel runs on the CUDA cores in f32.
//
// Design: chunk-parallel, three kernels in one call.  Only S crosses
// chunks, and its update S_{c+1} = S_c e^{seg_last,c} + U_c, with U_c =
// kwᵀ v, is elementwise over the D x D entries, so:
//   A. one block per (b, h, chunk) computes lw, seg, kw = k e^{seg_last -
//      seg} and U_c (each entry one thread's fmaf chain over the chunk's
//      tokens in order) into a workspace (B, H, T/Q, D, D) f32, and
//      e^{seg_last} into (B, H, T/Q, D) after it;
//   B. one thread per four entries of a (b, h)'s state walks the chunks in
//      order and overwrites U_c with S_c, the state before chunk c (S_0 =
//      0), as fmaf(S, e^{seg_last}, U_c): the parent's rounding of its
//      update;
//   C. one block per (b, h, chunk) computes seg, ri, kj, the bonus and the
//      causal scores, then y = (att v + bonus v) + ri S_c, with S_c copied
//      in by cp.async while the scores are computed.
// A and C order their blocks heads fastest, so that neighbouring blocks read
// neighbouring rows of (B, T, H, D), and read rows of 8 entries with 16-byte
// loads where D % 8 == 0 and the rows are aligned (else entry by entry).  At
// the scoring shape A and C are 4096 blocks of 256 threads (48 KB and 64.5
// KB of shared memory, four and three blocks an SM), B 128 blocks of 1024
// threads, one (b, h) each, streaming 64 KB a block at a time.  The
// workspace adds bytes (A writes U, 67 MB; B reads and writes it; C reads
// S): about 0.64 GB a call against the parent's 0.23 GB, 0.19 ms at 3.35
// TB/s, for 32 times the parent's parallelism.
//
// In A and C each product runs as 4 x 4 register tiles read as float4 from
// rows of shared memory: U from kw and v, the scores from ri and kj stored
// transposed ([d][i]), att·v from att stored transposed ([j][i]) and v, ri S
// from riᵀ and S.  C's four tiles hold r, k, seg and lw first, which the
// bonus, the scan and the elementwise step read by columns, so these are
// swizzled (sw); ri and kj are transposed in registers, 4 x 4 a thread.
// The scores are computed only for the 136 4 x 4 tiles on or below the
// diagonal (the parent stores 0 above it), by the block's first 136
// threads; the att·v chain of a row tile stops at its last row, leaving
// out the parent's fmaf(0, v, acc) steps past it, which leave acc as it is
// (acc != -0).
//
// Bits: every sum keeps the parent's order and rounding points: seg in token
// order, the bonus as fmaf(r u, k, s) over d, each score an fmaf chain over
// d, att·v over j and ri S over d in order, y = (att v + bonus v) + ri S,
// and S's update as above.  Each output has one owner and nothing is
// atomic, so two runs give the same bits.  D and Q up to 64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "conv2d_common.cuh"

namespace {

constexpr int kMaxQ = 64;
constexpr int kMaxD = 64;
constexpr int kThreadsW = 256;          // 16 x 16
constexpr int kN = 64;                  // row stride of every tile
constexpr int kTileN = kMaxQ * kN;      // floats a tile
constexpr int kDiagTiles = 16 * 17 / 2;  // 4 x 4 score tiles on or below
constexpr int kSmemA = 3 * kTileN * 4;
constexpr int kSmemC = (4 * kTileN + kMaxD + kMaxQ) * 4;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
// Four consecutive outputs in one store (16 bytes of f32, 8 of bf16).
__device__ __forceinline__ void put4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void put4(__nv_bfloat16* p, const float (&x)[4]) {
  const unsigned short b[4] = {
      __bfloat16_as_ushort(__float2bfloat16_rn(x[0])),
      __bfloat16_as_ushort(__float2bfloat16_rn(x[1])),
      __bfloat16_as_ushort(__float2bfloat16_rn(x[2])),
      __bfloat16_as_ushort(__float2bfloat16_rn(x[3]))};
  *reinterpret_cast<uint2*>(p) = make_uint2(b[0] | (unsigned(b[1]) << 16),
                                            b[2] | (unsigned(b[3]) << 16));
}

struct Strides {
  long long b, t, h;
};

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const void* u;
  void* y;
  float* state;  // (B, H, T/Q, D, D): U_c from A, S_c from B
  float* decay;  // (B, H, T/Q, D): e^{seg_last} of each chunk
  int u_bf16, H, T, D, Q, nc;
  int vec;       // 16-byte loads of 8 entries: D % 8 == 0, aligned rows
  int yvec;      // stores of 4 outputs: D % 4 == 0, aligned rows of y
  Strides sr, sk, sv, sw, sy;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Entry (row, col) of a 64 x 64 tile whose 4-float groups are permuted
// within each row by row / 4: a float4 group stays whole, and a warp
// reading a row, or one group from each of rows r, r + 4, ..., r + 28,
// hits distinct banks.
__device__ __forceinline__ int sw(int row, int col) {
  return row * kN + ((((col >> 2) ^ ((row >> 2) & 15)) << 2) | (col & 3));
}

// Eight consecutive entries of a row, widened to f32: one 16-byte load for
// bf16, two for f32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    o[2 * e] = __uint_as_float(w[e] << 16);
    o[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = ld4(p), b = ld4(p + 4);
  o[0] = a.x, o[1] = a.y, o[2] = a.z, o[3] = a.w;
  o[4] = b.x, o[5] = b.y, o[6] = b.z, o[7] = b.w;
}

// acc[i][j] = fmaf(a_i, b_j, acc[i][j]): one step of 16 chains.
__device__ __forceinline__ void fma4x4(float (&acc)[4][4], float4 a,
                                       float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
}

// seg down one column in token order: out[at(i)] = lw[at(0)] + ... +
// lw[at(i)], f32 adds in order.  Sixteen rows are loaded before their adds
// (out may be lw).
template <class At>
__device__ __forceinline__ void scan_column(const float* lw, float* out,
                                            int Q, At at) {
  float s = 0.f;
  for (int i0 = 0; i0 < Q; i0 += 16) {
    float x[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) x[e] = lw[at(min(i0 + e, Q - 1))];
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      if (i0 + e >= Q) break;
      s = __fadd_rn(s, x[e]);
      out[at(i0 + e)] = s;
    }
  }
}

// The (b, h, chunk) of block blockIdx.x, heads fastest: neighbouring blocks
// read neighbouring heads of the same tokens, which (B, T, H, D) keeps
// contiguous.  ws is the chunk's index in the workspace, (b, h, chunk).
struct Task {
  long long b, t0;
  int h, ws;
};
__device__ __forceinline__ Task task_of(const Args& a) {
  const int blk = blockIdx.x, h = blk % a.H, bc = blk / a.H;
  const int b = bc / a.nc, c = bc % a.nc;
  return {b, static_cast<long long>(c) * a.Q, h, (b * a.H + h) * a.nc + c};
}

template <typename T>
__device__ __forceinline__ const T* at(const void* base, const Strides& s,
                                       const Task& tk) {
  return static_cast<const T*>(base) + tk.b * s.b + tk.h * s.h + tk.t0 * s.t;
}

// A.  kw = k e^{seg_last - seg} and U_c = kwᵀ v of one (b, h, chunk).
template <typename TIn>
__global__ void __launch_bounds__(kThreadsW, 4) wkv6_chunk_state_kernel(
    Args a) {
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;           // k, then kw                 [j][d]
  float* sV = sK + kTileN;    // v                          [j][e]
  float* sSeg = sV + kTileN;  // lw, then seg in place      [i][d]
  const int D = a.D, Q = a.Q, tid = threadIdx.x;
  const Task tk = task_of(a);
  const TIn* k = at<TIn>(a.k, a.sk, tk);
  const TIn* v = at<TIn>(a.v, a.sv, tk);
  const float* w = at<float>(a.w, a.sw, tk);

  if (a.vec) {  // thread t: entries 8 (t % 8) .. of rows t / 8 and + 32
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int c = tid + kThreadsW * n, i = c >> 3, d = (c & 7) * 8;
      if (i < Q && d < D) {
        float kv[8], vv[8], wv[8];
        load8(k + i * a.sk.t + d, kv);
        load8(v + i * a.sv.t + d, vv);
        load8(w + i * a.sw.t + d, wv);
#pragma unroll
        for (int e = 0; e < 8; e += 4) {
          st4(sK + i * kN + d + e,
              make_float4(kv[e], kv[e + 1], kv[e + 2], kv[e + 3]));
          st4(sV + i * kN + d + e,
              make_float4(vv[e], vv[e + 1], vv[e + 2], vv[e + 3]));
          st4(sSeg + i * kN + d + e,
              make_float4(logf(fmaxf(wv[e], 1e-12f)),
                          logf(fmaxf(wv[e + 1], 1e-12f)),
                          logf(fmaxf(wv[e + 2], 1e-12f)),
                          logf(fmaxf(wv[e + 3], 1e-12f))));
        }
      }
    }
  } else {  // thread t: column t % 64 of rows t / 64 + 4 n
    const int d = tid & (kN - 1);
#pragma unroll 4
    for (int n = 0; n < kMaxQ / 4; ++n) {
      const int i = (tid >> 6) + 4 * n;
      if (i < Q && d < D) {
        sK[i * kN + d] = to_f(k[i * a.sk.t + d]);
        sV[i * kN + d] = to_f(v[i * a.sv.t + d]);
        sSeg[i * kN + d] = logf(fmaxf(w[i * a.sw.t + d], 1e-12f));
      }
    }
  }
  __syncthreads();
  if (tid < D) scan_column(sSeg + tid, sSeg + tid, Q, [](int i) {
        return i * kN;
      });
  __syncthreads();
  const float* segLast = sSeg + (Q - 1) * kN;
#pragma unroll
  for (int m = 0; m < 4; ++m) {  // kw, a float4 group a step
    const int g = tid + kThreadsW * m, i = g >> 4, d = (g & 15) * 4;
    if (i < Q && d < D) {
      const float4 kk = ld4(sK + i * kN + d), sg = ld4(sSeg + i * kN + d);
      const float4 sl = ld4(segLast + d);
      st4(sK + i * kN + d,
          make_float4(__fmul_rn(kk.x, expf(__fsub_rn(sl.x, sg.x))),
                      __fmul_rn(kk.y, expf(__fsub_rn(sl.y, sg.y))),
                      __fmul_rn(kk.z, expf(__fsub_rn(sl.z, sg.z))),
                      __fmul_rn(kk.w, expf(__fsub_rn(sl.w, sg.w)))));
    }
  }
  if (tid < D) a.decay[(long long)tk.ws * D + tid] = expf(segLast[tid]);
  __syncthreads();

  // U[d][e] = Σ_j kw[j][d] v[j][e]: thread (ty, tx) owns rows 4 ty .. and
  // columns 4 tx ..; the chains run over j in order.
  const int ty = tid / 16, tx = tid % 16;
  if (4 * ty >= D || 4 * tx >= D) return;
  float acc[4][4] = {};
#pragma unroll 8
  for (int j = 0; j < Q; ++j)
    fma4x4(acc, ld4(sK + j * kN + 4 * ty), ld4(sV + j * kN + 4 * tx));
  float* U = a.state + (long long)tk.ws * D * D;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int d = 4 * ty + p;
    if (d >= D) break;
    if ((D & 3) == 0) {
      st4(U + d * D + 4 * tx,
          make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]));
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (4 * tx + q < D) U[d * D + 4 * tx + q] = acc[p][q];
    }
  }
}

// B.  Thread (bh, W entries of a row of the state): U_c -> S_c in place, c
// in order, kScanBatch chunks' loads at a time.  At D = 64 a block of
// kThreadsScan threads is one (b, h), and a batch of it is 64 KB of
// contiguous workspace in flight.
constexpr int kThreadsScan = 1024;
constexpr int kScanBatch = 4;
template <int W>
__global__ void __launch_bounds__(kThreadsScan) wkv6_state_scan_kernel(
    float* __restrict__ state, const float* __restrict__ decay, int nc, int D,
    long long n) {
  const long long idx = blockIdx.x * static_cast<long long>(kThreadsScan) +
                        threadIdx.x;
  if (idx >= n) return;
  const int per = D * D / W;  // threads a (b, h)
  const long long bh = idx / per;
  const int de = static_cast<int>(idx % per) * W;
  const long long dd = static_cast<long long>(D) * D;
  float* U = state + bh * nc * dd + de;
  const float* g = decay + bh * nc * D + de / D;
  float S[W] = {};
  for (int c = 0; c < nc; c += kScanBatch) {
    float u[kScanBatch][W], gc[kScanBatch];
#pragma unroll
    for (int q = 0; q < kScanBatch; ++q) {
      if (c + q < nc) {
        if constexpr (W == 4) {
          const float4 t = ld4(U + (c + q) * dd);
          u[q][0] = t.x, u[q][1] = t.y, u[q][2] = t.z, u[q][3] = t.w;
        } else {
          u[q][0] = U[(c + q) * dd];
        }
        gc[q] = g[(c + q) * D];
      }
    }
#pragma unroll
    for (int q = 0; q < kScanBatch; ++q) {
      if (c + q < nc) {
        if constexpr (W == 4)
          st4(U + (c + q) * dd, make_float4(S[0], S[1], S[2], S[3]));
        else
          U[(c + q) * dd] = S[0];
#pragma unroll
        for (int e = 0; e < W; ++e) S[e] = __fmaf_rn(S[e], gc[q], u[q][e]);
      }
    }
  }
}

// C.  y of one (b, h, chunk) from its inputs and S_c.  Four 64 x 64 tiles
// hold, in turn: r, k, seg, lw, read by columns and so swizzled by sw; then
// S_c, v, kjᵀ, riᵀ and attᵀ over kjᵀ, read by rows, as plain rows of 64.
// v waits in registers while seg needs T2.
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreadsW, 3) wkv6_chunk_out_kernel(
    Args a) {
  extern __shared__ __align__(16) float smem[];
  float* T0 = smem;             // sw: r [i][d]; then S_c [d][e]
  float* T1 = T0 + kTileN;      // sw: k [i][d]; then v [j][e]
  float* T2 = T1 + kTileN;      // sw: seg [i][d]; then kjᵀ [d][j], attᵀ
  float* T3 = T2 + kTileN;      // sw: lw [i][d]; then riᵀ [d][i]
  float* sU = T3 + kTileN;      // (D,) bonus weights
  float* sBonus = sU + kMaxD;   // (Q,) Σ_d r u k of each row
  const int D = a.D, Q = a.Q, tid = threadIdx.x;
  const Task tk = task_of(a);
  const TIn* r = at<TIn>(a.r, a.sr, tk);
  const TIn* k = at<TIn>(a.k, a.sk, tk);
  const TIn* v = at<TIn>(a.v, a.sv, tk);
  const float* w = at<float>(a.w, a.sw, tk);
  TOut* y = static_cast<TOut*>(a.y) + tk.b * a.sy.b + tk.h * a.sy.h +
            tk.t0 * a.sy.t;

  // 1. r, k and lw into T0, T1, T3; v into registers; u.
  float vr[16];
  if (a.vec) {  // thread t: entries 8 (t % 8) .. of rows t / 8 and + 32
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int c = tid + kThreadsW * n, i = c >> 3, d = (c & 7) * 8;
      if (i < Q && d < D) {
        float rv[8], kv[8], wv[8];
        load8(r + i * a.sr.t + d, rv);
        load8(k + i * a.sk.t + d, kv);
        load8(w + i * a.sw.t + d, wv);
        float vv[8];
        load8(v + i * a.sv.t + d, vv);
#pragma unroll
        for (int e = 0; e < 8; ++e) vr[8 * n + e] = vv[e];
#pragma unroll
        for (int e = 0; e < 8; e += 4) {
          st4(T0 + sw(i, d + e),
              make_float4(rv[e], rv[e + 1], rv[e + 2], rv[e + 3]));
          st4(T1 + sw(i, d + e),
              make_float4(kv[e], kv[e + 1], kv[e + 2], kv[e + 3]));
          st4(T3 + sw(i, d + e),
              make_float4(logf(fmaxf(wv[e], 1e-12f)),
                          logf(fmaxf(wv[e + 1], 1e-12f)),
                          logf(fmaxf(wv[e + 2], 1e-12f)),
                          logf(fmaxf(wv[e + 3], 1e-12f))));
        }
      }
    }
  } else {  // thread t: column t % 64 of rows t / 64 + 4 n
    const int d = tid & (kN - 1);
#pragma unroll
    for (int n = 0; n < kMaxQ / 4; ++n) {
      const int i = (tid >> 6) + 4 * n;
      if (i < Q && d < D) {
        T0[sw(i, d)] = to_f(r[i * a.sr.t + d]);
        T1[sw(i, d)] = to_f(k[i * a.sk.t + d]);
        T3[sw(i, d)] = logf(fmaxf(w[i * a.sw.t + d], 1e-12f));
        vr[n] = to_f(v[i * a.sv.t + d]);
      }
    }
  }
  for (int d = tid; d < D; d += kThreadsW)
    sU[d] = a.u_bf16
                ? to_f(static_cast<const __nv_bfloat16*>(a.u)[tk.h * D + d])
                : static_cast<const float*>(a.u)[tk.h * D + d];
  __syncthreads();

  // 2. seg down column tid in token order, into T2; the bonus of row i from
  // float4 groups of r and k, d in order.
  if (tid < D) {
    scan_column(T3, T2, Q, [tid](int i) { return sw(i, tid); });
  } else if (tid >= kMaxD && tid < kMaxD + Q) {
    const int i = tid - kMaxD;
    float s = 0.f;
    for (int d = 0; d < D; d += 4) {
      const float4 rr = ld4(T0 + sw(i, d)), kk = ld4(T1 + sw(i, d));
      const float4 uu = ld4(sU + d);
      s = __fmaf_rn(__fmul_rn(rr.x, uu.x), kk.x, s);
      if (d + 1 < D) s = __fmaf_rn(__fmul_rn(rr.y, uu.y), kk.y, s);
      if (d + 2 < D) s = __fmaf_rn(__fmul_rn(rr.z, uu.z), kk.z, s);
      if (d + 3 < D) s = __fmaf_rn(__fmul_rn(rr.w, uu.w), kk.w, s);
    }
    sBonus[i] = s;
  }
  __syncthreads();

  // 3. ri = r e^{seg - lw} and kj = k e^{-seg} of rows 4 (tid % 16) .. + 3
  // and columns 4 (tid / 16) .. + 3, into registers.
  const int ib = tid & 15, gd = (tid >> 4) * 4;
  float4 ri[4], kj[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = 4 * ib + m;
    if (i < Q && gd < D) {
      const float4 rr = ld4(T0 + sw(i, gd)), kk = ld4(T1 + sw(i, gd));
      const float4 sg = ld4(T2 + sw(i, gd)), lw = ld4(T3 + sw(i, gd));
      ri[m] = make_float4(__fmul_rn(rr.x, expf(__fsub_rn(sg.x, lw.x))),
                          __fmul_rn(rr.y, expf(__fsub_rn(sg.y, lw.y))),
                          __fmul_rn(rr.z, expf(__fsub_rn(sg.z, lw.z))),
                          __fmul_rn(rr.w, expf(__fsub_rn(sg.w, lw.w))));
      kj[m] = make_float4(__fmul_rn(kk.x, expf(-sg.x)),
                          __fmul_rn(kk.y, expf(-sg.y)),
                          __fmul_rn(kk.z, expf(-sg.z)),
                          __fmul_rn(kk.w, expf(-sg.w)));
    }
  }
  __syncthreads();

  // 4. S_c into T0 (cp.async), v into T1, kjᵀ into T2, riᵀ into T3 (the
  // 4 x 4 blocks transposed in registers).
  const float* S = a.state + (long long)tk.ws * D * D;
  if ((D & 3) == 0) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int idx = tid + kThreadsW * m, d = idx >> 4, e = (idx & 15) * 4;
      if (d < D && e < D) cp_async16(T0 + d * kN + e, S + d * D + e, true);
    }
  } else {
    for (int m = 0; m < 16; ++m) {
      const int idx = tid + kThreadsW * m, d = idx >> 6, e = idx & 63;
      if (d < D && e < D) cp_async4(T0 + d * kN + e, S + d * D + e, true);
    }
  }
  cp_async_commit();
  if (a.vec) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int c = tid + kThreadsW * n, i = c >> 3, d = (c & 7) * 8;
      if (i < Q && d < D) {
        st4(T1 + i * kN + d, make_float4(vr[8 * n], vr[8 * n + 1],
                                         vr[8 * n + 2], vr[8 * n + 3]));
        st4(T1 + i * kN + d + 4, make_float4(vr[8 * n + 4], vr[8 * n + 5],
                                             vr[8 * n + 6], vr[8 * n + 7]));
      }
    }
  } else {
    const int d = tid & (kN - 1);
#pragma unroll
    for (int n = 0; n < kMaxQ / 4; ++n) {
      const int i = (tid >> 6) + 4 * n;
      if (i < Q && d < D) T1[i * kN + d] = vr[n];
    }
  }
  if (4 * ib < Q && gd < D) {  // rows past Q hold stale values, never read
    st4(T3 + gd * kN + 4 * ib, make_float4(ri[0].x, ri[1].x, ri[2].x, ri[3].x));
    st4(T3 + (gd + 1) * kN + 4 * ib,
        make_float4(ri[0].y, ri[1].y, ri[2].y, ri[3].y));
    st4(T3 + (gd + 2) * kN + 4 * ib,
        make_float4(ri[0].z, ri[1].z, ri[2].z, ri[3].z));
    st4(T3 + (gd + 3) * kN + 4 * ib,
        make_float4(ri[0].w, ri[1].w, ri[2].w, ri[3].w));
    st4(T2 + gd * kN + 4 * ib, make_float4(kj[0].x, kj[1].x, kj[2].x, kj[3].x));
    st4(T2 + (gd + 1) * kN + 4 * ib,
        make_float4(kj[0].y, kj[1].y, kj[2].y, kj[3].y));
    st4(T2 + (gd + 2) * kN + 4 * ib,
        make_float4(kj[0].z, kj[1].z, kj[2].z, kj[3].z));
    st4(T2 + (gd + 3) * kN + 4 * ib,
        make_float4(kj[0].w, kj[1].w, kj[2].w, kj[3].w));
  }
  __syncthreads();

  // 5. Scores att[i][j] = ri_i · kj_j for j < i, else 0.  Thread t < 136
  // takes the t-th 4 x 4 tile (p, q) with q <= p; those above the diagonal
  // are all zero and never read.
  int sp = 0, sq = 0;
  float att[4][4] = {};
  if (tid < kDiagTiles) {
    while ((sp + 1) * (sp + 2) / 2 <= tid) ++sp;
    sq = tid - sp * (sp + 1) / 2;
    if (4 * sp < Q)
#pragma unroll 8
      for (int d = 0; d < D; ++d)
        fma4x4(att, ld4(T3 + d * kN + 4 * sp), ld4(T2 + d * kN + 4 * sq));
  }
  cp_async_wait_all();
  __syncthreads();  // kjᵀ read by all; S_c landed
  if (tid < kDiagTiles && 4 * sp < Q) {  // attᵀ over kjᵀ
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = 4 * sq + c;
      st4(T2 + j * kN + 4 * sp,
          make_float4(j < 4 * sp ? att[0][c] : 0.f,
                      j < 4 * sp + 1 ? att[1][c] : 0.f,
                      j < 4 * sp + 2 ? att[2][c] : 0.f,
                      j < 4 * sp + 3 ? att[3][c] : 0.f));
    }
  }

  // 6. y = (att v + bonus v) + ri S: thread (p, s) owns rows 4 p .. and
  // columns 4 s ..; ri S first, then att v over j up to the tile's last row.
  const int p = tid / 16, s = tid % 16;
  const bool live = 4 * p < Q && 4 * s < D;
  float inter[4][4] = {};
  if (live)
#pragma unroll 8
    for (int d = 0; d < D; ++d)
      fma4x4(inter, ld4(T3 + d * kN + 4 * p), ld4(T0 + d * kN + 4 * s));
  __syncthreads();  // attᵀ stored
  if (!live) return;
  float intra[4][4] = {};
  const int jend = min(4 * p + 4, Q);
#pragma unroll 8
  for (int j = 0; j < jend; ++j)
    fma4x4(intra, ld4(T2 + j * kN + 4 * p), ld4(T1 + j * kN + 4 * s));
#pragma unroll
  for (int pp = 0; pp < 4; ++pp) {
    const int i = 4 * p + pp;
    if (i >= Q) break;
    const float bonus = sBonus[i];
    const float4 vi = ld4(T1 + i * kN + 4 * s);
    const float vv[4] = {vi.x, vi.y, vi.z, vi.w};
    float out[4];
#pragma unroll
    for (int qq = 0; qq < 4; ++qq)
      out[qq] = __fadd_rn(__fmaf_rn(bonus, vv[qq], intra[pp][qq]),
                          inter[pp][qq]);
    TOut* row = y + i * a.sy.t + 4 * s;
    if (a.yvec) {
      put4(row, out);
    } else {
#pragma unroll
      for (int qq = 0; qq < 4; ++qq)
        if (4 * s + qq < D) put(row + qq, out[qq]);
    }
  }
}

template <typename TIn, typename TOut>
int launch(const Args& a, long long tasks, cudaStream_t stream) {
  auto fa = wkv6_chunk_state_kernel<TIn>;
  auto fc = wkv6_chunk_out_kernel<TIn, TOut>;
  cudaError_t err = cudaFuncSetAttribute(
      fa, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemA);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        fc, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemC);
  if (err != cudaSuccess) return err;
  fa<<<static_cast<unsigned>(tasks), kThreadsW, kSmemA, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long bh = tasks / a.nc;
  if ((a.D & 3) == 0) {
    const long long n = bh * a.D * a.D / 4;
    wkv6_state_scan_kernel<4><<<static_cast<unsigned>(
                                    (n + kThreadsScan - 1) / kThreadsScan),
                                kThreadsScan, 0, stream>>>(a.state, a.decay,
                                                           a.nc, a.D, n);
  } else {
    const long long n = bh * a.D * a.D;
    wkv6_state_scan_kernel<1><<<static_cast<unsigned>(
                                    (n + kThreadsScan - 1) / kThreadsScan),
                                kThreadsScan, 0, stream>>>(a.state, a.decay,
                                                           a.nc, a.D, n);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fc<<<static_cast<unsigned>(tasks), kThreadsW, kSmemC, stream>>>(a);
  return cudaGetLastError();
}

// Whether every row of r, k and v (in_size bytes an entry) and of w (f32)
// starts on a 16-byte boundary and D % 8 == 0: the loads of 8 entries.
bool rows_aligned(const void* const* ptrs, const long long* strides,
                  int in_size, int D) {
  if (D % 8) return false;
  for (int t = 0; t < 4; ++t) {
    const int size = t < 3 ? in_size : 4;
    if (reinterpret_cast<uintptr_t>(ptrs[t]) % 16) return false;
    for (int s = 0; s < 3; ++s)
      if ((strides[3 * t + s] * size) % 16) return false;
  }
  return true;
}

}  // namespace

// dtype codes: 0 = f32, 1 = bf16.  r, k and v share in_dtype; w is f32; u
// (H, D) is contiguous in u_dtype; y is written in out_dtype.  Strides are in
// elements, for the (b, t, h) dims of each tensor; the last dim is
// contiguous.  T must be a multiple of Q; D and Q at most 64.  ws is an f32
// workspace of B·H·(T/Q)·D·(D + 1) floats: the chunks' states, then their
// decays.
extern "C" int repro_wkv6_fwd(
    const void* r, const void* k, const void* v, const void* w, const void* u,
    void* y, void* ws, int in_dtype, int u_dtype, int out_dtype, int B, int T,
    int H, int D, int Q, long long srb, long long srt, long long srh,
    long long skb, long long skt, long long skh, long long svb, long long svt,
    long long svh, long long swb, long long swt, long long swh, long long syb,
    long long syt, long long syh, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || D <= 0 || D > kMaxD || Q <= 0 ||
      Q > kMaxQ || T % Q || (long long)B * H > 2147483647LL ||
      (long long)B * H * (T / Q) > 2147483647LL ||
      (long long)B * H * D * D / kThreadsW > 2147483647LL || u_dtype < 0 ||
      u_dtype > 1 || ws == nullptr)
    return cudaErrorInvalidValue;
  const int nc = T / Q;
  const long long tasks = (long long)B * H * nc;
  float* state = static_cast<float*>(ws);
  const void* ptrs[4] = {r, k, v, w};
  const long long strides[12] = {srb, srt, srh, skb, skt, skh,
                                 svb, svt, svh, swb, swt, swh};
  const int vec = rows_aligned(ptrs, strides, in_dtype == 1 ? 2 : 4, D);
  const int out_size = out_dtype == 1 ? 2 : 4;
  const int yvec = D % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % (4 * out_size) == 0 &&
                   syb % 4 == 0 && syt % 4 == 0 && syh % 4 == 0;
  Args a{r, k, v, static_cast<const float*>(w), u, y, state,
         state + tasks * D * D, u_dtype, H, T, D, Q, nc, vec, yvec,
         {srb, srt, srh}, {skb, skt, skh}, {svb, svt, svh}, {swb, swt, swh},
         {syb, syt, syh}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    return launch<float, float>(a, tasks, st);
  if (in_dtype == 0 && out_dtype == 1)
    return launch<float, __nv_bfloat16>(a, tasks, st);
  if (in_dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(a, tasks, st);
  if (in_dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(a, tasks, st);
  return cudaErrorInvalidValue;
}
