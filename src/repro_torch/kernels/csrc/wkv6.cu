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
// Design: one block of 256 threads per (b, h); a loop over the chunks inside
// the block takes the place of the TPU's sequential grid axis, and S lives in
// shared memory for the whole walk, so no state goes to device memory.  Per
// chunk the r, k, v and log w tiles are widened to f32 in shared memory
// (read through their (b, t, h) strides, the last dim contiguous: no
// transpose to (B, H, T, D) as the TPU wrapper needs for its BlockSpecs);
// 64 threads scan seg down the D columns while 64 others sum the bonus of
// each row; then thread (ty, tx) of a 16 x 16 grid owns rows ty + 16a and
// columns tx + 16c (a, c < 4) of each product.  Tiles have an odd row stride
// (65 floats), so column reads hit distinct banks.  Eight 64 x 65 f32 tiles
// (r/ri, k, kj/kw, v, lw, seg, scores, S) make 133 KB, above the 48 KB
// default, so the launch opts in.  D and Q up to 64.  Every sum runs in a
// fixed order, each output has one owner and nothing is atomic, so two runs
// give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxQ = 64;
constexpr int kMaxD = 64;
constexpr int kLd = kMaxD + 1;      // row stride of every tile
constexpr int kTile = kMaxQ * kLd;  // floats per tile (Q x D, Q x Q, D x D)
constexpr int kTiles = 8;
constexpr int kThreads = 256;       // 16 x 16
constexpr int kSmemBytes = (kTiles * kTile + 2 * kMaxD + kMaxQ) * 4;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
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
  int u_bf16, H, T, D, Q;
  Strides sr, sk, sv, sw, sy;
};

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads) wkv6_fwd_kernel(Args a) {
  extern __shared__ float smem[];
  float* sR = smem;                // r, then ri = r e^{seg - lw}
  float* sK = sR + kTile;          // k
  float* sKj = sK + kTile;         // k e^{-seg}, then k e^{seg_last - seg}
  float* sV = sKj + kTile;         // v
  float* sLw = sV + kTile;         // log max(w, 1e-12)
  float* sSeg = sLw + kTile;       // inclusive cumsum of lw
  float* sAtt = sSeg + kTile;      // (Q, Q) strictly causal scores
  float* sS = sAtt + kTile;        // (D, D) state
  float* sU = sS + kTile;          // (D,) bonus weights
  float* sDecay = sU + kMaxD;      // (D,) e^{seg_last}
  float* sBonus = sDecay + kMaxD;  // (Q,) Σ_d r u k of each row

  const int H = a.H, D = a.D, Q = a.Q;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const TIn* r = static_cast<const TIn*>(a.r) + b * a.sr.b + h * a.sr.h;
  const TIn* k = static_cast<const TIn*>(a.k) + b * a.sk.b + h * a.sk.h;
  const TIn* v = static_cast<const TIn*>(a.v) + b * a.sv.b + h * a.sv.h;
  const float* w = a.w + b * a.sw.b + h * a.sw.h;
  TOut* y = static_cast<TOut*>(a.y) + b * a.sy.b + h * a.sy.h;

  for (int idx = tid; idx < kTile; idx += kThreads) sS[idx] = 0.f;
  for (int d = tid; d < D; d += kThreads)
    sU[d] = a.u_bf16
                ? to_f(static_cast<const __nv_bfloat16*>(a.u)[h * D + d])
                : static_cast<const float*>(a.u)[h * D + d];

  for (int c0 = 0; c0 < a.T; c0 += Q) {
    __syncthreads();  // the previous chunk is done with every tile
    for (int idx = tid; idx < Q * D; idx += kThreads) {
      const int i = idx / D, d = idx % D, o = i * kLd + d;
      const long long t = c0 + i;
      sR[o] = to_f(r[t * a.sr.t + d]);
      sK[o] = to_f(k[t * a.sk.t + d]);
      sV[o] = to_f(v[t * a.sv.t + d]);
      sLw[o] = logf(fmaxf(w[t * a.sw.t + d], 1e-12f));
    }
    __syncthreads();
    if (tid < D) {  // seg down column tid, in token order
      float s = 0.f;
      for (int i = 0; i < Q; ++i) {
        s += sLw[i * kLd + tid];
        sSeg[i * kLd + tid] = s;
      }
    } else if (tid >= kMaxD && tid < kMaxD + Q) {  // bonus of row i
      const int i = tid - kMaxD;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s += sR[i * kLd + d] * sU[d] * sK[i * kLd + d];
      sBonus[i] = s;
    }
    __syncthreads();
    for (int idx = tid; idx < Q * D; idx += kThreads) {
      const int o = (idx / D) * kLd + idx % D;
      sR[o] = sR[o] * expf(sSeg[o] - sLw[o]);
      sKj[o] = sK[o] * expf(-sSeg[o]);
    }
    __syncthreads();

    // scores: att[i][j] = ri_i · kj_j for j < i, else 0.  Rows and columns
    // past Q read stale shared memory and are never stored.
    {
      float acc[4][4] = {};
      for (int d = 0; d < D; ++d) {
        float ra[4], kc[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ra[q] = sR[(ty + 16 * q) * kLd + d];
          kc[q] = sKj[(tx + 16 * q) * kLd + d];
        }
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[p][q] += ra[p] * kc[q];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = ty + 16 * p, j = tx + 16 * q;
          if (i < Q && j < Q) sAtt[i * kLd + j] = j < i ? acc[p][q] : 0.f;
        }
    }
    __syncthreads();

    // the state update's weights, read only after the next barrier
    const float* segLast = sSeg + (Q - 1) * kLd;
    for (int idx = tid; idx < Q * D; idx += kThreads) {
      const int d = idx % D, o = (idx / D) * kLd + d;
      sKj[o] = sK[o] * expf(segLast[d] - sSeg[o]);
    }
    for (int d = tid; d < D; d += kThreads) sDecay[d] = expf(segLast[d]);

    // y = att v + bonus v + ri S
    {
      float intra[4][4] = {}, inter[4][4] = {};
      for (int j = 0; j < Q; ++j) {
        float at[4], vc[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          at[q] = sAtt[(ty + 16 * q) * kLd + j];
          vc[q] = sV[j * kLd + tx + 16 * q];
        }
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) intra[p][q] += at[p] * vc[q];
      }
      for (int d = 0; d < D; ++d) {
        float ra[4], sc[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ra[q] = sR[(ty + 16 * q) * kLd + d];
          sc[q] = sS[d * kLd + tx + 16 * q];
        }
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) inter[p][q] += ra[p] * sc[q];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int i = ty + 16 * p;
        if (i >= Q) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int e = tx + 16 * q;
          if (e >= D) continue;
          const float yi = intra[p][q] + sBonus[i] * sV[i * kLd + e];
          put(&y[(long long)(c0 + i) * a.sy.t + e], yi + inter[p][q]);
        }
      }
    }
    __syncthreads();  // every read of S for this chunk's y is done

    // S <- diag(e^{seg_last}) S + kwᵀ v; each thread owns its entries
    {
      float acc[4][4] = {};
      for (int j = 0; j < Q; ++j) {
        float kw[4], vc[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          kw[q] = sKj[j * kLd + ty + 16 * q];
          vc[q] = sV[j * kLd + tx + 16 * q];
        }
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[p][q] += kw[p] * vc[q];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int d = ty + 16 * p;
        if (d >= D) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int e = tx + 16 * q;
          if (e < D) sS[d * kLd + e] = sS[d * kLd + e] * sDecay[d] + acc[p][q];
        }
      }
    }
  }
}

template <typename TIn, typename TOut>
int launch(const Args& a, int B, cudaStream_t stream) {
  auto fn = wkv6_fwd_kernel<TIn, TOut>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  fn<<<B * a.H, kThreads, kSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = f32, 1 = bf16.  r, k and v share in_dtype; w is f32; u
// (H, D) is contiguous in u_dtype; y is written in out_dtype.  Strides are in
// elements, for the (b, t, h) dims of each tensor; the last dim is
// contiguous.  T must be a multiple of Q; D and Q at most 64.
extern "C" int repro_wkv6_fwd(
    const void* r, const void* k, const void* v, const void* w, const void* u,
    void* y, int in_dtype, int u_dtype, int out_dtype, int B, int T, int H,
    int D, int Q, long long srb, long long srt, long long srh, long long skb,
    long long skt, long long skh, long long svb, long long svt, long long svh,
    long long swb, long long swt, long long swh, long long syb, long long syt,
    long long syh, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || D <= 0 || D > kMaxD || Q <= 0 ||
      Q > kMaxQ || T % Q || (long long)B * H > 2147483647LL ||
      u_dtype < 0 || u_dtype > 1)
    return cudaErrorInvalidValue;
  Args a{r, k, v, static_cast<const float*>(w), u, y, u_dtype, H, T, D, Q,
         {srb, srt, srh}, {skb, skt, skh}, {svb, svt, svh}, {swb, swt, swh},
         {syb, syt, syh}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0) return launch<float, float>(a, B, st);
  if (in_dtype == 0 && out_dtype == 1)
    return launch<float, __nv_bfloat16>(a, B, st);
  if (in_dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(a, B, st);
  if (in_dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(a, B, st);
  return cudaErrorInvalidValue;
}
