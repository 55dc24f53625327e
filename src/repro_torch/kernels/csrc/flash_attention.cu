// Causal GQA flash-attention forward: out = softmax(q kᵀ · scale) v with an
// online softmax in f32, the causal frontier at the absolute position
// q_offset + row, and the optional per-row log-sum-exp.
//
// Replaces: src/repro/kernels/flash_attention.py _fa_kernel (:36) under
// flash_attention_fwd (:102), the Pallas TPU kernel that walks the grid
// (B, Hkv, q blocks, kv blocks) in order, carries m, l and acc in VMEM across
// the kv axis, skips the kv blocks that start past q_offset + the block's
// last row, and is called once per GQA group.  Same arithmetic here: f32
// scores of f32-widened inputs, masked scores set to -1e30 (finite), p kept
// in f32 and zeroed where masked, l == 0 replaced by 1, out = acc / l cast to
// q's dtype, lse = m + log(l).
//
// Bound on the H100: operations.  At qwen3-14b's prefill (A=4 prompts of
// 1024, Hq 40 over Hkv 8, D=128, a 2048-slot bf16 cache) one call does
// 4·D = 512 FLOP per visible (query, key) pair, 43 GFLOP over 84 M pairs,
// against 101 MB of q, visible k/v and output: 430 FLOP per byte, above the
// bf16 tensor-core ridge of the H100 SXM (~295 FLOP/byte).  Its least time is
// the tensor cores' (989 TFLOP/s); this kernel runs on the CUDA cores in f32
// (67 TFLOP/s), which is what the TPU kernel's arithmetic needs where it
// matters: q kᵀ over bf16 inputs with f32 sums would be exact on bf16 tensor
// cores (mma.sync / wgmma), but P·V with f32 p is not (it needs TF32, a split
// of p, or CUDA cores).  A tensor-core version is later work.
//
// Design: one launch per call, every GQA group folded in.  A block of 256
// threads owns 64 query rows of one query head (grid: q tiles, Hq, B; the q
// tiles reversed so the longest causal rows start first) and loops over
// 64-key tiles inside the block, up to the last tile that its last row can
// see.  Shared memory holds the q tile as f32 and transposed (D x 64), the
// key tile transposed (D x 64) and the value tile (64 x D) in the input
// dtype (bf16 halves them), and the tile of p transposed (64 x 68, padded),
// about 81 KB at D=128 in bf16 (115 KB in f32), above the 48 KB default, so
// the launch opts in.  Thread (ty, tx) of a 16 x 16 grid owns rows
// 4ty..4ty+3: it computes their scores against keys 4tx..4tx+3 (a float4 of
// q and four keys per step of D), reduces row max and row sum over its
// 16-lane half-warp with xor shuffles (every lane gets the same bits), and
// accumulates columns tx·D/16.. of the output rows (a float4 of p and D/16
// values of v per key).  Keys past Tk are loaded as zeros and masked;
// query rows past Tq are computed and not written.  Every sum runs in a
// fixed order and nothing is atomic, so two runs give the same bits.
// q, k, v and out are read and written through their (b, h, t) strides with
// a contiguous last dim, so the serving path passes the KV cache in its
// (B, S, Hkv, D) layout without a copy.
#include "flash_common.cuh"

namespace {

using flash::from_f;
using flash::load_vec;
using flash::stage_rows;
using flash::stage_transposed;

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = flash::kTileThreads;  // 16 x 16
constexpr int kPS = kBQ + 4;    // row stride of the p tile (16-byte aligned)
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  int Hq, Hkv, Tq, Tk, q_offset, causal;
  float scale;
  long long sqb, sqh, sqt, skb, skh, skt, svb, svh, svt, sob, soh, sot;
};

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_kernel(Args a) {
  constexpr int kDPT = D / 16;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* qT = reinterpret_cast<float*>(smem);               // D x kBQ
  float* pT = qT + D * kBQ;                                  // kBK x kPS
  TKV* kT = reinterpret_cast<TKV*>(pT + kBK * kPS);          // D x kBK
  TKV* vs = kT + D * kBK;                                    // kBK x D

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hkv = hq / (a.Hq / a.Hkv);
  const int q0 = qt * kBQ;
  const TQ* qp = static_cast<const TQ*>(a.q) + b * a.sqb + hq * a.sqh;
  const TKV* kp = static_cast<const TKV*>(a.k) + b * a.skb + hkv * a.skh;
  const TKV* vp = static_cast<const TKV*>(a.v) + b * a.svb + hkv * a.svh;

  stage_transposed<TQ, float, D>(qp, a.sqt, q0, a.Tq, qT);

  // kv tiles this block computes: all of them, or (causal) those that start
  // at or before the absolute position of its last valid query row
  int n_kt = (a.Tk + kBK - 1) / kBK;
  if (a.causal) {
    const long long last =
        (long long)a.q_offset + min(q0 + kBQ, a.Tq) - 1;
    const long long vis = last < 0 ? 0 : last / kBK + 1;
    n_kt = (int)min((long long)n_kt, vis);
  }

  float m[4], l[4], acc[4][kDPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDPT; ++j) acc[i][j] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's kT, vs and pT are consumed
    stage_transposed<TKV, TKV, D>(kp, a.skt, k0, a.Tk, kT);
    stage_rows<TKV, D>(vp, a.svt, k0, a.Tk, vs);
    __syncthreads();

    // scores of rows 4ty+i against keys 4tx+j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
      load_vec<float, 4>(qT + d * kBQ + ty * 4, qa);
      load_vec<TKV, 4>(kT + d * kBK + tx * 4, kb);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

    bool ok[4][4];
    float mx[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qpos = (long long)a.q_offset + q0 + ty * 4 + i;
      mx[i] = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        ok[i][j] = kpos < a.Tk && (!a.causal || kpos <= qpos);
        s[i][j] = ok[i][j] ? s[i][j] * a.scale : kNegInf;
        mx[i] = fmaxf(mx[i], s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
    }

    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float m_new = fmaxf(m[i], mx[i]);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = ok[i][j] ? expf(s[i][j] - m_new) : 0.f;
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDPT; ++j) acc[i][j] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pT + (tx * 4 + j) * kPS + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc[rows 4ty+i][cols tx*kDPT + j] += sum_c p[row][c] * v[c][col]
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pa[4], vb[kDPT];
      load_vec<float, 4>(pT + c * kPS + ty * 4, pa);
      load_vec<TKV, kDPT>(vs + c * D + tx * kDPT, vb);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kDPT; ++j)
          acc[i][j] = fmaf(pa[i], vb[j], acc[i][j]);
    }
  }

  TQ* op = static_cast<TQ*>(a.out) + b * a.sob + hq * a.soh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= a.Tq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < kDPT; ++j)
      op[(long long)row * a.sot + tx * kDPT + j] = from_f<TQ>(acc[i][j] / li);
    if (a.lse != nullptr && tx == 0)
      a.lse[((long long)b * a.Hq + hq) * a.Tq + row] = m[i] + logf(li);
  }
}

template <typename TQ, typename TKV, int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  const int smem = D * kBQ * 4 + kBK * kPS * 4 + 2 * D * kBK * (int)sizeof(TKV);
  auto fn = flash_fwd_kernel<TQ, TKV, D>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + kBQ - 1) / kBQ, a.Hq, B);
  fn<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
int launch_d(const Args& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<TQ, TKV, 16>(a, B, stream);
    case 32: return launch<TQ, TKV, 32>(a, B, stream);
    case 64: return launch<TQ, TKV, 64>(a, B, stream);
    case 128: return launch<TQ, TKV, 128>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = f32, 1 = bf16; (q, kv) in {(0, 0), (1, 1), (0, 1)}; out
// takes q's dtype.  lse may be null.  Strides are in elements, for the
// (b, h, t) dims of q, k, v and out; the last dim is contiguous.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int q_dtype, int kv_dtype, int B, int Hq, int Hkv, int Tq, int Tk, int D,
    int q_offset, int causal, float scale, long long sqb, long long sqh,
    long long sqt, long long skb, long long skh, long long skt, long long svb,
    long long svh, long long svt, long long sob, long long soh, long long sot,
    void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || Tq <= 0 || Tk <= 0 ||
      B > 65535 || Hq > 65535)
    return cudaErrorInvalidValue;
  Args a{q, k, v, out, static_cast<float*>(lse), Hq, Hkv, Tq, Tk, q_offset,
         causal, scale, sqb, sqh, sqt, skb, skh, skt, svb, svh, svt,
         sob, soh, sot};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0) return launch_d<float, float>(a, B, D, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_d<__nv_bfloat16, __nv_bfloat16>(a, B, D, st);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_d<float, __nv_bfloat16>(a, B, D, st);
  return cudaErrorInvalidValue;
}
