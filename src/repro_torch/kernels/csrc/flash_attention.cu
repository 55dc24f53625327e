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
// the tensor cores' (989 TFLOP/s).
//
// One launch per call, every GQA group folded in: a block owns 64 query
// rows of one query head and loops over 64-key tiles inside the block, up
// to the last tile that its last row can see.  Keys past Tk are loaded as
// zeros and masked; query rows past Tq are computed and not written.  Every
// sum runs in an order fixed by the shapes and nothing is atomic, so two
// runs give the same bits.  q, k, v and out are read and written through
// their (b, h, t) strides with a contiguous last dim, so the serving path
// passes the KV cache in its (B, S, Hkv, D) layout without a copy.  Two
// designs, one per dtype:
//
// bf16 q over a bf16 cache (namespace tc): tensor cores.  The instruction is
// the warp-level mma.sync.m16n8k16 bf16 MMA with f32 accumulators, operands
// by ldmatrix (.trans for V), as in flash_attention_bwd.cu, rather than
// wgmma: its fragments are registers of one warp, so the FA2 register trick
// (the score accumulators, packed to bf16, are the A operand of P·V) needs
// no descriptors and no shared-memory round trip for p.  A block is 4 warps,
// each owning 16 query rows; grid (Hq, B, q tiles), the q tiles reversed, so
// the longest causal rows of every head and batch row start first.
//  - Staging: the q tile once, then K and V tiles of 64 keys through a
//    double-buffered cp.async ring (16 bytes a copy, zero fill past Tq / Tk),
//    the next tile in flight while the current one is consumed; every tile
//    stays bf16 in shared memory in rows of D + 8 elements (the 8 rows of an
//    ldmatrix on 8 distinct 16-byte bank groups).  The q tile stays in
//    shared memory and its A fragments are loaded at every key tile (D/16
//    ldmatrix a warp, against D/2 for K and V): held in registers over the
//    loop, at D=128 they took the kernel to 255 registers and a spill.
//  - Per key tile: S = Q·Kᵀ into f32 accumulators (16 x 64 a warp); the
//    mask of the CUDA-core kernel, masked scores -1e30, then × scale; the
//    row max over the quad's 4 lanes by xor shuffles; p = expf(s − m_new) in
//    f32, 0 where masked; l = l·corr + Σp from the f32 p; then P·V for 64
//    keys into a zeroed f32 tile accumulator, added as acc = acc·corr + tile
//    (one fmaf), the reference's acc·corr + p·v.
//  - Precision.  q and k are bf16, so the products of S are exact with f32
//    sums, as in the reference.  p is f32 and is carried as three bf16
//    pieces, hi = bf16(p), mid = bf16(p − hi), lo = bf16(p − hi − mid), each
//    remainder exact in f32, so hi + mid + lo is p for p above about 2^-100
//    and each product p·v is the reference's; each 16-key step runs the
//    three MMAs into the tile accumulator.  Two pieces leave p off by up to
//    2^-17 of itself, which the card's limit (one bf16 ulp or 1e-6) does not
//    cover (tests/test_torch_flash_fwd_split.py).  The tensor cores do not
//    round their f32 sums to nearest as the CUDA cores do, so one
//    accumulator takes only a tile's twelve MMAs and the sum over tiles
//    rounds on the CUDA cores (one fmaf a tile).  Issued work: 8·D FLOP per
//    visible pair (one S and three P·V MMAs), twice the bound's count.
//  - Shared memory a block: the q tile and two K/V buffers, five tiles of
//    64 x (D + 8) bf16: 15,360 / 25,600 / 46,080 / 87,040 bytes at D = 16 /
//    32 / 64 / 128, so two blocks an SM fit at D=128.
//
// f32 q (over an f32 or a bf16 cache): the CUDA cores, in f32 (67 TFLOP/s),
// as before the bf16 redesign.  A block of 256 threads owns the 64 query
// rows (grid: q tiles reversed, Hq, B).  Shared memory holds the q tile as
// f32 and transposed (D x 64), the key tile transposed (D x 64) and the
// value tile (64 x D) in the cache's dtype, and the tile of p transposed
// (64 x 68, padded), 115 KB at D=128 in f32, above the 48 KB default, so
// the launch opts in.  Thread (ty, tx) of a 16 x 16 grid owns rows
// 4ty..4ty+3: it computes their scores against keys 4tx..4tx+3 (a float4 of
// q and four keys per step of D), reduces row max and row sum over its
// 16-lane half-warp with xor shuffles (every lane gets the same bits), and
// accumulates columns tx·D/16.. of the output rows (a float4 of p and D/16
// values of v per key).
#include <type_traits>

#include "flash_common.cuh"
#include "mma_common.cuh"

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
static_assert(kBQ == 16 * kWarps && kBK == kBQ,
              "16 query rows a warp; q and K/V tiles of 64 rows alike");

template <int D>
constexpr int kRS = D + 8;  // row stride of a staged tile, in elements
template <int D>
constexpr int kTile = kBK * kRS<D>;
template <int D>
constexpr int smem_bytes() {
  return 5 * kTile<D> * 2;  // q, then [2 buffers][k, v]
}

// Rows [t0, t0 + 64) of one head (row stride st) into dst, 16 bytes a copy,
// asynchronously; rows at or past T are zero.
template <int D>
__device__ __forceinline__ void stage(const bf16* src, long long st, int t0,
                                      int T, bf16* dst) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < kBK * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    const bool ok = t0 + r < T;
    mma::cp_async16(dst + r * kRS<D> + c * 8,
                    ok ? src + (long long)(t0 + r) * st + c * 8 : src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_mma_kernel(Args a) {
  constexpr int RS = kRS<D>, NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // 64 rows x RS
  bf16* kv = qs + kTile<D>;                  // [2 buffers][k, v] 64 x RS

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int hq = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // longest causal rows first
  const int hkv = hq / (a.Hq / a.Hkv);
  const int q0 = qt * kBQ;
  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.sqb + hq * a.sqh;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.skb + hkv * a.skh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.svb + hkv * a.svh;

  // kv tiles this block computes: all of them, or (causal) those that start
  // at or before the absolute position of its last valid query row
  int n_kt = (a.Tk + kBK - 1) / kBK;
  if (a.causal) {
    const long long last =
        (long long)a.q_offset + min(q0 + kBQ, a.Tq) - 1;
    const long long vis = last < 0 ? 0 : last / kBK + 1;
    n_kt = (int)min((long long)n_kt, vis);
  }

  stage<D>(qp, a.sqt, q0, a.Tq, qs);
  if (n_kt > 0) {
    stage<D>(kp, a.skt, 0, a.Tk, kv);
    stage<D>(vp, a.svt, 0, a.Tk, kv + kTile<D>);
  }
  mma::cp_async_commit();

  const int wr = warp * 16;  // the warp's first row in the tile
  // absolute positions of the thread's rows wr + g and wr + g + 8
  const long long qpos[2] = {(long long)a.q_offset + q0 + wr + g,
                             (long long)a.q_offset + q0 + wr + g + 8};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[NT][4];  // rows g, g + 8; cols 8j + 2t, + 1
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {  // the next K, V tile into the other buffer
      bf16* nb = kv + ((kt + 1) & 1) * 2 * kTile<D>;
      stage<D>(kp, a.skt, (kt + 1) * kBK, a.Tk, nb);
      stage<D>(vp, a.svt, (kt + 1) * kBK, a.Tk, nb + kTile<D>);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();  // tile kt (and at kt = 0 the q tile) has landed
    const bf16* ks = kv + (kt & 1) * 2 * kTile<D>;
    const bf16* vs = ks + kTile<D>;
    const int k0 = kt * kBK;

    // s (rows wr + g, + 8; keys 8j + 2t, + 1); the warp's q rows as A
    // fragments from the staged tile, 16 columns at a time
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qf[4];
      load_rows16<RS, false>(qf, qs, wr, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4];
        load_b_nk<RS>(kb, ks, np * 16, kk * 16, lane);
        mma_bf16(s[2 * np], qf, kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf, kb[2], kb[3]);
      }
    }

    // the causal diagonal or a ragged edge: mask element by element
    const bool edge = k0 + kBK > a.Tk ||
                      (a.causal && (long long)k0 + kBK - 1 >
                                       (long long)a.q_offset + q0);
    auto visible = [&](int j, int e) {
      const int kpos = k0 + 8 * j + 2 * t + e % 2;
      return !edge || (kpos < a.Tk && (!a.causal || kpos <= qpos[e / 2]));
    };
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = visible(j, e) ? s[j][e] * a.scale : kNegInf;
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      mx[h] = fmaxf(m[h], mx[h]);  // m_new
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = visible(j, e) ? expf(s[j][e] - mx[e / 2]) : 0.f;  // p
        rs[e / 2] += s[j][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
      corr[h] = expf(m[h] - mx[h]);
      l[h] = l[h] * corr[h] + rs[h];
      m[h] = mx[h];
    }

    // acc = acc·corr + p·v over the tile's 64 keys: p·v into a zeroed tile
    // accumulator, 16 keys a step, p as hi, mid and lo bf16 pieces
    float pv[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pc[3][4];
      mma::split3_a(s[2 * kk], s[2 * kk + 1], pc[0], pc[1], pc[2]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t vb[4];
        load_rows16<RS, true>(vb, vs, kk * 16, np * 16, lane);
#pragma unroll
        for (int piece = 0; piece < 3; ++piece) {
          mma_bf16(pv[2 * np], pc[piece], vb[0], vb[1]);
          mma_bf16(pv[2 * np + 1], pc[piece], vb[2], vb[3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j][e] = fmaf(acc[j][e], corr[e / 2], pv[j][e]);
    __syncthreads();  // this buffer is consumed before it is staged again
  }
  mma::cp_async_wait<0>();  // nothing in flight at exit (no tile: q)

  bf16* op = static_cast<bf16*>(a.out) + b * a.sob + hq * a.soh;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wr + g + 8 * h;
    if (row >= a.Tq) continue;
    const float li = l[h] == 0.f ? 1.f : l[h];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + (long long)row * a.sot + j * 8 +
                                         2 * t) =
          __floats2bfloat162_rn(acc[j][2 * h] / li, acc[j][2 * h + 1] / li);
    if (a.lse != nullptr && t == 0)
      a.lse[((long long)b * a.Hq + hq) * a.Tq + row] = m[h] + logf(li);
  }
}

template <int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  const int n_qt = (a.Tq + kBQ - 1) / kBQ;
  if (n_qt > 65535) return cudaErrorInvalidValue;  // grid z
  auto fn = flash_fwd_mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D>());
  if (err != cudaSuccess) return err;
  fn<<<dim3(a.Hq, B, n_qt), kThreads, smem_bytes<D>(), stream>>>(a);
  return cudaGetLastError();
}

}  // namespace tc

// bf16 q over a bf16 cache on the tensor cores; f32 q, over an f32 or a
// bf16 cache, on the CUDA cores.
template <typename TQ, typename TKV, int D>
int launch_dtype(const Args& a, int B, cudaStream_t stream) {
  if constexpr (std::is_same<TQ, __nv_bfloat16>::value)
    return tc::launch<D>(a, B, stream);
  else
    return launch<TQ, TKV, D>(a, B, stream);
}

template <typename TQ, typename TKV>
int launch_d(const Args& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_dtype<TQ, TKV, 16>(a, B, stream);
    case 32: return launch_dtype<TQ, TKV, 32>(a, B, stream);
    case 64: return launch_dtype<TQ, TKV, 64>(a, B, stream);
    case 128: return launch_dtype<TQ, TKV, 128>(a, B, stream);
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
