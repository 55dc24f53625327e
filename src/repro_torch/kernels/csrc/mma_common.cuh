// Warp-level tensor-core helpers for sm_90a (flash_attention.cu,
// flash_attention_bwd.cu): cp.async staging with zero fill, ldmatrix fragment
// loads, the bf16 m16n8k16 MMA with f32 accumulators, and the split of f32
// values into bf16 high and low halves (split) or three pieces (split3).
//
// Fragment layouts of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
// (PTX ISA), with lane = 4·g + t (g = lane / 4, t = lane % 4):
//   A (16 x 16, four .b32 of two bf16 each, the lower column in the low half):
//     a[0] (row g, cols 2t, 2t+1), a[1] (row g+8, cols 2t, 2t+1),
//     a[2] (row g, cols 2t+8, 2t+9), a[3] (row g+8, cols 2t+8, 2t+9);
//   B (16 x 8): b0 (rows 2t, 2t+1, col g), b1 (rows 2t+8, 2t+9, col g);
//   C, D (16 x 8 f32): c[0], c[1] (row g, cols 2t, 2t+1), c[2], c[3] (row
//     g+8, cols 2t, 2t+1).
// So the C fragments of two neighbouring n-tiles, packed to bf16, are the A
// fragment of a 16-deep step over those 16 columns (split_a, split3_a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global src to shared dst without passing through registers;
// zeros when !valid (a source size of 0 reads nothing from src).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// The same for one 4-byte word.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i (16 bytes each), r[i] receives its (row g, cols 2t,
// 2t+1); with trans, (rows 2t, 2t+1, col g).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a·b over one 16 x 8 x 16 step: bf16 products (exact in f32), f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of a 16 x 16 tile at (r0, c0) of a row-major bf16 tile with a
// row stride of RS elements; also the two n-tiles (cols c0..c0+15) of a B
// operand held as rows of k (rows r0..r0+15): r[0], r[1] are b0, b1 of the
// first n-tile, r[2], r[3] of the second (trans).
template <int RS, bool kTrans>
__device__ __forceinline__ void load_rows16(uint32_t (&r)[4],
                                            const __nv_bfloat16* tile, int r0,
                                            int c0, int lane) {
  const __nv_bfloat16* p =
      tile + (r0 + (lane & 15)) * RS + c0 + (lane >> 4) * 8;
  if constexpr (kTrans)
    ldmatrix_x4_trans(r, p);
  else
    ldmatrix_x4(r, p);
}

// B fragments of the two n-tiles n0..n0+15 at depth k0..k0+15 of a B operand
// held as rows of n (rows n0..n0+15, k along the row; no trans): r[0], r[1]
// are b0, b1 of the first n-tile, r[2], r[3] of the second.
template <int RS>
__device__ __forceinline__ void load_b_nk(uint32_t (&r)[4],
                                          const __nv_bfloat16* tile, int n0,
                                          int k0, int lane) {
  ldmatrix_x4(r, tile + (n0 + (lane & 7) + (lane >> 4) * 8) * RS + k0 +
                     ((lane >> 3) & 1) * 8);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}

// Two f32 values as one bf16x2 register, x0 in the low half.
__device__ __forceinline__ uint32_t pack(float x0, float x1) {
  return bits(__floats2bfloat162_rn(x0, x1));
}

// hi = bf16_rn(x), lo = bf16_rn(x − hi) of two values, packed as pack()
// does: hi + lo is x within 2^-16 |x|.  x − hi is exact in f32.
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = pack(__fsub_rn(x0, hf.x), __fsub_rn(x1, hf.y));
}

// The A fragments (hi and lo halves) of a 16-deep step from the C fragments
// of the two n-tiles c0 (cols 0-7 of the step) and c1 (cols 8-15).
__device__ __forceinline__ void split_a(const float (&c0)[4],
                                        const float (&c1)[4],
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(c0[0], c0[1], hi[0], lo[0]);
  split(c0[2], c0[3], hi[1], lo[1]);
  split(c1[0], c1[1], hi[2], lo[2]);
  split(c1[2], c1[3], hi[3], lo[3]);
}

// hi = bf16_rn(x), mid = bf16_rn(x − hi), lo = bf16_rn(x − hi − mid) of two
// values, packed as pack() does.  Each remainder is exact in f32 and holds 8
// fewer significant bits than the one before, so hi + mid + lo is x exactly
// while lo stays a normal number (|x| above about 2^-100).
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = __fsub_rn(x0, hf.x), r1 = __fsub_rn(x1, hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  hi = bits(h);
  mid = bits(m);
  lo = pack(__fsub_rn(r0, mf.x), __fsub_rn(r1, mf.y));
}

// The A fragments (hi, mid and lo pieces) of a 16-deep step from the C
// fragments of the two n-tiles c0 (cols 0-7 of the step) and c1 (cols 8-15).
__device__ __forceinline__ void split3_a(const float (&c0)[4],
                                         const float (&c1)[4],
                                         uint32_t (&hi)[4], uint32_t (&mid)[4],
                                         uint32_t (&lo)[4]) {
  split3(c0[0], c0[1], hi[0], mid[0], lo[0]);
  split3(c0[2], c0[3], hi[1], mid[1], lo[1]);
  split3(c1[0], c1[1], hi[2], mid[2], lo[2]);
  split3(c1[2], c1[3], hi[3], mid[3], lo[3]);
}

}  // namespace mma
