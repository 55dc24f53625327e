// Device helpers shared by the flash-attention kernels (flash_attention.cu,
// flash_attention_bwd.cu): f32 widening of f32 / bf16 values, vector loads,
// and the staging of a 64-row tile into shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace flash {

constexpr int kTileThreads = 256;  // every flash kernel's block size

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// N consecutive values at p (aligned to N * sizeof(T) bytes) widened to f32,
// in 16-, 8- or 4-byte loads where the size allows.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float* o) {
  constexpr int kBytes = N * (int)sizeof(T);
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / (int)sizeof(T);
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c) {
      uint4 raw = reinterpret_cast<const uint4*>(p)[c];
      T e[kPer];
      memcpy(e, &raw, 16);
#pragma unroll
      for (int i = 0; i < kPer; ++i) o[c * kPer + i] = to_f(e[i]);
    }
  } else if constexpr (kBytes == 8) {
    uint2 raw = *reinterpret_cast<const uint2*>(p);
    T e[N];
    memcpy(e, &raw, 8);
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = to_f(e[i]);
  } else if constexpr (kBytes == 4) {
    uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
    T e[N];
    memcpy(e, &raw, 4);
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = to_f(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = to_f(p[i]);
  }
}

// Stage rows [t0, t0 + 64) of one head (row stride st, D contiguous values
// each) transposed into dst[d * 64 + r] as Tdst; rows at or past T are zero.
// Consecutive threads take consecutive rows, 16 bytes of one row each.
template <typename Tsrc, typename Tdst, int D>
__device__ __forceinline__ void stage_transposed(const Tsrc* src, long long st,
                                                 int t0, int T, Tdst* dst) {
  constexpr int kPer = 16 / (int)sizeof(Tsrc);
  constexpr int kChunks = D / kPer;
  for (int idx = threadIdx.x; idx < 64 * kChunks; idx += kTileThreads) {
    const int r = idx % 64, ch = idx / 64;
    float vals[kPer];
    if (t0 + r < T) {
      load_vec<Tsrc, kPer>(src + (long long)(t0 + r) * st + ch * kPer, vals);
    } else {
#pragma unroll
      for (int i = 0; i < kPer; ++i) vals[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      dst[(ch * kPer + i) * 64 + r] = from_f<Tdst>(vals[i]);
  }
}

// Copy rows [t0, t0 + 64) of one head (row stride st, D contiguous values of
// type T each) into dst[r * D + c], raw, 16 bytes a thread; rows at or past T
// are zero.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(const T* src, long long st, int t0,
                                           int T_, T* dst) {
  constexpr int kPer = 16 / (int)sizeof(T);
  for (int idx = threadIdx.x; idx < 64 * (D / kPer); idx += kTileThreads) {
    const int r = idx / (D / kPer), ch = idx % (D / kPer);
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (t0 + r < T_)
      raw = *reinterpret_cast<const uint4*>(src + (long long)(t0 + r) * st +
                                            ch * kPer);
    *reinterpret_cast<uint4*>(dst + r * D + ch * kPer) = raw;
  }
}

}  // namespace flash
