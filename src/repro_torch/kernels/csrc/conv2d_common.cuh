// The register-tiled GEMM loop that the conv kernels share, and their one
// launch-geometry rule.
//
// tile_loop computes a block's BM x BN outputs of C = A . B, stepping along
// the reduction in chunks of kBK.  The caller's loader issues the copies of
// one chunk: A's kBK x BM entries k-major into As (padded rows, so the
// stores and the float4 reads are free of bank conflicts) and B's kBK x BN
// entries into Bs, with cp.async, zero-filling what lies outside.  Chunks
// are double-buffered: chunk c + 1 loads while chunk c is multiplied, with
// one barrier per chunk.  Each thread keeps TM x TN outputs in registers as
// an outer product, TM/4 groups of 4 rows by TN/4 groups of 4 columns, the
// groups BM/(TM/4) and BN/(TN/4) apart so that a warp's float4 reads are
// contiguous: per k, TM + TN shared loads feed TM*TN FMAs.  Every output is
// one thread's fmaf chain over the reduction index in chunk order, so its
// bits do not depend on the tile, and zero-filled entries add exact zeros.
//
// Included by conv2d.cu (the forward) and conv2d_bwd.cu (the fused and the
// split backward), and by fc.cu for its cp.async helpers alone; nvcc
// compiles it into each, and build.py hashes it with the sources.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kBK = 16;     // reduction entries per chunk
constexpr int kStages = 2;  // chunks in shared memory: double buffering

// The launch-geometry rule of the conv kernels: a plan aims at two blocks
// an SM of the current device, from its SM count.  No order of sums may
// depend on it: only tile choices and row blocks whose outputs' fmaf chains
// do not change with them.
inline cudaError_t min_blocks(int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *blocks = 2 * sms;
  return err;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most kStages - 2 groups of copies are in flight.
__device__ __forceinline__ void cp_async_wait_stage() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
}

template <int BM, int BN>
struct __align__(16) TileSmem {
  static constexpr int AS = BM + 4;  // A's row stride: 4 mod 32 banks
  float a[kStages][kBK][AS];
  float b[kStages][kBK][BN];
};

template <int BM, int BN, int TM, int TN>
struct TileShape {
  static constexpr int NT = (BM / TM) * (BN / TN);  // threads
  static constexpr int TC = BN / TN;                // thread columns
  static constexpr int GM = TM / 4, GN = TN / 4;
  static_assert(TM % 4 == 0 && TN % 4 == 0 && NT % 32 == 0, "tile");
  // Row of the block's tile that acc[i][*] of thread row tr holds, and the
  // column that acc[*][j] of thread column tc holds.
  static __device__ __forceinline__ int row(int i, int tr) {
    return (i / 4) * (BM / GM) + 4 * tr + i % 4;
  }
  static __device__ __forceinline__ int col(int j, int tc) {
    return (j / 4) * (BN / GN) + 4 * tc + j % 4;
  }
};

// Chunk c lands in stage c % kStages.  Before chunk c is multiplied, the
// copies of chunk c + kStages - 1 start, into the stage that every thread
// finished multiplying before this iteration's barrier.  load(chunk, st) is
// called once for each chunk < nchunks, in order; acc starts at zero.
template <int BM, int BN, int TM, int TN, class Load>
__device__ __forceinline__ void tile_loop(TileSmem<BM, BN>& sm, int nchunks,
                                          Load& load, float (&acc)[TM][TN]) {
  using S = TileShape<BM, BN, TM, TN>;
  const int t = threadIdx.x;
  const int tc = t % S::TC, tr = t / S::TC;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < nchunks) load(c, c % kStages);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait_stage();
    __syncthreads();
    const int nc = c + kStages - 1;
    if (nc < nchunks) load(nc, nc % kStages);
    cp_async_commit();
    const int st = c % kStages;
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int g = 0; g < S::GM; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(
            &sm.a[st][k][g * (BM / S::GM) + 4 * tr]);
        av[4 * g] = v.x, av[4 * g + 1] = v.y, av[4 * g + 2] = v.z,
        av[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < S::GN; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(
            &sm.b[st][k][g * (BN / S::GN) + 4 * tc]);
        bv[4 * g] = v.x, bv[4 * g + 1] = v.y, bv[4 * g + 2] = v.z,
        bv[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

}  // namespace
