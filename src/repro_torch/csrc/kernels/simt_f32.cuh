// CUDA-core f32 building blocks of the register-tiled kernels
// flash_attention.cu and moe_gmm.cu: the outer-product step of a product
// whose operands sit in shared memory, and cp.async copies with zero fill.
// Included by csrc/kernels/*.cu; nvcc_build hashes it into the library name
// of every kernel that includes it, so an edit here rebuilds them.
//
// Why register tiles: an SM issues one warp-wide shared-memory wavefront
// per clock and four warp-wide FFMAs, so a product fed from shared memory
// is bound by the FMA units only at four FFMAs or more per wavefront.  A
// thread that keeps a TM x TN accumulator tile and reads its TM values of
// A and TN values of B as float4 does TM * TN FFMAs for (TM + TN) / 4
// loads.  The layout that makes those loads cheap: a thread's values come
// in groups of four consecutive floats, group g at GAP * g, and the lanes
// of a warp that read one group read either the same float4 (a broadcast)
// or neighbouring float4s (one wavefront per 32 lanes' 128 bytes).  For
// example flash attention's P V at d = 128: 8 x 8 outputs a thread, the 16
// lanes of a half-warp reading one row group of P (a broadcast) and 16
// neighbouring float4 of V, 64 FFMAs a warp per key for 6 wavefronts.
// Products are IEEE f32 on the CUDA cores, no TF32.
#pragma once

#include <cuda_runtime.h>

namespace simt {

// ---- the product step --------------------------------------------------------
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// N values (N a multiple of 4) as N / 4 float4 loads, group g at p + g * GAP
template <int N, int GAP>
__device__ __forceinline__ void lds_frag(float (&r)[N], const float* p) {
#pragma unroll
  for (int g = 0; g < N / 4; ++g) {
    const float4 v = lds4(p + g * GAP);
    r[4 * g] = v.x;
    r[4 * g + 1] = v.y;
    r[4 * g + 2] = v.z;
    r[4 * g + 3] = v.w;
  }
}

// acc[i][j] += a[i] * b[j]
template <int TM, int TN>
__device__ __forceinline__ void outer_fma(float (&acc)[TM][TN],
                                          const float (&a)[TM],
                                          const float (&b)[TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
}

// one k of the product: acc[i][j] += A[k][i] * B[k][j], with `a` and `b`
// the thread's first A and B values of row k in shared memory and the
// groups of four GAP_A and GAP_B floats apart
template <int TM, int TN, int GAP_A, int GAP_B>
__device__ __forceinline__ void fma_step(float (&acc)[TM][TN], const float* a,
                                         const float* b) {
  float av[TM], bv[TN];
  lds_frag<TM, GAP_A>(av, a);
  lds_frag<TN, GAP_B>(bv, b);
  outer_fma(acc, av, bv);
}

// ---- cp.async: global -> shared without registers ------------------------------
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes (both addresses 16-byte aligned); `in` false: zeros, and
// nothing is read from `src` (pass any valid address)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0) : "memory");
}
// 4 bytes, the same contract
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every copy this thread issued has landed (other threads' copies are
// visible after the __syncthreads that follows)
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace simt
