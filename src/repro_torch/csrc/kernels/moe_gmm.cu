// Grouped expert matmul x[E, C, D] @ w[E, D, F] -> out[E, C, F] with
// counts[E]: the rows of every bc-row tile that holds a live row (a row
// below counts[e]) are computed, the others are exact zeros.
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_gmm/kernel.py
// (moe_gmm_fwd, pl.pallas_call at :56) for f32 inputs and for bf16 inputs
// that TMA cannot load (D or F not a multiple of 8, unaligned tensors);
// the other bf16 inputs go to moe_gmm_sm90.cu.  There the grid (E, nc, nf, nd)
// runs the contraction tiles in order and carries the f32 accumulator in
// VMEM scratch, with counts prefetched into SMEM; here one block per
// (expert, 64-row tile, 64-column tile) loops over D in slices of 16, the
// accumulator in registers (4 x 4 outputs a thread), the slices of x and w
// staged in shared memory as f32.  The block reads counts[e] itself; a
// tile with no live row writes zeros and skips the product.
//
// Why CUDA C++: a tiled product with a data-dependent skip per block and
// a serial loop over D inside the block; the same ctypes build as the
// other kernels of the package.
//
// Bound on this card: at granite-moe's shapes (E = 40, C = 1024, D = 1536,
// F = 512) an f32 product is bound by the CUDA cores' f32 rate (no TF32:
// f32 results are held to 1e-4); this kernel also waits on shared-memory
// reads, two barriers per 16-wide slice of D.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float ld(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, long i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, long i, float v) {
  p[i] = __float2bfloat16(v);
}

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4, THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
moe_gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const int* __restrict__ counts, T* __restrict__ out, int C,
               int D, int F, int bc) {
  const int e = blockIdx.z;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  T* o = out + (long)e * C * F;
  // rows the Pallas kernel computes: every row of a bc-row tile that
  // starts below counts[e]
  const long cnt = counts[e] > 0 ? counts[e] : 0;
  const long lim = (cnt + bc - 1) / bc * bc;
  const int live = lim < C ? (int)lim : C;
  if (row0 >= live) {
    for (int i = tid; i < BM * BN; i += THREADS) {
      const int r = row0 + i / BN, c = col0 + i % BN;
      if (r < C && c < F) st(o, (long)r * F + c, 0.0f);
    }
    return;
  }
  __shared__ float xs[BK][BM + 4];  // x slice, transposed: xs[k][row]
  __shared__ float ws[BK][BN];
  const T* xe = x + (long)e * C * D;
  const T* we = w + (long)e * D * F;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < D; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int m = i / BK, k = i % BK, r = row0 + m, kk = k0 + k;
      xs[k][m] = (r < live && kk < D) ? ld(xe, (long)r * D + kk) : 0.0f;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int k = i / BN, n = i % BN, kk = k0 + k, c = col0 + n;
      ws[k][n] = (kk < D && c < F) ? ld(we, (long)kk * F + c) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = xs[k][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = ws[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= C) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < F) st(o, (long)r * F + c, acc[i][j]);
    }
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, w, out); counts is int32.
extern "C" int launch_moe_gmm(const void* x, const void* w,
                              const void* counts, void* out, int E, int C,
                              int D, int F, int bc, int dtype, void* stream) {
  const dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, E);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    moe_gmm_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const int*>(counts), static_cast<float*>(out), C, D, F,
        bc);
  } else {
    moe_gmm_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<const int*>(counts), static_cast<__nv_bfloat16*>(out), C,
        D, F, bc);
  }
  return static_cast<int>(cudaGetLastError());
}
