// Grouped expert matmul x[E, C, D] @ w[E, D, F] -> out[E, C, F] with
// counts[E]: the rows of every bc-row tile that holds a live row (a row
// below counts[e]) are computed, the others are exact zeros.
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_gmm/kernel.py
// (moe_gmm_fwd, pl.pallas_call at :56) for f32 inputs and for bf16 inputs
// that TMA cannot load (D or F not a multiple of 8, unaligned tensors);
// the other bf16 inputs go to moe_gmm_sm90.cu.  There the grid (E, nc, nf, nd)
// runs the contraction tiles in order and carries the f32 accumulator in
// VMEM scratch, with counts prefetched into SMEM; here one block of 256
// threads per (expert, 128-row tile, 128-column tile) loops over D in
// slices of 64, the accumulator in registers.  The block reads counts[e]
// itself.
//
// Bound on this card: at granite-moe's shapes (E = 40, C = 1024, D = 1536,
// F = 512) an f32 product is bound by the CUDA cores' f32 rate (no TF32:
// f32 results are held to 1e-4).  Fed from shared memory it reaches that
// rate only at four or more FFMAs per wavefront (simt_f32.cuh):
//
// * Register tiles.  Warp w covers rows 32 (w / 2) .. + 31 and columns
//   64 (w % 2) .. + 63 as 4 x 8 lanes; lane (ty, tx) = (lane / 8, lane % 8)
//   owns 8 x 8 outputs, rows ty + 4 i and columns 4 tx + {0-3, 32-35} of
//   its warp's tile (simt::outer_fma).  Per two k it reads x as 8 float2
//   along k (the 4 rows a warp reads at once lie in other banks: one
//   wavefront each) and w as 4 float4 (8 neighbouring float4: one
//   wavefront each): 128 FFMAs a warp for 12 wavefronts.
// * Staging.  Both operands stay in the layout of memory — x row-major
//   with rows padded by 4 floats, w row-major — so cp.async copies them
//   straight from global memory, 16 bytes at a time with zero fill, and no
//   register holds a slice in flight.  bf16 operands, and f32 rows that do
//   not start on 16 bytes (D or F not a multiple of 4), load element by
//   element and are converted to f32 on the way into shared memory.
// * Pipelining.  Two stages: slice k + 1 streams in while slice k is
//   computed, one __syncthreads a slice.
// * Budget.  Two stages of 64-wide slices take 132 KB of shared memory, so
//   one block (8 warps) runs per SM, and __launch_bounds__(256, 1) lets it
//   keep up to 255 registers a thread (ptxas: about 165 in the f32 build,
//   no spills).  On the card this beat two blocks per SM at 128 registers
//   (16- and 32-wide slices, register or cp.async staging), whose register
//   cap left ptxas no room to run the next operands' loads ahead of the
//   FFMAs.
//
// Kept exactly: live = min(C, ceil(counts[e] / bc) * bc); a block whose
// rows all lie at or past live computes no product and writes zeros; in a
// live block the rows at or past live load zeros, so they come out as
// exact zeros, for any bc; edges in C, D and F are zero-filled.
//
// Why CUDA C++: a tiled product with a data-dependent skip per block and
// a serial loop over D inside the block; the same ctypes build as the
// other kernels of the package.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "kernels/simt_f32.cuh"

namespace {

__device__ __forceinline__ float ld(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, long i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, long i, float v) {
  p[i] = __float2bfloat16(v);
}

constexpr int BM = 128, BN = 128, BK = 64, TM = 8, TN = 8, THREADS = 256;
constexpr int LDA = BK + 4;  // padded row of a stage's x slice
constexpr int STAGE_FLOATS = BM * LDA + BK * BN;
constexpr int SMEM_BYTES = 2 * STAGE_FLOATS * (int)sizeof(float);

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
moe_gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const int* __restrict__ counts, T* __restrict__ out, int C,
               int D, int F, int bc) {
  extern __shared__ __align__(16) float smem[];  // 2 stages of {xs, ws}
  const int e = blockIdx.z;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the thread's outputs: rows rt + 4 i, columns ct + 32 (j / 4) + j % 4
  // of the block's tile
  const int rt = 32 * (warp / 2) + lane / 8;
  const int ct = BN / 2 * (warp % 2) + 4 * (lane % 8);
  const long cnt = counts[e] > 0 ? counts[e] : 0;
  const long lim = (cnt + bc - 1) / bc * bc;
  const int live = lim < C ? (int)lim : C;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  if (row0 < live) {
    const int nk = (D + BK - 1) / BK;
    const T* xt = x + (long)e * C * D + (long)row0 * D;  // the block's tiles
    const T* wt = w + (long)e * D * F + col0;
    // the thread's 16-byte copies: x rows xr + XSTEP p at k quad xq, w k
    // rows wr + WSTEP p at column quad wq, from its first elements xg, wg
    constexpr int XN = BM * BK / 4 / THREADS, XSTEP = THREADS / (BK / 4);
    constexpr int WN = BK * BN / 4 / THREADS, WSTEP = THREADS / (BN / 4);
    const int xr = tid / (BK / 4), xq = tid % (BK / 4);
    const int wr = tid / (BN / 4), wq = tid % (BN / 4);
    const T* xg = xt + (long)xr * D + 4 * xq;
    const T* wg = wt + (long)wr * F + 4 * wq;
    // slice kt into its stage: zeros past live, D and F
    auto copy = [&](int kt) {
      float* xs = smem + (kt & 1) * STAGE_FLOATS;
      float* ws = xs + BM * LDA;
      const int k0 = kt * BK;
      if constexpr (VEC) {  // f32, D % 4 == F % 4 == 0, 16-byte aligned
#pragma unroll
        for (int p = 0; p < XN; ++p) {
          const bool in = row0 + xr + XSTEP * p < live && k0 + 4 * xq < D;
          simt::cp_async16(xs + (xr + XSTEP * p) * LDA + 4 * xq,
                           in ? xg + (long)XSTEP * p * D + k0 : x, in);
        }
#pragma unroll
        for (int p = 0; p < WN; ++p) {
          const bool in = k0 + wr + WSTEP * p < D && col0 + 4 * wq < F;
          simt::cp_async16(ws + (wr + WSTEP * p) * BN + 4 * wq,
                           in ? wg + (long)(k0 + WSTEP * p) * F : w, in);
        }
      } else {  // element by element, converted to f32
#pragma unroll 1
        for (int i = tid; i < BM * BK; i += THREADS) {
          const int r = i / BK, k = i % BK;
          xs[r * LDA + k] = row0 + r < live && k0 + k < D
              ? ld(xt, (long)r * D + k0 + k) : 0.0f;
        }
#pragma unroll 1
        for (int i = tid; i < BK * BN; i += THREADS) {
          const int r = i / BN, c = i % BN;
          ws[r * BN + c] = k0 + r < D && col0 + c < F
              ? ld(wt, (long)(k0 + r) * F + c) : 0.0f;
        }
      }
    };
    copy(0);
    simt::cp_async_commit();
    for (int kt = 0; kt < nk; ++kt) {
      simt::cp_async_wait_all();
      __syncthreads();  // slice kt landed; slice kt - 1's readers are done
      if (kt + 1 < nk) {
        copy(kt + 1);
        simt::cp_async_commit();
      }
      const float* xs = smem + (kt & 1) * STAGE_FLOATS + rt * LDA;
      const float* ws = smem + (kt & 1) * STAGE_FLOATS + BM * LDA + ct;
#pragma unroll
      for (int kp = 0; kp < BK / 2; ++kp) {
        float2 a[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          a[i] = *reinterpret_cast<const float2*>(xs + 4 * i * LDA + 2 * kp);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          float av[TM], bv[TN];
#pragma unroll
          for (int i = 0; i < TM; ++i) av[i] = kk == 0 ? a[i].x : a[i].y;
          simt::lds_frag<TN, 32>(bv, ws + (2 * kp + kk) * BN);
          simt::outer_fma(acc, av, bv);
        }
      }
    }
  }

  T* o = out + (long)e * C * F;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + rt + 4 * i;
    if (r >= C) continue;
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      const int c = col0 + ct + 32 * g;
      if constexpr (VEC) {
        if (c < F)
          *reinterpret_cast<float4*>(o + (long)r * F + c) =
              make_float4(acc[i][4 * g], acc[i][4 * g + 1],
                          acc[i][4 * g + 2], acc[i][4 * g + 3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (c + q < F) st(o, (long)r * F + c + q, acc[i][4 * g + q]);
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

template <typename T, bool VEC>
int launch(const void* x, const void* w, const void* counts, void* out,
           int E, int C, int D, int F, int bc, cudaStream_t s) {
  auto kernel = moe_gmm_kernel<T, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, E);
  kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const int*>(counts), static_cast<T*>(out), C, D, F, bc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, w, out); counts is int32.
extern "C" int launch_moe_gmm(const void* x, const void* w,
                              const void* counts, void* out, int E, int C,
                              int D, int F, int bc, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0)
    return launch<__nv_bfloat16, false>(x, w, counts, out, E, C, D, F, bc, s);
  // 16-byte loads and stores where every row starts on 16 bytes
  if (D % 4 == 0 && F % 4 == 0 && aligned16(x) && aligned16(w) &&
      aligned16(out))
    return launch<float, true>(x, w, counts, out, E, C, D, F, bc, s);
  return launch<float, false>(x, w, counts, out, E, C, D, F, bc, s);
}
