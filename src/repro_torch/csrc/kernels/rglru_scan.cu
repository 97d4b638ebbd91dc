// RG-LRU scan h_t = a_t * h_{t-1} + x_t over time, on [B, S, D].
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan/kernel.py
// (rglru_scan_fwd, pl.pallas_call at :65).  There the grid (B, nd, ns)
// runs time tiles in order and carries h across them in VMEM scratch; on
// Hopper blocks run in no order, so the sequential time axis becomes a
// loop inside one thread: one thread per (batch, channel) walks all S
// steps with the f32 carry in a register, and a warp's 32 neighbouring
// channels make each step's loads and store coalesced.
//
// Why CUDA C++: the state is one register carried across a loop of S
// dependent steps, which is a plain loop here and needs no tiles.
//
// Bound on this card: bytes (each a and x read once, h written once).  At
// recurrentgemma-2b's D = 2560 and B = 1 only 2560 threads exist (80 warps,
// one per block, on 80 of the 132 SMs), so the kernel is bound by the
// latency of its dependent steps, far from its byte bound; a scan over
// time in two levels would fill the card.
//
// Every step rounds a*h and then +x separately (__fmul_rn, __fadd_rn), as
// the plain version and the oracle do, so the three agree in every bit.
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

constexpr int THREADS = 32;

template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ x,
                  const float* __restrict__ h0, T* __restrict__ h,
                  float* __restrict__ h_final, int S, int D) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= D) return;
  const long base = (long)b * S * D + c;
  float carry = h0[(long)b * D + c];
#pragma unroll 8
  for (int t = 0; t < S; ++t) {
    const long i = base + (long)t * D;
    carry = __fadd_rn(__fmul_rn(ld(a, i), carry), ld(x, i));
    st(h, i, carry);
  }
  h_final[(long)b * D + c] = carry;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (a, x, h); h0 and h_final are float32.
extern "C" int launch_rglru_scan(const void* a, const void* x, const void* h0,
                                 void* h, void* h_final, int B, int S, int D,
                                 int dtype, void* stream) {
  const dim3 grid((D + THREADS - 1) / THREADS, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    rglru_scan_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(x),
        static_cast<const float*>(h0), static_cast<float*>(h),
        static_cast<float*>(h_final), S, D);
  } else {
    rglru_scan_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const float*>(h0), static_cast<__nv_bfloat16*>(h),
        static_cast<float*>(h_final), S, D);
  }
  return static_cast<int>(cudaGetLastError());
}
