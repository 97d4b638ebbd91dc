// RG-LRU scan h_t = a_t * h_{t-1} + x_t over time, on [B, S, D].
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan/kernel.py
// (rglru_scan_fwd, pl.pallas_call at :65).  There the grid (B, nd, ns)
// runs time tiles in order and carries h across them in VMEM scratch; on
// Hopper blocks run in no order, so the sequential time axis becomes a
// loop inside one block: one block per (16 channels, batch row), whose
// first warp's lanes 0-15 each walk one channel's S dependent steps with
// the f32 carry in a register.
//
// Bound on this card: bytes (each a and x read once, h written once: 63 MB
// at recurrentgemma-2b's S = 4096, D = 2560, bf16, about 19 us at 3.35
// TB/s).  The chain itself, a multiply and an add a step (about 8 cycles),
// is of the same order (4096 steps, about 19 us at 1.75 GHz), so the design
// keeps the loads off the chain and enough bytes in flight:
//
// * Groups of 16 channels (32 bytes of bf16 a step): 160 blocks at
//   D = 2560, spread over every SM (one thread per channel in warps of 32
//   channels gave 80 blocks on 80 of 132 SMs).
// * A second warp moves the data: it copies a and x time tiles (128 steps
//   of bf16, 64 of f32: 8 KB a stage) by 16-byte cp.async into a
//   four-stage ring, three tiles ahead of the chain — some 24 KB in flight
//   a block — and stores each tile's h, which the chain leaves in shared
//   memory, with 16-byte stores.  The chain's warp then issues little
//   besides its own steps; the two warps meet at one barrier a tile.
// * The chain's operands come from shared memory eight steps ahead: a
//   lane reads the next eight steps' a and x into registers before it
//   runs this eight's multiply-adds, so no shared-memory latency sits on
//   the chain.
// Tails in S (a last partial tile), in D (a partial group) and rows of
// B > 1 run the same kernel; where a row of a or x does not start on 16
// bytes (D * size not a multiple of 16, or an unaligned tensor) elements
// are copied one by one.
//
// Every step rounds a*h and then +x separately (__fmul_rn, __fadd_rn), in
// time order, as the plain version and the oracle do, so the three agree
// in every bit: a scan that is associative over time would reorder the
// roundings.
//
// Why CUDA C++: the state is one register carried across a loop of S
// dependent steps fed by an asynchronous copy ring; the same ctypes build
// as the package's other kernels.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(in ? 16 : 0) : "memory");
}

constexpr int CG = 16;      // channels of a block
constexpr int U = 8;        // steps whose operands are read ahead
constexpr int NS = 4;       // stages of the ring
constexpr int WARP = 32;

// the chain over one time tile: h_t = a_t * h_{t-1} + x_t for the tile's
// n steps of this lane's channel, h into `out`; U steps' operands are read
// from shared memory ahead of the U multiply-adds before them
template <typename T, bool FULL>
__device__ __forceinline__ float chain_tile(const T* sa, const T* sx, T* out,
                                            int n, int lane, float carry) {
  T an[U], xn[U];
#pragma unroll
  for (int e = 0; e < U; ++e) {
    an[e] = sa[e * CG + lane];
    xn[e] = sx[e * CG + lane];
  }
  for (int r = 0; r < n; r += U) {
    float ac[U], xc[U];
#pragma unroll
    for (int e = 0; e < U; ++e) {
      ac[e] = to_f32(an[e]);
      xc[e] = to_f32(xn[e]);
    }
    if (r + U < n) {
#pragma unroll
      for (int e = 0; e < U; ++e) {
        an[e] = sa[(r + U + e) * CG + lane];
        xn[e] = sx[(r + U + e) * CG + lane];
      }
    }
#pragma unroll
    for (int e = 0; e < U; ++e) {
      if (FULL || r + e < n) {
        carry = __fadd_rn(__fmul_rn(ac[e], carry), xc[e]);
        out[(r + e) * CG + lane] = from_f32<T>(carry);
      }
    }
  }
  return carry;
}

// Two warps a block: warp 0 runs the chains (lanes 0-15, a channel each),
// warp 1 moves the data — it copies a and x tiles into the ring ahead of
// the chain and stores the last tile's h — so the chain's instruction
// stream holds little but its own steps.  One barrier a tile hands the
// stages and the h buffers over.
template <typename T, bool VEC>
__global__ void __launch_bounds__(2 * WARP)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ x,
                  const float* __restrict__ h0, T* __restrict__ h,
                  float* __restrict__ h_final, int S, int D) {
  constexpr int TT = 256 / (int)sizeof(T);      // steps of a tile
  constexpr int EPC = 16 / (int)sizeof(T);      // elements of a 16-byte chunk
  constexpr int CPR = CG / EPC;                 // chunks of a step's row
  __shared__ __align__(16) T ring[NS][2][TT * CG];  // a and x tiles
  __shared__ __align__(16) T out[2][TT * CG];       // h of two tiles
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int c0 = blockIdx.x * CG;
  const long base = (long)blockIdx.y * S * D;
  const int ntiles = (S + TT - 1) / TT;

  // (the data warp) time tile i into stage i % NS, zeros past S and D
  // (nothing read there)
  auto load = [&](int i) {
    T* sa = ring[i % NS][0];
    T* sx = ring[i % NS][1];
    const long s0 = (long)i * TT;
    if constexpr (VEC) {
      for (int j = lane; j < TT * CPR; j += WARP) {
        const int r = j / CPR, c = (j % CPR) * EPC;
        const bool in = s0 + r < S && c0 + c < D;
        const long off = in ? base + (s0 + r) * D + c0 + c : 0;
        cp_async16(sa + r * CG + c, a + off, in);
        cp_async16(sx + r * CG + c, x + off, in);
      }
    } else {
      for (int j = lane; j < TT * CG; j += WARP) {
        const int r = j / CG, c = j % CG;
        const bool in = s0 + r < S && c0 + c < D;
        const long off = base + (s0 + r) * D + c0 + c;
        sa[j] = in ? a[off] : from_f32<T>(0.0f);
        sx[j] = in ? x[off] : from_f32<T>(0.0f);
      }
    }
  };
  // (the data warp) tile i's h from out[i & 1] to global memory
  auto store = [&](int i) {
    const T* o = out[i & 1];
    const long s0 = (long)i * TT;
    const int n = (int)min((long)TT, S - s0);
    if constexpr (VEC) {
      for (int j = lane; j < n * CPR; j += WARP) {
        const int r = j / CPR, c = (j % CPR) * EPC;
        if (c0 + c < D)
          *reinterpret_cast<int4*>(h + base + (s0 + r) * D + c0 + c) =
              *reinterpret_cast<const int4*>(o + r * CG + c);
      }
    } else {
      for (int j = lane; j < n * CG; j += WARP) {
        const int r = j / CG, c = j % CG;
        if (c0 + c < D) h[base + (s0 + r) * D + c0 + c] = o[j];
      }
    }
  };

  const bool chain = warp == 0 && lane < CG && c0 + lane < D;
  float carry = chain ? h0[(long)blockIdx.y * D + c0 + lane] : 0.0f;
  if (warp == 1) {
#pragma unroll
    for (int i = 0; i < NS - 1; ++i) {
      if (i < ntiles) load(i);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  }
  for (int i = 0; i < ntiles; ++i) {
    if (warp == 1)  // tile i has landed: NS - 2 younger groups pending
      asm volatile("cp.async.wait_group %0;\n" ::"n"(NS - 2) : "memory");
    // tile i is in shared memory; the chain is done with tile i - 1 and
    // the data warp with storing tile i - 2's h
    __syncthreads();
    if (warp == 1) {
      if (i + NS - 1 < ntiles) load(i + NS - 1);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      if (i > 0) store(i - 1);
    } else if (lane < CG) {
      const long s0 = (long)i * TT;
      const int n = (int)min((long)TT, S - s0);
      carry = n == TT
          ? chain_tile<T, true>(ring[i % NS][0], ring[i % NS][1], out[i & 1],
                                n, lane, carry)
          : chain_tile<T, false>(ring[i % NS][0], ring[i % NS][1],
                                 out[i & 1], n, lane, carry);
    }
  }
  __syncthreads();
  if (warp == 1) {
    if (ntiles > 0) store(ntiles - 1);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  if (chain) h_final[(long)blockIdx.y * D + c0 + lane] = carry;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

template <typename T>
int launch(const void* a, const void* x, const void* h0, void* h,
           void* h_final, int B, int S, int D, cudaStream_t s) {
  const dim3 grid((D + CG - 1) / CG, B);
  const T* at = static_cast<const T*>(a);
  const T* xt = static_cast<const T*>(x);
  const float* h0f = static_cast<const float*>(h0);
  float* hf = static_cast<float*>(h_final);
  // 16-byte copies and stores where every row starts on 16 bytes
  if (D * (int)sizeof(T) % 16 == 0 && aligned16(a) && aligned16(x) &&
      aligned16(h))
    rglru_scan_kernel<T, true><<<grid, 2 * WARP, 0, s>>>(
        at, xt, h0f, static_cast<T*>(h), hf, S, D);
  else
    rglru_scan_kernel<T, false><<<grid, 2 * WARP, 0, s>>>(
        at, xt, h0f, static_cast<T*>(h), hf, S, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (a, x, h); h0 and h_final are float32.
extern "C" int launch_rglru_scan(const void* a, const void* x, const void* h0,
                                 void* h, void* h_final, int B, int S, int D,
                                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(a, x, h0, h, h_final, B, S, D, s);
  return launch<__nv_bfloat16>(a, x, h0, h, h_final, B, S, D, s);
}
