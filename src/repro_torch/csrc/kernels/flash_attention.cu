// Flash attention forward for f32: causal or sliding-window softmax
// attention on q, k, v [B, H, S, d] f32 (kv repeated for GQA), online
// softmax in f32.  bf16 inputs go to flash_attention_sm90.cu (wgmma fed by
// TMA); f32 stays on the CUDA cores, with no TF32, because its results are
// held to 2e-5.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_fwd, pl.pallas_call at :114; body _fwd_kernel at :30).
// There the grid (B, H, nq, nk) sweeps kv tiles innermost and keeps the
// accumulator, running max and denominator in VMEM scratch between grid
// steps; on Hopper blocks run in no order, so the kv sweep becomes a loop
// inside one block of 256 threads per (b, h, q tile).
//
// Bound on this card: at Llama 3.2 3B's prefill shape f32 attention is
// bound by the CUDA cores' f32 rate (67 TFLOP/s).  Fed from shared memory,
// a product reaches that rate only at four or more FFMAs per shared-memory
// wavefront (simt_f32.cuh), so the design is about wavefronts:
//
// * Register tiles.  Thread (ty, tx) = (tid / 16, tid % 16) owns TR query
//   rows (i / 4) * 64 + 4 ty + i % 4 — 8 rows for the 128-row q tiles of
//   the d <= 64 and <= 128 builds, 4 for the 64-row tiles of d <= 256 —
//   the scores of keys tx + 16 j of each kv tile (4 of a 64-key tile, 2 of
//   a 32-key one), and output columns 64 g + 4 tx + e (4, 8 or 16).  The
//   16 lanes of a half-warp share their rows: row max by four shuffles.
// * Q Kᵀ reads q and k along the head as float4: q[row][c..c+3] (a
//   half-warp's lanes read one row: a broadcast) and k[key][c..c+3] (16
//   keys of a row padded by 4 floats: 2 wavefronts).  q's 16-byte quads
//   are XOR-swizzled by bit 2 of the row (the two rows a warp reads at
//   once fall in other banks) at no cost in instructions: the thread's
//   swizzle is one bit, folded into two base addresses.  d = 128: 128
//   FFMAs a warp for 16 wavefronts.
// * P goes through shared memory transposed, pT[key][row] (rows padded by
//   4: conflict-free float4 stores), and P V reads it and V as float4
//   (simt::fma_step): d = 128, 64 FFMAs a warp per key for 6 wavefronts.
//   A row's P is written and read by one half-warp, so __syncwarp orders
//   it.
// * Fewer issue slots besides the FFMAs: P V unrolled by 8 keys, the
//   softmax in base 2 on the SFU.
// * Pipelining.  K and V tiles are double-buffered and copied by cp.async
//   straight from global memory (16-byte copies with zero fill; 4-byte
//   ones when d % 4 != 0 or a tensor is not 16-byte aligned): tile t + 1
//   streams in while tile t is computed, one __syncthreads per kv tile.
// * Order.  The grid is (B * H, nq) with the q tile slowest, so a wave of
//   blocks covers every head of one q tile; causal launches run the q
//   tiles last to first, the heaviest first, so the last wave is short.
//
// Kept from the TPU kernel: whole kv tiles past the diagonal (causal) or
// left of the window band are skipped; masked scores are NEG_INF = -1e30
// (not -inf, so exp(s - m) never sees inf - inf); the kv tail rows past Sk
// are zeros, never read from global memory, so 0 * NaN cannot leak; the
// denominator is clamped to 1e-30 on the flush; Sq != Sk works (row i sees
// keys <= i).  Products are IEEE f32 (no TF32).  The softmax runs in base
// 2: scores scaled by scale * log2 e, exp(s - m) as ex2.approx, the SFU's
// 2^x, whose error (about 2^-22 of the value) is far inside 2e-5.
//
// Head widths: d <= 64, <= 128 and <= 256 each have a build (DMAX) whose
// tiles pad the head with zeros, so any d <= 256 works (h2o-danube's 120
// runs in the 128 build).  Shared memory, BQ * DMAX + 2 BK (DMAX + 4) +
// 2 BK DMAX + BK (BQ + 4) floats: 131 KB (d <= 64), 227 KB (d <= 128, the
// whole opt-in budget of a block) and 201.5 KB (d <= 256); so every build
// runs one block (8 warps) per SM, with up to 255 registers a thread — no
// build fits two blocks per SM.  Registers, d <= 128: 64 accumulators, 32
// scores, 16 row-state values, 20 operand values.
//
// Why CUDA C++: the kv sweep carries per-row state across a loop inside
// the block, and the same ctypes build serves the package's kernels.
#include <cuda_runtime.h>

#include "kernels/simt_f32.cuh"

namespace {

constexpr int THREADS = 256;
// threads that share a query row: the 16 lanes of a half-warp
constexpr int NTX = 16;
constexpr float NEG_INF = -1e30f;

template <int DMAX>
struct Tiles {
  static constexpr int BQ = DMAX <= 128 ? 128 : 64;  // query rows of a block
  static constexpr int BK = DMAX <= 128 ? 64 : 32;   // keys of a kv tile
  static constexpr int TR = BQ / 16;                  // query rows a thread owns
  static constexpr int SC = BK / NTX;  // keys of a kv tile a thread scores
  static constexpr int OC = DMAX / NTX;  // output columns a thread owns
  static constexpr int LDK = DMAX + 4;   // padded k row
  static constexpr int LDP = BQ + 4;     // padded row of pT
  static constexpr int FLOATS =
      BQ * DMAX + 2 * BK * LDK + 2 * BK * DMAX + BK * LDP;
};

// the thread's i-th query row is 4 ty + row_off(i)
__host__ __device__ constexpr int row_off(int i) {
  return (i / 4) * 64 + i % 4;
}
// the XOR of q row r's 16-byte quads: bit 2 of the row
__device__ __forceinline__ int q_swz(int r) { return ((r >> 2) & 1) << 2; }
// 2^x by the SFU (relative error about 2^-22; results below 2^-126 are 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
constexpr float LOG2E = 1.4426950408889634f;

// rows [r0, r0 + R) of a [n, d] matrix into a [R][LD] tile by cp.async,
// zeros past row n and column d (nothing read there); SWZ: q's swizzle
template <int R, int DMAX, int LD, bool SWZ, bool VEC>
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          int r0, int n, int d, int tid) {
  if constexpr (VEC) {
    constexpr int QUADS = DMAX / 4;
    static_assert(R * QUADS % THREADS == 0, "whole copies per thread");
#pragma unroll
    for (int it = 0; it < R * QUADS / THREADS; ++it) {
      const int i = tid + it * THREADS, r = i / QUADS, c4 = i % QUADS;
      const bool in = r0 + r < n && 4 * c4 < d;
      const float* g = in ? src + (long)(r0 + r) * d + 4 * c4 : src;
      simt::cp_async16(dst + r * LD + 4 * (SWZ ? c4 ^ q_swz(r) : c4), g, in);
    }
  } else {
    static_assert(R * DMAX % THREADS == 0, "whole copies per thread");
#pragma unroll 4
    for (int it = 0; it < R * DMAX / THREADS; ++it) {
      const int i = tid + it * THREADS, r = i / DMAX, c = i % DMAX;
      const bool in = r0 + r < n && c < d;
      const float* g = in ? src + (long)(r0 + r) * d + c : src;
      const int col = SWZ ? ((c >> 2) ^ q_swz(r)) << 2 | (c & 3) : c;
      simt::cp_async4(dst + r * LD + col, g, in);
    }
  }
}

template <int DMAX, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int Sq,
                 int Sk, int d, int causal, int window, float scale) {
  using T = Tiles<DMAX>;
  constexpr int BQ = T::BQ, BK = T::BK, TR = T::TR, SC = T::SC, OC = T::OC;
  constexpr int LDK = T::LDK, LDP = T::LDP;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [BQ][DMAX], quads swizzled
  float* ks = qs + BQ * DMAX;       // [2][BK][LDK]
  float* vs = ks + 2 * BK * LDK;    // [2][BK][DMAX]
  float* pT = vs + 2 * BK * DMAX;   // [BK][LDP]: P transposed

  const long head = blockIdx.x;
  const float* qh = q + head * Sq * d;
  const float* kh = k + head * Sk * d;
  const float* vh = v + head * Sk * d;
  float* oh = o + head * Sq * d;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q_start = qt * BQ;
  const int tid = threadIdx.x, ty = tid / NTX, tx = tid % NTX;

  // the kv tiles the block visits: none left of the band, none past the
  // diagonal of its last row
  int t_lo = 0, t_hi = (Sk + BK - 1) / BK - 1;
  if (window >= 0 && q_start - window + 1 > 0)
    t_lo = (q_start - window + 1) / BK;
  if (causal) t_hi = min(t_hi, (min(q_start + BQ, Sq) - 1) / BK);

  copy_tile<BQ, DMAX, DMAX, true, VEC>(qs, qh, q_start, Sq, d, tid);
  if (t_lo <= t_hi) {
    copy_tile<BK, DMAX, LDK, false, VEC>(ks, kh, t_lo * BK, Sk, d, tid);
    copy_tile<BK, DMAX, DMAX, false, VEC>(vs, vh, t_lo * BK, Sk, d, tid);
  }
  simt::cp_async_commit();

  float m[TR], l[TR], acc[TR][OC];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.0f;
  }
  // q's swizzle flips quad bit 2 on odd ty: quads 0-3 of each 8 sit 4
  // quads later, quads 4-7 four quads earlier
  const int s16 = 16 * (ty & 1);
  const float scale2 = scale * LOG2E;
  const float* q_lo = qs + 4 * ty * DMAX + s16;
  const float* q_hi = qs + 4 * ty * DMAX - s16;

  for (int t = t_lo; t <= t_hi; ++t) {
    const int buf = (t - t_lo) & 1;
    const float* kt = ks + buf * BK * LDK;
    const float* vt = vs + buf * BK * DMAX;
    simt::cp_async_wait_all();
    __syncthreads();  // tile t has landed; every thread is done with t - 1
    if (t < t_hi) {
      copy_tile<BK, DMAX, LDK, false, VEC>(ks + (buf ^ 1) * BK * LDK, kh,
                                           (t + 1) * BK, Sk, d, tid);
      copy_tile<BK, DMAX, DMAX, false, VEC>(vs + (buf ^ 1) * BK * DMAX, vh,
                                            (t + 1) * BK, Sk, d, tid);
      simt::cp_async_commit();
    }

    // S = q kᵀ: s[i][j] for row 4 ty + row_off(i) and key tx + 16 j
    float s[TR][SC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) s[i][j] = 0.0f;
#pragma unroll 1
    for (int cb = 0; cb < d; cb += 32) {  // zeros past d: skip whole blocks
#pragma unroll
      for (int kq = 0; kq < 8; ++kq) {
        const int c = cb + 4 * kq;
        float4 kf[SC];
#pragma unroll
        for (int j = 0; j < SC; ++j)
          kf[j] = simt::lds4(kt + (tx + NTX * j) * LDK + c);
        const float* qb = (kq < 4 ? q_lo : q_hi) + c;
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const float4 qf = simt::lds4(qb + row_off(i) * DMAX);
#pragma unroll
          for (int j = 0; j < SC; ++j) {
            s[i][j] = fmaf(qf.x, kf[j].x, s[i][j]);
            s[i][j] = fmaf(qf.y, kf[j].y, s[i][j]);
            s[i][j] = fmaf(qf.z, kf[j].z, s[i][j]);
            s[i][j] = fmaf(qf.w, kf[j].w, s[i][j]);
          }
        }
      }
    }

    // scale (by scale * log2 e: the softmax runs in base 2), mask (only
    // tiles that cross the diagonal, band edge or Sk), online softmax; the
    // thread's l is its own keys' share of the row sum
    const int k_start = t * BK;
    const bool edge = k_start + BK > Sk ||
                      (causal && k_start + BK - 1 > q_start) ||
                      (window >= 0 && k_start <= q_start + BQ - 1 - window);
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int qpos = q_start + 4 * ty + row_off(i);
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        float x = s[i][j] * scale2;
        if (edge) {
          const int kpos = k_start + tx + NTX * j;
          const bool ok = kpos < Sk && (!causal || kpos <= qpos) &&
                          (window < 0 || kpos > qpos - window);
          x = ok ? x : NEG_INF;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = NTX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = ex2(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        s[i][j] = ex2(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int g = 0; g < TR / 4; ++g)
#pragma unroll
      for (int j = 0; j < SC; ++j)
        *reinterpret_cast<float4*>(pT + (tx + NTX * j) * LDP + 64 * g +
                                   4 * ty) =
            make_float4(s[4 * g][j], s[4 * g + 1][j], s[4 * g + 2][j],
                        s[4 * g + 3][j]);
    __syncwarp();  // a row's P is written and read by its half-warp

    // O += P V
    const float* pp = pT + 4 * ty;
    const float* vp = vt + 4 * tx;
#pragma unroll 8
    for (int u = 0; u < BK; ++u)
      simt::fma_step<TR, OC, 64, 64>(acc, pp + u * LDP, vp + u * DMAX);
  }
  simt::cp_async_wait_all();  // only the q copy when no tile was visited

  // flush: the row sum over the half-warp, clamped, divides the row
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int off = NTX / 2; off > 0; off >>= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = q_start + 4 * ty + row_off(i);
    if (r >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = oh + (long)r * d;
#pragma unroll
    for (int g = 0; g < OC / 4; ++g) {
      const int col = 64 * g + 4 * tx;
      if (VEC) {
        if (col < d)
          *reinterpret_cast<float4*>(orow + col) = make_float4(
              acc[i][4 * g] / den, acc[i][4 * g + 1] / den,
              acc[i][4 * g + 2] / den, acc[i][4 * g + 3] / den);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < d) orow[col + e] = acc[i][4 * g + e] / den;
      }
    }
  }
}

template <int DMAX, bool VEC>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Sq, int Sk, int d, int causal, int window, float scale,
           cudaStream_t s) {
  using T = Tiles<DMAX>;
  constexpr int bytes = T::FLOATS * (int)sizeof(float);
  auto kernel = flash_fwd_kernel<DMAX, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Sq + T::BQ - 1) / T::BQ);
  kernel<<<grid, THREADS, bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, d, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

template <int DMAX>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int H, int Sq, int Sk, int d, int causal, int window,
             float scale, cudaStream_t s) {
  // 16-byte copies and stores where every row starts on 16 bytes
  if (d % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
      aligned16(o))
    return launch<DMAX, true>(q, k, v, o, B, H, Sq, Sk, d, causal, window,
                              scale, s);
  return launch<DMAX, false>(q, k, v, o, B, H, Sq, Sk, d, causal, window,
                             scale, s);
}

}  // namespace

// q, k, v, o f32; window < 0: no window.  The wrapper refuses d > 256.
extern "C" int launch_flash_attention(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int Sq, int Sk, int d, int causal,
                                      int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return launch_d<64>(q, k, v, o, B, H, Sq, Sk, d, causal, window, scale,
                        s);
  if (d <= 128)
    return launch_d<128>(q, k, v, o, B, H, Sq, Sk, d, causal, window, scale,
                         s);
  return launch_d<256>(q, k, v, o, B, H, Sq, Sk, d, causal, window, scale, s);
}
