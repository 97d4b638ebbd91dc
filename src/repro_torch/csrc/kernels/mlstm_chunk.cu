// Chunked gated linear attention, the mLSTM matrix-memory core:
//   C_t = exp(lf_t) C_{t-1} + i_t k_t v_t^T,  y_t = q_t C_t
// on q, k [BH, S, dk], v [BH, S, dv], lf, gi [BH, S, 1], in chunks of L
// steps with L = cumsum(lf) inside a chunk:
//   y = exp(L) (q C_in) + P v,  P = (q k^T) o W,  W[t, u] = exp(L_t - L_u) i_u
//   for u <= t (else 0);  C_out = exp(L_end) C_in + (k o cf)^T v with
//   cf_u = exp(L_end - L_u) i_u.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mlstm_chunk/kernel.py
// (mlstm_chunk_fwd, pl.pallas_call at :89; body _kernel at :30).  There
// the grid (BH, nt) runs the chunks in order on one core and keeps the
// whole state C [dk, dv] in VMEM scratch.  On Hopper the chunks' work is
// split by what depends on the state:
//
// 1. mlstm_p_kernel, one block per (chunk, batch-head), all in parallel
//    (1024 blocks at xlstm-125m): the chunk's cumulative log-decay L (a
//    warp scan), exp(L), cf and exp(L_end) for the other two kernels, and
//    the masked scores P = (q k^T) o W over the causal triangle only
//    (32 x 32 sub-blocks on or below the diagonal: 10 of 16), computed
//    once per chunk and written to scratch [BH, nc, 128, 128].
// 2. mlstm_state_kernel, the only serial part: one block per (48 columns
//    of dv, 384 rows of dk, batch-head) — 256 blocks at xlstm-125m, two
//    per SM, one wave on 132 SMs — walks the chunks in order with its
//    C tile in registers (16 x 6 a thread), writes each chunk's C_in to
//    scratch [BH, nc, dk, dv] and updates C = exp(L_end) C + (k o cf)^T v
//    from k and v streamed through shared memory in 16-step slices (96
//    FFMAs a thread a step for four float4 and three float2 loads).
// 3. mlstm_out_kernel, one block per (128 columns of dv, chunk,
//    batch-head), all in parallel: y = exp(L) (q C_in) + P v as one
//    register-tiled product over dk and then the chunk's 128 steps (the
//    tiles of P above the warp's rows are skipped).
//
// Why this split: the state update is the one recurrence; everything else
// is a product that needs C_in or nothing.  Writing C_in for every chunk
// (604 MB at xlstm-125m, written once and read once: about 0.36 ms of
// traffic at 3.35 TB/s) lets y run fully parallel, which the serial pass
// could not fill the card with (it holds 256 chains); and the recurrent
// pass then only does k^T v, an outer-product update whose operands come
// from shared memory and whose accumulator never leaves registers.
//
// Bound on this card: f32 operations.  The bound counts q k^T and P v over
// the causal triangle and q C_in and k^T v in full (90.3 GFLOP at
// xlstm-125m).  Executed: kernel 1 the 10/16 of the scores' square, kernel
// 2 k^T v in full, kernel 3 q C_in in full and P v over 3/4 of its square
// (64-step tiles): 95.0 GFLOP, 1.05 times the bound
// (kernel.executed_ops computes the count).  Each product runs from
// shared memory at 10 or more FFMAs per shared load (simt_f32.cuh).
//
// Chunks: L = min(bt, 128) steps; a larger bt runs as chunks of 128 steps
// (the same function, another rounding order).  A chunk shorter than 128
// runs in the same 128-step tiles, its steps past L zero.  Any dk and dv:
// kernel 2 covers dk in tiles of 384 rows, the tails zero-filled.
//
// Why CUDA C++: three register-tiled products with a serial chain over
// chunks in one of them, fed by cp.async; the same ctypes build as the
// package's other kernels.
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

constexpr int CH = 128;  // rows of a chunk's tiles (the longest chunk)

// rows [r0, r0 + R) and columns [c0, c0 + C) of a row-major matrix with
// row stride `stride` into dst[R][LDS], zeros at rows >= n or columns >= w
// (nothing read there).  VEC: 16-byte cp.async (f32, stride, c0 and w
// multiples of 4, src 16-byte aligned); else element by element (cp.async
// for f32, converted loads for bf16).
template <typename T, int R, int C, int LDS, int NT, bool VEC>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long r0,
                                          long n, int c0, int w, long stride,
                                          int tid) {
  if constexpr (VEC) {
    constexpr int Q = C / 4;
    for (int i = tid; i < R * Q; i += NT) {
      const int r = i / Q, c = 4 * (i % Q);
      const bool in = r0 + r < n && c0 + c < w;
      const T* g = in ? src + (r0 + r) * stride + c0 + c : src;
      simt::cp_async16(dst + r * LDS + c, g, in);
    }
  } else {
    for (int i = tid; i < R * C; i += NT) {
      const int r = i / C, c = i % C;
      const bool in = r0 + r < n && c0 + c < w;
      if constexpr (sizeof(T) == 4) {
        const T* g = in ? src + (r0 + r) * stride + c0 + c : src;
        simt::cp_async4(dst + r * LDS + c, g, in);
      } else {
        dst[r * LDS + c] = in ? ld(src, (r0 + r) * stride + c0 + c) : 0.0f;
      }
    }
  }
}

// ---- 1: per chunk, the decays and P ------------------------------------------
constexpr int P_THREADS = 256;
constexpr int P_KS = 32;           // dk slice of q and k
constexpr int P_LD = P_KS + 4;     // padded row of a slice

template <typename T, bool VEC>
__global__ void __launch_bounds__(P_THREADS, 1)
mlstm_p_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const float* __restrict__ lf, const float* __restrict__ gi,
               float* __restrict__ P, float* __restrict__ el,
               float* __restrict__ cf, float* __restrict__ g, int S, int dk,
               int L, int nc) {
  extern __shared__ __align__(16) float smem[];
  float* lc = smem;               // [CH] L, the cumulative log-decay
  float* gs = lc + CH;            // [CH] input gate
  float* qk = gs + CH;            // [2][2][CH][P_LD] q and k slices
  const int c = blockIdx.x;
  const long bh = blockIdx.y;
  const long t0 = (long)c * L;
  const int n = (int)min((long)L, S - t0);  // live steps
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long chunk = bh * nc + c;
  const T* qb = q + (bh * S + t0) * dk;
  const T* kb = k + (bh * S + t0) * dk;

  auto load = [&](int s) {
    float* qs = qk + (s & 1) * 2 * CH * P_LD;
    load_tile<T, CH, P_KS, P_LD, P_THREADS, VEC>(qs, qb, 0, n, s * P_KS, dk,
                                                 dk, tid);
    load_tile<T, CH, P_KS, P_LD, P_THREADS, VEC>(qs + CH * P_LD, kb, 0, n,
                                                 s * P_KS, dk, dk, tid);
  };
  const int ns = (dk + P_KS - 1) / P_KS;
  load(0);
  simt::cp_async_commit();

  if (tid < CH) {
    lc[tid] = tid < n ? lf[bh * S + t0 + tid] : 0.0f;
    gs[tid] = tid < n ? gi[bh * S + t0 + tid] : 0.0f;
  }
  __syncthreads();
  if (tid < 32) {  // inclusive scan: 4 steps a lane, then across the warp
    float run = 0.0f, part[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) part[e] = run += lc[4 * tid + e];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, run, off);
      if (tid >= off) run += o;
    }
    // the sum of the lanes before: this lane's four steps start from it
    float pre = __shfl_up_sync(0xffffffffu, run, 1);
    if (tid == 0) pre = 0.0f;
#pragma unroll
    for (int e = 0; e < 4; ++e) lc[4 * tid + e] = pre + part[e];
  }
  __syncthreads();
  const float lend = lc[CH - 1];  // steps past n add 0
  if (tid < CH) {
    el[chunk * CH + tid] = expf(lc[tid]);
    cf[chunk * CH + tid] = expf(lend - lc[tid]) * gs[tid];
  }
  if (tid == 0) g[chunk] = expf(lend);

  // scores of rows ty + 16 i and keys tx + 16 j, only the 32 x 32
  // sub-blocks on or below the diagonal (j / 2 <= i / 2)
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  for (int s = 0; s < ns; ++s) {
    simt::cp_async_wait_all();
    __syncthreads();  // slice s landed; slice s - 1's readers are done
    if (s + 1 < ns) {
      load(s + 1);
      simt::cp_async_commit();
    }
    const float* qs = qk + (s & 1) * 2 * CH * P_LD;
    const float* ks = qs + CH * P_LD;
#pragma unroll 2
    for (int c4 = 0; c4 < P_KS; c4 += 4) {
      float4 qf[8], kf[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        qf[i] = simt::lds4(qs + (ty + 16 * i) * P_LD + c4);
        kf[i] = simt::lds4(ks + (tx + 16 * i) * P_LD + c4);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j / 2 > i / 2) continue;
          acc[i][j] = fmaf(qf[i].x, kf[j].x, acc[i][j]);
          acc[i][j] = fmaf(qf[i].y, kf[j].y, acc[i][j]);
          acc[i][j] = fmaf(qf[i].z, kf[j].z, acc[i][j]);
          acc[i][j] = fmaf(qf[i].w, kf[j].w, acc[i][j]);
        }
    }
  }
  simt::cp_async_wait_all();

  // P = scores o W, zero above the diagonal and past the live steps
  float* pc = P + chunk * CH * CH;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = ty + 16 * i;
    const float lt = lc[t];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int u = tx + 16 * j;
      pc[t * CH + u] = u <= t && t < n
          ? acc[i][j] * (expf(lt - lc[u]) * gs[u]) : 0.0f;
    }
  }
}

// ---- 2: the state, chunk after chunk ----------------------------------------
constexpr int C_THREADS = 192;
constexpr int C_ROWS = 384;        // dk rows of a block's C tile
constexpr int C_COLS = 48;         // dv columns of a block's C tile
constexpr int C_TS = 16;           // steps of a k / v slice
constexpr int C_LDK = C_ROWS + 4;  // padded row of a k slice
constexpr int C_STAGE = C_TS * C_LDK + C_TS * C_COLS + C_TS;

// Two 6-warp blocks an SM: three warps a scheduler, whose register file
// then leaves each thread up to 168 registers for its 96 accumulators
// (three blocks would cap it at 96 and spill).
template <typename T, bool VEC>
__global__ void __launch_bounds__(C_THREADS, 2)
mlstm_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ cf, const float* __restrict__ g,
                   float* __restrict__ states, float* __restrict__ c_final,
                   int S, int dk, int dv, int L, int nc) {
  extern __shared__ __align__(16) float smem[];  // 2 stages of {k, v, cf}
  const long bh = blockIdx.z;
  const int row0 = blockIdx.y * C_ROWS, col0 = blockIdx.x * C_COLS;
  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;
  // the thread's C: rows row0 + row_of(i), columns col0 + 6 tx + j — four
  // groups of four rows 96 apart, so that the four ty of a warp read one
  // 64-byte span of a k row (one wavefront a float4 load)
  const auto row_of = [&](int i) { return 96 * (i / 4) + 4 * ty + i % 4; };
  const int cc = col0 + 6 * tx;
  const int spc = (L + C_TS - 1) / C_TS;  // slices a chunk
  const int nz = nc * spc;
  const T* kb = k + bh * S * dk;
  const T* vb = v + bh * S * dv;

  auto load = [&](int z) {
    float* ks = smem + (z & 1) * C_STAGE;
    float* vs = ks + C_TS * C_LDK;
    float* cs = vs + C_TS * C_COLS;
    const int c = z / spc, s = z % spc;
    const long t = (long)c * L + s * C_TS;           // first step
    const long n = min((long)c * L + L, (long)S);    // the chunk's end
    load_tile<T, C_TS, C_ROWS, C_LDK, C_THREADS, VEC>(ks, kb, t, n, row0, dk,
                                                      dk, tid);
    load_tile<T, C_TS, C_COLS, C_COLS, C_THREADS, VEC>(vs, vb, t, n, col0, dv,
                                                       dv, tid);
    if (tid < C_TS)
      simt::cp_async4(cs + tid, cf + (bh * nc + c) * CH + s * C_TS + tid,
                      true);
  };

  float acc[16][6];
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) acc[i][j] = 0.0f;

  // the thread's C tile to dst [dk, dv]
  auto store = [&](float* dst) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = row0 + row_of(i);
      if (r >= dk) continue;
      float* row = dst + (long)r * dv + cc;
      if (VEC && cc + 6 <= dv) {
#pragma unroll
        for (int j = 0; j < 6; j += 2)
          *reinterpret_cast<float2*>(row + j) =
              make_float2(acc[i][j], acc[i][j + 1]);
      } else {
#pragma unroll
        for (int j = 0; j < 6; ++j)
          if (cc + j < dv) row[j] = acc[i][j];
      }
    }
  };

  load(0);
  simt::cp_async_commit();
  for (int z = 0; z < nz; ++z) {
    const int c = z / spc;
    if (z % spc == 0) {  // a chunk starts: its C_in, then the decay
      store(states + (bh * nc + c) * dk * dv);
      const float gc = g[bh * nc + c];
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int j = 0; j < 6; ++j) acc[i][j] *= gc;
    }
    simt::cp_async_wait_all();
    __syncthreads();  // slice z landed; slice z - 1's readers are done
    if (z + 1 < nz) {
      load(z + 1);
      simt::cp_async_commit();
    }
    const float* ks = smem + (z & 1) * C_STAGE + 4 * ty;
    const float* vs = smem + (z & 1) * C_STAGE + C_TS * C_LDK + 6 * tx;
    const float* cs = smem + (z & 1) * C_STAGE + C_TS * C_LDK
        + C_TS * C_COLS;
#pragma unroll 2
    for (int u = 0; u < C_TS; ++u) {
      float kv[16], vv[6];
      simt::lds_frag<16, 96>(kv, ks + u * C_LDK);
      const float w = cs[u];
#pragma unroll
      for (int j = 0; j < 6; j += 2) {
        const float2 v2 =
            *reinterpret_cast<const float2*>(vs + u * C_COLS + j);
        vv[j] = v2.x * w;
        vv[j + 1] = v2.y * w;
      }
      simt::outer_fma(acc, kv, vv);
    }
  }
  simt::cp_async_wait_all();
  store(c_final + bh * dk * dv);
}

// ---- 3: the outputs, every chunk at once ----------------------------------------
constexpr int Y_THREADS = 256, Y_BN = 128, Y_BK = 64, Y_TM = 8, Y_TN = 8;
constexpr int Y_LDA = Y_BK + 4;  // padded row of a stage's A slice
constexpr int Y_STAGE = CH * Y_LDA + Y_BK * Y_BN;
constexpr int Y_SMEM = 2 * Y_STAGE * (int)sizeof(float);

template <typename T, bool VEC>
__global__ void __launch_bounds__(Y_THREADS, 1)
mlstm_out_kernel(const T* __restrict__ q, const T* __restrict__ v,
                 const float* __restrict__ states,
                 const float* __restrict__ P, const float* __restrict__ el,
                 T* __restrict__ y, int S, int dk, int dv, int L, int nc) {
  extern __shared__ __align__(16) float smem[];  // 2 stages of {A, B}
  const long bh = blockIdx.z;
  const int c = blockIdx.y, col0 = blockIdx.x * Y_BN;
  const long t0 = (long)c * L;
  const int n = (int)min((long)L, S - t0);
  const long chunk = bh * nc + c;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the thread's outputs: rows rt + 4 i, columns ct + 32 (j / 4) + j % 4
  const int rt = 32 * (warp / 2) + lane / 8;
  const int ct = Y_BN / 2 * (warp % 2) + 4 * (lane % 8);
  const T* qb = q + (bh * S + t0) * dk;
  const T* vb = v + (bh * S + t0) * dv;
  const float* sb = states + chunk * dk * dv;
  const float* pb = P + chunk * CH * CH;
  // slices 0 .. na - 1 run q C_in over dk, the last CH / Y_BK run P v
  const int na = (dk + Y_BK - 1) / Y_BK, nz = na + CH / Y_BK;

  auto load = [&](int z) {
    float* as = smem + (z & 1) * Y_STAGE;
    float* bs = as + CH * Y_LDA;
    if (z < na) {
      const int k0 = z * Y_BK;
      load_tile<T, CH, Y_BK, Y_LDA, Y_THREADS, VEC>(as, qb, 0, n, k0, dk, dk,
                                                    tid);
      load_tile<float, Y_BK, Y_BN, Y_BN, Y_THREADS, VEC>(bs, sb, k0, dk,
                                                         col0, dv, dv, tid);
    } else {
      const int u0 = (z - na) * Y_BK;
      load_tile<float, CH, Y_BK, Y_LDA, Y_THREADS, true>(as, pb, 0, CH, u0,
                                                         CH, CH, tid);
      load_tile<T, Y_BK, Y_BN, Y_BN, Y_THREADS, VEC>(bs, vb, u0, n, col0, dv,
                                                     dv, tid);
    }
  };

  float acc[Y_TM][Y_TN];
#pragma unroll
  for (int i = 0; i < Y_TM; ++i)
#pragma unroll
    for (int j = 0; j < Y_TN; ++j) acc[i][j] = 0.0f;

  load(0);
  simt::cp_async_commit();
  for (int z = 0; z < nz; ++z) {
    simt::cp_async_wait_all();
    __syncthreads();  // slice z landed; slice z - 1's readers are done
    if (z + 1 < nz) {
      load(z + 1);
      simt::cp_async_commit();
    }
    if (z == na) {  // q C_in is complete: scale row t by exp(L_t)
#pragma unroll
      for (int i = 0; i < Y_TM; ++i) {
        const float e = el[chunk * CH + rt + 4 * i];
#pragma unroll
        for (int j = 0; j < Y_TN; ++j) acc[i][j] *= e;
      }
    }
    // P's columns past the warp's last row are zero: skip them
    if (z >= na && (z - na) * Y_BK > 32 * (warp / 2) + 31) continue;
    const float* as = smem + (z & 1) * Y_STAGE + rt * Y_LDA;
    const float* bs = smem + (z & 1) * Y_STAGE + CH * Y_LDA + ct;
#pragma unroll
    for (int kp = 0; kp < Y_BK / 2; ++kp) {
      float2 a[Y_TM];
#pragma unroll
      for (int i = 0; i < Y_TM; ++i)
        a[i] = *reinterpret_cast<const float2*>(as + 4 * i * Y_LDA + 2 * kp);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        float av[Y_TM], bv[Y_TN];
#pragma unroll
        for (int i = 0; i < Y_TM; ++i) av[i] = kk == 0 ? a[i].x : a[i].y;
        simt::lds_frag<Y_TN, 32>(bv, bs + (2 * kp + kk) * Y_BN);
        simt::outer_fma(acc, av, bv);
      }
    }
  }
  simt::cp_async_wait_all();

  T* yb = y + (bh * S + t0) * dv;
#pragma unroll
  for (int i = 0; i < Y_TM; ++i) {
    const int t = rt + 4 * i;
    if (t >= n) continue;
#pragma unroll
    for (int gq = 0; gq < Y_TN / 4; ++gq) {
      const int col = col0 + ct + 32 * gq;
      if constexpr (VEC) {
        if (col < dv)
          *reinterpret_cast<float4*>(yb + (long)t * dv + col) =
              make_float4(acc[i][4 * gq], acc[i][4 * gq + 1],
                          acc[i][4 * gq + 2], acc[i][4 * gq + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < dv) st(yb, (long)t * dv + col + e, acc[i][4 * gq + e]);
      }
    }
  }
}

template <typename T, bool VEC>
int launch(const void* q, const void* k, const void* v, const void* lf,
           const void* gi, void* y, void* c_final, void* P, void* states,
           void* el, void* cf, void* g, int BH, int S, int dk, int dv, int L,
           cudaStream_t s) {
  const int nc = (S + L - 1) / L;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  float* Pf = static_cast<float*>(P);
  float* sf = static_cast<float*>(states);
  float* elf = static_cast<float*>(el);
  float* cff = static_cast<float*>(cf);
  float* gf = static_cast<float*>(g);

  constexpr int p_bytes = (2 * CH + 4 * CH * P_LD) * (int)sizeof(float);
  auto pk = mlstm_p_kernel<T, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      pk, cudaFuncAttributeMaxDynamicSharedMemorySize, p_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  pk<<<dim3(nc, BH), P_THREADS, p_bytes, s>>>(
      qt, kt, static_cast<const float*>(lf), static_cast<const float*>(gi),
      Pf, elf, cff, gf, S, dk, L, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr int c_bytes = 2 * C_STAGE * (int)sizeof(float);
  auto ck = mlstm_state_kernel<T, VEC>;
  err = cudaFuncSetAttribute(
      ck, cudaFuncAttributeMaxDynamicSharedMemorySize, c_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ck<<<dim3((dv + C_COLS - 1) / C_COLS, (dk + C_ROWS - 1) / C_ROWS, BH),
       C_THREADS, c_bytes, s>>>(kt, vt, cff, gf, sf,
                                static_cast<float*>(c_final), S, dk, dv, L,
                                nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto yk = mlstm_out_kernel<T, VEC>;
  err = cudaFuncSetAttribute(
      yk, cudaFuncAttributeMaxDynamicSharedMemorySize, Y_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  yk<<<dim3((dv + Y_BN - 1) / Y_BN, nc, BH), Y_THREADS, Y_SMEM, s>>>(
      qt, vt, sf, Pf, elf, static_cast<T*>(y), S, dk, dv, L, nc);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v, y); lf, gi, c_final and the
// scratch (P [BH, nc, 128, 128], states [BH, nc, dk, dv], el and cf
// [BH, nc, 128], g [BH, nc], nc = ceil(S / L)) are float32.  L: the
// chunk, 1 to 128 steps.
extern "C" int launch_mlstm_chunk(const void* q, const void* k,
                                  const void* v, const void* lf,
                                  const void* gi, void* y, void* c_final,
                                  void* P, void* states, void* el, void* cf,
                                  void* g, int BH, int S, int dk, int dv,
                                  int L, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L < 1 || L > CH) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 0)
    return launch<__nv_bfloat16, false>(q, k, v, lf, gi, y, c_final, P,
                                        states, el, cf, g, BH, S, dk, dv, L,
                                        s);
  // 16-byte copies and stores where every row starts on 16 bytes
  if (dk % 4 == 0 && dv % 4 == 0 && aligned16(q) && aligned16(k) &&
      aligned16(v) && aligned16(y) && aligned16(c_final))
    return launch<float, true>(q, k, v, lf, gi, y, c_final, P, states, el,
                               cf, g, BH, S, dk, dv, L, s);
  return launch<float, false>(q, k, v, lf, gi, y, c_final, P, states, el, cf,
                              g, BH, S, dk, dv, L, s);
}
