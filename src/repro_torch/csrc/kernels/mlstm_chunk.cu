// Chunked gated linear attention, the mLSTM matrix-memory core:
//   C_t = exp(lf_t) C_{t-1} + i_t k_t v_t^T,  y_t = q_t C_t
// on q, k [BH, S, dk], v [BH, S, dv], lf, gi [BH, S, 1], in chunks of bt
// steps: y = exp(L) q C_in + (q k^T o W) v inside a chunk, then
// C_out = exp(L_end) C_in + (k o exp(L_end - L) i)^T v.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mlstm_chunk/kernel.py
// (mlstm_chunk_fwd, pl.pallas_call at :89; body _kernel at :30).  There
// the grid (BH, nt) runs chunks in order and keeps the whole state
// C [dk, dv] in VMEM scratch.  At xlstm-125m's dk = dv = 384 the state is
// 576 KB in f32, more than a block's 227 KB of shared memory, so here the
// grid is (dv / 64, BH): each block carries its C[:, 64-column tile] in
// shared memory over the chunks, in order, and recomputes the chunk's
// [bt, bt] score matrix q k^T itself.  q and k do not fit whole either
// ([128, 384] f32 each): they stream through shared memory in 32-wide dk
// slices, and each slice feeds the scores, the inter-chunk product with
// C_in and then the update of the same 32 state rows.  The decay-weighted
// scores then go through shared memory 16 columns at a time for the
// product with the chunk's v tile.
//
// Why CUDA C++: the state is carried across a serial loop of chunks
// inside the block, and the same ctypes build serves the package's four
// kernels.
//
// Bound on this card: f32 operations (about 1e11 at xlstm-125m's width
// with S = 4096, bt = 128); this kernel multiplies on the CUDA cores out
// of shared memory with one block of 8 warps on an SM, and recomputes the
// scores once per 64-column tile of dv (6 times at dv = 384).
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

constexpr int TV = 64;        // state columns a block carries
constexpr int KS = 32;        // width of a dk slice of q and k
constexpr int THREADS = 256;
constexpr int LDK = KS + 1;   // padded row stride of the q and k slices
constexpr int LDP = 17;       // padded row stride of a 16-column score slice
constexpr int KG = THREADS / TV;  // row groups of the state update
constexpr int KM = KS / KG;       // state rows a thread updates per slice

__host__ __device__ constexpr int padded_dk(int dk) {
  return (dk + KS - 1) / KS * KS;
}

template <int BT>
__host__ __device__ constexpr int smem_floats(int dk) {
  return padded_dk(dk) * TV + BT * TV + 2 * BT * LDK + 3 * BT;
}

template <typename T, int BT>
__global__ void __launch_bounds__(THREADS)
mlstm_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ lf,
                   const float* __restrict__ gi, T* __restrict__ y,
                   float* __restrict__ c_final, int S, int dk, int dv,
                   int bt) {
  constexpr int RT = BT / 16;  // chunk rows (t) a thread owns
  constexpr int CT = BT / 16;  // score columns (u) a thread owns
  constexpr int VC = TV / 16;  // output columns a thread owns
  extern __shared__ float smem[];
  const int dkp = padded_dk(dk);
  float* cs = smem;             // [dkp][TV] state slice
  float* vs = cs + dkp * TV;    // [BT][TV] the chunk's v tile
  float* qs = vs + BT * TV;     // [BT][LDK] q slice
  float* ks = qs + BT * LDK;    // [BT][LDK] k slice
  float* lc = ks + BT * LDK;    // [BT] cumulative log-decay L
  float* gs = lc + BT;          // [BT] input gate
  float* cf = gs + BT;          // [BT] exp(L_end - L[u]) * i[u]
  float* ps = qs;               // [BT][LDP] scores, once q is consumed

  const int j0 = blockIdx.x * TV;
  const long bh = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int jc = tid % TV, kr0 = tid / TV;  // state-update ownership
  const T* qb = q + bh * S * dk;
  const T* kb = k + bh * S * dk;
  const T* vb = v + bh * S * dv;
  const float* lfb = lf + bh * S;
  const float* gib = gi + bh * S;
  T* yb = y + bh * S * dv;

  for (int i = tid; i < dkp * TV; i += THREADS) cs[i] = 0.0f;

  for (int t0 = 0; t0 < S; t0 += bt) {
    const int n = min(bt, S - t0);  // live steps of this chunk
    __syncthreads();  // the previous chunk's readers are done
    for (int r = tid; r < BT; r += THREADS) {
      lc[r] = r < n ? lfb[t0 + r] : 0.0f;
      gs[r] = r < n ? gib[t0 + r] : 0.0f;
    }
    for (int i = tid; i < BT * TV; i += THREADS) {
      const int r = i / TV, c = i % TV;
      vs[i] = (r < n && j0 + c < dv) ? ld(vb, (long)(t0 + r) * dv + j0 + c)
                                     : 0.0f;
    }
    __syncthreads();
    if (tid == 0) {
      float run = 0.0f;
      for (int r = 0; r < BT; ++r) {
        run += lc[r];
        lc[r] = run;
      }
    }
    __syncthreads();
    const float total = lc[BT - 1];
    const float etot = expf(total);
    for (int r = tid; r < BT; r += THREADS)
      cf[r] = expf(total - lc[r]) * gs[r];

    float sacc[RT][CT], yacc[RT][VC];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
#pragma unroll
      for (int j = 0; j < CT; ++j) sacc[i][j] = 0.0f;
#pragma unroll
      for (int c = 0; c < VC; ++c) yacc[i][c] = 0.0f;
    }

    for (int k0 = 0; k0 < dkp; k0 += KS) {
      for (int i = tid; i < BT * KS; i += THREADS) {
        const int r = i / KS, c = i % KS;
        const bool in = r < n && k0 + c < dk;
        const long g = (long)(t0 + r) * dk + k0 + c;
        qs[r * LDK + c] = in ? ld(qb, g) : 0.0f;
        ks[r * LDK + c] = in ? ld(kb, g) : 0.0f;
      }
      __syncthreads();
      // scores q k^T and the inter-chunk product q C_in, over this slice
#pragma unroll 4
      for (int c = 0; c < KS; ++c) {
        float qv[RT], kv[CT], cv[VC];
#pragma unroll
        for (int i = 0; i < RT; ++i) qv[i] = qs[(ty * RT + i) * LDK + c];
#pragma unroll
        for (int j = 0; j < CT; ++j) kv[j] = ks[(tx + 16 * j) * LDK + c];
#pragma unroll
        for (int vc = 0; vc < VC; ++vc)
          cv[vc] = cs[(k0 + c) * TV + tx + 16 * vc];
#pragma unroll
        for (int i = 0; i < RT; ++i) {
#pragma unroll
          for (int j = 0; j < CT; ++j) sacc[i][j] += qv[i] * kv[j];
#pragma unroll
          for (int vc = 0; vc < VC; ++vc) yacc[i][vc] += qv[i] * cv[vc];
        }
      }
      __syncthreads();  // every read of C_in[k0 : k0 + KS] is done
      // state update of the same rows: C = exp(L_end) C + kw^T v
      float sum[KM];
#pragma unroll
      for (int m = 0; m < KM; ++m) sum[m] = 0.0f;
#pragma unroll 4
      for (int u = 0; u < BT; ++u) {
        const float wv = cf[u] * vs[u * TV + jc];
#pragma unroll
        for (int m = 0; m < KM; ++m) sum[m] += ks[u * LDK + kr0 + KG * m] * wv;
      }
#pragma unroll
      for (int m = 0; m < KM; ++m) {
        float* cp = &cs[(k0 + kr0 + KG * m) * TV + jc];
        *cp = etot * *cp + sum[m];
      }
      __syncthreads();  // before the next slice overwrites qs and ks
    }

    // y = exp(L[t]) (q C_in)[t] + sum_u (s o W)[t, u] v[u]
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float el = expf(lc[ty * RT + i]);
#pragma unroll
      for (int vc = 0; vc < VC; ++vc) yacc[i][vc] *= el;
    }
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int u = tx + 16 * j;
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int t = ty * RT + i;
        const float wgt = u <= t ? expf(lc[t] - lc[u]) * gs[u] : 0.0f;
        ps[t * LDP + tx] = sacc[i][j] * wgt;
      }
      __syncthreads();
#pragma unroll 4
      for (int uu = 0; uu < 16; ++uu) {
        float pv[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i) pv[i] = ps[(ty * RT + i) * LDP + uu];
#pragma unroll
        for (int vc = 0; vc < VC; ++vc) {
          const float vv = vs[(16 * j + uu) * TV + tx + 16 * vc];
#pragma unroll
          for (int i = 0; i < RT; ++i) yacc[i][vc] += pv[i] * vv;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int t = ty * RT + i;
      if (t >= n) continue;
#pragma unroll
      for (int vc = 0; vc < VC; ++vc) {
        const int col = j0 + tx + 16 * vc;
        if (col < dv) st(yb, (long)(t0 + t) * dv + col, yacc[i][vc]);
      }
    }
  }

  __syncthreads();
  for (int i = tid; i < dk * TV; i += THREADS) {
    const int r = i / TV, c = i % TV;
    if (j0 + c < dv) c_final[(bh * dk + r) * dv + j0 + c] = cs[r * TV + c];
  }
}

template <typename T, int BT>
int launch(const void* q, const void* k, const void* v, const void* lf,
           const void* gi, void* y, void* c_final, int BH, int S, int dk,
           int dv, int bt, cudaStream_t s) {
  const int bytes = smem_floats<BT>(dk) * (int)sizeof(float);
  auto kernel = mlstm_chunk_kernel<T, BT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((dv + TV - 1) / TV, BH);
  kernel<<<grid, THREADS, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(lf),
      static_cast<const float*>(gi), static_cast<T*>(y),
      static_cast<float*>(c_final), S, dk, dv, bt);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bt(const void* q, const void* k, const void* v, const void* lf,
              const void* gi, void* y, void* c_final, int BH, int S, int dk,
              int dv, int bt, cudaStream_t s) {
  if (bt <= 32)
    return launch<T, 32>(q, k, v, lf, gi, y, c_final, BH, S, dk, dv, bt, s);
  if (bt <= 64)
    return launch<T, 64>(q, k, v, lf, gi, y, c_final, BH, S, dk, dv, bt, s);
  return launch<T, 128>(q, k, v, lf, gi, y, c_final, BH, S, dk, dv, bt, s);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v, y); lf, gi and c_final are
// float32.  The wrapper refuses bt > 128 and dk > 640.
extern "C" int launch_mlstm_chunk(const void* q, const void* k,
                                  const void* v, const void* lf,
                                  const void* gi, void* y, void* c_final,
                                  int BH, int S, int dk, int dv, int bt,
                                  int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bt<float>(q, k, v, lf, gi, y, c_final, BH, S, dk, dv, bt,
                            s);
  return launch_bt<__nv_bfloat16>(q, k, v, lf, gi, y, c_final, BH, S, dk, dv,
                                  bt, s);
}
