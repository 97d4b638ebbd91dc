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
// inside one block per (b, h, 64-row q tile), with the q tile and each
// 32-row k and v tile staged in shared memory as f32 and the state in
// registers: a thread owns 4 query rows — 2 scores of each kv tile and
// d/16 output columns of each row — and the 16 threads that share a row
// reduce its max and sum with warp shuffles.
//
// Kept from the TPU kernel: whole kv tiles past the diagonal (causal) or
// left of the window band are skipped; masked scores are NEG_INF = -1e30
// (not -inf, so exp(s - m) never sees inf - inf); the kv tail rows past Sk
// are zeros, never read, so 0 * NaN cannot leak; the denominator is
// clamped to 1e-30 on the flush.  Products are IEEE f32 (no TF32): the
// f32 results are held to 2e-5.
//
// Head widths: d <= 64, <= 128 and <= 256 each have a build (DMAX) whose
// tiles pad the head with zeros, so any d <= 256 works (h2o-danube's 120
// runs in the 128 build).  Shared memory: (64 + 32) * (DMAX + 1) + 32 * DMAX
// + 64 * 33 floats — 41.6 KB, 74.4 KB and 140 KB.
//
// Why CUDA C++: the kv sweep carries per-row state across a loop inside
// the block, and the same ctypes build serves the package's kernels.
//
// Bound on this card: f32 at Llama 3.2 3B's prefill shape is bound by the
// CUDA cores' f32 rate; this kernel multiplies out of shared memory, so it
// is bound by that rate and by shared-memory reads.
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64, BK = 32, THREADS = 256;
constexpr int RT = BQ / 16;  // query rows a thread owns
constexpr int CT = BK / 16;  // scores of a row a thread owns per kv tile
constexpr float NEG_INF = -1e30f;

template <int DMAX>
constexpr int smem_floats() {
  return (BQ + BK) * (DMAX + 1) + BK * DMAX + BQ * (BK + 1);
}

template <int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk,
                 int d, int causal, int window, float scale) {
  constexpr int LD = DMAX + 1;  // padded row stride of the q and k tiles
  constexpr int DC = DMAX / 16; // output columns of a row a thread owns
  extern __shared__ float smem[];
  float* qs = smem;             // [BQ][LD]
  float* ks = qs + BQ * LD;     // [BK][LD]
  float* vs = ks + BK * LD;     // [BK][DMAX]
  float* ps = vs + BK * DMAX;   // [BQ][BK + 1] probabilities

  const long head = (long)blockIdx.z * gridDim.y + blockIdx.y;
  const float* qh = q + head * Sq * d;
  const float* kh = k + head * Sk * d;
  const float* vh = v + head * Sk * d;
  float* oh = o + head * Sq * d;
  const int q_start = blockIdx.x * BQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  for (int i = tid; i < BQ * DMAX; i += THREADS) {
    const int r = i / DMAX, c = i % DMAX;
    qs[r * LD + c] = (q_start + r < Sq && c < d)
                         ? qh[(long)(q_start + r) * d + c] : 0.0f;
  }
  float m[RT], l[RT], acc[RT][DC];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
  }

  const int nk = (Sk + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k_start = kt * BK;
    // tile-level skips, uniform over the block
    if (causal && k_start > q_start + BQ - 1) break;
    if (window >= 0 && k_start + BK - 1 <= q_start - window) continue;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * DMAX; i += THREADS) {
      const int r = i / DMAX, c = i % DMAX;
      const bool in = k_start + r < Sk && c < d;
      const long g = (long)(k_start + r) * d + c;
      ks[r * LD + c] = in ? kh[g] : 0.0f;
      vs[r * DMAX + c] = in ? vh[g] : 0.0f;
    }
    __syncthreads();

    float s[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int c = 0; c < DMAX; ++c) {
      float qv[RT], kv[CT];
#pragma unroll
      for (int i = 0; i < RT; ++i) qv[i] = qs[(ty * RT + i) * LD + c];
#pragma unroll
      for (int j = 0; j < CT; ++j) kv[j] = ks[(tx + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int qpos = q_start + ty * RT + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int kpos = k_start + tx + 16 * j;
        const bool ok = kpos < Sk && (!causal || kpos <= qpos) &&
                        (window < 0 || kpos > qpos - window);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are lanes tx = 0..15 of one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty * RT + i) * (BK + 1) + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int u = 0; u < BK; ++u) {
      float pv[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) pv[i] = ps[(ty * RT + i) * (BK + 1) + u];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = vs[u * DMAX + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < RT; ++i) acc[i][c] += pv[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = q_start + ty * RT + i;
    if (r >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) oh[(long)r * d + col] = acc[i][c] / den;
    }
  }
}

template <int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Sq, int Sk, int d, int causal, int window, float scale,
           cudaStream_t s) {
  constexpr int bytes = smem_floats<DMAX>() * (int)sizeof(float);
  auto kernel = flash_fwd_kernel<DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, d, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o f32; window < 0: no window.  The wrapper refuses d > 256.
extern "C" int launch_flash_attention(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int Sq, int Sk, int d, int causal,
                                      int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return launch<64>(q, k, v, o, B, H, Sq, Sk, d, causal, window, scale, s);
  if (d <= 128)
    return launch<128>(q, k, v, o, B, H, Sq, Sk, d, causal, window, scale, s);
  return launch<256>(q, k, v, o, B, H, Sq, Sk, d, causal, window, scale, s);
}
