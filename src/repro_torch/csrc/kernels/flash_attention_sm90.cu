// Flash attention forward for bf16 on Hopper: wgmma products fed by TMA.
// Causal or sliding-window softmax attention on q, k, v [B, H, S, d] bf16
// (kv repeated for GQA), online softmax in f32 registers.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_fwd, pl.pallas_call at :114; body _fwd_kernel at :30)
// for bf16 inputs; f32 inputs keep the CUDA-core kernel of
// flash_attention.cu.  There the grid (B, H, nq, nk) sweeps kv tiles
// innermost and keeps the accumulator, running max and denominator in VMEM
// scratch between grid steps; here the kv sweep is a loop inside one block
// per (b, h, 128-row q tile), with the state in registers.
//
// Bound on this card: at Llama 3.2 3B's prefill shape the work is bound
// by the tensor cores' bf16 rate (4 S^2 d / 2 operations against 4 S d
// bytes per head).  The design feeds the tensor cores from shared memory
// without the threads touching the tiles:
//  * a producer warpgroup (warps 8-11) whose first thread issues TMA
//    loads: q once (128 rows), then each kv tile's K and V (BK rows) into
//    a ring of two stages, 128-byte swizzled, completion on an mbarrier
//    per stage and tensor; a stage is refilled once all eight consumer
//    warps have released it.  The warpgroup keeps 40 registers a thread
//    and gives the rest to the consumers (setmaxnreg: 232 each), which
//    the 64 x 256 O accumulator of the d <= 256 build needs;
//  * two consumer warpgroups (warps 0-3 and 4-7) own 64 q rows each:
//    S = Q K^T by wgmma from the shared tiles into f32 registers; row max
//    and sum across the 4 threads of a row by quad shuffles; P = exp2(S -
//    m) becomes the A operand of O += P V in registers, as two bf16
//    operands hi = bf16(P) and lo = bf16(P - hi) (one alone rounds P to 8
//    bits, which moves an output by up to 2^-9 of the values it averages,
//    more than one bf16 step of the output where they cancel), with V read
//    from shared memory as the transposed B operand; O is rescaled in f32
//    registers and cast to bf16 once, at the final store.
//
// Kept from the TPU kernel: whole kv tiles past the diagonal (causal) or
// left of the window band are skipped (by the 128-row q tile); masked
// scores are NEG_INF = -1e30 (not -inf, so exp(s - m) never sees inf -
// inf); kv rows past Sk and head columns past d are zeros (TMA fills the
// box outside the tensor with zeros), so 0 * NaN cannot leak; the
// denominator is clamped to 1e-30 on the flush.  Scores are scaled by
// scale * log2(e) so that the exponentials are exp2; a fully masked row
// sees exp2(0) = 1 for its masked keys until a real key wipes them, as
// the TPU kernel's exp(0) does.
//
// Head widths: builds for d <= 64, <= 128 (kv tiles of 128 rows) and
// <= 256 (kv tiles of 64 rows, for the register budget: 128 f32
// accumulator registers for a 64 x 256 O); the head is padded with zeros,
// so d = 120 runs in the 128 build.  d must be a multiple of 8 (TMA takes
// global strides in multiples of 16 bytes).  Shared memory: q 128 DMAX
// bf16, two stages of K and V BK DMAX each — 80, 160 and 192 KB.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "kernels/sm90.cuh"

namespace {

using namespace sm90;

constexpr int BQ = 128;            // q rows of a block
constexpr int THREADS = 384;       // two consumer warpgroups + producer
// registers a thread after the split (setmaxnreg): the producer warpgroup
// gives up what the consumers' accumulators need; 128 x 40 + 256 x 232
// stays within the SM's 65536
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int STAGES = 2;
constexpr float NEG_INF = -1e30f;

template <int DMAX>
__host__ __device__ constexpr int kv_rows() { return DMAX > 128 ? 64 : 128; }

template <int DMAX>
constexpr int smem_bytes() {
  return 1024 + BQ * DMAX * 2 + STAGES * 2 * kv_rows<DMAX>() * DMAX * 2 + 64;
}

template <int DMAX>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               __nv_bfloat16* __restrict__ o, int Sq, int Sk, int d,
               int causal, int window, float scale_log2) {
  constexpr int BK = kv_rows<DMAX>();
  constexpr int NCH = DMAX / 64;                 // 128-byte column chunks
  constexpr uint32_t Q_BYTES = BQ * DMAX * 2;
  constexpr uint32_t KV_BYTES = BK * DMAX * 2;   // one of K or V, one stage
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  auto sk = [&](int s) { return base + Q_BYTES + s * 2 * KV_BYTES; };
  auto sv = [&](int s) { return sk(s) + KV_BYTES; };
  const uint32_t bars = base + Q_BYTES + STAGES * 2 * KV_BYTES;
  const uint32_t full_q = bars;
  auto full_k = [&](int s) { return bars + 8 * (1 + s); };
  auto full_v = [&](int s) { return bars + 8 * (1 + STAGES + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * STAGES + s); };

  const int bh = blockIdx.x;
  // the heaviest q tiles (most kv tiles under the causal mask) go first
  const int q_start = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int nk = (Sk + BK - 1) / BK;
  int n_hi = nk, n_lo = 0;
  if (causal) n_hi = min(nk, (q_start + BQ - 1) / BK + 1);
  if (window >= 0) {
    const int num = q_start - window - BK + 1;   // tile t skipped: t BK <= num
    if (num >= 0) n_lo = num / BK + 1;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), 8);                    // one arrive per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the role by warpgroup, read through a shuffle so that the compiler
  // sees it is uniform over each warp (else it cannot give each branch its
  // own register budget, and setmaxnreg is ignored)
  const int warpgroup = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (warpgroup == 2) {                          // producer warpgroup
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(full_q, Q_BYTES);
      for (int c = 0; c < NCH; ++c)
        tma_load_3d(sq + c * BQ * 128, &tq, full_q, c * 64, q_start, bh);
      for (int j = n_lo; j < n_hi; ++j) {
        const int jj = j - n_lo, s = jj % STAGES;
        if (jj >= STAGES) mbar_wait(empty(s), ((jj / STAGES) - 1) & 1);
        mbar_expect_tx(full_k(s), KV_BYTES);
        for (int c = 0; c < NCH; ++c)
          tma_load_3d(sk(s) + c * BK * 128, &tk, full_k(s), c * 64, j * BK,
                      bh);
        mbar_expect_tx(full_v(s), KV_BYTES);
        for (int c = 0; c < NCH; ++c)
          tma_load_3d(sv(s) + c * BK * 128, &tv, full_v(s), c * 64, j * BK,
                      bh);
      }
    }
  } else {
    // consumers: warpgroup wg owns q rows q_start + 64 wg .. + 63; this
    // thread owns rows r0 and r0 + 8
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = warpgroup;
    const int row_lo = q_start + wg * 64;
    const int r0 = row_lo + (warp % 4) * 16 + lane / 4;
    float acc[DMAX / 2];
#pragma unroll
    for (int i = 0; i < DMAX / 2; ++i) acc[i] = 0.0f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};

    mbar_wait(full_q, 0);
    for (int j = n_lo; j < n_hi; ++j) {
      const int jj = j - n_lo, s = jj % STAGES;
      const uint32_t parity = (jj / STAGES) & 1;
      mbar_wait(full_k(s), parity);

      float sc[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DMAX / 16; ++kk) {
        const uint32_t koff = (kk % 4) * 32;   // 16 columns = 32 bytes
        const uint64_t da = desc_sw128(
            sq + (kk / 4) * BQ * 128 + wg * 64 * 128 + koff, 16, 1024);
        const uint64_t db =
            desc_sw128(sk(s) + (kk / 4) * BK * 128 + koff, 16, 1024);
        wgmma_ss<BK>(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // scale into the log2 domain and mask where the tile can hold a key
      // past Sk, past the diagonal or left of the band for one of the rows
      const int k_start = j * BK;
      const bool need_mask = k_start + BK > Sk ||
                             (causal && k_start + BK - 1 > row_lo) ||
                             (window >= 0 && k_start <= row_lo + 63 - window);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int h = (i / 2) % 2;
        float x = sc[i] * scale_log2;
        if (need_mask) {
          const int qpos = r0 + 8 * h;
          const int kpos = k_start + (i / 4) * 8 + (lane % 4) * 2 + (i % 2);
          const bool ok = kpos < Sk && (!causal || kpos <= qpos) &&
                          (window < 0 || kpos > qpos - window);
          x = ok ? x : NEG_INF;
        }
        sc[i] = x;
        mx[h] = fmaxf(mx[h], x);
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        alpha[h] = exp2f(m[h] - m_new);
        m[h] = m_new;
      }
      // P = hi + lo, two bf16 operands (see the note at the top)
      float sum[2] = {0.0f, 0.0f};
      uint32_t p_hi[BK / 4], p_lo[BK / 4];
#pragma unroll
      for (int i = 0; i < BK / 2; i += 2) {
        const int h = (i / 2) % 2;
        const float p0 = exp2f(sc[i] - m[h]);
        const float p1 = exp2f(sc[i + 1] - m[h]);
        sum[h] += p0 + p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        p_hi[i / 2] = bits(hi);
        p_lo[i / 2] = pack_bf16(p0 - __low2float(hi), p1 - __high2float(hi));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
#pragma unroll
      for (int i = 0; i < DMAX / 2; ++i) acc[i] *= alpha[(i / 2) % 2];

      mbar_wait(full_v(s), parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // V [BK, DMAX]: 16 kv rows of 128 bytes per step; the 64-column
        // chunks lie BK * 128 bytes apart, the 8-row groups 1024
        const uint64_t db =
            desc_sw128(sv(s) + kk * 16 * 128, BK * 128, 1024);
        wgmma_rs_tb<DMAX>(acc, &p_hi[4 * kk], db, 1);
        wgmma_rs_tb<DMAX>(acc, &p_lo[4 * kk], db, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty(s));
    }

    // the flush: the row's denominator summed over its quad, clamped
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      l[h] = fmaxf(l[h], 1e-30f);
    }
    __nv_bfloat16* oh = o + (long)bh * Sq * d;
#pragma unroll
    for (int i = 0; i < DMAX / 2; i += 2) {
      const int h = (i / 2) % 2;
      const int row = r0 + 8 * h;
      const int col = (i / 4) * 8 + (lane % 4) * 2;
      if (row < Sq && col < d) {
        __nv_bfloat162 v = __floats2bfloat162_rn(acc[i] / l[h],
                                                 acc[i + 1] / l[h]);
        *reinterpret_cast<__nv_bfloat162*>(oh + (long)row * d + col) = v;
      }
    }
  }
}

template <int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Sq, int Sk, int d, int causal, int window, float scale,
           cudaStream_t s) {
  constexpr int bytes = smem_bytes<DMAX>();
  // [B H, S, d] in boxes of 64 columns x the tile's rows
  CUtensorMap tq, tk, tv;
  int err = encode_bf16_3d(&tq, q, d, Sq, B * H, 64, BQ);
  if (!err) err = encode_bf16_3d(&tk, k, d, Sk, B * H, 64, kv_rows<DMAX>());
  if (!err) err = encode_bf16_3d(&tv, v, d, Sk, B * H, 64, kv_rows<DMAX>());
  if (err) return err;
  auto kernel = flash_fwd_sm90<DMAX>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, bytes, s>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Sq, Sk, d, causal, window,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o bf16 [B, H, S, d], contiguous, 16-byte aligned; d a multiple
// of 8 and at most 256 (the wrapper refuses anything else); window < 0: no
// window.  Returns a cudaError_t, or 1000 + CUresult when a tensor map
// could not be encoded.
extern "C" int launch_flash_attention_sm90(const void* q, const void* k,
                                           const void* v, void* o, int B,
                                           int H, int Sq, int Sk, int d,
                                           int causal, int window,
                                           float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return launch<64>(q, k, v, o, B, H, Sq, Sk, d, causal, window, scale, s);
  if (d <= 128)
    return launch<128>(q, k, v, o, B, H, Sq, Sk, d, causal, window, scale, s);
  return launch<256>(q, k, v, o, B, H, Sq, Sk, d, causal, window, scale, s);
}
