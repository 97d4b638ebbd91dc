// Grouped expert matmul for bf16 on Hopper: wgmma products fed by TMA.
// x[E, C, D] @ w[E, D, F] -> out[E, C, F], bf16 in and out, f32
// accumulators, with counts[E]: the rows of every bc-row tile that holds a
// live row (a row below counts[e]) are computed, the others are exact
// zeros.
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_gmm/kernel.py
// (moe_gmm_fwd, pl.pallas_call at :56; body _gmm_kernel at :21) for bf16
// inputs whose rows TMA can load; f32 inputs and other bf16 shapes keep
// the CUDA-core kernel of moe_gmm.cu.  The Pallas body is a bf16 x bf16 ->
// f32 dot over contraction tiles into an f32 accumulator carried in VMEM
// between grid steps, with counts prefetched into SMEM; here the
// contraction is a loop inside one block per (expert, 128-row tile,
// 256-column tile), the accumulator in registers, and the block reads
// counts[e] itself.
//
// Bound on this card: at granite-moe's shapes (E = 40, C = 1024, D = 1536,
// F = 512) and half the rows live, the work is bound by bytes (x's live
// rows, w, the whole output) over 3.35 TB/s, with the tensor cores' bf16
// rate close behind; a CUDA-core product is 15x slower than either.
// Between them sits the L2 cache: every block streams its x rows and w
// columns through it, so the tile is as wide as the registers allow (each
// k step moves 48 KB for 4 MFLOP; a 128 x 128 tile moves 32 KB for 2).
// The design keeps the threads off the tiles:
//  * a producer warp (warp 8) whose first thread issues TMA loads of the x
//    tile [128 rows x 64 k] (K-major) and the w tile [64 k x 256 columns]
//    (four boxes of 64 columns, N-major), each 128-byte swizzled, into a
//    ring of STAGES stages with one mbarrier per stage; a stage is refilled
//    once all eight consumer warps have released it;
//  * two consumer warpgroups (warps 0-3 and 4-7) own 64 rows each and run
//    wgmma m64n256k16 from the shared tiles (w as the transposed B
//    operand) into 128 f32 registers a thread, keeping one k tile's
//    products in flight while they release the stage before it;
//  * one block per SM: 4 stages of 48 KB.
//
// The dead-tile contract is exact: live = min(C, ceil(counts[e] / bc) bc);
// a block whose first row is at or past live writes zeros and loads
// nothing; a block that straddles live computes its rows and writes zeros
// for rows >= live (whatever x holds there).  Rows past C and k past D load
// as zeros (TMA fills the box outside the tensor); a w box wholly past F is
// not loaded (its columns are never stored).  The epilogue stores only
// rows < C, columns < F.  TMA needs D and F multiples of 8 (row strides in
// multiples of 16 bytes) and 16-byte aligned tensors: the wrapper routes
// only those here.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "kernels/sm90.cuh"

namespace {

using namespace sm90;

constexpr int BM = 128, BN = 256, BK = 64;
constexpr int THREADS = 288;               // two consumer warpgroups + a warp
constexpr int STAGES = 4;
constexpr int W_BOXES = BN / 64;           // 64-column boxes of a w tile
constexpr uint32_t X_BYTES = BM * BK * 2;  // [128 rows, 64 k] bf16
constexpr uint32_t W_BOX = BK * 64 * 2;    // [64 k, 64 columns] bf16
constexpr uint32_t STAGE_BYTES = X_BYTES + W_BOXES * W_BOX;
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;

__global__ void __launch_bounds__(THREADS, 1)
moe_gmm_sm90(const __grid_constant__ CUtensorMap tx,
             const __grid_constant__ CUtensorMap tw,
             const int* __restrict__ counts, __nv_bfloat16* __restrict__ out,
             int C, int D, int F, int bc) {
  const int e = blockIdx.z;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  __nv_bfloat16* o = out + (long)e * C * F;
  const long cnt = counts[e] > 0 ? counts[e] : 0;
  const long lim = (cnt + bc - 1) / bc * bc;
  const int live = lim < C ? (int)lim : C;
  if (row0 >= live) {
    // no live row: zeros, 8 columns (16 bytes) a store (F % 8 == 0)
    for (int i = threadIdx.x; i < BM * BN / 8; i += THREADS) {
      const int r = row0 + i / (BN / 8), c = col0 + (i % (BN / 8)) * 8;
      if (r < C && c < F)
        *reinterpret_cast<uint4*>(o + (long)r * F + c) = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  auto sx = [&](int s) { return base + s * STAGE_BYTES; };
  auto sw = [&](int s) { return sx(s) + X_BYTES; };
  const uint32_t bars = base + STAGES * STAGE_BYTES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const int nk = (D + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);                // one arrive per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {                           // producer
    if (lane == 0) {
      // the w boxes that hold a column below F (the last column tile may
      // end past F)
      const int boxes = min(W_BOXES, (F - col0 + 63) / 64);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(empty(s), ((kt / STAGES) - 1) & 1);
        mbar_expect_tx(full(s), X_BYTES + boxes * W_BOX);
        tma_load_3d(sx(s), &tx, full(s), kt * BK, row0, e);
        for (int j = 0; j < boxes; ++j)
          tma_load_3d(sw(s) + j * W_BOX, &tw, full(s), col0 + 64 * j, kt * BK,
                      e);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows row0 + 64 wg .. + 63; this thread
  // holds rows r0 and r0 + 8 of its fragment
  const int wg = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(full(s), (kt / STAGES) & 1);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // x: 16 k columns = 32 bytes a step, 8-row groups 1024 bytes apart;
      // w: 16 k rows of 128 bytes a step, the 64-column boxes W_BOX bytes
      // apart, 8-row groups 1024
      const uint64_t da = desc_sw128(sx(s) + wg * 64 * 128 + kk * 32, 16, 1024);
      const uint64_t db = desc_sw128(sw(s) + kk * 16 * 128, W_BOX, 1024);
      wgmma_ss_tb<BN>(acc, da, db, 1);
    }
    wgmma_commit();
    wgmma_wait<1>();                         // tile kt - 1's products done
    fence_regs(acc);
    if (kt > 0 && lane == 0) mbar_arrive(empty((kt - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const int r0 = row0 + wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int row = r0 + 8 * ((i / 2) % 2);
    const int col = col0 + (i / 4) * 8 + (lane % 4) * 2;
    if (row < C && col < F) {
      const bool keep = row < live;
      *reinterpret_cast<__nv_bfloat162*>(o + (long)row * F + col) =
          __floats2bfloat162_rn(keep ? acc[i] : 0.0f, keep ? acc[i + 1] : 0.0f);
    }
  }
}

}  // namespace

// x [E, C, D], w [E, D, F], out [E, C, F] bf16, contiguous, 16-byte
// aligned; D and F multiples of 8 (the wrapper refuses anything else);
// counts [E] int32; 1 <= bc <= C.  Returns a cudaError_t, or 1000 +
// CUresult when a tensor map could not be encoded.
extern "C" int launch_moe_gmm_sm90(const void* x, const void* w,
                                   const void* counts, void* out, int E,
                                   int C, int D, int F, int bc,
                                   void* stream) {
  CUtensorMap tx, tw;
  int err = encode_bf16_3d(&tx, x, D, C, E, BK, BM);
  if (!err) err = encode_bf16_3d(&tw, w, F, D, E, 64, BK);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      moe_gmm_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, E);
  moe_gmm_sm90<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      tx, tw, static_cast<const int*>(counts),
      static_cast<__nv_bfloat16*>(out), C, D, F, bc);
  return static_cast<int>(cudaGetLastError());
}
