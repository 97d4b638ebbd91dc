// hetIR device runtime for the CUDA segment translator (sm_90a).
//
// The translator in repro_torch/core/backends/cuda_backend.py emits one
// kernel per barrier-free hetIR segment; every op it emits goes through the
// helpers below, so the rounding and ordering contract of the reference
// interpreter (NumPy scalars on x86) lives in this one file:
//
//  * one IEEE rounding per float op: __fadd_rn/__fsub_rn/__fmul_rn/__fdiv_rn/
//    __fsqrt_rn, which the compiler never contracts into a fused multiply-add
//    (the module is also built with -fmad=false);
//  * EXP is a software exponential built from those intrinsics only, op for
//    op the sequence of portable_math._exp_core;
//  * integer arithmetic wraps (done in unsigned), DIV/MOD are floor division
//    and modulo with a zero divisor giving 0, shifts by a count outside
//    [0, 32) give 0 (or the sign fill for a right shift of a negative i32);
//  * MIN/MAX propagate NaN like np.minimum/np.maximum: on a tie or a NaN in
//    the second operand the second operand wins, a NaN first operand wins;
//  * float -> integer casts give what NumPy gives on x86, not the saturating
//    conversion of the hardware;
//  * subnormals are kept (the module is built with -ftz=false).
#pragma once

#include <cuda_runtime.h>

// The slot counts come from the translator (cuda_backend.MAX_PTRS, ...),
// which defines them ahead of this header in every generated module.
#if !defined(HET_MAX_PTRS) || !defined(HET_MAX_BUFS) || !defined(HET_MAX_SCALARS)
#error "define HET_MAX_PTRS, HET_MAX_BUFS and HET_MAX_SCALARS before hetir_rt.cuh"
#endif

// Kernel arguments, passed by value (under the 4 KB parameter limit; the
// generated module asserts the size against the ctypes mirror).  Slot numbers are fixed per segment by the translator: global
// buffers (whose lengths share their slot numbers), the shared-memory rows,
// register inputs (null when the register is not live yet), register
// outputs.  Scalars travel as raw 32-bit patterns.
struct HetArgs {
  void* ptr[HET_MAX_PTRS];
  long long len[HET_MAX_BUFS];
  unsigned int sc[HET_MAX_SCALARS];
  int num_blocks;
  int block_size;
};

// ---- 32-bit patterns (scratch slots and scalar arguments) -----------------
__device__ __forceinline__ unsigned het_bits(float x) { return __float_as_uint(x); }
__device__ __forceinline__ unsigned het_bits(int x) { return (unsigned)x; }
__device__ __forceinline__ unsigned het_bits(unsigned x) { return x; }
__device__ __forceinline__ unsigned het_bits(bool x) { return x ? 1u : 0u; }
__device__ __forceinline__ float het_f32(unsigned u) { return __uint_as_float(u); }
__device__ __forceinline__ int het_i32(unsigned u) { return (int)u; }
__device__ __forceinline__ unsigned het_u32(unsigned u) { return u; }
__device__ __forceinline__ bool het_bool(unsigned u) { return u != 0u; }

// ---- casts: NumPy's conversions ---------------------------------------------
__device__ __forceinline__ int het_cvt_f32_i32(float x) {
  // x86 cvttss2si: NaN and out-of-range values give INT_MIN
  if (isnan(x) || x >= 2147483648.0f || x < -2147483648.0f) return (int)0x80000000u;
  return (int)x;
}
__device__ __forceinline__ unsigned het_cvt_f32_u32(float x) {
  // NumPy converts through int64 and keeps the low 32 bits; an int64
  // overflow (or NaN) gives INT64_MIN, whose low bits are 0
  if (isnan(x) || fabsf(x) >= 9223372036854775808.0f) return 0u;
  return (unsigned)(unsigned long long)(long long)x;
}
__device__ __forceinline__ bool het_cvt_f32_bool(float x) { return x != 0.0f; }
__device__ __forceinline__ float het_cvt_i32_f32(int x) { return __int2float_rn(x); }
__device__ __forceinline__ unsigned het_cvt_i32_u32(int x) { return (unsigned)x; }
__device__ __forceinline__ bool het_cvt_i32_bool(int x) { return x != 0; }
__device__ __forceinline__ float het_cvt_u32_f32(unsigned x) { return __uint2float_rn(x); }
__device__ __forceinline__ int het_cvt_u32_i32(unsigned x) { return (int)x; }
__device__ __forceinline__ bool het_cvt_u32_bool(unsigned x) { return x != 0u; }
__device__ __forceinline__ float het_cvt_bool_f32(bool x) { return x ? 1.0f : 0.0f; }
__device__ __forceinline__ int het_cvt_bool_i32(bool x) { return x ? 1 : 0; }
__device__ __forceinline__ unsigned het_cvt_bool_u32(bool x) { return x ? 1u : 0u; }

// truth value of a register (a @PRED condition, a vote operand)
__device__ __forceinline__ bool het_truth(float x) { return x != 0.0f; }
__device__ __forceinline__ bool het_truth(int x) { return x != 0; }
__device__ __forceinline__ bool het_truth(unsigned x) { return x != 0u; }
__device__ __forceinline__ bool het_truth(bool x) { return x; }

// memory index of a register (a float index truncates, as int() does)
__device__ __forceinline__ long long het_idx(int x) { return (long long)x; }
__device__ __forceinline__ long long het_idx(unsigned x) { return (long long)x; }
__device__ __forceinline__ long long het_idx(float x) { return (long long)het_cvt_f32_i32(x); }
__device__ __forceinline__ long long het_idx(bool x) { return x ? 1 : 0; }

// ---- integer arithmetic -----------------------------------------------------
__device__ __forceinline__ int het_add_i32(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ int het_sub_i32(int a, int b) { return (int)((unsigned)a - (unsigned)b); }
__device__ __forceinline__ int het_mul_i32(int a, int b) { return (int)((unsigned)a * (unsigned)b); }
__device__ __forceinline__ int het_neg_i32(int a) { return (int)(0u - (unsigned)a); }
__device__ __forceinline__ int het_abs_i32(int a) { return a < 0 ? het_neg_i32(a) : a; }
__device__ __forceinline__ int het_div_i32(int a, int b) {
  if (b == 0) return 0;
  if (b == -1) return het_neg_i32(a);  // INT_MIN / -1 wraps to INT_MIN
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
  return q;
}
__device__ __forceinline__ int het_mod_i32(int a, int b) {
  if (b == 0 || b == -1) return 0;
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}
__device__ __forceinline__ unsigned het_div_u32(unsigned a, unsigned b) { return b ? a / b : 0u; }
__device__ __forceinline__ unsigned het_mod_u32(unsigned a, unsigned b) { return b ? a % b : 0u; }
__device__ __forceinline__ int het_shl_i32(int a, int c) {
  return (c < 0 || c >= 32) ? 0 : (int)((unsigned)a << c);
}
__device__ __forceinline__ int het_shr_i32(int a, int c) {
  return (c < 0 || c >= 32) ? (a < 0 ? -1 : 0) : (a >> c);
}
__device__ __forceinline__ unsigned het_shl_u32(unsigned a, unsigned c) { return c >= 32u ? 0u : a << c; }
__device__ __forceinline__ unsigned het_shr_u32(unsigned a, unsigned c) { return c >= 32u ? 0u : a >> c; }
__device__ __forceinline__ int het_min_i32(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int het_max_i32(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ unsigned het_min_u32(unsigned a, unsigned b) { return a < b ? a : b; }
__device__ __forceinline__ unsigned het_max_u32(unsigned a, unsigned b) { return a > b ? a : b; }

// ---- float arithmetic -------------------------------------------------------
__device__ __forceinline__ float het_min_f32(float a, float b) { return (a < b || isnan(a)) ? a : b; }
__device__ __forceinline__ float het_max_f32(float a, float b) { return (a > b || isnan(a)) ? a : b; }
__device__ __forceinline__ float het_mod_f32(float a, float b) {
  // NumPy's npy_divmodf modulus: fmod, moved to the divisor's sign
  float m = fmodf(a, b);
  if (b == 0.0f) return m;
  if (m != 0.0f) {
    if ((b < 0.0f) != (m < 0.0f)) m = __fadd_rn(m, b);
  } else {
    m = copysignf(0.0f, b);
  }
  return m;
}

// 2^e for e in the normal exponent range, built from its bits
__device__ __forceinline__ float het_pow2(int e) { return __int_as_float((e + 127) << 23); }

// The portable exponential (portable_math._exp_core): Cody-Waite range
// reduction, the Cephes minimax polynomial by Horner with one rounding per
// op, and an exact two-step 2^k scale.  Subnormal results flush to zero.
__device__ __forceinline__ float het_exp_f32(float x) {
  float xs = isnan(x) ? 0.0f : x;
  xs = het_min_f32(het_max_f32(xs, -104.0f), 89.0f);
  const float k = rintf(__fmul_rn(xs, __uint_as_float(0x3fb8aa3bu)));  // log2(e)
  float r = __fsub_rn(xs, __fmul_rn(k, __uint_as_float(0x3f318000u)));  // ln2 hi
  r = __fsub_rn(r, __fmul_rn(k, __uint_as_float(0xb95e8083u)));          // ln2 lo
  float p = __uint_as_float(0x39506967u);
  p = __fadd_rn(__fmul_rn(p, r), __uint_as_float(0x3ab743ceu));
  p = __fadd_rn(__fmul_rn(p, r), __uint_as_float(0x3c088908u));
  p = __fadd_rn(__fmul_rn(p, r), __uint_as_float(0x3d2aa9c1u));
  p = __fadd_rn(__fmul_rn(p, r), __uint_as_float(0x3e2aaaaau));
  p = __fadd_rn(__fmul_rn(p, r), __uint_as_float(0x3f000000u));
  const float rr = __fmul_rn(r, r);
  float y = __fadd_rn(__fadd_rn(__fmul_rn(rr, p), r), 1.0f);
  const int ki = (int)k;
  const int k1 = ki >> 1;
  y = __fmul_rn(__fmul_rn(y, het_pow2(k1)), het_pow2(ki - k1));
  if (y < __uint_as_float(0x00800000u)) y = 0.0f;             // FLT_MIN
  if (x > __uint_as_float(0x42b17217u)) y = __int_as_float(0x7f800000);  // +inf
  if (x < __uint_as_float(0xc2cff1b5u)) y = 0.0f;
  if (isnan(x)) y = x;
  return y;
}

// ---- memory: Python indexing (negative counts from the end); an index out
// of range loads 0 and drops the store ---------------------------------------
template <typename T>
__device__ __forceinline__ T het_ld(const T* p, long long n, long long i) {
  if (i < 0) i += n;
  return (i >= 0 && i < n) ? p[i] : T(0);
}
template <typename T>
__device__ __forceinline__ void het_st(T* p, long long n, long long i, T v) {
  if (i < 0) i += n;
  if (i >= 0 && i < n) p[i] = v;
}

__device__ __forceinline__ int het_even(int n) { return (n + 1) & ~1; }
