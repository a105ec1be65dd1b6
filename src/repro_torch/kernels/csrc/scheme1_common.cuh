// Scheme-I pieces shared by EmuGEMM-I's kernels (emugemm1_planes.cu,
// emugemm1_batched.cu) and the decomposition (decompose.cu): operand and
// output types, exact powers of two, the carve of eight scaled elements
// into packed int8 slices, and the shift-reduce epilogue's steps.
//
// An operand is float32, bf16 (widened exactly to float32 on load) or
// float64; float32 and bf16 carve in float32 with float32 scales, float64
// in float64 with float64 scales, as repro_torch.core.scheme1.widen and
// pow2_scale have it (a float16 operand is widened to float32 by the
// caller). An output is float32, bf16, float16 or float64.
//
// Numerics, so that every kernel is bit-identical to its plain version
// (repro_torch.kernels.ozaki1):
//   * exact powers of two come from the exponent field, never exp2f; the
//     reciprocal of the largest scale is subnormal (2^-127 in float32,
//     2^-1023 in float64), and nvcc runs without -ftz;
//   * every float op is an explicit _rn intrinsic, so nvcc cannot contract
//     the carve or the fold into an FMA;
//   * int32 -> bf16 or float16 rounds through fp32 (RNE twice), as torch
//     does, and a bf16 or float16 output rounds after every op, as the
//     reference shift_reduce does, its weight and scales rounded to the
//     output type first (a float16 weight 2^(-beta (s + 2)) is subnormal
//     at s = 1 and zero from s = 2 at beta = 7, as the reference's is).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace scheme1 {

// Operand and output types of the entry points (kernels/ozaki1.py TYPE_CODE).
enum { F32 = 0, BF16 = 1, F64 = 2, F16 = 3 };
constexpr int MAXP = 16;

// The type an operand is carved in, and its scales' type.
template <typename T>
struct Work {
  using type = float;
};
template <>
struct Work<double> {
  using type = double;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ double widen(double x) { return x; }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float round_f16(float x) { return __half2float(__float2half_rn(x)); }

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// Exact 2^e for a normal exponent e, built from the exponent field.
__device__ __forceinline__ float pow2(int e) { return __int_as_float((127 + e) << 23); }
__device__ __forceinline__ double pow2d(int e) {
  return __longlong_as_double(static_cast<long long>(1023 + e) << 52);
}
template <typename F>
__device__ __forceinline__ F pow2_of(int e) {
  if constexpr (sizeof(F) == 8) return pow2d(e);
  else return pow2(e);
}

// 1 / s for a power of two s = 2^(E - 127) (biased exponent E in 1..254)
// or +inf, exact: 2^(127 - E), normal for E <= 253 and the subnormal 2^-127
// for E = 254; 1 / inf = 0.
__device__ __forceinline__ float recip_pow2(float s) {
  const int e = (__float_as_int(s) >> 23) & 0xff;
  if (e == 255) return 0.f;
  if (e == 254) return __int_as_float(1 << 22);
  return __int_as_float((254 - e) << 23);
}

// The same in float64 (biased exponent E in 1..2046, or +inf): the
// subnormal 2^-1023 for E = 2046.
__device__ __forceinline__ double recip_pow2(double s) {
  const int e = static_cast<int>((__double_as_longlong(s) >> 52) & 0x7ff);
  if (e == 2047) return 0.0;
  if (e == 2046) return __longlong_as_double(1LL << 51);
  return __longlong_as_double(static_cast<long long>(2046 - e) << 52);
}

// The p slices of eight scaled elements r (|r| < 1), by the
// truncate-subtract recurrence of repro.kernels.common.carve_slices:
// slice i of element j is byte j of the 8-byte word put(i, word). A slice
// t is an integer-valued float with |t| < 2^7, so t + 1.5 * 2^23 is exact
// and its low byte is t's two's-complement byte: one full-rate add instead
// of a float-to-int conversion (16 results a clock an SM).
template <typename Put>
__device__ __forceinline__ void carve8(float (&r)[8], float two_beta, int p, Put put) {
  constexpr float MAGIC = 12582912.f;   // 1.5 * 2^23
#pragma unroll
  for (int i = 0; i < MAXP; ++i) {
    if (i >= p) break;
    uint32_t w[2] = {0, 0};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float sh = __fmul_rn(r[j], two_beta);
      const float t = truncf(sh);
      w[j / 4] |= (__float_as_uint(__fadd_rn(t, MAGIC)) & 0xff) << (8 * (j % 4));
      r[j] = __fsub_rn(sh, t);
    }
    put(i, make_uint2(w[0], w[1]));
  }
}

// The same in float64: t + 1.5 * 2^52 is exact and its low byte is t's.
template <typename Put>
__device__ __forceinline__ void carve8(double (&r)[8], double two_beta, int p, Put put) {
  constexpr double MAGIC = 6755399441055744.0;   // 1.5 * 2^52
#pragma unroll
  for (int i = 0; i < MAXP; ++i) {
    if (i >= p) break;
    uint32_t w[2] = {0, 0};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const double sh = __dmul_rn(r[j], two_beta);
      const double t = trunc(sh);
      w[j / 4] |= (static_cast<uint32_t>(__double_as_longlong(__dadd_rn(t, MAGIC))) & 0xff)
                  << (8 * (j % 4));
      r[j] = __dsub_rn(sh, t);
    }
    put(i, make_uint2(w[0], w[1]));
  }
}

// A float32 or float64 scale in float32, as torch's .to(float32) rounds it
// (a float32 one as it is).
__device__ __forceinline__ float narrow(float x) { return x; }
__device__ __forceinline__ float narrow(double x) { return __double2float_rn(x); }

// The shift-reduce's steps in the output type: c + w C_s (w = 2^(-beta
// (s + 2)), highest weight first), then c mu nu (mu and nu, of type S,
// in the output type), then the store. Acc is the running sum's type.
template <typename O>
struct Epilogue;

template <>
struct Epilogue<float> {
  using Acc = float;
  static __device__ __forceinline__ float step(float c, int acc, float w) {
    return __fadd_rn(c, __fmul_rn(w, __int2float_rn(acc)));
  }
  template <typename S>
  static __device__ __forceinline__ float scale(float c, S mu, S nu) {
    return __fmul_rn(__fmul_rn(c, narrow(mu)), narrow(nu));
  }
  static __device__ __forceinline__ void store(float* o, float c) { *o = c; }
  static __device__ __forceinline__ void store2(float* o, float c0, float c1) {
    *reinterpret_cast<float2*>(o) = make_float2(c0, c1);
  }
};

template <>
struct Epilogue<__nv_bfloat16> {
  using Acc = float;
  static __device__ __forceinline__ float step(float c, int acc, float w) {
    const float cv = round_bf16(__int2float_rn(acc));
    return round_bf16(__fadd_rn(c, round_bf16(__fmul_rn(w, cv))));
  }
  // A float32 scale of a float32 or bf16 operand is a normal power of two,
  // exact in bf16, so the first rounding changes only a narrowed float64
  // scale below bf16's range.
  template <typename S>
  static __device__ __forceinline__ float scale(float c, S mu, S nu) {
    return round_bf16(
        __fmul_rn(round_bf16(__fmul_rn(c, round_bf16(narrow(mu)))), round_bf16(narrow(nu))));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* o, float c) {
    *o = __float2bfloat16_rn(c);
  }
  static __device__ __forceinline__ void store2(__nv_bfloat16* o, float c0, float c1) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(c0, c1);
  }
};

// float16: the weight, each partial product and sum, and the scales are
// rounded to float16 (so |C_s| >= 65520, or a scale >= 2^16, is inf, as in
// the reference's float16 shift-reduce).
template <>
struct Epilogue<__half> {
  using Acc = float;
  static __device__ __forceinline__ float step(float c, int acc, float w) {
    const float cv = round_f16(__int2float_rn(acc));
    return round_f16(__fadd_rn(c, round_f16(__fmul_rn(round_f16(w), cv))));
  }
  template <typename S>
  static __device__ __forceinline__ float scale(float c, S mu, S nu) {
    return round_f16(
        __fmul_rn(round_f16(__fmul_rn(c, round_f16(narrow(mu)))), round_f16(narrow(nu))));
  }
  static __device__ __forceinline__ void store(__half* o, float c) { *o = __float2half_rn(c); }
  static __device__ __forceinline__ void store2(__half* o, float c0, float c1) {
    *reinterpret_cast<__half2*>(o) = __floats2half2_rn(c0, c1);
  }
};

template <>
struct Epilogue<double> {
  using Acc = double;
  static __device__ __forceinline__ double step(double c, int acc, double w) {
    return __dadd_rn(c, __dmul_rn(w, __int2double_rn(acc)));
  }
  template <typename S>
  static __device__ __forceinline__ double scale(double c, S mu, S nu) {
    return __dmul_rn(__dmul_rn(c, static_cast<double>(mu)), static_cast<double>(nu));
  }
  static __device__ __forceinline__ void store(double* o, double c) { *o = c; }
  static __device__ __forceinline__ void store2(double* o, double c0, double c1) {
    *reinterpret_cast<double2*>(o) = make_double2(c0, c1);
  }
};

}  // namespace scheme1
