// Scheme-I pieces shared by EmuGEMM-I's kernels (emugemm1_planes.cu,
// emugemm1_batched.cu) and the decomposition (decompose.cu): operand and
// output types, exact powers of two, the carve of eight scaled elements
// into packed int8 slices, and the shift-reduce epilogue's steps.
//
// Numerics, so that every kernel is bit-identical to its plain version
// (repro_torch.kernels.ozaki1):
//   * exact powers of two come from the exponent field, never exp2f;
//   * every float op is an explicit _rn intrinsic, so nvcc cannot contract
//     the carve or the fold into an FMA;
//   * int32 -> bf16 rounds through fp32 (RNE twice), as torch does, and a
//     bf16 output rounds after every op, as the reference shift_reduce does.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace scheme1 {

// Operand and output types of the entry points (kernels/ozaki1.py TYPE_CODE).
enum { F32 = 0, BF16 = 1 };
constexpr int MAXP = 8;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Exact 2^e for a normal exponent e, built from the exponent field.
__device__ __forceinline__ float pow2(int e) { return __int_as_float((127 + e) << 23); }

// 1 / s for a power of two s = 2^(E - 127) (biased exponent E in 1..254)
// or +inf, exact: 2^(127 - E), normal for E <= 253 and the subnormal 2^-127
// for E = 254; 1 / inf = 0.
__device__ __forceinline__ float recip_pow2(float s) {
  const int e = (__float_as_int(s) >> 23) & 0xff;
  if (e == 255) return 0.f;
  if (e == 254) return __int_as_float(1 << 22);
  return __int_as_float((254 - e) << 23);
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

// The shift-reduce's steps in the output type: c + w C_s (w = 2^(-beta
// (s + 2)), highest weight first), then c mu nu, then the store.
template <typename O>
struct Epilogue;

template <>
struct Epilogue<float> {
  static __device__ __forceinline__ float step(float c, int acc, float w) {
    return __fadd_rn(c, __fmul_rn(w, __int2float_rn(acc)));
  }
  static __device__ __forceinline__ float scale(float c, float mu, float nu) {
    return __fmul_rn(__fmul_rn(c, mu), nu);
  }
  static __device__ __forceinline__ void store(float* o, float c) { *o = c; }
  static __device__ __forceinline__ void store2(float* o, float c0, float c1) {
    *reinterpret_cast<float2*>(o) = make_float2(c0, c1);
  }
};

template <>
struct Epilogue<__nv_bfloat16> {
  static __device__ __forceinline__ float step(float c, int acc, float w) {
    const float cv = round_bf16(__int2float_rn(acc));
    return round_bf16(__fadd_rn(c, round_bf16(__fmul_rn(w, cv))));
  }
  static __device__ __forceinline__ float scale(float c, float mu, float nu) {
    return round_bf16(__fmul_rn(round_bf16(__fmul_rn(c, mu)), nu));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* o, float c) {
    *o = __float2bfloat16_rn(c);
  }
  static __device__ __forceinline__ void store2(__nv_bfloat16* o, float c0, float c1) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(c0, c1);
  }
};

}  // namespace scheme1
