// Device pieces of Ozaki Scheme II for its plane route (emugemm2_planes.cu:
// the encode and the plane GEMM of every Scheme-II product of float
// operands, real or complex 3M, and the residue forms K5 and K7): operand
// types, integerization and the double-double CRT arithmetic.
//
// Numerics, so that every kernel is bit-identical to its plain version
// (repro_torch.core.scheme2, repro_torch.core.complex3m):
//   * floor modulo everywhere (the sign of the divisor, as jnp.remainder),
//     by Barrett's integer quotient (emugemm2_planes.cu): every exact
//     reduction gives the same residue;
//   * every float op of the double-double is an explicit _rn intrinsic,
//     so nvcc cannot contract ah * bh - p into an FMA, which would break
//     Dekker's exact product; the Veltkamp constant is 2^12 + 1 in float32
//     and 2^27 + 1 in float64 (repro.core.dd: 2^((nmant + 2) // 2) + 1);
//   * a float64 output reconstructs in float64 double-double, any other in
//     float32 (ROADMAP.md § 3 H6); residues, digits and products are int32;
//   * a bf16 output rounds every op to bf16, as the plain torch ops do.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace s2 {

constexpr int NT = 256;         // threads of an encode or relayout block
constexpr int MAXP = 16;

// The moduli and Garner's inverse table inv[i][j] = m_j^-1 mod m_i (j < i),
// passed by value.
struct Crt {
  int p;
  int m[MAXP];
  int inv[MAXP][MAXP];
};

inline int make_crt(int p, const int* moduli, const int* inv, Crt& crt) {
  if (p < 1 || p > MAXP) return -1;
  crt.p = p;
  for (int i = 0; i < MAXP; ++i) {
    crt.m[i] = i < p ? moduli[i] : 1;
    for (int j = 0; j < MAXP; ++j) crt.inv[i][j] = i < p && j < p && inv ? inv[i * p + j] : 0;
    if (i < p && (crt.m[i] < 2 || crt.m[i] > 256)) return -1;
  }
  return 0;
}

// ---- operand types ---------------------------------------------------------
// W: the type an operand is widened to (exactly); S: the type its
// integerized values are staged in.
template <typename T>
struct Num;
template <>
struct Num<float> {
  using W = float;
  using S = int;
};
template <>
struct Num<__nv_bfloat16> {
  using W = float;
  using S = int;
};
template <>
struct Num<double> {
  using W = double;
  using S = double;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ double widen(double x) { return x; }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// trunc(x * mu) in the operand's type T (x, mu already widened): a bf16
// product rounds to bf16 before the truncation.
__device__ __forceinline__ int integerize(float x, float mu, float) {
  return static_cast<int>(truncf(__fmul_rn(x, mu)));
}
__device__ __forceinline__ int integerize(float x, float mu, __nv_bfloat16) {
  return static_cast<int>(truncf(round_bf16(__fmul_rn(x, mu))));
}
__device__ __forceinline__ double integerize(double x, double mu, double) {
  return trunc(__dmul_rn(x, mu));
}

// ---- double-double (repro.core.dd), no FMA ---------------------------------

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float veltkamp_c(float) { return 4097.0f; }
__device__ __forceinline__ double veltkamp_c(double) { return 134217729.0; }

template <typename D>
__device__ __forceinline__ void two_sum(D a, D b, D& s, D& e) {
  s = add_rn(a, b);
  const D bb = sub_rn(s, a);
  e = add_rn(sub_rn(a, sub_rn(s, bb)), sub_rn(b, bb));
}

template <typename D>
__device__ __forceinline__ void quick_two_sum(D a, D b, D& s, D& e) {
  s = add_rn(a, b);
  e = sub_rn(b, sub_rn(s, a));
}

template <typename D>
__device__ __forceinline__ void veltkamp(D a, D& hi, D& lo) {
  const D c = mul_rn(veltkamp_c(a), a);
  hi = sub_rn(c, sub_rn(c, a));
  lo = sub_rn(a, hi);
}

template <typename D>
__device__ __forceinline__ void two_prod(D a, D b, D& p, D& e) {
  p = mul_rn(a, b);
  D ah, al, bh, bl;
  veltkamp(a, ah, al);
  veltkamp(b, bh, bl);
  e = add_rn(add_rn(add_rn(sub_rn(mul_rn(ah, bh), p), mul_rn(ah, bl)), mul_rn(al, bh)),
             mul_rn(al, bl));
}

template <typename D>
__device__ __forceinline__ void mul_scalar(D& hi, D& lo, D c) {
  D p1, p2;
  two_prod(hi, c, p1, p2);
  p2 = add_rn(p2, mul_rn(lo, c));
  quick_two_sum(p1, p2, hi, lo);
}

template <typename D>
__device__ __forceinline__ void add_scalar(D& hi, D& lo, D x) {
  D s, e;
  two_sum(hi, x, s, e);
  e = add_rn(e, lo);
  quick_two_sum(s, e, hi, lo);
}

// ---- the output type -------------------------------------------------------
// V: the arithmetic type of the epilogue; every op is rounded to O. D: the
// double-double's base type.

template <typename O>
struct Out;

template <>
struct Out<float> {
  using V = float;
  using D = float;
  static __device__ __forceinline__ float cvt(float x) { return x; }
  static __device__ __forceinline__ float cvt(double x) { return __double2float_rn(x); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ void store(float* o, float c) { *o = c; }
};

template <>
struct Out<__nv_bfloat16> {
  using V = float;
  using D = float;
  static __device__ __forceinline__ float cvt(float x) { return round_bf16(x); }
  static __device__ __forceinline__ float mul(float a, float b) { return round_bf16(__fmul_rn(a, b)); }
  static __device__ __forceinline__ float div(float a, float b) { return round_bf16(__fdiv_rn(a, b)); }
  static __device__ __forceinline__ float add(float a, float b) { return round_bf16(__fadd_rn(a, b)); }
  static __device__ __forceinline__ void store(__nv_bfloat16* o, float c) {
    *o = __float2bfloat16_rn(c);
  }
};

template <>
struct Out<double> {
  using V = double;
  using D = double;
  static __device__ __forceinline__ double cvt(float x) { return static_cast<double>(x); }
  static __device__ __forceinline__ double cvt(double x) { return x; }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ void store(double* o, double c) { *o = c; }
};

// ---- the CRT ---------------------------------------------------------------

// The mixed-radix polynomial of W elements' balanced digits by
// double-double Horner, hi and lo rounded to O and added in it.
template <typename O, int W>
__device__ __forceinline__ void horner(const Crt& crt, const int (&d)[W][MAXP],
                                       typename Out<O>::V (&c)[W]) {
  using D = typename Out<O>::D;
  const int p = crt.p;
  D hi[W], lo[W];
#pragma unroll
  for (int w = 0; w < W; ++w) hi[w] = lo[w] = 0;
#pragma unroll
  for (int i = MAXP - 1; i >= 0; --i) {
    if (i < p) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        if (i == p - 1) {
          hi[w] = static_cast<D>(d[w][i]);
          lo[w] = 0;
        } else {
          mul_scalar(hi[w], lo[w], static_cast<D>(crt.m[i]));
          add_scalar(hi[w], lo[w], static_cast<D>(d[w][i]));
        }
      }
    }
  }
#pragma unroll
  for (int w = 0; w < W; ++w) c[w] = Out<O>::add(Out<O>::cvt(hi[w]), Out<O>::cvt(lo[w]));
}

}  // namespace s2
