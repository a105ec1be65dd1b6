// EmuGEMM-II: the fused Ozaki Scheme-II emulated GEMM for Hopper (sm_90a).
//
// Replaces the Pallas kernels of the JAX package
//   src/repro/kernels/backends/gpu.py  fused_matmul_scheme2 (_kernel2, float rhs), 2-D launch
//   src/repro/kernels/backends/gpu.py  fused_matmul_scheme2_batched, batched launch
//   src/repro/kernels/ozaki2.py        fused_residue_matmul (_kernel), residue launch
// with one source and three launch forms: a 2-D grid over (BN, BM) output
// tiles, the same grid strided over a batch on blockIdx.z, and the residue
// form, whose grid runs over the p moduli on blockIdx.z and which takes
// int8 residues in and writes balanced int8 residues out.
//
// What one block of the fused forms computes, for its (BM, BN) output tile:
//   * prologue, once per K strip of BK: stage a (BM, BK) strip of A and a
//     (BK, BN) strip of B (fp32 or bf16, each in its own type) and
//     integerize trunc(x * mu) in the operand's type (a bf16 product rounds
//     to bf16 before the truncation) into int32 strips in shared memory;
//   * per modulus: carve the balanced int8 residues of both strips into the
//     MMA tiles, accumulate their product with int8 tensor-core MMAs (wmma
//     s8 16x16x16) into one int32 accumulator set in registers, reduce it
//     mod m (floor modulo) and add it, mod m, into that modulus's residue
//     tile, parked in shared memory as bytes;
//   * epilogue, once all strips are folded in: balanced Garner digits in
//     exact int32 (the inverse table comes from the caller), the
//     double-double Horner in float32, hi and lo rounded to the out type
//     and added in it, then divided by out(mu) * out(nu) rounded to the
//     out type; one store.
// The residue form runs the same MMA loop on int8 residue tiles loaded
// four bytes at a time where the layout allows, and writes
// ((acc + m/2) mod m) - m/2 as int8 (repro.kernels.ref.scheme2_residues).
// Rows, columns and K steps past the edge are staged as zeros: a zero
// element has zero residues, so ragged shapes need no padding copy.
// Operands are read through strides, so the transposed views of the
// batched backward (B^T, A^T) are read in place.
//
// Registers and shared memory: the moduli run INSIDE the strip loop, one
// at a time. With up to 16 moduli and a 64x64 tile, holding every
// modulus's accumulator across the K loop would take 16 int32 registers
// per thread per modulus, 256 at p = 16. Instead one accumulator set (16
// registers) is live at a time; after each strip it is reduced and folded
// into the modulus's parked residue tile, p * BM * BN bytes of dynamic
// shared memory (64 KB at p = 16). Each strip is read from device memory
// and integerized once for all p moduli; only the carve (a modulo per
// element and modulus) repeats, from shared memory.
//
// Numerics, so that the result is bit-identical to the plain version
// (repro_torch.kernels.ozaki2.fused_matmul_scheme2_plain):
//   * floor modulo everywhere (the sign of the divisor, as jnp.remainder);
//     C's % truncates toward zero, so a negative remainder gets m added.
//     Values below 2^24 in magnitude (integerized operands, one strip's
//     accumulator, Garner terms) take the quotient from a float reciprocal
//     and correct it by one; the residue form's accumulators, over all of
//     K, use %. Both give the exact floor modulo;
//   * every float op of the double-double is an explicit _rn intrinsic, so
//     nvcc cannot contract ah * bh - p into an FMA, which would break
//     Dekker's exact product; the Veltkamp constant is 2^12 + 1 (float32);
//   * residues, digits and products are int32; |(t - d_j) * inv| < 2^17;
//   * a bf16 output rounds hi, lo, their sum, mu * nu and the quotient to
//     bf16, as the plain version's torch ops do.
//
// Bound: attention scores are small GEMMs. At a serve step (64 heads x
// 16 x 128 x 80, p = 6) reading the operands and writing the output takes
// about 0.5 us at 3.35 TB/s and the 6 int8 GEMMs about 0.01 us at the
// int8 peak, so the form is bound by bytes and, in practice, by latency:
// 128 blocks, one per SM, each a chain of strip loads, carves, MMAs and
// the CRT epilogue. In training (128 x 128 x 128 x 128 per call) the bound
// is about 4 us of bytes. The design keeps the (p, M, K) residues and the
// (p, M, N) int32 products out of device memory: only the float operands
// are read and the output written, as the paper's fusion asks. It does
// not pipeline loads or use TMA / wgmma (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 64;          // the K strip, staged once for all moduli
constexpr int LDA = BK + 1;     // int32 strip row strides, padded so that
constexpr int LDB = BN + 1;     // column walks hit distinct banks
constexpr int NWARPS = 8;
constexpr int NT = NWARPS * 32;
constexpr int T16 = 16 * 16;
constexpr int FRAGS = (BM / 16) * (BN / 16);
constexpr int FW = FRAGS / NWARPS;
constexpr int MAXP = 16;
static_assert(FRAGS % NWARPS == 0, "fragments must split evenly over warps");
constexpr int STRIP_BYTES = (BM * LDA + BK * LDB) * 4;
constexpr int MAX_DYN_SMEM = STRIP_BYTES + MAXP * BM * BN;

// The moduli and Garner's inverse table inv[i][j] = m_j^-1 mod m_i (j < i),
// passed by value.
struct Crt {
  int p;
  int m[MAXP];
  int inv[MAXP][MAXP];
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Rounding of a product to the operand's type.
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) { return round_bf16(x); }

__device__ __forceinline__ int floor_mod(int x, int m) {
  const int r = x % m;
  return r < 0 ? r + m : r;
}

// Floor modulo for |x| < 2^24 (exact in float): the quotient from the
// float reciprocal is off by at most one, which the correction absorbs.
__device__ __forceinline__ int floor_mod_small(int x, int m, float rcp) {
  const int q = __float2int_rd(__fmul_rn(__int2float_rn(x), rcp));
  const int r = x - q * m;
  return r < 0 ? r + m : (r >= m ? r - m : r);
}

// trunc(x * mu) in the operand's type T (x, mu already widened), as int32.
template <typename T>
__device__ __forceinline__ int integerize(float x, float mu) {
  return static_cast<int>(truncf(round_to(__fmul_rn(x, mu), T())));
}

// Balanced residue ((ai + m/2) mod m) - m/2 of an integerized value.
__device__ __forceinline__ int8_t balanced(int ai, int m, int half, float rcp) {
  const int r = floor_mod_small(ai, m, rcp) + half;
  return static_cast<int8_t>((r >= m ? r - m : r) - half);
}

// ---- double-double in float32 (repro.core.dd), no FMA --------------------

__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

__device__ __forceinline__ void quick_two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  e = __fsub_rn(b, __fsub_rn(s, a));
}

__device__ __forceinline__ void veltkamp(float a, float& hi, float& lo) {
  const float c = __fmul_rn(4097.0f, a);
  hi = __fsub_rn(c, __fsub_rn(c, a));
  lo = __fsub_rn(a, hi);
}

__device__ __forceinline__ void two_prod(float a, float b, float& p, float& e) {
  p = __fmul_rn(a, b);
  float ah, al, bh, bl;
  veltkamp(a, ah, al);
  veltkamp(b, bh, bl);
  e = __fadd_rn(__fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(ah, bh), p), __fmul_rn(ah, bl)),
                          __fmul_rn(al, bh)),
                __fmul_rn(al, bl));
}

__device__ __forceinline__ void mul_scalar(float& hi, float& lo, float c) {
  float p1, p2;
  two_prod(hi, c, p1, p2);
  p2 = __fadd_rn(p2, __fmul_rn(lo, c));
  quick_two_sum(p1, p2, hi, lo);
}

__device__ __forceinline__ void add_scalar(float& hi, float& lo, float x) {
  float s, e;
  two_sum(hi, x, s, e);
  e = __fadd_rn(e, lo);
  quick_two_sum(s, e, hi, lo);
}

// ---- the output type -----------------------------------------------------

template <typename O>
struct Out;

template <>
struct Out<float> {
  static __device__ __forceinline__ float crt(float hi, float lo) { return __fadd_rn(hi, lo); }
  static __device__ __forceinline__ float unscale(float c, float mu, float nu) {
    return __fdiv_rn(c, __fmul_rn(mu, nu));
  }
  static __device__ __forceinline__ void store(float* o, float c) { *o = c; }
};

template <>
struct Out<__nv_bfloat16> {
  static __device__ __forceinline__ float crt(float hi, float lo) {
    return round_bf16(__fadd_rn(round_bf16(hi), round_bf16(lo)));
  }
  static __device__ __forceinline__ float unscale(float c, float mu, float nu) {
    return round_bf16(__fdiv_rn(c, round_bf16(__fmul_rn(round_bf16(mu), round_bf16(nu)))));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* o, float c) {
    *o = __float2bfloat16_rn(c);
  }
};

// Shared int8 tiles are stored as 16x16 sub-tiles (256 bytes each), so
// that every wmma load is 32-byte aligned with a leading dimension of 16.
__device__ __forceinline__ int a_off(int mm, int kk) {
  return ((kk / 16) * (BM / 16) + mm / 16) * T16 + (mm % 16) * 16 + kk % 16;
}
__device__ __forceinline__ int b_off(int kk, int nn) {
  return ((kk / 16) * (BN / 16) + nn / 16) * T16 + (kk % 16) * 16 + nn % 16;
}

using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, int>;

// One K step of MMAs on the staged tiles, into this warp's fragments.
__device__ __forceinline__ void mma_tile(const int8_t* sA, const int8_t* sB, FragAcc (&acc)[FW],
                                         int warp) {
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks) {
#pragma unroll
    for (int f = 0; f < FW; ++f) {
      const int q = warp * FW + f;
      const int fr = q / (BN / 16), fc = q % (BN / 16);
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, sA + (ks * (BM / 16) + fr) * T16, 16);
      wmma::load_matrix_sync(fb, sB + (ks * (BN / 16) + fc) * T16, 16);
      wmma::mma_sync(acc[f], fa, fb, acc[f]);
    }
  }
}

// Hand each of this warp's accumulator elements to fn(row, col, value),
// through a per-warp 16x16 int32 staging tile whose layout is known.
template <typename Fn>
__device__ __forceinline__ void for_each_acc(FragAcc (&acc)[FW], int* sC, int warp, int lane,
                                             Fn fn) {
#pragma unroll
  for (int f = 0; f < FW; ++f) {
    const int q = warp * FW + f;
    const int fr = q / (BN / 16), fc = q % (BN / 16);
    wmma::store_matrix_sync(sC, acc[f], 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int idx = lane * 8 + e;
      fn(fr * 16 + idx / 16, fc * 16 + idx % 16, sC[idx]);
    }
    __syncwarp();
  }
}

// Three blocks a streaming multiprocessor (80 registers, no spills at the
// -O3 of kernels/build.py), which the shared memory allows up to p = 6.
template <typename TA, typename TB, typename O>
__global__ void __launch_bounds__(NT, 3)
emugemm2_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
                const TA* __restrict__ mu, const TB* __restrict__ nu,
                O* __restrict__ out, int M, int N, int K,
                long long sab, long long sam, long long sak,
                long long sbb, long long sbk, long long sbn, const Crt crt) {
  __shared__ __align__(128) int8_t sA[BM * BK];
  __shared__ __align__(128) int8_t sB[BK * BN];
  __shared__ __align__(128) int sC[NWARPS][T16];
  __shared__ float sMu[BM];
  __shared__ float sNu[BN];
  extern __shared__ __align__(128) uint8_t dyn[];
  int* sAi = reinterpret_cast<int*>(dyn);                // [BM][LDA]
  int* sBi = sAi + BM * LDA;                             // [BK][LDB]
  uint8_t* park = dyn + STRIP_BYTES;                     // [p][BM * BN]

  const long long bz = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  a += bz * sab;
  b += bz * sbb;
  mu += bz * M;
  nu += bz * N;
  out += bz * M * static_cast<long long>(N);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int p = crt.p;

  for (int i = tid; i < BM; i += NT) sMu[i] = m0 + i < M ? widen(mu[m0 + i]) : 0.f;
  for (int i = tid; i < BN; i += NT) sNu[i] = n0 + i < N ? widen(nu[n0 + i]) : 0.f;
  for (int i = tid; i < p * BM * BN / 4; i += NT) reinterpret_cast<int*>(park)[i] = 0;
  __syncthreads();

  for (int k0 = 0; k0 < K; k0 += BK) {
    // Integerize the strips once for all moduli; threads walk each
    // operand's unit-stride axis.
#pragma unroll 4
    for (int e = tid; e < BM * BK; e += NT) {
      int mm, kk;
      if (sak == 1) { mm = e / BK; kk = e % BK; } else { kk = e / BM; mm = e % BM; }
      const int gm = m0 + mm, gk = k0 + kk;
      sAi[mm * LDA + kk] =
          gm < M && gk < K ? integerize<TA>(widen(a[gm * sam + gk * sak]), sMu[mm]) : 0;
    }
#pragma unroll 4
    for (int e = tid; e < BK * BN; e += NT) {
      int kk, nn;
      if (sbn == 1) { kk = e / BN; nn = e % BN; } else { nn = e / BK; kk = e % BK; }
      const int gk = k0 + kk, gn = n0 + nn;
      sBi[kk * LDB + nn] =
          gk < K && gn < N ? integerize<TB>(widen(b[gk * sbk + gn * sbn]), sNu[nn]) : 0;
    }
    __syncthreads();

    for (int l = 0; l < p; ++l) {
      const int m = crt.m[l];
      const int half = m / 2;
      const float rcp = __fdiv_rn(1.0f, static_cast<float>(m));
#pragma unroll 4
      for (int e = tid; e < BM * BK; e += NT) {
        const int mm = e / BK, kk = e % BK;
        sA[a_off(mm, kk)] = balanced(sAi[mm * LDA + kk], m, half, rcp);
      }
#pragma unroll 4
      for (int e = tid; e < BK * BN; e += NT) {
        const int kk = e / BN, nn = e % BN;
        sB[b_off(kk, nn)] = balanced(sBi[kk * LDB + nn], m, half, rcp);
      }
      __syncthreads();
      FragAcc acc[FW];
#pragma unroll
      for (int f = 0; f < FW; ++f) wmma::fill_fragment(acc[f], 0);
      mma_tile(sA, sB, acc, warp);
      // modular_reduce, folded into [0, m) with the earlier strips. One
      // strip's sum is below BK * 128^2 = 2^20 in magnitude.
      uint8_t* pk = park + l * (BM * BN);
      for_each_acc(acc, sC[warp], warp, lane, [&](int row, int col, int v) {
        const int r = floor_mod_small(v, m, rcp) + pk[row * BN + col];
        pk[row * BN + col] = static_cast<uint8_t>(r >= m ? r - m : r);
      });
      __syncthreads();   // the MMA tiles are carved again for the next modulus
    }
  }

  // CRT epilogue: balanced Garner digits, double-double Horner, unscale.
  float rcp[MAXP];
#pragma unroll
  for (int i = 0; i < MAXP; ++i) rcp[i] = i < p ? __fdiv_rn(1.0f, static_cast<float>(crt.m[i])) : 0.f;
  for (int e = tid; e < BM * BN; e += NT) {
    const int row = e / BN, col = e % BN;
    const int gm = m0 + row, gn = n0 + col;
    if (gm >= M || gn >= N) continue;
    int d[MAXP];
#pragma unroll
    for (int i = 0; i < MAXP; ++i) {
      if (i < p) {
        const int mi = crt.m[i];
        int t = park[i * (BM * BN) + e];
#pragma unroll
        for (int j = 0; j < i; ++j) t = floor_mod_small((t - d[j]) * crt.inv[i][j], mi, rcp[i]);
        d[i] = t > mi / 2 ? t - mi : t;
      }
    }
    float hi = 0.f, lo = 0.f;
#pragma unroll
    for (int i = MAXP - 1; i >= 0; --i) {
      if (i < p) {
        if (i == p - 1) {
          hi = static_cast<float>(d[i]);
          lo = 0.f;
        } else {
          mul_scalar(hi, lo, static_cast<float>(crt.m[i]));
          add_scalar(hi, lo, static_cast<float>(d[i]));
        }
      }
    }
    Out<O>::store(out + static_cast<long long>(gm) * N + gn,
                  Out<O>::unscale(Out<O>::crt(hi, lo), sMu[row], sNu[col]));
  }
}

// The residue form: (p, M, K) @ (p, K, N) int8 residues -> balanced int8
// (p, M, N), one modulus per blockIdx.z.
__global__ void __launch_bounds__(NT)
emugemm2_residues_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                         int8_t* __restrict__ out, int M, int N, int K,
                         long long sap, long long sam, long long sak,
                         long long sbp, long long sbk, long long sbn, const Crt crt) {
  __shared__ __align__(128) int8_t sA[BM * BK];
  __shared__ __align__(128) int8_t sB[BK * BN];
  __shared__ __align__(128) int sC[NWARPS][T16];

  const int l = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  a += l * sap;
  b += l * sbp;
  out += l * M * static_cast<long long>(N);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int m = crt.m[l];
  const int half = m / 2;
  // Four bytes at a time along a unit-stride axis whose rows and base are
  // 4-byte aligned (a_off and b_off keep 4 consecutive k, or n, adjacent).
  const bool vec_a = sak == 1 && (K & 3) == 0 && (sam & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(a) & 3) == 0;
  const bool vec_b = sbn == 1 && (N & 3) == 0 && (sbk & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(b) & 3) == 0;

  FragAcc acc[FW];
#pragma unroll
  for (int f = 0; f < FW; ++f) wmma::fill_fragment(acc[f], 0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    if (vec_a) {
      for (int e = tid; e < BM * BK / 4; e += NT) {
        const int mm = e / (BK / 4), kk = (e % (BK / 4)) * 4;
        const int gm = m0 + mm, gk = k0 + kk;
        *reinterpret_cast<int*>(sA + a_off(mm, kk)) =
            gm < M && gk < K ? *reinterpret_cast<const int*>(a + gm * sam + gk) : 0;
      }
    } else {
      for (int e = tid; e < BM * BK; e += NT) {
        int mm, kk;
        if (sak == 1) { mm = e / BK; kk = e % BK; } else { kk = e / BM; mm = e % BM; }
        const int gm = m0 + mm, gk = k0 + kk;
        sA[a_off(mm, kk)] = gm < M && gk < K ? a[gm * sam + gk * sak] : int8_t(0);
      }
    }
    if (vec_b) {
      for (int e = tid; e < BK * BN / 4; e += NT) {
        const int kk = e / (BN / 4), nn = (e % (BN / 4)) * 4;
        const int gk = k0 + kk, gn = n0 + nn;
        *reinterpret_cast<int*>(sB + b_off(kk, nn)) =
            gk < K && gn < N ? *reinterpret_cast<const int*>(b + gk * sbk + gn) : 0;
      }
    } else {
      for (int e = tid; e < BK * BN; e += NT) {
        int kk, nn;
        if (sbn == 1) { kk = e / BN; nn = e % BN; } else { nn = e / BK; kk = e % BK; }
        const int gk = k0 + kk, gn = n0 + nn;
        sB[b_off(kk, nn)] = gk < K && gn < N ? b[gk * sbk + gn * sbn] : int8_t(0);
      }
    }
    __syncthreads();
    mma_tile(sA, sB, acc, warp);
    __syncthreads();
  }
  for_each_acc(acc, sC[warp], warp, lane, [&](int row, int col, int v) {
    const int gm = m0 + row, gn = n0 + col;
    if (gm < M && gn < N)
      out[static_cast<long long>(gm) * N + gn] = static_cast<int8_t>(floor_mod(v + half, m) - half);
  });
}

int make_crt(int p, const int* moduli, const int* inv, Crt& crt) {
  if (p < 1 || p > MAXP) return -1;
  crt.p = p;
  for (int i = 0; i < MAXP; ++i) {
    crt.m[i] = i < p ? moduli[i] : 1;
    for (int j = 0; j < MAXP; ++j) crt.inv[i][j] = i < p && j < p ? inv[i * p + j] : 0;
    if (i < p && (crt.m[i] < 2 || crt.m[i] > 256)) return -1;
  }
  return 0;
}

template <typename TA, typename TB, typename O>
int launch(const void* a, const void* b, const void* mu, const void* nu, void* out, int batch,
           int M, int N, int K, long long sab, long long sam, long long sak, long long sbb,
           long long sbk, long long sbn, const Crt& crt, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(emugemm2_kernel<TA, TB, O>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 MAX_DYN_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  emugemm2_kernel<TA, TB, O><<<grid, NT, STRIP_BYTES + crt.p * BM * BN, stream>>>(
      static_cast<const TA*>(a), static_cast<const TB*>(b), static_cast<const TA*>(mu),
      static_cast<const TB*>(nu), static_cast<O*>(out), M, N, K, sab, sam, sak, sbb, sbk, sbn,
      crt);
  return static_cast<int>(cudaGetLastError());
}

template <typename TA, typename O>
int launch_b(int b_bf16, const void* a, const void* b, const void* mu, const void* nu, void* out,
             int batch, int M, int N, int K, long long sab, long long sam, long long sak,
             long long sbb, long long sbk, long long sbn, const Crt& crt, cudaStream_t st) {
  if (b_bf16)
    return launch<TA, __nv_bfloat16, O>(a, b, mu, nu, out, batch, M, N, K, sab, sam, sak, sbb,
                                        sbk, sbn, crt, st);
  return launch<TA, float, O>(a, b, mu, nu, out, batch, M, N, K, sab, sam, sak, sbb, sbk, sbn,
                              crt, st);
}

template <typename O>
int launch_ab(int a_bf16, int b_bf16, const void* a, const void* b, const void* mu,
              const void* nu, void* out, int batch, int M, int N, int K, long long sab,
              long long sam, long long sak, long long sbb, long long sbk, long long sbn,
              const Crt& crt, cudaStream_t st) {
  if (a_bf16)
    return launch_b<__nv_bfloat16, O>(b_bf16, a, b, mu, nu, out, batch, M, N, K, sab, sam, sak,
                                      sbb, sbk, sbn, crt, st);
  return launch_b<float, O>(b_bf16, a, b, mu, nu, out, batch, M, N, K, sab, sam, sak, sbb, sbk,
                            sbn, crt, st);
}

}  // namespace

// Plain C entry points, bound with ctypes. Each returns 0 on success, a
// cudaError_t code if the launch was refused, and -1 for arguments that
// have no compiled instance.
//
// The fused forms: A (batch, M, K) and B (batch, K, N) float through
// strides, mu (batch, M) in A's type and nu (batch, N) in B's type,
// contiguous; out (batch, M, N) contiguous. moduli[p] and the Garner
// table inv[p * p] are host arrays.
extern "C" int emugemm2(const void* a, const void* b, const void* mu, const void* nu, void* out,
                        int batch, int M, int N, int K, long long sab, long long sam,
                        long long sak, long long sbb, long long sbk, long long sbn, int a_bf16,
                        int b_bf16, int out_bf16, int p, const int* moduli, const int* inv,
                        void* stream) {
  if (batch <= 0 || M <= 0 || N <= 0 || K <= 0) return -1;
  Crt crt;
  if (make_crt(p, moduli, inv, crt) != 0) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return launch_ab<__nv_bfloat16>(a_bf16, b_bf16, a, b, mu, nu, out, batch, M, N, K, sab, sam,
                                    sak, sbb, sbk, sbn, crt, st);
  return launch_ab<float>(a_bf16, b_bf16, a, b, mu, nu, out, batch, M, N, K, sab, sam, sak, sbb,
                          sbk, sbn, crt, st);
}

// The residue form: a_res (p, M, K) and b_res (p, K, N) int8 through
// strides; out (p, M, N) int8 contiguous.
extern "C" int emugemm2_residues(const int8_t* a, const int8_t* b, int8_t* out, int M, int N,
                                 int K, long long sap, long long sam, long long sak,
                                 long long sbp, long long sbk, long long sbn, int p,
                                 const int* moduli, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return -1;
  int zeros[MAXP * MAXP] = {0};
  Crt crt;
  if (make_crt(p, moduli, zeros, crt) != 0) return -1;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, p);
  emugemm2_residues_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, out, M, N, K, sap, sam, sak, sbp, sbk, sbn, crt);
  return static_cast<int>(cudaGetLastError());
}
