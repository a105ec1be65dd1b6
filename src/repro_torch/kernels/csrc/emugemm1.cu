// EmuGEMM-I: the fused Ozaki Scheme-I emulated GEMM for Hopper (sm_90a),
// in the two launch forms that the plane route (emugemm1_planes.cu) does not
// take.
//
// Replaces the Pallas kernels of the JAX package
//   src/repro/kernels/backends/gpu.py  fused_matmul_scheme1_batched, batched launch
//   src/repro/kernels/ozaki1.py        fused_matmul_interleaved (_kernel, neither operand float)
// with one kernel and two launch forms: a 2-D grid over (bN, bM) output
// tiles strided over a batch on blockIdx.z (attention's scores and values
// under Scheme I), and the interleaved form, whose operands are already
// sliced: A-hat (M, p*Kp) and B-hat (p*Kp, N), the p int8 planes of each
// interleaved on K at the kernel's K tile BK (Kp = K rounded up to BK, the
// slices past K zero), as csrc/decompose.cu writes them (switch PREP). The
// interleaved form loads those planes into the same shared tiles the carve
// would have filled, so the MMA schedule and the epilogue, and with them
// every numerics rule below, are shared. It divides nothing: A-hat and
// B-hat hold slices of A / mu and B / nu, so mu and nu enter only in the
// epilogue, and its result equals the carving form's bit for bit on the
// same operands. (The 2-D form and the mixed form, a float lhs against a
// prepared weight, run on the plane route.)
//
// What one block computes, for its (BM, BN) output tile:
//   * every K step stages a (BM, BK) tile of A and a (BK, BN) tile of B
//     (fp32 or bf16; bf16 is widened to fp32 in registers, which is exact),
//     divides by the power-of-two row scale mu / column scale nu, and carves
//     P signed beta-bit int8 slices with the truncate-subtract recurrence of
//     repro.kernels.common.carve_slices into shared memory;
//   * int8 tensor-core MMAs (wmma s8 16x16x16) run the triangular schedule
//     C_s += A'_i B'_{s-i} into P int32 accumulators held in registers;
//   * the shift-reduce epilogue sums sum_s 2^{-beta(s+2)} C_s highest weight
//     first, then multiplies by mu and then by nu, before the one store.
// Rows, columns and K steps past the edge are staged as zeros: a zero
// element carves to zero slices, so ragged shapes need no padding copy.
// Operands are addressed through strides, so a transposed view is read in
// place.
//
// Numerics, so that the result is bit-identical to the plain version
// (repro_torch.kernels.ozaki1.fused_matmul_plain):
//   * exact powers of two come from the exponent field, never exp2f;
//   * every float op is an explicit _rn intrinsic, so nvcc cannot contract
//     the epilogue into an FMA;
//   * int32 -> bf16 rounds through fp32 (RNE twice), as torch does, and a
//     bf16 output rounds after every op, as the reference shift_reduce does;
//   * the scales and beta come from the caller, computed from the logical K.
//
// Bound: the interleaved form reads p bytes an element of each operand and
// does p(p+1)/2 int8 GEMMs, so it is bound by operations (about 43 us at
// M = 1024, K = N = 2048, p = 4). The batched form at attention's shapes
// (a few rows of a head against K or N of the cached view) reads each
// operand once per tile. Neither form splits K, pipelines loads or uses
// TMA / wgmma, so both run far from those floors (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

// One tile shape: a (64, 64) output tile per block of 8 warps, K steps of
// 32. At M = 4 it measured faster than a (16, 64) tile of 4 warps (more
// threads loading the weight), so the smaller tile was dropped.
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int NWARPS = 8;
constexpr int T16 = 16 * 16;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Exact 2^e for a normal exponent e, built from the exponent field.
__device__ __forceinline__ float pow2(int e) { return __int_as_float((127 + e) << 23); }

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
};

// Carve one scaled element into P slices. Shared tiles are stored as
// 16x16 sub-tiles (256 bytes each) so that every wmma load is 32-byte
// aligned with a leading dimension of 16.
template <int P>
__device__ __forceinline__ void carve(float r, float two_beta, int8_t* dst, int plane) {
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const float sh = __fmul_rn(r, two_beta);
    const float t = truncf(sh);
    dst[i * plane] = static_cast<int8_t>(static_cast<int>(t));
    r = __fsub_rn(sh, t);
  }
}

template <typename T, typename O, int P, bool PREP>
__global__ void __launch_bounds__(NWARPS * 32)
emugemm1_kernel(const T* __restrict__ a, const void* __restrict__ bv,
                const float* __restrict__ mu, const float* __restrict__ nu,
                O* __restrict__ out, int M, int N, int K,
                long long sab, long long sam, long long sak,
                long long sbb, long long sbk, long long sbn, int beta) {
  constexpr int NT = NWARPS * 32;
  constexpr int FRAGS = (BM / 16) * (BN / 16);
  constexpr int FW = FRAGS / NWARPS;
  static_assert(FRAGS % NWARPS == 0, "fragments must split evenly over warps");
  constexpr int PLANE_A = BM * BK;
  constexpr int PLANE_B = BK * BN;
  __shared__ __align__(128) int8_t sA[P * PLANE_A];
  __shared__ __align__(128) int8_t sB[P * PLANE_B];
  __shared__ __align__(128) int sC[NWARPS][T16];

  const long long bz = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  a += bz * sab;
  mu += bz * M;
  nu += bz * N;
  out += bz * M * static_cast<long long>(N);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const float two_beta = pow2(beta);

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[P][FW];
#pragma unroll
  for (int s = 0; s < P; ++s)
#pragma unroll
    for (int f = 0; f < FW; ++f) wmma::fill_fragment(acc[s][f], 0);

  for (int k0 = 0; k0 < K; k0 += BK) {
    if constexpr (PREP) {
      // Load the P sliced planes of this K chunk: columns
      // (k0 / BK * P + i) * BK + kk of the interleaved (M, P*Kp) layout,
      // whose row stride is sam. Four bytes at a time where rows and base
      // allow.
      const int8_t* ah = reinterpret_cast<const int8_t*>(a) + bz * sab;
      const long long col0 = static_cast<long long>(k0 / BK) * P * BK;
      if ((sam & 3) == 0 && (reinterpret_cast<uintptr_t>(ah) & 3) == 0) {
        for (int e = tid; e < P * BM * (BK / 4); e += NT) {
          const int i = e / (BM * BK / 4);
          const int rem = e % (BM * BK / 4);
          const int mm = rem / (BK / 4), kk = (rem % (BK / 4)) * 4;
          const int gm = m0 + mm;
          int v = 0;
          if (gm < M) v = *reinterpret_cast<const int*>(ah + gm * sam + col0 + i * BK + kk);
          const int off = ((kk / 16) * (BM / 16) + mm / 16) * T16 + (mm % 16) * 16 + kk % 16;
          *reinterpret_cast<int*>(sA + i * PLANE_A + off) = v;
        }
      } else {
        for (int e = tid; e < P * BM * BK; e += NT) {
          const int i = e / (BM * BK);
          const int rem = e % (BM * BK);
          const int mm = rem / BK, kk = rem % BK;
          const int gm = m0 + mm;
          const int8_t v = gm < M ? ah[gm * sam + col0 + i * BK + kk] : int8_t(0);
          const int off = ((kk / 16) * (BM / 16) + mm / 16) * T16 + (mm % 16) * 16 + kk % 16;
          sA[i * PLANE_A + off] = v;
        }
      }
    } else {
      // Stage and carve the A tile; threads walk A's unit-stride axis.
      for (int e = tid; e < BM * BK; e += NT) {
        int mm, kk;
        if (sak == 1) { mm = e / BK; kk = e % BK; } else { kk = e / BM; mm = e % BM; }
        const int gm = m0 + mm, gk = k0 + kk;
        float r = 0.f;
        if (gm < M && gk < K) r = __fdiv_rn(widen(a[gm * sam + gk * sak]), mu[gm]);
        const int off = ((kk / 16) * (BM / 16) + mm / 16) * T16 + (mm % 16) * 16 + kk % 16;
        carve<P>(r, two_beta, sA + off, PLANE_A);
      }
    }
    if constexpr (PREP) {
      // Load the P prepared planes of this K chunk: rows
      // (k0 / BK * P + i) * BK + kk of the interleaved layout, whose row
      // stride is sbk. Four bytes at a time where rows and base allow.
      const int8_t* bh = static_cast<const int8_t*>(bv) + bz * sbb;
      const long long row0 = static_cast<long long>(k0 / BK) * P * BK;
      if ((N & 3) == 0 && (sbk & 3) == 0 && (reinterpret_cast<uintptr_t>(bh) & 3) == 0) {
        for (int e = tid; e < P * BK * (BN / 4); e += NT) {
          const int i = e / (BK * BN / 4);
          const int rem = e % (BK * BN / 4);
          const int kk = rem / (BN / 4), nn = (rem % (BN / 4)) * 4;
          const int gn = n0 + nn;
          int v = 0;
          if (gn < N) v = *reinterpret_cast<const int*>(bh + (row0 + i * BK + kk) * sbk + gn);
          const int off = ((kk / 16) * (BN / 16) + nn / 16) * T16 + (kk % 16) * 16 + nn % 16;
          *reinterpret_cast<int*>(sB + i * PLANE_B + off) = v;
        }
      } else {
        for (int e = tid; e < P * BK * BN; e += NT) {
          const int i = e / (BK * BN);
          const int rem = e % (BK * BN);
          const int kk = rem / BN, nn = rem % BN;
          const int gn = n0 + nn;
          const int8_t v = gn < N ? bh[(row0 + i * BK + kk) * sbk + gn] : int8_t(0);
          const int off = ((kk / 16) * (BN / 16) + nn / 16) * T16 + (kk % 16) * 16 + nn % 16;
          sB[i * PLANE_B + off] = v;
        }
      }
    } else {
      // Stage and carve the B tile.
      const T* b = static_cast<const T*>(bv) + bz * sbb;
      for (int e = tid; e < BK * BN; e += NT) {
        int kk, nn;
        if (sbn == 1) { kk = e / BN; nn = e % BN; } else { nn = e / BK; kk = e % BK; }
        const int gk = k0 + kk, gn = n0 + nn;
        float r = 0.f;
        if (gk < K && gn < N) r = __fdiv_rn(widen(b[gk * sbk + gn * sbn]), nu[gn]);
        const int off = ((kk / 16) * (BN / 16) + nn / 16) * T16 + (kk % 16) * 16 + nn % 16;
        carve<P>(r, two_beta, sB + off, PLANE_B);
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
#pragma unroll
      for (int f = 0; f < FW; ++f) {
        const int q = warp * FW + f;
        const int fr = q / (BN / 16), fc = q % (BN / 16);
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa[P];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> fb[P];
#pragma unroll
        for (int i = 0; i < P; ++i) {
          wmma::load_matrix_sync(fa[i], sA + i * PLANE_A + (ks * (BM / 16) + fr) * T16, 16);
          wmma::load_matrix_sync(fb[i], sB + i * PLANE_B + (ks * (BN / 16) + fc) * T16, 16);
        }
        // Triangular schedule: C_s += A'_i B'_{s-i}.
#pragma unroll
        for (int s = 0; s < P; ++s)
#pragma unroll
          for (int i = 0; i <= s; ++i) wmma::mma_sync(acc[s][f], fa[i], fb[s - i], acc[s][f]);
      }
    }
    __syncthreads();
  }

  // Shift-reduce epilogue, highest weight first, through a per-warp
  // 16x16 int32 staging tile whose layout (row-major) is known.
  float c[FW][8];
#pragma unroll
  for (int f = 0; f < FW; ++f)
#pragma unroll
    for (int e = 0; e < 8; ++e) c[f][e] = 0.f;
#pragma unroll
  for (int s = 0; s < P; ++s) {
    const float w = pow2(-beta * (s + 2));
#pragma unroll
    for (int f = 0; f < FW; ++f) {
      wmma::store_matrix_sync(sC[warp], acc[s][f], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 8; ++e) c[f][e] = Epilogue<O>::step(c[f][e], sC[warp][lane * 8 + e], w);
      __syncwarp();
    }
  }
#pragma unroll
  for (int f = 0; f < FW; ++f) {
    const int q = warp * FW + f;
    const int fr = q / (BN / 16), fc = q % (BN / 16);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int idx = lane * 8 + e;
      const int gm = m0 + fr * 16 + idx / 16;
      const int gn = n0 + fc * 16 + idx % 16;
      if (gm < M && gn < N)
        Epilogue<O>::store(out + static_cast<long long>(gm) * N + gn,
                           Epilogue<O>::scale(c[f][e], mu[gm], nu[gn]));
    }
  }
}

template <typename T, typename O, int P, bool PREP>
int launch(const void* a, const void* b, const float* mu, const float* nu, void* out,
           int batch, int M, int N, int K, long long sab, long long sam, long long sak,
           long long sbb, long long sbk, long long sbn, int beta,
           cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  emugemm1_kernel<T, O, P, PREP><<<grid, NWARPS * 32, 0, stream>>>(
      static_cast<const T*>(a), b, mu, nu, static_cast<O*>(out), M, N, K,
      sab, sam, sak, sbb, sbk, sbn, beta);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename O, bool PREP>
int launch_p(int p, const void* a, const void* b, const float* mu, const float* nu,
             void* out, int batch, int M, int N, int K, long long sab, long long sam,
             long long sak, long long sbb, long long sbk, long long sbn, int beta,
             cudaStream_t st) {
#define EMUGEMM1_CASE(PP) \
  case PP:                \
    return launch<T, O, PP, PREP>(a, b, mu, nu, out, batch, M, N, K, sab, sam, sak, sbb, sbk, sbn, beta, st);
  switch (p) {
    EMUGEMM1_CASE(1)
    EMUGEMM1_CASE(2)
    EMUGEMM1_CASE(3)
    EMUGEMM1_CASE(4)
    EMUGEMM1_CASE(5)
    EMUGEMM1_CASE(6)
    EMUGEMM1_CASE(7)
    EMUGEMM1_CASE(8)
    default:
      return -1;
  }
#undef EMUGEMM1_CASE
}

int launch_types(int in_bf16, int out_bf16, int p, const void* a, const void* b,
                 const float* mu, const float* nu, void* out, int batch, int M, int N, int K,
                 long long sab, long long sam, long long sak, long long sbb, long long sbk,
                 long long sbn, int beta, cudaStream_t st) {
  if (!in_bf16 && !out_bf16)
    return launch_p<float, float, false>(p, a, b, mu, nu, out, batch, M, N, K, sab, sam, sak, sbb, sbk, sbn, beta, st);
  if (!in_bf16 && out_bf16)
    return launch_p<float, __nv_bfloat16, false>(p, a, b, mu, nu, out, batch, M, N, K, sab, sam, sak, sbb, sbk, sbn, beta, st);
  if (in_bf16 && !out_bf16)
    return launch_p<__nv_bfloat16, float, false>(p, a, b, mu, nu, out, batch, M, N, K, sab, sam, sak, sbb, sbk, sbn, beta, st);
  return launch_p<__nv_bfloat16, __nv_bfloat16, false>(p, a, b, mu, nu, out, batch, M, N, K, sab, sam, sak, sbb, sbk, sbn, beta, st);
}

}  // namespace

// Plain C entry points, bound with ctypes. Each returns 0 on success, a
// cudaError_t code if the launch was refused, and -1 for an argument
// combination that has no compiled instance.
extern "C" int emugemm1(const void* a, const void* b, const float* mu, const float* nu,
                        void* out, int batch, int M, int N, int K, long long sab,
                        long long sam, long long sak, long long sbb, long long sbk,
                        long long sbn, int in_bf16, int out_bf16, int p, int beta,
                        void* stream) {
  if (batch <= 0 || M <= 0 || N <= 0 || K <= 0 || beta < 1 || beta > 7) return -1;
  return launch_types(in_bf16, out_bf16, p, a, b, mu, nu, out, batch, M, N, K, sab, sam, sak,
                      sbb, sbk, sbn, beta, static_cast<cudaStream_t>(stream));
}

// The interleaved form: A-hat (M, p * Kp) and B-hat (p * Kp, N) int8
// planes with row strides lda and ldb, both interleaved at granularity BK
// (Kp a multiple of BK, the slices past the logical K zero).
extern "C" int emugemm1_interleaved(const void* a_hat, const void* b_hat, const float* mu,
                                    const float* nu, void* out, int M, int N, int Kp,
                                    long long lda, long long ldb, int out_bf16, int p,
                                    int beta, void* stream) {
  if (M <= 0 || N <= 0 || Kp <= 0 || Kp % BK != 0 || beta < 1 || beta > 7) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return launch_p<int8_t, __nv_bfloat16, true>(p, a_hat, b_hat, mu, nu, out, 1, M, N, Kp,
                                                       0, lda, 1, 0, ldb, 1, beta, st);
  return launch_p<int8_t, float, true>(p, a_hat, b_hat, mu, nu, out, 1, M, N, Kp, 0, lda,
                                             1, 0, ldb, 1, beta, st);
}

// The K tile, which is the interleave granularity the interleaved form reads.
extern "C" int emugemm1_bk() { return BK; }
