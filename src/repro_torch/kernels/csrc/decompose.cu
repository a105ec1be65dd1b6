// Scheme-I decomposition for Hopper (sm_90a): one read of an operand
// writes its int8 slices in the interleaved layouts of the library's
// interleaved form (both operands, relaid into planes by
// csrc/emugemm1_planes.cu) and of the 'torch' backend's prepared weights.
//
// Replaces the Pallas kernels of the JAX package
//   src/repro/kernels/decompose.py  decompose_interleave_pair (_kernel_pair)
//   src/repro/kernels/decompose.py  decompose_interleave_rhs  (_kernel_rhs)
//   src/repro/kernels/decompose.py  decompose_interleave      (_kernel)
// with one kernel in three forms: with and without the twin output, and
// the lhs form, which reads A (M, K) as its transpose (K, M) through the
// strides and writes the same planes transposed (below).
//
// What one block computes, for its (TK, TN) tile of B (f32 or bf16,
// bf16 widened exactly; read through strides, so the tied head's emb.T
// is read in place):
//   * the forward layout (p * Kp, N): the tile divided by the column
//     scale nu[n], carved into p slices with beta_f by the truncate-
//     subtract recurrence of repro.kernels.common.carve_slices, slice i
//     written to rows (k / TK * p + i) * TK + k % TK (paper Eq. 11 at
//     granularity TK);
//   * with the twin, the K-transposed layout (p * Np, K) of B^T, which
//     the backward dA = dC B^T contracts over N: the same tile divided by
//     the row scale tau[k], carved with beta_b, slice i of element (k, n)
//     written to row (n / TN * p + i) * TN + n % TN, column k. The tile
//     sits in shared memory, so the transposed read is free and both
//     outputs are written with neighbouring threads on neighbouring bytes.
//   * the lhs form (LHS): B is A^T (K, M) and nu is mu (1, M); slice i of
//     element (k, m) goes to row m, column (k / TK * p + i) * TK + k % TK of
//     the (M, p * Kp) layout (paper Eq. 11, lhs), so threads walk k and
//     neighbouring threads write neighbouring bytes of a row of A-hat.
// Rows past K (forward) and past N (twin), and columns past K (lhs), up to
// the next tile are written as zero slices, so a consumer needs no masking
// there.
//
// Numerics: exact division by a power of two with __fdiv_rn, exact shifts
// and truncation, no FMA, so the planes are bit-identical to
// repro_torch.kernels.decompose's plain version and to the slices the
// Scheme-I encodes carve (x times the exact reciprocal, which rounds as
// the quotient does).
//
// Bound: bytes. The operand is read once (2 or 4 bytes an element) and
// p bytes an element are written per layout: for a 2048 x 8192 bf16
// weight at p = 4, 33.6 MB read and 134 MB written, about 50 us at
// 3.35 TB/s. The kernel moves one byte per thread per store and keeps no
// loads in flight across tiles, so it stays above that bound (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TK = 32;   // tile rows (K): the forward interleave granularity
constexpr int TN = 32;   // tile columns (N): the twin interleave granularity
constexpr int NT = 256;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// Exact 2^e for a normal exponent e, built from the exponent field.
__device__ __forceinline__ float pow2(int e) { return __int_as_float((127 + e) << 23); }

template <int P>
__device__ __forceinline__ void carve(float r, float two_beta, int8_t* dst, long long plane) {
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const float sh = __fmul_rn(r, two_beta);
    const float t = truncf(sh);
    dst[i * plane] = static_cast<int8_t>(static_cast<int>(t));
    r = __fsub_rn(sh, t);
  }
}

template <typename T, int P, bool TWIN, bool LHS>
__global__ void __launch_bounds__(NT)
decompose_kernel(const T* __restrict__ b, const float* __restrict__ nu,
                 const float* __restrict__ tau, int8_t* __restrict__ fwd,
                 int8_t* __restrict__ twin, int K, int N, long long sbk,
                 long long sbn, int beta_f, int beta_b) {
  __shared__ float tile[TK][TN + 1];
  const int n0 = blockIdx.x * TN;
  const int k0 = blockIdx.y * TK;
  const int tid = threadIdx.x;

  // Stage the tile; threads walk B's unit-stride axis.
  for (int e = tid; e < TK * TN; e += NT) {
    int kk, nn;
    if (sbn == 1) { kk = e / TN; nn = e % TN; } else { nn = e / TK; kk = e % TK; }
    const int gk = k0 + kk, gn = n0 + nn;
    tile[kk][nn] = (gk < K && gn < N) ? widen(b[gk * sbk + gn * sbn]) : 0.f;
  }
  __syncthreads();

  const float tf = pow2(beta_f);
  const long long frow = static_cast<long long>(blockIdx.y) * P * TK;
  if constexpr (LHS) {
    // Lhs planes: a column of the tile (a row of A) per TK threads, read
    // transposed; the row length of A-hat is p * Kp = gridDim.y * P * TK.
    const long long ld = static_cast<long long>(gridDim.y) * P * TK;
    for (int e = tid; e < TK * TN; e += NT) {
      const int nn = e / TK, kk = e % TK;
      const int gn = n0 + nn;
      if (gn < N)
        carve<P>(__fdiv_rn(tile[kk][nn], nu[gn]), tf, fwd + gn * ld + frow + kk, TK);
    }
  } else {
    // Forward planes: a row of the tile per TN threads.
    for (int e = tid; e < TK * TN; e += NT) {
      const int kk = e / TN, nn = e % TN;
      const int gn = n0 + nn;
      if (gn < N)
        carve<P>(__fdiv_rn(tile[kk][nn], nu[gn]), tf,
                 fwd + (frow + kk) * N + gn, static_cast<long long>(TK) * N);
    }
  }

  if constexpr (TWIN) {
    // Twin planes: a column of the tile per TK threads, read transposed.
    const float tb = pow2(beta_b);
    const long long trow = static_cast<long long>(blockIdx.x) * P * TN;
    for (int e = tid; e < TK * TN; e += NT) {
      const int nn = e / TK, kk = e % TK;
      const int gk = k0 + kk;
      if (gk < K)
        carve<P>(__fdiv_rn(tile[kk][nn], tau[gk]), tb,
                 twin + (trow + nn) * K + gk, static_cast<long long>(TN) * K);
    }
  }
}

template <typename T, bool TWIN, bool LHS>
int launch_p(int p, const void* b, const float* nu, const float* tau, void* fwd,
             void* twin, int K, int N, long long sbk, long long sbn, int beta_f,
             int beta_b, cudaStream_t st) {
  const dim3 grid((N + TN - 1) / TN, (K + TK - 1) / TK);
  const T* tb = static_cast<const T*>(b);
  int8_t* f = static_cast<int8_t*>(fwd);
  int8_t* t = static_cast<int8_t*>(twin);
#define DECOMPOSE_CASE(PP)                                                    \
  case PP:                                                                    \
    decompose_kernel<T, PP, TWIN, LHS><<<grid, NT, 0, st>>>(tb, nu, tau, f, t, K, N, \
                                                             sbk, sbn, beta_f, beta_b); \
    break;
  switch (p) {
    DECOMPOSE_CASE(1)
    DECOMPOSE_CASE(2)
    DECOMPOSE_CASE(3)
    DECOMPOSE_CASE(4)
    DECOMPOSE_CASE(5)
    DECOMPOSE_CASE(6)
    DECOMPOSE_CASE(7)
    DECOMPOSE_CASE(8)
    default:
      return -1;
  }
#undef DECOMPOSE_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes. twin == nullptr compiles the
// twin output out (K2r). Returns 0 on success, a cudaError_t code if the
// launch was refused, and -1 for an argument combination that has no
// compiled instance.
extern "C" int decompose_interleave(const void* b, const float* nu, const float* tau,
                                    void* fwd, void* twin, int K, int N, long long sbk,
                                    long long sbn, int in_bf16, int p, int beta_f,
                                    int beta_b, void* stream) {
  if (K <= 0 || N <= 0 || beta_f < 1 || beta_f > 7) return -1;
  if (twin != nullptr && (beta_b < 1 || beta_b > 7)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (twin == nullptr)
    return in_bf16 ? launch_p<__nv_bfloat16, false, false>(p, b, nu, tau, fwd, twin, K, N, sbk, sbn, beta_f, beta_b, st)
                   : launch_p<float, false, false>(p, b, nu, tau, fwd, twin, K, N, sbk, sbn, beta_f, beta_b, st);
  return in_bf16 ? launch_p<__nv_bfloat16, true, false>(p, b, nu, tau, fwd, twin, K, N, sbk, sbn, beta_f, beta_b, st)
                 : launch_p<float, true, false>(p, b, nu, tau, fwd, twin, K, N, sbk, sbn, beta_f, beta_b, st);
}

// The lhs form: A (M, K) through its strides, mu (M, 1) -> A-hat
// (M, p * Kp), Kp = K rounded up to the tile. Same return codes.
extern "C" int decompose_interleave_lhs(const void* a, const float* mu, void* a_hat, int M,
                                        int K, long long sam, long long sak, int in_bf16,
                                        int p, int beta, void* stream) {
  if (M <= 0 || K <= 0 || beta < 1 || beta > 7) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // A read as A^T (K, M): its row stride is A's column stride.
  return in_bf16 ? launch_p<__nv_bfloat16, false, true>(p, a, mu, nullptr, a_hat, nullptr, K, M, sak, sam, beta, 0, st)
                 : launch_p<float, false, true>(p, a, mu, nullptr, a_hat, nullptr, K, M, sak, sam, beta, 0, st);
}

// The tile, which is the interleave granularity of both layouts.
extern "C" int decompose_tile() { return TK; }
