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
// What the kernel computes for each (TK, TN) tile of B (f32 or bf16, bf16
// widened exactly; read through strides, so the tied head's emb.T is read
// in place):
//   * the forward layout (p * Kp, N): the tile times the exact reciprocal
//     of the column scale nu[n], carved into p slices with beta_f by the
//     truncate-subtract recurrence of repro.kernels.common.carve_slices,
//     slice i of row k written to row (k / IT * p + i) * IT + k % IT
//     (paper Eq. 11 at granularity IT);
//   * with the twin, the K-transposed layout (p * Np, K) of B^T, which the
//     backward dA = dC B^T contracts over N: the same tile over the row
//     scale tau[k], carved with beta_b, slice i of element (k, n) written
//     to row (n / IT * p + i) * IT + n % IT, column k;
//   * the lhs form (LHS): B is A^T (K, M) and nu is mu (1, M); slice i of
//     element (k, m) goes to row m, column (k / IT * p + i) * IT + k % IT
//     of the (M, p * Kp) layout (paper Eq. 11, lhs).
// Rows past K (forward) and past N (twin), and columns past K (lhs), up to
// the next IT are written as zero slices, so a consumer needs no masking
// there.
//
// Bound: bytes. The operand is read once (2 or 4 bytes an element) and p
// bytes an element are written per layout: for a 2048 x 8192 bf16 weight
// at p = 4, 33.6 MB read and 134 MB written for the pair, about 50 us at
// 3.35 TB/s. The design keeps the memory system busy:
//   * loads: 16 bytes a thread along the operand's unit-stride axis (8
//     elements: one 16-byte load in bf16, two in f32), scalar loads where
//     the strides or the edge do not allow it;
//   * a (64, 64) tile a block pass, staged once in shared memory as float
//     with rows padded to 65 words, so that reading it along either axis
//     (8 consecutive n at one k, or 8 consecutive k at one n) is free of
//     bank conflicts (checked in a numpy model of the lane mapping below);
//   * a grid-stride walk over the tiles, each block resident on its SM
//     issuing the next tile's loads into registers before it carves the
//     current one, so that a tile's loads are in flight during the stores;
//   * the carve: each thread scales 8 consecutive elements of one output
//     row with x * (1 / s), the reciprocal exact from s's exponent field
//     (a product by an exact power of two rounds as the quotient does, the
//     subnormal 2^-127 included: no -ftz), and carves them with
//     scheme1_common.cuh's carve8, storing each slice as one 8-byte word
//     (neighbouring threads on neighbouring words of a row, 32-byte
//     sectors), byte stores only at a ragged edge or a row length that is
//     not a multiple of 8.
// Numerics: every float op an _rn intrinsic, exact shifts and truncation,
// no FMA, so the planes are bit-identical to repro_torch.kernels.
// decompose's plain version and to the slices the Scheme-I encodes carve.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "scheme1_common.cuh"

using namespace scheme1;

namespace {

constexpr int TK = 64;            // tile rows (K)
constexpr int TN = 64;            // tile columns (N)
constexpr int IT = 32;            // the interleave granularity of both layouts
constexpr int NT = 256;
constexpr int LD = TN + 1;        // staged row stride in words: conflict-free both ways
constexpr int UNITS = TK * TN / 8 / NT;   // 8-element granules a thread a pass

// The lane mapping of a granule, for pass q of thread tid: four lanes
// along the granule's axis, eight along the other. Along n (ALONG_N):
// tile row kk, columns n .. n + 7; along k: rows k .. k + 7, column nn.
__device__ __forceinline__ void granule(int tid, int q, int& along, int& across) {
  const int u = (tid >> 5) + 8 * q, lane = tid & 31;
  along = ((u & 1) * 4 + (lane & 3)) * 8;
  across = (u >> 1) * 8 + (lane >> 2);
}

template <typename T>
__device__ __forceinline__ void load8_vec(float (&v)[8], const T* src);

template <>
__device__ __forceinline__ void load8_vec(float (&v)[8], const float* src) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(src));
  const float4 y = __ldg(reinterpret_cast<const float4*>(src) + 1);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
}

template <>
__device__ __forceinline__ void load8_vec(float (&v)[8], const __nv_bfloat16* src) {
  const uint4 x = __ldg(reinterpret_cast<const uint4*>(src));
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __uint_as_float(w[j] << 16);           // bf16 widens exactly
    v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

// The p slices of eight consecutive output bytes: one 8-byte word a slice
// at dst + i * step, or `count` < 8 single bytes (a ragged edge, or a row
// length that is not a multiple of 8).
__device__ __forceinline__ void carve_store(float (&r)[8], float two_beta, int p, int8_t* dst,
                                           long long step, int count, bool vec) {
  carve8(r, two_beta, p, [&](int i, uint2 w) {
    int8_t* d = dst + i * step;
    if (vec) {
      *reinterpret_cast<uint2*>(d) = w;
    } else {
      for (int j = 0; j < count; ++j)
        d[j] = static_cast<int8_t>(((j < 4 ? w.x : w.y) >> (8 * (j % 4))) & 0xff);
    }
  });
}

// Runtime shape of one launch.
struct Args {
  int K, N;                 // B (K, N); the lhs form's B is A^T (K, M)
  long long sbk, sbn;       // strides in elements
  int along_n;              // loads walk n (B's unit stride); else k
  int vec_load;             // base and the other stride 16-byte aligned
  int p, beta_f, beta_b;
  long long ld;             // the lhs layout's row length p * Kp
};

template <typename T, bool TWIN, bool LHS>
__global__ void __launch_bounds__(NT)
decompose_kernel(const T* __restrict__ b, const float* __restrict__ nu,
                 const float* __restrict__ tau, int8_t* __restrict__ fwd,
                 int8_t* __restrict__ twin, const Args args) {
  __shared__ float tile[TK * LD];
  __shared__ float s_nu[TN];      // 1 / nu of the tile's columns (mu of its rows of A)
  __shared__ float s_tau[TK];     // 1 / tau of the tile's rows
  const int K = args.K, N = args.N, p = args.p;
  const int tid = threadIdx.x;
  const int tiles_n = (N + TN - 1) / TN;
  const int tiles = ((K + TK - 1) / TK) * tiles_n;
  const int Kp = (K + IT - 1) / IT * IT, Np = (N + IT - 1) / IT * IT;

  // This thread's share of a tile, held in registers between the fetch
  // and the stash: UNITS granules and one scale.
  float v[UNITS][8];
  float sc = 0.f;
  auto fetch = [&](int t) {
    const int k0 = (t / tiles_n) * TK, n0 = (t % tiles_n) * TN;
#pragma unroll
    for (int q = 0; q < UNITS; ++q) {
      int along, across;
      granule(tid, q, along, across);
      const int k = k0 + (args.along_n ? across : along);
      const int n = n0 + (args.along_n ? along : across);
      const int count = args.along_n ? (k < K ? min(8, N - n) : 0)
                                     : (n < N ? min(8, K - k) : 0);
      const long long step = args.along_n ? args.sbn : args.sbk;
      const T* src = b + k * args.sbk + n * args.sbn;
      if (args.vec_load && count == 8) {
        load8_vec(v[q], src);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[q][j] = j < count ? widen(src[j * step]) : 0.f;
      }
    }
    if (tid < TN) {
      sc = n0 + tid < N ? recip_pow2(nu[n0 + tid]) : 0.f;
    } else if (TWIN && tid < TN + TK) {
      sc = k0 + tid - TN < K ? recip_pow2(tau[k0 + tid - TN]) : 0.f;
    }
  };

  int t = blockIdx.x;
  if (t >= tiles) return;
  fetch(t);
  const float tf = pow2(args.beta_f);
  for (; t < tiles; t += gridDim.x) {
    const int k0 = (t / tiles_n) * TK, n0 = (t % tiles_n) * TN;
    __syncthreads();                       // the previous tile's readers are done
#pragma unroll
    for (int q = 0; q < UNITS; ++q) {
      int along, across;
      granule(tid, q, along, across);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (args.along_n) tile[across * LD + along + j] = v[q][j];
        else tile[(along + j) * LD + across] = v[q][j];
      }
    }
    if (tid < TN) s_nu[tid] = sc;
    else if (TWIN && tid < TN + TK) s_tau[tid - TN] = sc;
    __syncthreads();
    if (t + static_cast<int>(gridDim.x) < tiles) fetch(t + gridDim.x);   // in flight during the carve

    if constexpr (LHS) {
      // A-hat: 8 consecutive k of one row m of A, one word a slice.
#pragma unroll
      for (int q = 0; q < UNITS; ++q) {
        int kk, nn;
        granule(tid, q, kk, nn);
        const int k = k0 + kk, m = n0 + nn;
        if (m >= N || k >= Kp) continue;
        const float inv = s_nu[nn];
        float r[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) r[j] = __fmul_rn(tile[(kk + j) * LD + nn], inv);
        carve_store(r, tf, p, fwd + m * args.ld + (k / IT * p) * IT + k % IT, IT, 8, true);
      }
    } else {
      // Forward layout: 8 consecutive n of one row k.
      const bool vec = N % 8 == 0;
#pragma unroll
      for (int q = 0; q < UNITS; ++q) {
        int nn, kk;
        granule(tid, q, nn, kk);
        const int k = k0 + kk, n = n0 + nn;
        if (k >= Kp || n >= N) continue;
        float r[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) r[j] = __fmul_rn(tile[kk * LD + nn + j], s_nu[nn + j]);
        carve_store(r, tf, p, fwd + (static_cast<long long>(k / IT * p) * IT + k % IT) * N + n,
                    static_cast<long long>(IT) * N, min(8, N - n), vec);
      }
    }

    if constexpr (TWIN) {
      // Twin layout: 8 consecutive k of one row n of B^T.
      const float tb = pow2(args.beta_b);
      const bool vec = K % 8 == 0;
#pragma unroll
      for (int q = 0; q < UNITS; ++q) {
        int kk, nn;
        granule(tid, q, kk, nn);
        const int k = k0 + kk, n = n0 + nn;
        if (n >= Np || k >= K) continue;
        float r[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) r[j] = __fmul_rn(tile[(kk + j) * LD + nn], s_tau[kk + j]);
        carve_store(r, tb, p, twin + (static_cast<long long>(n / IT * p) * IT + n % IT) * K + k,
                    static_cast<long long>(IT) * K, min(8, K - k), vec);
      }
    }
  }
}

template <typename T, bool TWIN, bool LHS>
int launch(const void* b, const float* nu, const float* tau, void* fwd, void* twin,
           const Args& args, cudaStream_t st) {
  static int grid_cap = 0;     // resident blocks of this instance on the card
  if (grid_cap == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, decompose_kernel<T, TWIN, LHS>, NT, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    grid_cap = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long tiles =
      static_cast<long long>((args.K + TK - 1) / TK) * ((args.N + TN - 1) / TN);
  if (tiles > 0x7fffffffLL) return -1;
  const int grid = static_cast<int>(tiles < grid_cap ? tiles : grid_cap);
  decompose_kernel<T, TWIN, LHS><<<grid, NT, 0, st>>>(
      static_cast<const T*>(b), nu, tau, static_cast<int8_t*>(fwd), static_cast<int8_t*>(twin),
      args);
  return static_cast<int>(cudaGetLastError());
}

// Fills the load mode of `args` from B's strides and base address.
void load_mode(Args& args, const void* b, int elem) {
  // A dimension of extent 1 has no stride to speak of.
  const bool unit_n = args.sbn == 1 || args.N == 1, unit_k = args.sbk == 1 || args.K == 1;
  args.along_n = unit_n || !unit_k;
  const long long other = args.along_n ? args.sbk : args.sbn;
  const bool unit = args.along_n ? args.sbn == 1 : args.sbk == 1;
  args.vec_load = unit && reinterpret_cast<uintptr_t>(b) % 16 == 0 && (other * elem) % 16 == 0;
}

template <bool TWIN, bool LHS>
int dispatch(int in_bf16, const void* b, const float* nu, const float* tau, void* fwd, void* twin,
             Args& args, cudaStream_t st) {
  load_mode(args, b, in_bf16 ? 2 : 4);
  return in_bf16 ? launch<__nv_bfloat16, TWIN, LHS>(b, nu, tau, fwd, twin, args, st)
                 : launch<float, TWIN, LHS>(b, nu, tau, fwd, twin, args, st);
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
  if (K <= 0 || N <= 0 || p < 1 || p > MAXP || beta_f < 1 || beta_f > 7) return -1;
  if (twin != nullptr && (beta_b < 1 || beta_b > 7)) return -1;
  Args args{K, N, sbk, sbn, 0, 0, p, beta_f, beta_b, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (twin == nullptr) return dispatch<false, false>(in_bf16, b, nu, tau, fwd, twin, args, st);
  return dispatch<true, false>(in_bf16, b, nu, tau, fwd, twin, args, st);
}

// The lhs form: A (M, K) through its strides, mu (M, 1) -> A-hat
// (M, p * Kp), Kp = K rounded up to the interleave. Same return codes.
extern "C" int decompose_interleave_lhs(const void* a, const float* mu, void* a_hat, int M,
                                        int K, long long sam, long long sak, int in_bf16,
                                        int p, int beta, void* stream) {
  if (M <= 0 || K <= 0 || p < 1 || p > MAXP || beta < 1 || beta > 7) return -1;
  // A read as A^T (K, M): its row stride is A's column stride.
  Args args{K, M, sak, sam, 0, 0, p, beta, 0,
            static_cast<long long>(p) * ((K + IT - 1) / IT * IT)};
  return dispatch<false, true>(in_bf16, a, mu, nullptr, a_hat, nullptr, args,
                               static_cast<cudaStream_t>(stream));
}

// The interleave granularity of both layouts.
extern "C" int decompose_tile() { return IT; }
