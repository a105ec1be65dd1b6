// EmuGEMM-II: the fused Ozaki Scheme-II emulated GEMM for Hopper (sm_90a).
//
// Replaces the Pallas kernels of the JAX package
//   src/repro/kernels/backends/gpu.py  fused_matmul_scheme2 (_kernel2, float rhs), 2-D launch
//   src/repro/kernels/backends/gpu.py  fused_matmul_scheme2_batched, batched launch
//   src/repro/kernels/ozaki2.py        fused_residue_matmul (_kernel), residue launch
// with one source and three launch forms: a 2-D grid over (BN, BM) output
// tiles; the 2-D grid strided over a batch on blockIdx.z; and the residue
// form, whose grid runs over the p moduli on blockIdx.z and which takes
// int8 residues in and writes balanced int8 residues out.
//
// Operand types: float32 and bfloat16 (attention scores, dB of a prepared
// weight); outputs float32, bfloat16 and float64. A product of float64
// operands, 2-D (a DGEMM) or batched, and the prepared form (a float lhs
// against a weight's stored residue planes) take the plane route of
// emugemm2_planes.cu instead (kernels/ozaki2.py).
//
// What one block of the fused forms computes, for its (BM, BN) output tile:
//   * prologue, once per K strip of BK: stage a (BM, BK) strip of A and a
//     (BK, BN) strip of B, each in its own type, and integerize
//     trunc(x * mu) in that type (a bf16 product rounds to bf16 before the
//     truncation) into strips in shared memory: int32 for float32 and
//     bf16, exact integers in doubles (below 2^53) for float64;
//   * per modulus: carve the balanced int8 residues of both strips into the
//     MMA tiles, accumulate their product with int8 tensor-core MMAs (wmma
//     s8 16x16x16) into one int32 accumulator set in registers, reduce it
//     mod m (floor modulo) and add it, mod m, into that modulus's residue
//     tile, parked in shared memory as bytes;
//   * epilogue, once all strips are folded in: balanced Garner digits in
//     exact int32 (the inverse table comes from the caller), the
//     double-double Horner (float64 for a float64 output, float32
//     otherwise), hi and lo rounded to the out type and added in it, then
//     divided by out(mu) * out(nu) rounded to the out type; one store.
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
// Numerics: see scheme2_common.cuh. The plain version is
// repro_torch.kernels.ozaki2.fused_matmul_scheme2_plain.
//
// Bound: attention scores are small GEMMs. At a serve step (64 heads x
// 16 x 128 x 80, p = 6) reading the operands and writing the output takes
// about 0.5 us at 3.35 TB/s and the 6 int8 GEMMs about 0.01 us at the
// int8 peak, so the form is bound by bytes and, in practice, by latency:
// 128 blocks, one per SM, each a chain of strip loads, carves, MMAs and
// the CRT epilogue. The kernel is bound by its per-element integer work (a
// carve per staged element and modulus, a fold per strip and modulus). The
// design
// keeps the (p, M, K) residues and the (p, M, N) int32 products out of
// device memory: only the float operands are read and the output
// written, as the paper's fusion asks. It does not pipeline loads or use
// TMA / wgmma; the plane route does both (PERF.md).

#include "scheme2_common.cuh"

using namespace s2;

namespace {

constexpr int BK = 64;          // the K strip, staged once for all moduli
constexpr int LDA = BK + 1;     // strip row strides, padded so that
constexpr int LDB = BN + 1;     // column walks hit distinct banks

// The integerized strips of A and B (int32 for float32 and bf16).
template <typename TA, typename TB>
__host__ __device__ constexpr int strip_bytes() {
  return BM * LDA * sizeof(typename Num<TA>::S) + BK * LDB * sizeof(typename Num<TB>::S);
}

// Three blocks a streaming multiprocessor for a float32 or bf16 output (80
// registers, no spills at the -O3 of kernels/build.py), which the shared
// memory allows up to p = 6; one for a float64 output (its double-double
// needs more registers).
template <typename O>
__host__ __device__ constexpr int min_blocks() {
  return sizeof(O) == 8 ? 1 : 3;
}

template <typename TA, typename TB, typename O>
__global__ void __launch_bounds__(NT, (min_blocks<O>()))
emugemm2_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
                const TA* __restrict__ mu, const TB* __restrict__ nu,
                O* __restrict__ out, int M, int N, int K,
                long long sab, long long sam, long long sak,
                long long sbb, long long sbk, long long sbn, const Crt crt) {
  using WA = typename Num<TA>::W;
  using WB = typename Num<TB>::W;
  using SA = typename Num<TA>::S;
  using SB = typename Num<TB>::S;
  __shared__ __align__(128) int8_t sA[BM * BK];
  __shared__ __align__(128) int8_t sB[BK * BN];
  __shared__ __align__(128) int sC[NWARPS][T16];
  __shared__ WA sMu[BM];
  __shared__ WB sNu[BN];
  extern __shared__ __align__(128) uint8_t dyn[];
  SA* sAi = reinterpret_cast<SA*>(dyn);                               // [BM][LDA]
  SB* sBi = reinterpret_cast<SB*>(dyn + BM * LDA * sizeof(SA));       // [BK][LDB]
  uint8_t* park = dyn + strip_bytes<TA, TB>();                        // [p][BM * BN]

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

  for (int i = tid; i < BM; i += NT) sMu[i] = m0 + i < M ? widen(mu[m0 + i]) : WA(0);
  for (int i = tid; i < BN; i += NT) sNu[i] = n0 + i < N ? widen(nu[n0 + i]) : WB(0);
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
          gm < M && gk < K ? integerize(widen(a[gm * sam + gk * sak]), sMu[mm], TA()) : SA(0);
    }
#pragma unroll 4
    for (int e = tid; e < BK * BN; e += NT) {
      int kk, nn;
      if (sbn == 1) { kk = e / BN; nn = e % BN; } else { nn = e / BK; kk = e % BK; }
      const int gk = k0 + kk, gn = n0 + nn;
      sBi[kk * LDB + nn] =
          gk < K && gn < N ? integerize(widen(b[gk * sbk + gn * sbn]), sNu[nn], TB()) : SB(0);
    }
    __syncthreads();

    for (int l = 0; l < p; ++l) {
      const Mod md = modulus(crt.m[l]);
#pragma unroll 4
      for (int e = tid; e < BM * BK; e += NT) {
        const int mm = e / BK, kk = e % BK;
        sA[a_off(mm, kk)] = balanced(sAi[mm * LDA + kk], md);
      }
#pragma unroll 4
      for (int e = tid; e < BK * BN; e += NT) {
        const int kk = e / BN, nn = e % BN;
        sB[b_off(kk, nn)] = balanced(sBi[kk * LDB + nn], md);
      }
      __syncthreads();
      FragAcc acc[FW];
      zero(acc);
      mma_tile<BK>(sA, sB, acc, warp);
      // modular_reduce, folded into [0, m) with the earlier strips. One
      // strip's sum is below BK * 128^2 = 2^20 in magnitude.
      uint8_t* pk = park + l * (BM * BN);
      for_each_acc(acc, sC[warp], warp, lane, [&](int row, int col, int v) {
        const int r = floor_mod_small(v, md.m, md.rcp) + pk[row * BN + col];
        pk[row * BN + col] = static_cast<uint8_t>(r >= md.m ? r - md.m : r);
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
    const auto c = crt_element<O>(crt, rcp, [&](int i) { return int(park[i * (BM * BN) + e]); });
    Out<O>::store(out + static_cast<long long>(gm) * N + gn,
                  Out<O>::div(c, Out<O>::mul(Out<O>::cvt(sMu[row]), Out<O>::cvt(sNu[col]))));
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
  zero(acc);
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
    mma_tile<BK>(sA, sB, acc, warp);
    __syncthreads();
  }
  for_each_acc(acc, sC[warp], warp, lane, [&](int row, int col, int v) {
    const int gm = m0 + row, gn = n0 + col;
    if (gm < M && gn < N)
      out[static_cast<long long>(gm) * N + gn] = static_cast<int8_t>(floor_mod(v + half, m) - half);
  });
}

template <typename TA, typename TB, typename O>
int launch(const void* a, const void* b, const void* mu, const void* nu, void* out, int batch,
           int M, int N, int K, long long sab, long long sam, long long sak, long long sbb,
           long long sbk, long long sbn, const Crt& crt, cudaStream_t stream) {
  constexpr int strip = strip_bytes<TA, TB>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(emugemm2_kernel<TA, TB, O>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 strip + MAXP * BM * BN);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  emugemm2_kernel<TA, TB, O><<<grid, NT, strip + crt.p * BM * BN, stream>>>(
      static_cast<const TA*>(a), static_cast<const TB*>(b), static_cast<const TA*>(mu),
      static_cast<const TB*>(nu), static_cast<O*>(out), M, N, K, sab, sam, sak, sbb, sbk, sbn,
      crt);
  return static_cast<int>(cudaGetLastError());
}

// Operand types: 0 float32, 1 bfloat16, 2 float64.
enum { F32 = 0, BF16 = 1, F64 = 2 };

template <typename O>
int launch_ab(int ta, int tb, const void* a, const void* b, const void* mu, const void* nu,
              void* out, int batch, int M, int N, int K, long long sab, long long sam,
              long long sak, long long sbb, long long sbk, long long sbn, const Crt& crt,
              cudaStream_t st) {
#define EMUGEMM2_LAUNCH(TA_, TB_)                                                          \
  return launch<TA_, TB_, O>(a, b, mu, nu, out, batch, M, N, K, sab, sam, sak, sbb, sbk, \
                             sbn, crt, st)
  if (ta == F32 && tb == F32) EMUGEMM2_LAUNCH(float, float);
  if (ta == F32 && tb == BF16) EMUGEMM2_LAUNCH(float, __nv_bfloat16);
  if (ta == BF16 && tb == F32) EMUGEMM2_LAUNCH(__nv_bfloat16, float);
  if (ta == BF16 && tb == BF16) EMUGEMM2_LAUNCH(__nv_bfloat16, __nv_bfloat16);
#undef EMUGEMM2_LAUNCH
  return -1;
}

// The instances: float32 and bf16 operands in any pairing with a float32,
// bf16 or float64 output. Float64 operands take the plane route
// (emugemm2_planes.cu), so there is no float64 operand instance.
int launch_types(int ta, int tb, int to, const void* a, const void* b, const void* mu,
                 const void* nu, void* out, int batch, int M, int N, int K, long long sab,
                 long long sam, long long sak, long long sbb, long long sbk, long long sbn,
                 const Crt& crt, cudaStream_t st) {
  if (ta == F64 || tb == F64) return -1;
  if (to == F32)
    return launch_ab<float>(ta, tb, a, b, mu, nu, out, batch, M, N, K, sab, sam, sak, sbb, sbk,
                            sbn, crt, st);
  if (to == BF16)
    return launch_ab<__nv_bfloat16>(ta, tb, a, b, mu, nu, out, batch, M, N, K, sab, sam, sak,
                                    sbb, sbk, sbn, crt, st);
  if (to == F64)
    return launch_ab<double>(ta, tb, a, b, mu, nu, out, batch, M, N, K, sab, sam, sak, sbb, sbk,
                             sbn, crt, st);
  return -1;
}

}  // namespace

// Plain C entry points, bound with ctypes. Each returns 0 on success, a
// cudaError_t code if the launch was refused, and -1 for arguments that
// have no compiled instance.
//
// The fused forms: A (batch, M, K) and B (batch, K, N) through strides,
// mu (batch, M) in A's type and nu (batch, N) in B's type, contiguous; out
// (batch, M, N) contiguous. Types: 0 float32, 1 bfloat16, 2 float64, for
// A, B and out (instances: launch_types; no float64 operands). moduli[p] and the Garner table
// inv[p * p] are host arrays.
extern "C" int emugemm2(const void* a, const void* b, const void* mu, const void* nu, void* out,
                        int batch, int M, int N, int K, long long sab, long long sam,
                        long long sak, long long sbb, long long sbk, long long sbn, int ta,
                        int tb, int to, int p, const int* moduli, const int* inv, void* stream) {
  if (batch <= 0 || M <= 0 || N <= 0 || K <= 0) return -1;
  Crt crt;
  if (make_crt(p, moduli, inv, crt) != 0) return -1;
  return launch_types(ta, tb, to, a, b, mu, nu, out, batch, M, N, K, sab, sam, sak, sbb, sbk, sbn,
                      crt, static_cast<cudaStream_t>(stream));
}

// The residue form: a_res (p, M, K) and b_res (p, K, N) int8 through
// strides; out (p, M, N) int8 contiguous.
extern "C" int emugemm2_residues(const int8_t* a, const int8_t* b, int8_t* out, int M, int N,
                                 int K, long long sap, long long sam, long long sak,
                                 long long sbp, long long sbk, long long sbn, int p,
                                 const int* moduli, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return -1;
  Crt crt;
  if (make_crt(p, moduli, nullptr, crt) != 0) return -1;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, p);
  emugemm2_residues_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, out, M, N, K, sap, sam, sak, sbp, sbk, sbn, crt);
  return static_cast<int>(cudaGetLastError());
}
