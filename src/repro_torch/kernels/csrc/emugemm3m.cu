// EmuGEMM-II 3M: fused complex Ozaki Scheme-II GEMMs for Hopper (sm_90a).
//
// Replaces the Pallas kernels of the JAX package
//   src/repro/kernels/backends/gpu.py  fused_matmul_3m (_kernel2_3m)        -> emugemm3m (K7g)
//   src/repro/kernels/ozaki3m.py       fused_3m_residue_matmul (_kernel)     -> emugemm3m_residues (K7)
// The 3M identity in modular arithmetic (paper Sec. IV-B):
//   T1 = Ar'Br', T2 = Ai'Bi', T3 = (Ar' + Ai')(Br' + Bi')      (mod m)
//   C_re = T1 - T2,  C_im = T3 - T1 - T2                          (mod m, exact)
//
// K7g, for one (BM, BN) output tile of a complex product, a loop over K
// strips of BK = 32 inside the block:
//   * stage the strip of each of the four float parts once (float32 or
//     float64; a complex operand's parts are read in place from its
//     interleaved storage, a real operand's imaginary part is zero) and
//     integerize trunc(x * mu), trunc(x * nu) with the scales shared by the
//     real and imaginary parts, into strips in shared memory (int32 for
//     float32, exact integers in doubles for float64);
//   * per modulus: carve the balanced int8 residues of re and im and the
//     re-balanced residue of their sum (complex3m._balanced: a floor modulo
//     of the int32 sum) into three MMA tiles per operand, run the three
//     int8 products into three int32 accumulator sets, combine them in
//     registers into this strip's T1 - T2 and T3 - T1 - T2, and fold each,
//     mod m, into that modulus's two parked residue tiles;
//   * epilogue: two Garner + double-double CRTs per element (float64 for a
//     float64 output, float32 otherwise), each times inv = 1 / (mu * nu)
//     rounded to the output type, as the reference does (real Scheme II
//     divides by mu * nu instead; the two round differently), stored
//     interleaved into the complex output.
// Folding T1 - T2 and T3 - T1 - T2 strip by strip gives the reference's
// (t1m - t2m) mod m and (t3m - t1m - t2m) mod m: both are the one
// representative in [0, m) of the same integer.
//
// K7, the residue form: (p, 3, M, K) @ (p, 3, K, N) int8 phase stacks
// [re, im, re+im], one modulus per blockIdx.z, three accumulator sets
// over the whole K (three passes' worth in one), then
// C_re = bal(bal(T1) - bal(T2)), C_im = bal(bal(T3) - bal(T1) - bal(T2))
// as balanced int8 (repro.kernels.ref.scheme2_3m).
//
// Shared memory is what the design is built around. At p = 16, parking the
// three residue tiles of every modulus would take 3 * 16 * 4 KB = 192 KB
// and four float64 strips of 64 x 64 another 128 KB. So only one
// modulus's three accumulator sets are live (48 registers a thread), each
// strip's products are folded into the two C residue tiles of that
// modulus (2 * 16 * 4 KB = 128 KB at p = 16), and the K strip is 32 wide:
// the four staged strips take 33 KB (float32) or 66 KB (float64). At
// p = 16 and float64 one block fits an SM (215 KB).
//
// Bound: a ZGEMM-grade 4096^3 product at p = 16 is 48 int8 GEMMs, about
// 3.3 ms at the int8 peak; the operands (four float64 parts) and the
// output are read and written once, 0.8 ms at 3.35 TB/s. So the work is
// bound by operations, and the kernel as written by its per-element
// integer work: a carve of two parts and a sum per staged element and
// modulus, and a fold of two tiles per strip and modulus. It keeps the
// residues, the (3, p, M, N) int32 products and the 3M combination out of
// device memory, as the paper's Eq. 18 asks; it does not pipeline loads
// or use TMA / wgmma (PERF.md).
//
// Numerics: see scheme2_common.cuh. The plain versions are
// repro_torch.core.complex3m.scaled_matmul (K7g) and
// repro_torch.kernels.ozaki3m.fused_3m_residue_matmul_plain (K7).

#include "scheme2_common.cuh"

using namespace s2;

namespace {

constexpr int BK = 32;
constexpr int LDA = BK + 1;
constexpr int LDB = BN + 1;
constexpr int TILE = BM * BK;   // == BK * BN: one int8 MMA tile
static_assert(BM == BN, "the A and B tiles share a size");

template <typename T>
__host__ __device__ constexpr int strip_bytes() {
  return 2 * (BM * LDA + BK * LDB) * sizeof(typename Num<T>::S);
}

template <typename T, typename O>
__global__ void __launch_bounds__(NT, 1)
emugemm3m_kernel(const T* __restrict__ ar, const T* __restrict__ ai,
                 const T* __restrict__ br, const T* __restrict__ bi,
                 const T* __restrict__ mu, const T* __restrict__ nu, O* __restrict__ out,
                 int M, int N, int K, long long sam, long long sak, long long sbk,
                 long long sbn, const Crt crt) {
  using W = typename Num<T>::W;
  using S = typename Num<T>::S;
  __shared__ __align__(128) int8_t sA[3][TILE];   // phases re, im, re + im
  __shared__ __align__(128) int8_t sB[3][TILE];
  __shared__ __align__(128) int sC[NWARPS][T16];
  __shared__ W sMu[BM];
  __shared__ W sNu[BN];
  extern __shared__ __align__(128) uint8_t dyn[];
  S* sAr = reinterpret_cast<S*>(dyn);             // [BM][LDA]
  S* sAi = sAr + BM * LDA;
  S* sBr = sAi + BM * LDA;                        // [BK][LDB]
  S* sBi = sBr + BK * LDB;
  uint8_t* park_re = dyn + strip_bytes<T>();      // [p][BM * BN]
  uint8_t* park_im = park_re + crt.p * BM * BN;   // [p][BM * BN]

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int p = crt.p;

  for (int i = tid; i < BM; i += NT) sMu[i] = m0 + i < M ? widen(mu[m0 + i]) : W(0);
  for (int i = tid; i < BN; i += NT) sNu[i] = n0 + i < N ? widen(nu[n0 + i]) : W(0);
  for (int i = tid; i < 2 * p * BM * BN / 4; i += NT) reinterpret_cast<int*>(park_re)[i] = 0;
  __syncthreads();

  for (int k0 = 0; k0 < K; k0 += BK) {
    // Integerize the four strips once for all moduli; the real and
    // imaginary parts of an element are neighbours in memory.
    for (int e = tid; e < BM * BK; e += NT) {
      int mm, kk;
      if (sak == 1 || (ai && sak == 2)) { mm = e / BK; kk = e % BK; } else { kk = e / BM; mm = e % BM; }
      const int gm = m0 + mm, gk = k0 + kk;
      const bool in = gm < M && gk < K;
      const long long g = gm * sam + gk * sak;
      sAr[mm * LDA + kk] = in ? integerize(widen(ar[g]), sMu[mm], T()) : S(0);
      sAi[mm * LDA + kk] = in && ai ? integerize(widen(ai[g]), sMu[mm], T()) : S(0);
    }
    for (int e = tid; e < BK * BN; e += NT) {
      int kk, nn;
      if (sbn == 1 || (bi && sbn == 2)) { kk = e / BN; nn = e % BN; } else { nn = e / BK; kk = e % BK; }
      const int gk = k0 + kk, gn = n0 + nn;
      const bool in = gk < K && gn < N;
      const long long g = gk * sbk + gn * sbn;
      sBr[kk * LDB + nn] = in ? integerize(widen(br[g]), sNu[nn], T()) : S(0);
      sBi[kk * LDB + nn] = in && bi ? integerize(widen(bi[g]), sNu[nn], T()) : S(0);
    }
    __syncthreads();

    for (int l = 0; l < p; ++l) {
      const Mod md = modulus(crt.m[l]);
      for (int e = tid; e < BM * BK; e += NT) {
        const int mm = e / BK, kk = e % BK;
        const int8_t r = balanced(sAr[mm * LDA + kk], md);
        const int8_t i = balanced(sAi[mm * LDA + kk], md);
        const int o = a_off(mm, kk);
        sA[0][o] = r;
        sA[1][o] = i;
        sA[2][o] = balanced(int(r) + int(i), md);
      }
      for (int e = tid; e < BK * BN; e += NT) {
        const int kk = e / BN, nn = e % BN;
        const int8_t r = balanced(sBr[kk * LDB + nn], md);
        const int8_t i = balanced(sBi[kk * LDB + nn], md);
        const int o = b_off(kk, nn);
        sB[0][o] = r;
        sB[1][o] = i;
        sB[2][o] = balanced(int(r) + int(i), md);
      }
      __syncthreads();
      FragAcc t1[FW], t2[FW], t3[FW];
      zero(t1);
      zero(t2);
      zero(t3);
      mma_tile<BK>(sA[0], sB[0], t1, warp);
      mma_tile<BK>(sA[1], sB[1], t2, warp);
      mma_tile<BK>(sA[2], sB[2], t3, warp);
      // This strip's T1 - T2 into t1 and T3 - T1 - T2 into t3, element by
      // element (fragments of one type share their element layout). Each
      // strip's products are below BK * 128^2 = 2^19 in magnitude.
#pragma unroll
      for (int f = 0; f < FW; ++f) {
#pragma unroll
        for (int e = 0; e < t1[f].num_elements; ++e) {
          const int x1 = t1[f].x[e], x2 = t2[f].x[e];
          t1[f].x[e] = x1 - x2;
          t3[f].x[e] = t3[f].x[e] - x1 - x2;
        }
      }
      uint8_t* pr = park_re + l * (BM * BN);
      uint8_t* pi = park_im + l * (BM * BN);
      for_each_acc(t1, sC[warp], warp, lane, [&](int row, int col, int v) {
        const int r = floor_mod_small(v, md.m, md.rcp) + pr[row * BN + col];
        pr[row * BN + col] = static_cast<uint8_t>(r >= md.m ? r - md.m : r);
      });
      for_each_acc(t3, sC[warp], warp, lane, [&](int row, int col, int v) {
        const int r = floor_mod_small(v, md.m, md.rcp) + pi[row * BN + col];
        pi[row * BN + col] = static_cast<uint8_t>(r >= md.m ? r - md.m : r);
      });
      __syncthreads();   // the MMA tiles are carved again for the next modulus
    }
  }

  // Two CRTs per element, then times inv = 1 / (mu * nu).
  float rcp[MAXP];
#pragma unroll
  for (int i = 0; i < MAXP; ++i) rcp[i] = i < p ? __fdiv_rn(1.0f, static_cast<float>(crt.m[i])) : 0.f;
  using V = typename Out<O>::V;
  for (int e = tid; e < BM * BN; e += NT) {
    const int row = e / BN, col = e % BN;
    const int gm = m0 + row, gn = n0 + col;
    if (gm >= M || gn >= N) continue;
    const V c_re = crt_element<O>(crt, rcp, [&](int i) { return int(park_re[i * (BM * BN) + e]); });
    const V c_im = crt_element<O>(crt, rcp, [&](int i) { return int(park_im[i * (BM * BN) + e]); });
    const V inv = Out<O>::div(V(1), Out<O>::mul(Out<O>::cvt(sMu[row]), Out<O>::cvt(sNu[col])));
    O* o = out + 2 * (static_cast<long long>(gm) * N + gn);
    Out<O>::store(o, Out<O>::mul(c_re, inv));
    Out<O>::store(o + 1, Out<O>::mul(c_im, inv));
  }
}

// Balanced ((x + m/2) mod m) - m/2 of any int32.
__device__ __forceinline__ int bal(int x, int m, int half) { return floor_mod(x + half, m) - half; }

__global__ void __launch_bounds__(NT)
emugemm3m_residues_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                          int8_t* __restrict__ out_re, int8_t* __restrict__ out_im, int M, int N,
                          int K, long long sap, long long sat, long long sam, long long sak,
                          long long sbp, long long sbt, long long sbk, long long sbn,
                          const Crt crt) {
  constexpr int RBK = 64;
  __shared__ __align__(128) int8_t sA[3][BM * RBK];
  __shared__ __align__(128) int8_t sB[3][RBK * BN];
  __shared__ __align__(128) int sC[NWARPS][T16];

  const int l = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  a += l * sap;
  b += l * sbp;
  out_re += l * M * static_cast<long long>(N);
  out_im += l * M * static_cast<long long>(N);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int m = crt.m[l];
  const int half = m / 2;
  // Four bytes at a time along a unit-stride axis whose rows, phases and
  // base are 4-byte aligned.
  const bool vec_a = sak == 1 && (K & 3) == 0 && (sam & 3) == 0 && (sat & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(a) & 3) == 0;
  const bool vec_b = sbn == 1 && (N & 3) == 0 && (sbk & 3) == 0 && (sbt & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(b) & 3) == 0;

  FragAcc t1[FW], t2[FW], t3[FW];
  zero(t1);
  zero(t2);
  zero(t3);
  for (int k0 = 0; k0 < K; k0 += RBK) {
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const int8_t* at = a + t * sat;
      const int8_t* bt = b + t * sbt;
      if (vec_a) {
        for (int e = tid; e < BM * RBK / 4; e += NT) {
          const int mm = e / (RBK / 4), kk = (e % (RBK / 4)) * 4;
          const int gm = m0 + mm, gk = k0 + kk;
          *reinterpret_cast<int*>(sA[t] + a_off(mm, kk)) =
              gm < M && gk < K ? *reinterpret_cast<const int*>(at + gm * sam + gk) : 0;
        }
      } else {
        for (int e = tid; e < BM * RBK; e += NT) {
          int mm, kk;
          if (sak == 1) { mm = e / RBK; kk = e % RBK; } else { kk = e / BM; mm = e % BM; }
          const int gm = m0 + mm, gk = k0 + kk;
          sA[t][a_off(mm, kk)] = gm < M && gk < K ? at[gm * sam + gk * sak] : int8_t(0);
        }
      }
      if (vec_b) {
        for (int e = tid; e < RBK * BN / 4; e += NT) {
          const int kk = e / (BN / 4), nn = (e % (BN / 4)) * 4;
          const int gk = k0 + kk, gn = n0 + nn;
          *reinterpret_cast<int*>(sB[t] + b_off(kk, nn)) =
              gk < K && gn < N ? *reinterpret_cast<const int*>(bt + gk * sbk + gn) : 0;
        }
      } else {
        for (int e = tid; e < RBK * BN; e += NT) {
          int kk, nn;
          if (sbn == 1) { kk = e / BN; nn = e % BN; } else { nn = e / RBK; kk = e % RBK; }
          const int gk = k0 + kk, gn = n0 + nn;
          sB[t][b_off(kk, nn)] = gk < K && gn < N ? bt[gk * sbk + gn * sbn] : int8_t(0);
        }
      }
    }
    __syncthreads();
    mma_tile<RBK>(sA[0], sB[0], t1, warp);
    mma_tile<RBK>(sA[1], sB[1], t2, warp);
    mma_tile<RBK>(sA[2], sB[2], t3, warp);
    __syncthreads();
  }
  // The 3M combination of the balanced products, element by element.
#pragma unroll
  for (int f = 0; f < FW; ++f) {
#pragma unroll
    for (int e = 0; e < t1[f].num_elements; ++e) {
      const int x1 = bal(t1[f].x[e], m, half), x2 = bal(t2[f].x[e], m, half);
      const int x3 = bal(t3[f].x[e], m, half);
      t1[f].x[e] = bal(x1 - x2, m, half);
      t3[f].x[e] = bal(x3 - x1 - x2, m, half);
    }
  }
  for_each_acc(t1, sC[warp], warp, lane, [&](int row, int col, int v) {
    const int gm = m0 + row, gn = n0 + col;
    if (gm < M && gn < N) out_re[static_cast<long long>(gm) * N + gn] = static_cast<int8_t>(v);
  });
  for_each_acc(t3, sC[warp], warp, lane, [&](int row, int col, int v) {
    const int gm = m0 + row, gn = n0 + col;
    if (gm < M && gn < N) out_im[static_cast<long long>(gm) * N + gn] = static_cast<int8_t>(v);
  });
}

template <typename T, typename O>
int launch(const void* ar, const void* ai, const void* br, const void* bi, const void* mu,
           const void* nu, void* out, int M, int N, int K, long long sam, long long sak,
           long long sbk, long long sbn, const Crt& crt, cudaStream_t stream) {
  constexpr int strip = strip_bytes<T>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(emugemm3m_kernel<T, O>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 strip + 2 * MAXP * BM * BN);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  emugemm3m_kernel<T, O><<<grid, NT, strip + 2 * crt.p * BM * BN, stream>>>(
      static_cast<const T*>(ar), static_cast<const T*>(ai), static_cast<const T*>(br),
      static_cast<const T*>(bi), static_cast<const T*>(mu), static_cast<const T*>(nu),
      static_cast<O*>(out), M, N, K, sam, sak, sbk, sbn, crt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes. Each returns 0 on success, a
// cudaError_t code if the launch was refused, and -1 for arguments that
// have no compiled instance.
//
// K7g: the parts of A (M, K) and B (K, N) through strides in elements of
// the part type (f64 = 1: float64, else float32), shared by each operand's
// real and imaginary part; ai or bi null for a real operand. mu (M) and
// nu (N) contiguous in the part type; out (M, N) complex, contiguous,
// float64 parts if out_f64 else float32. moduli[p] and the Garner table
// inv[p * p] are host arrays.
extern "C" int emugemm3m(const void* ar, const void* ai, const void* br, const void* bi,
                         const void* mu, const void* nu, void* out, int M, int N, int K,
                         long long sam, long long sak, long long sbk, long long sbn, int f64,
                         int out_f64, int p, const int* moduli, const int* inv, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return -1;
  Crt crt;
  if (make_crt(p, moduli, inv, crt) != 0) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define EMUGEMM3M_LAUNCH(T_, O_) \
  return launch<T_, O_>(ar, ai, br, bi, mu, nu, out, M, N, K, sam, sak, sbk, sbn, crt, st)
  if (f64 && out_f64) EMUGEMM3M_LAUNCH(double, double);
  if (f64) EMUGEMM3M_LAUNCH(double, float);
  if (out_f64) EMUGEMM3M_LAUNCH(float, double);
  EMUGEMM3M_LAUNCH(float, float);
#undef EMUGEMM3M_LAUNCH
}

// K7: a3 (p, 3, M, K) and b3 (p, 3, K, N) int8 through strides; out_re and
// out_im (p, M, N) int8 contiguous.
extern "C" int emugemm3m_residues(const int8_t* a, const int8_t* b, int8_t* out_re,
                                  int8_t* out_im, int M, int N, int K, long long sap,
                                  long long sat, long long sam, long long sak, long long sbp,
                                  long long sbt, long long sbk, long long sbn, int p,
                                  const int* moduli, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return -1;
  Crt crt;
  if (make_crt(p, moduli, nullptr, crt) != 0) return -1;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, p);
  emugemm3m_residues_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, out_re, out_im, M, N, K, sap, sat, sam, sak, sbp, sbt, sbk, sbn, crt);
  return static_cast<int>(cudaGetLastError());
}
