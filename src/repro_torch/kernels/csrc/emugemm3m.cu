// EmuGEMM-II 3M on residues for Hopper (sm_90a): K7.
//
// Replaces the Pallas kernel of the JAX package
//   src/repro/kernels/ozaki3m.py       fused_3m_residue_matmul (_kernel)     -> emugemm3m_residues (K7)
// (K7g, gpu.py fused_matmul_3m, the 3M product from the float parts, runs
// on the plane route of emugemm2_planes.cu). The 3M identity in modular
// arithmetic (paper Sec. IV-B):
//   T1 = Ar'Br', T2 = Ai'Bi', T3 = (Ar' + Ai')(Br' + Bi')      (mod m)
//   C_re = T1 - T2,  C_im = T3 - T1 - T2                          (mod m, exact)
//
// K7, the residue form: (p, 3, M, K) @ (p, 3, K, N) int8 phase stacks
// [re, im, re+im], one modulus per blockIdx.z, three accumulator sets
// (wmma s8 16x16x16 fragments, 48 registers a thread) over the whole K,
// then C_re = bal(bal(T1) - bal(T2)), C_im = bal(bal(T3) - bal(T1) -
// bal(T2)) as balanced int8 (repro.kernels.ref.scheme2_3m).
//
// Bound: at 4096^3 and p = 16 the 48 int8 GEMMs take 3.3 ms at the int8
// peak, and the residues in and out (2.1 GB) 0.64 ms at 3.35 TB/s; the
// kernel loads its tiles without pipelining and uses wmma, not wgmma
// (PERF.md).
//
// Numerics: see scheme2_common.cuh. The plain version is
// repro_torch.kernels.ozaki3m.fused_3m_residue_matmul_plain.

#include "scheme2_common.cuh"

using namespace s2;

namespace {

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

}  // namespace

// Plain C entry points, bound with ctypes. Each returns 0 on success, a
// cudaError_t code if the launch was refused, and -1 for arguments that
// have no compiled instance.
//
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
