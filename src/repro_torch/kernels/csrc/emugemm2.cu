// EmuGEMM-II's residue form for Hopper (sm_90a): K5.
//
// Replaces the Pallas kernel of the JAX package
//   src/repro/kernels/ozaki2.py        fused_residue_matmul (_kernel), residue launch
// (the Scheme-II products of float operands, K5g and K6, 2-D or batched,
// with a float or a prepared rhs, run on the plane route of
// emugemm2_planes.cu). The residue form takes the (p, M, K) and (p, K, N)
// balanced int8 residues of two operands, read through strides, and
// writes the balanced int8 residues ((acc + m/2) mod m) - m/2 of their
// products, (p, M, N): one modulus per blockIdx.z, one (BM, BN) = (64,
// 64) output tile a block, K strips of 64 staged four bytes at a time
// where the layout allows, int8 tensor-core MMAs (wmma s8 16x16x16) into
// one int32 accumulator set over the whole K (repro.kernels.ref.
// scheme2_residues). Rows, columns and K steps past the edge are staged
// as zeros. It serves the library's residue route (kernels/ops.py); no
// model path launches it.
//
// Bound: at 4096^3 and p = 16 the 16 int8 GEMMs take 1.1 ms at the int8
// peak; the kernel loads its tiles without pipelining and uses wmma, not
// wgmma (PERF.md).
//
// Numerics: see scheme2_common.cuh. The plain version is
// repro_torch.kernels.ozaki2.fused_residue_matmul_plain.

#include "scheme2_common.cuh"

using namespace s2;

namespace {

constexpr int BK = 64;          // the K strip

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

}  // namespace

// Plain C entry point, bound with ctypes. Returns 0 on success, a
// cudaError_t code if the launch was refused, and -1 for arguments that
// have no compiled instance.
//
// a_res (p, M, K) and b_res (p, K, N) int8 through strides; out (p, M, N)
// int8 contiguous; moduli[p] is a host array.
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
