// The plain tiled int8 GEMM for Hopper (sm_90a): (M, K) int8 @ (K, N) int8
// -> (M, N) int32, exact, the int32 sums wrapping as the reference's do.
//
// Replaces the Pallas kernel of the JAX package
//   src/repro/kernels/matmul_int8.py  int8_matmul (_kernel)
// the "native INT8" baseline that a naive emulation composes p(p+1)/2
// launches of (paper Fig. 4), each writing its int32 product to device
// memory.
//
// What one block computes, for its (BM, BN) output tile: a loop over K in
// steps of BK, each staging a (BM, BK) tile of A and a (BK, BN) tile of B
// in shared memory as 16x16 sub-tiles (256 bytes each, so every wmma load
// is 32-byte aligned with a leading dimension of 16), then int8 tensor-core
// MMAs (wmma s8 16x16x16, compiled to mma.sync) into int32 fragments held
// in registers: eight warps in a 2 x 4 grid, each owning a 64 x 32 block of
// the tile. The next K step's tiles are loaded into registers while the
// current one multiplies (two shared buffers, one barrier a step). Rows,
// columns and K past the edge are staged as zeros, so M, N and K are the
// logical sizes: the reference asks for 128-aligned shapes, this kernel
// takes any.
//
// Bound: operations at the shapes the baseline runs (2MNK at the int8 peak,
// about 69 us for 4096^3 on an H100 SXM, against 84 MB moved, 25 us). The
// kernel uses mma.sync, not wgmma, and keeps one tile in flight, so it
// stays well above that bound (PERF.md).

#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int NWARPS = 8;
constexpr int NT = NWARPS * 32;
constexpr int WM = 64;               // rows of the tile per warp
constexpr int WN = 32;               // columns of the tile per warp
constexpr int FM = WM / 16;
constexpr int FN = WN / 16;
constexpr int T16 = 16 * 16;
constexpr int CHUNKS_A = BM * BK / 16;   // 16-byte chunks per tile
constexpr int CHUNKS_B = BK * BN / 16;
constexpr int RA = CHUNKS_A / NT;        // chunks per thread
constexpr int RB = CHUNKS_B / NT;
static_assert(CHUNKS_A % NT == 0 && CHUNKS_B % NT == 0, "tiles split evenly");

// One 16-byte chunk of a row of a row-major int8 matrix (rows x cols,
// row stride ld): the whole chunk where it lies inside and the matrix is
// 16-byte aligned, else byte by byte with zeros past the edge.
__device__ __forceinline__ int4 load_chunk(const int8_t* __restrict__ x, int rows, int cols,
                                           long long ld, int r, int c, bool vec) {
  if (r < rows && c + 16 <= cols && vec)
    return *reinterpret_cast<const int4*>(x + r * ld + c);
  int4 v = make_int4(0, 0, 0, 0);
  if (r < rows) {
    int8_t* b = reinterpret_cast<int8_t*>(&v);
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (c + j < cols) b[j] = x[r * ld + c + j];
  }
  return v;
}

__global__ void __launch_bounds__(NT)
int8_gemm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                 int* __restrict__ out, int M, int N, int K, long long lda,
                 long long ldb, int vec_a, int vec_b) {
  // Sub-tile layouts: A (BM/16, BK/16) tiles, B (BK/16, BN/16) tiles.
  __shared__ __align__(128) int8_t sA[2][BM * BK];
  __shared__ __align__(128) int8_t sB[2][BK * BN];
  __shared__ __align__(128) int sC[NWARPS][T16];

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = (warp / (BN / WN)) * WM;
  const int wn = (warp % (BN / WN)) * WN;

  int4 ra[RA], rb[RB];
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < RA; ++j) {
      const int c = tid + j * NT;
      const int mm = c / (BK / 16), kk = (c % (BK / 16)) * 16;
      ra[j] = load_chunk(a, M, K, lda, m0 + mm, k0 + kk, vec_a);
    }
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      const int c = tid + j * NT;
      const int kk = c / (BN / 16), nn = (c % (BN / 16)) * 16;
      rb[j] = load_chunk(b, K, N, ldb, k0 + kk, n0 + nn, vec_b);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int j = 0; j < RA; ++j) {
      const int c = tid + j * NT;
      const int mm = c / (BK / 16), kk = (c % (BK / 16)) * 16;
      const int off = ((mm / 16) * (BK / 16) + kk / 16) * T16 + (mm % 16) * 16;
      *reinterpret_cast<int4*>(sA[buf] + off) = ra[j];
    }
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      const int c = tid + j * NT;
      const int kk = c / (BN / 16), nn = (c % (BN / 16)) * 16;
      const int off = ((kk / 16) * (BN / 16) + nn / 16) * T16 + (kk % 16) * 16;
      *reinterpret_cast<int4*>(sB[buf] + off) = rb[j];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0);

  const int steps = (K + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) load((s + 1) * BK);
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], sA[buf] + (((wm / 16) + i) * (BK / 16) + ks) * T16, 16);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], sB[buf] + (ks * (BN / 16) + (wn / 16) + j) * T16, 16);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    if (s + 1 < steps) store(buf ^ 1);
    __syncthreads();
  }

  // Epilogue: a fragment inside the matrix goes straight out where the
  // row length keeps it 32-byte aligned; an edge fragment goes through a
  // per-warp staging tile whose (row-major) layout is known.
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      const int gm = m0 + wm + i * 16, gn = n0 + wn + j * 16;
      if (gm >= M || gn >= N) continue;
      if (gm + 16 <= M && gn + 16 <= N && (N & 7) == 0) {
        wmma::store_matrix_sync(out + static_cast<long long>(gm) * N + gn, acc[i][j], N,
                                wmma::mem_row_major);
      } else {
        wmma::store_matrix_sync(sC[warp], acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < T16; e += 32) {
          const int r = gm + e / 16, c = gn + e % 16;
          if (r < M && c < N) out[static_cast<long long>(r) * N + c] = sC[warp][e];
        }
        __syncwarp();
      }
    }
}

}  // namespace

// Plain C entry point, bound with ctypes: A (M, K) and B (K, N) row-major
// int8 with row strides lda and ldb, out (M, N) int32 contiguous. Returns 0
// on success, a cudaError_t code if the launch was refused, and -1 for bad
// sizes.
extern "C" int int8_matmul(const void* a, const void* b, void* out, int M, int N, int K,
                           long long lda, long long ldb, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return -1;
  const int vec_a = (lda % 16 == 0) && (reinterpret_cast<uintptr_t>(a) % 16 == 0);
  const int vec_b = (ldb % 16 == 0) && (reinterpret_cast<uintptr_t>(b) % 16 == 0);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_gemm_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), static_cast<int*>(out), M,
      N, K, lda, ldb, vec_a, vec_b);
  return static_cast<int>(cudaGetLastError());
}
