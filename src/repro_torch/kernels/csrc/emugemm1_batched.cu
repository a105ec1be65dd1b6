// EmuGEMM-I's batched form for Hopper (sm_90a): the fused Ozaki Scheme-I
// GEMM strided over a batch, one launch a call, on int8 wgmma.
//
// Replaces the Pallas kernel of the JAX package
//   src/repro/kernels/backends/gpu.py  fused_matmul_scheme1_batched (_kernel)
// the paper's fused design: each K step is carved in the kernel, the
// triangular schedule runs into p int32 accumulators, and the shift-reduce
// is the epilogue. Its callers are attention's scores and values under
// Scheme I (serving's attn_qk and attn_av: a batch of 4 lanes x 16 KV
// heads, 16 query rows in a mixed step and 1 in a decode step, K and N the
// head dim 128 and the cached view's length) and the batched front doors.
//
// Orientation. wgmma takes 64 rows on its A side and a multiple of 8 on
// its n side, and attention's M is small, so a block computes C^T: its 64
// rows are 64 columns of C (B^T on wgmma's A side, n0 .. n0 + 63) and its
// n side is NB rows of C (A on wgmma's B side, m0 .. m0 + NB - 1), NB = 16
// for M <= 16 and 32 above. The accumulators of all p diagonals fit one
// warpgroup's registers (MAXP x NB / 2 a thread), so the kernel makes one
// pass over K, the paper's triangular schedule without re-reading, and
// stores C^T's tile transposed. The per-element sums and the fold order do
// not depend on the orientation, so the bits are those of C.
//
// One block of one warpgroup per (batch element, output tile); its K loop
// walks K in chunks of 128:
//   * all 128 threads load the chunk's float tiles (B^T: 64 x 128, A: NB x
//     128) through the operands' batch, row and column strides, along the
//     unit-stride axis (16 bytes a thread where K is that axis and the rows
//     are aligned, else coalesced across rows), a thread's loads and row
//     scales all in flight before its first carve (a chunk waits about one
//     load latency, which at serving's shapes is most of a block's time),
//     scale each element by the exact reciprocal of its power-of-two
//     scale, carve it once into p slices, and store 8 K bytes of a slice a
//     thread into the chunk's shared planes, in the 128-byte swizzle that
//     wgmma's K-major descriptors read (a transposed view, such as the key
//     cache, is transposed on the way in);
//   * the warpgroup issues the chunk's wgmma m64nNBk32 s32.s8.s8 products,
//     C_s += B'^T_i A'_{s-i}, and carves the next chunk into the other of
//     two buffers while they run; rows, columns and K past the edge carve
//     to zeros;
//   * last, the shift-reduce c = sum_s 2^(-beta (s + 2)) C_s, highest weight
//     first, then c mu, then c nu (both loaded before the K loop), rounded
//     as the output type, and one store of each element.
// Bound: at serving's shapes the work is a few hundred bytes and 10 small
// int8 products a block, so launch latency and the one pass of load, carve
// and products set the time; at training's shapes the carve (B^T is carved
// again for every NB rows of A, A for every 64 columns of B) and the int8
// products.
//
// Numerics, so that the result is bit-identical to the plain version
// (repro_torch.kernels.ozaki1.fused_matmul_plain), as in every Scheme-I
// kernel here (scheme1_common.cuh): no .satfinite, so the int32 sums wrap
// as the reference's do; the fold adds the highest weight first, then
// multiplies by mu, then by nu; _rn intrinsics only; exponent-field powers
// of two (x * (1 / s) rounds as x / s for a power of two s); a bf16 output
// rounds after every op; the scales and beta come from the caller,
// computed from the logical K.

#include <algorithm>

#include "hopper.cuh"
#include "scheme1_common.cuh"

using namespace hopper;
using namespace scheme1;

namespace {

constexpr int XR = 64;            // rows of wgmma's A side: columns of C
constexpr int KC = 128;           // K chunk: one 128-byte swizzle row
constexpr int NT = 128;           // one warpgroup

// The shared planes of one K chunk: p slices of B^T (64 x 128 bytes each),
// then p slices of A (NB x 128 bytes each), every plane 1024-aligned.
template <int NB>
struct Chunk {
  static constexpr int X_BYTES = XR * KC;
  static constexpr int Y_BYTES = NB * KC;
  static __host__ __device__ constexpr int bytes(int p) { return p * (X_BYTES + Y_BYTES); }
  static __host__ __device__ constexpr int smem(int p, int buffers) {
    return 1024 + buffers * bytes(p);
  }
};

// Byte (r, kb) of a K-major tile of 128-byte rows in the 128-byte swizzle:
// 16-byte chunk kb / 16 of row r lands at chunk (kb / 16) ^ (r % 8).
__device__ __forceinline__ int swizzled(int r, int kb) {
  return r * KC + ((((kb >> 4) ^ (r & 7)) << 4) | (kb & 15));
}

template <typename T>
struct Vec;   // eight elements in 16-byte loads
template <>
struct Vec<float> {
  static __device__ __forceinline__ void load(const float* x, float (&v)[8]) {
    const float4 a = *reinterpret_cast<const float4*>(x);
    const float4 b = *reinterpret_cast<const float4*>(x + 4);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* x, float (&v)[8]) {
    const uint4 a = *reinterpret_cast<const uint4*>(x);
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = __uint_as_float(w[j] << 16);
      v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
};

// One operand tile of a K chunk: R rows, row r and K index k at
// x[r * sr + k * sk] (zero for r >= rows or k >= kn), with its rows'
// power-of-two scales. Threads walk the unit-stride axis (kwalk: K), with
// 16-byte loads where vec.
template <typename T>
struct Tile {
  const T* x;
  const float* scale;
  long long sr, sk;
  int rows;
  bool kwalk, vec;
};

// Load unit u of an R-row tile (8 consecutive K of one row, 16 units a
// row): its elements and the reciprocal of its row's scale, and where its
// bytes go in each shared plane.
template <typename T, int R>
__device__ __forceinline__ void load_unit(const Tile<T>& t, int kn, int u, float (&v)[8],
                                          float& inv, int& off) {
  const int r = t.kwalk ? u / (KC / 8) : u % R;
  const int g = t.kwalk ? u % (KC / 8) : u / R;
  const int k = 8 * g;
  off = swizzled(r, k);
  inv = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = 0.f;
  if (r >= t.rows || k >= kn) return;
  inv = recip_pow2(t.scale[r]);
  const T* src = t.x + r * t.sr + k * t.sk;
  if (t.vec && k + 8 <= kn) {
    Vec<T>::load(src, v);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = k + j < kn ? widen(src[j * t.sk]) : 0.f;
  }
}

// Scale a loaded unit, carve it, and store its p slices (8 bytes each).
__device__ __forceinline__ void carve_unit(float (&v)[8], float inv, uint8_t* dst, int plane,
                                           int p, float two_beta) {
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __fmul_rn(v[j], inv);
  carve8(v, two_beta, p,
         [&](int i, uint2 w) { *reinterpret_cast<uint2*>(dst + i * plane) = w; });
}

// Carve one K chunk of B^T's tile (XR rows) and A's (NB rows) into their
// shared planes: a thread's units of both, UX + UY, in batches whose loads
// are all issued before the first is carved, so that a chunk waits about
// one load latency (two batches at NB = 32, whose accumulators leave
// fewer registers: its instances spill 48-56 bytes, and three batches
// spilled more at the same speed).
template <typename T, int NB>
__device__ __forceinline__ void carve_chunk(const Tile<T>& tx, const Tile<T>& ty, int kn,
                                            uint8_t* x_planes, uint8_t* y_planes, int p,
                                            float two_beta) {
  constexpr int UX = XR * (KC / 8) / NT, UY = NB * (KC / 8) / NT;
  constexpr int U = UX + UY, BATCH = NB == 16 ? U : U / 2;
  static_assert(U % BATCH == 0, "batches must split the units");
#pragma unroll
  for (int q0 = 0; q0 < U; q0 += BATCH) {
    float v[BATCH][8], inv[BATCH];
    int off[BATCH];
#pragma unroll
    for (int q = 0; q < BATCH; ++q) {
      const int u = q0 + q;
      if (u < UX)
        load_unit<T, XR>(tx, kn, threadIdx.x + u * NT, v[q], inv[q], off[q]);
      else
        load_unit<T, NB>(ty, kn, threadIdx.x + (u - UX) * NT, v[q], inv[q], off[q]);
    }
#pragma unroll
    for (int q = 0; q < BATCH; ++q) {
      if (q0 + q < UX)
        carve_unit(v[q], inv[q], x_planes + off[q], Chunk<NB>::X_BYTES, p, two_beta);
      else
        carve_unit(v[q], inv[q], y_planes + off[q], Chunk<NB>::Y_BYTES, p, two_beta);
    }
  }
}

struct Strides {
  long long ab, am, ak, bb, bk, bn;
};

// flags: bit 0, A's K axis is unit-stride with 16-byte aligned rows; bit 1,
// the same of B; bit 2, A is walked along K; bit 3, B is walked along K.
template <typename T, typename O, int NB>
__global__ void __launch_bounds__(NT, 1)
emugemm1_batched_kernel(const T* __restrict__ a, const T* __restrict__ b,
                        const float* __restrict__ mu, const float* __restrict__ nu,
                        O* __restrict__ out, int M, int N, int K, int tiles_m, int tiles_n,
                        Strides st, int p, int beta, int flags) {
  using CH = Chunk<NB>;
  extern __shared__ __align__(16) uint8_t chunk_smem[];
  const uint32_t pad = (1024 - (smem_u32(chunk_smem) & 1023)) & 1023;
  uint8_t* buffers = chunk_smem + pad;
  const int nch = (K + KC - 1) / KC;
  const int chunk_bytes = CH::bytes(p);

  const int tile = blockIdx.x;
  const int n0 = (tile % tiles_n) * XR;
  const int m0 = (tile / tiles_n % tiles_m) * NB;
  const long long bz = tile / tiles_n / tiles_m;
  mu += bz * M + m0;
  nu += bz * N + n0;
  const Tile<T> tx{b + bz * st.bb + n0 * st.bn, nu, st.bn, st.bk, N - n0,
                   (flags & 8) != 0, (flags & 2) != 0};
  const Tile<T> ty{a + bz * st.ab + m0 * st.am, mu, st.am, st.ak, M - m0,
                   (flags & 4) != 0, (flags & 1) != 0};

  // The epilogue's scales, loaded now. Register 4 j + 2 h + e of the
  // fragment is row 16 warp + lane / 4 + 8 h (a column n of C) and column
  // 8 j + 2 (lane % 4) + e (a row m of C).
  const int tid = threadIdx.x, lane = tid % 32;
  const int nr = (tid / 32) * 16 + lane / 4, mc = 2 * (lane % 4);
  float nv[2], mv[NB / 8][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) nv[h] = n0 + nr + 8 * h < N ? nu[nr + 8 * h] : 0.f;
#pragma unroll
  for (int j = 0; j < NB / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) mv[j][e] = m0 + 8 * j + mc + e < M ? mu[8 * j + mc + e] : 0.f;

  const float two_beta = pow2(beta);
  int acc[MAXP][NB / 2];
#pragma unroll
  for (int s = 0; s < MAXP; ++s)
#pragma unroll
    for (int e = 0; e < NB / 2; ++e) acc[s][e] = 0;

  for (int t = 0; t < nch; ++t) {
    uint8_t* x_planes = buffers + (t & 1) * chunk_bytes;
    uint8_t* y_planes = x_planes + p * CH::X_BYTES;
    const int k0 = t * KC;
    Tile<T> cx = tx, cy = ty;
    cx.x += k0 * st.bk;
    cy.x += k0 * st.ak;
    carve_chunk<T, NB>(cx, cy, min(KC, K - k0), x_planes, y_planes, p, two_beta);
    fence_proxy_async();
    __syncthreads();
#pragma unroll
    for (int s = 0; s < MAXP; ++s) reg_fence(acc[s]);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < MAXP; ++s) {
      if (s >= p) break;
#pragma unroll
      for (int i = 0; i <= s; ++i) {
        const uint64_t dx = desc_sw128(x_planes + i * CH::X_BYTES);
        const uint64_t dy = desc_sw128(y_planes + (s - i) * CH::Y_BYTES);
#pragma unroll
        for (int ks = 0; ks < KC / 32; ++ks) wgmma_s8<NB>(acc[s], dx + 2 * ks, dy + 2 * ks);
      }
    }
    wgmma_commit();
    // The previous chunk's products are done once at most this group is
    // in flight; once every warp has seen that, its buffer takes the next
    // chunk's carve.
    wgmma_wait<1>();
#pragma unroll
    for (int s = 0; s < MAXP; ++s) reg_fence(acc[s]);
    __syncthreads();
  }
  wgmma_wait_all();
#pragma unroll
  for (int s = 0; s < MAXP; ++s) reg_fence(acc[s]);

  float c[NB / 2];
#pragma unroll
  for (int e = 0; e < NB / 2; ++e) c[e] = 0.f;
#pragma unroll
  for (int s = 0; s < MAXP; ++s) {
    if (s >= p) break;
    const float w = pow2(-beta * (s + 2));
#pragma unroll
    for (int e = 0; e < NB / 2; ++e) c[e] = Epilogue<O>::step(c[e], acc[s][e], w);
  }
  out += bz * M * static_cast<long long>(N) + static_cast<long long>(m0) * N + n0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = nr + 8 * h;
    if (n0 + n >= N) continue;
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 8 * j + mc + e;
        if (m0 + m < M)
          Epilogue<O>::store(out + static_cast<long long>(m) * N + n,
                             Epilogue<O>::scale(c[4 * j + 2 * h + e], mv[j][e], nv[h]));
      }
    }
  }
}

template <typename T, typename O, int NB>
int launch(const void* a, const void* b, const float* mu, const float* nu, void* out, int batch,
           int M, int N, int K, const Strides& st, int p, int beta, int flags,
           cudaStream_t stream) {
  using CH = Chunk<NB>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(emugemm1_batched_kernel<T, O, NB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, CH::smem(MAXP, 2));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int tiles_m = (M + NB - 1) / NB, tiles_n = (N + XR - 1) / XR;
  const long long blocks = static_cast<long long>(batch) * tiles_m * tiles_n;
  if (blocks > 0x7fffffffLL) return -1;
  const int smem = CH::smem(p, std::min((K + KC - 1) / KC, 2));
  emugemm1_batched_kernel<T, O, NB><<<static_cast<int>(blocks), NT, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), mu, nu, static_cast<O*>(out), M, N, K,
      tiles_m, tiles_n, st, p, beta, flags);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte rows along K: the K axis is unit-stride and every row and batch
// start, and the base, 16-byte aligned.
bool vec_rows(const void* x, long long sb, long long sr, long long sk, int elt) {
  return sk == 1 && (sr * elt) % 16 == 0 && (sb * elt) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

template <typename T>
int launch_out(int out_type, int nb, const void* a, const void* b, const float* mu,
               const float* nu, void* out, int batch, int M, int N, int K, const Strides& st,
               int p, int beta, cudaStream_t stream) {
  const int elt = sizeof(T);
  const int flags = (vec_rows(a, st.ab, st.am, st.ak, elt) ? 1 : 0) |
                    (vec_rows(b, st.bb, st.bn, st.bk, elt) ? 2 : 0) | (st.ak <= st.am ? 4 : 0) |
                    (st.bk <= st.bn ? 8 : 0);
#define EMUGEMM1_BATCHED(O_, NB_) \
  return launch<T, O_, NB_>(a, b, mu, nu, out, batch, M, N, K, st, p, beta, flags, stream)
  if (out_type == F32 && nb == 16) EMUGEMM1_BATCHED(float, 16);
  if (out_type == F32 && nb == 32) EMUGEMM1_BATCHED(float, 32);
  if (out_type == BF16 && nb == 16) EMUGEMM1_BATCHED(__nv_bfloat16, 16);
  if (out_type == BF16 && nb == 32) EMUGEMM1_BATCHED(__nv_bfloat16, 32);
#undef EMUGEMM1_BATCHED
  return -1;
}

}  // namespace

// Plain C entry point, bound with ctypes; returns 0 on success, a
// cudaError_t code if the launch was refused, -1 for arguments that have no
// compiled instance.
//
// a (batch, M, K) and b (batch, K, N) float32 or bfloat16 (in_type: 0, 1)
// through strides in elements (sab, sam, sak), (sbb, sbk, sbn), all >= 0;
// mu (batch, M) and nu (batch, N) float32 powers of two, contiguous; out
// (batch, M, N) contiguous, float32 or bfloat16 (out_type: 0, 1); nb, the
// tile's rows of C, 16 or 32.
extern "C" int emugemm1_batched(const void* a, const void* b, const float* mu, const float* nu,
                                void* out, int batch, int M, int N, int K, long long sab,
                                long long sam, long long sak, long long sbb, long long sbk,
                                long long sbn, int in_type, int out_type, int p, int beta,
                                int nb, void* stream) {
  if (batch <= 0 || M <= 0 || N <= 0 || K <= 0) return -1;
  if (p < 1 || p > MAXP || beta < 1 || beta > 7) return -1;
  const Strides st{sab, sam, sak, sbb, sbk, sbn};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_type == F32)
    return launch_out<float>(out_type, nb, a, b, mu, nu, out, batch, M, N, K, st, p, beta, s);
  if (in_type == BF16)
    return launch_out<__nv_bfloat16>(out_type, nb, a, b, mu, nu, out, batch, M, N, K, st, p,
                                     beta, s);
  return -1;
}
