// EmuGEMM-I's plane route for Hopper (sm_90a): Ozaki Scheme I as an encode
// kernel and a TMA-fed int8 wgmma plane GEMM, and the interleaved form's
// relayout into the plane GEMM's planes.
//
// Replaces the Pallas kernels of the JAX package
//   src/repro/kernels/ozaki1.py        fused_matmul_prologue (_kernel, a_fp=b_fp=True)
//   src/repro/kernels/backends/gpu.py  fused_matmul_scheme1 (_kernel), 2-D launch
//   src/repro/kernels/ozaki1.py        fused_matmul_mixed (_kernel, a_fp only)
//   src/repro/kernels/ozaki1.py        fused_matmul_interleaved (_kernel, neither operand float)
//   src/repro/kernels/matmul_int8.py   int8_matmul (_kernel), the int8 GEMM (K9)
// (the batched launch is emugemm1_batched.cu). A 2-D product is two
// encodes and one plane GEMM; the mixed form, whose rhs is a prepared
// weight, one encode of the lhs and one plane GEMM against the planes that
// an encode wrote once, when the weight was prepared (kernels/prepared.py,
// layout 'planes'); the interleaved form, whose operands arrive sliced and
// interleaved on K (A-hat, B-hat), a relayout of each into planes and one
// plane GEMM, mu and nu entering only in its epilogue. The int8 GEMM (K9)
// is the plane GEMM's int32 instance at p = 1 (below).
//
// encode: one pass over a float32, bf16 or float64 operand (R, K), read
// through its strides, with a power-of-two row scale s (float32, or float64
// for a float64 operand: mu of A; B enters as B^T with nu^T, the twin as B
// with tau), writes its p carved slices (p <= 16) as K-contiguous
// int8 planes (p, R, Kp), Kp = K padded with zero slices to the plane
// GEMM's K tile. Each element is read, scaled and carved once (the fused
// kernel it replaces carved each A tile N / 64 times and each B tile M / 64
// times): x * (1 / s), the reciprocal exact from s's exponent field (a
// product by an exact power of two rounds as the quotient does), then the
// truncate-subtract recurrence of repro.kernels.common.carve_slices, every
// op an _rn intrinsic. A bf16 element widens to float32 exactly on load; a
// float64 one is carved in float64 (scheme1_common.cuh). Bound by bytes:
// (in + p) bytes an element, (8 + p) in float64.
//
// planes: one block per (BM, 128) output tile, BM = 128 (two consumer
// warpgroups) or 64 (one, for M <= 64: serving's rows), and one producer
// warpgroup:
//   * one producer thread keeps a ring of 6 shared stages filled by TMA
//     (cp.async.bulk.tensor, 128-byte swizzle, mbarriers): the (BM, 128) A
//     tile of slice plane i and the (128, 128) B tile of plane s - i at one
//     K tile, 32 KB a stage at BM = 128; the tensor maps are 3-D (Kp, rows,
//     planes), so rows past M or N arrive as zeros;
//   * the consumers run wgmma m64n128k32 s32.s8.s8 on the arrived tiles,
//     diagonal-outer and K-inner: for s = 0..p-1 one int32 accumulator set
//     (64 registers a thread) covers the whole K of the s + 1 slice
//     products A'_i B'_{s-i} of diagonal s, and is then folded into the
//     running float result, c = c + 2^(-beta (s + 2)) C_s, highest weight
//     first, before the next diagonal starts; one wgmma group stays in
//     flight while the next stage is awaited;
//   * last, c * mu * nu, rounded as the output type (float32, bf16,
//     float16 or float64), stored from registers.
// The p(p+1)/2 plane-pair passes re-read the planes from L2 and never carve;
// p runs to 16 (136 passes), which only lengthens the loop.
// A float64 output keeps its running sum in float64 and takes float64 mu
// and nu: 64 float64 partial results would be 128 registers beside the 64
// accumulators, past the 168 a 384-thread block may use, so its tile is
// (BM, 64) on wgmma m64n64k32 (32 accumulators and 32 float64 partials,
// 64 + 32 registers a consumer thread) and its stage 24 KB at BM = 128.
// The accumulators wrap as int32 adds do (no .satfinite), as the
// reference's triangular_accumulators: a diagonal of s + 1 products can
// pass 2^31 (4 * 50688 * 127^2 at the tied head's dA), and addition modulo
// 2^32 gives the same bits in any order.
// Bound: a (1024, 2048) @ (2048, 2048) GEMM at p = 4 is 10 int8 GEMMs,
// 43 us at the int8 peak. Registers: 64 accumulators and 64 partial results
// a consumer thread, within the 168 a 384-thread block may use. Serving's
// M = 4 and 64 rows run one tile row (BM = 64) over N / 128 tiles, so the
// grid fills few SMs (PERF.md measures both).
//
// The int8 GEMM (K9), (M, K) int8 @ (K, N) int8 -> (M, N) int32: the same
// kernel at p = 1 with an int32 output type, whose epilogue stores the raw
// accumulator (no fold, no mu or nu) as 8-byte pairs, on a (128, 256)
// output tile (two column halves of m64n128k32 a consumer, 4 stages of
// 48 KB) where M > 64: its consumers hold no float partial results, so
// 128 accumulators fit; A, and B^T, are each a single plane. An operand whose rows are K-contiguous with a 16-byte
// aligned base and row stride is read in place through its tensor map (K
// past the edge arrives as zeros); otherwise one relayout (below, at p = 1
// with a logical K) writes its (1, R, Kpp) plane first: B (K, N) as it
// arrives, N-contiguous, always. Bound: operations at large shapes, 2 M N K
// at the int8 peak (4096^3: 69 us); the int32 output (4 M N bytes) is
// written in series with the mainloop on a one-block-per-SM grid.
//
// Numerics, so that the result is bit-identical to the plain versions
// (repro_torch.kernels.ozaki1.encode_planes_plain, plane_matmul_plain):
//   * exact powers of two come from the exponent field, never exp2f;
//   * every float op is an explicit _rn intrinsic, so nvcc cannot contract
//     the fold into an FMA;
//   * int32 -> bf16 rounds through fp32 (RNE twice), as torch does, and a
//     bf16 output rounds after every op, as the reference shift_reduce does;
//   * the scales and beta come from the caller, computed from the logical K.

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"
#include "scheme1_common.cuh"

using namespace hopper;
using namespace scheme1;

namespace {

// ---- encode ----------------------------------------------------------------

constexpr int ER = 64;           // rows of an encode block
constexpr int EK = 64;           // K columns of an encode block
constexpr int ELD = EK + 1;      // staged row stride, padded against bank conflicts
constexpr int ENT = 256;

template <typename T>
__global__ void __launch_bounds__(ENT)
emugemm1_encode_kernel(const T* __restrict__ x, const typename Work<T>::type* __restrict__ scale,
                       int8_t* __restrict__ planes, int R, int K, int Kp, long long sr,
                       long long sk, int p, int beta) {
  using W = typename Work<T>::type;
  __shared__ W sx[ER * ELD];
  __shared__ W sinv[ER];
  const int r0 = blockIdx.y * ER;
  const int k0 = blockIdx.x * EK;
  const int tid = threadIdx.x;
  if (tid < ER) sinv[tid] = r0 + tid < R ? recip_pow2(scale[r0 + tid]) : W(0);
  __syncthreads();

  // Scale the tile once; threads walk the operand's unit-stride axis.
  const bool kwalk = sk <= sr;
#pragma unroll 4
  for (int e = tid; e < ER * EK; e += ENT) {
    const int rr = kwalk ? e / EK : e % ER;
    const int kk = kwalk ? e % EK : e / ER;
    const int gr = r0 + rr, gk = k0 + kk;
    W v = 0;
    if (gr < R && gk < K) v = mul_rn(widen(x[gr * sr + gk * sk]), sinv[rr]);
    sx[rr * ELD + kk] = v;
  }
  __syncthreads();

  // Each thread carves 8 consecutive K of two rows, held in registers
  // across the slices, and stores each (row, slice) as one 8-byte word: a
  // warp writes 4 rows of 64 contiguous bytes.
  const W two_beta = pow2_of<W>(beta);
  const int kc = (tid % (EK / 8)) * 8;
  const long long plane = static_cast<long long>(R) * Kp;
  for (int half = 0; half < 2; ++half) {
    const int rr = tid / (EK / 8) + half * (ER / 2);
    if (r0 + rr >= R) break;
    W r[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) r[j] = sx[rr * ELD + kc + j];
    int8_t* dst = planes + static_cast<long long>(r0 + rr) * Kp + k0 + kc;
    carve8(r, two_beta, p,
           [&](int i, uint2 w) { *reinterpret_cast<uint2*>(dst + i * plane) = w; });
  }
}

// ---- the plane GEMM ----------------------------------------------------------

constexpr int PBN = 128;                  // output tile columns: one m64n128 a k-step
constexpr int PBN64 = 64;                 // the float64 output's: one m64n64
constexpr int PBK = 128;                  // K tile: one 128-byte swizzle row
constexpr int GROUP_M = 16;               // tile rows of a raster group

// WG consumer warpgroups of 64 rows each, NH column parts of NW = 128 or
// 64 (NH = 2, a 256-column tile, only for the int8 GEMM's int32 instance,
// whose consumers hold no float partial results beside the accumulators;
// NW = 64 for the float64 output).
template <int WG, int NH = 1, int NW = PBN>
struct Tile {
  static constexpr int BM = 64 * WG;
  static constexpr int BN = NW * NH;
  static constexpr int A_BYTES = BM * PBK;
  static constexpr int STAGE_BYTES = A_BYTES + BN * PBK;
  static constexpr int STAGES = NH == 1 ? 6 : 4;
  static constexpr int CONSUMERS = 128 * WG;
  static constexpr int THREADS = CONSUMERS + 128;   // and one producer warpgroup
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
};

// The scales' type of an output: float64 for a float64 output, else float32.
template <typename O>
using ScaleOf = typename std::conditional<std::is_same<O, double>::value, double, float>::type;

// The running sum's type of an output (none for the int8 GEMM's int32).
template <typename O>
struct AccOf {
  using type = typename Epilogue<O>::Acc;
};
template <>
struct AccOf<int32_t> {
  using type = float;
};

// A (M, Kp) and B^T (N, Kp) planes as 3-D tensor maps; mu (M) and nu (N)
// contiguous; out (M, N) row-major. epilogue = 0 stops after the mainloop
// and stores nothing (for timing the two apart). O = int32_t is the int8
// GEMM: p = 1, the accumulator stored as it is, mu and nu unread.
template <typename O, int WG, int NH, int NW>
__global__ void __launch_bounds__(Tile<WG, NH, NW>::THREADS, 1)
emugemm1_planes_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_b,
                       const ScaleOf<O>* __restrict__ mu, const ScaleOf<O>* __restrict__ nu,
                       O* __restrict__ out, int M, int N, int nk, int p, int beta, int epilogue) {
  using TL = Tile<WG, NH, NW>;
  using S = ScaleOf<O>;
  constexpr int STAGES = TL::STAGES;
  constexpr bool RAW = std::is_same<O, int32_t>::value;
  static_assert(NH == 1 || RAW, "a 256-column tile only for the int32 instance");
  extern __shared__ __align__(16) uint8_t ring_smem[];
  const uint32_t pad = (1024 - (smem_u32(ring_smem) & 1023)) & 1023;
  uint8_t* ring = ring_smem + pad;                                  // [STAGES][A | B], 1024-aligned
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * TL::STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  // Tiles run in groups of GROUP_M tile rows, column by column, so that
  // the blocks resident together read a few row and column slabs of each
  // plane, which stay in L2 across the plane-pair passes.
  const int tiles_m = (M + TL::BM - 1) / TL::BM, tiles_n = (N + TL::BN - 1) / TL::BN;
  const int tile = blockIdx.x;
  const int first = (tile / (GROUP_M * tiles_n)) * GROUP_M;
  const int rows = min(tiles_m - first, GROUP_M);
  const int in_group = tile % (GROUP_M * tiles_n);
  const int m0 = (first + in_group % rows) * TL::BM;
  const int n0 = (in_group / rows) * TL::BN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], TL::CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == WG) {
    // The producer: one thread streams the (diagonal, K tile, slice pair)
    // stages into the ring, in the order the consumers take them.
    if constexpr (WG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == TL::CONSUMERS) {
      int stage = 0, phase = 0;
      for (int s = 0; s < p; ++s) {
        for (int kt = 0; kt < nk; ++kt) {
          for (int i = 0; i <= s; ++i) {
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_expect_tx(&full[stage], TL::STAGE_BYTES);
            uint8_t* st = ring + stage * TL::STAGE_BYTES;
            tma_load_3d(st, &map_a, &full[stage], kt * PBK, m0, i);
            tma_load_3d(st + TL::A_BYTES, &map_b, &full[stage], kt * PBK, n0, s - i);
            if (++stage == STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
  } else {
    if constexpr (WG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int ct = threadIdx.x;                    // consumer thread
    const int lane = ct % 32;
    constexpr int NA = NW / 2;                     // accumulators a part
    using Acc = typename AccOf<O>::type;
    Acc c[RAW ? 1 : NA];
#pragma unroll
    for (int i = 0; i < (RAW ? 1 : NA); ++i) c[i] = 0;
    int acc[NH][NA];
    int stage = 0, phase = 0;
    for (int s = 0; s < p; ++s) {
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int i = 0; i < NA; ++i) acc[h][i] = 0;
      int prev = -1;
      for (int kt = 0; kt < nk; ++kt) {
        for (int i = 0; i <= s; ++i) {
          mbar_wait(&full[stage], phase);
          const uint8_t* st = ring + stage * TL::STAGE_BYTES;
          const uint64_t da = desc_sw128(st + wg * 64 * PBK);
          const uint64_t db = desc_sw128(st + TL::A_BYTES);
#pragma unroll
          for (int h = 0; h < NH; ++h) reg_fence(acc[h]);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < PBK / 32; ++ks)
#pragma unroll
            for (int h = 0; h < NH; ++h) {
              if constexpr (NW == PBN)
                wgmma_s8_n128(acc[h], da + 2 * ks, db + h * (NW * PBK >> 4) + 2 * ks);
              else
                wgmma_s8_n64(acc[h], da + 2 * ks, db + h * (NW * PBK >> 4) + 2 * ks);
            }
          wgmma_commit();
          // The previous stage's products are done once at most this
          // group is in flight: hand that stage back to the producer.
          wgmma_wait<1>();
#pragma unroll
          for (int h = 0; h < NH; ++h) reg_fence(acc[h]);
          if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
          prev = stage;
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      wgmma_wait_all();
#pragma unroll
      for (int h = 0; h < NH; ++h) reg_fence(acc[h]);
      if (lane == 0) mbar_arrive(&empty[prev]);
      if constexpr (!RAW) {
        if (epilogue) {
          const Acc w = pow2_of<Acc>(-beta * (s + 2));
#pragma unroll
          for (int i = 0; i < NA; ++i) c[i] = Epilogue<O>::step(c[i], acc[0][i], w);
        }
      }
    }
    if (!epilogue) return;

    // Register 4 j + 2 h + e of the fragment is row r + 8 h, column
    // 8 j + 2 (lane % 4) + e of the warpgroup's 64 x NW tile.
    const int row0 = m0 + wg * 64 + ((ct % 128) / 32) * 16 + lane / 4;
    const int col0 = n0 + (lane % 4) * 2;
    const bool pairs = (N & 1) == 0;
    if constexpr (RAW) {
      // The int8 GEMM: a warp stores 8 rows of 32 contiguous bytes an
      // instruction, one 8-byte pair a lane.
#pragma unroll
      for (int q = 0; q < NH; ++q) {
#pragma unroll
        for (int j = 0; j < NW / 8; ++j) {
          const int col = col0 + NW * q + 8 * j;
          if (col >= N) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row0 + 8 * h;
            if (row >= M) continue;
            O* o = out + static_cast<long long>(row) * N + col;
            const int* d = &acc[q][4 * j + 2 * h];
            if (pairs) {
              *reinterpret_cast<int2*>(o) = make_int2(d[0], d[1]);
            } else {
              o[0] = d[0];
              if (col + 1 < N) o[1] = d[1];
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const int col = col0 + 8 * j;
        if (col >= N) continue;
        const bool two = col + 1 < N;
        const S nu0 = nu[col], nu1 = two ? nu[col + 1] : S(0);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 8 * h;
          if (row >= M) continue;
          const S m = mu[row];
          O* o = out + static_cast<long long>(row) * N + col;
          const Acc v0 = Epilogue<O>::scale(c[4 * j + 2 * h], m, nu0);
          if (two) {
            const Acc v1 = Epilogue<O>::scale(c[4 * j + 2 * h + 1], m, nu1);
            if (pairs) {
              Epilogue<O>::store2(o, v0, v1);
            } else {
              Epilogue<O>::store(o, v0);
              Epilogue<O>::store(o + 1, v1);
            }
          } else {
            Epilogue<O>::store(o, v0);
          }
        }
      }
    }
  }
}

// ---- the interleaved form (K8): relayout into planes ---------------------------
//
// A-hat (M, p Kp) and B-hat (p Kp, N) hold the p slices interleaved on K
// at granularity IT = 32 (decompose.cu): K chunk c of slice i is the 32
// columns (rows) (c p + i) IT of the layout. The relayout writes them as the
// plane GEMM's K-contiguous planes (p, R, Kpp), Kpp = Kp padded to PBK with
// zero slices: A-hat's rows as they are, B-hat transposed (B^T's planes).
// At p = 1 the layout is the operand itself and K is any logical K, the
// bytes past it zeros: the int8 GEMM's relayout of an operand that its
// tensor map cannot read in place (B (K, N), or a misaligned A).
// Both kernels read and write 16 bytes or more a thread along rows of 32 or
// more contiguous bytes; B-hat's transpose goes through a (128, 128)
// shared tile, 4 x 4 bytes transposed in registers a thread. Bound by
// bytes: p Kp bytes read and p Kpp written a row.

constexpr int IT = 32;            // the interleave granularity
constexpr int RNT = 256;          // threads of a relayout block
constexpr int RT = 128;           // B-hat relayout tile: 128 K x 128 N bytes

// Source row (A-hat: column) of slice i at K index k of the interleaved layout.
__device__ __forceinline__ long long interleaved(int k, int i, int p) {
  return static_cast<long long>((k / IT) * p + i) * IT + k % IT;
}

// A-hat (R, p Kp), row stride ld -> planes (p, R, Kpp): one 16-byte group a
// thread, a grid-stride walk; vec: ld and the base 16-byte aligned.
__global__ void __launch_bounds__(RNT)
relayout_lhs_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ planes, int R, int Kp,
                    int Kpp, long long ld, int p, int vec) {
  // Kp: the K of a slice (a multiple of IT when p > 1).
  const int groups = Kpp / 16;
  const long long units = static_cast<long long>(p) * R * groups;
  for (long long u = blockIdx.x * static_cast<long long>(RNT) + threadIdx.x; u < units;
       u += static_cast<long long>(gridDim.x) * RNT) {
    const int k = static_cast<int>(u % groups) * 16;
    const long long row = u / groups;             // i R + r
    const int r = static_cast<int>(row % R), i = static_cast<int>(row / R);
    uint4 w = make_uint4(0, 0, 0, 0);
    if (k < Kp) {
      const int8_t* src = x + r * ld + interleaved(k, i, p);
      if (vec && k + 16 <= Kp) {
        w = *reinterpret_cast<const uint4*>(src);
      } else {
        uint32_t b[4] = {0, 0, 0, 0};
        const int n = min(16, Kp - k);
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (j < n) b[j / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(src[j])) << (8 * (j % 4));
        w = make_uint4(b[0], b[1], b[2], b[3]);
      }
    }
    *reinterpret_cast<uint4*>(planes + row * Kpp + k) = w;
  }
}

// The word of local row n (N axis) holding K bytes 4 kw .. 4 kw + 3 in the
// shared tile, swizzled so that both passes below are free of bank
// conflicts: the first stores a word of 32 rows 4 apart, the second loads
// one word of each 16-byte group of 4 neighbouring rows.
__device__ __forceinline__ int tile_word(int n, int kw) {
  return n * (RT / 4) + (kw ^ ((n >> 2) ^ (n & 3)));
}

// B-hat (p Kp, N), row stride ld -> B^T's planes (p, N, Kpp); block
// (K tile, N tile, slice). vec: ld and the base 4-byte aligned.
__global__ void __launch_bounds__(RNT)
relayout_rhs_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ planes, int N, int Kp,
                    int Kpp, long long ld, int p, int vec) {
  __shared__ uint32_t tile[RT * RT / 4];
  const int k0 = blockIdx.x * RT, n0 = blockIdx.y * RT, i = blockIdx.z;
  const int tid = threadIdx.x;
  // Each thread loads a 4 (K) x 4 (N) block of bytes, a warp 128 bytes of
  // each of 4 rows, and transposes it in registers.
  const int nb = tid % 32;
  const int n = n0 + 4 * nb;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int kw = tid / 32 + 8 * j;
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = k0 + 4 * kw + q;
      v[q] = 0;
      if (k >= Kp || n >= N) continue;
      const int8_t* src = x + interleaved(k, i, p) * ld + n;
      if (vec && n + 3 < N) {
        v[q] = *reinterpret_cast<const uint32_t*>(src);
      } else {
        for (int c = 0; c < 4 && n + c < N; ++c)
          v[q] |= static_cast<uint32_t>(static_cast<uint8_t>(src[c])) << (8 * c);
      }
    }
    const uint32_t t0 = __byte_perm(v[0], v[1], 0x5140), t1 = __byte_perm(v[0], v[1], 0x7362);
    const uint32_t t2 = __byte_perm(v[2], v[3], 0x5140), t3 = __byte_perm(v[2], v[3], 0x7362);
    tile[tile_word(4 * nb, kw)] = __byte_perm(t0, t2, 0x5410);
    tile[tile_word(4 * nb + 1, kw)] = __byte_perm(t0, t2, 0x7632);
    tile[tile_word(4 * nb + 2, kw)] = __byte_perm(t1, t3, 0x5410);
    tile[tile_word(4 * nb + 3, kw)] = __byte_perm(t1, t3, 0x7632);
  }
  __syncthreads();
  // Each thread stores 16 K bytes of a row, 8 threads a row's 128 bytes.
  const int g = tid % 8;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int nn = tid / 8 + 32 * j;
    if (n0 + nn >= N) break;
    uint4 w;
    w.x = tile[tile_word(nn, 4 * g)];
    w.y = tile[tile_word(nn, 4 * g + 1)];
    w.z = tile[tile_word(nn, 4 * g + 2)];
    w.w = tile[tile_word(nn, 4 * g + 3)];
    *reinterpret_cast<uint4*>(planes + (static_cast<long long>(i) * N + n0 + nn) * Kpp + k0 +
                              16 * g) = w;
  }
}

// ---- host side -------------------------------------------------------------

// The planes (p, rows, K) int8, row stride ld bytes, as a 3-D tensor map
// with (PBK, box_rows, 1) boxes: rows past `rows` and K past `K` arrive as
// zeros.
int plane_map(CUtensorMap* map, const int8_t* planes, int p, int rows, int K, long long ld,
              int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(p)};
  const cuuint64_t row = static_cast<cuuint64_t>(ld);
  const cuuint64_t strides[2] = {row, row * rows};
  const cuuint32_t box[3] = {PBK, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<int8_t*>(planes), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

template <typename T>
int launch_encode(const void* x, const void* scale, int8_t* planes, int R, int K, int Kp,
                  long long sr, long long sk, int p, int beta, cudaStream_t st) {
  const dim3 grid(Kp / EK, (R + ER - 1) / ER);
  emugemm1_encode_kernel<T><<<grid, ENT, 0, st>>>(
      static_cast<const T*>(x), static_cast<const typename Work<T>::type*>(scale), planes, R, K,
      Kp, sr, sk, p, beta);
  return static_cast<int>(cudaGetLastError());
}

template <typename O, int WG, int NH = 1, int NW = PBN>
int launch_planes(const CUtensorMap& ma, const CUtensorMap& mb, const void* mu, const void* nu,
                  void* out, int M, int N, int nk, int p, int beta, int epilogue,
                  cudaStream_t st) {
  using TL = Tile<WG, NH, NW>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        emugemm1_planes_kernel<O, WG, NH, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        TL::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int tiles = ((M + TL::BM - 1) / TL::BM) * ((N + TL::BN - 1) / TL::BN);
  emugemm1_planes_kernel<O, WG, NH, NW><<<tiles, TL::THREADS, TL::SMEM, st>>>(
      ma, mb, static_cast<const ScaleOf<O>*>(mu), static_cast<const ScaleOf<O>*>(nu),
      static_cast<O*>(out), M, N, nk, p, beta, epilogue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes. Each returns 0 on success, a
// cudaError_t code if the launch was refused, -1 for arguments that have
// no compiled instance, and -2 / -3 if libcuda's tensor-map encoder is
// missing / refused the planes.
//
// Encode: x (R, K) through strides (sr, sk) in elements, in float32,
// bfloat16 or float64 (type: 0, 1, 2); scale (R) powers of two, contiguous,
// float32 (float64 for a float64 x); planes (p, R, Kp) int8 contiguous, Kp
// a multiple of the K tile >= K; p in 1..16.
extern "C" int emugemm1_encode(const void* x, const void* scale, int8_t* planes, int R, int K,
                               int Kp, long long sr, long long sk, int type, int p, int beta,
                               void* stream) {
  if (R <= 0 || R > 65535 * ER || K <= 0 || Kp < K || Kp % PBK != 0) return -1;
  if (p < 1 || p > MAXP || beta < 1 || beta > 7) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (type == F32) return launch_encode<float>(x, scale, planes, R, K, Kp, sr, sk, p, beta, st);
  if (type == BF16)
    return launch_encode<__nv_bfloat16>(x, scale, planes, R, K, Kp, sr, sk, p, beta, st);
  if (type == F64) return launch_encode<double>(x, scale, planes, R, K, Kp, sr, sk, p, beta, st);
  return -1;
}

// The plane GEMM: a_planes (p, M, Kp) and b_planes (p, N, Kp) int8 from
// emugemm1_encode (A and B^T), p in 1..16, mu (M) and nu (N) float32
// (float64 for a float64 output), out (M, N) row-major in float32,
// bfloat16, float64 or float16 (out_type: 0, 1, 2, 3); tile_m, the output
// tile's rows, 128 or 64 (its columns: 128, 64 for float64). epilogue = 0
// stops after the mainloop.
extern "C" int emugemm1_planes(const int8_t* a_planes, const int8_t* b_planes, const void* mu,
                               const void* nu, void* out, int M, int N, int Kp, int out_type,
                               int p, int beta, int tile_m, int epilogue, void* stream) {
  if (M <= 0 || N <= 0 || Kp <= 0 || Kp % PBK != 0) return -1;
  if (p < 1 || p > MAXP || beta < 1 || beta > 7 || (tile_m != 64 && tile_m != 128)) return -1;
  if (out_type < F32 || out_type > F16) return -1;
  CUtensorMap ma, mb;
  int rc = plane_map(&ma, a_planes, p, M, Kp, Kp, tile_m);
  if (rc == 0) rc = plane_map(&mb, b_planes, p, N, Kp, Kp, out_type == F64 ? PBN64 : PBN);
  if (rc != 0) return rc;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nk = Kp / PBK;
#define EMUGEMM1_PLANES(O_, NW_)                                                                  \
  return tile_m == 128                                                                             \
             ? launch_planes<O_, 2, 1, NW_>(ma, mb, mu, nu, out, M, N, nk, p, beta, epilogue, st)  \
             : launch_planes<O_, 1, 1, NW_>(ma, mb, mu, nu, out, M, N, nk, p, beta, epilogue, st)
  if (out_type == F32) EMUGEMM1_PLANES(float, PBN);
  if (out_type == BF16) EMUGEMM1_PLANES(__nv_bfloat16, PBN);
  if (out_type == F16) EMUGEMM1_PLANES(__half, PBN);
  EMUGEMM1_PLANES(double, PBN64);
#undef EMUGEMM1_PLANES
}

// The plane GEMM's output tile columns for an output type.
extern "C" int emugemm1_plane_n(int out_type) { return out_type == F64 ? PBN64 : PBN; }

// The int8 GEMM (K9): a (M, K) and bt (N, K) int8, K-contiguous rows with
// row strides lda and ldb (bytes; each a multiple of 16, each base 16-byte
// aligned: the operand itself or its plane from emugemm1_relayout) ->
// out (M, N) int32 row-major, the sums wrapping as int32 adds do; the
// output tile (tile_m, tile_n): (128, 256) or (64, 128). epilogue = 0
// stops after the mainloop.
extern "C" int emugemm1_int8(const int8_t* a, const int8_t* bt, int32_t* out, int M, int N,
                             int K, long long lda, long long ldb, int tile_m, int tile_n,
                             int epilogue, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return -1;
  if (!(tile_m == 128 && tile_n == 256) && !(tile_m == 64 && tile_n == 128)) return -1;
  CUtensorMap ma, mb;
  int rc = plane_map(&ma, a, 1, M, K, lda, tile_m);
  if (rc == 0) rc = plane_map(&mb, bt, 1, N, K, ldb, tile_n);
  if (rc != 0) return rc;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nk = (K + PBK - 1) / PBK;
  return tile_m == 128
             ? launch_planes<int32_t, 2, 2>(ma, mb, nullptr, nullptr, out, M, N, nk, 1, 1, epilogue,
                                            st)
             : launch_planes<int32_t, 1>(ma, mb, nullptr, nullptr, out, M, N, nk, 1, 1, epilogue, st);
}

// The K tile, to which planes are padded.
extern "C" int emugemm1_plane_k() { return PBK; }

// The interleaved form's relayout: x, A-hat (R, p Kp) (rhs = 0) or B-hat
// (p Kp, R) (rhs = 1), int8 with row stride ld (bytes), Kp a multiple of
// the interleave granularity when p > 1 (at p = 1 any logical K) -> planes
// (p, R, Kpp) int8 contiguous, Kpp a multiple of the K tile >= Kp.
extern "C" int emugemm1_relayout(const int8_t* x, int8_t* planes, int R, int Kp, int Kpp,
                                 long long ld, int p, int rhs, void* stream) {
  if (R <= 0 || Kp <= 0 || (p > 1 && Kp % IT != 0) || Kpp < Kp || Kpp % PBK != 0) return -1;
  if (p < 1 || p > MAXP) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t base = reinterpret_cast<uintptr_t>(x);
  if (rhs) {
    if ((R + RT - 1) / RT > 65535) return -1;
    const dim3 grid(Kpp / RT, (R + RT - 1) / RT, p);
    relayout_rhs_kernel<<<grid, RNT, 0, st>>>(x, planes, R, Kp, Kpp, ld, p,
                                              ld % 4 == 0 && base % 4 == 0);
  } else {
    const long long units = static_cast<long long>(p) * R * (Kpp / 16);
    const int blocks = static_cast<int>(std::min<long long>((units + RNT - 1) / RNT, 132 * 16));
    relayout_lhs_kernel<<<blocks, RNT, 0, st>>>(x, planes, R, Kp, Kpp, ld, p,
                                                ld % 16 == 0 && base % 16 == 0);
  }
  return static_cast<int>(cudaGetLastError());
}

// The interleave granularity the relayout reads.
extern "C" int emugemm1_interleave() { return IT; }
