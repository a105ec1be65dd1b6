// Fused flash attention for Hopper (sm_90a): softmax(q k^T * scale, masked)
// v for q (B, H, Sq, D) against k and v (B, KVH, Sk, D), float32, bf16 or
// float16, with grouped-query heads and causal and/or sliding-window masks.
//
// Head dims: any D <= 256 that is a multiple of 8 runs on the instance
// compiled for the next of 32, 64, 128 and 256 (Di). Only the true D
// reaches device memory: the tensor maps' inner extent is D and their
// boxes Di wide, so TMA fills the columns past D with zeros in shared
// memory (a zero column adds nothing to Q K^T, and P V's columns past D
// are never stored); the FFMA kernel and the 3xTF32 pre-pass zero them by
// hand. Rows of q, k, v and o are D elements apart (D a multiple of 8
// keeps them 16-byte aligned, as TMA wants).
//
// Replaces the Pallas kernel of the JAX package
//   src/repro/kernels/flash_attn.py  flash_attention (_kernel)
//
// Every kernel keeps the score tile, the running max m, the running
// denominator l and the output accumulator on chip, so only q, k, v (or
// their parts) and o touch device memory. The kv head is h / (H / KVH): k
// and v are read in place for every q head of their group, never repeated
// in memory.
//
// bf16 and float16 (instances 32, 64, 128, 256): one kernel, the .bf16 or
// the .f16 form of the same wgmma shapes; one block per (b, h, 128-query
// tile), three warpgroups.
//   * A producer warpgroup, its registers cut with setmaxnreg, in which
//     one thread loads the q tile once and streams the k and v tiles of
//     BK keys through a ring of STAGES shared stages by TMA
//     (cp.async.bulk.tensor, full and empty mbarriers, k and v on barriers
//     of their own so that Q K^T starts before v lands). The tensor maps
//     are 3-D, (B H, Sq, D) for q and (B KVH, Sk, D) for k and v, in
//     rows of 64 (D = 32: 32) elements swizzled by TMA; rows past Sq or Sk
//     arrive as zeros, and the row coordinate names the kv head.
//   * Two consumer warpgroups of 64 query rows each, their registers raised
//     with setmaxnreg: S = Q K^T on wgmma m64n{BK}k16 bf16 (f16) -> float32
//     with both operands in shared memory; the online softmax in registers;
//     P rounded to v's type in registers is wgmma's A operand for O += P V,
//     and V
//     is read in place as an MN-major B (16-bit types allow it), so
//     nothing is transposed by hand.
//   * BK = 128 keys a tile (64 at D = 256, where O alone is 128 floats a
//     thread), 3 stages at D <= 64, 2 above. ptxas gives every thread of a
//     384-thread block 168 registers, whatever setmaxnreg asks, so D = 256
//     spills some 420 bytes a thread, and there is no room to overlap one
//     tile's softmax with the previous tile's P V (PERF.md).
//   * Blocks run heaviest q tile first: under a causal mask the last q
//     tiles see the most keys, so the tail of the grid is short.
// float32 (instances 32, 64, 128): 3xTF32 on wgmma, the bf16 kernel's
// structure. One TF32 product keeps 11 significant bits, far from the 2e-5
// bar; three keep about 22. Every operand x is split as x = hi + lo, hi =
// x with its 13 low mantissa bits cleared (a tf32 value, so that the
// tensor core's own reading of a float32 does not matter) and lo = the
// same of x - hi (exact in float32), and S = Qh Kh^T + Qh Kl^T + Ql Kh^T,
// O += Ph Vh + Ph Vl + Pl Vh, all accumulated in float32 (the lo * lo term,
// 2^-22 of the product, is left out).
//   * A pre-pass (split_rows_kernel, split_vt_kernel) writes the parts to
//     device memory: q and k elementwise, and v transposed, (B KVH, D,
//     Skp), Skp = Sk rounded up to 32 with zeros past Sk: wgmma reads
//     32-bit operands K-major only, and the keys are K of P V. Within each
//     group of 8 keys, column c holds key 2c (c < 4) or 2(c - 4) + 1: the
//     score accumulator holds keys 2t and 2t + 1 of a k-step in thread t,
//     and tf32's register A fragment wants k columns t and t + 4, so P
//     goes from the accumulator into the A fragment with no shuffle. The
//     pre-pass moves about 7 x 4 bytes an element of q, k, v (about
//     0.04 ms at olmo-1b's 2 x 16 x 2048 x 128).
//   * The main kernel: a TMA producer and two consumer warpgroups; Qh and
//     Ql stay in shared memory (both operands of S are shared-memory
//     descriptors, m64n{BK}k8), P's parts are computed in registers from
//     the scores and are the register A operand of O += P V (m64n{D}k8).
//     Shared memory holds both q parts (2 x 64 KB at D = 128) and per
//     stage both parts of a k tile and a v tile, so BK = 32 and one stage
//     at D = 128 (192 KB), BK = 64 and two stages below; k and v have
//     empty barriers of their own, so the next k tile loads while the
//     current one's softmax and P V run. D = 256 does not fit (its q parts
//     alone take 256 KB) and stays on the FFMA kernel below.
// float32 at the instance 256: one block per (b, h, 64-query tile) of four warps of
// 16 rows, k and v tiles loaded by the threads themselves, each thread
// owning rows g and g + 8 of its warp and columns 2t, 2t + 1 of every
// 8-wide tile, computed with FFMA in true float32 from shared memory.
//
// Numerics, as the reference kernel and its oracle (src/repro/kernels/
// ref.py flash_attention), in every kernel:
//   * a masked score is the finite -1e30, never -inf: a row whose keys are
//     all masked (a window, Sq > Sk) averages v uniformly, as the reference
//     does; keys past Sk in the last tile are left out (probability 0);
//   * masks are top-left aligned: rel = q_pos - k_pos, both from 0; causal
//     keeps rel >= 0, a window keeps rel < window;
//   * the scale multiplies the float32 score; the output divides by
//     max(l, 1e-30); P is rounded (bf16, float16) or split (3xTF32) for the PV
//     product while l sums the unrounded probabilities, as the reference's
//     p.astype(v);
//   * expf, not __expf, and no --use_fast_math.
// A k tile that no row of the q tile can see is skipped; when some row of
// the tile has no visible key at all, every tile is visited, so that row's
// uniform average spans all Sk keys as in the reference.
//
// Bound: operations for long sequences (4 B H Sq Sk D flops over the
// unmasked pairs, at the bf16 tensor-core peak, three times that at the
// TF32 peak for 3xTF32, or the float32 FFMA peak) and bytes for short
// ones. Each warpgroup runs its score product, softmax and P V product in
// series, so the tensor cores idle while both warpgroups are in their
// softmax (PERF.md).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr float NEG_INF = -1e30f;

// The keys a query row qq can see are [lo(qq), hi(qq)]; both ends grow with
// qq, and lo - hi is largest at an end row of a tile (it falls, then
// rises). The k tiles [kt0, kt1) of BK keys that a q tile [q0, qlast]
// visits: those some row sees, or all when some row sees none.
struct Mask {
  int Sk, causal, has_window, window;
  __device__ int lo(int qq) const { return has_window ? max(0, qq - window + 1) : 0; }
  __device__ int hi(int qq) const { return causal ? min(Sk - 1, qq) : Sk - 1; }
  __device__ bool masked(int qq, int kc) const {
    const int rel = qq - kc;
    return (causal && rel < 0) || (has_window && rel >= window);
  }
  __device__ void tiles(int q0, int qlast, int BK, int& kt0, int& kt1) const {
    const bool empty_row = lo(q0) > hi(q0) || lo(qlast) > hi(qlast);
    kt0 = 0;
    kt1 = (Sk + BK - 1) / BK;
    if (!empty_row) {
      kt0 = lo(q0) / BK;
      kt1 = hi(qlast) / BK + 1;
    }
  }
};

// ---- float32 at D = 256: FFMA --------------------------------------------------

constexpr int BQ32 = 64;
constexpr int NWARPS32 = 4;
constexpr int NT32 = NWARPS32 * 32;

template <int D>
struct Layout32 {
  static_assert(D == 256, "the 3xTF32 kernel takes float32 at smaller head dims");
  static constexpr int BK = 32;
  static constexpr int LD = D + 4;                 // keeps 16-byte rows, shifts banks
  static constexpr int PLD = BK + 4;               // sP: (NWARPS, 16, BK)
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + BQ32 * LD;
  static constexpr int V_OFF = K_OFF + BK * LD;
  static constexpr int P_OFF = V_OFF + BK * LD;
  static constexpr size_t BYTES = static_cast<size_t>(P_OFF + NWARPS32 * 16 * PLD) * 4;
};

__device__ __forceinline__ float dot4(float4 a, float4 b, float c) {
  c = fmaf(a.x, b.x, c);
  c = fmaf(a.y, b.y, c);
  c = fmaf(a.z, b.z, c);
  return fmaf(a.w, b.w, c);
}

// Copy rows [r0, r0 + rows) of a (S, Dt) matrix into shared memory as rows
// of D with row stride ld, zeros past S and past Dt; 16 bytes a thread at a
// time.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* __restrict__ src, int r0,
                                          int rows, int S, int Dt) {
  for (int c = threadIdx.x; c < rows * (D / 4); c += NT32) {
    const int r = c / (D / 4), d = (c % (D / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S && d < Dt)
      v = *reinterpret_cast<const float4*>(src + static_cast<long long>(r0 + r) * Dt + d);
    *reinterpret_cast<float4*>(dst + r * ld + d) = v;
  }
}

template <int D>
__global__ void __launch_bounds__(NT32)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int H, int KVH, int Sq,
                 int Sk, int Dt, float scale, const Mask mask) {
  using L = Layout32<D>;
  constexpr int BK = L::BK;
  constexpr int NS = BK / 8;   // 8-wide score tiles of a row block
  constexpr int ND = D / 8;    // 8-wide output tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  float* sQ = smem + L::Q_OFF;
  float* sK = smem + L::K_OFF;
  float* sV = smem + L::V_OFF;

  const int q0 = blockIdx.x * BQ32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KVH);
  const float* qb = q + static_cast<long long>(b * H + h) * Sq * Dt;
  const float* kb = k + static_cast<long long>(b * KVH + kh) * Sk * Dt;
  const float* vb = v + static_cast<long long>(b * KVH + kh) * Sk * Dt;
  float* ob = o + static_cast<long long>(b * H + h) * Sq * Dt;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int qr0 = q0 + warp * 16 + g, qr1 = qr0 + 8;
  int kt0, kt1;
  mask.tiles(q0, min(q0 + BQ32, Sq) - 1, BK, kt0, kt1);

  load_rows<D>(sQ, L::LD, qb, q0, BQ32, Sq, Dt);

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BK;
    load_rows<D>(sK, L::LD, kb, k0, BK, Sk, Dt);
    load_rows<D>(sV, L::LD, vb, k0, BK, Sk, Dt);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows.
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    const float* qw = sQ + warp * 16 * L::LD;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      const float4 qa = *reinterpret_cast<const float4*>(qw + g * L::LD + d);
      const float4 qc = *reinterpret_cast<const float4*>(qw + (g + 8) * L::LD + d);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float4 ka = *reinterpret_cast<const float4*>(sK + (8 * n + 2 * t) * L::LD + d);
        const float4 kc = *reinterpret_cast<const float4*>(sK + (8 * n + 2 * t + 1) * L::LD + d);
        s[n][0] = dot4(qa, ka, s[n][0]);
        s[n][1] = dot4(qa, kc, s[n][1]);
        s[n][2] = dot4(qc, ka, s[n][2]);
        s[n][3] = dot4(qc, kc, s[n][3]);
      }
    }

    // Scale, mask, and the online softmax update of rows qr0 and qr1. The
    // four threads of a group (lanes 4g .. 4g+3) hold one row's columns.
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kc = k0 + 8 * n + 2 * t + j;
        float x0 = -INFINITY, x1 = -INFINITY;    // a key past Sk: probability 0
        if (kc < Sk) {
          x0 = mask.masked(qr0, kc) ? NEG_INF : s[n][j] * scale;
          x1 = mask.masked(qr1, kc) ? NEG_INF : s[n][2 + j] * scale;
        }
        s[n][j] = x0;
        s[n][2 + j] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[n][j] = expf(s[n][j] - mn0);
        s[n][2 + j] = expf(s[n][2 + j] - mn1);
        sum0 += s[n][j];
        sum1 += s[n][2 + j];
      }
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }

    // O += P V, P parked per warp in shared memory.
    float* pw = smem + L::P_OFF + warp * 16 * L::PLD;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      *reinterpret_cast<float2*>(pw + g * L::PLD + 8 * n + 2 * t) = make_float2(s[n][0], s[n][1]);
      *reinterpret_cast<float2*>(pw + (g + 8) * L::PLD + 8 * n + 2 * t) =
          make_float2(s[n][2], s[n][3]);
    }
    __syncwarp();
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      const float p0 = pw[g * L::PLD + j], p1 = pw[(g + 8) * L::PLD + j];
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const float2 vv = *reinterpret_cast<const float2*>(sV + j * L::LD + 8 * n + 2 * t);
        acc[n][0] = fmaf(p0, vv.x, acc[n][0]);
        acc[n][1] = fmaf(p0, vv.y, acc[n][1]);
        acc[n][2] = fmaf(p1, vv.x, acc[n][2]);
        acc[n][3] = fmaf(p1, vv.y, acc[n][3]);
      }
    }
    __syncthreads();   // every warp is done with sK, sV and its sP before the next load
  }

  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = 8 * n + 2 * t;
    if (col >= Dt) continue;
    if (qr0 < Sq)
      *reinterpret_cast<float2*>(ob + static_cast<long long>(qr0) * Dt + col) =
          make_float2(acc[n][0] / d0, acc[n][1] / d0);
    if (qr1 < Sq)
      *reinterpret_cast<float2*>(ob + static_cast<long long>(qr1) * Dt + col) =
          make_float2(acc[n][2] / d1, acc[n][3] / d1);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int H, int KVH, int Sq,
               int Sk, int Dt, float scale, const Mask& mask, cudaStream_t st) {
  using L = Layout32<D>;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::BYTES));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + BQ32 - 1) / BQ32, H, B);
  flash_f32_kernel<D><<<grid, NT32, L::BYTES, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), H, KVH, Sq, Sk, Dt, scale, mask);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 and float16: TMA, warp specialisation, wgmma -----------------------

constexpr int BQ = 128;                   // query rows of a block: two consumer warpgroups
constexpr int CONSUMERS = 256;
constexpr int NT = CONSUMERS + 128;       // and one producer warpgroup

template <int D>
struct Tiles {
  static constexpr int BK = D == 256 ? 64 : 128;
  static constexpr int STAGES = D <= 64 ? 3 : 2;
  static constexpr int SW = D >= 64 ? 128 : 64;    // swizzle bytes: one row block
  static constexpr int SWE = SW / 2;               // its bf16 elements
  static constexpr int Q_BYTES = BQ * D * 2;       // [D / SWE][BQ][SWE], swizzled
  static constexpr int KV_BYTES = BK * D * 2;      // [D / SWE][BK][SWE], swizzled
  static constexpr int BARS = 1 + 3 * STAGES;      // q, full k, full v, empty
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + BARS * 8 + 1024;
};

// The kernel's two 16-bit types: the wgmma form, the tensor maps' type, P
// packed for the A fragment and a pair of outputs stored.
template <typename T>
struct Half16;

template <>
struct Half16<__nv_bfloat16> {
  static constexpr bool F16 = false;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  __device__ static uint32_t pack(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  __device__ static void store(__nv_bfloat16* at, float lo, float hi) {
    *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(lo, hi);
  }
};

template <>
struct Half16<__half> {
  static constexpr bool F16 = true;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  __device__ static uint32_t pack(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  __device__ static void store(__half* at, float lo, float hi) {
    *reinterpret_cast<__half2*>(at) = __floats2half2_rn(lo, hi);
  }
};

template <int D, typename T>
__global__ void __launch_bounds__(NT, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v, T* __restrict__ o, int H, int KVH,
                  int Sq, int Sk, int Dt, float scale, const Mask mask) {
  using L = Tiles<D>;
  using E = Half16<T>;
  constexpr int BK = L::BK, STAGES = L::STAGES, SW = L::SW, SWE = L::SWE;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  uint8_t* sQ = smem_raw + pad;                          // 1024-aligned swizzle atoms
  uint8_t* sK = sQ + L::Q_BYTES;                         // [STAGES][KV_BYTES]
  uint8_t* sV = sK + STAGES * L::KV_BYTES;               // [STAGES][KV_BYTES]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sV + STAGES * L::KV_BYTES);
  uint64_t* full_k = qbar + 1;
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty = full_v + STAGES;

  // Heaviest q tile first: block x runs q tile nq - 1 - x / (B H).
  const int nq = (Sq + BQ - 1) / BQ;
  const int slices = gridDim.x / nq;                     // B * H
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x) / slices) * BQ;
  const int bh = blockIdx.x % slices;
  const int kv_slice = (bh / H) * KVH + (bh % H) / (H / KVH);
  int kt0, kt1;
  mask.tiles(q0, min(q0 + BQ, Sq) - 1, BK, kt0, kt1);

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS / 128) {
    // The producer: one thread loads q, then streams the k and v tiles.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(qbar, L::Q_BYTES);
      for (int c = 0; c < D / SWE; ++c) tma_load_3d(sQ + c * BQ * SW, &map_q, qbar, c * SWE, q0, bh);
      int stage = 0, phase = 0;
      for (int kt = kt0; kt < kt1; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* k_st = sK + stage * L::KV_BYTES;
        uint8_t* v_st = sV + stage * L::KV_BYTES;
        mbar_expect_tx(&full_k[stage], L::KV_BYTES);
        for (int c = 0; c < D / SWE; ++c)
          tma_load_3d(k_st + c * BK * SW, &map_k, &full_k[stage], c * SWE, kt * BK, kv_slice);
        mbar_expect_tx(&full_v[stage], L::KV_BYTES);
        for (int c = 0; c < D / SWE; ++c)
          tma_load_3d(v_st + c * BK * SW, &map_v, &full_v[stage], c * SWE, kt * BK, kv_slice);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int row_lo = q0 + wg * 64;                     // this warpgroup's 64 rows
    const int r0 = row_lo + ((threadIdx.x % 128) / 32) * 16 + g, r1 = r0 + 8;
    const uint8_t* q_wg = sQ + wg * 64 * SW;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
    mbar_wait(qbar, 0);

    int stage = 0, phase = 0;
    for (int kt = kt0; kt < kt1; ++kt) {
      const int k0 = kt * BK;
      // S = Q K^T: D / 16 k-steps; a step moves 32 bytes along a swizzled
      // row block, and past it to the next block.
      float s[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
      mbar_wait(&full_k[stage], phase);
      const uint8_t* k_st = sK + stage * L::KV_BYTES;
      reg_fence(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk * 16 / SWE, off = (kk * 16 % SWE) * 2;
        wgmma_bf16_ss<BK, E::F16>(s, smem_desc(q_wg + c * BQ * SW + off, 16, 8 * SW, SW),
                          smem_desc(k_st + c * BK * SW + off, 16, 8 * SW, SW), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(s);

      // Scale, mask, and the online softmax update of rows r0 and r1:
      // s[4 n + j] is (r0, k0 + 8 n + 2 t + j), s[4 n + 2 + j] is r1's. The
      // mask is tested only on tiles where some row of the warpgroup needs
      // it.
      const bool edge = k0 + BK > Sk || (mask.causal && k0 + BK - 1 > row_lo) ||
                        (mask.has_window && row_lo + 63 - k0 >= mask.window);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float x0 = s[4 * n + j] * scale, x1 = s[4 * n + 2 + j] * scale;
          if (edge) {
            const int kc = k0 + 8 * n + 2 * t + j;
            if (kc >= Sk) {
              x0 = x1 = -INFINITY;                      // a key past Sk: probability 0
            } else {
              x0 = mask.masked(r0, kc) ? NEG_INF : x0;
              x1 = mask.masked(r1, kc) ? NEG_INF : x1;
            }
          }
          s[4 * n + j] = x0;
          s[4 * n + 2 + j] = x1;
          mx0 = fmaxf(mx0, x0);
          mx1 = fmaxf(mx1, x1);
        }
#pragma unroll
      for (int off = 1; off < 4; off *= 2) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[4 * n + j] = expf(s[4 * n + j] - mn0);
          s[4 * n + 2 + j] = expf(s[4 * n + 2 + j] - mn1);
          sum0 += s[4 * n + j];
          sum1 += s[4 * n + 2 + j];
        }
#pragma unroll
      for (int off = 1; off < 4; off *= 2) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
      }
      l0 = l0 * al0 + sum0;
      l1 = l1 * al1 + sum1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[4 * n] *= al0;
        acc[4 * n + 1] *= al0;
        acc[4 * n + 2] *= al1;
        acc[4 * n + 3] *= al1;
      }

      // O += P V: the score fragments of keys 16 kk .. 16 kk + 15 are the
      // A fragment of k-step kk; V's rows step 16 keys along K.
      mbar_wait(&full_v[stage], phase);
      const uint8_t* v_st = sV + stage * L::KV_BYTES;
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t a[4] = {E::pack(s[8 * kk], s[8 * kk + 1]),
                               E::pack(s[8 * kk + 2], s[8 * kk + 3]),
                               E::pack(s[8 * kk + 4], s[8 * kk + 5]),
                               E::pack(s[8 * kk + 6], s[8 * kk + 7])};
        wgmma_bf16_rs<D, E::F16>(acc, a, smem_desc(v_st + kk * 16 * SW, BK * SW, 8 * SW, SW));
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(acc);
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    T* ob = o + static_cast<long long>(bh) * Sq * Dt;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = 8 * n + 2 * t;
      if (col >= Dt) continue;                         // the instance's columns past D
      if (r0 < Sq) E::store(ob + static_cast<long long>(r0) * Dt + col, acc[4 * n] / d0,
                            acc[4 * n + 1] / d0);
      if (r1 < Sq) E::store(ob + static_cast<long long>(r1) * Dt + col, acc[4 * n + 2] / d1,
                            acc[4 * n + 3] / d1);
    }
  }
}

// (slices, rows, Dt) of 16-bit T as a 3-D tensor map of (SWE, box_rows, 1)
// boxes in the swizzle of SW bytes for the instance D; rows past `rows` and
// columns past Dt arrive as zeros.
template <int D, typename T>
int attn_map(CUtensorMap* map, const void* base, int slices, int rows, int box_rows, int Dt) {
  using L = Tiles<D>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Dt), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(slices)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(Dt) * 2,
                                 static_cast<cuuint64_t>(Dt) * 2 * static_cast<cuuint64_t>(rows)};
  const cuuint32_t box[3] = {L::SWE, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, Half16<T>::MAP, 3, const_cast<void*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        L::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

template <int D, typename T>
int launch_16(const void* q, const void* k, const void* v, void* o, int B, int H, int KVH, int Sq,
              int Sk, int Dt, float scale, const Mask& mask, cudaStream_t st) {
  using L = Tiles<D>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bf16_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  CUtensorMap mq, mk, mv;
  int rc = attn_map<D, T>(&mq, q, B * H, Sq, BQ, Dt);
  if (rc == 0) rc = attn_map<D, T>(&mk, k, B * KVH, Sk, L::BK, Dt);
  if (rc == 0) rc = attn_map<D, T>(&mv, v, B * KVH, Sk, L::BK, Dt);
  if (rc != 0) return rc;
  const long long blocks = static_cast<long long>((Sq + BQ - 1) / BQ) * B * H;
  if (blocks > 0x7fffffffll) return -1;
  flash_bf16_kernel<D, T><<<static_cast<unsigned>(blocks), NT, L::SMEM, st>>>(
      mq, mk, mv, static_cast<T*>(o), H, KVH, Sq, Sk, Dt, scale, mask);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_16_any(const void* q, const void* k, const void* v, void* o, int B, int H, int KVH,
                  int Sq, int Sk, int Dt, float scale, const Mask& mask, cudaStream_t st) {
  if (Dt <= 32) return launch_16<32, T>(q, k, v, o, B, H, KVH, Sq, Sk, Dt, scale, mask, st);
  if (Dt <= 64) return launch_16<64, T>(q, k, v, o, B, H, KVH, Sq, Sk, Dt, scale, mask, st);
  if (Dt <= 128) return launch_16<128, T>(q, k, v, o, B, H, KVH, Sq, Sk, Dt, scale, mask, st);
  return launch_16<256, T>(q, k, v, o, B, H, KVH, Sq, Sk, Dt, scale, mask, st);
}

// ---- float32: 3xTF32 on TMA, warp specialisation and wgmma -------------------

constexpr uint32_t TF32_MASK = 0xffffe000u;   // sign, exponent, 10 mantissa bits

// The tf32 hi part of x (its bits) and the tf32 of the rest.
__device__ __forceinline__ uint32_t tf32_hi(float x) { return __float_as_uint(x) & TF32_MASK; }
__device__ __forceinline__ uint32_t tf32_lo(float x) {
  return __float_as_uint(__fsub_rn(x, __uint_as_float(tf32_hi(x)))) & TF32_MASK;
}

template <int D>
struct Tiles32 {
  static constexpr int BK = D == 128 ? 32 : 64;
  static constexpr int STAGES = D == 128 ? 1 : 2;
  static constexpr int Q_BYTES = BQ * D * 4;       // one part: [D / 32][BQ][32], swizzled
  static constexpr int K_BYTES = BK * D * 4;       // one part: [D / 32][BK][32]
  static constexpr int V_BYTES = D * BK * 4;       // one part of v^T: [BK / 32][D][32]
  static constexpr int BARS = 1 + 4 * STAGES;      // q, full k, full v, empty k, empty v
  static constexpr int SMEM = 2 * Q_BYTES + 2 * STAGES * (K_BYTES + V_BYTES) + BARS * 8 + 1024;
};

// The tiles' swizzled rows are 128 bytes, 32 floats: a k-step of 8 moves
// 32 bytes along a row, four k-steps one row block.
__device__ __forceinline__ uint64_t desc32(const uint8_t* tile, int rows, int kk) {
  return smem_desc(tile + (kk / 4) * rows * 128 + (kk % 4) * 32, 16, 1024, 128);
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_tf32_kernel(const __grid_constant__ CUtensorMap map_qh, const __grid_constant__ CUtensorMap map_ql,
                  const __grid_constant__ CUtensorMap map_kh, const __grid_constant__ CUtensorMap map_kl,
                  const __grid_constant__ CUtensorMap map_vh, const __grid_constant__ CUtensorMap map_vl,
                  float* __restrict__ o, int H, int KVH, int Sq, int Sk, int Dt,
                  float scale, const Mask mask) {
  using L = Tiles32<D>;
  constexpr int BK = L::BK, STAGES = L::STAGES;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  uint8_t* sQ = smem_raw + pad;                          // [2][Q_BYTES]: hi, lo
  uint8_t* sK = sQ + 2 * L::Q_BYTES;                     // [STAGES][2][K_BYTES]
  uint8_t* sV = sK + 2 * STAGES * L::K_BYTES;            // [STAGES][2][V_BYTES]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sV + 2 * STAGES * L::V_BYTES);
  uint64_t* full_k = qbar + 1;
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty_k = full_v + STAGES;
  uint64_t* empty_v = empty_k + STAGES;

  // Heaviest q tile first: block x runs q tile nq - 1 - x / (B H).
  const int nq = (Sq + BQ - 1) / BQ;
  const int slices = gridDim.x / nq;                     // B * H
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x) / slices) * BQ;
  const int bh = blockIdx.x % slices;
  const int kv_slice = (bh / H) * KVH + (bh % H) / (H / KVH);
  int kt0, kt1;
  mask.tiles(q0, min(q0 + BQ, Sq) - 1, BK, kt0, kt1);

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], CONSUMERS / 32);
      mbar_init(&empty_v[s], CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS / 128) {
    // The producer: one thread loads both q parts, then streams both parts
    // of every k tile and v^T tile.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(qbar, 2 * L::Q_BYTES);
      for (int part = 0; part < 2; ++part)
        for (int c = 0; c < D / 32; ++c)
          tma_load_3d(sQ + part * L::Q_BYTES + c * BQ * 128, part ? &map_ql : &map_qh, qbar,
                      c * 32, q0, bh);
      int stage = 0, phase = 0;
      for (int kt = kt0; kt < kt1; ++kt) {
        uint8_t* k_st = sK + stage * 2 * L::K_BYTES;
        uint8_t* v_st = sV + stage * 2 * L::V_BYTES;
        mbar_wait(&empty_k[stage], phase ^ 1);
        mbar_expect_tx(&full_k[stage], 2 * L::K_BYTES);
        for (int part = 0; part < 2; ++part)
          for (int c = 0; c < D / 32; ++c)
            tma_load_3d(k_st + part * L::K_BYTES + c * BK * 128, part ? &map_kl : &map_kh,
                        &full_k[stage], c * 32, kt * BK, kv_slice);
        mbar_wait(&empty_v[stage], phase ^ 1);
        mbar_expect_tx(&full_v[stage], 2 * L::V_BYTES);
        for (int part = 0; part < 2; ++part)
          for (int c = 0; c < BK / 32; ++c)
            tma_load_3d(v_st + part * L::V_BYTES + c * D * 128, part ? &map_vl : &map_vh,
                        &full_v[stage], kt * BK + c * 32, 0, kv_slice);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x % 32, t = lane % 4;
    const int row_lo = q0 + wg * 64;                     // this warpgroup's 64 rows
    const int r0 = row_lo + ((threadIdx.x % 128) / 32) * 16 + lane / 4, r1 = r0 + 8;
    const uint8_t* qh = sQ + wg * 64 * 128;
    const uint8_t* ql = qh + L::Q_BYTES;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
    mbar_wait(qbar, 0);

    int stage = 0, phase = 0;
    for (int kt = kt0; kt < kt1; ++kt) {
      const int k0 = kt * BK;
      // S = Qh Kh^T + Qh Kl^T + Ql Kh^T over D / 8 k-steps.
      float s[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
      mbar_wait(&full_k[stage], phase);
      const uint8_t* kh = sK + stage * 2 * L::K_BYTES;
      const uint8_t* kl = kh + L::K_BYTES;
      reg_fence(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const uint64_t dqh = desc32(qh, BQ, kk), dkh = desc32(kh, BK, kk);
        wgmma_tf32_ss<BK>(s, dqh, dkh, kk > 0);
        wgmma_tf32_ss<BK>(s, dqh, desc32(kl, BK, kk), 1);
        wgmma_tf32_ss<BK>(s, desc32(ql, BQ, kk), dkh, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(s);
      if (lane == 0) mbar_arrive(&empty_k[stage]);

      // Scale, mask, and the online softmax update of rows r0 and r1:
      // s[4 n + j] is (r0, k0 + 8 n + 2 t + j), s[4 n + 2 + j] is r1's.
      const bool edge = k0 + BK > Sk || (mask.causal && k0 + BK - 1 > row_lo) ||
                        (mask.has_window && row_lo + 63 - k0 >= mask.window);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float x0 = s[4 * n + j] * scale, x1 = s[4 * n + 2 + j] * scale;
          if (edge) {
            const int kc = k0 + 8 * n + 2 * t + j;
            if (kc >= Sk) {
              x0 = x1 = -INFINITY;                      // a key past Sk: probability 0
            } else {
              x0 = mask.masked(r0, kc) ? NEG_INF : x0;
              x1 = mask.masked(r1, kc) ? NEG_INF : x1;
            }
          }
          s[4 * n + j] = x0;
          s[4 * n + 2 + j] = x1;
          mx0 = fmaxf(mx0, x0);
          mx1 = fmaxf(mx1, x1);
        }
#pragma unroll
      for (int off = 1; off < 4; off *= 2) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[4 * n + j] = expf(s[4 * n + j] - mn0);
          s[4 * n + 2 + j] = expf(s[4 * n + 2 + j] - mn1);
          sum0 += s[4 * n + j];
          sum1 += s[4 * n + 2 + j];
        }
#pragma unroll
      for (int off = 1; off < 4; off *= 2) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
      }
      l0 = l0 * al0 + sum0;
      l1 = l1 * al1 + sum1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[4 * n] *= al0;
        acc[4 * n + 1] *= al0;
        acc[4 * n + 2] *= al1;
        acc[4 * n + 3] *= al1;
      }

      // O += Ph Vh + Ph Vl + Pl Vh: k-step kk's A fragment is (r0, key
      // 2t), (r1, 2t), (r0, 2t + 1), (r1, 2t + 1) of keys 8 kk .., which
      // v^T's permuted columns t and t + 4 of that k-step hold.
      uint32_t ph[BK / 2], pl[BK / 2];
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const int idx[4] = {4 * kk, 4 * kk + 2, 4 * kk + 1, 4 * kk + 3};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ph[4 * kk + i] = tf32_hi(s[idx[i]]);
          pl[4 * kk + i] = tf32_lo(s[idx[i]]);
        }
      }
      mbar_wait(&full_v[stage], phase);
      const uint8_t* vh = sV + stage * 2 * L::V_BYTES;
      const uint8_t* vl = vh + L::V_BYTES;
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const uint32_t ah[4] = {ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2], ph[4 * kk + 3]};
        const uint32_t al[4] = {pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2], pl[4 * kk + 3]};
        const uint64_t dvh = desc32(vh, D, kk);
        wgmma_tf32_rs<D>(acc, ah, dvh);
        wgmma_tf32_rs<D>(acc, ah, desc32(vl, D, kk));
        wgmma_tf32_rs<D>(acc, al, dvh);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(acc);
      if (lane == 0) mbar_arrive(&empty_v[stage]);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    float* ob = o + static_cast<long long>(bh) * Sq * Dt;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = 8 * n + 2 * t;
      if (col >= Dt) continue;                         // the instance's columns past D
      if (r0 < Sq)
        *reinterpret_cast<float2*>(ob + static_cast<long long>(r0) * Dt + col) =
            make_float2(acc[4 * n] / d0, acc[4 * n + 1] / d0);
      if (r1 < Sq)
        *reinterpret_cast<float2*>(ob + static_cast<long long>(r1) * Dt + col) =
            make_float2(acc[4 * n + 2] / d1, acc[4 * n + 3] / d1);
    }
  }
}

// The parts of q or k, elementwise: n floats, n a multiple of 4.
__global__ void __launch_bounds__(256)
split_rows_kernel(const float4* __restrict__ x, float4* __restrict__ hi, float4* __restrict__ lo,
                  long long n4) {
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n4; i += 256ll * gridDim.x) {
    const float4 v = x[i];
    hi[i] = make_float4(__uint_as_float(tf32_hi(v.x)), __uint_as_float(tf32_hi(v.y)),
                        __uint_as_float(tf32_hi(v.z)), __uint_as_float(tf32_hi(v.w)));
    lo[i] = make_float4(__uint_as_float(tf32_lo(v.x)), __uint_as_float(tf32_lo(v.y)),
                        __uint_as_float(tf32_lo(v.z)), __uint_as_float(tf32_lo(v.w)));
  }
}

// The parts of v^T: a (32 keys, 32 dims) tile of slice blockIdx.z through
// shared memory, written as (dims, keys) rows of Skp with the keys of each
// group of 8 permuted (the module comment) and zeros past Sk; D rows, the
// true head dim (a multiple of 8: the last tile's dims past D are skipped).
__global__ void __launch_bounds__(256)
split_vt_kernel(const float* __restrict__ v, float* __restrict__ vh, float* __restrict__ vl,
                int Sk, int Skp, int D) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, d0 = blockIdx.y * 32, z = blockIdx.z;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const float* vz = v + static_cast<long long>(z) * Sk * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 8 * i;
    tile[ty + 8 * i][tx] =
        key < Sk && d0 + tx < D ? vz[static_cast<long long>(key) * D + d0 + tx] : 0.f;
  }
  __syncthreads();
  const int c = tx % 8;
  const int src = tx - c + (c < 4 ? 2 * c : 2 * (c - 4) + 1);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = d0 + ty + 8 * i;
    if (d >= D) break;
    const float x = tile[src][ty + 8 * i];
    const long long at = (static_cast<long long>(z) * D + d) * Skp + k0 + tx;
    vh[at] = __uint_as_float(tf32_hi(x));
    vl[at] = __uint_as_float(tf32_lo(x));
  }
}

// (slices, rows, inner) float32 as a 3-D tensor map of (32, box_rows, 1)
// boxes in the 128-byte swizzle; rows and inner elements past the edge
// arrive as zeros.
int f32_map(CUtensorMap* map, const void* base, int slices, int rows, int inner, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(slices)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(inner) * 4,
                                 static_cast<cuuint64_t>(inner) * 4 * static_cast<cuuint64_t>(rows)};
  const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

template <int D>
int launch_tf32(const void* const* parts, void* o, int B, int H, int KVH, int Sq, int Sk, int Skp,
                int Dt, float scale, const Mask& mask, cudaStream_t st) {
  using L = Tiles32<D>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_tf32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  CUtensorMap m[6];
  int rc = 0;
  // The parts hold the true head dim Dt: q and k rows of Dt, v^T Dt rows;
  // the instance's columns (rows of v^T) past Dt arrive as zeros.
  for (int i = 0; i < 2 && rc == 0; ++i) rc = f32_map(&m[i], parts[i], B * H, Sq, Dt, BQ);
  for (int i = 2; i < 4 && rc == 0; ++i) rc = f32_map(&m[i], parts[i], B * KVH, Sk, Dt, L::BK);
  for (int i = 4; i < 6 && rc == 0; ++i) rc = f32_map(&m[i], parts[i], B * KVH, Dt, Skp, D);
  if (rc != 0) return rc;
  const long long blocks = static_cast<long long>((Sq + BQ - 1) / BQ) * B * H;
  if (blocks > 0x7fffffffll) return -1;
  flash_tf32_kernel<D><<<static_cast<unsigned>(blocks), NT, L::SMEM, st>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], static_cast<float*>(o), H, KVH, Sq, Sk, Dt, scale,
      mask);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes. Each returns 0 on success, a
// cudaError_t code if a launch was refused, -1 for sizes or a head dim
// that have no compiled instance, and -2 / -3 if libcuda's tensor-map
// encoder is missing / refused the operands. D is the true head dim: a
// multiple of 8, at most 256 (instance_dim).

namespace {

bool head_dim_ok(int D) { return D >= 8 && D <= 256 && D % 8 == 0; }

}  // namespace

// flash_attention: contiguous q (B, H, Sq, D), k and v (B, KVH, Sk, D), o
// (B, H, Sq, D), 16-byte aligned; dtype 1 = bf16, 2 = float16 at any D
// (the wgmma kernel), 0 = float32 at 128 < D <= 256 (the FFMA kernel).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                               int H, int KVH, int Sq, int Sk, int D, int dtype,
                               float scale, int causal, int has_window, int window,
                               void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || Sq <= 0 || Sk <= 0 || !head_dim_ok(D))
    return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Mask mask{Sk, causal, has_window, window};
  switch (dtype) {
    case 0: return D > 128 ? launch_f32<256>(q, k, v, o, B, H, KVH, Sq, Sk, D, scale, mask, st) : -1;
    case 1:
      return launch_16_any<__nv_bfloat16>(q, k, v, o, B, H, KVH, Sq, Sk, D, scale, mask, st);
    case 2: return launch_16_any<__half>(q, k, v, o, B, H, KVH, Sq, Sk, D, scale, mask, st);
    default: return -1;
  }
}

// flash_split_tf32: the 3xTF32 parts of contiguous float32 q, k, v as
// above: parts[0..3] = qh, ql (B, H, Sq, D), kh, kl (B, KVH, Sk, D);
// parts[4..5] = vh, vl (B, KVH, D, Skp), Skp = Sk rounded up to 32.
extern "C" int flash_split_tf32(const void* q, const void* k, const void* v, void* const* parts,
                                int B, int H, int KVH, int Sq, int Sk, int Skp, int D,
                                void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || Sq <= 0 || Sk <= 0 || !head_dim_ok(D) || Skp % 32 != 0 ||
      Skp < Sk || static_cast<long long>(B) * KVH > 65535)
    return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nq = static_cast<long long>(B) * H * Sq * D / 4;
  const long long nk = static_cast<long long>(B) * KVH * Sk * D / 4;
  const auto blocks = [](long long n4) { return static_cast<unsigned>(n4 / 256 < 8192 ? n4 / 256 + 1 : 8192); };
  split_rows_kernel<<<blocks(nq), 256, 0, st>>>(
      static_cast<const float4*>(q), static_cast<float4*>(parts[0]),
      static_cast<float4*>(parts[1]), nq);
  split_rows_kernel<<<blocks(nk), 256, 0, st>>>(
      static_cast<const float4*>(k), static_cast<float4*>(parts[2]),
      static_cast<float4*>(parts[3]), nk);
  split_vt_kernel<<<dim3(Skp / 32, (D + 31) / 32, B * KVH), 256, 0, st>>>(
      static_cast<const float*>(v), static_cast<float*>(parts[4]), static_cast<float*>(parts[5]),
      Sk, Skp, D);
  return static_cast<int>(cudaGetLastError());
}

// flash_attention_tf32: the 3xTF32 kernel on the parts of flash_split_tf32
// (16-byte aligned) into o (B, H, Sq, D) float32, D <= 128.
extern "C" int flash_attention_tf32(const void* const* parts, void* o, int B, int H, int KVH,
                                    int Sq, int Sk, int Skp, int D, float scale, int causal,
                                    int has_window, int window, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || Sq <= 0 || Sk <= 0 || Skp % 32 != 0 ||
      Skp < Sk || !head_dim_ok(D) || D > 128)
    return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Mask mask{Sk, causal, has_window, window};
  if (D <= 32) return launch_tf32<32>(parts, o, B, H, KVH, Sq, Sk, Skp, D, scale, mask, st);
  if (D <= 64) return launch_tf32<64>(parts, o, B, H, KVH, Sq, Sk, Skp, D, scale, mask, st);
  return launch_tf32<128>(parts, o, B, H, KVH, Sq, Sk, Skp, D, scale, mask, st);
}
