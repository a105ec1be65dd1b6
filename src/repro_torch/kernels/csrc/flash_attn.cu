// Fused flash attention for Hopper (sm_90a): softmax(q k^T * scale, masked)
// v for q (B, H, Sq, D) against k and v (B, KVH, Sk, D), float32 or bf16,
// with grouped-query heads and causal and/or sliding-window masks.
//
// Replaces the Pallas kernel of the JAX package
//   src/repro/kernels/flash_attn.py  flash_attention (_kernel)
//
// What one block computes: one (b, h, q-tile of BQ = 64 rows), in four
// warps of 16 rows each, with a loop over the k tiles of BK keys. The
// score tile, the running max m, the running denominator l and the output
// accumulator stay on chip (registers; the float32 path also parks each
// warp's probabilities in shared memory), so only q, k, v and o touch
// device memory. The kv head is h / (H / KVH): k and v are read in place
// for every q head of their group, never repeated in memory.
//
//   * bf16: S = Q K^T and O += P V on bf16 mma.sync m16n8k16 with float32
//     accumulate. Q and K are row-major in shared memory; V is stored
//     transposed (d, key) so that a B fragment is one 32-bit load. The
//     score accumulators are in the A-fragment layout of the next MMA, so
//     P goes from registers to the PV product without shared memory.
//   * float32: the same fragment layout (each thread owns rows g and g+8
//     of its warp and columns 2t, 2t+1 of every 8-wide tile), computed with
//     FFMA in true float32 from shared memory: TF32 would miss the 2e-5 bar.
//
// Numerics, as the reference kernel and its oracle (src/repro/kernels/
// ref.py flash_attention):
//   * a masked score is the finite -1e30, never -inf: a row whose keys are
//     all masked (a window, Sq > Sk) averages v uniformly, as the reference
//     does; keys past Sk in the last tile are left out (probability 0);
//   * masks are top-left aligned: rel = q_pos - k_pos, both from 0; causal
//     keeps rel >= 0, a window keeps rel < window;
//   * the scale multiplies the float32 score; the output divides by
//     max(l, 1e-30); in bf16, P is rounded to bf16 for the PV product while
//     l sums the unrounded probabilities, as the reference's p.astype(v);
//   * expf, not __expf, and no --use_fast_math.
// A k tile that no row of the q tile can see is skipped; when some row of
// the tile has no visible key at all, every tile is visited, so that row's
// uniform average spans all Sk keys as in the reference.
//
// Bound: operations for long sequences (4 B H Sq Sk D flops over the
// unmasked pairs, at the bf16 tensor-core or the float32 FFMA peak) and
// bytes for short ones. This first version uses mma.sync with one tile in
// flight and no pipelining, so it stays above that bound (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;
constexpr int NWARPS = 4;
constexpr int NT = NWARPS * 32;
constexpr float NEG_INF = -1e30f;

template <typename T, int D>
struct Layout {
  static constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int BK = D == 256 ? 32 : 64;
  static constexpr int PAD = BF16 ? 8 : 4;         // keeps 16-byte rows, shifts banks
  static constexpr int QLD = D + PAD;              // sQ (BQ, D)
  static constexpr int KLD = D + PAD;              // sK (BK, D)
  static constexpr int VLD = BF16 ? BK + 8 : D + PAD;  // sV: (D, BK) bf16, (BK, D) f32
  static constexpr int VROWS = BF16 ? D : BK;
  static constexpr int PLD = BK + 4;               // sP (f32 only): (NWARPS, 16, BK)
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + BQ * QLD;
  static constexpr int V_OFF = K_OFF + BK * KLD;
  static constexpr int P_OFF = V_OFF + VROWS * VLD;
  static constexpr int ELEMS = BF16 ? P_OFF : P_OFF + NWARPS * 16 * PLD;
  static constexpr size_t BYTES = static_cast<size_t>(ELEMS) * (BF16 ? 2 : 4);
};

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// c += a b for one m16n8k16 tile: bf16 operands, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float c) {
  c = fmaf(a.x, b.x, c);
  c = fmaf(a.y, b.y, c);
  c = fmaf(a.z, b.z, c);
  return fmaf(a.w, b.w, c);
}

// Copy rows [r0, r0 + rows) of a (S, D) matrix into shared memory with row
// stride ld, zeros past S; 16 bytes a thread at a time.
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* __restrict__ src, int r0,
                                          int rows, int S) {
  constexpr int VEC = 16 / sizeof(T);
  for (int c = threadIdx.x; c < rows * (D / VEC); c += NT) {
    const int r = c / (D / VEC), d = (c % (D / VEC)) * VEC;
    int4 v = make_int4(0, 0, 0, 0);
    if (r0 + r < S) v = *reinterpret_cast<const int4*>(src + static_cast<long long>(r0 + r) * D + d);
    *reinterpret_cast<int4*>(dst + r * ld + d) = v;
  }
}

// The same for bf16 V, stored transposed: dst[d * ld + key]. Threads walk
// the keys, so neighbouring threads store neighbouring halves.
template <int D, int BK>
__device__ __forceinline__ void load_vt(__nv_bfloat16* dst, int ld,
                                        const __nv_bfloat16* __restrict__ src, int r0, int S) {
  for (int c = threadIdx.x; c < BK * (D / 8); c += NT) {
    const int key = c % BK, d = (c / BK) * 8;
    int4 v = make_int4(0, 0, 0, 0);
    if (r0 + key < S)
      v = *reinterpret_cast<const int4*>(src + static_cast<long long>(r0 + key) * D + d);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(d + i) * ld + key] = e[i];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int H, int KVH, int Sq, int Sk, float scale, int causal,
             int has_window, int window) {
  using L = Layout<T, D>;
  constexpr int BK = L::BK;
  constexpr int NS = BK / 8;   // 8-wide score tiles of a row block
  constexpr int ND = D / 8;    // 8-wide output tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  T* sQ = smem + L::Q_OFF;
  T* sK = smem + L::K_OFF;
  T* sV = smem + L::V_OFF;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KVH);
  const T* qb = q + static_cast<long long>(b * H + h) * Sq * D;
  const T* kb = k + static_cast<long long>(b * KVH + kh) * Sk * D;
  const T* vb = v + static_cast<long long>(b * KVH + kh) * Sk * D;
  T* ob = o + static_cast<long long>(b * H + h) * Sq * D;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int qr0 = q0 + warp * 16 + g, qr1 = qr0 + 8;

  // The keys a row qq can see are [lo(qq), hi(qq)]; both ends grow with qq.
  auto lo_of = [&](int qq) { return has_window ? max(0, qq - window + 1) : 0; };
  auto hi_of = [&](int qq) { return causal ? min(Sk - 1, qq) : Sk - 1; };
  auto masked = [&](int qq, int kc) {
    const int rel = qq - kc;
    return (causal && rel < 0) || (has_window && rel >= window);
  };
  // lo - hi is largest at an end row of the tile (it falls, then rises).
  const int qlast = min(q0 + BQ, Sq) - 1;
  const bool empty_row = lo_of(q0) > hi_of(q0) || lo_of(qlast) > hi_of(qlast);
  int kt0 = 0, kt1 = (Sk + BK - 1) / BK;
  if (!empty_row) {
    kt0 = lo_of(q0) / BK;
    kt1 = hi_of(qlast) / BK + 1;
  }

  load_rows<T, D>(sQ, L::QLD, qb, q0, BQ, Sq);

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BK;
    load_rows<T, D>(sK, L::KLD, kb, k0, BK, Sk);
    if constexpr (L::BF16)
      load_vt<D, BK>(sV, L::VLD, vb, k0, Sk);
    else
      load_rows<T, D>(sV, L::VLD, vb, k0, BK, Sk);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows.
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    const T* qw = sQ + warp * 16 * L::QLD;
    if constexpr (L::BF16) {
#pragma unroll 4
      for (int kd = 0; kd < D; kd += 16) {
        const uint32_t a0 = lds32(qw + g * L::QLD + kd + 2 * t);
        const uint32_t a1 = lds32(qw + (g + 8) * L::QLD + kd + 2 * t);
        const uint32_t a2 = lds32(qw + g * L::QLD + kd + 2 * t + 8);
        const uint32_t a3 = lds32(qw + (g + 8) * L::QLD + kd + 2 * t + 8);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const T* kr = sK + (8 * n + g) * L::KLD + kd + 2 * t;
          mma_bf16(s[n], a0, a1, a2, a3, lds32(kr), lds32(kr + 8));
        }
      }
    } else {
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        const float4 qa = *reinterpret_cast<const float4*>(qw + g * L::QLD + d);
        const float4 qc = *reinterpret_cast<const float4*>(qw + (g + 8) * L::QLD + d);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const float4 ka = *reinterpret_cast<const float4*>(sK + (8 * n + 2 * t) * L::KLD + d);
          const float4 kc = *reinterpret_cast<const float4*>(sK + (8 * n + 2 * t + 1) * L::KLD + d);
          s[n][0] = dot4(qa, ka, s[n][0]);
          s[n][1] = dot4(qa, kc, s[n][1]);
          s[n][2] = dot4(qc, ka, s[n][2]);
          s[n][3] = dot4(qc, kc, s[n][3]);
        }
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
          x0 = masked(qr0, kc) ? NEG_INF : s[n][j] * scale;
          x1 = masked(qr1, kc) ? NEG_INF : s[n][2 + j] * scale;
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

    // O += P V.
    if constexpr (L::BF16) {
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        // Two adjacent score tiles are one A fragment (keys 16 kc .. +15).
        const uint32_t a0 = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
        const uint32_t a1 = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
        const uint32_t a2 = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
        const uint32_t a3 = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          const T* vr = sV + (8 * n + g) * L::VLD + 16 * kc + 2 * t;
          mma_bf16(acc[n], a0, a1, a2, a3, lds32(vr), lds32(vr + 8));
        }
      }
    } else {
      float* pw = reinterpret_cast<float*>(smem) + L::P_OFF + warp * 16 * L::PLD;
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
          const float2 vv = *reinterpret_cast<const float2*>(sV + j * L::VLD + 8 * n + 2 * t);
          acc[n][0] = fmaf(p0, vv.x, acc[n][0]);
          acc[n][1] = fmaf(p0, vv.y, acc[n][1]);
          acc[n][2] = fmaf(p1, vv.x, acc[n][2]);
          acc[n][3] = fmaf(p1, vv.y, acc[n][3]);
        }
      }
    }
    __syncthreads();   // every warp is done with sK, sV (and its sP) before the next load
  }

  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = 8 * n + 2 * t;
    if constexpr (L::BF16) {
      if (qr0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<long long>(qr0) * D + col) =
            __floats2bfloat162_rn(acc[n][0] / d0, acc[n][1] / d0);
      if (qr1 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<long long>(qr1) * D + col) =
            __floats2bfloat162_rn(acc[n][2] / d1, acc[n][3] / d1);
    } else {
      if (qr0 < Sq)
        *reinterpret_cast<float2*>(ob + static_cast<long long>(qr0) * D + col) =
            make_float2(acc[n][0] / d0, acc[n][1] / d0);
      if (qr1 < Sq)
        *reinterpret_cast<float2*>(ob + static_cast<long long>(qr1) * D + col) =
            make_float2(acc[n][2] / d1, acc[n][3] / d1);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KVH, int Sq,
           int Sk, float scale, int causal, int has_window, int window, cudaStream_t st) {
  using L = Layout<T, D>;
  cudaError_t e = cudaFuncSetAttribute(flash_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L::BYTES));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_kernel<T, D><<<grid, NT, L::BYTES, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, KVH, Sq, Sk, scale, causal, has_window, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* o, int B, int H, int KVH,
             int Sq, int Sk, float scale, int causal, int has_window, int window,
             cudaStream_t st) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, B, H, KVH, Sq, Sk, scale, causal, has_window, window, st);
    case 64: return launch<T, 64>(q, k, v, o, B, H, KVH, Sq, Sk, scale, causal, has_window, window, st);
    case 128: return launch<T, 128>(q, k, v, o, B, H, KVH, Sq, Sk, scale, causal, has_window, window, st);
    case 256: return launch<T, 256>(q, k, v, o, B, H, KVH, Sq, Sk, scale, causal, has_window, window, st);
    default: return -1;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes: contiguous q (B, H, Sq, D), k and
// v (B, KVH, Sk, D), o (B, H, Sq, D), 16-byte aligned. Returns 0 on
// success, a cudaError_t code if the launch was refused, and -1 for sizes
// or a head dim that have no compiled instance.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                               int H, int KVH, int Sq, int Sk, int D, int is_bf16,
                               float scale, int causal, int has_window, int window,
                               void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || Sq <= 0 || Sk <= 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_d<__nv_bfloat16>(D, q, k, v, o, B, H, KVH, Sq, Sk, scale, causal, has_window,
                                   window, st);
  return launch_d<float>(D, q, k, v, o, B, H, KVH, Sq, Sk, scale, causal, has_window, window,
                         st);
}
