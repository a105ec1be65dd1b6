// EmuGEMM-II's plane route for Hopper (sm_90a): Scheme II as an encode
// kernel and a TMA-fed wgmma plane GEMM.
//
// Replaces, for float64 operands, for every complex product and for the
// prepared form, the Pallas kernels of the JAX package
//   src/repro/kernels/backends/gpu.py  fused_matmul_scheme2 (_kernel2), float64 2-D launch
//   src/repro/kernels/backends/gpu.py  fused_matmul_scheme2 (_kernel2, b_res), prepared launch
//   src/repro/kernels/backends/gpu.py  fused_matmul_scheme2_batched, float64 operands
//   src/repro/kernels/backends/gpu.py  fused_matmul_3m (_kernel2_3m), 2-D and batched
// (float32 / bf16 products with a float rhs, the residue form and float32
// operands to a float64 output stay on emugemm2.cu; the complex residue
// form K7 on emugemm3m.cu). The prepared form is a float32, bf16 or
// float64 lhs encoded here against a weight whose planes were encoded here
// once, when it was prepared (kernels/prepared.py), with float32 scales for
// a float32 / bf16 pair (a bf16 power of two widens exactly).
//
// Every product carries a batch coordinate Bt; a 2-D product is Bt = 1.
//
// encode: one pass over an operand, read through its strides, writes the
// balanced int8 residues of every modulus as K-contiguous planes: a
// (Bt, R, K) operand with a per-row scale s (A with mu; B as B^T with nu)
// becomes planes (p, T, Bt, R, Kp), T = 1 ([x]) or, for 3M, T = 3 ([re,
// im, bal(re + im)], complex3m.phase_residues); Kp is K padded with zero
// residues to the plane GEMM's K tile; the batch element is blockIdx.z.
// Each element is integerized once,
// trunc(x * s) in its type (a bf16 element widens to float32 exactly on
// load, and its product rounds to bf16 before the truncation), and carved
// p times (the fused kernel it replaces integerized it N / 64 times and
// carved it 64 * p times), by integer arithmetic alone: a float32 or bf16
// value as the int it truncates to (|x| < 2^24), a float64 value as four
// 16-bit limbs, each residue a Barrett quotient. Bound by bytes: (8 + p)
// bytes an element for float64, (2 + p) for bf16, (16 + 3p) for
// complex128.
//
// planes: one block per (BM, BN) = (128, 256) output tile of one batch
// element (128 x 128 when those still fit in one wave of the SMs, as at 8
// x 512^3: the CRT epilogue then runs on twice the SMs), 384 threads:
//   * one producer thread keeps a ring of 4 shared stages filled by TMA
//     (cp.async.bulk.tensor, 128-byte swizzle, mbarriers): the (128, 128)
//     A tile and (256, 128) B tile of one plane and K tile, 48 KB a stage;
//     the tensor maps are 4-D (Kp, rows, Bt, planes), so rows past M or N
//     arrive as zeros in every batch element;
//   * two consumer warpgroups, 64 rows each, run wgmma m64n128k32
//     s32.s8.s8 (two a k-step, one per 128 columns) on the arrived tiles,
//     modulus-outer and K-inner: for each modulus (for 3M each of the 3p
//     (modulus, phase) products) one int32 accumulator set (128 registers
//     a thread) covers the whole K, floor-reduced mod m every KR K tiles
//     (KR * 128 * (m // 2)^2 < 2^31, so any K the fused kernel takes is
//     exact) and once at the end;
//   * the reduced residues are parked as bytes in a block-private global
//     scratch (p bytes an output element, 2p for 3M) by the thread that
//     owns them, and read back by the same thread in the epilogue, so no
//     barrier guards the park. For 3M, T1 is parked, T2 turns it into
//     C_re = (T1 - T2) mod m and parks S = (T1 + T2) mod m, and T3 turns S
//     into C_im = (T3 - S) mod m: each product is reduced before it is
//     combined, as the reference's (t1m - t2m) mod m and (t3m - t1m - t2m)
//     mod m, and three full-K sums never add up in int32;
//   * epilogue: four elements at a time, balanced Garner digits in exact
//     int32 in direct form (one Barrett reduction a digit, no
//     conversions) and the double-double Horner of scheme2_common.cuh op
//     for op (float64 for a float64 output, float32 otherwise; a bf16
//     output rounds every op to bf16 through float32), then / (mu * nu)
//     (real) or * 1 / (mu * nu) (3M), rounded to the output type.
// The park: a shared one (p * BM * BN bytes, 2p for 3M) would not fit
// beside the ring at p = 16 even at 128 x 128 (256 KB), and a smaller
// tile re-reads each plane more often (L2 traffic per modulus M*K*N/BN +
// K*N*M/BM bytes). The global park costs 2p bytes an output element of
// write and read (0.54 GB, about 0.16 ms at 3.35 TB/s for a 4096^2 DGEMM
// at p = 16; twice that for 3M), mostly in L2, and lets the tile be
// 128 x 256.
// Bound: a 4096^3 DGEMM at p = 16 is 16 int8 GEMMs (1.1 ms at the int8
// peak); a ZGEMM 48 (3.3 ms). The mainloop is held below the peak by L2:
// each K tile brings 48 KB to each block, about 11 TB/s over 132 SMs at
// the peak rate. The epilogue (p(p-1)/2 multiply-adds, p reductions and
// p - 1 double-double Horner steps an element, twice for 3M) runs after
// the tile's mainloop, in series with it. Tiles are rastered in groups of
// GROUP_M tile rows for L2 reuse (PERF.md measures all of it). A prepared
// GEMM of olmo-1b's hoisted train step (512 x 2048 x 2048, m = 6, bf16) is
// 6 int8 GEMMs, 0.013 ms at the int8 peak, against 0.006 ms for its bytes;
// its 64 narrow tiles fill half the SMs once, so one tile's mainloop and
// CRT in series set its time.
//
// Numerics: see scheme2_common.cuh. The plain versions are
// repro_torch.kernels.ozaki2.encode_planes_plain / plane_matmul_plain and
// repro_torch.kernels.ozaki3m.encode_planes_3m_plain / plane_matmul_3m_plain.

#include "hopper.cuh"
#include "scheme2_common.cuh"

using namespace s2;
using namespace hopper;

namespace {

// Operand and output types of the entry points (kernels/ozaki2.py TYPE_CODE).
enum { F32 = 0, BF16 = 1, F64 = 2 };

// ---- Barrett floor moduli --------------------------------------------------
// Per-modulus constants for the exact floor modulo of integers without a
// conversion: magic = floor(2^32 / m) + 1; c16, c32, c48 = 2^16, 2^32,
// 2^48 mod m; and bias, a multiple of m in [2^23, 2^23 + 256) that makes
// the operand non-negative.
struct Barrett {
  unsigned magic[MAXP];
  int c16[MAXP];
  int c32[MAXP];
  int c48[MAXP];
  int bias[MAXP];
};

inline void make_barrett(const Crt& crt, Barrett& br) {
  for (int i = 0; i < MAXP; ++i) {
    const unsigned long long m = static_cast<unsigned>(crt.m[i]);
    br.magic[i] = static_cast<unsigned>((1ull << 32) / m + 1);
    br.c16[i] = static_cast<int>((1ull << 16) % m);
    br.c32[i] = static_cast<int>((1ull << 32) % m);
    br.c48[i] = static_cast<int>((1ull << 48) % m);
    br.bias[i] = static_cast<int>(m * ((1u << 23) / m + 1));
  }
}

// y mod m for 0 <= y < 2^31: umulhi(y, magic) is floor(y / m) or one
// more (y * (magic - 2^32 / m) < 2^32), which the correction absorbs.
__device__ __forceinline__ int barrett(int y, int m, unsigned magic) {
  const int r = y - static_cast<int>(__umulhi(static_cast<unsigned>(y), magic)) * m;
  return r < 0 ? r + m : r;
}

// y mod m for 0 <= y < 2^24, with no correction: y * (magic - 2^32 / m)
// / 2^32 < 2^-8 <= 1 / m, too little to carry floor(y / m) to the next
// integer.
__device__ __forceinline__ int barrett_exact(int y, int m, unsigned magic) {
  return y - static_cast<int>(__umulhi(static_cast<unsigned>(y), magic)) * m;
}

// Floor modulo of |x| < 2^22 (Garner terms, sums of residues).
__device__ __forceinline__ int mod_small(int x, const Barrett& br, int m, int i) {
  return barrett_exact(x + br.bias[i], m, br.magic[i]);
}

// Floor modulo of any int32 (a full-K accumulator): x = hi * 2^16 + lo
// with |hi * c16| < 2^23 and 0 <= lo < 2^16.
__device__ __forceinline__ int mod_full(int x, const Barrett& br, int m, int i) {
  return barrett((x >> 16) * br.c16[i] + (x & 0xffff) + br.bias[i], m, br.magic[i]);
}

// An exact integer |v| < 2^53 as 16-bit limbs, v = x3 2^48 + x2 2^32 +
// x1 2^16 + x0 (x0, x1, x2 in [0, 2^16), |x3| <= 32), so that
// v mod m = (x3 c48 + x2 c32 + x1 c16 + x0) mod m, below 2^26 with the
// bias added.
struct Limbs {
  int x0, x1, x2, x3;
};

__device__ __forceinline__ Limbs limbs(double v) {
  const long long i = __double2ll_rz(v);
  return Limbs{static_cast<int>(i & 0xffff), static_cast<int>((i >> 16) & 0xffff),
               static_cast<int>((i >> 32) & 0xffff), static_cast<int>(i >> 48)};
}

__device__ __forceinline__ int mod_limbs(const Limbs& v, const Barrett& br, int m, int i) {
  return barrett(v.x3 * br.c48[i] + v.x2 * br.c32[i] + v.x1 * br.c16[i] + v.x0 + br.bias[i], m,
                 br.magic[i]);
}

// ---- encode ----------------------------------------------------------------

constexpr int ER = 64;           // rows of an encode block
constexpr int EK = 64;           // K columns of an encode block
constexpr int ELD = EK + 1;      // staged row stride, padded against bank conflicts

template <typename T, bool CPLX>
__host__ __device__ constexpr int encode_smem() {
  return (CPLX ? 2 : 1) * ER * ELD * static_cast<int>(sizeof(typename Num<T>::S));
}

// An integerized value as the carve reads it: an int (float32 parts,
// |x| < 2^24) as it is, an exact integer in a double as its 16-bit limbs
// (one conversion per element; the p reductions are integer arithmetic).
__device__ __forceinline__ int carve_form(int x) { return x; }
__device__ __forceinline__ Limbs carve_form(double x) { return limbs(x); }
__device__ __forceinline__ int residue(int x, const Barrett& br, int m, int l) {
  return mod_full(x, br, m, l);
}
__device__ __forceinline__ int residue(const Limbs& x, const Barrett& br, int m, int l) {
  return mod_limbs(x, br, m, l);
}

// xi: the imaginary part (CPLX; null for a real operand of a complex
// product, whose imaginary residues are zero); planes (p, T, Bt, R, Kp).
// Batch element blockIdx.z reads x at z * sb and its scales at z * ssb.
template <typename T, bool CPLX>
__global__ void __launch_bounds__(NT)
encode_kernel(const T* __restrict__ xr, const T* __restrict__ xi, const T* __restrict__ scale,
              int8_t* __restrict__ planes, int R, int K, int Kp, long long sr, long long sk,
              long long sb, long long ssb, const __grid_constant__ Crt crt,
              const __grid_constant__ Barrett br) {
  using W = typename Num<T>::W;
  using S = typename Num<T>::S;
  constexpr int TP = CPLX ? 3 : 1;
  extern __shared__ __align__(16) uint8_t enc_smem[];
  S* sr_ = reinterpret_cast<S*>(enc_smem);                 // [ER][ELD]
  S* si_ = sr_ + ER * ELD;                                 // [ER][ELD] (CPLX)
  __shared__ W sS[ER];

  const int r0 = blockIdx.y * ER;
  const int k0 = blockIdx.x * EK;
  const int bt = blockIdx.z, batch = gridDim.z;
  const int tid = threadIdx.x;
  xr += bt * sb;
  if (xi) xi += bt * sb;
  scale += bt * ssb;
  if (tid < ER) sS[tid] = r0 + tid < R ? widen(scale[r0 + tid]) : W(0);
  __syncthreads();

  // Integerize the tile once; threads walk the operand's unit-stride axis.
  const bool kwalk = sk <= sr;
#pragma unroll 4
  for (int e = tid; e < ER * EK; e += NT) {
    const int rr = kwalk ? e / EK : e % ER;
    const int kk = kwalk ? e % EK : e / ER;
    const int gr = r0 + rr, gk = k0 + kk;
    const bool in = gr < R && gk < K;
    const long long g = gr * sr + gk * sk;
    sr_[rr * ELD + kk] = in ? integerize(widen(xr[g]), sS[rr], T()) : S(0);
    if constexpr (CPLX) si_[rr * ELD + kk] = in && xi ? integerize(widen(xi[g]), sS[rr], T()) : S(0);
  }
  __syncthreads();

  // Each thread carves 8 consecutive K of two rows, held in registers
  // across the moduli, and stores each (row, modulus, phase) as one
  // 8-byte word: a warp writes 4 rows of 64 contiguous bytes.
  const int kc = (tid % (EK / 8)) * 8;
  for (int half = 0; half < 2; ++half) {
    const int rr = tid / (EK / 8) + half * (ER / 2);
    if (r0 + rr >= R) break;
    decltype(carve_form(S())) vr[8], vi[CPLX ? 8 : 1];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      vr[j] = carve_form(sr_[rr * ELD + kc + j]);
      if constexpr (CPLX) vi[j] = carve_form(si_[rr * ELD + kc + j]);
    }
    for (int l = 0; l < crt.p; ++l) {
      const int m = crt.m[l], top = m - m / 2;   // residues from top up balance to r - m
      uint32_t b[TP][2] = {};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int sh = 8 * (j % 4);
        int re = residue(vr[j], br, m, l);
        re = re >= top ? re - m : re;
        b[0][j / 4] |= static_cast<uint32_t>(re & 0xff) << sh;
        if constexpr (CPLX) {
          int im = residue(vi[j], br, m, l);
          im = im >= top ? im - m : im;
          int sum = mod_small(re + im, br, m, l);
          sum = sum >= top ? sum - m : sum;
          b[1][j / 4] |= static_cast<uint32_t>(im & 0xff) << sh;
          b[2][j / 4] |= static_cast<uint32_t>(sum & 0xff) << sh;
        }
      }
#pragma unroll
      for (int t = 0; t < TP; ++t)
        *reinterpret_cast<uint2*>(
            planes + (((static_cast<long long>(l) * TP + t) * batch + bt) * R + r0 + rr) * Kp + k0 +
            kc) = make_uint2(b[t][0], b[t][1]);
    }
  }
}

// ---- the plane GEMM ----------------------------------------------------------

constexpr int PBM = 128;                  // output tile rows: two consumer warpgroups
constexpr int PBK = 128;                  // K tile: one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int A_BYTES = PBM * PBK;
constexpr int CONSUMER_THREADS = 256;
constexpr int PT = CONSUMER_THREADS + 128;   // and one producer warpgroup
constexpr int GROUP_M = 16;               // tile rows of a raster group

// The output tile's columns: NH halves of 128, one m64n128 each per
// k-step. NH = 2 (128 x 256) is the tile; NH = 1 (128 x 128) is for grids
// whose narrow tiles still fit in one wave, where it doubles the blocks
// that run the CRT epilogue (kernels/ozaki2.py plane_tile_n chooses).
template <int NH>
struct Tile {
  static constexpr int BN = 128 * NH;
  static constexpr int B_BYTES = BN * PBK;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int GROUPS = PBM * BN / CONSUMER_THREADS / 4;   // 4-element groups a thread
  static constexpr int PARK_SLOT = PBM * BN;                      // bytes of a tile's park slot
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
};

// D (64 x 128 int32, the warpgroup's accumulator fragment) += A (64 x 32
// int8) * B (32 x 128 int8), both K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// The word of residue group g (four bytes, one an element) in park slot
// s: each consumer thread owns one word a group, and a warp's words are
// contiguous.
template <int NH>
__device__ __forceinline__ uint32_t* park_word(uint8_t* tile_park, int s, int g, int ct) {
  return reinterpret_cast<uint32_t*>(tile_park + static_cast<long long>(s) * Tile<NH>::PARK_SLOT) +
         g * CONSUMER_THREADS + ct;
}

__device__ __forceinline__ int byte_of(uint32_t w, int i) { return (w >> (8 * i)) & 0xff; }

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return static_cast<uint32_t>(a) | (static_cast<uint32_t>(b) << 8) |
         (static_cast<uint32_t>(c) << 16) | (static_cast<uint32_t>(d) << 24);
}

// Garner's digits in direct form. The recurrence t = ((t - d_j) inv_ij)
// mod m_i over j < i unrolls to t_i = r_i a_i + sum_j d_j b_ij (mod m_i)
// with a_i = prod_{j<i} inv_ij and b_ij = -prod_{j<=k<i} inv_ik (mod m_i),
// so each digit takes i multiply-adds and one reduction (|x| < 2^20)
// instead of i reductions; the digits, exact integers, are the same.
struct Digits {
  int a[MAXP];
  int b[MAXP][MAXP];
};

inline void make_digits(const Crt& crt, Digits& dg) {
  for (int i = 0; i < MAXP; ++i) {
    const long long m = crt.m[i];
    long long prod = 1;
    for (int j = i - 1; j >= 0; --j) {
      prod = prod * crt.inv[i][j] % m;
      dg.b[i][j] = static_cast<int>((m - prod) % m);
    }
    for (int j = i; j < MAXP; ++j) dg.b[i][j] = 0;
    dg.a[i] = static_cast<int>(prod);
  }
}

// Balanced digits of W elements (res(w, i) in [0, m_i)).
template <int W, typename Res>
__device__ __forceinline__ void direct_digits(const Crt& crt, const Digits& dg, const Barrett& br,
                                              Res res, int (&d)[W][MAXP]) {
#pragma unroll
  for (int i = 0; i < MAXP; ++i) {
    if (i < crt.p) {
      const int mi = crt.m[i];
#pragma unroll
      for (int w = 0; w < W; ++w) {
        int x = res(w, i) * dg.a[i];
#pragma unroll
        for (int j = 0; j < MAXP; ++j)
          if (j < i) x += d[w][j] * dg.b[i][j];
        const int t = mod_small(x, br, mi, i);
        d[w][i] = t > mi / 2 ? t - mi : t;
      }
    }
  }
}

// T: the scales' type (double, or float for float32 and bf16 operands); O:
// the output part type; CPLX: 3M (planes
// (p, 3, Bt, ., Kp), a complex output of interleaved parts). park: Bt *
// tiles * S * PARK_SLOT bytes, S = p (2p for 3M). kr: K tiles between
// reductions. Batch element z reads mu at z * smu, nu at z * snu and
// writes out at z * sout (in output parts).
template <typename T, typename O, bool CPLX, int NH>
__global__ void __launch_bounds__(PT, 1)
planes_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
              const T* __restrict__ mu, const T* __restrict__ nu, O* __restrict__ out,
              uint8_t* park, int M, int N, int nk, int kr, int epilogue, long long smu,
              long long snu, long long sout, const __grid_constant__ Crt crt,
              const __grid_constant__ Barrett br, const __grid_constant__ Digits dg) {
  constexpr int TP = CPLX ? 3 : 1;
  constexpr int PBN = Tile<NH>::BN, STAGE_BYTES = Tile<NH>::STAGE_BYTES;
  constexpr int GROUPS = Tile<NH>::GROUPS;
  using V = typename Out<O>::V;
  extern __shared__ __align__(16) uint8_t ring_smem[];
  const uint32_t pad = (1024 - (smem_u32(ring_smem) & 1023)) & 1023;
  uint8_t* ring = ring_smem + pad;                                  // [STAGES][A | B], 1024-aligned
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int p = crt.p;
  // Batch elements run one after another, and inside one the tiles run in
  // groups of GROUP_M tile rows, column by column, so that the blocks
  // resident together read a few row and column slabs of each plane, which
  // stay in L2 while they work through the moduli.
  const int tiles_m = (M + PBM - 1) / PBM, tiles_n = (N + PBN - 1) / PBN;
  const int bt = blockIdx.x / (tiles_m * tiles_n);
  const int tile = blockIdx.x % (tiles_m * tiles_n);
  const int first = (tile / (GROUP_M * tiles_n)) * GROUP_M;
  const int rows = min(tiles_m - first, GROUP_M);
  const int in_group = tile % (GROUP_M * tiles_n);
  const int m0 = (first + in_group % rows) * PBM;
  const int n0 = (in_group / rows) * PBN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMER_THREADS / 128) {
    // The producer: one thread streams (plane, K tile) pairs into the ring.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == CONSUMER_THREADS) {
      int stage = 0, phase = 0;
      for (int pl = 0; pl < p * TP; ++pl) {
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], STAGE_BYTES);
          uint8_t* st = ring + stage * STAGE_BYTES;
          tma_load_4d(st, &map_a, &full[stage], kt * PBK, m0, bt, pl);
          tma_load_4d(st + A_BYTES, &map_b, &full[stage], kt * PBK, n0, bt, pl);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int ct = threadIdx.x;                    // consumer thread, 0..255
    const int lane = ct % 32;
    uint8_t* tile_park =
        park + static_cast<long long>(blockIdx.x) * (CPLX ? 2 : 1) * p * Tile<NH>::PARK_SLOT;
    int acc[NH][64];
    int stage = 0, phase = 0;
    for (int l = 0; l < p; ++l) {
      const int m = crt.m[l];
      for (int t = 0; t < TP; ++t) {
#pragma unroll
        for (int h = 0; h < NH; ++h)
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[h][i] = 0;
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(&full[stage], phase);
          const uint8_t* st = ring + stage * STAGE_BYTES;
          const uint64_t da = desc_sw128(st + wg * 64 * PBK);
          const uint64_t db = desc_sw128(st + A_BYTES);
#pragma unroll
          for (int h = 0; h < NH; ++h) reg_fence(acc[h]);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < PBK / 32; ++ks)
#pragma unroll
            for (int h = 0; h < NH; ++h)
              wgmma_m64n128k32(acc[h], da + 2 * ks, db + h * (128 * PBK >> 4) + 2 * ks);
          wgmma_commit();
          wgmma_wait_all();
#pragma unroll
          for (int h = 0; h < NH; ++h) reg_fence(acc[h]);
          if (lane == 0) mbar_arrive(&empty[stage]);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
          if ((kt + 1) % kr == 0 && kt + 1 < nk) {
#pragma unroll
            for (int h = 0; h < NH; ++h)
#pragma unroll
              for (int i = 0; i < 64; ++i) acc[h][i] = mod_full(acc[h][i], br, m, l);
          }
        }
        // Reduce this product into [0, m) and park it; for 3M combine it
        // with what T1 (or T1 + T2) parked. Group g holds registers
        // 4 * (g % 16) + w of acc[g / 16]: rows r and r + 8 (w / 2),
        // columns c and c + 1 (w % 2) of the wgmma fragment. The parked
        // words are read eight at a time, so their latencies overlap.
#pragma unroll
        for (int c = 0; c < GROUPS / 8; ++c) {
          uint32_t prev[8];
          if (CPLX && t > 0) {
#pragma unroll
            for (int q = 0; q < 8; ++q) prev[q] = *park_word<NH>(tile_park, t == 1 ? l : p + l, 8 * c + q, ct);
          }
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int g = 8 * c + q;
            int v[4];
#pragma unroll
            for (int w = 0; w < 4; ++w) v[w] = mod_full(acc[g / 16][4 * (g % 16) + w], br, m, l);
            if (!CPLX || t == 0) {
              *park_word<NH>(tile_park, l, g, ct) = pack4(v[0], v[1], v[2], v[3]);
            } else if (t == 1) {
              int re[4], s[4];
#pragma unroll
              for (int w = 0; w < 4; ++w) {
                const int x = byte_of(prev[q], w);
                re[w] = x - v[w] < 0 ? x - v[w] + m : x - v[w];
                s[w] = x + v[w] >= m ? x + v[w] - m : x + v[w];
              }
              *park_word<NH>(tile_park, l, g, ct) = pack4(re[0], re[1], re[2], re[3]);
              *park_word<NH>(tile_park, p + l, g, ct) = pack4(s[0], s[1], s[2], s[3]);
            } else {
              int im[4];
#pragma unroll
              for (int w = 0; w < 4; ++w) {
                const int x = v[w] - byte_of(prev[q], w);
                im[w] = x < 0 ? x + m : x;
              }
              *park_word<NH>(tile_park, p + l, g, ct) = pack4(im[0], im[1], im[2], im[3]);
            }
          }
        }
      }
    }
    if (!epilogue) return;

    // CRT epilogue: each thread rebuilds the elements it parked.
    mu += bt * smu;
    nu += bt * snu;
    out += bt * sout;
    const int row0 = m0 + wg * 64 + ((ct % 128) / 32) * 16 + lane / 4;
    const int col0 = n0 + (lane % 4) * 2;
    for (int g = 0; g < GROUPS; ++g) {
      const int col = col0 + (g / 16) * 128 + (g % 16) * 8;
      // out(mu) * out(nu): real Scheme II divides by it, 3M multiplies
      // by its reciprocal, both rounded to the output type.
      V scale[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int gm = min(row0 + 8 * (w / 2), M - 1), gn = min(col + (w % 2), N - 1);
        scale[w] = Out<O>::mul(Out<O>::cvt(widen(mu[gm])), Out<O>::cvt(widen(nu[gn])));
        if constexpr (CPLX) scale[w] = Out<O>::div(V(1), scale[w]);
      }
#pragma unroll
      for (int part = 0; part < (CPLX ? 2 : 1); ++part) {
        uint32_t res[MAXP];
#pragma unroll
        for (int l = 0; l < MAXP; ++l) res[l] = l < p ? *park_word<NH>(tile_park, part * p + l, g, ct) : 0;
        int d[4][MAXP];
        direct_digits<4>(crt, dg, br, [&](int w, int i) { return byte_of(res[i], w); }, d);
        V c[4];
        horner<O, 4>(crt, d, c);
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int gm = row0 + 8 * (w / 2), gn = col + (w % 2);
          if (gm >= M || gn >= N) continue;
          const long long o = static_cast<long long>(gm) * N + gn;
          if constexpr (CPLX)
            Out<O>::store(out + 2 * o + part, Out<O>::mul(c[w], scale[w]));
          else
            Out<O>::store(out + o, Out<O>::div(c[w], scale[w]));
        }
      }
    }
  }
}

// ---- host side -------------------------------------------------------------

// The planes (planes, Bt, rows, Kp) int8 as a 4-D tensor map with (PBK,
// box_rows, 1, 1) boxes: rows past `rows` arrive as zeros in every batch
// element (a flattened (Bt * rows) axis would bring the next element's).
int plane_map(CUtensorMap* map, const int8_t* planes, int n_planes, int batch, int rows, int Kp,
              int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(Kp), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch), static_cast<cuuint64_t>(n_planes)};
  const cuuint64_t row = static_cast<cuuint64_t>(Kp);
  const cuuint64_t strides[3] = {row, row * rows, row * rows * batch};
  const cuuint32_t box[4] = {PBK, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<int8_t*>(planes), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

template <typename T, bool CPLX>
int launch_encode(const void* xr, const void* xi, const void* scale, int8_t* planes, int batch,
                  int R, int K, int Kp, long long sr, long long sk, long long sb, long long ssb,
                  const Crt& crt, const Barrett& br, cudaStream_t st) {
  constexpr int smem = encode_smem<T, CPLX>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        encode_kernel<T, CPLX>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(Kp / EK, (R + ER - 1) / ER, batch);
  encode_kernel<T, CPLX><<<grid, NT, smem, st>>>(
      static_cast<const T*>(xr), static_cast<const T*>(xi), static_cast<const T*>(scale), planes,
      R, K, Kp, sr, sk, sb, ssb, crt, br);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename O, bool CPLX, int NH>
int launch_planes(const CUtensorMap& ma, const CUtensorMap& mb, const void* mu, const void* nu,
                  void* out, uint8_t* park, int batch, int M, int N, int nk, int kr,
                  int epilogue, long long smu, long long snu, long long sout, const Crt& crt,
                  const Barrett& br, const Digits& dg, cudaStream_t st) {
  constexpr int smem = Tile<NH>::SMEM;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        planes_kernel<T, O, CPLX, NH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int tiles = batch * ((M + PBM - 1) / PBM) * ((N + Tile<NH>::BN - 1) / Tile<NH>::BN);
  planes_kernel<T, O, CPLX, NH><<<tiles, PT, smem, st>>>(
      ma, mb, static_cast<const T*>(mu), static_cast<const T*>(nu), static_cast<O*>(out), park, M,
      N, nk, kr, epilogue, smu, snu, sout, crt, br, dg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes. Each returns 0 on success, a
// cudaError_t code if the launch was refused, -1 for arguments that have
// no compiled instance, and -2 / -3 if libcuda's tensor-map encoder is
// missing / refused the planes.
//
// Encode: x (batch, R, K) through strides (sb, sr, sk) in elements, xi its
// imaginary part (cplx; null for a real operand) with the same strides,
// scale (batch, R) with batch stride ssb and rows contiguous, in x's type
// (type: 0 float32, 1 bfloat16, 2 float64; a complex encode takes float32
// or float64 parts); planes (p, T, batch, R, Kp) int8 contiguous, Kp a
// multiple of 128 >= K. moduli[p] is a host array.
extern "C" int emugemm2_encode(const void* xr, const void* xi, const void* scale, int8_t* planes,
                               int batch, int R, int K, int Kp, long long sb, long long sr,
                               long long sk, long long ssb, int cplx, int type, int p,
                               const int* moduli, void* stream) {
  if (batch <= 0 || batch > 65535 || R <= 0 || K <= 0 || Kp < K || Kp % PBK != 0) return -1;
  Crt crt;
  if (make_crt(p, moduli, nullptr, crt) != 0) return -1;
  Barrett br;
  make_barrett(crt, br);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define EMUGEMM2_ENCODE(T_, C_) \
  return launch_encode<T_, C_>(xr, xi, scale, planes, batch, R, K, Kp, sr, sk, sb, ssb, crt, br, st)
  if (!cplx) {
    if (type == F64) EMUGEMM2_ENCODE(double, false);
    if (type == F32) EMUGEMM2_ENCODE(float, false);
    if (type == BF16) EMUGEMM2_ENCODE(__nv_bfloat16, false);
    return -1;
  }
  if (type == F64) EMUGEMM2_ENCODE(double, true);
  if (type == F32) EMUGEMM2_ENCODE(float, true);
  return -1;
#undef EMUGEMM2_ENCODE
}

// The plane GEMM: a_planes (p, T, batch, M, Kp) and b_planes (p, T, batch,
// N, Kp) int8 from emugemm2_encode, mu (batch, M) and nu (batch, N) with
// batch strides smu, snu and rows contiguous, in the scale type (f64: float64,
// else float32); out (batch, M, N) with batch stride sout in output parts
// and rows contiguous (complex parts interleaved if cplx; out_type: 0
// float32, 1 bfloat16 (real products with float32 scales), 2 float64);
// tile_n, the output tile's columns, 256 or 128; park batch *
// tiles * S * 128 * tile_n bytes of scratch (tiles = ceil(M / 128) *
// ceil(N / tile_n), S = p, 2p if cplx). epilogue = 0 stops after the
// mainloop (the park holds the residues; for timing). moduli[p] and the
// Garner table inv[p * p] are host arrays.
extern "C" int emugemm2_planes(const int8_t* a_planes, const int8_t* b_planes, const void* mu,
                               const void* nu, void* out, uint8_t* park, int batch, int M, int N,
                               int Kp, long long smu, long long snu, long long sout, int tile_n,
                               int cplx, int f64, int out_type, int p, const int* moduli,
                               const int* inv, int epilogue, void* stream) {
  if (batch <= 0 || M <= 0 || N <= 0 || Kp <= 0 || Kp % PBK != 0) return -1;
  if (tile_n != 128 && tile_n != 256) return -1;
  Crt crt;
  if (make_crt(p, moduli, inv, crt) != 0) return -1;
  Barrett br;
  make_barrett(crt, br);
  Digits dg;
  make_digits(crt, dg);
  int half = 1;
  for (int i = 0; i < p; ++i) half = crt.m[i] / 2 > half ? crt.m[i] / 2 : half;
  // K tiles whose products, with a reduced residue below 256 carried in,
  // stay inside int32.
  const int kr = static_cast<int>((2147483647ll - 256) / (static_cast<long long>(half) * half * PBK));
  const int T = cplx ? 3 : 1;
  CUtensorMap ma, mb;
  int rc = plane_map(&ma, a_planes, p * T, batch, M, Kp, PBM);
  if (rc == 0) rc = plane_map(&mb, b_planes, p * T, batch, N, Kp, tile_n);
  if (rc != 0) return rc;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nk = Kp / PBK;
#define EMUGEMM2_PLANES(T_, O_, C_)                                                             \
  return tile_n == 256 ? launch_planes<T_, O_, C_, 2>(ma, mb, mu, nu, out, park, batch, M, N, nk,  \
                                                      kr, epilogue, smu, snu, sout, crt, br, dg,  \
                                                      st)                                          \
                       : launch_planes<T_, O_, C_, 1>(ma, mb, mu, nu, out, park, batch, M, N, nk,  \
                                                      kr, epilogue, smu, snu, sout, crt, br, dg,  \
                                                      st)
  if (!cplx) {
    if (f64) {
      if (out_type == F64) EMUGEMM2_PLANES(double, double, false);
      if (out_type == F32) EMUGEMM2_PLANES(double, float, false);
      return -1;
    }
    if (out_type == F32) EMUGEMM2_PLANES(float, float, false);
    if (out_type == BF16) EMUGEMM2_PLANES(float, __nv_bfloat16, false);
    if (out_type == F64) EMUGEMM2_PLANES(float, double, false);
    return -1;
  }
  if (f64 && out_type == F64) EMUGEMM2_PLANES(double, double, true);
  if (f64 && out_type == F32) EMUGEMM2_PLANES(double, float, true);
  if (out_type == F64) EMUGEMM2_PLANES(float, double, true);
  if (out_type == F32) EMUGEMM2_PLANES(float, float, true);
  return -1;
#undef EMUGEMM2_PLANES
}
