// EmuGEMM-II's plane route for Hopper (sm_90a): Scheme II as an encode
// kernel and a TMA-fed wgmma plane GEMM.
//
// Replaces, for every Scheme-II product of float operands, real or complex,
// the Pallas kernels of the JAX package
//   src/repro/kernels/backends/gpu.py  fused_matmul_scheme2 (_kernel2), 2-D launch, float rhs
//   src/repro/kernels/backends/gpu.py  fused_matmul_scheme2 (_kernel2, b_res), prepared launch
//   src/repro/kernels/backends/gpu.py  fused_matmul_scheme2_batched, batched launch
//   src/repro/kernels/backends/gpu.py  fused_matmul_3m (_kernel2_3m), 2-D and batched
// and the residue forms, given balanced int8 residues in and out,
//   src/repro/kernels/ozaki2.py        fused_residue_matmul (_kernel), K5
//   src/repro/kernels/ozaki3m.py       fused_3m_residue_matmul (_kernel), K7
// (below the plane GEMM: the relayout and the residue plane GEMM). A
// product with a float rhs is two encodes, A's and B^T's, both read through
// their strides (dB's A is X^T, attention's backward reads transposed
// views), and one plane GEMM. Operands: float64 (both, to a float64 or
// float32 output), or float32 and bf16 in any pairing to a float32, bf16 or
// float64 output, whose scales the plane GEMM reads as float32 (a bf16
// power of two widens exactly); the float64 output of float32 / bf16
// operands reconstructs in float64 double-double, as the reference does
// under x64 (H6). The prepared form is a float lhs encoded here against a
// weight whose planes were encoded here once, when it was prepared
// (kernels/prepared.py).
//
// Every product carries a batch coordinate Bt; a 2-D product is Bt = 1.
//
// encode: one pass over an operand, read through its strides, writes the
// balanced int8 residues of every modulus as K-contiguous planes: a
// (Bt, R, K) operand with a per-row scale s (A with mu; B as B^T with nu)
// becomes planes (p, T, Bt, R, Kp), T = 1 ([x]) or, for 3M, T = 3 ([re,
// im, bal(re + im)], complex3m.phase_residues); Kp is K padded with zero
// residues to the plane GEMM's K tile; the batch element is blockIdx.z.
// Each element is integerized once, trunc(x * s) in its type (a bf16
// element widens to float32 exactly on load, and its product rounds to
// bf16 before the truncation), and carved p times (a fused kernel that
// integerizes in each output tile's prologue does it N / BN times and
// carves it BN * p times), by integer arithmetic alone: a float32 or bf16
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
//     mod m, and three full-K sums never add up in int32; a thread's
//     four-element group that lies wholly past M or N (a thin tile, as
//     attention's decode heads give: M = 1 of 128 rows) is neither parked
//     nor rebuilt;
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
// CRT in series set its time. A float-rhs GEMM with short K, as dB = X^T dC
// at 512 tokens (four K tiles a modulus), spends most of its plane GEMM in
// the CRT epilogue: the mainloop no longer hides it, and overlapping the
// two needs a persistent grid (PERF.md measures the split).
//
// The residue forms take balanced int8 residues of any value in [-128,
// 128) for every modulus, (p, [3,] M, K) and (p, [3,] K, N), and give the
// balanced residues of their products, (p, M, N) (for 3M c_re and c_im):
//   * relayout: int8 wgmma reads both operands K-major, so an operand that
//     a tensor map cannot read in place (K not unit-stride, a row or plane
//     stride not a multiple of 16 bytes, a base not 16-byte aligned; B as
//     it arrives, N-contiguous) is copied once into K-contiguous planes
//     (p, T, R, Kp), zero residues past K, B as B^T: ER x EK tiles staged
//     in shared memory, read along the operand's unit-stride axis, written
//     eight bytes a thread. Bound by bytes: one read and one write a
//     residue (B of a 4096^2 operand at p = 16, 0.16 ms at 3.35 TB/s);
//   * residues_kernel: the plane GEMM's ring and mainloop (a copy) on
//     4-D tensor maps (K, rows, phase, modulus) through the operands' own
//     strides, so a contiguous A, or a B that arrives as the transposed
//     view of B^T's residues, is read in place (TMA's out-of-bounds fill
//     gives the zeros past K and past M or N). The modulus is the batch
//     coordinate: one block a (modulus, tile), which fills the SMs at
//     small shapes; a 3M block runs its modulus's three phase products in
//     turn. One int32 accumulator set covers the whole K with no
//     reduction between K tiles and no .satfinite, so the sums wrap as
//     the reference's int32 accumulator does (a periodic floor reduction
//     would give other bits once a sum wraps). Epilogue: bal(x) =
//     floor_mod(x + m/2, m) - m/2, the add wrapping in int32 as the
//     reference's, stored as int8 pairs (two columns of a row) into (p,
//     M, N). For 3M, bal(T1) waits in a shared park beside the ring (a
//     word a thread and group of four elements, 32 KB at 128 x 256), T2
//     stores C_re = bal(T1 - T2) and parks S = bal(T1 + T2), and T3
//     stores C_im = bal(T3 - S): the balanced representative is unique,
//     so reducing before combining gives the reference's bal(bal(T3) -
//     bal(T1) - bal(T2)). Only the thread that parked a word reads it, so
//     no barrier guards the park (parked in the outputs and read back,
//     the 4096^3 epilogue took 5.4 ms instead of 1.2, PERF.md). Bound: at
//     4096^3 and p = 16, 16 int8 GEMMs (1.1 ms at the int8 peak), 48 for
//     3M (3.3 ms).
//
// Numerics: see scheme2_common.cuh. The plain versions are
// repro_torch.kernels.ozaki2.encode_planes_plain / plane_matmul_plain /
// relayout_planes_plain / residue_planes_plain and
// repro_torch.kernels.ozaki3m.encode_planes_3m_plain / plane_matmul_3m_plain /
// residue_planes_3m_plain.

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

// A scale as the epilogue reads it: float64, or float32 widened from a
// float32 or (bf16 set) a bf16 scale, exactly.
template <typename T>
__device__ __forceinline__ T scale_at(const void* s, long long i, int bf16) {
  if constexpr (sizeof(T) == 8) {
    return static_cast<const double*>(s)[i];
  } else {
    return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(s)[i])
                : static_cast<const float*>(s)[i];
  }
}

// T: the scales' type (double, or float for float32 and bf16 operands,
// whose scales are read in their own types: scale_bf16 bit 0 marks a bf16
// mu, bit 1 a bf16 nu); O: the output part type; CPLX: 3M (planes
// (p, 3, Bt, ., Kp), a complex output of interleaved parts). park: Bt *
// tiles * S * PARK_SLOT bytes, S = p (2p for 3M). kr: K tiles between
// reductions. Batch element z reads mu at z * smu, nu at z * snu and
// writes out at z * sout (in output parts).
template <typename T, typename O, bool CPLX, int NH>
__global__ void __launch_bounds__(PT, 1)
planes_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
              const void* __restrict__ mu, const void* __restrict__ nu, int scale_bf16,
              O* __restrict__ out, uint8_t* park, int M, int N, int nk, int kr, int epilogue,
              long long smu,
              long long snu, long long sout, const __grid_constant__ Crt crt,
              const __grid_constant__ Barrett br, const __grid_constant__ Digits dg) {
  constexpr int TP = CPLX ? 3 : 1;
  constexpr int PBN = Tile<NH>::BN, STAGE_BYTES = Tile<NH>::STAGE_BYTES;
  constexpr int GROUPS = Tile<NH>::GROUPS;
  using V = typename Out<O>::V;
  // The ring, the raster and the K tile below have a copy in ring_init,
  // tile_origin and mma_stage (residues_kernel's): a change to one must
  // be made to both.
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
    // This thread's fragment rows (row0, row0 + 8) and, for group g,
    // columns (col, col + 1): a group wholly past M or N is neither parked
    // nor rebuilt (a thin or ragged tile, as a decode step's heads give).
    const int row0 = m0 + wg * 64 + ((ct % 128) / 32) * 16 + lane / 4;
    const int col0 = n0 + (lane % 4) * 2;
    auto live = [&](int g) { return row0 < M && col0 + (g / 16) * 128 + (g % 16) * 8 < N; };
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
              wgmma_s8_n128(acc[h], da + 2 * ks, db + h * (128 * PBK >> 4) + 2 * ks);
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
            for (int q = 0; q < 8; ++q)
              prev[q] = live(8 * c + q) ? *park_word<NH>(tile_park, t == 1 ? l : p + l, 8 * c + q, ct) : 0;
          }
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int g = 8 * c + q;
            if (!live(g)) continue;
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
    const long long mo = bt * smu, no = bt * snu;
    out += bt * sout;
    for (int g = 0; g < GROUPS; ++g) {
      if (!live(g)) continue;
      const int col = col0 + (g / 16) * 128 + (g % 16) * 8;
      // out(mu) * out(nu): real Scheme II divides by it, 3M multiplies
      // by its reciprocal, both rounded to the output type.
      V scale[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int gm = min(row0 + 8 * (w / 2), M - 1), gn = min(col + (w % 2), N - 1);
        scale[w] = Out<O>::mul(Out<O>::cvt(scale_at<T>(mu, mo + gm, scale_bf16 & 1)),
                               Out<O>::cvt(scale_at<T>(nu, no + gn, scale_bf16 & 2)));
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

// ---- the residue forms (K5, K7) ---------------------------------------------

constexpr int RLD = EK + 4;   // staged row stride, 17 words: 32 rows fall in 32 banks

// relayout: residues x (p, T, R, K) through strides (sp, st, sr, sk) ->
// planes (p, T, R, Kp), K-contiguous, zero residues past K; blockIdx.z is
// the (modulus, phase) plane.
__global__ void __launch_bounds__(NT)
relayout_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ planes, int T, int R, int K,
                int Kp, long long sp, long long st, long long sr, long long sk) {
  __shared__ __align__(16) int8_t tile[ER * RLD];
  const int r0 = blockIdx.y * ER;
  const int k0 = blockIdx.x * EK;
  const int pl = blockIdx.z;
  const int tid = threadIdx.x;
  x += (pl / T) * sp + (pl % T) * st;
  // Threads walk the operand's unit-stride axis.
  const bool kwalk = sk <= sr;
#pragma unroll 4
  for (int e = tid; e < ER * EK; e += NT) {
    const int rr = kwalk ? e / EK : e % ER;
    const int kk = kwalk ? e % EK : e / ER;
    const int gr = r0 + rr, gk = k0 + kk;
    tile[rr * RLD + kk] = gr < R && gk < K ? x[gr * sr + gk * sk] : int8_t(0);
  }
  __syncthreads();
  // Each thread writes 8 consecutive K of two rows as one 8-byte word.
  const int kc = (tid % (EK / 8)) * 8;
  for (int half = 0; half < 2; ++half) {
    const int rr = tid / (EK / 8) + half * (ER / 2);
    if (r0 + rr >= R) break;
    const uint32_t* w = reinterpret_cast<const uint32_t*>(tile + rr * RLD + kc);
    *reinterpret_cast<uint2*>(planes + (static_cast<long long>(pl) * R + r0 + rr) * Kp + k0 + kc) =
        make_uint2(w[0], w[1]);
  }
}

// The residue plane GEMM's pieces: planes_kernel's ring, raster and K
// tile, written once more (sharing them with planes_kernel through these
// helpers cost its mainloop 2 %, PERF.md). The two copies must stay one
// design: a change to one must be made to the other.
//
// The ring of STAGES (A | B) stages in dynamic shared memory, 1024-byte
// aligned for the 128-byte swizzle, and its full and empty barriers; thread
// 0 initialises the barriers, and the caller synchronises.
template <int NH>
__device__ __forceinline__ uint8_t* ring_init(uint8_t* smem, uint64_t*& full, uint64_t*& empty) {
  const uint32_t pad = (1024 - (smem_u32(smem) & 1023)) & 1023;
  uint8_t* ring = smem + pad;
  full = reinterpret_cast<uint64_t*>(ring + STAGES * Tile<NH>::STAGE_BYTES);
  empty = full + STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  return ring;
}

// The origin of output tile `tile` of a (tiles_m, tiles_n) grid: tiles run
// in groups of GROUP_M tile rows, column by column, so that the blocks
// resident together read a few row and column slabs of each plane, which
// stay in L2 while they work through it.
template <int NH>
__device__ __forceinline__ void tile_origin(int tile, int tiles_m, int tiles_n, int& m0, int& n0) {
  const int first = (tile / (GROUP_M * tiles_n)) * GROUP_M;
  const int rows = min(tiles_m - first, GROUP_M);
  const int in_group = tile % (GROUP_M * tiles_n);
  m0 = (first + in_group % rows) * PBM;
  n0 = (in_group / rows) * Tile<NH>::BN;
}

// One K tile of the ring into this warpgroup's accumulators: wait for its
// stage, run its wgmmas (two a k-step at NH = 2, one per 128 columns),
// release the stage and step the ring.
template <int NH>
__device__ __forceinline__ void mma_stage(int (&acc)[NH][64], const uint8_t* ring, uint64_t* full,
                                          uint64_t* empty, int& stage, int& phase, int wg,
                                          int lane) {
  mbar_wait(&full[stage], phase);
  const uint8_t* st = ring + stage * Tile<NH>::STAGE_BYTES;
  const uint64_t da = desc_sw128(st + wg * 64 * PBK);
  const uint64_t db = desc_sw128(st + A_BYTES);
#pragma unroll
  for (int h = 0; h < NH; ++h) reg_fence(acc[h]);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < PBK / 32; ++ks)
#pragma unroll
    for (int h = 0; h < NH; ++h)
      wgmma_s8_n128(acc[h], da + 2 * ks, db + h * (128 * PBK >> 4) + 2 * ks);
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int h = 0; h < NH; ++h) reg_fence(acc[h]);
  if (lane == 0) mbar_arrive(&empty[stage]);
  if (++stage == STAGES) {
    stage = 0;
    phase ^= 1;
  }
}

// Balanced residue of any int32 sum: floor_mod(x + m/2, m) - m/2, the add
// wrapping in int32 as the reference's does.
__device__ __forceinline__ int bal_full(int x, const Barrett& br, int m, int l) {
  const int half = m / 2;
  const unsigned sum = static_cast<unsigned>(x) + static_cast<unsigned>(half);
  return mod_full(static_cast<int>(sum), br, m, l) - half;
}

// Balanced residue of |x| < 2^21 (sums of balanced residues).
__device__ __forceinline__ int bal_small(int x, const Barrett& br, int m, int l) {
  return mod_small(x + m / 2, br, m, l) - m / 2;
}

// Two int8 residues at columns c and c + 1 of one row of an (M, N) output,
// or of its last N columns (c counted from their first, an even column):
// a 2-byte access where N is even (c is even, so it is aligned), bytes
// otherwise (column c + 1 only below N).
__device__ __forceinline__ void store_pair(int8_t* o, int N, int c, int x, int y) {
  if ((N & 1) == 0) {
    *reinterpret_cast<uint16_t*>(o) = static_cast<uint16_t>((x & 0xff) | ((y & 0xff) << 8));
  } else {
    o[0] = static_cast<int8_t>(x);
    if (c + 1 < N) o[1] = static_cast<int8_t>(y);
  }
}

// Four balanced residues as the bytes of a word, and back.
__device__ __forceinline__ uint32_t pack_bal(const int (&v)[4]) {
  return pack4(v[0] & 0xff, v[1] & 0xff, v[2] & 0xff, v[3] & 0xff);
}

__device__ __forceinline__ int signed_byte(uint32_t w, int i) {
  return static_cast<int8_t>(byte_of(w, i));
}

// The residue plane GEMM. TP = 1: K5, out_re (p, M, N); TP = 3: K7, the
// phases [re, im, re+im] into out_re and out_im. map_a (K, M, TP, p) and
// map_b (K, N, TP, p) are the operands' tensor maps; nk K tiles cover
// both. Block blockIdx.x is output tile blockIdx.x % tiles of modulus
// blockIdx.x / tiles. epilogue = 0 stops after the mainloop (for timing).
// For 3M, bal(T1) and then S wait in a shared park beside the ring, one
// word (a group's four elements) a thread and group, which only the
// thread that wrote it reads.
template <int TP, int NH>
__host__ __device__ constexpr int residues_smem() {
  return Tile<NH>::SMEM + (TP == 3 ? Tile<NH>::PARK_SLOT : 0);
}

template <int TP, int NH>
__global__ void __launch_bounds__(PT, 1)
residues_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                int8_t* __restrict__ out_re, int8_t* __restrict__ out_im, int M, int N, int nk,
                int epilogue, const __grid_constant__ Crt crt, const __grid_constant__ Barrett br) {
  constexpr int PBN = Tile<NH>::BN, STAGE_BYTES = Tile<NH>::STAGE_BYTES;
  constexpr int GROUPS = Tile<NH>::GROUPS;
  extern __shared__ __align__(16) uint8_t ring_smem[];
  uint64_t *full, *empty;
  uint8_t* ring = ring_init<NH>(ring_smem, full, empty);

  const int tiles_m = (M + PBM - 1) / PBM, tiles_n = (N + PBN - 1) / PBN;
  const int l = blockIdx.x / (tiles_m * tiles_n);
  int m0, n0;
  tile_origin<NH>(blockIdx.x % (tiles_m * tiles_n), tiles_m, tiles_n, m0, n0);
  const int wg = threadIdx.x / 128;
  __syncthreads();

  if (wg == CONSUMER_THREADS / 128) {
    // The producer: one thread streams (phase, K tile) pairs into the ring.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == CONSUMER_THREADS) {
      int stage = 0, phase = 0;
      for (int t = 0; t < TP; ++t) {
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], STAGE_BYTES);
          uint8_t* st = ring + stage * STAGE_BYTES;
          tma_load_4d(st, &map_a, &full[stage], kt * PBK, m0, t, l);
          tma_load_4d(st + A_BYTES, &map_b, &full[stage], kt * PBK, n0, t, l);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int ct = threadIdx.x;
    const int lane = ct % 32;
    const int row0 = m0 + wg * 64 + ((ct % 128) / 32) * 16 + lane / 4;
    const int col0 = n0 + (lane % 4) * 2;
    const int m = crt.m[l];
    const long long plane = static_cast<long long>(l) * M * N;
    uint32_t* park = reinterpret_cast<uint32_t*>(empty + STAGES) + ct;   // [GROUPS][256]
    int acc[NH][64];
    int stage = 0, phase = 0;
    for (int t = 0; t < TP; ++t) {
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[h][i] = 0;
      for (int kt = 0; kt < nk; ++kt) mma_stage<NH>(acc, ring, full, empty, stage, phase, wg, lane);
      if (!epilogue) continue;
      // This thread's first element and how many rows and columns lie
      // from it to the edge, taken afresh in every phase through an empty
      // asm: derived from values the compiler could hoist out of the phase
      // loop, the 64 pairs' addresses and bounds would stay live across the
      // next phase's mainloop and spill.
      long long first = plane + static_cast<long long>(row0) * N + col0;
      int rows = M - row0, cols = N - col0;
      asm volatile("" : "+l"(first), "+r"(rows), "+r"(cols));
      // Group g holds registers 4 * (g % 16) + w of acc[g / 16]: rows r
      // and r + 8 (w / 2), columns c and c + 1 (w % 2).
#pragma unroll
      for (int g = 0; g < GROUPS; ++g) {
        int v[4];
#pragma unroll
        for (int w = 0; w < 4; ++w) v[w] = bal_full(acc[g / 16][4 * (g % 16) + w], br, m, l);
        int8_t* out = out_re;
        if (TP == 3) {
          // T1 parks; T2 stores C_re = bal(T1 - T2) and parks S = bal(T1 +
          // T2); T3 stores C_im = bal(T3 - S).
          uint32_t& word = park[g * CONSUMER_THREADS];
          if (t == 0) {
            word = pack_bal(v);
            continue;
          }
          const uint32_t prev = word;
          if (t == 1) {
            int sum[4];
#pragma unroll
            for (int w = 0; w < 4; ++w) {
              const int x = signed_byte(prev, w);
              sum[w] = bal_small(x + v[w], br, m, l);
              v[w] = bal_small(x - v[w], br, m, l);
            }
            word = pack_bal(sum);
          } else {
#pragma unroll
            for (int w = 0; w < 4; ++w) v[w] = bal_small(v[w] - signed_byte(prev, w), br, m, l);
            out = out_im;
          }
        }
        const int col = (g / 16) * 128 + (g % 16) * 8;   // from col0
        if (col >= cols) continue;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (8 * r < rows)
            store_pair(out + first + static_cast<long long>(8 * r) * N + col, cols, col,
                       v[2 * r], v[2 * r + 1]);
      }
    }
  }
}

// ---- host side -------------------------------------------------------------

// An int8 (d3, d2, rows, K) tensor with byte strides (s3, s2, s_row), K
// unit-stride, as a 4-D tensor map with (PBK, box_rows, 1, 1) boxes: rows
// past `rows` and K past `K` arrive as zeros, in every (d2, d3) element (a
// flattened axis would bring the next element's).
int tile_map(CUtensorMap* map, const int8_t* base, int d3, int d2, int rows, long long K,
             long long s3, long long s2, long long s_row, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(d2), static_cast<cuuint64_t>(d3)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_row), static_cast<cuuint64_t>(s2),
                                 static_cast<cuuint64_t>(s3)};
  const cuuint32_t box[4] = {PBK, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<int8_t*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

// The planes (planes, Bt, rows, Kp), contiguous.
int plane_map(CUtensorMap* map, const int8_t* planes, int n_planes, int batch, int rows, int Kp,
              int box_rows) {
  const long long row = Kp;
  return tile_map(map, planes, n_planes, batch, rows, Kp, row * rows * batch, row * rows, row,
                  box_rows);
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
                  int scale_bf16, void* out, uint8_t* park, int batch, int M, int N, int nk, int kr,
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
      ma, mb, mu, nu, scale_bf16, static_cast<O*>(out), park, M, N, nk, kr, epilogue, smu, snu,
      sout, crt, br, dg);
  return static_cast<int>(cudaGetLastError());
}

template <int TP, int NH>
int launch_residues(const CUtensorMap& ma, const CUtensorMap& mb, int8_t* out_re, int8_t* out_im,
                    int p, int M, int N, int nk, int epilogue, const Crt& crt, const Barrett& br,
                    cudaStream_t st) {
  constexpr int smem = residues_smem<TP, NH>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        residues_kernel<TP, NH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const long long tiles =
      static_cast<long long>(p) * ((M + PBM - 1) / PBM) * ((N + Tile<NH>::BN - 1) / Tile<NH>::BN);
  if (tiles > 2147483647ll) return -1;
  residues_kernel<TP, NH><<<static_cast<unsigned>(tiles), PT, smem, st>>>(
      ma, mb, out_re, out_im, M, N, nk, epilogue, crt, br);
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
// batch strides smu, snu and rows contiguous, in the scale type (f64: float64;
// else float32, or bf16 where scale_bf16 says so: bit 0 mu, bit 1 nu); out
// (batch, M, N) with batch stride sout in output parts
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
                               int cplx, int f64, int scale_bf16, int out_type, int p,
                               const int* moduli, const int* inv, int epilogue, void* stream) {
  if (batch <= 0 || M <= 0 || N <= 0 || Kp <= 0 || Kp % PBK != 0) return -1;
  if (scale_bf16 < 0 || scale_bf16 > 3 || (f64 && scale_bf16)) return -1;
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
  return tile_n == 256                                                                         \
             ? launch_planes<T_, O_, C_, 2>(ma, mb, mu, nu, scale_bf16, out, park, batch, M, N, nk, \
                                            kr, epilogue, smu, snu, sout, crt, br, dg, st)        \
             : launch_planes<T_, O_, C_, 1>(ma, mb, mu, nu, scale_bf16, out, park, batch, M, N, nk, \
                                            kr, epilogue, smu, snu, sout, crt, br, dg, st)
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

// The residue forms. Relayout: residues x (p, T, R, K) through strides
// (sp, st, sr, sk) in bytes -> planes (p, T, R, Kp) int8 contiguous, Kp a
// multiple of 128 >= K, zero residues past K.
extern "C" int emugemm2_relayout(const int8_t* x, int8_t* planes, int p, int T, int R, int K,
                                 int Kp, long long sp, long long st, long long sr, long long sk,
                                 void* stream) {
  if (p <= 0 || T <= 0 || p * T > 65535 || R <= 0 || (R + ER - 1) / ER > 65535 || K <= 0 ||
      Kp < K || Kp % PBK != 0)
    return -1;
  const dim3 grid(Kp / EK, (R + ER - 1) / ER, p * T);
  relayout_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(x, planes, T, R, K, Kp, sp,
                                                                      st, sr, sk);
  return static_cast<int>(cudaGetLastError());
}

// The residue plane GEMM: a (p, T, M, ka) and b (p, T, N, kb) int8
// residues, each K-contiguous with byte strides (plane, phase, row) that
// are multiples of 16 and a 16-byte aligned base (the planes of
// emugemm2_relayout are), past its K read as zero residues; T = phases (1:
// K5, 3: K7). out_re and, for 3M, out_im (p, M, N) int8 contiguous;
// tile_n 256 or 128; epilogue = 0 stops after the mainloop (for timing).
// moduli[p] is a host array.
extern "C" int emugemm2_residues(const int8_t* a, const int8_t* b, int8_t* out_re, int8_t* out_im,
                                 int M, int N, int ka, int kb, long long a_sp, long long a_st,
                                 long long a_sr, long long b_sp, long long b_st, long long b_sr,
                                 int phases, int tile_n, int p, const int* moduli, int epilogue,
                                 void* stream) {
  if (M <= 0 || N <= 0 || ka <= 0 || kb <= 0 || (phases != 1 && phases != 3)) return -1;
  if (tile_n != 128 && tile_n != 256) return -1;
  if (((a_sp | a_st | a_sr | b_sp | b_st | b_sr) & 15) != 0 ||
      ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) != 0)
    return -1;
  Crt crt;
  if (make_crt(p, moduli, nullptr, crt) != 0) return -1;
  Barrett br;
  make_barrett(crt, br);
  CUtensorMap ma, mb;
  int rc = tile_map(&ma, a, p, phases, M, ka, a_sp, a_st, a_sr, PBM);
  if (rc == 0) rc = tile_map(&mb, b, p, phases, N, kb, b_sp, b_st, b_sr, tile_n);
  if (rc != 0) return rc;
  const int nk = ((ka > kb ? ka : kb) + PBK - 1) / PBK;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define EMUGEMM2_RESIDUES(TP_)                                                                   \
  return tile_n == 256 ? launch_residues<TP_, 2>(ma, mb, out_re, out_im, p, M, N, nk, epilogue, \
                                                 crt, br, st)                                    \
                       : launch_residues<TP_, 1>(ma, mb, out_re, out_im, p, M, N, nk, epilogue, \
                                                 crt, br, st)
  if (phases == 1) EMUGEMM2_RESIDUES(1);
  EMUGEMM2_RESIDUES(3);
#undef EMUGEMM2_RESIDUES
}
