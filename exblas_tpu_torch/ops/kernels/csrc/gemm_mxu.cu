// Exact ExGEMM on the int8 tensor cores (Ozaki-Kulisch slices) for data
// the dispatcher has found covered: A and B recoded into balanced signed
// base-256 digit planes anchored per row of A and per column of B, so that
//   z[i,k] * b[k,j] = sum_{s,t} A_s[i,k] * B_t[j,k] * 2^(e_base - 8(s+t)),
//   e_base = ea[i] + fb[j] + 2,
// and the exact result is sum_c M_c[i,j] * 2^(e_base - 8c) (+ beta*c[i,j])
// with the class sums M_c = sum_{s+t=c} sum_k A_s[i,k] * B_t[j,k].
//
// Replaces exblas_tpu/ops/kernels/gemm_mxu.py: gemm_bits_mxu (its
// make_digits preparation, and _mxu_kernel with _deposit_beta_c_rel,
// _renorm_rel and _round_rel_kernel_part).  The TPU kernel keeps int32
// class sums in VMEM, spills them into 20-bit limbs every _spill_run k
// elements (its vector unit has int32 only) and rounds them in its last
// grid step.  Here:
//   * mxu_digits_kernel: the digit planes, four k-consecutive elements a
//     thread (mxu.cuh's excess-128 recode, one 32-bit store a plane): A as
//     (sa+1, m_pad, k_pad), B transposed as (sb+1, n_pad, k_pad);
//   * rung (8, 8), the benchmark configuration's: wg88::gemm88_kernel
//     computes the 17 class sums of a 64 x 32 tile with wgmma and rounds
//     them in its epilogue.  A producer warpgroup keeps TMA loads of the
//     tile's nine A and nine B^T digit planes (32-byte swizzle) in flight
//     in a ring of stages, each with a full and an empty mbarrier; two
//     consumer warpgroups each own 16 of the columns.  setmaxnreg moves
//     the producer's registers to them (40 and 232 a thread:
//     128 * 40 + 256 * 232 = 384 * 168, the block's registers at launch;
//     an increase draws only on what the block's own warps released).
//     wgmma in flight are ordered only on the same accumulator registers,
//     so the classes are cut into windows (4, 8, 5) with one accumulator
//     each (17 x 8 int32 a thread in all): digit s of A meets, in one
//     wgmma.m64nNk32 (N = 16 classes), the B^T planes t = c - s of its
//     window's classes c, read from a stack of the nine planes padded
//     with zero planes on both sides.  The zero planes cost 113 block
//     products where 81 are needed, and buy 18 wgmma a k step that run
//     back to back.  The int32 class sums are exact over a chunk of kc k
//     elements while kc * 9 * 2^14 < 2^31 (gemm_mxu.py exact_chunk:
//     8192); a launch covers one chunk.  Its epilogue stashes the sums in
//     the idle ring (no register spills), adds each element's 17 sums at
//     8-bit spacing into three 64-bit words (the exact value is below
//     2^169 in units of 2^(e_base - 128)), with the words of the earlier
//     chunks and, in the last chunk, the exact beta*c, and rounds them
//     once (kulisch.cuh round_window); a k of more than one chunk keeps
//     its words in device memory between launches.  No class sum reaches
//     device memory;
//   * rungs (8, 12) to (16, 16) (gemm_mxu.py WG_RUNGS):
//     wgw::wide_kernel<sa + 1, sb + 1>, built as wg88's: a producer
//     warpgroup's TMA ring of the tile's sa + 1 A and sb + 1 B^T planes,
//     and the rounding in the epilogue.  33 classes of a 64 x 16 tile, at
//     (16, 16), are 264 int32 a thread, over the 232 setmaxnreg leaves, so
//     the two consumer warpgroups share one 64 x 16 tile and split its
//     classes: warpgroup 0 the lower half, 1 the rest (17 and 16 classes,
//     136 and 128 registers), both reading the same A planes and the same
//     zero-padded B^T stack.  A wider tile would not fit: 33 classes of
//     64 x 32 outputs are 67,584 int32, more than an SM's registers.  The
//     price is L2 traffic: A is read once per 16 columns (at n = 4096,
//     (16, 16), 73 GB, against 19 GB at (8, 8)).  Each half is cut into
//     windows of about kWidth = 4 classes, one accumulator each: (4, 4, 4,
//     5) and (4, 4, 4, 4) at (16, 16), 341 block products where 289 are
//     needed, 81 wgmma a k step.  Of kWidth 8, 5 and 4 (49, 66 and 81
//     wgmma; 409, 364 and 341 products) 4 measured fastest
//     (scripts/mxu_variants.py, PERF.md).  The int32 class sums are exact
//     over exact_chunk(sa, sb) k elements (4096 at (16, 16), 8192 at the
//     others); a launch covers one chunk.  The epilogue stashes both
//     warpgroups' sums in the idle ring, and each consumer thread rounds
//     four elements: their sa + sb + 1 class sums at 8-bit spacing in
//     kWords 64-bit words (five at (12, 16), (16, 12) and (16, 16), four
//     at the others: the exact value is below 2^(8(sa+sb) + 38) in units
//     of 2^(e_base - 8(sa+sb))), the words of the earlier chunks and, in
//     the last, the exact beta*c, rounded once (kulisch.cuh round_window).
//     No class sum reaches device memory;
//   * the rungs above (16, 16): mxu_class_kernel holds kG = 17 classes in
//     registers per pass over k (blockIdx.z picks the group), int8
//     mma.sync, int32 sums widened into int64 class sums in device memory
//     every kc = _spill_run(sa, sb) k elements, and mxu_round_kernel adds
//     each element's class sums and beta * c into a private int64
//     accumulator (round.cuh add_scaled, deposit.cuh add_digits) and rounds
//     it once (round.cuh round_limbs).  Rounding n int64 terms at given bit
//     positions is also what B3 (round_in_kernel.py: round_scaled_terms)
//     computes, so its port can share these routines.
//
// Bound on the H100: the int8 tensor cores.  A rung (sa, sb) does
// (sa+1)(sb+1) int8 products of m x k x n: at (8, 8) and n = 4096 that is
// 1.1e13 operations, 5.6 ms at 1,979 TOP/s (at (16, 16) 20.3 ms), while
// the digit planes, C and the result move 0.57 GB (0.17 ms of HBM).  Only
// wgmma reaches the full rate; its tile is bounded by the registers (17
// classes of a 64 x 16 warpgroup tile are 136 a thread).  Consecutive
// blocks take groups of kGroupM row tiles across the column tiles, so that
// the blocks in flight share their planes in L2.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "deposit.cuh"
#include "kulisch.cuh"
#include "mxu.cuh"
#include "round.cuh"

namespace {

using exblas::ld32;
using exblas::mma_s8;

constexpr int kG = 17;        // classes per pass, held in registers
constexpr int kTile = 32;     // block tile: 32 x 32 outputs, 4 warps
constexpr int kThreads = 128;
constexpr int kMaxRel = 48;   // limbs of the rounding accumulator

// Class sums of one 32 x 32 output tile for classes [c0, c0 + kG):
// cls[c][i][j] (int64, (n_cls, rows, n_pad)) over all k.
__global__ void __launch_bounds__(kThreads)
    mxu_class_kernel(const int8_t* __restrict__ ad,
                     const int8_t* __restrict__ bd, int sa, int sb,
                     long long plane_a, long long plane_b, long long rows,
                     long long n_pad, long long k_pad, long long kc,
                     long long* __restrict__ cls) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row / column group
  const int tq = lane & 3;   // thread in group
  const long long row0 = static_cast<long long>(blockIdx.y) * kTile +
                         (warp >> 1) * 16;
  const long long col0 = static_cast<long long>(blockIdx.x) * kTile +
                         (warp & 1) * 16;
  const int c0 = blockIdx.z * kG;
  const int n_cls = sa + sb + 1;
  const int s_lo = c0 - sb > 0 ? c0 - sb : 0;
  const int s_hi = c0 + kG - 1 < sa ? c0 + kG - 1 : sa;
  // A: rows row0+g and row0+g+8; B^T: rows (output columns) col0+g, +8.
  const int8_t* a0 = ad + (row0 + g) * k_pad + tq * 4;
  const int8_t* a1 = a0 + 8 * k_pad;
  const int8_t* b0 = bd + (col0 + g) * k_pad + tq * 4;
  const int8_t* b1 = b0 + 8 * k_pad;

  for (long long kb = 0; kb < k_pad; kb += kc) {
    int acc[kG][2][4];
#pragma unroll
    for (int d = 0; d < kG; ++d) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[d][0][r] = 0;
        acc[d][1][r] = 0;
      }
    }
    const long long ke = kb + kc < k_pad ? kb + kc : k_pad;
    for (long long kk = kb; kk < ke; kk += 32) {
      for (int s = s_lo; s <= s_hi; ++s) {
        const long long oa = s * plane_a + kk;
        const unsigned a[4] = {ld32(a0 + oa), ld32(a1 + oa),
                               ld32(a0 + oa + 16), ld32(a1 + oa + 16)};
#pragma unroll
        for (int d = 0; d < kG; ++d) {
          const int t = c0 + d - s;
          if (t < 0 || t > sb) continue;  // warp-uniform
          const long long ob = t * plane_b + kk;
          mma_s8(acc[d][0], a, ld32(b0 + ob), ld32(b0 + ob + 16));
          mma_s8(acc[d][1], a, ld32(b1 + ob), ld32(b1 + ob + 16));
        }
      }
    }
    // Widen into the int64 class sums (this block owns its tile).
#pragma unroll
    for (int d = 0; d < kG; ++d) {
      const int c = c0 + d;
      if (c >= n_cls) break;
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const long long i = row0 + g + (r >= 2 ? 8 : 0);
          const long long j = col0 + ni * 8 + tq * 2 + (r & 1);
          long long* p = cls + (c * rows + i) * n_pad + j;
          *p = (kb == 0 ? 0LL : *p) + acc[d][ni][r];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Rung (8, 8): wgmma with TMA-fed stages, rounded in the epilogue
// ---------------------------------------------------------------------------
namespace wg88 {

constexpr int kS = 9;                     // digits per side
constexpr int kCls = 2 * kS - 1;          // classes
constexpr int kRel0 = 8 * (kCls - 1);     // class 0's relative bit
constexpr int kBM = 64;                   // block rows: one wgmma M
constexpr int kWN = 16;                   // columns of a consumer warpgroup
constexpr int kBN = 2 * kWN;              // block columns
constexpr int kBK = 32;                   // k per stage: one wgmma K
constexpr int kPlaneA = kBM * kBK;        // bytes of one A plane's tile
constexpr int kPlaneB = kWN * kBK;        // bytes of one B^T plane's tile

// The class windows: classes [kWin[w], kWin[w + 1]) share one accumulator
// of 8 (kWin[w + 1] - kWin[w]) registers a thread, and digit s of A meets
// the B^T planes t = c - s of its classes c in one wgmma of N = 16 classes
// (a zero plane where t lies outside 0..8).  Wider windows take fewer
// wgmma; narrower ones multiply fewer zero planes.  The times on the card
// fit a floor of about 60 cycles a wgmma whatever its N; of the partitions
// tried (scripts/mxu_variants.py, PERF.md), (4, 8, 5) measured fastest.
constexpr int kWin[] = {0, 4, 12, kCls};
constexpr int kNWin = sizeof(kWin) / sizeof(kWin[0]) - 1;
// The digits s of A whose products reach classes [c0, c1).
__host__ __device__ constexpr int first_s(int c0) {
  return c0 - (kS - 1) > 0 ? c0 - (kS - 1) : 0;
}
__host__ __device__ constexpr int last_s(int c1) {
  return c1 - 1 < kS - 1 ? c1 - 1 : kS - 1;
}
constexpr int lowest_plane() {
  int t = 0;
  for (int w = 0; w < kNWin; ++w) {
    t = kWin[w] - last_s(kWin[w + 1]) < t ? kWin[w] - last_s(kWin[w + 1]) : t;
  }
  return t;
}
constexpr int highest_plane() {
  int t = kS - 1;
  for (int w = 0; w < kNWin; ++w) {
    const int v = kWin[w + 1] - 1 - first_s(kWin[w]);
    t = v > t ? v : t;
  }
  return t;
}
constexpr int kTLo = lowest_plane();       // a warpgroup's B^T stack holds
constexpr int kZPlanes = highest_plane() - kTLo + 1;  // planes kTLo..
constexpr int kHalfB = kZPlanes * kPlaneB;
constexpr int kStageBytes = kS * kPlaneA + 2 * kHalfB;
constexpr int kTmaBytes = kS * kPlaneA + 2 * kS * kPlaneB;  // 27,648
constexpr int kSmemBudget = 232448 - 1024 - 256;
constexpr int kStages = kSmemBudget / kStageBytes < 8
                            ? kSmemBudget / kStageBytes : 8;
constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;
constexpr int kThreads = 384;             // two consumer warpgroups, TMA
constexpr int kConsumerWarps = 8;
constexpr int kGroupM = 8;                // row tiles a group of blocks takes
static_assert(kWin[0] == 0 && kWin[kNWin] == kCls, "windows cover 0..16");
static_assert(kCls * 8 * 256 * 4 <= kStages * kStageBytes,
              "the epilogue's class sums fit in the ring");
using u64 = unsigned long long;

// w += x (mod 2^192).
__device__ __forceinline__ void add192(u64 (&w)[3], u64 x0, u64 x1, u64 x2) {
  w[0] += x0;
  const u64 c0 = w[0] < x0 ? 1ULL : 0ULL;
  u64 s1 = w[1] + x1;
  u64 c1 = s1 < x1 ? 1ULL : 0ULL;
  s1 += c0;
  c1 += s1 < c0 ? 1ULL : 0ULL;
  w[1] = s1;
  w[2] += x2 + c1;
}

// The three words (two's complement, unit 2^(e_base - 128)) of
// sum_c M_c * 2^(8 (16 - c)) for element e of a thread's stashed class
// sums (class c's at stash[(8 c + e) * 256]): int64 sums at 32-bit
// spacing, four classes each, then one carry pass.
__device__ __forceinline__ void class_words(const int* stash, int e,
                                            u64 (&w)[3]) {
  long long t[5] = {0, 0, 0, 0, 0};
#pragma unroll
  for (int c = 0; c < kCls; ++c) {
    const int p = kRel0 - 8 * c;
    t[p >> 5] += static_cast<long long>(stash[(8 * c + e) * 256]) *
                 (1LL << (p & 31));
  }
  long long x = t[0];
  const unsigned d0 = static_cast<unsigned>(x);
  x = (x >> 32) + t[1];
  const unsigned d1 = static_cast<unsigned>(x);
  x = (x >> 32) + t[2];
  const unsigned d2 = static_cast<unsigned>(x);
  x = (x >> 32) + t[3];
  const unsigned d3 = static_cast<unsigned>(x);
  x = (x >> 32) + t[4];
  w[0] = d0 | (static_cast<u64>(d1) << 32);
  w[1] = d2 | (static_cast<u64>(d3) << 32);
  w[2] = static_cast<u64>(x);
}

// w += beta * c, exact, where both are finite and nonzero and the
// product's lsb lies at relative bit p >= 0 (rel = 128 - e_base); as in
// deposit.cuh decode_product, anything else adds nothing (the dispatcher
// overrides specials and checks the coverage).
__device__ __forceinline__ void add_beta_c(u64 (&w)[3], long long beta,
                                           long long cv, int rel) {
  const int eb = static_cast<int>((beta >> 52) & 0x7FF);
  const int ec = static_cast<int>((cv >> 52) & 0x7FF);
  u64 mb = static_cast<u64>(beta) & exblas::kFracMask;
  u64 mc = static_cast<u64>(cv) & exblas::kFracMask;
  if (eb != 0) mb |= 1ULL << 52;
  if (ec != 0) mc |= 1ULL << 52;
  const int p = (eb > 1 ? eb : 1) + (ec > 1 ? ec : 1) - 2150 + rel;
  if (eb == 0x7FF || ec == 0x7FF || mb == 0ULL || mc == 0ULL || p < 0 ||
      p >= 192) {
    return;
  }
  const u64 lo = mb * mc;
  const u64 hi = __umul64hi(mb, mc);
  const int s = p & 63;
  const u64 y0 = lo << s;
  const u64 y1 = s ? (hi << s) | (lo >> (64 - s)) : hi;
  const u64 y2 = s ? hi >> (64 - s) : 0ULL;
  const int q = p >> 6;
  u64 x0 = q == 0 ? y0 : 0ULL;
  u64 x1 = q == 0 ? y1 : (q == 1 ? y0 : 0ULL);
  u64 x2 = q == 0 ? y2 : (q == 1 ? y1 : y0);
  if ((beta ^ cv) < 0) {  // add the two's complement
    x0 = ~x0 + 1ULL;
    const u64 c0 = x0 == 0ULL ? 1ULL : 0ULL;
    x1 = ~x1 + c0;
    x2 = ~x2 + ((c0 != 0ULL && x1 == 0ULL) ? 1ULL : 0ULL);
  }
  add192(w, x0, x1, x2);
}

// The correctly rounded binary64 of three two's-complement words, bit p
// of exponent p - offset_bits; an exact zero is +0.0.
__device__ __forceinline__ unsigned long long round192(const u64 (&v)[3],
                                                       int offset_bits) {
  u64 w0 = v[0], w1 = v[1], w2 = v[2];
  const bool negative = static_cast<long long>(w2) < 0;
  if (negative) {
    w0 = ~w0 + 1ULL;
    const u64 c0 = w0 == 0ULL ? 1ULL : 0ULL;
    w1 = ~w1 + c0;
    w2 = ~w2 + ((c0 != 0ULL && w1 == 0ULL) ? 1ULL : 0ULL);
  }
  if ((w0 | w1 | w2) == 0ULL) return 0ULL;
  const int t = w2 != 0ULL ? 2 : (w1 != 0ULL ? 1 : 0);
  const int l = w0 != 0ULL ? 0 : (w1 != 0ULL ? 1 : 2);
  const u64 top = t == 2 ? w2 : (t == 1 ? w1 : w0);
  const u64 below = t == 2 ? w1 : (t == 1 ? w0 : 0ULL);
  return exblas::round_window(negative, t, l, top, below, offset_bits);
}

// The wgmma of windows W.. for one k step: A's planes at a_addr, this
// warpgroup's zero-padded B^T stack (planes kTLo..) at z.
template <int W>
__device__ __forceinline__ void window_products(int* acc, unsigned a_addr,
                                                unsigned z) {
  if constexpr (W < kNWin) {
    constexpr int c0 = kWin[W];
    constexpr int c1 = kWin[W + 1];
    constexpr int s0 = first_s(c0);
    constexpr int s1 = last_s(c1);
#pragma unroll
    for (int s = s0; s <= s1; ++s) {
      exblas::wgmma_s8<16 * (c1 - c0)>(
          acc + 8 * c0, exblas::wgmma_desc_sw32(a_addr + s * kPlaneA),
          exblas::wgmma_desc_sw32(z + (c0 - s - kTLo) * kPlaneB));
    }
    window_products<W + 1>(acc, a_addr, z);
  }
}

// One launch covers k elements [k0, k0 + 32 steps) of every output tile:
// the class sums of that chunk, added to the words of the earlier chunks
// (first == 0: words (3, m, n) holds them), then either the words of this
// chunk (last == 0) or the rounded result (last != 0, with beta * c).
__global__ void __launch_bounds__(kThreads, 1)
    gemm88_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b, int k0,
                  int steps, long long m_tiles, long long n_tiles,
                  const int* __restrict__ ea, const int* __restrict__ fb,
                  const long long* __restrict__ c, long long beta,
                  int beta_mode, long long m, long long n,
                  u64* __restrict__ words, int first, int last,
                  long long* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - (exblas::smem_u32(smem_raw) & 1023u)) & 1023u);
  u64* full = reinterpret_cast<u64*>(smem + kStages * kStageBytes);
  u64* empty = full + kStages;
  // Groups of kGroupM row tiles sweep the column tiles.
  const long long id = blockIdx.x;
  const long long per_group = kGroupM * n_tiles;
  const long long first_m = id / per_group * kGroupM;
  const long long gm =
      m_tiles - first_m < kGroupM ? m_tiles - first_m : kGroupM;
  const long long in_group = id % per_group;
  const int row0 = static_cast<int>((first_m + in_group % gm) * kBM);
  const int col0 = static_cast<int>(in_group / gm * kBN);
  // The warpgroup, warp-uniform for ptxas: setmaxnreg needs that.
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 7),
                             0);
  {  // the zero planes around each B^T stack stay zero
    uint4* z = reinterpret_cast<uint4*>(smem);
    for (int i = threadIdx.x; i < kStages * kStageBytes / 16; i += kThreads) {
      z[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    exblas::fence_proxy_async();
  }
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      exblas::mbar_init(full + st, 1);
      exblas::mbar_init(empty + st, kConsumerWarps);
    }
    exblas::mbar_init_fence();
  }
  __syncthreads();
  if (wg == 2) {
    // The producer warpgroup: one thread keeps the ring full.
    exblas::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      exblas::tma_prefetch(&map_a);
      exblas::tma_prefetch(&map_b);
      for (int step = 0; step < steps; ++step) {
        const int st = step % kStages;
        exblas::mbar_wait(empty + st, ((step / kStages) & 1) ^ 1);
        exblas::mbar_expect_tx(full + st, kTmaBytes);
        unsigned char* s = smem + st * kStageBytes;
        const int kk = k0 + step * kBK;
        exblas::tma_load_3d(s, &map_a, full + st, kk, row0, 0);
        unsigned char* b = s + kS * kPlaneA - kTLo * kPlaneB;  // plane 0
        exblas::tma_load_3d(b, &map_b, full + st, kk, col0, 0);
        exblas::tma_load_3d(b + kHalfB, &map_b, full + st, kk, col0 + kWN, 0);
      }
    }
  } else {
    // A consumer warpgroup: columns [col0 + 16 wg, +16) of the tile.
    exblas::setmaxnreg_inc<232>();
    int acc[kCls * 8];
#pragma unroll
    for (int i = 0; i < kCls * 8; ++i) acc[i] = 0;
    const unsigned base = exblas::smem_u32(smem);
    for (int step = 0; step < steps; ++step) {
      const int st = step % kStages;
      exblas::mbar_wait(full + st, (step / kStages) & 1);
      const unsigned a_addr = base + st * kStageBytes;
      exblas::wgmma_fence();
      window_products<0>(acc, a_addr, a_addr + kS * kPlaneA + wg * kHalfB);
      exblas::wgmma_commit();
      // The previous step's products are done: its stage may be refilled.
      exblas::wgmma_wait<1>();
      if (step > 0 && (threadIdx.x & 31) == 0) {
        exblas::mbar_arrive(empty + (step - 1) % kStages);
      }
    }
    exblas::wgmma_wait<0>();
    // The epilogue reads the class sums back from the ring, which every
    // product of both warpgroups is done with, so that no register spills.
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    int* stash = reinterpret_cast<int*>(smem) + threadIdx.x;
#pragma unroll
    for (int i = 0; i < kCls * 8; ++i) stash[i * 256] = acc[i];
    // Thread (warp wi, lane 4g + tq) holds, for e = 4j + i, row
    // 16 wi + g + 8 (i >> 1), column 8j + 2tq + (i & 1) of each class.
    const int wi = (threadIdx.x >> 5) & 3;
    const int g = (threadIdx.x & 31) >> 2;
    const int tq = threadIdx.x & 3;
    const long long mn = m * n;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const long long row = row0 + wi * 16 + g + ((e & 2) ? 8 : 0);
      const long long col =
          col0 + wg * kWN + (e >> 2) * 8 + 2 * tq + (e & 1);
      if (row >= m || col >= n) continue;
      u64 w[3];
      class_words(stash, e, w);
      const long long idx = row * n + col;
      if (!first) add192(w, words[idx], words[mn + idx], words[2 * mn + idx]);
      if (!last) {
        words[idx] = w[0];
        words[mn + idx] = w[1];
        words[2 * mn + idx] = w[2];
        continue;
      }
      const int rel = kRel0 - (ea[row] + fb[col] + 2);
      if (beta_mode != 0) add_beta_c(w, beta, c[idx], rel);
      out[idx] = static_cast<long long>(round192(w, rel));
    }
  }
}

}  // namespace wg88

// ---------------------------------------------------------------------------
// Rungs (8, 12) to (16, 16): wgmma with TMA-fed stages, the classes split
// between two warpgroups, rounded in the epilogue
// ---------------------------------------------------------------------------
namespace wgw {

using u64 = unsigned long long;
constexpr int kBM = 64;                   // block rows: one wgmma M
constexpr int kBN = 16;                   // block columns, a class's wgmma N
constexpr int kBK = 32;                   // k per stage: one wgmma K
constexpr int kPlaneA = kBM * kBK;        // bytes of one A plane's tile
constexpr int kPlaneB = kBN * kBK;        // bytes of one B^T plane's tile
constexpr int kWidth = 4;                 // classes a window aims at
constexpr int kThreads = 384;             // two consumer warpgroups, TMA
constexpr int kConsumerWarps = 8;
constexpr int kGroupM = 8;                // row tiles a group of blocks takes
constexpr int kSmemBudget = 232448 - 1024 - 256;

// Warpgroup 0 holds the lower half of the classes, 1 the rest: len(n_cls,
// h) classes from cut(n_cls, h, 0), in parts(len) windows of about kWidth
// classes and at most 9 (wgmma_s8's widths); window w, classes
// [cut(h, w), cut(h, w + 1)), shares one accumulator, as wg88's windows do.
__host__ __device__ constexpr int len(int n_cls, int h) {
  return h == 0 ? (n_cls + 1) / 2 : n_cls - (n_cls + 1) / 2;
}
__host__ __device__ constexpr int parts(int n) {
  return (n + kWidth / 2) / kWidth > (n + 8) / 9 ? (n + kWidth / 2) / kWidth
                                                 : (n + 8) / 9;
}
__host__ __device__ constexpr int cut(int n_cls, int h, int w) {
  return (h == 0 ? 0 : len(n_cls, 0)) +
         len(n_cls, h) * w / parts(len(n_cls, h));
}
// The digits s of A (of sa_planes) whose products with the B^T planes (of
// sb_planes) reach classes [c0, c1).
__host__ __device__ constexpr int first_s(int sb_planes, int c0) {
  return c0 - (sb_planes - 1) > 0 ? c0 - (sb_planes - 1) : 0;
}
__host__ __device__ constexpr int last_s(int sa_planes, int c1) {
  return c1 - 1 < sa_planes - 1 ? c1 - 1 : sa_planes - 1;
}
// The lowest (top = 0) or highest (top = 1) B^T plane a window reads.
__host__ __device__ constexpr int plane_edge(int sa_planes, int sb_planes,
                                             int top) {
  const int n_cls = sa_planes + sb_planes - 1;
  int t = top ? sb_planes - 1 : 0;
  for (int h = 0; h < 2; ++h) {
    for (int w = 0; w < parts(len(n_cls, h)); ++w) {
      const int c0 = cut(n_cls, h, w), c1 = cut(n_cls, h, w + 1);
      const int v = top ? c1 - 1 - first_s(sb_planes, c0)
                        : c0 - last_s(sa_planes, c1);
      t = (top ? v > t : v < t) ? v : t;
    }
  }
  return t;
}

// Rung (SA - 1, SB - 1): SA digit planes of A, SB of B^T.
template <int SA, int SB>
struct Rung {
  static constexpr int kCls = SA + SB - 1;
  static constexpr int kRel0 = 8 * (kCls - 1);  // class 0's relative bit
  // |exact value| < 2^(kRel0 + 38) (k below 2^22, beta*c at most
  // MXU_BETA_HEAD = 36 bits above the anchor): words of two's complement.
  static constexpr int kWords = (kRel0 + 39 + 63) / 64;
  static constexpr int kTLo = plane_edge(SA, SB, 0);  // the B^T stack holds
  static constexpr int kZPlanes = plane_edge(SA, SB, 1) - kTLo + 1;  // kTLo..
  static constexpr int kStageBytes = SA * kPlaneA + kZPlanes * kPlaneB;
  static constexpr int kTmaBytes = SA * kPlaneA + SB * kPlaneB;
  static constexpr int kStages = kSmemBudget / kStageBytes < 8
                                     ? kSmemBudget / kStageBytes : 8;
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;
  static_assert(kStages >= 2, "a ring of two stages at least");
  static_assert(kCls * 8 * 128 * 4 <= kStages * kStageBytes,
                "the epilogue's class sums fit in the ring");
  static_assert(2 * kWords > kRel0 / 32, "class 0 lands in the words");
};

// The wgmma of warpgroup H's windows W.. for one k step: A's planes at
// a_addr, the zero-padded B^T stack (planes kTLo..) at z; acc holds the
// warpgroup's classes from cut(H, 0) on, 8 registers each.
template <int SA, int SB, int H, int W>
__device__ __forceinline__ void window_products(int* acc, unsigned a_addr,
                                                unsigned z) {
  constexpr int n_cls = SA + SB - 1;
  if constexpr (W < parts(len(n_cls, H))) {
    constexpr int c0 = cut(n_cls, H, W);
    constexpr int c1 = cut(n_cls, H, W + 1);
    constexpr int s0 = first_s(SB, c0);
    constexpr int s1 = last_s(SA, c1);
#pragma unroll
    for (int s = s0; s <= s1; ++s) {
      exblas::wgmma_s8<16 * (c1 - c0)>(
          acc + 8 * (c0 - cut(n_cls, H, 0)),
          exblas::wgmma_desc_sw32(a_addr + s * kPlaneA),
          exblas::wgmma_desc_sw32(z + (c0 - s - Rung<SA, SB>::kTLo) *
                                          kPlaneB));
    }
    window_products<SA, SB, H, W + 1>(acc, a_addr, z);
  }
}

// Consumer warpgroup H: its classes' sums over the launch's k steps, then
// stashed in the ring (class c, register e of thread j at
// [(8 c + e) * 128 + j]) once both warpgroups are done with it.
template <int SA, int SB, int H>
__device__ __forceinline__ void consume(unsigned char* smem, u64* full,
                                        u64* empty, int steps) {
  using R = Rung<SA, SB>;
  constexpr int c_lo = cut(R::kCls, H, 0);
  constexpr int n_acc = 8 * len(R::kCls, H);
  int acc[n_acc];
#pragma unroll
  for (int i = 0; i < n_acc; ++i) acc[i] = 0;
  const unsigned base = exblas::smem_u32(smem);
  for (int step = 0; step < steps; ++step) {
    const int st = step % R::kStages;
    exblas::mbar_wait(full + st, (step / R::kStages) & 1);
    const unsigned a_addr = base + st * R::kStageBytes;
    exblas::wgmma_fence();
    window_products<SA, SB, H, 0>(acc, a_addr, a_addr + SA * kPlaneA);
    exblas::wgmma_commit();
    // The previous step's products are done: its stage may be refilled.
    exblas::wgmma_wait<1>();
    if (step > 0 && (threadIdx.x & 31) == 0) {
      exblas::mbar_arrive(empty + (step - 1) % R::kStages);
    }
  }
  exblas::wgmma_wait<0>();
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  int* stash = reinterpret_cast<int*>(smem) + (threadIdx.x & 127);
#pragma unroll
  for (int i = 0; i < n_acc; ++i) stash[(8 * c_lo + i) * 128] = acc[i];
}

// The NW words (two's complement, unit 2^(e_base - rel0)) of
// sum_c M_c * 2^(rel0 - 8c) from the stashed class sums s[c * 1024]:
// int64 sums at 32-bit spacing, four classes each, then one carry pass.
template <int NCLS, int NW>
__device__ __forceinline__ void class_words(const int* s, u64 (&w)[NW]) {
  long long t[2 * NW];
#pragma unroll
  for (int i = 0; i < 2 * NW; ++i) t[i] = 0;
#pragma unroll
  for (int c = 0; c < NCLS; ++c) {
    const int p = 8 * (NCLS - 1 - c);
    t[p >> 5] += static_cast<long long>(s[c * 1024]) * (1LL << (p & 31));
  }
  long long x = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    x += t[2 * i];
    const unsigned lo = static_cast<unsigned>(x);
    x = (x >> 32) + t[2 * i + 1];
    const unsigned hi = static_cast<unsigned>(x);
    x >>= 32;
    w[i] = lo | (static_cast<u64>(hi) << 32);
  }
}

// w += x (mod 2^(64 NW)).
template <int NW>
__device__ __forceinline__ void add_words(u64 (&w)[NW], const u64 (&x)[NW]) {
  u64 carry = 0ULL;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const u64 s = w[i] + x[i];
    const u64 c1 = s < x[i] ? 1ULL : 0ULL;
    w[i] = s + carry;
    carry = c1 + (w[i] < carry ? 1ULL : 0ULL);
  }
}

// x = -x (mod 2^(64 NW)).
template <int NW>
__device__ __forceinline__ void negate_words(u64 (&x)[NW]) {
  u64 carry = 1ULL;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    x[i] = ~x[i] + carry;
    carry = (carry != 0ULL && x[i] == 0ULL) ? 1ULL : 0ULL;
  }
}

// w += beta * c, exact, as wg88::add_beta_c on NW words: where both are
// finite and nonzero and the product's lsb lies at relative bit
// 0 <= p < 64 NW; anything else adds nothing.
template <int NW>
__device__ __forceinline__ void add_beta_c(u64 (&w)[NW], long long beta,
                                           long long cv, int rel) {
  const int eb = static_cast<int>((beta >> 52) & 0x7FF);
  const int ec = static_cast<int>((cv >> 52) & 0x7FF);
  u64 mb = static_cast<u64>(beta) & exblas::kFracMask;
  u64 mc = static_cast<u64>(cv) & exblas::kFracMask;
  if (eb != 0) mb |= 1ULL << 52;
  if (ec != 0) mc |= 1ULL << 52;
  const int p = (eb > 1 ? eb : 1) + (ec > 1 ? ec : 1) - 2150 + rel;
  if (eb == 0x7FF || ec == 0x7FF || mb == 0ULL || mc == 0ULL || p < 0 ||
      p >= 64 * NW) {
    return;
  }
  const u64 lo = mb * mc;
  const u64 hi = __umul64hi(mb, mc);
  const int s = p & 63;
  const u64 y0 = lo << s;
  const u64 y1 = s ? (hi << s) | (lo >> (64 - s)) : hi;
  const u64 y2 = s ? hi >> (64 - s) : 0ULL;
  const int q = p >> 6;
  u64 x[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    x[i] = i == q ? y0 : (i == q + 1 ? y1 : (i == q + 2 ? y2 : 0ULL));
  }
  if ((beta ^ cv) < 0) negate_words(x);
  add_words(w, x);
}

// The correctly rounded binary64 of NW two's-complement words, bit p of
// exponent p - offset_bits; an exact zero is +0.0.
template <int NW>
__device__ __forceinline__ u64 round_words(u64 (&w)[NW], int offset_bits) {
  const bool negative = static_cast<long long>(w[NW - 1]) < 0;
  if (negative) negate_words(w);
  int t = 0, l = NW;
  u64 top = 0ULL, below = 0ULL;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    if (w[i] != 0ULL) {
      t = i;
      top = w[i];
      below = i > 0 ? w[i - 1] : 0ULL;
      if (l == NW) l = i;
    }
  }
  if (l == NW) return 0ULL;
  return exblas::round_window(negative, t, l, top, below, offset_bits);
}

// One launch covers k elements [k0, k0 + 32 steps) of every output tile
// of 64 x 16: the class sums of that chunk, added to the words of the
// earlier chunks (first == 0: words (kWords, m, n) holds them), then
// either the words of this chunk (last == 0) or the rounded result
// (last != 0, with beta * c).
template <int SA, int SB>
__global__ void __launch_bounds__(kThreads, 1)
    wide_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b, int k0, int steps,
                long long m_tiles, long long n_tiles,
                const int* __restrict__ ea, const int* __restrict__ fb,
                const long long* __restrict__ c, long long beta,
                int beta_mode, long long m, long long n,
                u64* __restrict__ words, int first, int last,
                long long* __restrict__ out) {
  using R = Rung<SA, SB>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - (exblas::smem_u32(smem_raw) & 1023u)) & 1023u);
  u64* full = reinterpret_cast<u64*>(smem + R::kStages * R::kStageBytes);
  u64* empty = full + R::kStages;
  // Groups of kGroupM row tiles sweep the column tiles.
  const long long id = blockIdx.x;
  const long long per_group = kGroupM * n_tiles;
  const long long first_m = id / per_group * kGroupM;
  const long long gm =
      m_tiles - first_m < kGroupM ? m_tiles - first_m : kGroupM;
  const long long in_group = id % per_group;
  const int row0 = static_cast<int>((first_m + in_group % gm) * kBM);
  const int col0 = static_cast<int>(in_group / gm * kBN);
  // The warpgroup, warp-uniform for ptxas: setmaxnreg needs that.
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 7),
                             0);
  {  // the zero planes around the B^T stack stay zero
    uint4* z = reinterpret_cast<uint4*>(smem);
    for (int i = threadIdx.x; i < R::kStages * R::kStageBytes / 16;
         i += kThreads) {
      z[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    exblas::fence_proxy_async();
  }
  if (threadIdx.x == 0) {
    for (int st = 0; st < R::kStages; ++st) {
      exblas::mbar_init(full + st, 1);
      exblas::mbar_init(empty + st, kConsumerWarps);
    }
    exblas::mbar_init_fence();
  }
  __syncthreads();
  if (wg == 2) {
    // The producer warpgroup: one thread keeps the ring full.
    exblas::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      exblas::tma_prefetch(&map_a);
      exblas::tma_prefetch(&map_b);
      for (int step = 0; step < steps; ++step) {
        const int st = step % R::kStages;
        exblas::mbar_wait(empty + st, ((step / R::kStages) & 1) ^ 1);
        exblas::mbar_expect_tx(full + st, R::kTmaBytes);
        unsigned char* s = smem + st * R::kStageBytes;
        const int kk = k0 + step * kBK;
        exblas::tma_load_3d(s, &map_a, full + st, kk, row0, 0);
        exblas::tma_load_3d(s + SA * kPlaneA - R::kTLo * kPlaneB, &map_b,
                            full + st, kk, col0, 0);
      }
    }
  } else {
    exblas::setmaxnreg_inc<232>();
    if (wg == 0) {
      consume<SA, SB, 0>(smem, full, empty, steps);
    } else {
      consume<SA, SB, 1>(smem, full, empty, steps);
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");  // every class stashed
    // Thread j of a warpgroup (warp wi, lane 4g + tq) held, for register
    // e, row 16 wi + g + 8 ((e >> 1) & 1), column 8 (e >> 2) + 2 tq + (e & 1)
    // of each class; consumer thread x rounds registers 4 (x >> 7) .. + 3
    // of thread j = x & 127.
    const int j = threadIdx.x & 127;
    const int wi = j >> 5;
    const int g = (j & 31) >> 2;
    const int tq = j & 3;
    const int* stash = reinterpret_cast<const int*>(smem) + j;
    const long long mn = m * n;
#pragma unroll 1
    for (int i = 0; i < 4; ++i) {
      const int e = 4 * static_cast<int>(threadIdx.x >> 7) + i;
      const long long row = row0 + wi * 16 + g + ((e & 2) ? 8 : 0);
      const long long col = col0 + (e >> 2) * 8 + 2 * tq + (e & 1);
      if (row >= m || col >= n) continue;
      u64 w[R::kWords];
      class_words<R::kCls>(stash + e * 128, w);
      const long long idx = row * n + col;
      if (!first) {
        u64 prev[R::kWords];
#pragma unroll
        for (int q = 0; q < R::kWords; ++q) prev[q] = words[q * mn + idx];
        add_words(w, prev);
      }
      if (!last) {
#pragma unroll
        for (int q = 0; q < R::kWords; ++q) words[q * mn + idx] = w[q];
        continue;
      }
      const int rel = R::kRel0 - (ea[row] + fb[col] + 2);
      if (beta_mode != 0) add_beta_c(w, beta, c[idx], rel);
      out[idx] = static_cast<long long>(round_words(w, rel));
    }
  }
}

}  // namespace wgw

// ---------------------------------------------------------------------------
// The digit planes
// ---------------------------------------------------------------------------

// Balanced signed base-256 digits of x (rows, k), row-major int64 bits,
// anchored per row (mxu.cuh's excess-128 recode, the port of
// make_digits): digit u of element (r, c) goes to out[u][r][c] of
// (n_slices + 1, rows_pad, k_pad) int8, zeros beyond (rows, k).  A thread
// recodes four k-consecutive elements and stores each plane's four digits
// as one 32-bit word; kNs8 is the main path's n_slices = 8.
template <bool kNs8>
__global__ void __launch_bounds__(256)
    mxu_digits_kernel(const long long* __restrict__ x, long long rows,
                      long long k, const long long* __restrict__ anchors,
                      int n_slices, long long rows_pad, long long k_pad,
                      int8_t* __restrict__ out) {
  const long long quads = k_pad / 4;
  const long long step = rows_pad * quads;  // a plane, in 32-bit words
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < step; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = e / quads;
    const long long c = (e - r * quads) * 4;
    long long bits[4] = {0, 0, 0, 0};
    const int anchor = r < rows ? static_cast<int>(anchors[r]) : 0;
    if (r < rows) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c + j < k) bits[j] = __ldg(x + r * k + c + j);
      }
    }
    unsigned* dst = reinterpret_cast<unsigned*>(out) + e;
    if (kNs8) {
      double s1, s2;
      exblas::window_scales8(anchor, s1, s2);
      unsigned long long w[4];
      int carry[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w[j] = exblas::excess8(bits[j], s1, s2, carry[j]);
      }
      unsigned p[9];
      exblas::pack_digits8(w, carry, p);
#pragma unroll
      for (int u = 0; u < 9; ++u) dst[u * step] = p[u];
    } else {
      const int off = exblas::window_offset(anchor, n_slices);
      exblas::ExcessFrame f[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        f[j] = exblas::excess_frame(bits[j], off, n_slices);
      }
      for (int u = 0; u <= n_slices; ++u) {
        unsigned word = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = exblas::excess_digit(f[j], n_slices, u);
          word |= (static_cast<unsigned>(d) & 0xFFu) << (8 * j);
        }
        dst[u * step] = word;
      }
    }
  }
}

// One thread per element (i, j) of rows [0, m_rows) x [0, n): combine the
// class sums and beta * c exactly and round once.
__global__ void __launch_bounds__(256)
    mxu_round_kernel(const long long* __restrict__ cls, int n_cls,
                     long long rows, long long n_pad,
                     const int* __restrict__ ea, const int* __restrict__ fb,
                     const long long* __restrict__ c, long long beta,
                     int beta_mode, long long m_rows, long long n, int nl,
                     int rel0, long long* __restrict__ out) {
  const long long total = m_rows * n;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long i = e / n;
    const long long j = e % n;
    long long limbs[kMaxRel];
    for (int l = 0; l < nl; ++l) limbs[l] = 0;
    // Class c has weight 2^(e_base - 8c): relative bit rel0 - 8c.
    for (int cc = 0; cc < n_cls; ++cc) {
      const long long v = cls[(cc * rows + i) * n_pad + j];
      if (v != 0) exblas::add_scaled(limbs, v, rel0 - 8 * cc);
    }
    const int e_base = ea[i] + fb[j] + 2;
    if (beta_mode != 0) {
      long long sn = 0, sp = 0, sm = 0;  // specials: the dispatcher's
      int q;
      unsigned long long lo, hi;
      bool negative;
      if (exblas::decode_product(beta, c[e], rel0 - e_base, q, lo, hi,
                                 negative, sn, sp, sm)) {
        exblas::add_digits<exblas::kDigits>(limbs, nl, q, lo, hi, negative);
      }
    }
    out[e] = static_cast<long long>(
        exblas::round_limbs(limbs, 0, nl - 1, nl, rel0 - e_base));
  }
}

int grid_for(long long total, int threads, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (total + threads - 1) / threads;
  const long long cap = static_cast<long long>(sms) * (2048 / threads);
  *grid = static_cast<int>(want < cap ? want : cap);
  return 0;
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (no link against libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// The TMA map of n_planes digit planes (n_planes, rows_pad, k_pad) int8:
// boxes of 32 k x box_rows rows x n_planes planes in the 32-byte swizzle.
int plane_map(CUtensorMap* map, const void* planes, long long rows_pad,
              long long k_pad, unsigned box_rows, unsigned n_planes) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(k_pad),
                              static_cast<cuuint64_t>(rows_pad),
                              static_cast<cuuint64_t>(n_planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(k_pad),
                                 static_cast<cuuint64_t>(rows_pad * k_pad)};
  const cuuint32_t box[3] = {32, box_rows, n_planes};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(planes), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The rungs (sa, sb) wgw::wide_kernel is built for, one instance of
// (sa + 1, sb + 1) planes each, in gemm_mxu.py WG_RUNGS' order: X(sa, sb)
// for each.  wide_instance and mxu_gemm_wide_cuda's dispatch expand it.
#define EXBLAS_WG_RUNGS(X) \
  X(8, 12) X(12, 8) X(8, 16) X(16, 8) X(12, 12) X(12, 16) X(16, 12) X(16, 16)

#define EXBLAS_WG_COUNT(A, B) +1
constexpr int kNWide = 0 EXBLAS_WG_RUNGS(EXBLAS_WG_COUNT);
#undef EXBLAS_WG_COUNT

template <int SA, int SB>
int wide_launch(const void* ad, const void* bd, long long m_pad,
                long long n_pad, long long k_pad, long long k0,
                long long k_len, const void* ea, const void* fb,
                const void* c, long long beta, int beta_mode, long long m,
                long long n, void* words, int first, int last, void* out,
                cudaStream_t stream) {
  using R = wgw::Rung<SA, SB>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      wgw::wide_kernel<SA, SB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      R::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap map_a, map_b;
  int err = plane_map(&map_a, ad, m_pad, k_pad, wgw::kBM, SA);
  if (err == 0) err = plane_map(&map_b, bd, n_pad, k_pad, wgw::kBN, SB);
  if (err != 0) return err;
  const long long m_tiles = m_pad / wgw::kBM;
  const long long n_tiles = n_pad / wgw::kBN;
  wgw::wide_kernel<SA, SB><<<static_cast<unsigned>(m_tiles * n_tiles),
                             wgw::kThreads, R::kSmem, stream>>>(
      map_a, map_b, static_cast<int>(k0), static_cast<int>(k_len / wgw::kBK),
      m_tiles, n_tiles, static_cast<const int*>(ea),
      static_cast<const int*>(fb), static_cast<const long long*>(c), beta,
      beta_mode, m, n, static_cast<unsigned long long*>(words), first, last,
      static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The instance of the i-th rung of EXBLAS_WG_RUNGS: its attributes, for
// gemm_mxu_attrs.
const void* wide_instance(int i) {
#define EXBLAS_WG_PTR(A, B) \
  reinterpret_cast<const void*>(wgw::wide_kernel<A + 1, B + 1>),
  static const void* const kernels[kNWide] = {EXBLAS_WG_RUNGS(EXBLAS_WG_PTR)};
#undef EXBLAS_WG_PTR
  return i >= 0 && i < kNWide ? kernels[i] : nullptr;
}

}  // namespace

extern "C" {

// Class sums of `rows` output rows (a multiple of 32) against all n_pad
// columns, for every rung but (8, 8): ad points at the first row of digit
// plane 0 of A (planes plane_a bytes apart), bd at B^T's digit plane 0
// (planes plane_b apart); both k_pad-contiguous, k_pad a multiple of 32,
// kc a multiple of 32.  cls: int64 (sa+sb+1, rows, n_pad), written whole.
int mxu_classes_cuda(const void* ad, const void* bd, int sa, int sb,
                     long long plane_a, long long plane_b, long long rows,
                     long long n_pad, long long k_pad, long long kc,
                     void* cls, void* stream) {
  const dim3 grid(static_cast<unsigned>(n_pad / kTile),
                  static_cast<unsigned>(rows / kTile),
                  static_cast<unsigned>((sa + sb + 1 + kG - 1) / kG));
  mxu_class_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(ad), static_cast<const int8_t*>(bd), sa, sb,
      plane_a, plane_b, rows, n_pad, k_pad, kc, static_cast<long long*>(cls));
  return static_cast<int>(cudaGetLastError());
}

// Rung (8, 8): k elements [k0, k0 + k_len) of every element of the
// (m, n) result.  ad: A's digit planes (9, m_pad, k_pad) int8, bd: B^T's
// (9, n_pad, k_pad); m_pad a multiple of 64, n_pad of 32, k0 and k_len of
// 32, k_len at most gemm_mxu.py's exact chunk.  ea (m,), fb (n,) int32
// anchors; c (m, n) float64 bits (unused when beta_mode == 0).  words:
// (3, m, n) int64, read unless first, written unless last (null for one
// chunk); out (m, n) int64 bits, written when last.
int mxu_gemm88_cuda(const void* ad, const void* bd, long long m_pad,
                    long long n_pad, long long k_pad, long long k0,
                    long long k_len, const void* ea, const void* fb,
                    const void* c, long long beta, int beta_mode, long long m,
                    long long n, void* words, int first, int last, void* out,
                    void* stream) {
  if (m_pad % wg88::kBM || n_pad % wg88::kBN || k0 % wg88::kBK ||
      k_len % wg88::kBK || k_len <= 0 || k0 + k_len > k_pad ||
      k_pad > 0x7FFFFFFFLL || m_pad > 0x7FFFFFFFLL || n_pad > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      wg88::gemm88_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      wg88::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap map_a, map_b;
  int err = plane_map(&map_a, ad, m_pad, k_pad, wg88::kBM, wg88::kS);
  if (err == 0) {
    err = plane_map(&map_b, bd, n_pad, k_pad, wg88::kWN, wg88::kS);
  }
  if (err != 0) return err;
  const long long m_tiles = m_pad / wg88::kBM;
  const long long n_tiles = n_pad / wg88::kBN;
  wg88::gemm88_kernel<<<static_cast<unsigned>(m_tiles * n_tiles),
                        wg88::kThreads, wg88::kSmem,
                        static_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, static_cast<int>(k0),
      static_cast<int>(k_len / wg88::kBK), m_tiles, n_tiles,
      static_cast<const int*>(ea), static_cast<const int*>(fb),
      static_cast<const long long*>(c), beta, beta_mode, m, n,
      static_cast<unsigned long long*>(words), first, last,
      static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Rungs (8, 12) to (16, 16) (gemm_mxu.py WG_RUNGS): k elements [k0, k0 +
// k_len) of every element of the (m, n) result, as mxu_gemm88_cuda at
// (8, 8).  ad: A's digit planes (sa + 1, m_pad, k_pad) int8, bd: B^T's
// (sb + 1, n_pad, k_pad); m_pad a multiple of 64, n_pad of 16, k0 and k_len
// of 32, k_len at most the rung's exact chunk (gemm_mxu.py exact_chunk).
// words: (Rung::kWords, m, n) int64 (gemm_mxu.py wg_words), read unless
// first, written unless last.
int mxu_gemm_wide_cuda(const void* ad, const void* bd, int sa, int sb,
                       long long m_pad, long long n_pad, long long k_pad,
                       long long k0, long long k_len, const void* ea,
                       const void* fb, const void* c, long long beta,
                       int beta_mode, long long m, long long n, void* words,
                       int first, int last, void* out, void* stream) {
  const long long pairs = (sa < sb ? sa : sb) + 1;
  if (m_pad % wgw::kBM || n_pad % wgw::kBN || k0 % wgw::kBK ||
      k_len % wgw::kBK || k_len <= 0 || k0 + k_len > k_pad ||
      k_len * pairs * 16384 > 0x7FFFFFFFLL || k_pad > 0x7FFFFFFFLL ||
      m_pad > 0x7FFFFFFFLL || n_pad > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define EXBLAS_WIDE(A, B)                                                    \
  if (sa == A && sb == B) {                                                  \
    return wide_launch<A + 1, B + 1>(ad, bd, m_pad, n_pad, k_pad, k0, k_len, \
                                     ea, fb, c, beta, beta_mode, m, n, words, \
                                     first, last, out, s);                   \
  }
  EXBLAS_WG_RUNGS(EXBLAS_WIDE)
#undef EXBLAS_WIDE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Digit planes of x (rows, k) int64 bits, row-major, anchored by the int64
// anchors (rows,): out int8 (n_slices + 1, rows_pad, k_pad), written whole;
// k_pad a multiple of 4.
int mxu_digits_cuda(const void* x, long long rows, long long k,
                    const void* anchors, int n_slices, long long rows_pad,
                    long long k_pad, void* out, void* stream) {
  if (k_pad % 4) return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  const int err = grid_for(rows_pad * k_pad / 4, 256, &grid);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* px = static_cast<const long long*>(x);
  const auto* pa = static_cast<const long long*>(anchors);
  auto* po = static_cast<int8_t*>(out);
  if (n_slices == 8) {
    mxu_digits_kernel<true><<<grid, 256, 0, s>>>(px, rows, k, pa, n_slices,
                                                 rows_pad, k_pad, po);
  } else {
    mxu_digits_kernel<false><<<grid, 256, 0, s>>>(px, rows, k, pa, n_slices,
                                                  rows_pad, k_pad, po);
  }
  return static_cast<int>(cudaGetLastError());
}

// Rounds elements [0, m_rows) x [0, n) from their class sums (as written
// by mxu_classes_cuda), anchors ea (m_rows,) and fb (n,), and beta * c
// (c: (m_rows, n) float64 bits, unused when beta_mode == 0).  nl <= 48
// limbs must hold the exact value relative to 2^(e_base - rel0).
int mxu_round_cuda(const void* cls, int n_cls, long long rows,
                   long long n_pad, const void* ea, const void* fb,
                   const void* c, long long beta, int beta_mode,
                   long long m_rows, long long n, int nl, int rel0,
                   void* out, void* stream) {
  if (nl > kMaxRel) return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  const int err = grid_for(m_rows * n, 256, &grid);
  if (err != 0) return err;
  mxu_round_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(cls), n_cls, rows, n_pad,
      static_cast<const int*>(ea), static_cast<const int*>(fb),
      static_cast<const long long*>(c), beta, beta_mode, m_rows, n, nl, rel0,
      static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out[0..3] = registers a thread, local (spilled) bytes, static and
// dynamic shared bytes (as set before its first launch) of kernel
// `which`: 0 the rung (8, 8) class kernel, 1 the digit kernel at
// n_slices = 8, 2 the digit kernel at other n_slices, 3 + i the class
// kernel of the i-th rung of WG_RUNGS.
int gemm_mxu_attrs(int which, void* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaErrorInvalidValue;
  if (which == 0) err = cudaFuncGetAttributes(&a, wg88::gemm88_kernel);
  if (which == 1) err = cudaFuncGetAttributes(&a, mxu_digits_kernel<true>);
  if (which == 2) err = cudaFuncGetAttributes(&a, mxu_digits_kernel<false>);
  if (which >= 3 && which < 3 + kNWide) {
    err = cudaFuncGetAttributes(&a, wide_instance(which - 3));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  int* o = static_cast<int*>(out);
  o[0] = a.numRegs;
  o[1] = static_cast<int>(a.localSizeBytes);
  o[2] = static_cast<int>(a.sharedSizeBytes);
  o[3] = a.maxDynamicSharedSizeBytes;
  return 0;
}

}  // extern "C"
