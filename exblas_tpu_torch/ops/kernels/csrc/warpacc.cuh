// Warp-owned exact accumulators of the ExDOT and ExGEMV row kernels (B4,
// B7) and, at the end of this file, of the ExSUM kernel (B2: SumAcc).
//
// A warp owns one DOT_FORMAT accumulator (216 limbs of 20 bits, bit 0 at
// 2^-2148) in three layers:
//   * a register window: one signed 256-bit sum a lane, bit 0 at limb
//     `base`, placed at the warp's first valid product.  A product whose
//     LSB lies in the window's first 64 bits is shifted there and added
//     whole, with no branch (the hit path, which every product of
//     realistic exponent ranges takes).  The window is
//     kept in carry-save form -- three 64-bit words, the carries out of
//     each counted apart, and a count of the negated products -- so that
//     a product's add is three independent 64-bit adds and not one carry
//     chain through 256 bits; settle() folds the counts in, on the spill
//     cadence and before the flush;
//   * int32 limbs in shared memory, a set a warp: any other product adds
//     its 7 digits (each |d| < 2^20) there by native 32-bit shared
//     atomicAdd (the miss path).  A 64-bit shared atomicAdd has no native
//     instruction on sm_90a and compiles to a compare-and-swap loop;
//   * int64 limbs in shared memory, a set a warp, limb j owned by lane
//     j % 32, which alone reads and writes it: no atomics.  The int32 layer
//     is spilled into it on a fixed cadence, and the window is flushed into
//     it once, at the end.
// A step decodes and adds its products' hits straight through, marking
// the misses and specials, and handles those in a second pass only when a
// lane marked one.
// Why nothing overflows:
//   * int32 layer: a step adds at most kPerStep products a lane, and
//     spill() runs at least every kSpillSteps steps, so a limb takes at
//     most 32 * kPerStep * kSpillSteps <= 2048 digits between spills:
//     |sum| <= 2048 * (2^20 - 1) < 2^31;
//   * window: a shifted product is below 2^(106 + 64) = 2^170, and at most
//     k <= 2^42 (MAX_TERMS, checked by the wrappers) of them reach a warp,
//     so the warp's sum is below 2^212: 256 bits hold it, and 12 digits and
//     a sign digit hold the flushed value; a count takes at most one a
//     product between two settles, at most kPerStep * kSpillSteps <= 64;
//   * int64 layer: a limb takes at most one digit below 2^20 per product
//     and per flush: below 2^63 for k <= 2^42.
// Integer addition is associative, so where a product is added never
// changes the accumulated integer, and the bits never depend on the launch
// geometry.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "deposit.cuh"

namespace exblas {

constexpr int kWarpSlots = 7;                // limbs a lane owns
constexpr int kWarpLimbs = 32 * kWarpSlots;  // 224 >= kDotLimbs
constexpr int kSpillDigits = 2048;           // 2048 * (2^20 - 1) < 2^31
constexpr int kWinWords = 4;                 // the window: 256 bits
constexpr int kWinShift = 64;                // LSB offsets a hit may have
constexpr int kWinDigits = 12;               // digits of a flushed window
static_assert(kDotLimbs <= kWarpLimbs, "a lane owns kWarpSlots limbs");
// The highest limb a flush writes: base <= 203 (the top product of two
// finite doubles has q = 204), plus kWinDigits digits and a sign digit.
static_assert(203 + kWinDigits < kDotLimbs, "the flush stays in the format");

// Bits [20t, 20t + 20) of a 256-bit value, 0 <= t < 12 known at run time.
__device__ __forceinline__ long long digit256(
    const unsigned long long (&w)[kWinWords], int t) {
  const int lo = 20 * t;
  const int wi = lo >> 6, sh = lo & 63;
  const unsigned long long x =
      wi == 0 ? w[0] : (wi == 1 ? w[1] : (wi == 2 ? w[2] : w[3]));
  const unsigned long long y = wi == 0 ? w[1] : (wi == 1 ? w[2] : w[3]);
  unsigned long long r = x >> sh;
  if (sh > 44) r |= y << (64 - sh);
  return static_cast<long long>(r & 0xFFFFFULL);
}

// w += x + cin over 256 bits (cin: 0 or 1).
__device__ __forceinline__ void add256(unsigned long long (&w)[kWinWords],
                                       unsigned long long x0,
                                       unsigned long long x1,
                                       unsigned long long x2,
                                       unsigned long long x3, unsigned cin) {
  asm("{\n\t.reg .u32 t;\n\t"
      "add.cc.u32 t, %4, 0xFFFFFFFF;\n\t"
      "addc.cc.u64 %0, %0, %5;\n\t"
      "addc.cc.u64 %1, %1, %6;\n\t"
      "addc.cc.u64 %2, %2, %7;\n\t"
      "addc.u64 %3, %3, %8;\n\t}"
      : "+l"(w[0]), "+l"(w[1]), "+l"(w[2]), "+l"(w[3])
      : "r"(cin), "l"(x0), "l"(x1), "l"(x2), "l"(x3));
}

// (hi:lo) = a * b exactly, for significands a, b < 2^53, from four 32-bit
// products.
__device__ __forceinline__ void mul53(unsigned long long a,
                                      unsigned long long b,
                                      unsigned long long& lo,
                                      unsigned long long& hi) {
  const unsigned a0 = static_cast<unsigned>(a);
  const unsigned a1 = static_cast<unsigned>(a >> 32);
  const unsigned b0 = static_cast<unsigned>(b);
  const unsigned b1 = static_cast<unsigned>(b >> 32);
  const unsigned long long p00 = static_cast<unsigned long long>(a0) * b0;
  const unsigned long long mid = static_cast<unsigned long long>(a0) * b1 +
                                 static_cast<unsigned long long>(a1) * b0 +
                                 (p00 >> 32);  // < 2^55
  lo = (mid << 32) | (p00 & 0xFFFFFFFFULL);
  hi = static_cast<unsigned long long>(a1) * b1 + (mid >> 32);
}

// The sum of a signed 256-bit value over the 32 lanes, in every lane.
__device__ __forceinline__ void warp_sum256(
    unsigned long long (&w)[kWinWords]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long x0 = __shfl_xor_sync(kFullMask, w[0], o);
    const unsigned long long x1 = __shfl_xor_sync(kFullMask, w[1], o);
    const unsigned long long x2 = __shfl_xor_sync(kFullMask, w[2], o);
    const unsigned long long x3 = __shfl_xor_sync(kFullMask, w[3], o);
    add256(w, x0, x1, x2, x3, 0u);
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// *p += v for v != 0 by a native 32-bit shared atomic (no branch).
__device__ __forceinline__ void red_shared_nz(int* p, int v) {
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.s32 q, %1, 0;\n\t"
      "@q red.shared.add.s32 [%0], %1;\n\t}" ::"r"(smem_addr(p)),
      "r"(v)
      : "memory");
}

// Zeroes a warp's int32 and int64 layers, kSlots limbs a lane (lane l
// owns limbs l + 32 j).  All 32 lanes call.
template <int kSlots>
__device__ __forceinline__ void zero_layers(int* s32, long long* s64) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    s32[lane + 32 * j] = 0;
    s64[lane + 32 * j] = 0LL;
  }
  __syncwarp();
}

// Moves a warp's int32 layer into its int64 layer, each lane its own
// limbs.  All 32 lanes call.
template <int kSlots>
__device__ __forceinline__ void spill_layers(int* s32, long long* s64) {
  __syncwarp();  // every lane's atomics are visible to the warp
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int l = lane + 32 * j;
    s64[l] += s32[l];
    s32[l] = 0;
  }
  __syncwarp();
}

// The warp's NaN, +Inf and -Inf counts, in every lane (*_t); zeroes the
// lanes' own (*_c).  All 32 lanes call.
__device__ __forceinline__ void warp_specials(long long& nan_c,
                                              long long& pinf_c,
                                              long long& ninf_c,
                                              long long& nan_t,
                                              long long& pinf_t,
                                              long long& ninf_t) {
  nan_t = nan_c;
  pinf_t = pinf_c;
  ninf_t = ninf_c;
  if (__any_sync(kFullMask, (nan_c | pinf_c | ninf_c) != 0LL)) {
    nan_t = warp_sum(nan_t);
    pinf_t = warp_sum(pinf_t);
    ninf_t = warp_sum(ninf_t);
  }
  nan_c = pinf_c = ninf_c = 0LL;
}

// kPerStep: the products a lane adds in a step at most.  Every member
// function is called by all 32 lanes of the warp together.  A step:
//   if (acc.unplaced()) for each product: acc.place(a, b);
//   rare = 0; for each product i: rare |= acc.add_hit(a, b) << i;
//   if (__any_sync(~0u, rare)) for each i: acc.add_rare(a, b, rare >> i & 1);
template <int kPerStep>
struct WarpAcc {
  static constexpr int kSpillSteps = kSpillDigits / (32 * kPerStep);
  static_assert(kSpillSteps >= 1, "a step adds too many digits");

  // The window's value, mod 2^256: sum_i win[i] 2^(64 i) + sum_i cy[i]
  // 2^(64 (i + 1)) + nneg (1 - 2^192), two's complement, bit 0 at limb
  // base: a product x added negated is (~x mod 2^192) + 1 - 2^192.
  unsigned long long win[kWinWords];
  unsigned cy[kWinWords - 1];  // carries out of win[0..2]
  unsigned nneg;               // the products added negated
  int base;     // the same in every lane; -1: not placed yet
  bool missed;  // this lane added to the int32 layer since the last spill
  long long nan_c, pinf_c, ninf_c;
  int* s32;        // the warp's kWarpLimbs int32 limbs
  long long* s64;  // the warp's kWarpLimbs int64 limbs

  // Zeroes both shared layers and the registers.
  __device__ __forceinline__ void init(int* s32_, long long* s64_) {
    s32 = s32_;
    s64 = s64_;
    zero_layers<kWarpSlots>(s32, s64);
    base = -1;
    missed = false;
    nan_c = pinf_c = ninf_c = 0LL;
    clear_window();
  }

  __device__ __forceinline__ void clear_window() {
#pragma unroll
    for (int i = 0; i < kWinWords; ++i) win[i] = 0ULL;
#pragma unroll
    for (int i = 0; i < kWinWords - 1; ++i) cy[i] = 0u;
    nneg = 0u;
  }

  // Folds the counts into the words (a lane alone).
  __device__ __forceinline__ void settle() {
    add256(win, nneg, static_cast<unsigned long long>(cy[0]),
           static_cast<unsigned long long>(cy[1]),
           static_cast<unsigned long long>(cy[2]) -
               static_cast<unsigned long long>(nneg),
           0u);
#pragma unroll
    for (int i = 0; i < kWinWords - 1; ++i) cy[i] = 0u;
    nneg = 0u;
  }

  __device__ __forceinline__ bool unplaced() const { return base < 0; }

  // Places the window at the first valid product a * b of the warp (the
  // lowest lane's, at the first call with one): its base limb q0 - 1.
  __device__ __forceinline__ void place(long long a, long long b) {
    if (base >= 0) return;  // warp-uniform
    const int ea = static_cast<int>((a >> 52) & 0x7FF);
    const int eb = static_cast<int>((b >> 52) & 0x7FF);
    const bool valid = ea != 0x7FF && eb != 0x7FF &&
                       (a & 0x7FFFFFFFFFFFFFFFLL) != 0 &&
                       (b & 0x7FFFFFFFFFFFFFFFLL) != 0;
    const unsigned mask = __ballot_sync(kFullMask, valid);
    if (mask == 0u) return;
    const int p = (ea > 1 ? ea : 1) + (eb > 1 ? eb : 1) - 2 * 1075 +
                  kDotOffset;
    const int q0 = __shfl_sync(kFullMask, p, __ffs(mask) - 1) / 20;
    base = q0 > 0 ? q0 - 1 : 0;
  }

  // Adds a * b (int64 bits of two binary64) to the window if it is a hit,
  // without a branch; returns whether it is a miss or a special, which
  // add_rare must then take.  Zeros add nothing and return false.
  __device__ __forceinline__ bool add_hit(long long a, long long b) {
    const int ea = static_cast<int>((a >> 52) & 0x7FF);
    const int eb = static_cast<int>((b >> 52) & 0x7FF);
    const unsigned long long frac = (1ULL << 52) - 1ULL;
    const unsigned long long ma =
        (static_cast<unsigned long long>(a) & frac) |
        (ea != 0 ? 1ULL << 52 : 0ULL);
    const unsigned long long mb =
        (static_cast<unsigned long long>(b) & frac) |
        (eb != 0 ? 1ULL << 52 : 0ULL);
    const bool special = ea == 0x7FF || eb == 0x7FF;
    const bool valid = !special && ma != 0ULL && mb != 0ULL;
    // the product's LSB relative to the window: p - 20 * base
    const int sh = (ea > 1 ? ea : 1) + (eb > 1 ? eb : 1) - 2 * 1075 +
                   kDotOffset - 20 * base;
    const bool hit = valid && static_cast<unsigned>(sh) < kWinShift;
    unsigned long long lo, hi;
    mul53(ma, mb, lo, hi);
    // (hi:lo) << sh over 192 bits (below 2^170), sh in [0, 64) for a hit
    const int s = sh & 63;
    const unsigned long long lsb = (lo >> 1) >> (63 - s);  // 0 for s == 0
    const unsigned long long hsb = (hi >> 1) >> (63 - s);
    // -x: the words xor m; the +1 and the -2^192 counted in nneg
    const unsigned long long m = (hit && (a ^ b) < 0) ? ~0ULL : 0ULL;
    const unsigned long long keep = hit ? ~0ULL : 0ULL;
    const unsigned long long x0 = ((lo << s) & keep) ^ m;
    const unsigned long long x1 = (((hi << s) | lsb) & keep) ^ m;
    const unsigned long long x2 = (hsb & keep) ^ m;
    win[0] += x0;
    win[1] += x1;
    win[2] += x2;
    cy[0] += win[0] < x0 ? 1u : 0u;
    cy[1] += win[1] < x1 ? 1u : 0u;
    cy[2] += win[2] < x2 ? 1u : 0u;
    nneg += static_cast<unsigned>(m & 1ULL);
    return special || (valid && !hit);
  }

  // One product alone (place, add_hit and add_rare).
  __device__ __forceinline__ void add_one(long long a, long long b) {
    place(a, b);
    const bool rare = add_hit(a, b);
    if (__any_sync(kFullMask, rare)) add_rare(a, b, rare);
  }

  // Takes a product add_hit returned true for (take): counts a special
  // as deposit.cuh's decode_product does (NaN, or Inf times zero: NaN;
  // else Inf with the xor of the signs), or adds a miss digit by digit to
  // the int32 layer.
  __device__ __forceinline__ void add_rare(long long a, long long b,
                                           bool take) {
    if (!take) return;
    const int ea = static_cast<int>((a >> 52) & 0x7FF);
    const int eb = static_cast<int>((b >> 52) & 0x7FF);
    const unsigned long long frac = (1ULL << 52) - 1ULL;
    const unsigned long long fa = static_cast<unsigned long long>(a) & frac;
    const unsigned long long fb = static_cast<unsigned long long>(b) & frac;
    const bool negative = (a ^ b) < 0;
    if (ea == 0x7FF || eb == 0x7FF) {
      const bool nan = (ea == 0x7FF && fa != 0ULL) ||
                       (eb == 0x7FF && fb != 0ULL) ||
                       (ea == 0x7FF && eb == 0 && fb == 0ULL) ||
                       (eb == 0x7FF && ea == 0 && fa == 0ULL);
      if (nan) {
        ++nan_c;
      } else if (negative) {
        ++ninf_c;
      } else {
        ++pinf_c;
      }
      return;
    }
    // a miss: finite, nonzero, outside the window
    const unsigned long long ma = fa | (ea != 0 ? 1ULL << 52 : 0ULL);
    const unsigned long long mb = fb | (eb != 0 ? 1ULL << 52 : 0ULL);
    const int p = (ea > 1 ? ea : 1) + (eb > 1 ? eb : 1) - 2 * 1075 +
                  kDotOffset;
    const int q = p / 20, r = p - 20 * q;
    unsigned long long lo, hi;
    mul53(ma, mb, lo, hi);
    hi = (hi << r) | ((lo >> 1) >> (63 - r));
    lo <<= r;
    const unsigned long long w[2] = {lo, hi};
#pragma unroll
    for (int t = 0; t < kDigits; ++t) {
      const int d = static_cast<int>(digit_at<2>(w, t));
      red_shared_nz(&s32[q + t], negative ? -d : d);
    }
    missed = true;
  }

  // Settles the window and moves the int32 layer into the int64 layer, if
  // a lane missed since the last spill.
  __device__ __forceinline__ void spill() {
    settle();
    if (!__any_sync(kFullMask, missed)) return;
    spill_layers<kWarpSlots>(s32, s64);
    missed = false;
  }

  // Spills, then adds the window, summed over the warp, to the int64
  // layer: its value V (|V| < 2^212, two's complement) is its 12 digits of
  // bits [0, 240) at limbs base.., plus -1 at limb base + 12 when V < 0.
  // Lane l adds the digit of limb base + ((l - base) mod 32), which it
  // owns.  Leaves the window unplaced and the counts as they are.
  __device__ __forceinline__ void flush() {
    spill();
    if (base < 0) return;  // warp-uniform: the warp saw no valid product
    warp_sum256(win);
    const int o = ((threadIdx.x & 31) - base) & 31;
    long long v = 0;
    if (o < kWinDigits) v = digit256(win, o);
    if (o == kWinDigits && static_cast<long long>(win[3]) < 0) v = -1;
    if (o <= kWinDigits) s64[base + o] += v;
    clear_window();
    base = -1;
  }

  // The warp's NaN, +Inf and -Inf counts, in every lane; zeroes the lanes'.
  __device__ __forceinline__ void special_totals(long long& nan_t,
                                                 long long& pinf_t,
                                                 long long& ninf_t) {
    warp_specials(nan_c, pinf_c, ninf_c, nan_t, pinf_t, ninf_t);
  }
};

// SUM_FORMAT (B2): 112 limbs of 20 bits, bit 0 at 2^-1074.  A warp owns
// one such accumulator in the same three layers as WarpAcc's, with a
// window sized to one significand:
//   * the register window: one signed 160-bit sum a lane, two's
//     complement, five 32-bit words, bit 0 at limb `base`.  A normal
//     double whose LSB lies in the window's first 64 bits is a hit: its
//     signed significand (|v| < 2^53), shifted there, is a 128-bit two's
//     complement value, added with one five-word carry chain.  There is
//     no carry-save form and no count to fold: the chain is five
//     instructions, and a warp's terms are independent enough that their
//     latency hides behind the other warps;
//   * misses (other finite nonzero doubles, subnormals among them) add
//     their 4 digits (|d| < 2^20) to int32 limbs by native 32-bit shared
//     atomics, spilled on the kSpillDigits cadence into lane-owned int64
//     limbs (4 a lane), as WarpAcc's;
//   * NaN, +Inf and -Inf are counted; zeros add nothing.
// Why nothing overflows: a hit is below 2^(53 + 63) = 2^116 and at most
// n <= 2^42 (MAX_TERMS, checked by the wrappers) reach a warp, so the
// warp's window sum is below 2^158: 160 bits hold it, its 8 digits and a
// sign digit hold the flushed value; a limb takes at most one digit below
// 2^20 per double, so the int32 layer stays below 2048 * 2^20 = 2^31
// between spills and the int64 layer below 2^63.
constexpr int kSumLimbs = 112;
constexpr int kSumSlots = 4;                   // limbs a lane owns
constexpr int kSumWarpLimbs = 32 * kSumSlots;  // 128 >= kSumLimbs
constexpr int kSumWinShift = 64;               // LSB offsets a hit may have
constexpr int kSumWinDigits = 8;               // digits of 160 bits
static_assert(kSumLimbs <= kSumWarpLimbs, "a lane owns kSumSlots limbs");
// The highest limb a flush writes: base <= 101 (the LSB of the largest
// double sits at limb 102), plus kSumWinDigits digits and a sign digit.
static_assert(101 + kSumWinDigits < kSumLimbs, "the flush stays in the format");

// x << s and x >> s (arithmetic) for any s: PTX clamps s to 64, so s >= 64
// gives 0 and the sign fill.
__device__ __forceinline__ unsigned long long shl64(unsigned long long x,
                                                    unsigned s) {
  unsigned long long r;
  asm("shl.b64 %0, %1, %2;" : "=l"(r) : "l"(x), "r"(s));
  return r;
}

__device__ __forceinline__ long long sar64(long long x, unsigned s) {
  long long r;
  asm("shr.s64 %0, %1, %2;" : "=l"(r) : "l"(x), "r"(s));
  return r;
}

// w += x over 160 bits, one carry chain.
__device__ __forceinline__ void add160(unsigned (&w)[5], unsigned x0,
                                       unsigned x1, unsigned x2, unsigned x3,
                                       unsigned x4) {
  asm("add.cc.u32 %0, %0, %5;\n\t"
      "addc.cc.u32 %1, %1, %6;\n\t"
      "addc.cc.u32 %2, %2, %7;\n\t"
      "addc.cc.u32 %3, %3, %8;\n\t"
      "addc.u32 %4, %4, %9;"
      : "+r"(w[0]), "+r"(w[1]), "+r"(w[2]), "+r"(w[3]), "+r"(w[4])
      : "r"(x0), "r"(x1), "r"(x2), "r"(x3), "r"(x4));
}

// kPerStep: the doubles a lane adds in a step at most.  Every member
// function is called by all 32 lanes of the warp together.  A step:
//   if (acc.unplaced()) for each double: acc.place(v);
//   rare = 0; for each double i: rare |= acc.add_hit(v) << i;
//   if (__any_sync(~0u, rare)) for each i: acc.add_rare(v, rare >> i & 1);
template <int kPerStep>
struct SumAcc {
  static constexpr int kSpillSteps = kSpillDigits / (32 * kPerStep);
  static_assert(kSpillSteps >= 1, "a step adds too many digits");

  unsigned win[5];  // the window, two's complement, bit 0 at limb base
  int base;         // the same in every lane; -1: not placed yet
  int off;          // 20 * base + 1: a normal double's LSB is at bit e - 1
  // off while unplaced: every exponent field lies below it, so no double
  // is a hit (a warp's first step may hold only zeros and specials)
  static constexpr int kUnplaced = 1 << 20;
  bool missed;      // this lane added to the int32 layer since the last spill
  long long nan_c, pinf_c, ninf_c;
  int* s32;        // the warp's kSumWarpLimbs int32 limbs
  long long* s64;  // the warp's kSumWarpLimbs int64 limbs

  // Zeroes both shared layers and the registers.
  __device__ __forceinline__ void init(int* s32_, long long* s64_) {
    s32 = s32_;
    s64 = s64_;
    zero_layers<kSumSlots>(s32, s64);
    base = -1;
    off = kUnplaced;
    missed = false;
    nan_c = pinf_c = ninf_c = 0LL;
    clear_window();
  }

  __device__ __forceinline__ void clear_window() {
#pragma unroll
    for (int i = 0; i < 5; ++i) win[i] = 0u;
  }

  __device__ __forceinline__ bool unplaced() const { return base < 0; }

  // Places the window at the first finite nonzero double of the warp (the
  // lowest lane's, at the first call with one): its base limb q0 - 1.
  __device__ __forceinline__ void place(long long v) {
    if (base >= 0) return;  // warp-uniform
    const int e = static_cast<int>((v >> 52) & 0x7FF);
    const bool valid = e != 0x7FF && (v & 0x7FFFFFFFFFFFFFFFLL) != 0;
    const unsigned mask = __ballot_sync(kFullMask, valid);
    if (mask == 0u) return;
    const int p = (e > 1 ? e : 1) - 1;  // the LSB's bit in SUM_FORMAT
    const int q0 = __shfl_sync(kFullMask, p, __ffs(mask) - 1) / 20;
    base = q0 > 0 ? q0 - 1 : 0;
    off = 20 * base + 1;
  }

  // Adds v (the int64 bits of a binary64) to the window if it is a hit,
  // without a branch; returns whether it is a miss or a special, which
  // add_rare must then take.  Zeros add nothing and return false.
  __device__ __forceinline__ bool add_hit(long long v) {
    const int e = static_cast<int>((v >> 52) & 0x7FF);
    const int sh = e - off;  // the LSB's offset in the window (normals)
    const bool hit = static_cast<unsigned>(sh) < kSumWinShift && e != 0x7FF;
    const long long keep = hit ? -1LL : 0LL;
    const long long neg = keep & (v >> 63);  // -1 for a negative hit
    const long long mant =
        ((v & ((1LL << 52) - 1)) | (1LL << 52)) & keep;
    const long long sv = (mant ^ neg) - neg;  // +-significand, 0 if no hit
    const unsigned long long lo = shl64(static_cast<unsigned long long>(sv),
                                        static_cast<unsigned>(sh));
    const long long hi = sar64(sv, static_cast<unsigned>(64 - sh));
    add160(win, static_cast<unsigned>(lo), static_cast<unsigned>(lo >> 32),
           static_cast<unsigned>(hi), static_cast<unsigned>(hi >> 32),
           static_cast<unsigned>(neg));
    return !hit && (v & 0x7FFFFFFFFFFFFFFFLL) != 0;
  }

  // One double alone (place, add_hit and add_rare).
  __device__ __forceinline__ void add_one(long long v) {
    place(v);
    const bool rare = add_hit(v);
    if (__any_sync(kFullMask, rare)) add_rare(v, rare);
  }

  // Takes a double add_hit returned true for (take): counts a NaN, +Inf
  // or -Inf, or adds a miss digit by digit to the int32 layer.
  __device__ __forceinline__ void add_rare(long long v, bool take) {
    if (!take) return;
    const int e = static_cast<int>((v >> 52) & 0x7FF);
    const unsigned long long frac =
        static_cast<unsigned long long>(v) & ((1ULL << 52) - 1ULL);
    const bool negative = v < 0;
    if (e == 0x7FF) {
      if (frac != 0ULL) {
        ++nan_c;
      } else if (negative) {
        ++ninf_c;
      } else {
        ++pinf_c;
      }
      return;
    }
    // a miss: finite, nonzero, outside the window or subnormal
    const unsigned long long mant = frac | (e != 0 ? 1ULL << 52 : 0ULL);
    const int p = (e > 1 ? e : 1) - 1;
    const int q = p / 20, r = p - 20 * q;
    const unsigned long long w[2] = {mant << r, (mant >> 1) >> (63 - r)};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int dig = static_cast<int>(digit_at<2>(w, t));
      red_shared_nz(&s32[q + t], negative ? -dig : dig);
    }
    missed = true;
  }

  // Moves the int32 layer into the int64 layer, if a lane missed since the
  // last spill.
  __device__ __forceinline__ void spill() {
    if (!__any_sync(kFullMask, missed)) return;
    spill_layers<kSumSlots>(s32, s64);
    missed = false;
  }

  // Bits [20t, 20t + 20) of the window (t < 8, known at run time).
  __device__ __forceinline__ long long digit(int t) const {
    const unsigned long long u[3] = {
        win[0] | (static_cast<unsigned long long>(win[1]) << 32),
        win[2] | (static_cast<unsigned long long>(win[3]) << 32),
        static_cast<unsigned long long>(
            static_cast<long long>(static_cast<int>(win[4])))};
    const int lo = 20 * t;
    const int wi = lo >> 6, sh = lo & 63;
    const unsigned long long x = wi == 0 ? u[0] : (wi == 1 ? u[1] : u[2]);
    const unsigned long long y = wi == 0 ? u[1] : u[2];
    unsigned long long r = x >> sh;
    if (sh > 44) r |= y << (64 - sh);
    return static_cast<long long>(r & 0xFFFFFULL);
  }

  // Spills, then adds the window, summed over the warp, to the int64
  // layer: its value V (|V| < 2^158, two's complement) is its 8 digits at
  // limbs base.., plus -1 at limb base + 8 when V < 0.  Lane l adds the
  // digit of limb base + ((l - base) mod 32), which it owns.  Leaves the
  // window unplaced and the counts as they are.
  __device__ __forceinline__ void flush() {
    spill();
    if (base < 0) return;  // warp-uniform: the warp saw no finite nonzero
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      unsigned x[5];
#pragma unroll
      for (int i = 0; i < 5; ++i) x[i] = __shfl_xor_sync(kFullMask, win[i], o);
      add160(win, x[0], x[1], x[2], x[3], x[4]);
    }
    const int o = ((threadIdx.x & 31) - base) & 31;
    long long v = 0;
    if (o < kSumWinDigits) v = digit(o);
    if (o == kSumWinDigits && static_cast<int>(win[4]) < 0) v = -1;
    if (o <= kSumWinDigits) s64[base + o] += v;
    clear_window();
    base = -1;
    off = kUnplaced;
  }

  // The warp's NaN, +Inf and -Inf counts, in every lane; zeroes the lanes'.
  __device__ __forceinline__ void special_totals(long long& nan_t,
                                                 long long& pinf_t,
                                                 long long& ninf_t) {
    warp_specials(nan_c, pinf_c, ninf_c, nan_t, pinf_t, ninf_t);
  }
};

}  // namespace exblas
