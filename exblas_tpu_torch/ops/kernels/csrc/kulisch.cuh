// The word accumulator shared by the exact GEMM (B5) and TRSV (B10)
// kernels: one exact DOT_FORMAT value as a two's-complement integer of
// kWords 64-bit words, little-endian, bit 0 at 2^-2148 (kDotOffset).
//
// DOT_FORMAT's 216 limbs of 20 bits hold 4,320 bits; 68 words hold 4,352,
// so the JAX canonical digits convert to words and back without loss
// (exblas_tpu_torch/core/words.py is the plain model, held against the JAX
// package's rounding by tests/test_torch_word_acc.py).  Unlike the limbs,
// words are never redundant: a deposit adds the exact 106-bit product into
// three consecutive words with carries, and a carry or borrow out of the
// third runs up until it stops (kBiasWord below keeps that short).
// Arithmetic is modulo 2^4352; every value of an exact sum of at most
// MAX_TERMS = 2^42 products lies below 2^4239 in magnitude (a product is
// below 2^(2148 + 2048), times 2^42, plus the sign), so the sum's words
// determine it.
//
// Word i of an accumulator lives at w[i * stride]: a block keeps many
// accumulators interleaved ([word][owner]), so that the 32 lanes of a warp,
// each at its own word, touch 32 distinct banks.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "round.cuh"

namespace exblas {

constexpr int kWords = 68;
constexpr int kWordOffset = 2148;  // DOT_FORMAT: bit 0 at 2^-2148

// The fields of one binary64 pattern, as the word kernels keep them: the
// significand (0 for zeros, infinities and NaNs), and a meta word holding
// max(expf, 1) in bits 0-10, the sign in bit 11 and the class flags.
constexpr int kMetaSign = 1 << 11;
constexpr int kMetaZero = 1 << 12;
constexpr int kMetaInf = 1 << 13;
constexpr int kMetaNan = 1 << 14;
constexpr int kMetaSpecial = kMetaInf | kMetaNan;

__device__ __forceinline__ void decode_meta(long long b,
                                            unsigned long long& mant,
                                            int& meta) {
  const int expf = static_cast<int>((b >> 52) & 0x7FF);
  const unsigned long long frac =
      static_cast<unsigned long long>(b) & ((1ULL << 52) - 1ULL);
  meta = (expf > 1 ? expf : 1) | (b < 0 ? kMetaSign : 0);
  if (expf == 0x7FF) {
    meta |= frac != 0ULL ? kMetaNan : kMetaInf;
    mant = 0ULL;
  } else {
    mant = expf != 0 ? (frac | (1ULL << 52)) : frac;
    if (mant == 0ULL) meta |= kMetaZero;
  }
}

// Counts the special product of two decoded elements, at least one of them
// Inf or NaN, as exblas_tpu/core/deposit.py does: NaN if either is NaN or
// Inf meets zero, else an infinity of the product's sign.
__device__ __forceinline__ void count_special(int ma, int mb, long long& nan_c,
                                              long long& pinf_c,
                                              long long& ninf_c) {
  const int both = ma | mb;
  if ((both & kMetaNan) || ((ma & kMetaInf) && (mb & kMetaZero)) ||
      ((mb & kMetaInf) && (ma & kMetaZero))) {
    ++nan_c;
  } else if (((ma ^ mb) & kMetaSign) != 0) {
    ++ninf_c;
  } else {
    ++pinf_c;
  }
}

// The bit position of the product of two finite nonzero decoded elements:
// bit p of the accumulator has exponent p - 2148, and E = max(expf,1)-1075,
// so p = ea + eb - 2 >= 0.
__device__ __forceinline__ int product_pos(int ma, int mb) {
  return (ma & 0x7FF) + (mb & 0x7FF) - 2;
}

// Decodes the product of two binary64 patterns a * b: counts it if it is
// special; returns true (with the exact product hi:lo, its bit position p
// and sign) if it is finite and nonzero.
__device__ __forceinline__ bool word_product(long long a, long long b,
                                             unsigned long long& lo,
                                             unsigned long long& hi, int& p,
                                             bool& negative, long long& nan_c,
                                             long long& pinf_c,
                                             long long& ninf_c) {
  unsigned long long xa, xb;
  int ma, mb;
  decode_meta(a, xa, ma);
  decode_meta(b, xb, mb);
  if ((ma | mb) & kMetaSpecial) {
    count_special(ma, mb, nan_c, pinf_c, ninf_c);
    return false;
  }
  if (xa == 0ULL || xb == 0ULL) return false;
  lo = xa * xb;
  hi = __umul64hi(xa, xb);
  p = product_pos(ma, mb);
  negative = ((ma ^ mb) & kMetaSign) != 0;
  return true;
}

// The three words of an exact product (hi:lo, below 2^106) shifted to bit
// p: word q = p / 64 and up.
struct Shifted {
  int q;
  unsigned long long x0, x1, x2;
};

__device__ __forceinline__ Shifted shift_product(int p, unsigned long long lo,
                                                 unsigned long long hi) {
  const int s = p & 63;
  Shifted r;
  r.q = p >> 6;
  r.x0 = lo << s;
  r.x1 = s ? (hi << s) | (lo >> (64 - s)) : hi;
  r.x2 = s ? hi >> (64 - s) : 0ULL;
  return r;
}

// a[0..2] +- x with carries; returns the carry (or borrow) out of a[2].
// One path for both signs, so the lanes of a warp do not split on the
// product's sign: a - x is a + (~x + 1) - 2^192 over three words, whose
// borrow out of a[2] is the carry's complement.
__device__ __forceinline__ bool add3(unsigned long long (&a)[3],
                                     const Shifted& x, bool negative) {
  const unsigned long long neg = negative ? 1ULL : 0ULL;
  const unsigned long long flip = 0ULL - neg;  // all ones for a - x
  const unsigned long long y0 = x.x0 ^ flip, y1 = x.x1 ^ flip,
                           y2 = x.x2 ^ flip;
  const unsigned long long t0 = a[0] + y0;
  const unsigned long long s0 = t0 + neg;
  const unsigned long long c0 = (t0 < a[0]) | (s0 < t0);
  const unsigned long long t1 = a[1] + y1;
  const unsigned long long s1 = t1 + c0;
  const unsigned long long c1 = (t1 < a[1]) | (s1 < t1);
  const unsigned long long t2 = a[2] + y2;
  const unsigned long long s2 = t2 + c1;
  const bool carry = (t2 < a[2]) | (s2 < t2);
  a[0] = s0;
  a[1] = s1;
  a[2] = s2;
  return carry != negative;
}

// Runs a carry (or borrow) up from word j until it stops or leaves the top.
__device__ __forceinline__ void propagate(unsigned long long* w, int stride,
                                          int j, bool negative) {
  bool more = true;
  for (; more && j < kWords; ++j) {
    const unsigned long long v = w[j * stride];
    w[j * stride] = negative ? v - 1ULL : v + 1ULL;
    more = negative ? v == 0ULL : v == ~0ULL;
  }
}

// w += (-1)^negative * (hi:lo) * 2^p, the exact product (below 2^106) at
// bit p >= 0 with p / 64 + 2 < kWords: three words with carries, then the
// carry or borrow runs up until it stops (or leaves the top word).
__device__ __forceinline__ void add_words(unsigned long long* w, int stride,
                                          int p, unsigned long long lo,
                                          unsigned long long hi,
                                          bool negative) {
  const Shifted x = shift_product(p, lo, hi);
  unsigned long long* p0 = w + x.q * stride;
  unsigned long long a[3] = {p0[0], p0[stride], p0[2 * stride]};
  const bool c = add3(a, x, negative);
  p0[0] = a[0];
  p0[stride] = a[1];
  p0[2 * stride] = a[2];
  if (c) propagate(w, stride, x.q + 3, negative);
}

// A biased accumulator starts with every word at kBiasWord = 2^63, that is
// at the constant B = sum_i 2^63 * 2^(64 i) (mod 2^4352).  A carry or
// borrow out of a deposit's third word then stops at the next word, unless
// that word has taken about 2^63 unit carries of one sign: so a deposit
// touches four words at most whatever the signs of the sum and the
// product.  Unbiased, a sum that changes sign flips every sign-extension
// word above the deposit, up to 65 of them.  unbias_words subtracts B once,
// before the rounding; the arithmetic is modular, so the bits are those of
// the unbiased sum.
constexpr unsigned long long kBiasWord = 1ULL << 63;

__device__ __forceinline__ void unbias_words(unsigned long long* w,
                                             int stride) {
  unsigned long long borrow = 0ULL;
#pragma unroll 4
  for (int i = 0; i < kWords; ++i) {
    const unsigned long long v = w[i * stride];
    const unsigned long long sub = kBiasWord + borrow;  // no wrap
    w[i * stride] = v - sub;
    borrow = v < sub;
  }
}

// Round the magnitude words top (word t) and below (word t - 1, 0 if
// t == 0) of a value whose lowest nonzero word is l to binary64 bits:
// the 55-bit window under the leading bit, the sticky bit, then
// round.cuh's encode_round (round to nearest even, subnormals, overflow).
__device__ __forceinline__ unsigned long long round_window(
    bool negative, int t, int l, unsigned long long top,
    unsigned long long below, int offset_bits) {
  const int b = 63 - __clzll(static_cast<long long>(top));
  const int p_msb = 64 * t + b;
  unsigned long long m55;
  bool sticky;
  if (b >= 54) {  // the window lies in word t
    const int up = b - 54;
    m55 = top >> up;
    sticky = (top & ((1ULL << up) - 1ULL)) != 0ULL || below != 0ULL;
  } else {  // 54 - b bits come from word t - 1
    const int down = 54 - b;
    m55 = (top << down) | (below >> (64 - down));
    sticky = (below & ((1ULL << (64 - down)) - 1ULL)) != 0ULL;
  }
  sticky = sticky || l < t - 1;
  m55 &= (1ULL << 55) - 1ULL;
  const int e = p_msb - offset_bits;  // the leading bit's exponent
  if (e < -1022) return encode_round(negative, e, m55, sticky);  // subnormal
  // A normal result: round m55 to 53 bits; adding the rounded significand
  // to the biased exponent less one carries a round-up that reaches 2^53
  // into the exponent, and one at e = 1023 into the infinity's pattern.
  const unsigned long long m53 = m55 >> 2;
  const unsigned long long up =
      ((m55 >> 1) & 1ULL) & ((sticky || (m55 & 1ULL)) ? 1ULL : (m53 & 1ULL));
  const unsigned long long bits =
      e > 1023 ? kPInfBits
               : (static_cast<unsigned long long>(e + 1022) << 52) + m53 + up;
  return negative ? bits | kSignBit : bits;
}

// One thread rounds its own accumulator (word i at w[i * stride]); an exact
// zero is +0.0.  The steps of core/words.py round_words: the sign from the
// top word, the lowest nonzero word l, the top nonzero word t of the
// magnitude (0 below l, -w[l] at l and ~w[j] above l for a negative value),
// then the window.
__device__ __forceinline__ unsigned long long round_words(
    const unsigned long long* w, int stride,
    int offset_bits = kWordOffset) {
  int l = 0;
  while (l < kWords && w[l * stride] == 0ULL) ++l;
  if (l == kWords) return 0ULL;
  const bool negative =
      static_cast<long long>(w[(kWords - 1) * stride]) < 0;
  const unsigned long long ext = negative ? ~0ULL : 0ULL;
  int t = kWords - 1;
  while (t > l && w[t * stride] == ext) --t;
  auto mag = [&](int j) -> unsigned long long {
    if (j < l) return 0ULL;
    const unsigned long long v = w[j * stride];
    if (!negative) return v;
    return j == l ? 0ULL - v : ~v;
  };
  return round_window(negative, t, l, mag(t), t > 0 ? mag(t - 1) : 0ULL,
                      offset_bits);
}

// A warp rounds one accumulator: lane i holds words i, i + 32 and, for
// lanes below kWords - 64, i + 64 (w0, w1, w2).  Ballots find l and t,
// shuffles bring words t and t - 1 to every lane; every lane returns the
// bits.
__device__ __forceinline__ unsigned long long round_words_warp(
    unsigned long long w0, unsigned long long w1, unsigned long long w2,
    int offset_bits = kWordOffset) {
  const int lane = threadIdx.x & 31;
  const bool has2 = lane < kWords - 64;
  const unsigned n0 = __ballot_sync(0xffffffffu, w0 != 0ULL);
  const unsigned n1 = __ballot_sync(0xffffffffu, w1 != 0ULL);
  const unsigned n2 = __ballot_sync(0xffffffffu, has2 && w2 != 0ULL);
  if ((n0 | n1 | n2) == 0u) return 0ULL;
  const int l = n0 ? __ffs(n0) - 1
                   : (n1 ? 31 + __ffs(n1) : 63 + __ffs(n2));
  const bool negative =
      static_cast<long long>(__shfl_sync(0xffffffffu, w2, kWords - 65)) < 0;
  unsigned long long m0 = w0, m1 = w1, m2 = has2 ? w2 : 0ULL;
  unsigned t0 = n0, t1 = n1, t2 = n2;
  if (negative) {  // warp-uniform: the magnitude's words and their ballots
    auto mag = [&](unsigned long long v, int j) -> unsigned long long {
      if (j < l) return 0ULL;
      return j == l ? 0ULL - v : ~v;
    };
    m0 = mag(w0, lane);
    m1 = mag(w1, lane + 32);
    m2 = has2 ? mag(w2, lane + 64) : 0ULL;
    t0 = __ballot_sync(0xffffffffu, m0 != 0ULL);
    t1 = __ballot_sync(0xffffffffu, m1 != 0ULL);
    t2 = __ballot_sync(0xffffffffu, m2 != 0ULL);
  }
  const int t = t2 ? 95 - __clz(t2) : (t1 ? 63 - __clz(t1) : 31 - __clz(t0));
  auto word = [&](int j) -> unsigned long long {  // warp-uniform j >= 0
    const unsigned long long v = j < 32 ? m0 : (j < 64 ? m1 : m2);
    return __shfl_sync(0xffffffffu, v, j & 31);
  };
  const unsigned long long top = word(t);
  const unsigned long long below = t > 0 ? word(t - 1) : 0ULL;
  return round_window(negative, t, l, top, below, offset_bits);
}

}  // namespace exblas
