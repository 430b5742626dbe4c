// Correctly rounded conversion of one int64 superaccumulator to binary64
// bits, on the device.
//
// Replaces exblas_tpu/ops/kernels/round_in_kernel.py::round_lanes_acc (the
// in-kernel rounding inside exsum_bits_pallas and exdot_bits_pallas).  The
// TPU version rounds 128 lane accumulators at once in uint32 word pairs and
// finds the leading limb without gathers; on Hopper one thread walks the
// range of nonzero merged int64 limbs held in shared memory, with native
// 64-bit integers (finish, round_limbs).
//
// Steps (all in integers: a native fp64 add cannot round a ~2100-bit value
// once):
//   1. canonicalize: sequential carry, digits in [0, 2^20); the sign is the
//      final carry (-1 or 0 within the format's headroom);
//   2. negate (two's complement in base 2^20) if the value is negative;
//   3. find the leading digit and the leading bit p_msb;
//   4. take the 55-bit window [p_msb - 54, p_msb] plus a sticky bit;
//   5. round to nearest even, with subnormals and overflow to +-Inf;
//      an all-zero accumulator is +0.0;
//   6. specials, in the order of exblas_tpu/core/rounding.py:341-346:
//      -Inf, then +Inf, then NaN (any NaN, or both infinities), where NaN is
//      the canonical 0x7FF8000000000000.
#pragma once

#include <cstdint>

namespace exblas {

constexpr int kLimbBits = 20;
constexpr long long kLimbMask = (1LL << kLimbBits) - 1;
constexpr unsigned long long kQNanBits = 0x7FF8000000000000ULL;
constexpr unsigned long long kPInfBits = 0x7FF0000000000000ULL;
constexpr unsigned long long kNInfBits = 0xFFF0000000000000ULL;
constexpr unsigned long long kSignBit = 0x8000000000000000ULL;

// Round m55 * 2^(e_msb - 54) (bit 54 of m55 set) plus a sticky tail below
// to binary64, round to nearest even.  Port of core/rounding.py's
// ieee_encode_round.
__device__ __forceinline__ unsigned long long encode_round(
    bool negative, int e_msb, unsigned long long m55, bool sticky_below) {
  const bool subn = e_msb < -1022;
  const int d = subn ? (-1022 - e_msb) : 0;
  const int c = d + 2 > 63 ? 63 : d + 2;
  unsigned long long m53 = m55 >> c;
  unsigned long long guard = (m55 >> (c - 1)) & 1ULL;
  bool sticky = sticky_below || (m55 & ((1ULL << (c - 1)) - 1ULL)) != 0ULL;
  if (d >= 60) {  // deep underflow: everything dropped
    m53 = 0ULL;
    guard = 0ULL;
    sticky = true;
  }
  const bool round_up = guard != 0ULL && (sticky || (m53 & 1ULL) != 0ULL);
  unsigned long long m = m53 + (round_up ? 1ULL : 0ULL);
  int e = e_msb;
  if (!subn && m == (1ULL << 53)) {  // mantissa overflow on round-up
    m = 1ULL << 52;
    e += 1;
  }
  // A subnormal that rounded up to 2^52 becomes the smallest normal.
  const unsigned long long expf =
      subn ? ((m >> 52) & 1ULL) : static_cast<unsigned long long>(e + 1023);
  unsigned long long bits = (expf << 52) | (m & ((1ULL << 52) - 1ULL));
  if (!subn && e + 1023 >= 2047) bits = kPInfBits;
  return negative ? (bits | kSignBit) : bits;
}

// Round the exact value sum_j limbs[j] * 2^(20 j) of a thread's own limbs
// to binary64 bits; bit p has exponent p - offset_bits.  Limb j lives at
// limbs[j * stride] (int64, or int32 when every limb and digit fits).
// Limbs outside [jlo, jhi] must be zero (jhi < jlo: the value is zero), so
// only that range and one limb above it are canonicalized, in place: past
// the last nonzero limb the carry is 0 or -1, and the digits above are 0 or
// all ones.  The same steps as round_digits; an exact zero is +0.0.  Shared
// by the GEMM, GEMV and TRSV kernels, one element per call.
template <typename Limb>
__device__ __forceinline__ unsigned long long round_limbs(Limb* limbs, int jlo,
                                                          int jhi, int L,
                                                          int offset_bits,
                                                          int stride = 1) {
  if (jhi < jlo) return 0ULL;
  const int jtop = jhi + 1 < L ? jhi + 1 : L - 1;
  long long carry = 0;
  for (int j = jlo; j <= jtop; ++j) {
    const long long d = static_cast<long long>(limbs[j * stride]) + carry;
    const long long digit = d & kLimbMask;
    limbs[j * stride] = static_cast<Limb>(digit);
    carry = (d - digit) >> kLimbBits;
  }
  const bool negative = carry < 0;
  if (negative) {  // digits below jlo are 0, so the borrow starts at jlo
    long long borrow = 1;
    for (int j = jlo; j <= jtop; ++j) {
      const long long t =
          (static_cast<long long>(limbs[j * stride]) ^ kLimbMask) + borrow;
      limbs[j * stride] = static_cast<Limb>(t & kLimbMask);
      borrow = t >> kLimbBits;
    }
  }
  int jstar = jtop;
  while (jstar >= jlo && limbs[jstar * stride] == 0) --jstar;
  if (jstar < jlo) return 0ULL;
  const int p_msb =
      jstar * kLimbBits +
      (63 - __clzll(static_cast<long long>(limbs[jstar * stride])));
  const int pos_low = p_msb - 54;
  const int j0 = (pos_low + 60) / kLimbBits - 3;  // floor(pos_low / 20)
  unsigned long long m55 = 0ULL;
  bool sticky = false;
  for (int j = jlo; j < j0; ++j) sticky = sticky || limbs[j * stride] != 0;
  for (int j = j0 < jlo ? jlo : j0; j <= jstar; ++j) {
    const unsigned long long d =
        static_cast<unsigned long long>(limbs[j * stride]);
    const int s = kLimbBits * j - pos_low;  // this digit's lsb in the window
    if (s >= 0) {
      m55 |= d << s;
    } else {
      m55 |= d >> (-s);
      sticky = sticky || (d & ((1ULL << (-s)) - 1ULL)) != 0ULL;
    }
  }
  return encode_round(negative, p_msb - offset_bits,
                      m55 & ((1ULL << 55) - 1ULL), sticky);
}

// limbs += v * 2^p for a signed |v| < 2^43 and p >= 0: three pieces at
// limbs q, q+1, q+2 (q = p / 20), the top one signed.  The caller's L
// must exceed q + 2.
__device__ __forceinline__ void add_scaled(long long* limbs, long long v,
                                           int p) {
  const int q = p / kLimbBits;
  const long long w = v * (1LL << (p - q * kLimbBits));  // |w| < 2^62
  limbs[q] += w & kLimbMask;
  limbs[q + 1] += (w >> kLimbBits) & kLimbMask;
  limbs[q + 2] += w >> (2 * kLimbBits);
}

// Kernel B3's body: the correctly rounded binary64 bits of
// sum_t vals[t] * 2^(pos[t] + e) for t < T int64 terms of any size, with
// pos[t] >= 0.  Each term's 32-bit halves go through add_scaled into nl
// zeroed limbs (nl > (max pos + 72) / 20 + 1 holds 128 terms of 2^63 and
// the sign), then round_limbs rounds them once (an exact zero is +0.0).
// `pos` is anything indexable: B3's int array, or FramePos for the last
// blocks of the window kernels B11 and B12, which run this same rounding.
template <typename Pos>
__device__ __forceinline__ unsigned long long round_scaled_terms(
    const long long* vals, Pos pos, int t, long long* limbs, int nl, int e) {
  for (int l = 0; l < nl; ++l) limbs[l] = 0;
  for (int i = 0; i < t; ++i) {
    const long long v = vals[i];
    add_scaled(limbs, v & 0xFFFFFFFFLL, pos[i]);  // below 2^32
    add_scaled(limbs, v >> 32, pos[i] + 32);       // |v >> 32| <= 2^31
  }
  return round_limbs(limbs, 0, nl - 1, nl, -e);
}

// The positions of an anchored window's terms: term k at bit 32 k.
struct FramePos {
  __device__ __forceinline__ int operator[](int k) const { return 32 * k; }
};

// Limbs round_scaled_terms needs for t terms at FramePos
// (term_limbs_count in round_in_kernel.py: (max pos + 72) / 20 + 2).
__host__ __device__ constexpr int frame_limbs(int t) {
  return (32 * (t - 1) + 72) / kLimbBits + 2;
}

// The end of the anchored window kernels B11 and B12, run by one thread
// of the last block: carries T sums (sum k at frame bit 32 k, each at
// most 2^63 - 2^31 in magnitude, so that a carry below 2^31 cannot
// overflow) in place into canonical terms -- terms 0..T-2 in
// [0, 2^32), the last the value >> 32 (T - 1), floor -- and writes them to
// out[0..T-1] and the value rounded once, frame bit 0 at 2^e, to out[T +
// 1] (out[T] is the caller's flag).  limbs: frame_limbs(T) int64 of
// scratch.  The canonical terms are the exact value's digits, so neither
// they nor the bits depend on how the grid split the sums.
template <int T>
__device__ __forceinline__ void finish_frame(long long* terms,
                                             long long* limbs, int e,
                                             long long* out) {
  long long carry = 0;
#pragma unroll
  for (int k = 0; k < T - 1; ++k) {
    const long long t = terms[k] + carry;
    terms[k] = t & 0xFFFFFFFFLL;
    carry = t >> 32;
    out[k] = terms[k];
  }
  terms[T - 1] += carry;
  out[T - 1] = terms[T - 1];
  out[T + 1] = static_cast<long long>(
      round_scaled_terms(terms, FramePos{}, T, limbs, frame_limbs(T), e));
}

__device__ __forceinline__ unsigned long long apply_specials(
    unsigned long long bits, long long nan_c, long long pinf_c,
    long long ninf_c) {
  if (ninf_c > 0) bits = kNInfBits;
  if (pinf_c > 0) bits = kPInfBits;
  if (nan_c > 0 || (pinf_c > 0 && ninf_c > 0)) bits = kQNanBits;
  return bits;
}

// The finishing step shared by the sum and dot kernels, run by every thread
// of one block: sum holds L int64 limbs (|limb| < 2^63) and then the NaN,
// +Inf and -Inf counts, in shared memory, and is modified.  With bits_out
// set it writes the correctly rounded binary64 bits; otherwise the
// canonical int32 limbs (digits in [0, 2^20), the final carry folded into
// the top limb) and the int32 counts.  One thread carries only the range of
// nonzero limbs: below the lowest the digits are 0, and a carry out of the
// highest, jhi, is below 2^43, 2^23 and 2^3 at limbs jhi + 1, + 2 and + 3,
// and 0 or -1 from there on, so the digits above jhi + 3 are 0 or all
// ones -- the digits of one sequential carry over all L limbs.
template <int L>
__device__ __forceinline__ void finish(long long* sum, int offset_bits,
                                       int* limbs_out, int* special_out,
                                       unsigned long long* bits_out) {
  __shared__ int s_lo, s_hi;
  __shared__ long long s_carry;
  if (threadIdx.x == 0) {
    s_lo = L;
    s_hi = -1;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    if (sum[j] != 0LL) {
      atomicMin(&s_lo, j);
      atomicMax(&s_hi, j);
    }
  }
  __syncthreads();
  const int jlo = s_lo, jhi = s_hi;
  const int jtop = jhi + 3 < L - 1 ? jhi + 3 : L - 1;
  if (bits_out != nullptr) {
    if (threadIdx.x == 0) {
      // round_limbs canonicalizes up to one limb above the range it is given
      const unsigned long long bits =
          round_limbs(sum, jlo, jtop - 1 > jhi ? jtop - 1 : jhi, L,
                      offset_bits);
      *bits_out = apply_specials(bits, sum[L], sum[L + 1], sum[L + 2]);
    }
    return;
  }
  if (threadIdx.x == 0) {
    long long carry = 0;
    for (int j = jlo; j <= jtop; ++j) {
      const long long d = sum[j] + carry;
      const long long digit = d & kLimbMask;
      sum[j] = digit;
      carry = (d - digit) >> kLimbBits;
    }
    s_carry = carry;
  }
  __syncthreads();
  const long long carry = s_carry;
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    long long d = 0LL;  // below jlo
    if (j >= jlo) d = j <= jtop ? sum[j] : (carry < 0 ? kLimbMask : 0LL);
    if (j == L - 1) d += carry * (1LL << kLimbBits);
    limbs_out[j] = static_cast<int>(d);
  }
  if (threadIdx.x < 3) {
    special_out[threadIdx.x] = static_cast<int>(sum[L + threadIdx.x]);
  }
}

}  // namespace exblas
