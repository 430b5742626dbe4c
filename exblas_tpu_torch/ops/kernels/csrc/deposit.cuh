// Deposits shared by the exact kernels: product decoding and digits (B4,
// B6-B10), the grid of the window kernel B11, and the register bins of
// BinWindow, which only the solve B10 uses (B2 and B4 keep warp-owned
// accumulators, warpacc.cuh).
//
// A deposit adds one exact term -- a significand (ExSUM, < 2^73) or a
// product of significands (ExDOT, < 2^125), already shifted left by its
// in-limb offset r < 20 -- at base limb q of a block's int64 accumulator in
// shared memory.  Splitting every term into 20-bit digits and adding each
// with an atomic costs more than the data's own load, so each warp keeps a
// window of kBins consecutive base limbs, one signed 192-bit bin per limb
// per thread, in registers.  A term whose q falls in the window is added
// to its bin whole; one outside goes to shared memory digit by digit.  The
// window is placed at the first valid term of the warp -- for realistic
// exponent ranges every later term then lands in it, the counterpart of the
// TPU kernel's single-window fast path (sum_kernel.py:150-174) -- and is
// split into digits, summed over the warp and deposited once, at the end.
// Integer addition is associative, so where a term is added never changes
// the accumulated integer.  A bin holds at most 2^42 terms below 2^125, so
// 192 bits cannot overflow.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace exblas {

// Threads per block of every deposit kernel.  One geometry serves every
// call: the bits never depend on it, and no other size has been measured.
constexpr int kBlock = 256;

// Blocks of a grid-stride deposit kernel over n elements on the current
// device: enough to fill every SM (2048 resident threads each), and no more
// than one per kBlock elements.
inline cudaError_t deposit_grid(long long n, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  const long long want = (n + kBlock - 1) / kBlock;
  const long long cap = static_cast<long long>(sms) * (2048 / kBlock);
  *grid = static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
  return cudaSuccess;
}

// How a row kernel cuts its work: `units` row units (rows or row tiles) of
// k elements, k processed in steps of `step`.  Small `units` with large k
// split k into *splits spans of *span elements (a multiple of step) so that
// the grid fills every SM (8 resident blocks each); every span but the
// last is whole, and the grid is units * *splits blocks.
inline cudaError_t row_splits(long long units, long long k, long long step,
                              long long* splits, long long* span) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  const long long steps = k > 0 ? (k + step - 1) / step : 1;
  long long s = (static_cast<long long>(sms) * 8 + units - 1) / units;
  if (s > steps) s = steps;
  if (s < 1) s = 1;
  *span = (steps + s - 1) / s * step;
  *splits = k > 0 ? (k + *span - 1) / *span : 1;
  if (units * *splits > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  return cudaSuccess;
}

// DOT_FORMAT: 216 limbs of 20 bits, bit 0 at 2^-2148; a 106-bit product
// shifted by r < 20 spans 7 digits.
constexpr int kDotLimbs = 216;
constexpr int kDotOffset = 2148;
constexpr int kDigits = 7;

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kBins = 4;
// Digits of a flushed bin: its magnitude is below 2^(125 + 42) < 2^180.
constexpr int kFlushDigits = 9;

// Sum of a 64-bit value over the 32 lanes of a warp (exact integer adds).
__device__ __forceinline__ long long warp_sum(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// Bits [20t, 20t + 20) of the little-endian words w (t static).
template <int NW>
__device__ __forceinline__ long long digit_at(
    const unsigned long long (&w)[NW], int t) {
  const int lo = 20 * t;
  const int word = lo / 64;
  const int shift = lo % 64;
  unsigned long long v = word < NW ? w[word] >> shift : 0ULL;
  if (shift > 44 && word + 1 < NW) v |= w[word + 1] << (64 - shift);
  return static_cast<long long>(v & 0xFFFFFULL);
}

// Adds the ND digits of +-(m1:m0) to limbs q.. of s_acc, one atomic each.
template <int ND>
__device__ __forceinline__ void deposit_digits(unsigned long long* s_acc,
                                               int q, unsigned long long m0,
                                               unsigned long long m1,
                                               bool negative) {
  const unsigned long long w[2] = {m0, m1};
#pragma unroll
  for (int t = 0; t < ND; ++t) {
    const long long d = digit_at<2>(w, t);
    if (d != 0) {
      atomicAdd(&s_acc[q + t],
                static_cast<unsigned long long>(negative ? -d : d));
    }
  }
}

// A signed 192-bit integer, two's complement, little-endian words.
struct Int192 {
  unsigned long long w[3];
};

// a += b, both 192-bit two's complement.
__device__ __forceinline__ void add192(Int192& a, unsigned long long b0,
                                       unsigned long long b1,
                                       unsigned long long b2) {
  a.w[0] += b0;
  const unsigned long long c0 = a.w[0] < b0 ? 1ULL : 0ULL;
  const unsigned long long s1 = b1 + c0;
  const unsigned long long c1 = s1 < c0 ? 1ULL : 0ULL;
  a.w[1] += s1;
  a.w[2] += b2 + c1 + (a.w[1] < s1 ? 1ULL : 0ULL);
}

// ND: digits of one term (4 for ExSUM, 7 for ExDOT).
template <int ND>
struct BinWindow {
  Int192 bin[kBins];
  int base;  // limb of bin[0], the same in every lane of a warp; -1: unset

  __device__ __forceinline__ BinWindow() : base(-1) {
#pragma unroll
    for (int b = 0; b < kBins; ++b) {
      bin[b].w[0] = 0ULL;
      bin[b].w[1] = 0ULL;
      bin[b].w[2] = 0ULL;
    }
  }

  // All 32 lanes of the warp must call.  Adds +-(m1:m0) at limb q.
  __device__ __forceinline__ void add(bool valid, int q, unsigned long long m0,
                                      unsigned long long m1, bool negative,
                                      unsigned long long* s_acc) {
    if (base < 0) {  // warp-uniform
      const unsigned mask = __ballot_sync(kFullMask, valid);
      if (mask == 0u) return;
      const int q0 = __shfl_sync(kFullMask, q, __ffs(mask) - 1);
      base = q0 > 0 ? q0 - 1 : 0;
    }
    if (!valid) return;
    const int off = q - base;
    if (off < 0 || off >= kBins) {
      deposit_digits<ND>(s_acc, q, m0, m1, negative);
      return;
    }
    // -m = ~m + 1 over 192 bits.
    unsigned long long b0 = m0, b1 = m1, b2 = 0ULL;
    if (negative) {
      b0 = ~m0 + 1ULL;
      b1 = ~m1 + (m0 == 0ULL ? 1ULL : 0ULL);
      b2 = (m0 == 0ULL && m1 == 0ULL) ? 0ULL : ~0ULL;
    }
#pragma unroll
    for (int b = 0; b < kBins; ++b) {
      if (off == b) add192(bin[b], b0, b1, b2);
    }
  }

  // All 32 lanes of the warp must call, once, at the end.
  __device__ __forceinline__ void flush(unsigned long long* s_acc) const {
    if (base < 0) return;  // warp-uniform: the warp saw no valid term
#pragma unroll
    for (int b = 0; b < kBins; ++b) {
      const bool negative = static_cast<long long>(bin[b].w[2]) < 0;
      unsigned long long m[3] = {bin[b].w[0], bin[b].w[1], bin[b].w[2]};
      if (negative) {  // magnitude: ~v + 1
        m[0] = ~m[0] + 1ULL;
        const unsigned long long c0 = m[0] == 0ULL ? 1ULL : 0ULL;
        m[1] = ~m[1] + c0;
        m[2] = ~m[2] + ((c0 != 0ULL && m[1] == 0ULL) ? 1ULL : 0ULL);
      }
#pragma unroll
      for (int t = 0; t < kFlushDigits; ++t) {
        const long long d = digit_at<3>(m, t);
        const long long v = warp_sum(negative ? -d : d);
        if ((threadIdx.x & 31) == 0 && v != 0) {
          atomicAdd(&s_acc[base + b + t], static_cast<unsigned long long>(v));
        }
      }
    }
  }
};

// The fields of one binary64 pattern.
struct Decoded {
  int expf;
  unsigned long long mant;  // significand with the implicit bit
  bool zero, inf, nan;
};

__device__ __forceinline__ Decoded decode(long long b) {
  Decoded d;
  d.expf = static_cast<int>((b >> 52) & 0x7FF);
  const unsigned long long frac =
      static_cast<unsigned long long>(b) & ((1ULL << 52) - 1ULL);
  d.mant = (d.expf != 0 && d.expf != 0x7FF) ? (frac | (1ULL << 52)) : frac;
  d.zero = d.expf == 0 && frac == 0ULL;
  d.inf = d.expf == 0x7FF && frac == 0ULL;
  d.nan = d.expf == 0x7FF && frac != 0ULL;
  return d;
}

// Decode one product a*b (int64 bits of each) into its base limb q and the
// exact product of the significands shifted left by r = p % 20,
// (hi:lo) < 2^125, to be added at limb q with the product's sign
// (*negative).  Bit p of the accumulator has exponent p - offset_bits, and
// p >= 0 must hold for every finite nonzero product (DOT_FORMAT's 2148
// guarantees it).  NaN/+Inf/-Inf products are counted and, like zero
// products, deposit nothing (valid == false).
__device__ __forceinline__ bool decode_product(
    long long ba, long long bb, int offset_bits, int& q,
    unsigned long long& lo, unsigned long long& hi, bool& negative,
    long long& nan_c, long long& pinf_c, long long& ninf_c) {
  const Decoded da = decode(ba);
  const Decoded db = decode(bb);
  negative = (ba ^ bb) < 0;
  if (da.nan || db.nan || (da.inf && db.zero) || (db.inf && da.zero)) {
    ++nan_c;
  } else if (da.inf || db.inf) {
    if (negative) {
      ++ninf_c;
    } else {
      ++pinf_c;
    }
  }
  // Product LSB bit position p = Ea + Eb + offset_bits, E = max(expf,1)-1075.
  int p = (da.expf > 1 ? da.expf : 1) + (db.expf > 1 ? db.expf : 1) -
          2 * 1075 + offset_bits;
  const bool valid = da.expf != 0x7FF && db.expf != 0x7FF && !da.zero &&
                     !db.zero && p >= 0;
  const unsigned long long ma = valid ? da.mant : 0ULL;
  const unsigned long long mb = valid ? db.mant : 0ULL;
  p = valid ? p : 0;
  q = p / 20;
  const int r = p - q * 20;
  // Exact 106-bit product, shifted left by r < 20: hi < 2^61.
  lo = ma * mb;
  hi = __umul64hi(ma, mb);
  if (r != 0) {
    hi = (hi << r) | (lo >> (64 - r));
    lo <<= r;
  }
  return valid;
}

// Adds the ND digits of +-(m1:m0) to limbs q.. of a thread's own
// accumulator of L limbs, limb j at limbs[j * stride] (no atomics); digits
// outside [0, L) are dropped, which callers rule out by their range checks.
// Limb is int64, or int32 where the caller bounds the digits a limb takes.
template <int ND, typename Limb>
__device__ __forceinline__ void add_digits(Limb* limbs, int L, int q,
                                           unsigned long long m0,
                                           unsigned long long m1,
                                           bool negative, int stride = 1) {
  const unsigned long long w[2] = {m0, m1};
#pragma unroll
  for (int t = 0; t < ND; ++t) {
    const long long d = digit_at<2>(w, t);
    if (d != 0 && q + t >= 0 && q + t < L) {
      limbs[(q + t) * stride] += static_cast<Limb>(negative ? -d : d);
    }
  }
}

// Adds the per-thread special counts of a block to s_acc[L..L+2].
__device__ __forceinline__ void deposit_specials(unsigned long long* s_acc,
                                                 int L, long long nan_c,
                                                 long long pinf_c,
                                                 long long ninf_c) {
  nan_c = warp_sum(nan_c);
  pinf_c = warp_sum(pinf_c);
  ninf_c = warp_sum(ninf_c);
  if ((threadIdx.x & 31) == 0 && (nan_c | pinf_c | ninf_c) != 0LL) {
    atomicAdd(&s_acc[L], static_cast<unsigned long long>(nan_c));
    atomicAdd(&s_acc[L + 1], static_cast<unsigned long long>(pinf_c));
    atomicAdd(&s_acc[L + 2], static_cast<unsigned long long>(ninf_c));
  }
}

}  // namespace exblas
