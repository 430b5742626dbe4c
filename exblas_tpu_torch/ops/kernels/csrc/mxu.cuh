// What the int8 tensor-core kernels share: the balanced signed base-256
// digits of one binary64 value anchored at a given exponent (the ExGEMM
// digit kernel in gemm_mxu.cu, the ExGEMV byte-plane kernel in
// gemv_mxu.cu), the mma.sync int8 product and 32-bit loads of packed int8.
//
// The digits are the port of make_digits
// (exblas_tpu_torch/ops/kernels/gemm_mxu.py): with anchor a, digit u
// (1 <= u <= n_slices) holds bits [a + 1 - 8u, a + 9 - 8u) of the value's
// magnitude recoded into [-128, 127] with the value's sign,
// and digit 0 is the carry in {-1, 0, 1}, so
//   x = sum_{u=0..n_slices} d_u * 2^(a + 1 - 8u)
// exactly when the value's lsb lies within 8 * n_slices bits of the anchor
// (the dispatcher's coverage test).  Zeros and NaN/Inf give zero digits.
#pragma once

#include <cstdint>

#include "deposit.cuh"

namespace exblas {

__device__ __forceinline__ unsigned ld32(const int8_t* p) {
  return __ldg(reinterpret_cast<const unsigned*>(p));
}

// d += a * b on a 16 x 8 tile of int32 sums over k = 32: a is the 16 x 32
// int8 A fragment, (b0, b1) the 32 x 8 int8 B fragment (mma.sync layouts).
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Bits [s, s + 8) of a 53-bit significand; zero outside [-7, 60].
__device__ __forceinline__ int extract8(unsigned long long mant, int s) {
  if (s < 0) return s > -8 ? static_cast<int>((mant << -s) & 0xFFULL) : 0;
  return s < 61 ? static_cast<int>((mant >> s) & 0xFFULL) : 0;
}

// Calls store(u, digit) for u = n_slices, ..., 1 (least significant
// first) and then store(0, carry).  With n_slices known at compile time
// the loop unrolls and a store into a register array stays in registers.
template <typename Store>
__device__ __forceinline__ void balanced_digits(long long bits, int anchor,
                                                int n_slices, Store store) {
  const Decoded d = decode(bits);
  const bool valid = d.expf != 0x7FF && !d.zero;
  const int e_lsb = (d.expf > 1 ? d.expf : 1) - 1075;
  const int sgn = bits < 0 ? -1 : 1;
  int carry = 0;
#pragma unroll
  for (int s = n_slices - 1; s >= 0; --s) {
    const int cut = anchor + 1 - 8 * (s + 1);
    const int byte = valid ? extract8(d.mant, cut - e_lsb) : 0;
    const int t = sgn * byte + carry;           // in [-256, 256]
    const int digit = ((t + 128) & 255) - 128;  // in [-128, 127]
    carry = (t - digit) >> 8;                   // in {-1, 0, 1}
    store(s + 1, digit);
  }
  store(0, carry);
}

}  // namespace exblas
