// What the int8 tensor-core kernels share: the balanced signed base-256
// digits of one binary64 value anchored at a given exponent (the ExGEMM
// digit kernel in gemm_mxu.cu, the ExGEMV byte-plane kernel in
// gemv_mxu.cu), the mma.sync int8 product, 32-bit loads of packed int8,
// and the Hopper pieces of the rung (8, 8) GEMM kernel: mbarriers, TMA
// tensor loads and wgmma.
//
// The digits are those of make_digits
// (exblas_tpu_torch/ops/kernels/gemm_mxu.py): with anchor a, digit u
// (1 <= u <= n_slices) has weight 2^(a + 1 - 8u) and lies in [-128, 127],
// digit 0 is the carry in {-1, 0, 1}, and
//   x = sum_{u=0..n_slices} d_u * 2^(a + 1 - 8u)
// exactly when the value's lsb lies within 8 * n_slices bits of the anchor
// (the dispatcher's coverage test).  Zeros and NaN/Inf give zero digits.
//
// The excess-128 recode.  Let V = x / 2^(a + 1 - 8 ns) be the element's
// window integer (ns = n_slices; an integer for a covered element) and
// W = V + sum_{u=1..ns} 128 * 256^(ns - u).  Byte j of W XOR 0x80 is
// digit ns - j as an int8, and W >> 8 ns is the carry digit: balanced
// digits in [-128, 127] are unique, so these are make_digits' digits.  An
// element below the window (lsb under its lowest weight: never sent by the
// dispatcher) has V truncated toward zero, as make_digits drops its bits.
// The arithmetic runs on a frame of at most 15 bytes at the byte b0 where
// the significand's lowest bit lands: the bytes below are 0x80 (digit 0),
// and above the frame every byte is 0x80 too, so the cost does not grow
// with the rung.  At ns = 8, the main path's rung, the frame is the whole
// 64-bit window, and V comes from two exact float64 scalings and one
// conversion (excess8).
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

constexpr unsigned long long kExcess = 0x8080808080808080ULL;
constexpr unsigned long long kFracMask = (1ULL << 52) - 1ULL;

// The significand of a finite element (0 for zeros, NaN and Inf) and
// its shift into the window, sh = max(expf, 1) + off.
__device__ __forceinline__ unsigned long long significand(long long bits,
                                                          int off, int& sh) {
  const int expf = static_cast<int>((bits >> 52) & 0x7FF);
  unsigned long long mant = static_cast<unsigned long long>(bits) & kFracMask;
  if (expf != 0) mant |= 1ULL << 52;
  sh = (expf > 1 ? expf : 1) + off;
  return expf == 0x7FF ? 0ULL : mant;
}

// The shift of an element's significand into the window of rung ns at
// anchor a: sh = max(expf, 1) + window_offset(a, ns).
__host__ __device__ __forceinline__ int window_offset(int anchor, int ns) {
  return 8 * ns - 1076 - anchor;
}

// ns = 8: |V| = |x| * 2^(63 - a) is below 2^64, and scaling by a power
// of two is exact while the product is normal: |x| * s2 * s1 with
// s1 = 2^min(63 - a, 1023), s2 = 2^max(63 - a - 1023, 0) (window_scales8)
// is exact down to 1, and converting it toward zero to an unsigned 64-bit
// integer truncates exactly as make_digits does.
__device__ __forceinline__ void window_scales8(int anchor, double& s1,
                                               double& s2) {
  const int k = 63 - anchor;
  s1 = __longlong_as_double(static_cast<long long>((k < 1023 ? k : 1023) +
                                                   1023) << 52);
  s2 = __longlong_as_double(static_cast<long long>((k > 1023 ? k - 1023 : 0) +
                                                   1023) << 52);
}

// ns = 8: digit 8 - j is byte j of the result (as int8), *carry the carry
// digit; (s1, s2) from window_scales8 of the element's anchor.
__device__ __forceinline__ unsigned long long excess8(long long bits,
                                                      double s1, double s2,
                                                      int& carry) {
  const bool special = ((bits >> 52) & 0x7FF) == 0x7FF;
  const double ax = __longlong_as_double(bits & 0x7FFFFFFFFFFFFFFFLL);
  const unsigned long long f =
      special ? 0ULL : __double2ull_rz(__dmul_rn(__dmul_rn(ax, s2), s1));
  const bool neg = bits < 0;
  const unsigned long long w = neg ? kExcess - f : kExcess + f;
  carry = neg ? -static_cast<int>(f > kExcess) : static_cast<int>(w < f);
  return w ^ kExcess;
}

// Any ns: W over the frame of nb <= 15 bytes at byte b0 (lo: bytes 0-7,
// hi: 8-14 and the sign above).
struct ExcessFrame {
  unsigned long long lo, hi;
  int b0, nb;
};

__device__ __forceinline__ ExcessFrame excess_frame(long long bits, int off,
                                                    int ns) {
  int sh;
  unsigned long long f = significand(bits, off, sh);
  int b0 = 0;
  if (sh >= 0) {
    b0 = sh >> 3;
    f <<= sh & 7;
  } else {
    f = sh > -64 ? f >> -sh : 0ULL;
  }
  if (b0 >= ns) {  // above the window: never covered
    f = 0ULL;
    b0 = 0;
  }
  ExcessFrame e;
  e.b0 = b0;
  e.nb = ns - b0 < 15 ? ns - b0 : 15;
  const unsigned long long clo = e.nb >= 8 ? kExcess
                                           : kExcess >> (64 - 8 * e.nb);
  const unsigned long long chi = e.nb > 8 ? kExcess >> (128 - 8 * e.nb)
                                          : 0ULL;
  if (bits < 0) {
    e.lo = clo - f;
    e.hi = chi - (f > clo ? 1ULL : 0ULL);
  } else {
    e.lo = clo + f;
    e.hi = chi + (e.lo < f ? 1ULL : 0ULL);
  }
  return e;
}

// Digit u (0 <= u <= ns) of the element whose frame is e.
__device__ __forceinline__ int excess_digit(const ExcessFrame& e, int ns,
                                            int u) {
  if (u == 0) {  // W >> 8 ns, where the frame reaches byte ns
    if (e.b0 + e.nb < ns) return 0;
    return static_cast<int>(
        e.nb >= 8 ? static_cast<long long>(e.hi) >> (8 * e.nb - 64)
                  : static_cast<long long>(e.lo) >> (8 * e.nb));
  }
  const int i = ns - u - e.b0;
  if (i < 0 || i >= e.nb) return 0;
  const unsigned long long w = i < 8 ? e.lo >> (8 * i) : e.hi >> (8 * i - 64);
  return static_cast<int>(static_cast<signed char>((w & 0xFFULL) ^ 0x80ULL));
}

// Byte j of four 32-bit words, packed: w[j] = {x0.bj, x1.bj, x2.bj, x3.bj}.
__device__ __forceinline__ void transpose4(unsigned x0, unsigned x1,
                                           unsigned x2, unsigned x3,
                                           unsigned (&w)[4]) {
  const unsigned t0 = __byte_perm(x0, x1, 0x5140);
  const unsigned t1 = __byte_perm(x2, x3, 0x5140);
  const unsigned t2 = __byte_perm(x0, x1, 0x7362);
  const unsigned t3 = __byte_perm(x2, x3, 0x7362);
  w[0] = __byte_perm(t0, t1, 0x5410);
  w[1] = __byte_perm(t0, t1, 0x7632);
  w[2] = __byte_perm(t2, t3, 0x5410);
  w[3] = __byte_perm(t2, t3, 0x7632);
}

// The nine digit words of four consecutive elements at ns = 8:
// plane[u] holds digit u of each element in its byte (element e in byte e).
__device__ __forceinline__ void pack_digits8(const unsigned long long (&x)[4],
                                             const int (&carry)[4],
                                             unsigned (&plane)[9]) {
  unsigned lo[4], hi[4];
  transpose4(static_cast<unsigned>(x[0]), static_cast<unsigned>(x[1]),
             static_cast<unsigned>(x[2]), static_cast<unsigned>(x[3]), lo);
  transpose4(static_cast<unsigned>(x[0] >> 32),
             static_cast<unsigned>(x[1] >> 32),
             static_cast<unsigned>(x[2] >> 32),
             static_cast<unsigned>(x[3] >> 32), hi);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    plane[8 - j] = lo[j];
    plane[4 - j] = hi[j];
  }
  plane[0] = __byte_perm(__byte_perm(carry[0], carry[1], 0x0040),
                         __byte_perm(carry[2], carry[3], 0x0040), 0x5410);
}

// ---------------------------------------------------------------------------
// Hopper: mbarriers, TMA tensor loads, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0u;
}

// Waits until the phase of parity `parity` has completed.  A wait that
// outlasts about two seconds traps (a launch failure the wrapper reports)
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity)) {
    if (clock64() - t0 > (1LL << 32)) __trap();
  }
}

// A 3-D TMA tile load of `map` at coordinates (c0, c1, c2) into dst,
// completing on `bar`'s transaction count.
__device__ __forceinline__ void tma_load_3d(void* dst, const void* map,
                                            unsigned long long* bar, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(smem_u32(bar)),
      "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<unsigned long long>(map))
               : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy (TMA, wgmma) accesses.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The wgmma descriptor of a K-major int8 tile of 32-byte rows in the
// 32-byte swizzle (as TMA's CU_TENSOR_MAP_SWIZZLE_32B writes it): 8-row
// groups 256 bytes apart (SBO), LBO unused (1), layout type 3.
__device__ __forceinline__ unsigned long long wgmma_desc_sw32(unsigned addr) {
  return static_cast<unsigned long long>((addr & 0x3FFFF) >> 4) |
         (1ULL << 16) | (16ULL << 32) | (3ULL << 62);
}

// d (64 x N int32, N / 2 registers a thread) += A (64 x 32 int8, shared,
// descriptor da) * B^T (N x 32 int8, shared, descriptor db), for the
// widths the rung (8, 8) kernel's class windows take.
template <int N>
__device__ __forceinline__ void wgmma_s8(int* d, unsigned long long da,
                                         unsigned long long db);

template <>
__device__ __forceinline__ void wgmma_s8<48>(int* d, unsigned long long da,
                                              unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int* d, unsigned long long da,
                                              unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<80>(int* d, unsigned long long da,
                                              unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<96>(int* d, unsigned long long da,
                                              unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<112>(int* d, unsigned long long da,
                                               unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, %56, %57, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int* d, unsigned long long da,
                                               unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<144>(int* d, unsigned long long da,
                                               unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71"
      "}, %72, %73, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71])
      : "l"(da), "l"(db), "r"(1));
}
}  // namespace exblas
