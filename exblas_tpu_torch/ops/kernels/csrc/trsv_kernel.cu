// Exact lower-triangular solve T x = b on Hopper (ExTRSV), any data: each
// row i carries an exact DOT_FORMAT superaccumulator seeded with b_i;
// x_i = Round(acc_i), divided by t_ii unless the diagonal is unit (one
// correctly rounded __ddiv_rn, every NaN made 0x7FF8000000000000); the
// exact 106-bit products -t_ji * x_i are deposited into the rows j > i.
// Only the lower triangle is read, and for a unit diagonal not the
// diagonal either.
//
// Replaces exblas_tpu/ops/kernels/trsv_kernel.py: trsv_lower_x_pallas
// (_trsv_kernel).  That kernel relied on its grid running in order on one
// core and carried x from grid step to grid step in VMEM; its lanes,
// 8 phase sub-accumulators and _renorm8 passes served the TPU's int32
// vector unit.  Hopper runs blocks in no order, so here the order lives in
// the host loop of the C entry, which walks the row blocks of height B
// (128 by default; 1..256) on one stream, left-looking.  For block kb:
//   1. panel: B7's row kernel (gemv_kernel.cu) deposits
//      -T[rows kb, cols < kb*B] . x[< kb*B] into the B rows' int64
//      accumulators in the JAX layout, reading T in place (row stride n)
//      and negating x by its sign bit -- exactly the products of the
//      negated T the JAX package deposits, with +-Inf counts swapped as
//      they should be.  row_splits spreads k over blocks, so B rows still
//      fill the card;
//   2. diagonal block: one thread block of B threads solves the B rows in
//      B steps.  Thread j owns row j: it seeds b_j (the exact product
//      b_j * 1.0), carries its row into digits, and keeps it in shared
//      memory as int32 limbs with its live limb range and special counts
//      in registers.  At step i thread i rounds its own row over that range
//      (round.cuh round_limbs) and applies the specials, divides, and
//      publishes x_i in shared memory; after one barrier every thread j > i
//      adds the exact product -t_ji * x_i to its own row (deposit.cuh
//      decode_product, add_digits): no atomics, one barrier a step.
// Every strictly-lower product is deposited, zeros included, so 0 * Inf
// counts as NaN as in exblas_tpu/core/deposit.py.  The bits never depend on
// B: every deposit is an exact integer.
//
// Shared memory: 216 int64 limbs for 128 rows would be 221,184 bytes, all a
// block may have.  After the carry pass a limb holds a digit below 2^20
// (the top one -1), and each of at most B - 1 < 2^8 in-block deposits adds
// one digit below 2^20, so every limb stays below 2^28 and int32 limbs
// suffice: 110,592 bytes at B = 128, laid out [limb][row] so that the
// threads of a warp always touch 32 distinct banks.  T's diagonal block
// stays in device memory (L2); each thread loads its t_ji a step ahead.
//
// Bound on the H100: bytes.  The lower triangle read once, n(n+1)/2 * 8
// bytes: 268.5 MB at n = 8192, 0.080 ms at 3.35 TB/s; the integer work of
// the 33.6 M exact products (about 11 int32 operations each) is 0.022 ms.
// The roofline does not see the chain of n dependent steps (round, divide,
// publish, deposit) that no order of work can shorten: here it runs on one
// SM per row block, B steps per launch, and it -- not the panel's bytes --
// sets the time.  A persistent wavefront that overlaps block kb's
// diagonal solve with the panels of the blocks below is the next step.
#include <cuda_runtime.h>

#include <cstdint>

#include "deposit.cuh"
#include "round.cuh"

extern "C" int gemv_rows_acc_cuda(const void* a, const void* z, long long m,
                                  long long k, long long lda, int negate_z,
                                  void* limbs, void* special, void* stream);

namespace {

using exblas::kDigits;
using exblas::kDotLimbs;
using exblas::kDotOffset;

constexpr int kMaxBlock = 256;
constexpr long long kOneBits = 0x3FF0000000000000LL;  // 1.0
constexpr long long kSign = static_cast<long long>(exblas::kSignBit);
// The C entry's parts: the panels, the diagonal blocks, or both.
constexpr int kPanel = 1;
constexpr int kDiag = 2;

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// Solves rows [base, base + rows) of T x = b given their accumulators acc
// (rows, 216) and counts special (rows, 3), which the panel filled; leaves
// both zeroed for the next block.  blockDim.x = B >= rows threads.
__global__ void __launch_bounds__(kMaxBlock)
    trsv_diag_kernel(const long long* __restrict__ t, long long n,
                     const long long* __restrict__ b, int unit,
                     long long base, int rows, long long* __restrict__ acc,
                     long long* __restrict__ special,
                     long long* __restrict__ x) {
  extern __shared__ int s_limbs[];  // limb l of row j at s_limbs[l * B + j]
  __shared__ long long s_x[kMaxBlock];
  const int j = threadIdx.x;
  const int B = blockDim.x;
  const bool live = j < rows;
  const long long row = base + j;
  int* my = s_limbs + j;
  long long nan_c = 0, pinf_c = 0, ninf_c = 0;
  int jlo = kDotLimbs, jhi = -1;  // live limb range of the row
  long long t_ii = 0, t_next = 0;

  if (live) {
    long long* ar = acc + static_cast<long long>(j) * kDotLimbs;
    long long* sp = special + static_cast<long long>(j) * 3;
    int q;
    unsigned long long lo, hi;
    bool negative;
    // b_j, seeded as the exact product b_j * 1.0 (NaN/Inf counted alike)
    if (exblas::decode_product(b[row], kOneBits, kDotOffset, q, lo, hi,
                               negative, nan_c, pinf_c, ninf_c)) {
      exblas::add_digits<kDigits>(ar, kDotLimbs, q, lo, hi, negative);
    }
    nan_c += sp[0];
    pinf_c += sp[1];
    ninf_c += sp[2];
    sp[0] = sp[1] = sp[2] = 0;
    // carry pass into digits in [0, 2^20); the scratch is zeroed behind it
    long long carry = 0;
#pragma unroll 8
    for (int l = 0; l < kDotLimbs; ++l) {
      const long long v = ar[l] + carry;
      const long long d = v & exblas::kLimbMask;
      carry = (v - d) >> exblas::kLimbBits;
      my[l * B] = static_cast<int>(d);
      ar[l] = 0;
    }
    if (carry < 0) {
      // A negative value: the digits above its top are all ones.  They and
      // the final -1 carry are together one limb of -1 just above them.
      int top = kDotLimbs - 1;
      while (top >= 0 && my[top * B] == exblas::kLimbMask) {
        my[top * B] = 0;
        --top;
      }
      if (top + 1 < kDotLimbs) {
        my[(top + 1) * B] = -1;
      } else {
        my[top * B] -= 1 << exblas::kLimbBits;
      }
    }
    for (int l = 0; l < kDotLimbs; ++l) {
      if (my[l * B] != 0) {
        jlo = imin(jlo, l);
        jhi = l;
      }
    }
    if (!unit) t_ii = t[row * n + row];
    if (j > 0) t_next = t[row * n + base];
  }

  for (int i = 0; i < rows; ++i) {
    const long long t_ji = t_next;  // T[row, base + i], for j > i
    if (live && j > i + 1) t_next = t[row * n + base + i + 1];
    if (j == i) {
      // a special count decides the bits whatever the rounding gives
      unsigned long long bits =
          (nan_c | pinf_c | ninf_c) != 0
              ? 0ULL
              : exblas::round_limbs(my, jlo, jhi, kDotLimbs, kDotOffset, B);
      bits = exblas::apply_specials(bits, nan_c, pinf_c, ninf_c);
      if (!unit) {
        const double v = __ddiv_rn(
            __longlong_as_double(static_cast<long long>(bits)),
            __longlong_as_double(t_ii));
        bits = v != v ? exblas::kQNanBits
                      : static_cast<unsigned long long>(__double_as_longlong(v));
      }
      s_x[i] = static_cast<long long>(bits);
      x[row] = static_cast<long long>(bits);
    }
    __syncthreads();
    if (live && j > i) {
      int q;
      unsigned long long lo, hi;
      bool negative;
      if (exblas::decode_product(t_ji ^ kSign, s_x[i], kDotOffset, q, lo, hi,
                                 negative, nan_c, pinf_c, ninf_c)) {
        exblas::add_digits<kDigits>(my, kDotLimbs, q, lo, hi, negative, B);
        jlo = imin(jlo, q);
        jhi = imax(jhi, imin(q + kDigits - 1, kDotLimbs - 1));
      }
    }
  }
}

}  // namespace

extern "C" {

// t: (n, n) float64 row-major, b: (n,) float64 (both read as int64 bits);
// x: (n,) int64 bits out.  acc: (min(block, n), 216) int64 and special:
// (min(block, n), 3) int64, zeroed by the caller, are the row blocks'
// scratch (the diagonal kernel leaves them zeroed).  block: the row-block
// height in [1, 256].  parts: kPanel | kDiag for the solve; one of them
// alone runs only those launches (for timing them apart: the panels then
// read the x already in the output).
int trsv_lower_x_cuda(const void* t, const void* b, long long n, int unit,
                      int block, int parts, void* acc, void* special, void* x,
                      void* stream) {
  if (block < 1 || block > kMaxBlock) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = static_cast<int>(sizeof(int)) * kDotLimbs * block;
  cudaError_t err = cudaFuncSetAttribute(
      trsv_diag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* tb = static_cast<const long long*>(t);
  long long* xb = static_cast<long long*>(x);
  for (long long base = 0; base < n; base += block) {
    const int rows = static_cast<int>(n - base < block ? n - base : block);
    if ((parts & kPanel) && base > 0) {
      const int e = gemv_rows_acc_cuda(tb + base * n, xb, rows, base, n, 1,
                                       acc, special, stream);
      if (e != 0) return e;
    }
    if (parts & kDiag) {
      trsv_diag_kernel<<<1, block, smem, s>>>(
          tb, n, static_cast<const long long*>(b), unit, base, rows,
          static_cast<long long*>(acc), static_cast<long long*>(special), xb);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
