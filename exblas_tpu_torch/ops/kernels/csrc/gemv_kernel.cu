// Exact ExGEMV row accumulators on Hopper, any data: for each row i of A
// (m, k) the exact sum of the 106-bit products a[i,k] * z[k] in a
// DOT_FORMAT superaccumulator (216 int64 limbs of 20 bits, bit 0 at
// 2^-2148) and the row's NaN, +Inf and -Inf counts, in the JAX layout.
//
// Replaces exblas_tpu/ops/kernels/gemv_kernel.py: gemv_rows_acc_pallas
// (_gemv_kernel).  The TPU kernel reads A transposed (k in sublanes, 128
// rows in lanes), broadcasts z to (k, 128), and keeps 8 int32 phase
// sub-accumulators per limb with a _renorm8 carry pass, all because its
// lanes are int32 only.  Here rows of A are contiguous and limbs are
// int64:
//   * a block of 256 threads owns one row and one span of k; its lanes
//     stride over the span with coalesced 8-byte loads of the row and of
//     z, four products in flight per lane;
//   * each product is decoded and formed exactly as in dot_kernel.cu
//     (exblas::decode_product, __umul64hi) and added whole into the warp's
//     BinWindow register bins, or digit by digit into the block's shared
//     int64 accumulator (deposit.cuh); specials are counted as in
//     exblas_tpu/core/deposit.py;
//   * the block adds its nonzero limbs and counts to the row's output by
//     64-bit integer atomics.  Small m with large k splits k over several
//     blocks per row so that every SM has work; integer addition is
//     associative, so the split never changes a bit.
// A limb takes at most one digit below 2^20 per product and per flushed
// bin, so int64 limbs need no carry pass while k <= 2^42 (the wrapper
// checks).
//
// Bound on the H100: A's bytes.  8 bytes per element of A (z stays in
// L2): 537 MB at 8192^2, 0.160 ms at 3.35 TB/s; the integer work of a
// product (about 11 int32 operations at least) is 0.044 ms.  On data no
// GEMV rung covers, most products miss the warp's 4-limb window and take
// the shared-memory atomics, which then bound it.
#include <cuda_runtime.h>

#include <cstdint>

#include "deposit.cuh"
#include "round.cuh"

namespace {

using exblas::kDigits;
using exblas::kDotLimbs;
using exblas::kDotOffset;

constexpr int kWs = kDotLimbs + 3;  // limbs, then NaN, +Inf, -Inf counts
constexpr int kUnroll = 4;          // products loaded per thread per step
constexpr long long kStep = static_cast<long long>(exblas::kBlock) * kUnroll;

__global__ void __launch_bounds__(exblas::kBlock)
    gemv_rows_kernel(const long long* __restrict__ a, long long lda,
                     const long long* __restrict__ z, long long zsign,
                     long long k, int splits, long long span,
                     unsigned long long* __restrict__ limbs,
                     unsigned long long* __restrict__ special) {
  __shared__ unsigned long long s_acc[kWs];
  for (int j = threadIdx.x; j < kWs; j += blockDim.x) s_acc[j] = 0ULL;
  __syncthreads();
  const long long row = blockIdx.x / splits;
  const long long k0 = (blockIdx.x % splits) * span;
  const long long k1 = k0 + span < k ? k0 + span : k;
  const long long* ar = a + row * lda;

  exblas::BinWindow<kDigits> window;
  long long nan_c = 0, pinf_c = 0, ninf_c = 0;
  // Block-uniform loop bound; lanes past k1 decode 0 * 0.
  for (long long base = k0; base < k1; base += kStep) {
    long long va[kUnroll], vz[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * blockDim.x + threadIdx.x;
      va[u] = i < k1 ? ar[i] : 0LL;
      vz[u] = i < k1 ? z[i] ^ zsign : 0LL;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      int q;
      unsigned long long lo, hi;
      bool negative;
      const bool valid =
          exblas::decode_product(va[u], vz[u], kDotOffset, q, lo, hi,
                                 negative, nan_c, pinf_c, ninf_c);
      window.add(valid, q, lo, hi, negative, s_acc);
    }
  }
  window.flush(s_acc);
  exblas::deposit_specials(s_acc, kDotLimbs, nan_c, pinf_c, ninf_c);
  __syncthreads();
  for (int j = threadIdx.x; j < kWs; j += blockDim.x) {
    if (s_acc[j] == 0ULL) continue;
    unsigned long long* dst = j < kDotLimbs
                                  ? limbs + row * kDotLimbs + j
                                  : special + row * 3 + (j - kDotLimbs);
    atomicAdd(dst, s_acc[j]);
  }
}

}  // namespace

extern "C" {

// a: (m, k) float64 with rows lda >= k elements apart (row-major: lda = k),
// z: (k,) float64 (read as int64 bits); k >= 1.  negate_z != 0 flips z's
// sign bits, so the rows take the products a[i,k] * -z[k] -- exactly those
// of -a[i,k] * z[k], specials included.  limbs: (m, 216) int64 and special:
// (m, 3) int64, zeroed by the caller; the row sums are added to them.
int gemv_rows_acc_cuda(const void* a, const void* z, long long m, long long k,
                       long long lda, int negate_z, void* limbs,
                       void* special, void* stream) {
  long long splits = 0, span = 0;
  const cudaError_t err = exblas::row_splits(m, k, kStep, &splits, &span);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = m * splits;
  gemv_rows_kernel<<<static_cast<unsigned>(blocks), exblas::kBlock, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(a), lda, static_cast<const long long*>(z),
      negate_z ? static_cast<long long>(exblas::kSignBit) : 0LL, k,
      static_cast<int>(splits), span, static_cast<unsigned long long*>(limbs),
      static_cast<unsigned long long*>(special));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
