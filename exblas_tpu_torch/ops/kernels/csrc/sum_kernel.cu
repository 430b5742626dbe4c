// Exact ExSUM on Hopper: any float64 data -> one int64 Kulisch
// superaccumulator (SUM_FORMAT: 112 limbs of base 2^20, bit 0 = 2^-1074)
// -> canonical int32 limbs or one correctly rounded double.
//
// Replaces exblas_tpu/ops/kernels/sum_kernel.py: exsum_pallas (_sum_kernel)
// and exsum_bits_pallas (_sum_bits_kernel with _sum_round_tail).  The TPU
// kernel's 8-phase (L*8, 128) lane layout, _tree8, periodic _renorm8 carry
// passes and power-of-two grid bucketing exist for the TPU's sequential
// grid and int32 limbs; this kernel needs none of them.
//
// Bound on the H100: the stream reads 8 bytes per element and does a few
// dozen integer operations on it, so HBM bandwidth (3.35 TB/s) is the
// natural bound: 2^24 elements are 128 MiB, about 40 us.  The design:
//   * one grid-stride pass with coalesced 8-byte loads, four elements in
//     flight per thread;
//   * each element's significand, shifted to its offset in base limb q,
//     is added whole into a per-thread signed 192-bit bin in registers when
//     q falls in the warp's window of 4 limbs (deposit.cuh) -- for
//     realistic exponent ranges, the counterpart of the TPU kernel's
//     single-window fast path (sum_kernel.py:150-174), every element does --
//     and otherwise split into four signed 20-bit pieces added to limbs
//     q..q+3 of a per-block int64 accumulator in shared memory by integer
//     atomics; the bins are split, summed over the warp and added to the
//     shared accumulator once, at the end.  A limb takes at most one piece
//     below 2^20 per element and per flushed bin, so int64 limbs need no
//     carry pass while n <= 2^42 (the wrapper checks);
//   * NaN/+Inf/-Inf are counted beside the limbs;
//   * blocks merge into one global int64 accumulator by integer atomics,
//     and a one-block finishing kernel exports or rounds it (round.cuh).
// Integer addition is associative, so the result does not depend on the
// order of the atomics.  No floating-point arithmetic touches the data.
#include <cuda_runtime.h>

#include <cstdint>

#include "deposit.cuh"
#include "round.cuh"

namespace {

using exblas::kLimbBits;
using exblas::kLimbMask;

constexpr int kSumLimbs = 112;    // SUM_FORMAT.n_limbs
constexpr int kSumOffset = 1074;  // SUM_FORMAT.offset_bits
constexpr int kWs = kSumLimbs + 3;
constexpr int kUnroll = 4;        // elements loaded per thread per step

// Decode one double (int64 bits) into its base limb q and its significand
// shifted left by r = p % 20, (m1:m0) < 2^73, to be added at limb q with
// the double's sign.  NaN/+Inf/-Inf are counted and, like zeros, deposit
// nothing (valid == false).
__device__ __forceinline__ bool decode_sum(long long b, int& q,
                                           unsigned long long& m0,
                                           unsigned long long& m1,
                                           long long& nan_c,
                                           long long& pinf_c,
                                           long long& ninf_c) {
  const int expf = static_cast<int>((b >> 52) & 0x7FF);
  const unsigned long long frac =
      static_cast<unsigned long long>(b) & ((1ULL << 52) - 1ULL);
  unsigned long long mant = 0ULL;
  if (expf == 0x7FF) {
    if (frac != 0ULL) {
      ++nan_c;
    } else if (b < 0) {
      ++ninf_c;
    } else {
      ++pinf_c;
    }
  } else {
    mant = expf != 0 ? (frac | (1ULL << 52)) : frac;
  }
  // LSB bit position p = max(expf,1) - 1075 + 1074 >= 0; q = p / 20.
  const int p = (expf != 0 ? expf : 1) - 1075 + kSumOffset;
  q = p / kLimbBits;
  const int r = p - q * kLimbBits;
  m0 = mant << r;
  m1 = r != 0 ? mant >> (64 - r) : 0ULL;
  return mant != 0ULL;
}

__global__ void __launch_bounds__(exblas::kBlock)
    sum_deposit_kernel(const long long* __restrict__ x, long long n,
                       unsigned long long* __restrict__ ws) {
  __shared__ unsigned long long s_acc[kWs];
  for (int j = threadIdx.x; j < kWs; j += blockDim.x) s_acc[j] = 0ULL;
  __syncthreads();

  exblas::BinWindow<4> window;
  long long nan_c = 0, pinf_c = 0, ninf_c = 0;
  const long long step = static_cast<long long>(blockDim.x) * kUnroll;
  // The loop bound is uniform over the block, so every lane of a warp takes
  // part in the warp collectives; lanes past n decode +0.0, which deposits
  // nothing.
  for (long long base = blockIdx.x * step; base < n;
       base += gridDim.x * step) {
    long long b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * blockDim.x + threadIdx.x;
      b[u] = i < n ? x[i] : 0LL;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      int q;
      unsigned long long m0, m1;
      const bool valid = decode_sum(b[u], q, m0, m1, nan_c, pinf_c, ninf_c);
      window.add(valid, q, m0, m1, b[u] < 0, s_acc);
    }
  }
  window.flush(s_acc);
  exblas::deposit_specials(s_acc, kSumLimbs, nan_c, pinf_c, ninf_c);
  __syncthreads();
  for (int j = threadIdx.x; j < kWs; j += blockDim.x) {
    if (s_acc[j] != 0ULL) atomicAdd(&ws[j], s_acc[j]);
  }
}

__global__ void sum_finish_kernel(const long long* __restrict__ ws,
                                  int* limbs_out, int* special_out,
                                  unsigned long long* bits_out) {
  __shared__ long long sum[kWs];
  for (int j = threadIdx.x; j < kWs; j += blockDim.x) sum[j] = ws[j];
  __syncthreads();
  exblas::finish<kSumLimbs>(sum, kSumOffset, limbs_out, special_out,
                            bits_out);
}

int launch(const void* x, long long n, void* ws, void* limbs_out,
           void* special_out, void* bits_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int grid = 0;
  cudaError_t err = exblas::deposit_grid(n, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_deposit_kernel<<<grid, exblas::kBlock, 0, s>>>(
      static_cast<const long long*>(x), n,
      static_cast<unsigned long long*>(ws));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_finish_kernel<<<1, 128, 0, s>>>(
      static_cast<const long long*>(ws), static_cast<int*>(limbs_out),
      static_cast<int*>(special_out),
      static_cast<unsigned long long*>(bits_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: n float64 values (read as int64 bits).  ws: 115 int64, zeroed by the
// caller.  Writes 112 canonical int32 limbs and 3 int32 special counts.
int exsum_acc_cuda(const void* x, long long n, void* ws, void* limbs_out,
                   void* special_out, void* stream) {
  return launch(x, n, ws, limbs_out, special_out, nullptr, stream);
}

// As exsum_acc_cuda, but writes the correctly rounded binary64 bits.
int exsum_bits_cuda(const void* x, long long n, void* ws, void* bits_out,
                    void* stream) {
  return launch(x, n, ws, nullptr, nullptr, bits_out, stream);
}

}  // extern "C"
