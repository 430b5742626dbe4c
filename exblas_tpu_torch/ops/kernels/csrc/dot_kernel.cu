// Exact ExDOT on Hopper: any two float64 vectors -> one int64 Kulisch
// superaccumulator of their exact products (DOT_FORMAT: 216 limbs of base
// 2^20, bit 0 = 2^-2148) -> canonical int32 limbs or one correctly rounded
// double.
//
// Replaces exblas_tpu/ops/kernels/dot_kernel.py: exdot_pallas (_dot_kernel)
// and exdot_bits_pallas (_dot_bits_kernel with _dot_round_tail).  The TPU
// builds the 106-bit product from 14-bit pieces in 7 shift classes because
// it has no 64-bit multiply; Hopper forms it directly as (hi, lo) =
// (__umul64hi(ma, mb), ma * mb) on the 53-bit significands.  No TwoProdFMA:
// its residual underflows, and DOT_FORMAT keeps products down to 2^-2148.
// The TPU's 8-phase lane layout, _tree8, _renorm8 cadence and grid
// bucketing are left out, as in sum_kernel.cu.
//
// Bound on the H100: 16 bytes read per element and a few dozen integer
// operations, so HBM bandwidth (3.35 TB/s) is the natural bound: 2^24
// elements are 256 MiB, about 80 us.  The design follows sum_kernel.cu:
//   * one grid-stride pass with coalesced 8-byte loads of both vectors,
//     four products in flight per thread;
//   * the shifted product (up to 125 bits) is added whole into a
//     per-thread signed 192-bit bin in registers when its base limb q falls
//     in the warp's window of 4 limbs (deposit.cuh), and otherwise split
//     into 7 exact 20-bit digits added to limbs q..q+6 of a per-block int64
//     accumulator in shared memory by integer atomics; the bins reach the
//     shared accumulator once, at the end.  A limb takes at most one digit
//     below 2^20 per element and per flushed bin, so int64 limbs need no
//     carry pass while n <= 2^42 (the wrapper checks);
//   * specials follow exblas_tpu/core/deposit.py:181-234: NaN or 0*Inf gives
//     NaN, Inf times a finite nonzero gives Inf with the xor of the signs,
//     and a zero or special deposits nothing;
//   * blocks merge by global integer atomics; a one-block finishing kernel
//     exports or rounds (round.cuh).
#include <cuda_runtime.h>

#include <cstdint>

#include "deposit.cuh"
#include "round.cuh"

namespace {

using exblas::kDigits;
using exblas::kDotLimbs;
using exblas::kDotOffset;

constexpr int kWs = kDotLimbs + 3;
constexpr int kUnroll = 4;  // products loaded per thread per step

__global__ void __launch_bounds__(exblas::kBlock)
    dot_deposit_kernel(const long long* __restrict__ a,
                       const long long* __restrict__ b, long long n,
                       unsigned long long* __restrict__ ws) {
  __shared__ unsigned long long s_acc[kWs];
  for (int j = threadIdx.x; j < kWs; j += blockDim.x) s_acc[j] = 0ULL;
  __syncthreads();

  exblas::BinWindow<kDigits> window;
  long long nan_c = 0, pinf_c = 0, ninf_c = 0;
  const long long step = static_cast<long long>(blockDim.x) * kUnroll;
  // Block-uniform loop bound; lanes past n decode 0 * 0.
  for (long long base = blockIdx.x * step; base < n;
       base += gridDim.x * step) {
    long long va[kUnroll], vb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * blockDim.x + threadIdx.x;
      va[u] = i < n ? a[i] : 0LL;
      vb[u] = i < n ? b[i] : 0LL;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      int q;
      unsigned long long lo, hi;
      bool negative;
      const bool valid =
          exblas::decode_product(va[u], vb[u], kDotOffset, q, lo, hi,
                                 negative, nan_c, pinf_c, ninf_c);
      window.add(valid, q, lo, hi, negative, s_acc);
    }
  }
  window.flush(s_acc);
  exblas::deposit_specials(s_acc, kDotLimbs, nan_c, pinf_c, ninf_c);
  __syncthreads();
  for (int j = threadIdx.x; j < kWs; j += blockDim.x) {
    if (s_acc[j] != 0ULL) atomicAdd(&ws[j], s_acc[j]);
  }
}

__global__ void dot_finish_kernel(const long long* __restrict__ ws,
                                  int* limbs_out, int* special_out,
                                  unsigned long long* bits_out) {
  exblas::finish<kDotLimbs>(ws, kDotOffset, limbs_out, special_out, bits_out);
}

int launch(const void* a, const void* b, long long n, void* ws,
           void* limbs_out, void* special_out, void* bits_out,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int grid = 0;
  cudaError_t err = exblas::deposit_grid(n, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  dot_deposit_kernel<<<grid, exblas::kBlock, 0, s>>>(
      static_cast<const long long*>(a), static_cast<const long long*>(b), n,
      static_cast<unsigned long long*>(ws));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dot_finish_kernel<<<1, 128, 0, s>>>(
      static_cast<const long long*>(ws), static_cast<int*>(limbs_out),
      static_cast<int*>(special_out),
      static_cast<unsigned long long*>(bits_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// a, b: n float64 values each (read as int64 bits).  ws: 219 int64, zeroed
// by the caller.  Writes 216 canonical int32 limbs and 3 int32 counts.
int exdot_acc_cuda(const void* a, const void* b, long long n, void* ws,
                   void* limbs_out, void* special_out, void* stream) {
  return launch(a, b, n, ws, limbs_out, special_out, nullptr, stream);
}

// As exdot_acc_cuda, but writes the correctly rounded binary64 bits.
int exdot_bits_cuda(const void* a, const void* b, long long n, void* ws,
                    void* bits_out, void* stream) {
  return launch(a, b, n, ws, nullptr, nullptr, bits_out, stream);
}

}  // extern "C"
