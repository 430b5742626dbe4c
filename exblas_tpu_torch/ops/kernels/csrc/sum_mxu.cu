// Kernel B11 on Hopper: the exact sum of every element covered by one
// global anchored window of W = 32 * nwa bits (nwa in {3, 4, 5}), plus a
// flag for any element it does not cover.
//
// Replaces exblas_tpu/ops/kernels/sum_mxu.py::_sum_epilogue_terms
// (_sum_flat_kernel).  The TPU kernel shifted each element into the window
// and summed its byte planes with one int8 MXU matmul per 32-bit word,
// because the TPU's vector unit could not decode and add fast enough.  On
// Hopper the integer pipes keep up with device memory, so each thread adds
// its elements' window words in registers (anchored.cuh) and a block adds
// its sums to a global workspace with one int64 atomic per word.
//
// Element x (int64 bits) with significand m and lowest-bit exponent
// e_lsb sits at sh = e_lsb - (E + 1 - W) in the frame whose bit 0 has
// exponent E + 1 - W (sum_mxu.py:216-218).  It is covered when
// 0 <= sh <= W - 53; a nonzero element outside, or a NaN/Inf, sets the
// flag (the exponent-field rule of gemv_mxu.py:367-377).  A covered
// element adds +-(m << (sh % 32)) -- three 32-bit words -- at word sh / 32.
//
// Bound on the H100: 8 bytes read per element and a few dozen integer
// operations, so device memory (3.35 TB/s) is the bound: 2^24 elements in
// about 40 us.  Headroom: each word sum grows by < 2^32 per element and
// n <= 2^30 (MAX_N_MXU), so every sum stays below 2^62.
#include <cuda_runtime.h>

#include "anchored.cuh"
#include "deposit.cuh"

namespace {

constexpr int kUnroll = 4;  // elements loaded per thread per step

template <int NW>
__global__ void __launch_bounds__(exblas::kBlock)
    sum_flat_kernel(const long long* __restrict__ x, long long n,
                    const int* __restrict__ anchor,
                    unsigned long long* __restrict__ ws) {
  constexpr int kW = 32 * NW;
  constexpr int kQB = NW > 3 ? 2 : 1;  // word shifts up to NW - 2
  const int base_exp = *anchor + 1 - kW;
  unsigned long long sums[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) sums[j] = 0ULL;
  unsigned long long negs = 0ULL;
  bool bad = false;
  const long long step = static_cast<long long>(blockDim.x) * kUnroll;
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
      unsigned long long m;
      int e_lsb;
      bool special;
      exblas::decode_anchored(b[u], m, e_lsb, special);
      const int sh = e_lsb - base_exp;
      const bool inside = sh >= 0 && sh <= kW - 53;
      bad = bad || special || (m != 0ULL && !inside);
      const bool add = m != 0ULL && inside;
      const int s = add ? sh : 0;
      const unsigned long long mm = add ? m : 0ULL;
      const int r = s & 31;
      const unsigned long long lo = mm << r;
      const unsigned int y[3] = {
          static_cast<unsigned int>(lo), static_cast<unsigned int>(lo >> 32),
          static_cast<unsigned int>(r != 0 ? mm >> (64 - r) : 0ULL)};
      exblas::add_to_frame<NW, 3, kQB>(sums, negs, y, s >> 5,
                                       add && b[u] < 0);
    }
  }
  exblas::flush_frame<NW>(sums, negs, bad, ws);
}

template <int NW>
int launch(const void* x, long long n, const void* anchor, void* ws,
           cudaStream_t s) {
  int grid = 0;
  cudaError_t err = exblas::deposit_grid(n, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_flat_kernel<NW><<<grid, exblas::kBlock, 0, s>>>(
      static_cast<const long long*>(x), n, static_cast<const int*>(anchor),
      static_cast<unsigned long long*>(ws));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: n float64 values (read as int64 bits); anchor: one int32 on the
// device; ws: nwa + 2 int64, zeroed by the caller.  Adds the word sums
// D_0..D_{nwa-1} (word d at frame bit 32 d), minus the negative count (at
// bit 32 nwa), and the flag.
int sum_flat_cuda(const void* x, long long n, const void* anchor, int nwa,
                  void* ws, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nwa) {
    case 3:
      return launch<3>(x, n, anchor, ws, s);
    case 4:
      return launch<4>(x, n, anchor, ws, s);
    case 5:
      return launch<5>(x, n, anchor, ws, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
