// Exact ExGEMM on Hopper, any data: C[i,j] = Round(sum_k z[i,k] * b[k,j]
// (+ beta * c[i,j])), every product exact down to 2^-2148 and each element
// rounded once, on the device.
//
// Replaces exblas_tpu/ops/kernels/gemm_kernel.py: gemm_bits_pallas
// (_gemm_kernel).  The TPU kernel walks (8, 128) output tiles with k in
// sublanes, deposits 14-bit shift classes into a phase-layout int32
// accumulator with _renorm8 carry passes and mask-selects rows; none of
// that carries over.  Here one warp owns one output element at a time:
//   * its 32 lanes stride over k with coalesced 8-byte loads of row i of z
//     and row j of b^T (the wrapper passes b transposed and contiguous),
//     four products in flight per lane;
//   * each product is decoded and formed exactly as in dot_kernel.cu
//     (exblas::decode_product, __umul64hi) and added whole into the warp's
//     BinWindow register bins, or digit by digit into the warp's own
//     DOT_FORMAT accumulator of 216 int64 limbs in shared memory (1.7 KB);
//   * lane 0 adds the exact 106-bit product beta * c[i,j] (beta = 1 makes
//     it c itself) and the special counts follow exblas_tpu/core/deposit.py;
//   * the warp finds the nonzero limb range by ballots and lane 0 rounds
//     only that range (round.cuh round_limbs), so rounding costs a few
//     dozen limbs, not 216, per element.
// A limb takes at most one digit below 2^20 per product and per flushed
// bin, so int64 limbs need no carry pass while k <= 2^42 (the wrapper
// checks).  No floating-point operation touches the data, so the bits do
// not depend on the order of the lanes' atomics.
//
// Bound on the H100: integer issue.  Each product costs a few dozen
// integer instructions (decode of both operands, the 64-bit product, the
// 192-bit bin add) and the tensor cores cannot help, so at n = 4096 the
// 2^36 products take far longer than the 0.4 GB the kernel reads; this
// kernel is the fallback behind the int8 slice kernel (gemm_mxu.cu) for
// data it cannot cover.
#include <cuda_runtime.h>

#include <cstdint>

#include "deposit.cuh"
#include "round.cuh"

namespace {

using exblas::kDigits;
using exblas::kDotLimbs;
using exblas::kDotOffset;

constexpr int kWarps = exblas::kBlock / 32;
constexpr int kWs = kDotLimbs + 3;  // limbs, then NaN, +Inf, -Inf counts
constexpr int kUnroll = 4;          // products loaded per lane per step

__global__ void __launch_bounds__(exblas::kBlock)
    gemm_exact_kernel(const long long* __restrict__ z,
                      const long long* __restrict__ bt,
                      const long long* __restrict__ c, long long beta,
                      int beta_mode, long long m, long long n, long long k,
                      long long* __restrict__ out) {
  __shared__ unsigned long long s_acc[kWarps][kWs];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned long long* acc = s_acc[warp];
  const long long total = m * n;
  for (long long e = static_cast<long long>(blockIdx.x) * kWarps + warp;
       e < total; e += static_cast<long long>(gridDim.x) * kWarps) {
    for (int j = lane; j < kWs; j += 32) acc[j] = 0ULL;
    __syncwarp();
    const long long* zr = z + (e / n) * k;
    const long long* br = bt + (e % n) * k;
    exblas::BinWindow<kDigits> window;
    long long nan_c = 0, pinf_c = 0, ninf_c = 0;
    // Warp-uniform loop bound; lanes past k decode 0 * 0.
    for (long long base = 0; base < k; base += 32 * kUnroll) {
      long long va[kUnroll], vb[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + u * 32 + lane;
        va[u] = i < k ? zr[i] : 0LL;
        vb[u] = i < k ? br[i] : 0LL;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        int q;
        unsigned long long lo, hi;
        bool negative;
        const bool valid =
            exblas::decode_product(va[u], vb[u], kDotOffset, q, lo, hi,
                                   negative, nan_c, pinf_c, ninf_c);
        window.add(valid, q, lo, hi, negative, acc);
      }
    }
    window.flush(acc);
    exblas::deposit_specials(acc, kDotLimbs, nan_c, pinf_c, ninf_c);
    if (lane == 0 && beta_mode != 0) {
      long long cn = 0, cp = 0, cm = 0;
      int q;
      unsigned long long lo, hi;
      bool negative;
      if (exblas::decode_product(beta, c[e], kDotOffset, q, lo, hi, negative,
                                 cn, cp, cm)) {
        exblas::deposit_digits<kDigits>(acc, q, lo, hi, negative);
      }
      acc[kDotLimbs] += cn;
      acc[kDotLimbs + 1] += cp;
      acc[kDotLimbs + 2] += cm;
    }
    __syncwarp();
    // The nonzero limb range, 32 limbs per ballot.
    int jlo = kDotLimbs, jhi = -1;
    for (int j0 = 0; j0 < kDotLimbs; j0 += 32) {
      const int j = j0 + lane;
      const unsigned nz =
          __ballot_sync(exblas::kFullMask, j < kDotLimbs && acc[j] != 0ULL);
      if (nz != 0u) {
        if (jlo == kDotLimbs) jlo = j0 + __ffs(nz) - 1;
        jhi = j0 + 31 - __clz(nz);
      }
    }
    if (lane == 0) {
      long long* limbs = reinterpret_cast<long long*>(acc);
      const unsigned long long bits =
          exblas::round_limbs(limbs, jlo, jhi, kDotLimbs, kDotOffset);
      out[e] = static_cast<long long>(exblas::apply_specials(
          bits, limbs[kDotLimbs], limbs[kDotLimbs + 1],
          limbs[kDotLimbs + 2]));
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// z: (m, k) and bt: (n, k) float64, row-major (read as int64 bits); c:
// (m, n) float64 or null when beta_mode == 0; beta: the bits of beta
// (beta_mode 1 passes 1.0).  Writes the (m, n) correctly rounded bits.
int gemm_bits_cuda(const void* z, const void* bt, const void* c,
                   long long beta, int beta_mode, long long m, long long n,
                   long long k, void* out, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (m * n + kWarps - 1) / kWarps;
  const long long cap = static_cast<long long>(sms) * (2048 / exblas::kBlock);
  const int grid = static_cast<int>(want < cap ? want : cap);
  gemm_exact_kernel<<<grid, exblas::kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(z), static_cast<const long long*>(bt),
      static_cast<const long long*>(c), beta, beta_mode, m, n, k,
      static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
