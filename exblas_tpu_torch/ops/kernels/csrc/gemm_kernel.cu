// Exact ExGEMM on Hopper, any data: C[i,j] = Round(sum_k z[i,k] * b[k,j]
// (+ beta * c[i,j])), every product exact down to 2^-2148 and each element
// rounded once, on the device.
//
// Replaces exblas_tpu/ops/kernels/gemm_kernel.py:179 gemm_bits_pallas
// (_gemm_kernel).  The TPU kernel walks (8, 128) output tiles with k in
// sublanes, deposits 14-bit shift classes into a phase-layout int32
// accumulator with _renorm8 carry passes and mask-selects rows; none of
// that carries over.  Here each thread owns one output element and its own
// exact accumulator, so no deposit needs an atomic:
//   * a block of 256 threads owns a 16 x 16 tile of C; the tiles are
//     numbered row by row on grid.x alone, so m and n are limited only by
//     2^31 - 1 tiles.  The tile's 16 rows of z and 16 columns of b (rows
//     of b^T: the wrapper passes b transposed and contiguous) come through
//     shared memory in chunks of kChunk = 32 values of k; the next chunk's
//     raw bits are loaded into registers while the current one is used;
//   * each element is decoded once per chunk (significand, max(expf, 1),
//     sign and class, kulisch.cuh decode_meta) and then serves the 16
//     threads of its row or column;
//   * a thread's accumulator is kulisch.cuh's word accumulator: 68 words of
//     64 bits in shared memory, laid out [word][thread], so the 32 lanes of
//     a warp touch 32 distinct banks whatever word each adds to.  A product
//     is one 64x64 -> 128-bit multiply and a three-word add with carries
//     (add_words).  The words start biased (kulisch.cuh kBiasWord), so a
//     carry or borrow out of the third word stops at the fourth even where
//     the sum changes sign, which would otherwise flip every word above it;
//   * NaN, +Inf and -Inf products are counted in registers, as
//     exblas_tpu/core/deposit.py counts them (0 * Inf is NaN), on a path a
//     chunk takes only when one of its elements is special;
//   * the thread adds the exact product beta * c[i,j] (beta = 1 makes it c
//     itself), removes the bias and rounds its words once (kulisch.cuh
//     unbias_words, round_words: the bits of round.cuh round_limbs on the
//     same value; an exact zero is +0.0) and applies the specials.
// No floating-point operation touches the data, so the bits depend on
// neither the tile nor the chunk.
//
// Headroom: a product is below 2^(2148 + 2048) in units of bit 0, so k <=
// MAX_TERMS = 2^42 products (the wrapper checks) and beta * c stay below
// 2^4239 in magnitude; 68 words hold 4,352 bits, so the two's-complement
// sum never wraps.
//
// Shared memory: 68 words x 8 bytes x 256 threads = 139,264 bytes of
// accumulators plus 13,056 bytes for one decoded chunk of z and b: one
// block per SM, 8 warps.
//
// Bound on the H100: at n = 4096 the 2^36 products need at least 11 int32
// operations each (45.2 ms at 64 per clock per SM; PERF.md section 6),
// more than the 0.4 GB of operands take (0.12 ms).  This design also has
// its own bound in shared-memory wavefronts: a warp's 32 products take 12
// for the three words read and written (64-bit accesses, two wavefronts
// each) and 4 for the decoded operands, 0.5 cycles a product per SM:
// 131 ms at 1980 MHz on 132 SMs.
#include <cuda_runtime.h>

#include <cstdint>

#include "kulisch.cuh"
#include "round.cuh"

namespace {

using exblas::kWords;

constexpr int kTile = 16;                   // C tile: kTile x kTile
constexpr int kThreads = kTile * kTile;     // one thread per element
constexpr int kChunk = 32;                  // k values staged at once
constexpr int kLoads = kTile * kChunk / kThreads;  // per thread per operand
constexpr int kAccBytes = kWords * kThreads * 8;

__global__ void __launch_bounds__(kThreads)
    gemm_words_kernel(const long long* __restrict__ z,
                      const long long* __restrict__ bt,
                      const long long* __restrict__ c, long long beta,
                      int beta_mode, long long m, long long n, long long k,
                      long long* __restrict__ out) {
  extern __shared__ unsigned long long s_acc[];  // word w at [w * kThreads]
  // [k][row or column], rows padded by one so the decode's stores (32
  // values of k of one row per warp) spread over the banks
  __shared__ unsigned long long s_zm[kChunk][kTile + 1];
  __shared__ unsigned long long s_bm[kChunk][kTile + 1];
  __shared__ int s_zx[kChunk][kTile + 1], s_bx[kChunk][kTile + 1];
  const int tid = threadIdx.x;
  const int ty = tid / kTile, tx = tid % kTile;
  const long long tiles_n = (n + kTile - 1) / kTile;
  const long long i0 = blockIdx.x / tiles_n * kTile;
  const long long j0 = blockIdx.x % tiles_n * kTile;
  unsigned long long* acc = s_acc + tid;
#pragma unroll 4
  for (int w = 0; w < kWords; ++w) acc[w * kThreads] = exblas::kBiasWord;

  // Element e = tid + kThreads * u of a chunk: row (or column) e / kChunk,
  // k offset e % kChunk; out-of-range values load as +0.0.
  long long rz[kLoads], rb[kLoads];
  auto load = [&](long long k0) {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = tid + kThreads * u;
      const long long kk = k0 + e % kChunk;
      const long long i = i0 + e / kChunk, j = j0 + e / kChunk;
      rz[u] = (i < m && kk < k) ? z[i * k + kk] : 0LL;
      rb[u] = (j < n && kk < k) ? bt[j * k + kk] : 0LL;
    }
  };
  long long nan_c = 0, pinf_c = 0, ninf_c = 0;
  load(0);
  for (long long k0 = 0; k0 < k; k0 += kChunk) {
    __syncthreads();  // the previous chunk is used up
    int special = 0;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = tid + kThreads * u;
      unsigned long long mant;
      int meta;
      exblas::decode_meta(rz[u], mant, meta);
      s_zm[e % kChunk][e / kChunk] = mant;
      s_zx[e % kChunk][e / kChunk] = meta;
      special |= meta;
      exblas::decode_meta(rb[u], mant, meta);
      s_bm[e % kChunk][e / kChunk] = mant;
      s_bx[e % kChunk][e / kChunk] = meta;
      special |= meta;
    }
    const bool any_special =
        __syncthreads_or(special & exblas::kMetaSpecial) != 0;
    if (k0 + kChunk < k) load(k0 + kChunk);  // in flight while we deposit
    const int kn = k - k0 < kChunk ? static_cast<int>(k - k0) : kChunk;
    if (any_special) {
      for (int kk = 0; kk < kn; ++kk) {
        const int ma = s_zx[kk][ty], mb = s_bx[kk][tx];
        if ((ma | mb) & exblas::kMetaSpecial) {
          exblas::count_special(ma, mb, nan_c, pinf_c, ninf_c);
        }
      }
    }
    // One product a pass, so scripts/b5_sass.py reads the loop directly;
    // the next product's operands are loaded before this one's deposit.
    unsigned long long xa = s_zm[0][ty], xb = s_bm[0][tx];
    int ma = s_zx[0][ty], mb = s_bx[0][tx];
#pragma unroll 1
    for (int kk = 0; kk < kn; ++kk) {
      const unsigned long long ya = xa, yb = xb;
      const int na = ma, nb = mb;
      const int k1 = kk + 1 < kn ? kk + 1 : kk;
      xa = s_zm[k1][ty];
      xb = s_bm[k1][tx];
      ma = s_zx[k1][ty];
      mb = s_bx[k1][tx];
      if (ya == 0ULL || yb == 0ULL) continue;  // zeros and specials
      exblas::add_words(acc, kThreads, exblas::product_pos(na, nb), ya * yb,
                        __umul64hi(ya, yb),
                        ((na ^ nb) & exblas::kMetaSign) != 0);
    }
  }
  const long long i = i0 + ty, j = j0 + tx;
  if (i >= m || j >= n) return;
  if (beta_mode != 0) {
    unsigned long long lo, hi;
    int p;
    bool negative;
    if (exblas::word_product(beta, c[i * n + j], lo, hi, p, negative, nan_c,
                             pinf_c, ninf_c)) {
      exblas::add_words(acc, kThreads, p, lo, hi, negative);
    }
  }
  // a special count decides the bits whatever the rounding gives
  unsigned long long bits = 0ULL;
  if ((nan_c | pinf_c | ninf_c) == 0) {
    exblas::unbias_words(acc, kThreads);
    bits = exblas::round_words(acc, kThreads);
  }
  out[i * n + j] = static_cast<long long>(
      exblas::apply_specials(bits, nan_c, pinf_c, ninf_c));
}

}  // namespace

extern "C" {

// z: (m, k) and bt: (n, k) float64, row-major (read as int64 bits); c:
// (m, n) float64 or null when beta_mode == 0; beta: the bits of beta
// (beta_mode 1 passes 1.0).  Writes the (m, n) correctly rounded bits.
int gemm_bits_cuda(const void* z, const void* bt, const void* c,
                   long long beta, int beta_mode, long long m, long long n,
                   long long k, void* out, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_words_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kAccBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles =
      ((m + kTile - 1) / kTile) * ((n + kTile - 1) / kTile);
  if (tiles > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  gemm_words_kernel<<<static_cast<unsigned>(tiles), kThreads, kAccBytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(z), static_cast<const long long*>(bt),
      static_cast<const long long*>(c), beta, beta_mode, m, n, k,
      static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
