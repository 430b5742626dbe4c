// Kernel B12 on Hopper: the exact dot product of two vectors, each
// covered by its own anchored window of 160 bits, plus a flag for any
// element that its window does not cover.
//
// Replaces exblas_tpu/ops/kernels/dot_mxu.py::_run_dot_kernel
// (_dot_flat_kernel).  The TPU kernel stacked both vectors' byte planes,
// sign masks and a ones row and formed every cross sum with one int8 MXU
// matmul per block (7/8 of its output discarded), because its vector unit
// could not build 106-bit products fast enough.  On Hopper each thread
// forms the exact product of two 53-bit significands with __umul64hi and
// the low product (never TwoProdFMA, whose residual underflows) and adds
// it, shifted, into a 320-bit frame of word sums in registers
// (anchored.cuh); a block adds its sums to a global workspace with one
// int64 atomic per word.
//
// Side a: significand ma, lowest-bit exponent ea_lsb, shift
// sha = ea_lsb - (EA + 1 - 160), covered when 0 <= sha <= 107; side b
// alike.  Each side is checked on its own (dot_mxu.py:138-139 calls
// _stack_planes once per side), so a zero a_i does not hide a b_i outside
// b's window.  A covered nonzero product ma * mb < 2^106 sits at bit
// sha + shb in [0, 214] of the frame whose bit 0 has exponent
// EA + EB + 2 - 320 (dot_mxu.py:214-215): five 32-bit words at word
// (sha + shb) / 32, ten words in all.
//
// Bound on the H100: 16 bytes read per element pair, 0.08 ms at 2^24
// pairs; the product, the shift and the frame cost about a hundred integer
// operations a pair.  Headroom: each word sum grows by < 2^32 per pair and
// n <= 2^31 (MAX_N_DOT_MXU), so every sum stays below 2^63 -- an int64 on
// the host.
#include <cuda_runtime.h>

#include "anchored.cuh"
#include "deposit.cuh"

namespace {

constexpr int kNW = 10;     // 320-bit frame
constexpr int kWin = 160;   // each side's window
constexpr int kUnroll = 4;  // pairs loaded per thread per step

__global__ void __launch_bounds__(exblas::kBlock)
    dot_flat_kernel(const long long* __restrict__ a,
                    const long long* __restrict__ b, long long n,
                    const int* __restrict__ ea, const int* __restrict__ eb,
                    unsigned long long* __restrict__ ws) {
  const int base_a = *ea + 1 - kWin;
  const int base_b = *eb + 1 - kWin;
  unsigned long long sums[kNW];
#pragma unroll
  for (int j = 0; j < kNW; ++j) sums[j] = 0ULL;
  unsigned long long negs = 0ULL;
  bool bad = false;
  const long long step = static_cast<long long>(blockDim.x) * kUnroll;
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
      unsigned long long ma, mb;
      int la, lb;
      bool spa, spb;
      exblas::decode_anchored(va[u], ma, la, spa);
      exblas::decode_anchored(vb[u], mb, lb, spb);
      const int sha = la - base_a;
      const int shb = lb - base_b;
      const bool in_a = sha >= 0 && sha <= kWin - 53;
      const bool in_b = shb >= 0 && shb <= kWin - 53;
      bad = bad || spa || spb || (ma != 0ULL && !in_a) ||
            (mb != 0ULL && !in_b);
      const bool add = ma != 0ULL && mb != 0ULL && in_a && in_b;
      const int s = add ? sha + shb : 0;
      const unsigned long long pa = add ? ma : 0ULL;
      const unsigned long long lo = pa * mb;
      const unsigned long long hi = __umul64hi(pa, mb);  // < 2^42
      const int r = s & 31;
      const unsigned long long w0 = lo << r;
      const unsigned long long w1 = (hi << r) | (r != 0 ? lo >> (64 - r) : 0);
      const unsigned long long w2 = r != 0 ? hi >> (64 - r) : 0ULL;
      const unsigned int y[5] = {
          static_cast<unsigned int>(w0), static_cast<unsigned int>(w0 >> 32),
          static_cast<unsigned int>(w1), static_cast<unsigned int>(w1 >> 32),
          static_cast<unsigned int>(w2)};
      exblas::add_to_frame<kNW, 5, 3>(sums, negs, y, s >> 5,
                                      add && ((va[u] ^ vb[u]) < 0));
    }
  }
  exblas::flush_frame<kNW>(sums, negs, bad, ws);
}

}  // namespace

extern "C" {

// a, b: n float64 values each (read as int64 bits); ea, eb: one int32 each
// on the device; ws: 12 int64, zeroed by the caller.  Adds the word sums
// D_0..D_9 (word d at frame bit 32 d), minus the negative count (at bit
// 320), and the flag.
int dot_flat_cuda(const void* a, const void* b, long long n, const void* ea,
                  const void* eb, void* ws, void* stream) {
  int grid = 0;
  cudaError_t err = exblas::deposit_grid(n, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  dot_flat_kernel<<<grid, exblas::kBlock, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(a), static_cast<const long long*>(b), n,
      static_cast<const int*>(ea), static_cast<const int*>(eb),
      static_cast<unsigned long long*>(ws));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
