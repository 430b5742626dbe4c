// Kernel B11 on Hopper: the exact sum of every element covered by one
// global anchored window of W = 32 * nwa bits (nwa in {3, 4, 5}), a flag
// for any element it does not cover, and the sum rounded once.
//
// Replaces exblas_tpu/ops/kernels/sum_mxu.py::_sum_epilogue_terms
// (_sum_flat_kernel) and, after it, the term rounding B3
// (round_in_kernel.py::round_scaled_terms).  The TPU kernel shifted each
// element into the window and summed its byte planes with one int8 MXU
// matmul per 32-bit word, because the TPU's vector unit could not decode
// and add fast enough.  Which elements are covered, and the flag, follow
// anchored.cuh (sum_mxu.py:216-218, gemv_mxu.py:367-377).
//
// Bound on the H100: 8 bytes read per element, so device memory (3.35
// TB/s) is the bound: 2^24 elements in about 40 us.  An SM then has about
// 80 issue slots a warp-wide element on each scheduler, half of them for
// the integer pipe, so the work an element must be short and must not
// grow with the window.  The design:
//   * one persistent launch, its grid as many blocks as the occupancy
//     calculator lets every SM hold, each thread streaming x in 16-byte
//     loads, the next step's issued before the current step is added, and
//     where x starts 8 bytes off 16 its first element taken alone
//     (stream.cuh, B2's loop);
//   * each thread adds its elements' words into its own int64 sums of
//     the frame's nwa + 1 words, positive and negative elements apart, in
//     shared memory, indexed by the element's word (anchored.cuh
//     SumFrame): three 64-bit read-modify-writes an element at every
//     window, with no negation over the frame and no shifter over its
//     words;
//   * a block sums its threads' words as int64 (warp shuffles, then shared
//     memory) and adds them to the workspace by one integer atomic a word;
//     the last block to arrive (a ticket) carries the sums into canonical
//     terms and rounds them on one thread (round.cuh finish_frame, B3's
//     device code) at e = E + 1 - W, E read on the device: a window pass
//     is one launch after the workspace's zeroing.
// Integer addition is associative, so neither the terms nor the bits
// depend on the grid, the load width or the order of the atomics.
#include <cuda_runtime.h>

#include <cstdint>

#include "anchored.cuh"
#include "round.cuh"
#include "stream.cuh"
#include "warpacc.cuh"  // warp_sum

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerStep = 4;           // elements a thread adds a step
constexpr int kUnits = kPerStep / 2;  // 16-byte loads a thread a step

// x: n <= 2^30 elements; the first `head` (0 or 1) of them apart, then nu
// pairs from x + head (16-byte aligned), then the element past head + 2 nu
// (at most one) apart.  ws: the nwa + 1 sums, then terms; the flag; the
// bits; the ticket.
template <int NW>
__global__ void __launch_bounds__(kThreads, 3)
    sum_window_kernel(const long long* __restrict__ x, int n, int head,
                      const int* __restrict__ anchor,
                      long long* __restrict__ ws) {
  using Frame = exblas::SumFrame<NW, kThreads>;
  constexpr int kWords = NW + 1;
  constexpr int kTicket = NW + 3;
  __shared__ unsigned long long s_frame[Frame::kShared];
  __shared__ long long s_part[kWarps * kWords];  // [warp][word]
  __shared__ bool s_last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nu = (n - head) / 2;
  const int tail = head + nu * 2;  // the element left over, if < n
  const int threads = static_cast<int>(gridDim.x) * kThreads;
  const int tid = static_cast<int>(blockIdx.x * kThreads + threadIdx.x);
  const int e = *anchor;

  Frame acc;
  acc.init(e, s_frame);
  if (blockIdx.x == 0 && threadIdx.x < 2) {  // the head and the tail element
    const int i = threadIdx.x == 0 ? (head ? 0 : n) : tail;
    if (i < n) acc.add(x[i]);
  }
  exblas::stream_units<kUnits>(
      reinterpret_cast<const longlong2*>(x + head), nu, threads, tid,
      [&](const longlong2 (&cur)[kUnits], int) {
#pragma unroll
        for (int u = 0; u < kUnits; ++u) {
          acc.add(cur[u].x);
          acc.add(cur[u].y);
        }
      });
  // the threads' words, summed over the warp, then the block
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const long long v = exblas::warp_sum(acc.word(k));
    if (lane == 0) s_part[warp * kWords + k] = v;
  }
  const int any_bad = __syncthreads_or(acc.flagged() ? 1 : 0);
  if (threadIdx.x < kWords) {
    long long v = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += s_part[w * kWords + threadIdx.x];
    if (v != 0LL) {
      atomicAdd(reinterpret_cast<unsigned long long*>(ws + threadIdx.x),
                static_cast<unsigned long long>(v));
    }
  }
  if (threadIdx.x == 0 && any_bad) {
    atomicOr(reinterpret_cast<unsigned long long*>(ws + kWords), 1ULL);
  }
  __threadfence();  // this block's sums are in ws before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(reinterpret_cast<unsigned*>(ws + kTicket), 1u) ==
             gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (threadIdx.x < kWords) s_part[threadIdx.x] = __ldcg(ws + threadIdx.x);
  __syncthreads();
  if (threadIdx.x != 0) return;
  // the frames are summed: their shared memory holds the rounding's limbs
  exblas::finish_frame<kWords>(s_part, reinterpret_cast<long long*>(s_frame),
                               e + 1 - 32 * NW, ws);
}

template <int NW>
int launch(const void* x, long long n, const void* anchor, void* ws,
           cudaStream_t s) {
  const int head =
      (reinterpret_cast<uintptr_t>(x) & 15) != 0 && n > 0 ? 1 : 0;
  const long long want = ((n - head) / 2 + kThreads * kUnits - 1) /
                         (kThreads * kUnits);
  int grid = 0;
  const cudaError_t err = exblas::persistent_grid(
      reinterpret_cast<const void*>(sum_window_kernel<NW>), kThreads, want,
      &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_window_kernel<NW><<<grid, kThreads, 0, s>>>(
      static_cast<const long long*>(x), static_cast<int>(n), head,
      static_cast<const int*>(anchor), static_cast<long long*>(ws));
  return static_cast<int>(cudaGetLastError());
}

const void* kernel_of(int nwa) {
  switch (nwa) {
    case 3:
      return reinterpret_cast<const void*>(sum_window_kernel<3>);
    case 4:
      return reinterpret_cast<const void*>(sum_window_kernel<4>);
    case 5:
      return reinterpret_cast<const void*>(sum_window_kernel<5>);
    default:
      return nullptr;
  }
}

}  // namespace

extern "C" {

// x: n <= 2^30 float64 values (read as int64 bits, 8-byte aligned); anchor: one
// int32 on the device, E; ws: nwa + 4 int64, zeroed by the caller.  Writes
// the canonical terms T_0..T_nwa (term k at frame bit 32 k: T_k in
// [0, 2^32) for k < nwa, T_nwa the value >> 32 nwa) to ws[0..nwa], the
// flag to ws[nwa + 1] and the bits of the sum rounded once to ws[nwa + 2];
// ws[nwa + 3] is the ticket.
int sum_flat_cuda(const void* x, long long n, const void* anchor, int nwa,
                  void* ws, void* stream) {
  if (n < 0 || n > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
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

// out[0..3] = registers a thread, local (spilled) bytes, static shared
// bytes and resident blocks an SM of the kernel at window nwa.
int sum_flat_attrs(int nwa, void* out) {
  const void* fn = kernel_of(nwa);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      exblas::kernel_attrs(fn, kThreads, static_cast<int*>(out)));
}

}  // extern "C"
