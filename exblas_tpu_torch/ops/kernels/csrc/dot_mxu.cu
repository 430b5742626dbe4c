// Kernel B12 on Hopper: the exact dot product of two vectors, each
// covered by its own anchored window of 160 bits, a flag for any element
// that its window does not cover, and the dot rounded once.
//
// Replaces exblas_tpu/ops/kernels/dot_mxu.py::_run_dot_kernel
// (_dot_flat_kernel) and, after it, the term rounding B3
// (round_in_kernel.py::round_scaled_terms).  The TPU kernel stacked both
// vectors' byte planes, sign masks and a ones row and formed every cross
// sum with one int8 MXU matmul per block (7/8 of its output discarded),
// because its vector unit could not build 106-bit products fast enough.  On Hopper each thread
// forms the exact product of two 53-bit significands (four 32-bit
// multiplies; never TwoProdFMA, whose residual underflows) and adds it,
// shifted, to a frame of word sums of its own.
//
// Side a: significand ma, lowest-bit exponent ea_lsb, shift
// sha = ea_lsb - (EA + 1 - 160), covered when finite and 0 <= sha <= 107;
// side b alike.  Each side is checked on its own (dot_mxu.py:138-139 calls
// _stack_planes once per side), so a zero a_i does not hide a b_i outside
// b's window; NaN/Inf set the flag.  Only pairs covered on both sides are
// added, so the terms are the exact dot of those pairs, flag or not.  A
// covered product ma * mb < 2^106 sits at bit s = sha + shb in [0, 214]
// of the frame whose bit 0 has exponent EA + EB + 2 - 320
// (dot_mxu.py:214-215): five 32-bit words y_0..y_4 of ma * mb << (s % 32),
// at frame words s / 32 + j <= 10.
//
// Bound on the H100: 16 bytes read per pair, 0.08 ms at 2^24 pairs, about
// 140 cycles a warp-wide pair on each of an SM's four schedulers.  The
// placement at a word chosen per pair is what costs: in registers it takes
// a shifter over the whole frame and a negation through all its words.
// Here each thread's frame lives in shared memory, indexed by the pair's
// word: 11 int64 sums of the positive products' words and 11 of the
// negative ones', lane-private (word-major, so a warp's accesses never
// conflict), so a pair is five 64-bit read-modify-writes and no negation.
// The design:
//   * one persistent launch, its grid as many blocks as the occupancy
//     calculator lets every SM hold (stream.cuh);
//   * both vectors in 16-byte loads one step ahead (8-byte loads where
//     their offsets differ mod 16; a pair apart where both start 8 bytes
//     off 16);
//   * a block adds its threads' sums, positive minus negative, to the
//     global workspace by one int64 atomic a word; the last block to
//     arrive (a ticket) carries the 11 sums into canonical terms: term k
//     in [0, 2^32) at bit 32 k for k < 10, term 10 = the value >> 320
//     (signed), and rounds them once on one thread, its limbs in the
//     frame's shared memory (round.cuh finish_frame, B3's device code) at
//     e = EA + EB + 2 - 320, read on the device: a window pass is one
//     launch after the workspace's zeroing.  The terms are the exact
//     value's digits, so neither they nor the bits depend on the grid, the
//     load width or the order of the atomics.
// Headroom: a word is below 2^32 and n <= 2^31 (MAX_N_DOT_MXU), so every
// sum of one sign's words stays below 2^63; the value is below
// 2^(320 + 31), so term 10 is an int32.
#include <cuda_runtime.h>

#include <cstdint>

#include "round.cuh"
#include "stream.cuh"
#include "warpacc.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerStep = 4;  // pairs a thread adds a step
constexpr int kNW = 10;      // 32-bit words of the 320-bit frame
constexpr int kWin = 160;    // each side's window
constexpr int kMaxSh = kWin - 53;   // the largest covered shift
constexpr int kSlots = kNW + 1;     // a sign's word sums, term 10 included
constexpr int kFlag = kSlots;       // ws: the terms, the flag, the bits,
constexpr int kTicket = kSlots + 2;  // the ticket
constexpr unsigned long long kFrac = (1ULL << 52) - 1ULL;

// One thread's pairs: the word sums at frame[k * kThreads] (positive
// products, k < kSlots) and frame[(kSlots + k) * kThreads] (negative).
struct PairFrame {
  unsigned long long* frame;
  int ca, cb;               // sha = max(expf, 1) - ca, likewise b
  unsigned long long bad;   // nonzero: an uncovered nonzero element
  int exm;                  // the largest exponent field: 0x7FF flags NaN/Inf

  __device__ __forceinline__ void add(long long a, long long b) {
    const int exa = static_cast<int>((a >> 52) & 0x7FF);
    const int exb = static_cast<int>((b >> 52) & 0x7FF);
    const int sha = (exa > 1 ? exa : 1) - ca;
    const int shb = (exb > 1 ? exb : 1) - cb;
    const bool in_a = static_cast<unsigned>(sha) <= kMaxSh && exa != 0x7FF;
    const bool in_b = static_cast<unsigned>(shb) <= kMaxSh && exb != 0x7FF;
    if (!in_a) bad |= static_cast<unsigned long long>(a) << 1;
    if (!in_b) bad |= static_cast<unsigned long long>(b) << 1;
    exm = max(exm, max(exa, exb));
    const bool add = in_a && in_b;
    const unsigned long long ma =
        add ? (static_cast<unsigned long long>(a) & kFrac) |
                  (exa != 0 ? 1ULL << 52 : 0ULL)
            : 0ULL;
    const unsigned long long mb = (static_cast<unsigned long long>(b) & kFrac) |
                                  (exb != 0 ? 1ULL << 52 : 0ULL);
    const int s = add ? sha + shb : 0;
    unsigned long long lo, hi;
    exblas::mul53(ma, mb, lo, hi);  // hi < 2^42
    const unsigned r = static_cast<unsigned>(s) & 31u;
    const unsigned p0 = static_cast<unsigned>(lo);
    const unsigned p1 = static_cast<unsigned>(lo >> 32);
    const unsigned p2 = static_cast<unsigned>(hi);
    const unsigned p3 = static_cast<unsigned>(hi >> 32);
    unsigned long long* f =
        frame + ((s >> 5) + ((a ^ b) < 0 ? kSlots : 0)) * kThreads;
    f[0] += p0 << r;
    f[kThreads] += __funnelshift_l(p0, p1, r);
    f[2 * kThreads] += __funnelshift_l(p1, p2, r);
    f[3 * kThreads] += __funnelshift_l(p2, p3, r);
    f[4 * kThreads] += __funnelshift_l(p3, 0u, r);
  }
};

// a, b: n elements; the first `head` (0 or 1) of them apart, then nu
// units of W elements from a + head, b + head (16-byte aligned when W ==
// 2), then the elements past head + nu * W (at most one) apart.
template <int W>
__global__ void __launch_bounds__(kThreads, 3)
    dot_frame_kernel(const long long* __restrict__ a,
                     const long long* __restrict__ b, long long n, int head,
                     const int* __restrict__ ea, const int* __restrict__ eb,
                     long long* __restrict__ ws) {
  constexpr int kUnits = kPerStep / W;  // loads of each vector a step
  __shared__ unsigned long long s_frame[2 * kSlots * kThreads];
  __shared__ long long s_part[kWarps][kSlots];
  __shared__ bool s_last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long nu = (n - head) / W;
  const long long tail = head + nu * W;  // the element left over, if < n
  const long long threads = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  const long long per_step = kUnits * threads;
  const long long* pa = a + head;
  const long long* pb = b + head;

  PairFrame acc;
  acc.frame = s_frame + threadIdx.x;
  // sha = max(expf, 1) - 1075 - (EA + 1 - 160)
  acc.ca = *ea + 1075 + 1 - kWin;
  acc.cb = *eb + 1075 + 1 - kWin;
  acc.bad = 0ULL;
  acc.exm = 0;
#pragma unroll
  for (int k = 0; k < 2 * kSlots; ++k) acc.frame[k * kThreads] = 0ULL;
  if (blockIdx.x == 0 && threadIdx.x < 2) {  // the head and the tail pair
    const long long i = threadIdx.x == 0 ? (head ? 0 : n) : tail;
    if (i < n) acc.add(a[i], b[i]);
  }
  exblas::PairUnit<W> cur[kUnits];
#pragma unroll
  for (int u = 0; u < kUnits; ++u) cur[u].load(pa, pb, u * threads + tid, nu);
#pragma unroll 1
  for (long long base = 0; base < nu; base += per_step) {
    exblas::PairUnit<W> nxt[kUnits];
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      nxt[u].load(pa, pb, base + per_step + u * threads + tid, nu);
    }
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
#pragma unroll
      for (int j = 0; j < W; ++j) acc.add(cur[u].av(j), cur[u].bv(j));
    }
#pragma unroll
    for (int u = 0; u < kUnits; ++u) cur[u] = nxt[u];
  }
  // this thread's signed word sums, summed over the warp, then the block
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const long long v = exblas::warp_sum(static_cast<long long>(
        acc.frame[k * kThreads] - acc.frame[(kSlots + k) * kThreads]));
    if (lane == 0) s_part[warp][k] = v;
  }
  const int any_bad =
      __syncthreads_or(acc.bad != 0ULL || acc.exm == 0x7FF ? 1 : 0);
  if (threadIdx.x < kSlots) {
    long long v = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += s_part[w][threadIdx.x];
    if (v != 0LL) {
      atomicAdd(reinterpret_cast<unsigned long long*>(ws + threadIdx.x),
                static_cast<unsigned long long>(v));
    }
  }
  if (threadIdx.x == 0 && any_bad) {
    atomicOr(reinterpret_cast<unsigned long long*>(ws + kFlag), 1ULL);
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
  // the sums read at once, then one thread's carry pass and rounding
  if (threadIdx.x < kSlots) s_part[0][threadIdx.x] = __ldcg(ws + threadIdx.x);
  __syncthreads();
  if (threadIdx.x != 0) return;
  exblas::finish_frame<kSlots>(s_part[0],
                               reinterpret_cast<long long*>(s_frame),
                               *ea + *eb + 2 - 2 * kWin, ws);
}

template <int W>
int launch_w(const long long* a, const long long* b, long long n, int head,
             const int* ea, const int* eb, long long* ws, cudaStream_t s) {
  const long long units = (n - head) / W;
  const long long want = (units + kThreads * (kPerStep / W) - 1) /
                         (kThreads * (kPerStep / W));
  int grid = 0;
  const cudaError_t err = exblas::persistent_grid(
      reinterpret_cast<const void*>(dot_frame_kernel<W>), kThreads, want,
      &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  dot_frame_kernel<W><<<grid, kThreads, 0, s>>>(a, b, n, head, ea, eb, ws);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// a, b: n float64 values each (read as int64 bits, 8-byte aligned); ea,
// eb: one int32 each on the device; ws: 14 int64, zeroed by the caller.
// Writes the canonical terms T_0..T_10 (term k at frame bit 32 k) to
// ws[0..10], the flag to ws[11] and the bits of the dot rounded once to
// ws[12]; ws[13] is the ticket.
int dot_flat_cuda(const void* a, const void* b, long long n, const void* ea,
                  const void* eb, void* ws, void* stream) {
  const auto pa = static_cast<const long long*>(a);
  const auto pb = static_cast<const long long*>(b);
  const uintptr_t ra = reinterpret_cast<uintptr_t>(a) & 15;
  const uintptr_t rb = reinterpret_cast<uintptr_t>(b) & 15;
  const auto pea = static_cast<const int*>(ea);
  const auto peb = static_cast<const int*>(eb);
  auto w = static_cast<long long*>(ws);
  auto s = static_cast<cudaStream_t>(stream);
  if (ra == rb) {
    return launch_w<2>(pa, pb, n, ra != 0 && n > 0 ? 1 : 0, pea, peb, w, s);
  }
  return launch_w<1>(pa, pb, n, 0, pea, peb, w, s);
}

// out[0..3] = registers a thread, local (spilled) bytes, static shared
// bytes and resident blocks an SM of the kernel: which 0 with 16-byte
// loads, 1 with 8-byte loads.
int dot_flat_attrs(int which, void* out) {
  const void* fn = which == 0
                       ? reinterpret_cast<const void*>(dot_frame_kernel<2>)
                       : reinterpret_cast<const void*>(dot_frame_kernel<1>);
  return static_cast<int>(
      exblas::kernel_attrs(fn, kThreads, static_cast<int*>(out)));
}

}  // extern "C"
