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
// elements are 256 MiB, about 80 us.  The design:
//   * one persistent launch, its grid as many blocks as the occupancy
//     calculator lets every SM hold;
//   * every thread streams both vectors with 16-byte loads (8-byte loads
//     where the two start at different offsets mod 16; an element apart
//     where both start 8 bytes off 16), kUnits loads of each a step, the
//     next step's loads issued before the current step is decoded;
//   * each product is formed exactly (__umul64hi) and added to its warp's
//     accumulator (warpacc.cuh): straight through into the warp's register
//     window when it falls there, else, in a second pass only where a lane
//     needs it, digit by digit into int32 shared limbs by native 32-bit
//     atomics, spilled into the warp's int64 limbs every kSpillSteps steps;
//   * specials follow exblas_tpu/core/deposit.py:181-234: NaN or 0*Inf gives
//     NaN, Inf times a finite nonzero gives Inf with the xor of the signs,
//     and a zero or special deposits nothing;
//   * a block adds its warps' limbs and counts and merges them into the
//     global workspace by 64-bit global integer atomics (native); the last
//     block to arrive (a ticket counter) exports or rounds the sum
//     (round.cuh finish: one thread walks only the range of nonzero
//     limbs), so a call is one launch after the workspace's zeroing.
#include <cuda_runtime.h>

#include <cstdint>

#include "deposit.cuh"
#include "round.cuh"
#include "stream.cuh"
#include "warpacc.cuh"

namespace {

using exblas::kDotLimbs;
using exblas::kDotOffset;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerStep = 4;  // products a thread adds a step
constexpr int kWs = kDotLimbs + 3;  // limbs, NaN, +Inf, -Inf; then the ticket

using Acc = exblas::WarpAcc<kPerStep>;

// a, b: n elements; the first `head` (0 or 1) of them apart, then nu
// units of W elements from a + head, b + head (16-byte aligned when W ==
// 2), then the elements past head + nu * W (at most one) apart.
template <int W>
__global__ void __launch_bounds__(kThreads, 2)
    dot_warp_kernel(const long long* __restrict__ a,
                    const long long* __restrict__ b, long long n, int head,
                    long long* __restrict__ ws, int* limbs_out,
                    int* special_out, unsigned long long* bits_out) {
  constexpr int kUnits = kPerStep / W;  // loads of each vector a step
  __shared__ int s32[kWarps][exblas::kWarpLimbs];
  __shared__ long long s64[kWarps][exblas::kWarpLimbs];
  __shared__ long long s_cnt[kWarps][3];
  __shared__ bool s_last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long nu = (n - head) / W;
  const long long tail = head + nu * W;  // the element left over, if < n
  const long long threads = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  const long long per_step = kUnits * threads;
  const long long steps = (nu + per_step - 1) / per_step;  // grid-uniform
  const long long* pa = a + head;
  const long long* pb = b + head;

  Acc acc;
  acc.init(s32[warp], s64[warp]);
  if (blockIdx.x == 0 && warp == 0) {  // the head and the tail element
    const long long i = lane == 0 && head ? 0 : (lane == 1 ? tail : n);
    acc.add_one(i < n ? a[i] : 0LL, i < n ? b[i] : 0LL);
    acc.spill();
  }
  exblas::PairUnit<W> cur[kUnits];
#pragma unroll
  for (int u = 0; u < kUnits; ++u) cur[u].load(pa, pb, u * threads + tid, nu);
#pragma unroll 1
  for (long long s = 0; s < steps; ++s) {
    exblas::PairUnit<W> nxt[kUnits];
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      nxt[u].load(pa, pb, (s + 1) * per_step + u * threads + tid, nu);
    }
    if (acc.unplaced()) {
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
#pragma unroll
        for (int j = 0; j < W; ++j) acc.place(cur[u].av(j), cur[u].bv(j));
      }
    }
    unsigned rare = 0u;
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
#pragma unroll
      for (int j = 0; j < W; ++j) {
        rare |= static_cast<unsigned>(acc.add_hit(cur[u].av(j), cur[u].bv(j)))
                << (u * W + j);
      }
    }
    if (__any_sync(exblas::kFullMask, rare != 0u)) {
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
#pragma unroll
        for (int j = 0; j < W; ++j) {
          acc.add_rare(cur[u].av(j), cur[u].bv(j), (rare >> (u * W + j)) & 1u);
        }
      }
    }
    if ((s + 1) % Acc::kSpillSteps == 0) acc.spill();
#pragma unroll
    for (int u = 0; u < kUnits; ++u) cur[u] = nxt[u];
  }
  acc.flush();
  long long nan_t, pinf_t, ninf_t;
  acc.special_totals(nan_t, pinf_t, ninf_t);
  if (lane < 3) {
    s_cnt[warp][lane] = lane == 0 ? nan_t : (lane == 1 ? pinf_t : ninf_t);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < kWs; j += kThreads) {
    long long v = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      v += j < kDotLimbs ? s64[w][j] : s_cnt[w][j - kDotLimbs];
    }
    if (v != 0LL) {
      atomicAdd(reinterpret_cast<unsigned long long*>(ws + j),
                static_cast<unsigned long long>(v));
    }
  }
  __threadfence();  // this block's sums are in ws before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(reinterpret_cast<unsigned*>(ws + kWs), 1u) ==
             gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  long long* sum = s64[0];
  for (int j = threadIdx.x; j < kWs; j += kThreads) sum[j] = __ldcg(ws + j);
  __syncthreads();
  exblas::finish<kDotLimbs>(sum, kDotOffset, limbs_out, special_out,
                            bits_out);
}

template <int W>
int launch_w(const long long* a, const long long* b, long long n, int head,
             long long* ws, int* limbs_out, int* special_out,
             unsigned long long* bits_out, cudaStream_t s) {
  const long long units = (n - head) / W;
  const long long want = (units + kThreads * (kPerStep / W) - 1) /
                         (kThreads * (kPerStep / W));
  int grid = 0;
  const cudaError_t err = exblas::persistent_grid(
      reinterpret_cast<const void*>(dot_warp_kernel<W>), kThreads, want,
      &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  dot_warp_kernel<W><<<grid, kThreads, 0, s>>>(a, b, n, head, ws, limbs_out,
                                                special_out, bits_out);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* a, const void* b, long long n, void* ws,
           void* limbs_out, void* special_out, void* bits_out,
           void* stream) {
  const auto pa = static_cast<const long long*>(a);
  const auto pb = static_cast<const long long*>(b);
  const uintptr_t ra = reinterpret_cast<uintptr_t>(a) & 15;
  const uintptr_t rb = reinterpret_cast<uintptr_t>(b) & 15;
  auto w = static_cast<long long*>(ws);
  auto lo = static_cast<int*>(limbs_out);
  auto so = static_cast<int*>(special_out);
  auto bo = static_cast<unsigned long long*>(bits_out);
  auto s = static_cast<cudaStream_t>(stream);
  if (ra == rb) {
    return launch_w<2>(pa, pb, n, ra != 0 && n > 0 ? 1 : 0, w, lo, so, bo, s);
  }
  return launch_w<1>(pa, pb, n, 0, w, lo, so, bo, s);
}

}  // namespace

extern "C" {

// a, b: n float64 values each (read as int64 bits, 8-byte aligned).  ws:
// 220 int64 (219 sums and the ticket), zeroed by the caller.  Writes 216
// canonical int32 limbs and 3 int32 counts.
int exdot_acc_cuda(const void* a, const void* b, long long n, void* ws,
                   void* limbs_out, void* special_out, void* stream) {
  return launch(a, b, n, ws, limbs_out, special_out, nullptr, stream);
}

// As exdot_acc_cuda, but writes the correctly rounded binary64 bits.
int exdot_bits_cuda(const void* a, const void* b, long long n, void* ws,
                    void* bits_out, void* stream) {
  return launch(a, b, n, ws, nullptr, nullptr, bits_out, stream);
}

// out[0..3] = registers a thread, local (spilled) bytes, static shared
// bytes and resident blocks an SM of the deposit kernel: which 0 with
// 16-byte loads, 1 with 8-byte loads.
int exdot_attrs(int which, void* out) {
  const void* fn = which == 0
                       ? reinterpret_cast<const void*>(dot_warp_kernel<2>)
                       : reinterpret_cast<const void*>(dot_warp_kernel<1>);
  return static_cast<int>(
      exblas::kernel_attrs(fn, kThreads, static_cast<int*>(out)));
}

}  // extern "C"
