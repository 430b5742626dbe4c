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
// Bound on the H100: the stream reads 8 bytes per element, so HBM
// bandwidth (3.35 TB/s) is the natural bound: 2^24 elements are 128 MiB,
// about 40 us.  At that pace an SM has about 70 cycles a warp-wide element
// on each of its four schedulers, half of them for the integer pipe, so
// the hit path is kept near 30 instructions an element.  The design:
//   * one persistent launch, its grid as many blocks as the occupancy
//     calculator lets every SM hold (stream.cuh);
//   * every thread streams x with 16-byte loads, kPerStep elements a step
//     (4 loads: 48 KB in flight an SM at three blocks), the next step's
//     loads issued before the current step is decoded; where x starts 8
//     bytes off 16 its first element is taken alone;
//   * each element is added to its warp's accumulator (warpacc.cuh
//     SumAcc): a normal double whose LSB falls in the warp's 64-bit hit
//     range goes straight into a 160-bit register window by one carry
//     chain; others (misses, subnormals) in a second pass only where a
//     lane needs it, digit by digit into int32 shared limbs by native
//     32-bit atomics, spilled into the warp's int64 limbs every
//     kSpillSteps steps; NaN/+Inf/-Inf are counted and, like zeros,
//     deposit nothing;
//   * a block adds its warps' limbs and counts and merges them into the
//     global workspace by 64-bit global integer atomics (native); the last
//     block to arrive (a ticket counter) exports or rounds the sum
//     (round.cuh finish), so a call is one launch after the workspace's
//     zeroing.
// Integer addition is associative, so the result does not depend on the
// grid, the load width or the order of the atomics.  No floating-point
// arithmetic touches the data.
#include <cuda_runtime.h>

#include <cstdint>

#include "deposit.cuh"
#include "round.cuh"
#include "stream.cuh"
#include "warpacc.cuh"

namespace {

using exblas::kSumLimbs;

constexpr int kSumOffset = 1074;  // SUM_FORMAT.offset_bits
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerStep = 8;  // elements a thread adds a step
constexpr int kUnits = kPerStep / 2;  // 16-byte loads a thread a step
constexpr int kWs = kSumLimbs + 3;  // limbs, NaN, +Inf, -Inf; then the ticket

using Acc = exblas::SumAcc<kPerStep>;

// x: n elements; the first `head` (0 or 1) of them apart, then nu pairs
// from x + head (16-byte aligned), then the element past head + 2 nu (at
// most one) apart.
__global__ void __launch_bounds__(kThreads, 3)
    sum_warp_kernel(const long long* __restrict__ x, long long n, int head,
                    long long* __restrict__ ws, int* limbs_out,
                    int* special_out, unsigned long long* bits_out) {
  __shared__ int s32[kWarps][exblas::kSumWarpLimbs];
  __shared__ long long s64[kWarps][exblas::kSumWarpLimbs];
  __shared__ long long s_cnt[kWarps][3];
  __shared__ bool s_last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long nu = (n - head) / 2;
  const long long tail = head + nu * 2;  // the element left over, if < n
  const long long threads = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  const long long per_step = kUnits * threads;
  const long long steps = (nu + per_step - 1) / per_step;  // grid-uniform
  const longlong2* px = reinterpret_cast<const longlong2*>(x + head);

  Acc acc;
  acc.init(s32[warp], s64[warp]);
  if (blockIdx.x == 0 && warp == 0) {  // the head and the tail element
    const long long i = lane == 0 && head ? 0 : (lane == 1 ? tail : n);
    acc.add_one(i < n ? x[i] : 0LL);
    acc.spill();
  }
  longlong2 cur[kUnits];
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const long long i = u * threads + tid;
    cur[u] = i < nu ? __ldcs(px + i) : make_longlong2(0LL, 0LL);
  }
#pragma unroll 1
  for (long long s = 0; s < steps; ++s) {
    longlong2 nxt[kUnits];
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const long long i = (s + 1) * per_step + u * threads + tid;
      nxt[u] = i < nu ? __ldcs(px + i) : make_longlong2(0LL, 0LL);
    }
    if (acc.unplaced()) {
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        acc.place(cur[u].x);
        acc.place(cur[u].y);
      }
    }
    unsigned rare = 0u;
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      rare |= static_cast<unsigned>(acc.add_hit(cur[u].x)) << (2 * u);
      rare |= static_cast<unsigned>(acc.add_hit(cur[u].y)) << (2 * u + 1);
    }
    if (__any_sync(exblas::kFullMask, rare != 0u)) {
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        acc.add_rare(cur[u].x, (rare >> (2 * u)) & 1u);
        acc.add_rare(cur[u].y, (rare >> (2 * u + 1)) & 1u);
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
      v += j < kSumLimbs ? s64[w][j] : s_cnt[w][j - kSumLimbs];
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
  exblas::finish<kSumLimbs>(sum, kSumOffset, limbs_out, special_out,
                            bits_out);
}

int launch(const void* x, long long n, void* ws, void* limbs_out,
           void* special_out, void* bits_out, void* stream) {
  const int head =
      (reinterpret_cast<uintptr_t>(x) & 15) != 0 && n > 0 ? 1 : 0;
  const long long want = ((n - head) / 2 + kThreads * kUnits - 1) /
                         (kThreads * kUnits);
  int grid = 0;
  const cudaError_t err = exblas::persistent_grid(
      reinterpret_cast<const void*>(sum_warp_kernel), kThreads, want, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_warp_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(x), n, head, static_cast<long long*>(ws),
      static_cast<int*>(limbs_out), static_cast<int*>(special_out),
      static_cast<unsigned long long*>(bits_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: n float64 values (read as int64 bits, 8-byte aligned).  ws: 116
// int64 (115 sums and the ticket), zeroed by the caller.  Writes 112
// canonical int32 limbs and 3 int32 special counts.
int exsum_acc_cuda(const void* x, long long n, void* ws, void* limbs_out,
                   void* special_out, void* stream) {
  return launch(x, n, ws, limbs_out, special_out, nullptr, stream);
}

// As exsum_acc_cuda, but writes the correctly rounded binary64 bits.
int exsum_bits_cuda(const void* x, long long n, void* ws, void* bits_out,
                    void* stream) {
  return launch(x, n, ws, nullptr, nullptr, bits_out, stream);
}

// out[0..3] = registers a thread, local (spilled) bytes, static shared
// bytes and resident blocks an SM of the kernel.
int exsum_attrs(void* out) {
  return static_cast<int>(exblas::kernel_attrs(
      reinterpret_cast<const void*>(sum_warp_kernel), kThreads,
      static_cast<int*>(out)));
}

}  // extern "C"
