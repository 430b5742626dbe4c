// Exact ExGEMV row accumulators on Hopper, any data: for each row i of A
// (m, k) the exact sum of the 106-bit products a[i,k] * z[k] in a
// DOT_FORMAT superaccumulator (216 int64 limbs of 20 bits, bit 0 at
// 2^-2148) and the row's NaN, +Inf and -Inf counts, in the JAX layout.
//
// Replaces exblas_tpu/ops/kernels/gemv_kernel.py: gemv_rows_acc_pallas
// (_gemv_kernel).  The TPU kernel reads A transposed (k in sublanes, 128
// rows in lanes), broadcasts z to (k, 128), and keeps 8 int32 phase
// sub-accumulators per limb with a _renorm8 carry pass, all because its
// lanes are int32 only.  Here rows of A are contiguous and a warp owns a
// row:
//   * a block of up to kMaxWarps warps takes as many consecutive rows, a
//     warp each, over one span of k; z's span is staged in shared memory
//     by chunks of kChunk (cp.async, two buffers), once for all the
//     block's rows;
//   * a lane streams its row with 16-byte loads (a scalar head where the
//     row starts 8 bytes off 16), kPairs of them a step, the next step's
//     loads issued before the current step is decoded;
//   * each product is formed exactly (__umul64hi) and added to the warp's
//     accumulator (warpacc.cuh): a step adds its products that fall in the
//     warp's register window straight through, without a branch; a second
//     pass, only where a lane needs it, adds the others digit by digit into
//     int32 shared limbs by native 32-bit atomics (spilled into the warp's
//     int64 limbs every kSpillSteps steps) and counts specials as
//     exblas_tpu/core/deposit.py does;
//   * the warp flushes its window once a row and writes the row's 216 limbs
//     and 3 counts with plain coalesced stores.  Small m with large k
//     splits k over several blocks a row so that every SM has rows; those
//     rows are added into zeroed outputs by 64-bit global integer atomics
//     (native).  Integer addition is associative, so neither the split nor
//     the order of the atomics changes a bit.
// The geometry (warps a block, splits, span) comes from the wrapper,
// ops/kernels/gemv_kernel.py row_geometry.
//
// Bound on the H100: A's bytes.  8 bytes per element of A: 537 MB at
// 8192^2, 0.160 ms at 3.35 TB/s.  The integer work of a product (about 11
// int32 operations at least) is 0.044 ms; the decode and the window add
// take several times that, so on data every product of which hits the
// window both are close.  On data no GEMV rung covers, most products miss
// the window and take 7 shared atomics each, which then bound it.
#include <cuda_runtime.h>

#include <cstdint>

#include "deposit.cuh"
#include "round.cuh"
#include "warpacc.cuh"

namespace {

using exblas::kDotLimbs;

constexpr int kMaxWarps = 8;            // rows of a block, one a warp
constexpr int kPairs = 2;               // 16-byte loads of a row a lane a step
constexpr int kPerStep = 2 * kPairs;    // products a lane adds a step
constexpr int kStepK = 32 * kPerStep;   // k a warp covers a step
constexpr int kChunk = 1024;            // k of z staged at once
constexpr int kChunkSteps = kChunk / kStepK;
static_assert(kChunk % kStepK == 0, "a chunk is whole steps");
// A chunk's z and one more element: a row that starts 8 bytes off 16
// takes its first element apart and reads z one element later.
constexpr int kZStage = kChunk + 1;

using Acc = exblas::WarpAcc<kPerStep>;

// An 8-byte asynchronous copy to shared memory; zero-filled where !valid.
__device__ __forceinline__ void cp_async8_zfill(void* dst, const void* src,
                                                bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   exblas::smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Elements e, e + 1 of a row of len elements from a 16-byte aligned start;
// zeros past the end.
__device__ __forceinline__ longlong2 load_pair(const long long* row,
                                               long long e, long long len) {
  if (e + 1 < len) return __ldcs(reinterpret_cast<const longlong2*>(row + e));
  longlong2 v;
  v.x = e < len ? __ldcs(row + e) : 0LL;
  v.y = 0LL;
  return v;
}

// Three resident blocks an SM (at most 85 registers a thread): more warps
// to hide the loads and the products' latency than two (scripts/
// deposit_split.py times both).
__global__ void __launch_bounds__(32 * kMaxWarps, 3)
    gemv_warp_rows_kernel(const long long* __restrict__ a, long long lda,
                          const long long* __restrict__ z, long long zsign,
                          long long m, long long k, int splits,
                          long long span, long long* __restrict__ limbs,
                          long long* __restrict__ special, int accumulate) {
  __shared__ long long s_z[2][kZStage];
  __shared__ int s32[kMaxWarps][exblas::kWarpLimbs];
  __shared__ long long s64[kMaxWarps][exblas::kWarpLimbs];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long group = blockIdx.x / splits;
  const long long k0 = (blockIdx.x % splits) * span;
  const long long k1 = k0 + span < k ? k0 + span : k;
  const long long row = group * (blockDim.x >> 5) + warp;
  // A warp past m takes the steps too, on no elements: its lanes then
  // reach every warp collective together, with no branch around them.
  const bool active = row < m;  // warp-uniform
  const long long* ar = a + (active ? row : 0LL) * lda + k0;
  const int head = (reinterpret_cast<uintptr_t>(ar) & 15) != 0 ? 1 : 0;
  const long long* ap = ar + head;  // 16-byte aligned
  const long long alen = active ? (k1 - k0) - head : 0LL;  // from ap
  const long long nchunks = (k1 - k0 + kChunk - 1) / kChunk;

  // z[k0 + c * kChunk + i] for i < kZStage into buffer c & 1, zero past k1
  auto stage = [&](long long c) {
    const long long e0 = k0 + c * kChunk;
    for (int i = threadIdx.x; i < kZStage; i += blockDim.x) {
      const long long e = e0 + i;
      cp_async8_zfill(&s_z[c & 1][i], e < k1 ? z + e : z, e < k1);
    }
    cp_async_commit_group();
  };
  stage(0);

  Acc acc;
  acc.init(s32[warp], s64[warp]);
  // the row's first element, 8 bytes before ap
  const bool first = active && head && lane == 0;
  acc.add_one(first ? ar[0] : 0LL, first ? z[k0] ^ zsign : 0LL);
  acc.spill();
  longlong2 cur[kPairs];
#pragma unroll
  for (int u = 0; u < kPairs; ++u) {
    cur[u] = load_pair(ap, 2 * (lane + 32 * u), alen);
  }
  for (long long c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {
      stage(c + 1);
      cp_async_wait_groups<1>();
    } else {
      cp_async_wait_groups<0>();
    }
    __syncthreads();  // chunk c is staged
    {
      // z of the element ap[c * kChunk + i] is zs[i]
      const long long* zs = s_z[c & 1] + head;
#pragma unroll 1
      for (int s = 0; s < kChunkSteps; ++s) {
        const long long step = c * kChunkSteps + s;
        longlong2 nxt[kPairs];
#pragma unroll
        for (int u = 0; u < kPairs; ++u) {
          nxt[u] = load_pair(ap, (step + 1) * kStepK + 2 * (lane + 32 * u),
                             alen);
        }
        // z of pair u's element j; read from shared memory in each pass
        const int i0 = s * kStepK + 2 * lane;
        auto zv = [&](int u, int j) { return zs[i0 + 64 * u + j] ^ zsign; };
        if (acc.unplaced()) {
#pragma unroll
          for (int u = 0; u < kPairs; ++u) {
            acc.place(cur[u].x, zv(u, 0));
            acc.place(cur[u].y, zv(u, 1));
          }
        }
        unsigned rare = 0u;
#pragma unroll
        for (int u = 0; u < kPairs; ++u) {
          rare |= static_cast<unsigned>(acc.add_hit(cur[u].x, zv(u, 0)))
                  << 2 * u;
          rare |= static_cast<unsigned>(acc.add_hit(cur[u].y, zv(u, 1)))
                  << (2 * u + 1);
        }
        if (__any_sync(exblas::kFullMask, rare != 0u)) {
#pragma unroll
          for (int u = 0; u < kPairs; ++u) {
            acc.add_rare(cur[u].x, zv(u, 0), (rare >> 2 * u) & 1u);
            acc.add_rare(cur[u].y, zv(u, 1), (rare >> (2 * u + 1)) & 1u);
          }
        }
        if ((step + 1) % Acc::kSpillSteps == 0) acc.spill();
#pragma unroll
        for (int u = 0; u < kPairs; ++u) cur[u] = nxt[u];
      }
    }
    __syncthreads();  // buffer c & 1 is free for chunk c + 2
  }
  acc.flush();
  long long nan_t, pinf_t, ninf_t;
  acc.special_totals(nan_t, pinf_t, ninf_t);
  if (!active) return;
  long long* out = limbs + row * kDotLimbs;
#pragma unroll
  for (int j = 0; j < exblas::kWarpSlots; ++j) {
    const int l = lane + 32 * j;
    if (l >= kDotLimbs) break;
    const long long v = s64[warp][l];
    if (!accumulate) {
      out[l] = v;
    } else if (v != 0LL) {
      atomicAdd(reinterpret_cast<unsigned long long*>(out + l),
                static_cast<unsigned long long>(v));
    }
  }
  if (lane < 3) {
    const long long v = lane == 0 ? nan_t : (lane == 1 ? pinf_t : ninf_t);
    long long* dst = special + row * 3 + lane;
    if (!accumulate) {
      *dst = v;
    } else if (v != 0LL) {
      atomicAdd(reinterpret_cast<unsigned long long*>(dst),
                static_cast<unsigned long long>(v));
    }
  }
}

}  // namespace

extern "C" {

// a: (m, k) float64 with rows lda >= k elements apart (row-major: lda = k),
// z: (k,) float64 (read as int64 bits); k >= 1.  negate_z != 0 flips z's
// sign bits, so the rows take the products a[i,k] * -z[k] -- exactly those
// of -a[i,k] * z[k], specials included.  limbs: (m, 216) int64 and
// special: (m, 3) int64.  The geometry is the wrapper's row_geometry:
// blocks of `warps` warps (1..8), each over `warps` consecutive rows and
// one of `splits` spans of `span` k (a multiple of 1024).  With splits ==
// 1 the rows are written; with splits > 1 they are added to the outputs,
// which the caller zeroes.
int gemv_rows_acc_cuda(const void* a, const void* z, long long m, long long k,
                       long long lda, int negate_z, int warps, int splits,
                       long long span, void* limbs, void* special,
                       void* stream) {
  if (m < 1 || k < 1 || lda < k || warps < 1 || warps > kMaxWarps ||
      splits < 1 || span < 1 || span % kChunk != 0 ||
      (splits - 1) * span >= k || static_cast<long long>(splits) * span < k) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (m + warps - 1) / warps * splits;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  gemv_warp_rows_kernel<<<static_cast<unsigned>(blocks), 32 * warps, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(a), lda, static_cast<const long long*>(z),
      negate_z ? static_cast<long long>(exblas::kSignBit) : 0LL, m, k, splits,
      span, static_cast<long long*>(limbs), static_cast<long long*>(special),
      splits > 1 ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

// out[0..3] = registers a thread, local (spilled) bytes, static shared
// bytes and resident blocks an SM of the row kernel at 8 warps a block.
int gemv_rows_attrs(void* out) {
  cudaFuncAttributes at;
  cudaError_t err = cudaFuncGetAttributes(&at, gemv_warp_rows_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int* o = static_cast<int*>(out);
  o[0] = at.numRegs;
  o[1] = static_cast<int>(at.localSizeBytes);
  o[2] = static_cast<int>(at.sharedSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &o[3], gemv_warp_rows_kernel, 32 * kMaxWarps, 0));
}

}  // extern "C"
