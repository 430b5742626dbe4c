// The streaming shape shared by the persistent ExSUM/ExDOT kernels (B2,
// B4, B11, B12): a grid of as many blocks as every SM holds at once, each
// thread reading its vectors in 16-byte loads (8-byte loads where two
// vectors start at different offsets mod 16), the next step's loads issued
// before the current step is decoded.
#pragma once

#include <cuda_runtime.h>

namespace exblas {

// W elements of each of two vectors a load: 2 (16-byte loads) or 1; av(j),
// bv(j) are the j-th elements of a and b.  Past nu units a load gives
// zeros, which every caller adds as nothing.
template <int W>
struct PairUnit;

template <>
struct PairUnit<2> {
  longlong2 a, b;
  __device__ __forceinline__ void load(const long long* pa,
                                       const long long* pb, long long i,
                                       long long nu) {
    if (i < nu) {
      a = __ldcs(reinterpret_cast<const longlong2*>(pa) + i);
      b = __ldcs(reinterpret_cast<const longlong2*>(pb) + i);
    } else {
      a.x = a.y = b.x = b.y = 0LL;
    }
  }
  __device__ __forceinline__ long long av(int j) const { return j ? a.y : a.x; }
  __device__ __forceinline__ long long bv(int j) const { return j ? b.y : b.x; }
};

template <>
struct PairUnit<1> {
  long long a, b;
  __device__ __forceinline__ void load(const long long* pa,
                                       const long long* pb, long long i,
                                       long long nu) {
    a = i < nu ? __ldcs(pa + i) : 0LL;
    b = i < nu ? __ldcs(pb + i) : 0LL;
  }
  __device__ __forceinline__ long long av(int) const { return a; }
  __device__ __forceinline__ long long bv(int) const { return b; }
};

// One vector's loop, as B2's (sum_kernel.cu): nu 16-byte units from px,
// kUnits a thread a step (unit s * per_step + u * threads + tid), the next
// step's loads issued before body(cur, s) takes the current step's; past
// nu a unit is zeros.  The step count is the same in every thread of the
// grid, so the body may hold warp-wide operations.  Index: the type of
// the unit indices, int where the caller's n bounds them (B11's n <=
// 2^30), which spares registers and 64-bit arithmetic.
template <int kUnits, typename Index, typename Body>
__device__ __forceinline__ void stream_units(const longlong2* px, Index nu,
                                             Index threads, Index tid,
                                             Body&& body) {
  const Index per_step = kUnits * threads;
  const Index steps = (nu + per_step - 1) / per_step;  // grid-uniform
  longlong2 cur[kUnits];
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const Index i = u * threads + tid;
    cur[u] = i < nu ? __ldcs(px + i) : make_longlong2(0LL, 0LL);
  }
#pragma unroll 1
  for (Index s = 0; s < steps; ++s) {
    longlong2 nxt[kUnits];
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const Index i = (s + 1) * per_step + u * threads + tid;
      nxt[u] = i < nu ? __ldcs(px + i) : make_longlong2(0LL, 0LL);
    }
    body(cur, s);
#pragma unroll
    for (int u = 0; u < kUnits; ++u) cur[u] = nxt[u];
  }
}

// Blocks of a persistent launch of `fn` (threads a block): `want` (the
// blocks the work fills, at least 1), but no more than every SM holds at
// once by the occupancy calculator, so the grid runs in one wave.
inline cudaError_t persistent_grid(const void* fn, int threads,
                                   long long want, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                        0);
  }
  if (err != cudaSuccess) return err;
  const long long cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  *grid = static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
  return cudaSuccess;
}

// Reads the int32 counters of a kernel's resources for a C entry point:
// out[0..3] = registers a thread, local (spilled) bytes, static shared
// bytes and resident blocks an SM at `threads` a block.
inline cudaError_t kernel_attrs(const void* fn, int threads, int* out) {
  cudaFuncAttributes at;
  cudaError_t err = cudaFuncGetAttributes(&at, fn);
  if (err != cudaSuccess) return err;
  out[0] = at.numRegs;
  out[1] = static_cast<int>(at.localSizeBytes);
  out[2] = static_cast<int>(at.sharedSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], fn, threads,
                                                       0);
}

}  // namespace exblas
