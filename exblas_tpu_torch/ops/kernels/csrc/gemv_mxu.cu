// ExGEMV on the H100's int8 tensor cores: the row analysis B8 and the
// byte-plane kernel B9.
//
// B8 replaces exblas_tpu/ops/kernels/gemv_mxu.py: _analyze_rows_stats
// (_analyze_rows_kernel, via analyze_gemv_rows).  Per row of A (m, k): the
// anchor ea (the largest max(expf, 1) - 1023 over non-special elements,
// zeros included; -10000 if none), the smallest lsb exponent
// max(expf, 1) - 1075 over finite nonzero elements, and whether a NaN or
// Inf occurs; then over the rows the spread max(ea - lsb + 1) and the
// special flag.  The TPU pass reads only the high words and needs a second
// pass over the low words for elements whose high word is all zero; with
// the whole 64-bit word in hand one pass decides.  A block of 256 threads
// owns one row and one span of k (spans combine by integer atomic max and
// min); a second kernel reduces the rows.  Bound: A's 8 bytes per element,
// 0.160 ms at 8192^2 on 3.35 TB/s.
//
// B9 replaces exblas_tpu/ops/kernels/gemv_mxu.py: gemv_bits_mxu
// (_gemv_mxu_kernel with _slice_byte_words, make_z_digits, the in-kernel
// rounding _gemv_round_in_kernel and the beta != 0 XLA epilogue).  Data
// the dispatcher found covered by rung (nwa, nwz): each A element has its
// bits within 32 nwa of its row anchor ea, each z element within 32 nwz of
// the z anchor f.  With balanced signed base-256 digits (mxu.cuh: A_s of
// weight 2^(ea + 1 - 8s), s = 0..4 nwa; Z_t of weight 2^(f + 1 - 8t),
// t = 0..4 nwz, the latter made by gemm_mxu.cu's digit kernel)
//   y_i = sum_c M_c[i] 2^(e_base - 8c),  e_base = ea_i + f + 2,
//   M_c[i] = sum_{s+t=c} sum_k A_s[i,k] Z_t[k],
// a matrix product whose M is rows x digits of A, N the z digits (at most
// 29) and K = k.  The TPU kernel built A's planes by an XOR-0x80808080
// excess-128 bitcast with a sign-mask matmul and a global correction,
// folded byte lanes with an f32 selection matmul and spilled int32 sums
// into 20-bit limbs -- all for its int32-only vector unit; none of it is
// needed here:
//   * rung (2, 2), the benchmark configuration's: v22::class_kernel.
//     Each lane copies its own 16 doubles a k step into a private
//     cp.async ring (three steps in flight, no barrier in the k loop) and
//     recodes them in registers (mxu.cuh excess8) straight into the nine
//     mma A fragments; 18 mma.sync a step against the z-digit fragments,
//     read from L2.  Bound by A's bytes, not by the tensor cores;
//   * the wider rungs, gemv_mxu_class_kernel: a block owns 16 rows and one
//     span of k.  Per k step of 64 each thread loads 4 elements of A,
//     recodes them (mxu.cuh excess_frame) and stores each plane's four
//     digits as one word in shared memory (A's planes never reach device
//     memory: at rung (16, 7) they would be 65 bytes per element); warp w
//     then runs mma.sync.m16n8k32 s8 x s8 -> s32 of planes w, w + 8, ...
//     against the z-digit fragments.  Its accumulators (planes x z-digit
//     tiles) would not fit the registers of one warp per plane set.
//   Both keep int32 pair sums, exact over k_chunk <= 2^16 elements
//   (|A_s Z_t| <= 2^14), and widen them into the block's int64 class sums
//   in shared memory, which go to device memory by 64-bit integer atomics
//   (k spans of one row tile combine there);
//   * gemv_mxu_round_kernel: a thread per row adds its class sums at 8-bit
//     spacing into a private int64 accumulator (round.cuh add_scaled) and
//     rounds it once (round_limbs) with the row's exponent put back -- the
//     arithmetic of gemm_mxu.cu's rounding kernel at n = 1.  With beta != 0
//     it moves the exact row value into an absolute DOT_FORMAT accumulator
//     (a digit straddling bit 0 of a deep-subnormal row folds in by an
//     exact right shift), adds the exact beta * y_i there, where it needs
//     no coverage, and rounds there, counting beta * y's specials.
// Bound: A's bytes, 0.160 ms at 8192^2; rung (2, 2) does 81 int8 products
// of m x k (1.1e10 operations, 5.5 us at 1,979 TOP/s) and even rung
// (16, 7), about 2.5e11, stays near the bytes.  What costs is the recode
// (about 25 integer operations an element at rung (2, 2)) and keeping A's
// bytes in flight.
#include <cuda_runtime.h>

#include <cstdint>

#include "deposit.cuh"
#include "mxu.cuh"
#include "round.cuh"

namespace {

using exblas::kDigits;
using exblas::kDotLimbs;
using exblas::kDotOffset;
using exblas::kLimbBits;
using exblas::kLimbMask;

constexpr int kESent = -10000;   // row without a non-special element
constexpr int kLsbSent = 10000;  // row without a finite nonzero element
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;        // rows of a class-kernel block: one m16
constexpr int kKs = 64;          // k per step: two mma k-steps of 32
constexpr int kRowBytes = 80;    // padded bytes of a staged row of 64
constexpr int kMaxRel = 48;      // limbs of the relative accumulator
constexpr int kAnalyzeUnroll = 4;

// ---------------------------------------------------------------------------
// B8: the row analysis
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    analyze_rows_kernel(const long long* __restrict__ a, long long k,
                        int splits, long long span, int* __restrict__ ea,
                        int* __restrict__ lsb, int* __restrict__ flags) {
  __shared__ int s_e[kWarps], s_l[kWarps], s_f[kWarps];
  const long long row = blockIdx.x / splits;
  const long long k0 = (blockIdx.x % splits) * span;
  const long long k1 = k0 + span < k ? k0 + span : k;
  const long long* ar = a + row * k;
  int e = kESent, l = kLsbSent, special = 0;
  for (long long base = k0; base < k1;
       base += static_cast<long long>(kThreads) * kAnalyzeUnroll) {
    long long v[kAnalyzeUnroll];
    bool in[kAnalyzeUnroll];
#pragma unroll
    for (int u = 0; u < kAnalyzeUnroll; ++u) {
      const long long i = base + u * kThreads + threadIdx.x;
      in[u] = i < k1;
      v[u] = in[u] ? __ldg(ar + i) : 0LL;
    }
#pragma unroll
    for (int u = 0; u < kAnalyzeUnroll; ++u) {
      if (!in[u]) continue;
      const int expf = static_cast<int>((v[u] >> 52) & 0x7FF);
      if (expf == 0x7FF) {
        special = 1;
        continue;
      }
      const int eb = expf > 1 ? expf : 1;
      e = max(e, eb - 1023);
      if ((v[u] & 0x7FFFFFFFFFFFFFFFLL) != 0) l = min(l, eb - 1075);
    }
  }
  const int warp = threadIdx.x >> 5;
  e = __reduce_max_sync(exblas::kFullMask, e);
  l = __reduce_min_sync(exblas::kFullMask, l);
  special = __reduce_or_sync(exblas::kFullMask, special != 0 ? 1u : 0u);
  if ((threadIdx.x & 31) == 0) {
    s_e[warp] = e;
    s_l[warp] = l;
    s_f[warp] = special;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < kWarps; ++w) {
    e = max(e, s_e[w]);
    l = min(l, s_l[w]);
    special |= s_f[w];
  }
  if (e > kESent) atomicMax(ea + row, e);
  if (l < kLsbSent) atomicMin(lsb + row, l);
  if (special) atomicOr(flags + row, 1);
}

// stats[0] = max over rows of ea - lsb + 1 (0 without a finite nonzero
// element), stats[1] = any row flag; both zeroed by the caller.
__global__ void __launch_bounds__(kThreads)
    analyze_finish_kernel(const int* __restrict__ ea,
                          const int* __restrict__ lsb,
                          const int* __restrict__ flags, long long m,
                          int* __restrict__ stats) {
  int spread = 0;
  unsigned special = 0;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < m; i += static_cast<long long>(gridDim.x) * kThreads) {
    if (lsb[i] < kLsbSent) spread = max(spread, ea[i] - lsb[i] + 1);
    special |= static_cast<unsigned>(flags[i]);
  }
  spread = __reduce_max_sync(exblas::kFullMask, spread);
  special = __reduce_or_sync(exblas::kFullMask, special);
  if ((threadIdx.x & 31) == 0) {
    if (spread > 0) atomicMax(stats, spread);
    if (special) atomicOr(stats + 1, 1);
  }
}

// ---------------------------------------------------------------------------
// B9: class sums on the int8 tensor cores
// ---------------------------------------------------------------------------

template <int NWA, int NWZ>
struct Rung {
  static constexpr int kNs = 4 * NWA;        // digits of A below its carry
  static constexpr int kNa = kNs + 1;        // digits of A
  static constexpr int kNz = 4 * NWZ + 1;    // digits of z
  static constexpr int kNTiles = (kNz + 7) / 8;
  static constexpr int kCls = kNa + kNz - 1;
  static constexpr int kPlanes = (kNa + kWarps - 1) / kWarps;  // per warp
  static constexpr int kPlaneBytes = kRows * kRowBytes;
  static constexpr int kABytes = kNa * kPlaneBytes;
  static constexpr int kSmem = kABytes + kRows * kCls * 8;
};

__device__ __forceinline__ unsigned lds32(const unsigned char* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// cls (m, kCls) int64, zeroed by the caller, += the class sums of rows
// [row0, row0 + 16) over k span [k0, k1).  zd: z digits (kNz, k_pad) int8,
// zero past k.
template <int NWA, int NWZ>
__global__ void __launch_bounds__(kThreads)
    gemv_mxu_class_kernel(const long long* __restrict__ a,
                          const int* __restrict__ ea,
                          const int8_t* __restrict__ zd, long long m,
                          long long k, long long k_pad, int splits,
                          long long span, long long kc,
                          long long* __restrict__ cls) {
  using R = Rung<NWA, NWZ>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* planes = smem;
  long long* cls_s = reinterpret_cast<long long*>(smem + R::kABytes);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row / column group
  const int tq = lane & 3;  // thread in group
  const long long row0 = static_cast<long long>(blockIdx.x / splits) * kRows;
  const long long k0 = static_cast<long long>(blockIdx.x % splits) * span;
  const long long k1 = k0 + span < k ? k0 + span : k;
  for (int j = threadIdx.x; j < kRows * R::kCls; j += kThreads) cls_s[j] = 0;

  // The recode: thread (r, q) owns elements kk + 4q .. kk + 4q + 3 of row r.
  const int r = threadIdx.x >> 4;
  const int q = threadIdx.x & 15;
  const long long row = row0 + r;
  const bool row_ok = row < m;
  const int anchor = row_ok ? ea[row] : 0;
  const long long* ar = a + (row_ok ? row : 0) * k;
  unsigned char* own = planes + r * kRowBytes + 4 * q;
  long long v[4];
  auto load = [&](long long kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long i = kk + 4 * q + j;
      v[j] = row_ok && i < k1 ? __ldg(ar + i) : 0LL;
    }
  };

  int acc[R::kPlanes][R::kNTiles][4];
#pragma unroll
  for (int p = 0; p < R::kPlanes; ++p) {
#pragma unroll
    for (int nt = 0; nt < R::kNTiles; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[p][nt][i] = 0;
    }
  }
  const int off = exblas::window_offset(anchor, R::kNs);
  load(k0);
  long long run = 0;
  for (long long kk = k0; kk < k1; kk += kKs) {
    __syncthreads();  // every warp is done reading the previous planes
    exblas::ExcessFrame f[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) f[j] = exblas::excess_frame(v[j], off, R::kNs);
#pragma unroll
    for (int u = 0; u <= R::kNs; ++u) {
      unsigned word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = exblas::excess_digit(f[j], R::kNs, u);
        word |= (static_cast<unsigned>(d) & 0xFFu) << (8 * j);
      }
      *reinterpret_cast<unsigned*>(own + u * R::kPlaneBytes) = word;
    }
    __syncthreads();
    if (kk + kKs < k1) load(kk + kKs);  // in flight during the products
#pragma unroll
    for (int p = 0; p < R::kPlanes; ++p) {
      const int s = warp + p * kWarps;
      if (s >= R::kNa) continue;  // warp-uniform
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned char* ap =
            planes + s * R::kPlaneBytes + h * 32 + tq * 4;
        const unsigned af[4] = {lds32(ap + g * kRowBytes),
                                lds32(ap + (g + 8) * kRowBytes),
                                lds32(ap + g * kRowBytes + 16),
                                lds32(ap + (g + 8) * kRowBytes + 16)};
#pragma unroll
        for (int nt = 0; nt < R::kNTiles; ++nt) {
          const int t = nt * 8 + g;
          unsigned b0 = 0, b1 = 0;
          if (t < R::kNz) {
            const int8_t* zp = zd + t * k_pad + kk + h * 32 + tq * 4;
            b0 = exblas::ld32(zp);
            b1 = exblas::ld32(zp + 16);
          }
          exblas::mma_s8(acc[p][nt], af, b0, b1);
        }
      }
    }
    run += kKs;
    if (run == kc || kk + kKs >= k1) {  // block-uniform: widen
      run = 0;
#pragma unroll
      for (int p = 0; p < R::kPlanes; ++p) {
        const int s = warp + p * kWarps;
#pragma unroll
        for (int nt = 0; nt < R::kNTiles; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int t = nt * 8 + tq * 2 + (i & 1);
            const int rr = g + (i >= 2 ? 8 : 0);
            if (s < R::kNa && t < R::kNz && acc[p][nt][i] != 0) {
              atomicAdd(reinterpret_cast<unsigned long long*>(
                            cls_s + rr * R::kCls + s + t),
                        static_cast<unsigned long long>(
                            static_cast<long long>(acc[p][nt][i])));
            }
            acc[p][nt][i] = 0;
          }
        }
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < kRows * R::kCls; j += kThreads) {
    const long long i = row0 + j / R::kCls;
    if (i < m && cls_s[j] != 0) {
      atomicAdd(reinterpret_cast<unsigned long long*>(
                    cls + i * R::kCls + j % R::kCls),
                static_cast<unsigned long long>(cls_s[j]));
    }
  }
}

// Rung (2, 2), the benchmark configuration's: A's digits are made in
// registers straight into the mma A fragments.  Lane (g, tq) of a warp
// holds, for each k step of 32, rows g and g + 8 at k 8p + 2tq + {0, 1}
// for p = 0..3, so that the four lanes of a row copy 64 contiguous bytes
// a piece: fragment positions 4tq..4tq+3 take k 2tq, 2tq+1, 8+2tq, 9+2tq
// and positions 16+4tq..16+4tq+3 the same plus 16 (the z fragments are
// gathered in the same order, so the sums are those of k in order).  A
// lane copies its own 16 doubles into a private ring of kStages steps in
// shared memory (cp.async, zero-filled past the span), so two steps are
// in flight while it computes one, and no barrier is needed: a lane reads
// only what it copied.  Twelve warps (384 threads, at most 168 registers
// each) measured fastest; eight were about 14% slower (PERF.md).  The
// recode (excess8) packs each plane's four digits per row and half into
// one fragment register: nine A fragments, 36 registers, then 18 mma.sync
// a step (z digits 0-7 and digit 8).  The warps of a block share its 16
// rows and take every kWarps-th k step of its span; they combine their
// int32 pair sums once, at the end (or every kc k of their own), through
// the block's int64 class sums in shared memory.
namespace v22 {

constexpr int kNs = 8;                 // digits of A below its carry
constexpr int kNa = kNs + 1;           // digits of A, and of z
constexpr int kCls = 2 * kNa - 1;
constexpr int kWarps = 12;
constexpr int kThreads = 32 * kWarps;
constexpr int kStride = 32 * kWarps;   // k between a warp's steps
constexpr int kStages = 3;             // k steps a lane's ring holds
constexpr int kPieces = 8;             // 16-byte pieces a lane copies a step
constexpr int kStageBytes = kPieces * kThreads * 16;
constexpr int kRing = kStages * kStageBytes;  // 131,072
constexpr int kSmem = kRing + kRows * kCls * 8;

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async8(unsigned dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// cls (m, 17) int64, zeroed by the caller, += the class sums of rows
// [row0, row0 + 16) over k span [k0, k1).  zd: z digits (9, k_pad) int8,
// zero past k.
__global__ void __launch_bounds__(kThreads, 1)
    class_kernel(const long long* __restrict__ a, const int* __restrict__ ea,
                 const int8_t* __restrict__ zd, long long m, long long k,
                 long long k_pad, int splits, long long span, long long kc,
                 long long* __restrict__ cls) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* cls_s = reinterpret_cast<long long*>(smem + kRing);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const long long row0 = static_cast<long long>(blockIdx.x / splits) * kRows;
  const long long k0 = static_cast<long long>(blockIdx.x % splits) * span;
  const long long k1 = k0 + span < k ? k0 + span : k;
  for (int j = threadIdx.x; j < kRows * kCls; j += kThreads) cls_s[j] = 0;
  __syncthreads();

  const long long* src[2];
  bool ok[2], aligned[2];
  double s1[2], s2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = row0 + g + 8 * h;
    ok[h] = row < m;
    src[h] = a + (ok[h] ? row : 0) * k + 2 * tq;
    aligned[h] = (reinterpret_cast<uintptr_t>(src[h]) & 15u) == 0u;
    exblas::window_scales8(ok[h] ? ea[row] : 0, s1[h], s2[h]);
  }
  const unsigned ring = exblas::smem_u32(smem) + threadIdx.x * 16u;
  // This warp's steps: kw + kStride i, i < n.
  const long long kw = k0 + 32 * warp;
  const int n =
      kw < k1 ? static_cast<int>((k1 - kw + kStride - 1) / kStride) : 0;
  auto copy_step = [&](int i) {
    const long long kk = kw + static_cast<long long>(kStride) * i;
    const unsigned st = ring + (i % kStages) * kStageBytes;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const long long e = kk + 8 * p + 2 * tq;
        const long long left = ok[h] ? k1 - e : 0;
        const int nv = left <= 0 ? 0 : (left >= 2 ? 2 : 1);
        const unsigned dst = st + (h * 4 + p) * (kThreads * 16);
        const long long* from = src[h] + kk + 8 * p;
        if (aligned[h]) {
          cp_async16(dst, nv > 0 ? from : a, 8 * nv);
        } else {
          cp_async8(dst, nv > 0 ? from : a, nv > 0 ? 8 : 0);
          cp_async8(dst + 8, nv > 1 ? from + 1 : a, nv > 1 ? 8 : 0);
        }
      }
    }
  };

  int acc[kNa][2][4];
#pragma unroll
  for (int u = 0; u < kNa; ++u) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[u][0][i] = acc[u][1][i] = 0;
  }
  auto widen = [&]() {
#pragma unroll
    for (int u = 0; u < kNa; ++u) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = nt * 8 + tq * 2 + (i & 1);
          const int rr = g + (i >= 2 ? 8 : 0);
          if (t < kNa && acc[u][nt][i] != 0) {
            atomicAdd(reinterpret_cast<unsigned long long*>(
                          cls_s + rr * kCls + u + t),
                      static_cast<unsigned long long>(
                          static_cast<long long>(acc[u][nt][i])));
          }
          acc[u][nt][i] = 0;
        }
      }
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) copy_step(i);
    cp_async_commit();
  }
  long long run = 0;
  for (int i = 0; i < n; ++i) {
    if (i + kStages - 1 < n) copy_step(i + kStages - 1);
    cp_async_commit();
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
    const unsigned char* st =
        smem + (i % kStages) * kStageBytes + threadIdx.x * 16;
    long long v[16];
#pragma unroll
    for (int q = 0; q < kPieces; ++q) {
      const longlong2 pair =
          *reinterpret_cast<const longlong2*>(st + q * (kThreads * 16));
      v[2 * q] = pair.x;
      v[2 * q + 1] = pair.y;
    }
    // v[8h + 2p + j]: row g + 8h, k 8p + 2tq + j.  Fragment register
    // h + 2 half holds row g + 8h at v[8h + 4 half + 0..3].
    unsigned af[kNa][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        unsigned long long x[4];
        int carry[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          x[j] = exblas::excess8(v[8 * h + 4 * half + j], s1[h], s2[h],
                                 carry[j]);
        }
        unsigned p[kNa];
        exblas::pack_digits8(x, carry, p);
#pragma unroll
        for (int u = 0; u < kNa; ++u) af[u][h + 2 * half] = p[u];
      }
    }
    const long long kk = kw + static_cast<long long>(kStride) * i;
    unsigned zb[2][2];  // [tile][b0, b1]: z digits g and 8 + g
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      zb[nt][0] = zb[nt][1] = 0u;
      if (nt == 0 || g == 0) {
        const uint4* zp =
            reinterpret_cast<const uint4*>(zd + (8 * nt + g) * k_pad + kk);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const uint4 w = __ldg(zp + half);  // k 16 half .. 16 half + 15
          zb[nt][half] = __byte_perm(tq >> 1 ? w.y : w.x, tq >> 1 ? w.w : w.z,
                                     tq & 1 ? 0x7632 : 0x5410);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kNa; ++u) {
      exblas::mma_s8(acc[u][0], af[u], zb[0][0], zb[0][1]);
      exblas::mma_s8(acc[u][1], af[u], zb[1][0], zb[1][1]);
    }
    run += 32;
    if (run >= kc) {
      widen();
      run = 0;
    }
  }
  widen();
  __syncthreads();
  for (int j = threadIdx.x; j < kRows * kCls; j += kThreads) {
    const long long i = row0 + j / kCls;
    if (i < m && cls_s[j] != 0) {
      atomicAdd(
          reinterpret_cast<unsigned long long*>(cls + i * kCls + j % kCls),
          static_cast<unsigned long long>(cls_s[j]));
    }
  }
}

// One block of 16 rows per row tile when the tiles fill the card, else
// the k spans that fill it once.
cudaError_t splits_for(long long tiles, long long k, long long* splits,
                       long long* span) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  const long long steps = k > 0 ? (k + kKs - 1) / kKs : 1;
  long long s = (sms + tiles - 1) / tiles;
  if (s > steps) s = steps;
  if (s < 1) s = 1;
  *span = (steps + s - 1) / s * kKs;
  *splits = k > 0 ? (k + *span - 1) / *span : 1;
  if (tiles * *splits > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  return cudaSuccess;
}

int launch(const long long* a, const int* ea, const int8_t* zd, long long m,
           long long k, long long k_pad, long long kc, long long* cls,
           cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      class_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  long long splits = 0, span = 0;
  const long long tiles = (m + kRows - 1) / kRows;
  const cudaError_t err = splits_for(tiles, k, &splits, &span);
  if (err != cudaSuccess) return static_cast<int>(err);
  class_kernel<<<static_cast<unsigned>(tiles * splits), kThreads, kSmem,
                 stream>>>(a, ea, zd, m, k, k_pad, static_cast<int>(splits),
                           span, kc, cls);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace v22

template <int NWA, int NWZ>
int launch_classes(const long long* a, const int* ea, const int8_t* zd,
                   long long m, long long k, long long k_pad, long long kc,
                   long long* cls, cudaStream_t stream) {
  using R = Rung<NWA, NWZ>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemv_mxu_class_kernel<NWA, NWZ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  long long splits = 0, span = 0;
  const long long tiles = (m + kRows - 1) / kRows;
  const cudaError_t err = exblas::row_splits(tiles, k, kKs, &splits, &span);
  if (err != cudaSuccess) return static_cast<int>(err);
  gemv_mxu_class_kernel<NWA, NWZ>
      <<<static_cast<unsigned>(tiles * splits), kThreads, R::kSmem, stream>>>(
          a, ea, zd, m, k, k_pad, static_cast<int>(splits), span, kc, cls);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// B9: the rounding
// ---------------------------------------------------------------------------

// Round rel * 2^(p0 - 2148) + beta * y, where rel holds nl int64 limbs of
// an exact multiple of 2^-2148 (every product is), in an absolute
// DOT_FORMAT accumulator; beta * y's NaN/Inf counts set the specials.
// rel is canonicalized in place.
__device__ unsigned long long round_with_beta(long long* rel, int nl, int p0,
                                              long long beta, long long y) {
  long long carry = 0;
  for (int j = 0; j < nl; ++j) {
    const long long d = rel[j] + carry;
    rel[j] = d & kLimbMask;
    carry = (d - rel[j]) >> kLimbBits;
  }
  const bool negative = carry < 0;
  if (negative) {  // magnitude digits
    long long borrow = 1;
    for (int j = 0; j < nl; ++j) {
      const long long t = (rel[j] ^ kLimbMask) + borrow;
      rel[j] = t & kLimbMask;
      borrow = t >> kLimbBits;
    }
  }
  long long acc[kDotLimbs];
  for (int j = 0; j < kDotLimbs; ++j) acc[j] = 0;
  int jlo = kDotLimbs, jhi = -1;
  for (int j = 0; j < nl; ++j) {
    long long v = rel[j];
    int p = p0 + kLimbBits * j;
    if (p < 0) {  // below bit 0 only the straddling digit can be nonzero
      v = -p < kLimbBits ? v >> -p : 0;
      p = 0;
    }
    if (v == 0) continue;
    exblas::add_scaled(acc, negative ? -v : v, p);
    jlo = min(jlo, p / kLimbBits);
    jhi = max(jhi, p / kLimbBits + 2);
  }
  long long nan_c = 0, pinf_c = 0, ninf_c = 0;
  int q;
  unsigned long long lo, hi;
  bool neg;
  if (exblas::decode_product(beta, y, kDotOffset, q, lo, hi, neg, nan_c,
                             pinf_c, ninf_c)) {
    exblas::add_digits<kDigits>(acc, kDotLimbs, q, lo, hi, neg);
    jlo = min(jlo, q);
    jhi = max(jhi, q + kDigits - 1);
  }
  if (jhi > kDotLimbs - 1) jhi = kDotLimbs - 1;
  const unsigned long long bits =
      exblas::round_limbs(acc, jlo, jhi, kDotLimbs, kDotOffset);
  return exblas::apply_specials(bits, nan_c, pinf_c, ninf_c);
}

__global__ void __launch_bounds__(128)
    gemv_mxu_round_kernel(const long long* __restrict__ cls, int n_cls,
                          const int* __restrict__ ea,
                          const int* __restrict__ f,
                          const long long* __restrict__ y, long long beta,
                          int beta_mode, long long m, int nl, int rel0,
                          long long* __restrict__ out) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < m; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    long long rel[kMaxRel];
    for (int l = 0; l < nl; ++l) rel[l] = 0;
    // Class c has weight 2^(e_base - 8c): relative bit rel0 - 8c.  Two
    // pieces keep each add_scaled product below 2^63.
    for (int c = 0; c < n_cls; ++c) {
      const long long v = cls[i * n_cls + c];
      if (v == 0) continue;
      exblas::add_scaled(rel, v & kLimbMask, rel0 - 8 * c);
      exblas::add_scaled(rel, v >> kLimbBits, rel0 - 8 * c + kLimbBits);
    }
    const int e_base = ea[i] + *f + 2;
    out[i] = static_cast<long long>(
        beta_mode == 0
            ? exblas::round_limbs(rel, 0, nl - 1, nl, rel0 - e_base)
            : round_with_beta(rel, nl, e_base - rel0 + kDotOffset, beta,
                              y[i]));
  }
}

int grid_for(long long total, int threads, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (total + threads - 1) / threads;
  const long long cap = static_cast<long long>(sms) * (2048 / threads);
  *grid = static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
  return 0;
}

}  // namespace

extern "C" {

// a: (m, k) float64 bits, row-major, k >= 1.  ea, lsb, flags: (m,) int32,
// set by the caller to -10000, 10000 and 0; stats: 2 int32, zeroed.
// Writes per row the anchor, the smallest lsb exponent and the special
// flag, and stats = {spread, any special}.
int gemv_analyze_cuda(const void* a, long long m, long long k, void* ea,
                      void* lsb, void* flags, void* stats, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long splits = 0, span = 0;
  cudaError_t err = exblas::row_splits(
      m, k, static_cast<long long>(kThreads) * kAnalyzeUnroll, &splits,
      &span);
  if (err != cudaSuccess) return static_cast<int>(err);
  analyze_rows_kernel<<<static_cast<unsigned>(m * splits), kThreads, 0, s>>>(
      static_cast<const long long*>(a), k, static_cast<int>(splits), span,
      static_cast<int*>(ea), static_cast<int*>(lsb), static_cast<int*>(flags));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int grid = 0;
  const int e = grid_for(m, kThreads, &grid);
  if (e != 0) return e;
  analyze_finish_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const int*>(ea), static_cast<const int*>(lsb),
      static_cast<const int*>(flags), m, static_cast<int*>(stats));
  return static_cast<int>(cudaGetLastError());
}

// Class sums of rung (nwa, nwz): a (m, k) float64 bits, row-major; ea (m,)
// int32 row anchors; zd (4 nwz + 1, k_pad) int8 z digits, k_pad a multiple
// of 64; kc a multiple of 64, at most 2^16.  cls: (m, 4 nwa + 4 nwz + 1)
// int64, zeroed by the caller.
int gemv_mxu_classes_cuda(const void* a, const void* ea, const void* zd,
                          long long m, long long k, long long k_pad, int nwa,
                          int nwz, long long kc, void* cls, void* stream) {
  if (k == 0 || m == 0) return 0;
  const auto* pa = static_cast<const long long*>(a);
  const auto* pe = static_cast<const int*>(ea);
  const auto* pz = static_cast<const int8_t*>(zd);
  auto* pc = static_cast<long long*>(cls);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define EXBLAS_GEMV_RUNG(A, Z)                                           \
  if (nwa == (A) && nwz == (Z)) {                                        \
    return launch_classes<A, Z>(pa, pe, pz, m, k, k_pad, kc, pc, s);     \
  }
  if (nwa == 2 && nwz == 2) {
    return v22::launch(pa, pe, pz, m, k, k_pad, kc, pc, s);
  }
  EXBLAS_GEMV_RUNG(3, 3)
  EXBLAS_GEMV_RUNG(4, 4)
  EXBLAS_GEMV_RUNG(5, 4)
  EXBLAS_GEMV_RUNG(6, 5)
  EXBLAS_GEMV_RUNG(8, 6)
  EXBLAS_GEMV_RUNG(12, 7)
  EXBLAS_GEMV_RUNG(16, 7)
#undef EXBLAS_GEMV_RUNG
  return static_cast<int>(cudaErrorInvalidValue);
}

// Rounds rows [0, m) from their n_cls class sums (as written by
// gemv_mxu_classes_cuda), anchors ea (m,) and f (1,) int32, and beta * y
// (y: (m,) float64 bits, unused when beta_mode == 0).  nl <= 48 limbs hold
// the exact row value relative to 2^(e_base - rel0).
int gemv_mxu_round_cuda(const void* cls, int n_cls, const void* ea,
                        const void* f, const void* y, long long beta,
                        int beta_mode, long long m, int nl, int rel0,
                        void* out, void* stream) {
  if (nl > kMaxRel) return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  const int err = grid_for(m, 128, &grid);
  if (err != 0) return err;
  gemv_mxu_round_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(cls), n_cls, static_cast<const int*>(ea),
      static_cast<const int*>(f), static_cast<const long long*>(y), beta,
      beta_mode, m, nl, rel0, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out[0..3] = registers a thread, local (spilled) bytes, static and
// dynamic shared bytes (as set before its first launch) of kernel
// `which`: 0 the rung (2, 2) class kernel, 1 the staged class kernel of
// rung (16, 7).
int gemv_mxu_attrs(int which, void* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaErrorInvalidValue;
  if (which == 0) err = cudaFuncGetAttributes(&a, v22::class_kernel);
  if (which == 1) {
    err = cudaFuncGetAttributes(&a, gemv_mxu_class_kernel<16, 7>);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  int* o = static_cast<int*>(out);
  o[0] = a.numRegs;
  o[1] = static_cast<int>(a.localSizeBytes);
  o[2] = static_cast<int>(a.sharedSizeBytes);
  o[3] = a.maxDynamicSharedSizeBytes;
  return 0;
}

}  // extern "C"
