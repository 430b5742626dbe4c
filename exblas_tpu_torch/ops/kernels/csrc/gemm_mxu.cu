// Exact ExGEMM on the int8 tensor cores (Ozaki-Kulisch slices) for data
// the dispatcher has found covered: A and B recoded into balanced signed
// base-256 digit planes anchored per row of A and per column of B, so that
//   z[i,k] * b[k,j] = sum_{s,t} A_s[i,k] * B_t[j,k] * 2^(e_base - 8(s+t)),
//   e_base = ea[i] + fb[j] + 2,
// and the exact result is sum_c M_c[i,j] * 2^(e_base - 8c) (+ beta*c[i,j])
// with the class sums M_c = sum_{s+t=c} sum_k A_s[i,k] * B_t[j,k].
//
// Replaces exblas_tpu/ops/kernels/gemm_mxu.py: gemm_bits_mxu (its
// make_digits preparation, and _mxu_kernel with _deposit_beta_c_rel,
// _renorm_rel and _round_rel_kernel_part).  The TPU kernel keeps int32
// class sums in VMEM and spills them into 20-bit limbs with a carry pass
// every _spill_run k elements, because its vector unit has int32 only.
// Hopper has int64, so three kernels:
//   * mxu_digits_kernel: the digit planes, one thread per element, k
//     contiguous: A as (sa+1, m_pad, k_pad), B transposed as
//     (sb+1, n_pad, k_pad);
//   * a class kernel: int8 mma.sync.m16n8k32 products of digit pairs with
//     int32 sums, exact over a k chunk of kc = _spill_run(sa, sb) <= 2048
//     elements ((min(sa,sb)+1) pairs of |d_s d_t| <= 2^14 per k element:
//     < 2^31), widened into int64 class sums in device memory after each
//     chunk; an int64 class sum cannot overflow below the 2^22 k cap.  No
//     limb spill, no carry pass.  Rung (8, 8) runs r88::class_kernel
//     (digit indices static, tiles staged in shared memory); every other
//     rung runs mxu_class_kernel, which holds kG = 17 classes in registers
//     per pass over k (blockIdx.z picks the group) and loads fragments
//     straight from device memory;
//   * mxu_round_kernel: one thread per element adds its n_cls int64 class
//     sums at 8-bit spacing and the exact beta*c product into a private
//     int64 accumulator anchored at e_base - 8(sa+sb) (round.cuh
//     add_scaled, deposit.cuh add_digits) and rounds it once with the
//     element's exponent put back (round.cuh round_limbs).  Rounding n
//     int64 terms at given bit positions is also what B3
//     (round_in_kernel.py: round_scaled_terms) computes, so its port can
//     share these routines.
//
// Bound on the H100: the int8 tensor cores.  A rung (sa, sb) does
// (sa+1)(sb+1) int8 products of m x k x n: at (8, 8) and n = 4096 that is
// 1.1e13 operations, 5.6 ms at 1,979 TOP/s, while the digit planes, C and
// the result move 0.57 GB (0.17 ms of HBM).  mma.sync is the simple
// route; wgmma and TMA are later work.  The class sums go through device
// memory (n_cls x 8 bytes per element) to keep the rounding apart.
#include <cuda_runtime.h>

#include <cstdint>

#include "deposit.cuh"
#include "mxu.cuh"
#include "round.cuh"

namespace {

using exblas::ld32;
using exblas::mma_s8;

constexpr int kG = 17;        // classes per pass, held in registers
constexpr int kTile = 32;     // block tile: 32 x 32 outputs, 4 warps
constexpr int kThreads = 128;
constexpr int kMaxRel = 48;   // limbs of the rounding accumulator

// Class sums of one 32 x 32 output tile for classes [c0, c0 + kG):
// cls[c][i][j] (int64, (n_cls, rows, n_pad)) over all k.
__global__ void __launch_bounds__(kThreads)
    mxu_class_kernel(const int8_t* __restrict__ ad,
                     const int8_t* __restrict__ bd, int sa, int sb,
                     long long plane_a, long long plane_b, long long rows,
                     long long n_pad, long long k_pad, long long kc,
                     long long* __restrict__ cls) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row / column group
  const int tq = lane & 3;   // thread in group
  const long long row0 = static_cast<long long>(blockIdx.y) * kTile +
                         (warp >> 1) * 16;
  const long long col0 = static_cast<long long>(blockIdx.x) * kTile +
                         (warp & 1) * 16;
  const int c0 = blockIdx.z * kG;
  const int n_cls = sa + sb + 1;
  const int s_lo = c0 - sb > 0 ? c0 - sb : 0;
  const int s_hi = c0 + kG - 1 < sa ? c0 + kG - 1 : sa;
  // A: rows row0+g and row0+g+8; B^T: rows (output columns) col0+g, +8.
  const int8_t* a0 = ad + (row0 + g) * k_pad + tq * 4;
  const int8_t* a1 = a0 + 8 * k_pad;
  const int8_t* b0 = bd + (col0 + g) * k_pad + tq * 4;
  const int8_t* b1 = b0 + 8 * k_pad;

  for (long long kb = 0; kb < k_pad; kb += kc) {
    int acc[kG][2][4];
#pragma unroll
    for (int d = 0; d < kG; ++d) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[d][0][r] = 0;
        acc[d][1][r] = 0;
      }
    }
    const long long ke = kb + kc < k_pad ? kb + kc : k_pad;
    for (long long kk = kb; kk < ke; kk += 32) {
      for (int s = s_lo; s <= s_hi; ++s) {
        const long long oa = s * plane_a + kk;
        const unsigned a[4] = {ld32(a0 + oa), ld32(a1 + oa),
                               ld32(a0 + oa + 16), ld32(a1 + oa + 16)};
#pragma unroll
        for (int d = 0; d < kG; ++d) {
          const int t = c0 + d - s;
          if (t < 0 || t > sb) continue;  // warp-uniform
          const long long ob = t * plane_b + kk;
          mma_s8(acc[d][0], a, ld32(b0 + ob), ld32(b0 + ob + 16));
          mma_s8(acc[d][1], a, ld32(b1 + ob), ld32(b1 + ob + 16));
        }
      }
    }
    // Widen into the int64 class sums (this block owns its tile).
#pragma unroll
    for (int d = 0; d < kG; ++d) {
      const int c = c0 + d;
      if (c >= n_cls) break;
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const long long i = row0 + g + (r >= 2 ? 8 : 0);
          const long long j = col0 + ni * 8 + tq * 2 + (r & 1);
          long long* p = cls + (c * rows + i) * n_pad + j;
          *p = (kb == 0 ? 0LL : *p) + acc[d][ni][r];
        }
      }
    }
  }
}

// Rung (8, 8), the benchmark configuration's, with every digit index
// static: a block of 8 warps (4 x 2, each 16 x 16 outputs) owns a 64 x 32
// tile.  Per k step of 32 the block stages the nine A and nine B^T digit
// planes of its tile in shared memory (cp.async, three stages, rows padded
// to 48 bytes so ldmatrix hits distinct banks); each thread copies the
// nine planes of one (row, half) of the A or B tile through a pointer it
// computes once.  Each warp loads its nine A fragments once per k step
// with ldmatrix and, per digit t, one B fragment pair, and issues the 162
// mma of the step from registers into its 17 class sums.
namespace r88 {

constexpr int kS = 9;               // digits per side
constexpr int kCls = 2 * kS - 1;    // classes
constexpr int kBM = 64, kBN = 32;   // block tile
constexpr int kThreads = 256;
constexpr int kRow = 48;            // padded bytes per staged row of 32
constexpr int kABytes = kS * kBM * kRow;
constexpr int kStage = kABytes + kS * kBN * kRow;
constexpr int kStages = 3;
constexpr int kSmem = kStages * kStage;  // 124,416 bytes

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__global__ void __launch_bounds__(kThreads, 1)
    class_kernel(const int8_t* __restrict__ ad, const int8_t* __restrict__ bd,
                 long long plane_a, long long plane_b, long long rows,
                 long long n_pad, long long k_pad, long long kc,
                 long long* __restrict__ cls) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const long long row0 = static_cast<long long>(blockIdx.y) * kBM;
  const long long col0 = static_cast<long long>(blockIdx.x) * kBN;
  // The copies: threads 0-127 own (row, half) of the A tile, 128-191 of
  // the B tile; each walks the nine planes.
  const int tid = threadIdx.x;
  const bool copies = tid < 2 * (kBM + kBN);
  const bool is_a = tid < 2 * kBM;
  const int crow = (is_a ? tid : tid - 2 * kBM) >> 1;
  const int chalf = tid & 1;
  const int8_t* gsrc = is_a ? ad + (row0 + crow) * k_pad + chalf * 16
                            : bd + (col0 + crow) * k_pad + chalf * 16;
  const long long gplane = is_a ? plane_a : plane_b;
  const int soff = (is_a ? crow * kRow : kABytes + crow * kRow) + chalf * 16;
  const int splane = (is_a ? kBM : kBN) * kRow;
  auto load_stage = [&](int st, long long kk) {
    if (copies) {
      const int8_t* g = gsrc + kk;
      unsigned char* d = smem + st * kStage + soff;
#pragma unroll
      for (int p = 0; p < kS; ++p) cp_async16(d + p * splane, g + p * gplane);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // ldmatrix row addresses: lanes 8q..8q+7 give the rows of matrix q.
  // A: matrices (rows 0-7 | 8-15) x (bytes 0-15 | 16-31) -> a0..a3;
  // B: (rows 0-7, bytes 0-15 | 16-31), then rows 8-15 -> b[ni][0..1].
  const int q = lane >> 3, r = lane & 7;
  const int a_off = (wm * 16 + (q & 1) * 8 + r) * kRow + (q >> 1) * 16;
  const int b_off = kABytes + (wn * 16 + (q >> 1) * 8 + r) * kRow +
                    (q & 1) * 16;

  int acc[kCls][2][4];
#pragma unroll
  for (int c = 0; c < kCls; ++c) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[c][0][i] = acc[c][1][i] = 0;
  }
  const long long steps = k_pad / 32;
  load_stage(0, 0);
  if (steps > 1) load_stage(1, 32);
  for (long long step = 0; step < steps; ++step) {
    const long long kk = step * 32;
    // This step's copies are complete once at most one newer group is
    // still in flight.  The barrier also retires every warp's reads of the
    // previous step's stage, which the copies issued next overwrite.
    if (step + 1 < steps) {
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    if (step + 2 < steps) load_stage((step + 2) % kStages, kk + 64);
    const unsigned char* st = smem + (step % kStages) * kStage;
    unsigned a[kS][4];
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      ldmatrix_x4(a[s], st + a_off + s * kBM * kRow);
    }
#pragma unroll
    for (int t = 0; t < kS; ++t) {
      unsigned b[4];
      ldmatrix_x4(b, st + b_off + t * kBN * kRow);
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        mma_s8(acc[s + t][0], a[s], b[0], b[1]);
        mma_s8(acc[s + t][1], a[s], b[2], b[3]);
      }
    }
    if ((kk + 32) % kc == 0 || step + 1 == steps) {
      // widen into the int64 class sums (this block owns its tile)
      const bool first = kk + 32 <= kc;
      const int g = lane >> 2, tq = lane & 3;
#pragma unroll
      for (int c = 0; c < kCls; ++c) {
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const long long row = row0 + wm * 16 + g + (i >= 2 ? 8 : 0);
            const long long col = col0 + wn * 16 + ni * 8 + tq * 2 + (i & 1);
            long long* p = cls + (c * rows + row) * n_pad + col;
            *p = (first ? 0LL : *p) + acc[c][ni][i];
            acc[c][ni][i] = 0;
          }
        }
      }
    }
  }
}

}  // namespace r88

// Balanced signed base-256 digits of x (rows, k), row-major int64 bits,
// anchored per row (mxu.cuh, the port of make_digits): digit u of
// element (r, c)
// goes to out[u][r][c] of (n_slices + 1, rows_pad, k_pad) int8, zeros
// beyond (rows, k).  One thread per output position, c fastest.
__global__ void __launch_bounds__(256)
    mxu_digits_kernel(const long long* __restrict__ x, long long rows,
                      long long k, const long long* __restrict__ anchors,
                      int n_slices, long long rows_pad, long long k_pad,
                      int8_t* __restrict__ out) {
  const long long plane = rows_pad * k_pad;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < plane; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = e / k_pad;
    const long long c = e - r * k_pad;
    long long bits = 0;
    int anchor = 0;
    if (r < rows && c < k) {
      bits = x[r * k + c];
      anchor = static_cast<int>(anchors[r]);
    }
    exblas::balanced_digits(bits, anchor, n_slices, [&](int u, int digit) {
      out[u * plane + e] = static_cast<int8_t>(digit);
    });
  }
}

// One thread per element (i, j) of rows [0, m_rows) x [0, n): combine the
// class sums and beta * c exactly and round once.
__global__ void __launch_bounds__(256)
    mxu_round_kernel(const long long* __restrict__ cls, int n_cls,
                     long long rows, long long n_pad,
                     const int* __restrict__ ea, const int* __restrict__ fb,
                     const long long* __restrict__ c, long long beta,
                     int beta_mode, long long m_rows, long long n, int nl,
                     int rel0, long long* __restrict__ out) {
  const long long total = m_rows * n;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long i = e / n;
    const long long j = e % n;
    long long limbs[kMaxRel];
    for (int l = 0; l < nl; ++l) limbs[l] = 0;
    // Class c has weight 2^(e_base - 8c): relative bit rel0 - 8c.
    for (int cc = 0; cc < n_cls; ++cc) {
      const long long v = cls[(cc * rows + i) * n_pad + j];
      if (v != 0) exblas::add_scaled(limbs, v, rel0 - 8 * cc);
    }
    const int e_base = ea[i] + fb[j] + 2;
    if (beta_mode != 0) {
      long long sn = 0, sp = 0, sm = 0;  // specials: the dispatcher's
      int q;
      unsigned long long lo, hi;
      bool negative;
      if (exblas::decode_product(beta, c[e], rel0 - e_base, q, lo, hi,
                                 negative, sn, sp, sm)) {
        exblas::add_digits<exblas::kDigits>(limbs, nl, q, lo, hi, negative);
      }
    }
    out[e] = static_cast<long long>(
        exblas::round_limbs(limbs, 0, nl - 1, nl, rel0 - e_base));
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
  *grid = static_cast<int>(want < cap ? want : cap);
  return 0;
}

}  // namespace

extern "C" {

// Class sums of `rows` output rows (a multiple of 32; of 64 for the rung
// (8, 8) kernel) against all n_pad columns: ad points at the first row of digit plane 0 of A (planes
// plane_a bytes apart), bd at B^T's digit plane 0 (planes plane_b apart);
// both k_pad-contiguous, k_pad a multiple of 32, kc a multiple of 32.
// cls: int64 (sa+sb+1, rows, n_pad), written whole.  Rung (8, 8) on
// whole 64 x 32 tiles runs the staged kernel, every other case the generic
// one.
int mxu_classes_cuda(const void* ad, const void* bd, int sa, int sb,
                     long long plane_a, long long plane_b, long long rows,
                     long long n_pad, long long k_pad, long long kc,
                     void* cls, void* stream) {
  if (sa == 8 && sb == 8 && rows % r88::kBM == 0 && n_pad % r88::kBN == 0) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        r88::class_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        r88::kSmem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid88(static_cast<unsigned>(n_pad / r88::kBN),
                      static_cast<unsigned>(rows / r88::kBM));
    r88::class_kernel<<<grid88, r88::kThreads, r88::kSmem,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(ad), static_cast<const int8_t*>(bd),
        plane_a, plane_b, rows, n_pad, k_pad, kc,
        static_cast<long long*>(cls));
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid(static_cast<unsigned>(n_pad / kTile),
                  static_cast<unsigned>(rows / kTile),
                  static_cast<unsigned>((sa + sb + 1 + kG - 1) / kG));
  mxu_class_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(ad), static_cast<const int8_t*>(bd), sa, sb,
      plane_a, plane_b, rows, n_pad, k_pad, kc, static_cast<long long*>(cls));
  return static_cast<int>(cudaGetLastError());
}

// Digit planes of x (rows, k) int64 bits, row-major, anchored by the int64
// anchors (rows,): out int8 (n_slices + 1, rows_pad, k_pad), written whole.
int mxu_digits_cuda(const void* x, long long rows, long long k,
                    const void* anchors, int n_slices, long long rows_pad,
                    long long k_pad, void* out, void* stream) {
  int grid = 0;
  const int err = grid_for(rows_pad * k_pad, 256, &grid);
  if (err != 0) return err;
  mxu_digits_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(x), rows, k,
      static_cast<const long long*>(anchors), n_slices, rows_pad, k_pad,
      static_cast<int8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Rounds elements [0, m_rows) x [0, n) from their class sums (as written
// by mxu_classes_cuda), anchors ea (m_rows,) and fb (n,), and beta * c
// (c: (m_rows, n) float64 bits, unused when beta_mode == 0).  nl <= 48
// limbs must hold the exact value relative to 2^(e_base - rel0).
int mxu_round_cuda(const void* cls, int n_cls, long long rows,
                   long long n_pad, const void* ea, const void* fb,
                   const void* c, long long beta, int beta_mode,
                   long long m_rows, long long n, int nl, int rel0,
                   void* out, void* stream) {
  if (nl > kMaxRel) return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  const int err = grid_for(m_rows * n, 256, &grid);
  if (err != 0) return err;
  mxu_round_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(cls), n_cls, rows, n_pad,
      static_cast<const int*>(ea), static_cast<const int*>(fb),
      static_cast<const long long*>(c), beta, beta_mode, m_rows, n, nl, rel0,
      static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
