// Exact lower-triangular solve T x = b on Hopper (ExTRSV), any data: each
// row i carries an exact DOT_FORMAT accumulator seeded with b_i;
// x_i = Round(acc_i), divided by t_ii unless the diagonal is unit (one
// correctly rounded __ddiv_rn, every NaN made 0x7FF8000000000000); the
// exact 106-bit products -t_ji * x_i are deposited into the rows j > i.
// Only the lower triangle is read, and for a unit diagonal not the
// diagonal either.  Every strictly-lower product is deposited, zeros
// included, so 0 * Inf counts as NaN as in exblas_tpu/core/deposit.py.
//
// Replaces exblas_tpu/ops/kernels/trsv_kernel.py:285 trsv_lower_x_pallas
// (_trsv_kernel).  That kernel relied on its grid running in order on one
// core and carried x from grid step to grid step in VMEM.  Here one
// persistent cooperative launch solves the whole system; the rows are cut
// into blocks of B (128 by default; a multiple of 32 up to 128).
//
//   * Block 0, the solver block, walks the rows in order.  It keeps a
//     window of 2B rows -- the row block being solved and the next -- as
//     kulisch.cuh word accumulators in shared memory, laid out [word][row]
//     with a row stride of 2B + 1, so a warp's lanes on one word of 32 rows,
//     or on 32 words of one row, spread over the banks.
//       - 2B row owners, one thread per window row, 32 consecutive rows a
//         warp in step: the owners of block R's rows load them as words
//         (coalesced; the panels deposited x's blocks 0..R-2 and converted
//         them), add b_j, then deposit -t_jk * x_k for k from block R-1's
//         first row to j - 2, each as soon as x_k is published, T read in
//         32 x 32 tiles staged in shared memory, and hand each row over
//         with t_{j,j-1} and t_jj.
//       - One solver warp does only what is on the chain: for row j it
//         deposits the last product -t_{j,j-1} * x_{j-1}, rounds the row
//         with the whole warp (kulisch.cuh round_words_warp: a word per
//         lane, ballots, shuffles), applies the specials, divides, and
//         publishes x_j in shared memory with a ready flag; each finished
//         block of x goes to device memory at once, with a flag for the
//         panels.  Rows whose special counts decide them skip the rounding.
//     Each waits only on the flags it needs; there is no block-wide
//     barrier after the start.  Slots and block ends are counters, not
//     64-bit divisions, which the card runs as long software sequences.
//   * The other blocks, the panel blocks, take tiles (32 rows of row block
//     R, column block C <= R - 2) in the order (R, C, rows), the next row
//     block first: once x's block C is published (a flag in global memory,
//     release and acquire) a tile deposits its 32 x B exact products into
//     the rows' global accumulators, in B7's JAX layout with 64-bit integer
//     atomics (deposit.cuh BinWindow, one warp per row), and counts itself
//     done; the block that finishes the 32 rows' last tile converts them
//     to words for their owners.  Tiles of 32 rows keep the panels' part
//     of a block transition short: four blocks share the last tile.
// The bits never depend on B or on the order of the panels' atomics:
// every deposit is an exact integer.
//
// Shared memory at B = 128: 68 words x 8 bytes x 257 rows = 139,808 bytes
// of row words, 14,336 bytes of flags, x, special counts and the solver's
// T operands, 67,584 bytes of staged T tiles; the panel blocks use 15,792
// bytes of it.  One block per SM.
//
// Bound on the H100: bytes.  The lower triangle read once, n(n+1)/2 * 8
// bytes: 268.5 MB at n = 8192, 0.080 ms at 3.35 TB/s.  The roofline does
// not see the chain of n dependent steps that no order of work can
// shorten: the deposit of one product into row j, the rounding of row j,
// a divide and a publish, each step's latency the sum of theirs
// (chip_smoke.py TRSV_CHAIN_CYCLES).
#include <cuda_runtime.h>

#include <cstdint>

#include "deposit.cuh"
#include "kulisch.cuh"
#include "round.cuh"

namespace {

using exblas::kDotLimbs;
using exblas::kWords;

constexpr int kMaxBlock = 128;
constexpr int kMaxThreads = 2 * kMaxBlock + 32;
constexpr long long kOneBits = 0x3FF0000000000000LL;  // 1.0
constexpr long long kSign = static_cast<long long>(exblas::kSignBit);
constexpr int kPanelWs = kDotLimbs + 3;  // a panel warp's limbs and counts
// The C entry's parts: the solve, and the solver warp's step stamps.
constexpr int kSolve = 1;
constexpr int kStamps = 2;

struct Args {
  const long long* t;
  const long long* b;
  long long n;
  int unit;
  int B;
  long long nb;          // row blocks
  long long ntasks;      // panel tiles
  long long* acc;        // (n, 216) int64 limbs, zeroed
  long long* special;    // (n, 3) int64 counts, zeroed
  unsigned long long* xdone;   // (nb): x's block published
  int nsub;              // 32-row sub-blocks a row block
  unsigned long long* pcount;  // (nb, nsub): panel tiles done
  unsigned long long* conv;    // (nb, nsub): the rows are in words_g
  unsigned long long* task;    // next panel tile to take
  unsigned long long* words_g; // (nb, 68, B): the panels' sums as words
  long long* stamps;     // 5 cycle sums (kStamps), or null
  long long* x;          // (n) bits out
};

template <typename T>
__device__ __forceinline__ T ld_volatile(const T* p) {
  return *static_cast<const volatile T*>(p);
}

// Shared-memory layout of the solver block (window W = 2B rows).
struct Window {
  unsigned long long* words;  // word i of slot s at words[i * (W + 1) + s]
  long long* xs;              // x_k at xs[k % W]
  int* ready;                 // k + 1 once x_k is in xs
  int* rowdone;               // j + 1 once row j waits only for the solver
  long long* cnt;             // slot s: NaN, +Inf, -Inf at cnt[3 s ..]
  long long* tiles;           // per owner warp: T[32 rows, 32 k], k-major
  long long* tsub;            // slot s: t_{j,j-1} of its row j
  long long* tdiag;           // slot s: t_jj
  int W, S;
};

constexpr int kTileT = 32 * 33;  // an owner warp's staged T, rows padded

__device__ __forceinline__ Window window(unsigned char* smem, int B) {
  Window w;
  w.W = 2 * B;
  w.S = w.W + 1;
  w.words = reinterpret_cast<unsigned long long*>(smem);
  w.xs = reinterpret_cast<long long*>(w.words + kWords * w.S);
  w.cnt = w.xs + w.W;
  w.ready = reinterpret_cast<int*>(w.cnt + 3 * w.W);
  w.rowdone = w.ready + w.W;
  w.tiles = reinterpret_cast<long long*>(w.rowdone + w.W);
  w.tsub = w.tiles + (w.W / 32) * kTileT;
  w.tdiag = w.tsub + w.W;
  return w;
}

// The flags between the warps of the solver block: a release store after
// the data it guards, an acquire once the wanted value is seen.
__device__ __forceinline__ void flag_release(int* flag, int v) {
  __threadfence_block();
  *static_cast<volatile int*>(flag) = v;
}

__device__ __forceinline__ void flag_acquired() { __threadfence_block(); }

__device__ __forceinline__ void wait_shared(const int* flag, int want) {
  while (ld_volatile(flag) != want) {
  }
  flag_acquired();
}

// A row's JAX-layout limbs (canonicalized, 20-bit digits packed into 64-bit
// words, a negative value sign-extended) into words out[i * stride].  The
// limbs come in chunks of 24 loads in flight at once: one at a time, each
// would wait for the last store, as the compiler cannot tell the two
// arrays apart.
__device__ __forceinline__ void convert_row(const long long* limbs,
                                            unsigned long long* out,
                                            long long stride) {
  constexpr int kChunk = 24;  // 216 = 9 x 24
  long long carry = 0;
  unsigned long long cur = 0ULL;
  int fill = 0, wi = 0;
  for (int l0 = 0; l0 < kDotLimbs; l0 += kChunk) {
    long long v[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) v[i] = __ldcg(limbs + l0 + i);
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const long long t = v[i] + carry;
      const long long d = t & exblas::kLimbMask;
      carry = (t - d) >> exblas::kLimbBits;
      cur |= static_cast<unsigned long long>(d) << fill;
      fill += exblas::kLimbBits;
      if (fill >= 64) {
        out[wi * stride] = cur;
        ++wi;
        fill -= 64;
        cur = static_cast<unsigned long long>(d) >>
              (exblas::kLimbBits - fill);
      }
    }
  }
  // 216 * 20 = 67 * 64 + 32: the top word holds 32 digit bits
  if (carry < 0) cur |= ~0ULL << fill;
  out[wi * stride] = cur;
}

// The owners of a warp take 32 consecutive window rows -- a group -- in
// step: one loop over the x's any of them needs, each lane depositing into
// its own row, each row handed over as soon as its last x is in.  A lane
// never waits on a lane of its own warp.
__device__ void row_owner(const Args& a, const Window& win, int slot) {
  unsigned long long* w = win.words + slot;
  const int lane = threadIdx.x & 31;
  // the warp's rows: W is a multiple of 32
  for (long long g = slot - lane; g < a.n; g += win.W) {
    const long long j = g + lane;
    const bool active = j < a.n;
    const long long last = g + 31 < a.n ? g + 31 : a.n - 1;
    const long long R = j / a.B;
    const long long kstart = R >= 1 ? (R - 1) * a.B : 0;
    long long nan_c = 0, pinf_c = 0, ninf_c = 0;
    long long t_sub = 0, t_dg = 0;  // the solver's operands, staged here
    if (active) {
      if (j > 0) t_sub = a.t[j * a.n + j - 1];
      if (!a.unit) t_dg = a.t[j * a.n + j];
      if (R >= 2) {  // x's blocks 0..R-2, as words the panels converted
        const long long sub = (g - R * a.B) / 32;
        while (ld_volatile(a.conv + R * a.nsub + sub) == 0ULL) {
          __nanosleep(128);
        }
        __threadfence();
        const unsigned long long* src =
            a.words_g + R * kWords * a.B + (j - R * a.B);
        for (int i0 = 0; i0 < kWords; i0 += 17) {  // 17 loads in flight
          unsigned long long v[17];
#pragma unroll
          for (int i = 0; i < 17; ++i) v[i] = __ldcg(src + (i0 + i) * a.B);
#pragma unroll
          for (int i = 0; i < 17; ++i) w[(i0 + i) * win.S] = v[i];
        }
        nan_c = __ldcg(a.special + 3 * j);
        pinf_c = __ldcg(a.special + 3 * j + 1);
        ninf_c = __ldcg(a.special + 3 * j + 2);
      } else {
#pragma unroll 4
        for (int i = 0; i < kWords; ++i) w[i * win.S] = 0ULL;
      }
      unsigned long long lo, hi;
      int p;
      bool negative;
      // b_j, seeded as the exact product b_j * 1.0 (NaN/Inf counted alike)
      if (exblas::word_product(a.b[j], kOneBits, lo, hi, p, negative, nan_c,
                               pinf_c, ninf_c)) {
        exblas::add_words(w, win.S, p, lo, hi, negative);
      }
    }
    auto hand_over = [&]() {
      win.tsub[slot] = t_sub;
      win.tdiag[slot] = t_dg;
      win.cnt[3 * slot] = nan_c;
      win.cnt[3 * slot + 1] = pinf_c;
      win.cnt[3 * slot + 2] = ninf_c;
      flag_release(win.rowdone + slot, static_cast<int>(j + 1));
    };
    if (active && j - 2 < kstart) hand_over();  // no x of its own to add
    // the group's x's: from the first row's kstart to the last row's j - 2
    const long long g_block = g / a.B;
    const long long k0 = g_block >= 1 ? (g_block - 1) * a.B : 0;
    // T[g.., k..] comes in 32 x 32 tiles, each row's 32 k in one coalesced
    // load (only the strictly lower part left of the subdiagonal), staged
    // k-major in shared memory.
    long long* tile = win.tiles + (slot / 32) * kTileT;
    // k's slot in the x ring and its column in the tile, kept as counters:
    // a 64-bit division is a long software sequence on the card
    int ks = static_cast<int>(k0 % win.W), off = 0;
    for (long long k = k0; k <= last - 2;
         ++k, ks = ks + 1 == win.W ? 0 : ks + 1, off = (off + 1) & 31) {
      if (off == 0) {
        long long pre[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const long long row = g + i, kk = k + lane;
          pre[i] = row < a.n && kk <= row - 2 ? a.t[row * a.n + kk] : 0LL;
        }
        __syncwarp();
#pragma unroll
        for (int i = 0; i < 32; ++i) tile[lane * 33 + i] = pre[i];
        __syncwarp();
      }
      const long long t_jk = tile[off * 33 + lane];
      wait_shared(win.ready + ks, static_cast<int>(k + 1));
      if (active && k >= kstart && k <= j - 2) {
        unsigned long long lo, hi;
        int p;
        bool negative;
        if (exblas::word_product(t_jk ^ kSign, win.xs[ks], lo, hi, p,
                                 negative, nan_c, pinf_c, ninf_c)) {
          exblas::add_words(w, win.S, p, lo, hi, negative);
        }
        if (k == j - 2) hand_over();
      }
    }
    // the group's rows solved: its slots are free
    wait_shared(win.ready + last % win.W, static_cast<int>(last + 1));
  }
}

// The solver warp.  Lane 0 deposits the chain's product, the warp rounds
// the row, and row j + 1's hand-over is awaited, and its operands read,
// between row j's rounding and its divide, so that the next step starts on
// the chain's product at once.
__device__ void solver_warp(const Args& a, const Window& win) {
  const int lane = threadIdx.x & 31;
  const long long n = a.n;
  long long x_prev = 0;
  long long s_wait = 0, s_dep = 0, s_round = 0, s_div = 0, s_pub = 0;
  const bool stamp = a.stamps != nullptr;
  // row j's hand-over: its special counts and T operands
  long long nan_c, pinf_c, ninf_c, t_sub, t_jj;
  auto take = [&](int s, long long j) {
    wait_shared(win.rowdone + s, static_cast<int>(j + 1));
    nan_c = win.cnt[3 * s];
    pinf_c = win.cnt[3 * s + 1];
    ninf_c = win.cnt[3 * s + 2];
    t_sub = win.tsub[s];
    t_jj = win.tdiag[s];
  };
  {
    const long long c0 = stamp ? clock64() : 0;
    take(0, 0);
    if (stamp) s_wait += clock64() - c0;
  }
  int s = 0;           // j's slot, j % W
  int block_left = a.B;  // rows of j's block from j on
  for (long long j = 0; j < n;
       ++j, s = s + 1 == win.W ? 0 : s + 1,
       block_left = block_left == 1 ? a.B : block_left - 1) {
    long long c0 = stamp ? clock64() : 0;
    unsigned long long* w = win.words + s;
    if (j > 0) {  // the chain's product: -t_{j,j-1} * x_{j-1}
      unsigned long long lo, hi;
      int p;
      bool negative;
      if (exblas::word_product(t_sub ^ kSign, x_prev, lo, hi, p, negative,
                               nan_c, pinf_c, ninf_c) &&
          lane == 0) {
        exblas::add_words(w, win.S, p, lo, hi, negative);
      }
    }
    __syncwarp();
    long long c1 = stamp ? clock64() : 0;
    unsigned long long bits = 0ULL;
    if ((nan_c | pinf_c | ninf_c) == 0) {  // else the specials decide
      const int S = win.S;
      bits = exblas::round_words_warp(
          w[lane * S], w[(lane + 32) * S],
          lane < kWords - 64 ? w[(lane + 64) * S] : 0ULL);
    }
    bits = exblas::apply_specials(bits, nan_c, pinf_c, ninf_c);
    const long long d = t_jj;
    long long c2 = stamp ? clock64() : 0;
    if (j + 1 < n) take(s + 1 == win.W ? 0 : s + 1, j + 1);
    long long c3 = stamp ? clock64() : 0;
    if (!a.unit) {
      const double v = __ddiv_rn(
          __longlong_as_double(static_cast<long long>(bits)),
          __longlong_as_double(d));
      bits = v != v ? exblas::kQNanBits
                    : static_cast<unsigned long long>(__double_as_longlong(v));
    }
    long long c4 = stamp ? clock64() : 0;
    x_prev = static_cast<long long>(bits);
    if (lane == 0) {
      win.xs[s] = x_prev;
      flag_release(win.ready + s, static_cast<int>(j + 1));
    }
    if (block_left == 1 || j + 1 == n) {  // x's block is whole: to x,
      __syncwarp();                        // for the panels
      const int rows = a.B - block_left + 1;
      const long long r0 = j + 1 - rows;
      const int s0 = s + 1 - rows;  // >= 0: a block's slots are contiguous
      for (int r = lane; r < rows; r += 32) a.x[r0 + r] = win.xs[s0 + r];
      __threadfence();
      __syncwarp();
      if (lane == 0) atomicExch(a.xdone + r0 / a.B, 1ULL);
    }
    if (stamp) {
      const long long c5 = clock64();
      s_dep += c1 - c0;
      s_round += c2 - c1;
      s_wait += c3 - c2;
      s_div += c4 - c3;
      s_pub += c5 - c4;
    }
  }
  if (stamp && lane == 0) {
    a.stamps[0] = s_wait;
    a.stamps[1] = s_dep;
    a.stamps[2] = s_round;
    a.stamps[3] = s_div;
    a.stamps[4] = s_pub;
  }
}

// Tile (R, C, sub): the exact products -T[rows, cols of C] . x[cols of C]
// for the 32 rows of sub-block sub of row block R into the rows' global
// accumulators, one warp per row at a time.
__device__ void panel_tile(const Args& a, long long R, long long C, int sub,
                           unsigned long long* sacc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const long long r0 = R * a.B + 32 * sub;
  const long long r1 = r0 + 32 < a.n ? r0 + 32 : a.n;
  const long long c0 = C * a.B, c1 = c0 + a.B;
  constexpr int kPer = kMaxBlock / 32;  // columns a lane takes
  long long xv[kPer];  // x's block C, the same for every row
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const long long c = c0 + 32 * u + lane;
    xv[u] = c < c1 ? __ldcg(a.x + c) : 0LL;
  }
  for (long long r = r0 + warp; r < r1; r += nwarps) {
    const long long* trow = a.t + r * a.n;
    long long tv[kPer];  // the row's loads all in flight at once
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const long long c = c0 + 32 * u + lane;
      tv[u] = c < c1 ? trow[c] ^ kSign : 0LL;
    }
    exblas::BinWindow<exblas::kDigits> bins;
    long long nan_c = 0, pinf_c = 0, ninf_c = 0;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {  // columns past c1 decode 0 * 0
      int q;
      unsigned long long lo, hi;
      bool negative;
      const bool valid =
          exblas::decode_product(tv[u], xv[u], exblas::kDotOffset, q, lo,
                                 hi, negative, nan_c, pinf_c, ninf_c);
      bins.add(valid, q, lo, hi, negative, sacc);
    }
    bins.flush(sacc);
    exblas::deposit_specials(sacc, kDotLimbs, nan_c, pinf_c, ninf_c);
    __syncwarp();
    for (int l = lane; l < kPanelWs; l += 32) {
      const unsigned long long v = sacc[l];
      if (v == 0ULL) continue;
      sacc[l] = 0ULL;
      long long* dst = l < kDotLimbs ? a.acc + r * kDotLimbs + l
                                     : a.special + 3 * r + (l - kDotLimbs);
      atomicAdd(reinterpret_cast<unsigned long long*>(dst), v);
    }
    __syncwarp();
  }
}

__device__ void panel_block(const Args& a, unsigned char* smem) {
  unsigned long long* sacc =
      reinterpret_cast<unsigned long long*>(smem) +
      (threadIdx.x >> 5) * kPanelWs;
  long long* s_task = reinterpret_cast<long long*>(
      reinterpret_cast<unsigned long long*>(smem) +
      (blockDim.x >> 5) * kPanelWs);
  for (int l = threadIdx.x & 31; l < kPanelWs; l += 32) sacc[l] = 0ULL;
  for (;;) {
    if (threadIdx.x == 0) {
      const long long task =
          static_cast<long long>(atomicAdd(a.task, 1ULL));
      long long R = -1, C = 0, sub = 0;
      if (task < a.ntasks) {
        // tasks are ordered (R, C, sub), R >= 2, C <= R - 2: (R - 2)(R - 1)
        // / 2 tiles of nsub tasks come before row block R
        const long long tile = task / a.nsub;
        sub = task - tile * a.nsub;
        R = static_cast<long long>(1.5 + sqrt(2.0 * tile + 0.25));
        while ((R - 2) * (R - 1) / 2 > tile) --R;
        while ((R - 1) * R / 2 <= tile) ++R;
        C = tile - (R - 2) * (R - 1) / 2;
        while (ld_volatile(a.xdone + C) == 0ULL) __nanosleep(256);
        __threadfence();
      }
      s_task[0] = R;
      s_task[1] = C;
      s_task[2] = sub;
    }
    __syncthreads();
    const long long R = s_task[0], C = s_task[1];
    const int sub = static_cast<int>(s_task[2]);
    if (R < 0) return;
    panel_tile(a, R, C, sub, sacc);
    __threadfence();
    __syncthreads();  // every atomic of the tile is visible
    if (threadIdx.x == 0) {
      s_task[3] = atomicAdd(a.pcount + R * a.nsub + sub, 1ULL) ==
                  static_cast<unsigned long long>(R - 2);
    }
    __syncthreads();
    if (s_task[3]) {  // the sub-block's last tile: convert its rows once
      const long long r = R * a.B + 32 * sub + threadIdx.x;
      if (threadIdx.x < 32 && r < a.n) {
        convert_row(a.acc + r * kDotLimbs,
                    a.words_g + R * kWords * a.B + 32 * sub + threadIdx.x,
                    a.B);
      }
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) atomicExch(a.conv + R * a.nsub + sub, 1ULL);
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
    trsv_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char s_dyn[];
  if (blockIdx.x != 0) {
    panel_block(a, s_dyn);
    return;
  }
  const Window win = window(s_dyn, a.B);
  for (int s = threadIdx.x; s < win.W; s += blockDim.x) {
    win.ready[s] = 0;
    win.rowdone[s] = 0;
  }
  __syncthreads();
  // the owners, then the solver warp from the next warp boundary
  if (threadIdx.x < win.W) {
    row_owner(a, win, threadIdx.x);
  } else if (threadIdx.x >= blockDim.x - 32) {
    solver_warp(a, win);
  }
}

}  // namespace

extern "C" {

// t: (n, n) float64 row-major, b: (n,) float64 (both read as int64 bits);
// x: (n,) int64 bits out.  block: the row-block height B, a multiple of 32
// in [32, 128].  acc: n * 216 + nb * (1 + 2 * B / 32) + 9 + nb * 68 * B
// int64 (nb = ceil(n / B)) and special: (n, 3) int64, all zeroed by the
// caller: the rows' accumulators in the JAX layout, the flags of the
// launch (x's blocks published; panel tiles done and rows converted per
// 32-row sub-block; the next panel task), 8 stamp slots, then each row
// block's converted words, laid out [block][word][row].  parts:
// kSolve, plus kStamps to sum the solver warp's clock64() cycles by phase
// (wait, deposit, rounding, divide, publish) into the 5 stamp slots.
int trsv_lower_x_cuda(const void* t, const void* b, long long n, int unit,
                      int block, int parts, void* acc, void* special, void* x,
                      void* stream) {
  if (block < 32 || block > kMaxBlock || block % 32 != 0 ||
      !(parts & kSolve)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  Args a;
  a.t = static_cast<const long long*>(t);
  a.b = static_cast<const long long*>(b);
  a.n = n;
  a.unit = unit;
  a.B = block;
  a.nb = (n + block - 1) / block;
  a.nsub = block / 32;
  a.ntasks = a.nb >= 2 ? (a.nb - 2) * (a.nb - 1) / 2 * a.nsub : 0;
  a.acc = static_cast<long long*>(acc);
  a.special = static_cast<long long*>(special);
  unsigned long long* flags =
      reinterpret_cast<unsigned long long*>(a.acc + n * kDotLimbs);
  const long long nf = a.nb * (1 + 2 * a.nsub);  // the flags before task
  a.xdone = flags;
  a.pcount = flags + a.nb;
  a.conv = a.pcount + a.nb * a.nsub;
  a.task = flags + nf;
  a.stamps = (parts & kStamps) ? reinterpret_cast<long long*>(flags + nf + 1)
                               : nullptr;
  a.words_g = flags + nf + 9;
  a.x = static_cast<long long*>(x);

  const int W = 2 * block;  // a multiple of 32: whole owner warps
  const int threads = W + 32;
  const size_t diag_smem = sizeof(unsigned long long) * kWords * (W + 1) +
                           sizeof(long long) * 4 * W + sizeof(int) * 2 * W +
                           sizeof(long long) * ((W / 32) * kTileT + 2 * W);
  const size_t panel_smem =
      sizeof(unsigned long long) * ((threads / 32) * kPanelWs + 4);
  const size_t smem = diag_smem > panel_smem ? diag_smem : panel_smem;
  cudaError_t err = cudaFuncSetAttribute(
      trsv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, trsv_kernel,
                                                        threads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // every block resident at once: the solver and the panels wait on each
  // other's flags
  const long long cap = static_cast<long long>(sms) * per_sm - 1;
  const long long panels = a.ntasks < cap ? a.ntasks : cap;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(trsv_kernel),
      dim3(static_cast<unsigned>(1 + panels)), dim3(threads), params, smem,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
