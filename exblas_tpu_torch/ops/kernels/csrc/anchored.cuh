// The anchored-window arithmetic of kernel B11 (sum_mxu.cu): a thread's
// exact sum of the elements that one global window of W = 32 NW bits
// covers, kept as word sums in shared memory, as B12 (dot_mxu.cu) keeps
// its frame.
//
// Element v (int64 bits) has the lowest-bit exponent max(expf, 1) - 1075,
// read from the exponent field alone (gemv_mxu.py:367-377, trailing zeros
// not read), and sits at sh = that - (E + 1 - W) in the frame whose bit 0
// has exponent E + 1 - W.  It is covered when it is finite and
// 0 <= sh <= W - 53.  Only covered elements are added; a nonzero element
// that is not covered, or a NaN/Inf, sets the flag.  A covered element's
// significand m shifted by sh mod 32 is three 32-bit words y_0..y_2, which
// go to frame words q = sh / 32 .. q + 2 (q + 2 <= NW) of the thread's
// sums of positive or of negative elements: NW + 1 int64 sums a sign,
// lane-private in shared memory and indexed by the word and the sign, so
// an element is three 64-bit read-modify-writes whatever NW is, with no
// two's complement, no negative count and no shifter over the frame.
// (Measured against a register window over the whole frame and against
// register sums with the same sign split: scripts/stream_split.py.)
//
// Headroom: a word is below 2^32 and a call adds at most n <= MAX_N_MXU =
// 2^30 elements, so every sum of one sign's words -- a thread's, a
// block's, the workspace's -- stays below n * 2^32 <= 2^62.
#pragma once

namespace exblas {

template <int NW, int kThreads>
struct SumFrame {
  static constexpr int kWords = NW + 1;
  static constexpr int kMaxSh = 32 * NW - 53;  // the largest covered shift
  // the shared memory a block's frames take, in int64
  static constexpr int kShared = 2 * kWords * kThreads;

  unsigned long long* f;    // word k: f[k kThreads] (+), f[(kWords + k) ..] (-)
  int c;                    // sh = max(expf, 1) - c
  unsigned long long bad;   // nonzero: an uncovered nonzero element
  int exm;                  // the largest exponent field: 0x7FF flags NaN/Inf

  // anchor: E, the exponent of the window's top bit; frame: the block's
  // kShared int64 of shared memory.
  __device__ __forceinline__ void init(int anchor,
                                       unsigned long long* frame) {
    f = frame + threadIdx.x;
#pragma unroll
    for (int k = 0; k < 2 * kWords; ++k) f[k * kThreads] = 0ULL;
    c = anchor + 1075 + 1 - 32 * NW;
    bad = 0ULL;
    exm = 0;
  }

  __device__ __forceinline__ void add(long long v) {
    const int ex = static_cast<int>((v >> 52) & 0x7FF);
    const int sh = (ex > 1 ? ex : 1) - c;
    const bool in = static_cast<unsigned>(sh) <= kMaxSh && ex != 0x7FF;
    if (!in) bad |= static_cast<unsigned long long>(v) << 1;
    exm = max(exm, ex);
    const unsigned long long m =
        in ? (static_cast<unsigned long long>(v) & ((1ULL << 52) - 1ULL)) |
                 (ex != 0 ? 1ULL << 52 : 0ULL)
           : 0ULL;
    const int s = in ? sh : 0;
    const unsigned r = static_cast<unsigned>(s) & 31u;
    const unsigned m0 = static_cast<unsigned>(m);
    const unsigned m1 = static_cast<unsigned>(m >> 32);
    unsigned long long* p = f + ((s >> 5) + (v < 0 ? kWords : 0)) * kThreads;
    p[0] += m0 << r;
    p[kThreads] += __funnelshift_l(m0, m1, r);
    p[2 * kThreads] += __funnelshift_l(m1, 0u, r);
  }

  // This thread's signed sum of word k: positive minus negative.
  __device__ __forceinline__ long long word(int k) const {
    return static_cast<long long>(f[k * kThreads] -
                                  f[(kWords + k) * kThreads]);
  }

  __device__ __forceinline__ bool flagged() const {
    return bad != 0ULL || exm == 0x7FF;
  }
};

}  // namespace exblas
