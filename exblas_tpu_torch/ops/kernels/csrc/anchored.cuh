// The anchored-window arithmetic of kernel B11 (sum_mxu.cu): every
// covered element is an integer Y * 2^sh in a fixed frame of NW 32-bit
// words, sh >= 0, added to NW word sums.  (B12, dot_mxu.cu, keeps its
// frame in shared memory instead and uses none of this.)
//
// A negative term enters as its NW-word two's complement U = 2^(32 NW) - X
// and counts once towards a negative count c, so that the exact sum is
//
//   sum_d D_d * 2^(32 d) - c * 2^(32 NW),   D_d = sum of word d of every U,
//
// the excess form of exblas_tpu/ops/kernels/gemv_mxu.py _slice_byte_words
// (there as byte planes and a sign-mask plane for the TPU's int8 matmuls;
// here as 32-bit words added in integer registers).  Each word is below
// 2^32, so D_d < n * 2^32: exact in uint64 for any n, and below 2^63 (an
// int64 on the host) while n <= 2^31.
#pragma once

#include <cstdint>

namespace exblas {

// The fields of one double (int64 bits) that the window check reads:
// the 53-bit significand m (0 for NaN/Inf), the exponent of its lowest
// bit from the exponent field alone, max(expf, 1) - 1075 (as
// gemv_mxu.py:367-377 has it, trailing zeros not read), and whether the
// double is NaN or +-Inf.
__device__ __forceinline__ void decode_anchored(long long b,
                                                unsigned long long& m,
                                                int& e_lsb, bool& special) {
  const int expf = static_cast<int>((b >> 52) & 0x7FF);
  const unsigned long long frac =
      static_cast<unsigned long long>(b) & ((1ULL << 52) - 1ULL);
  special = expf == 0x7FF;
  m = special ? 0ULL : (expf != 0 ? (frac | (1ULL << 52)) : frac);
  e_lsb = (expf != 0 ? expf : 1) - 1075;
}

// word_sums[d] += word d of the NW-word two's complement frame value of
// (neg ? -1 : 1) * Y * 2^(32 q), Y = sum_j y[j] 2^(32 j) (NY words), and
// neg_count += neg.  The caller guarantees Y * 2^(32 q) < 2^(32 NW),
// q < 2^QB, and neg only for Y != 0.  The words are negated over the whole
// frame and then moved up by q words with a logarithmic shifter: every
// index is static, so the frame stays in registers.
template <int NW, int NY, int QB>
__device__ __forceinline__ void add_to_frame(unsigned long long (&word_sums)[NW],
                                             unsigned long long& neg_count,
                                             const unsigned int (&y)[NY],
                                             int q, bool neg) {
  unsigned int w[NW];
  const unsigned int flip = neg ? 0xFFFFFFFFu : 0u;
  unsigned long long carry = neg ? 1ULL : 0ULL;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const unsigned long long t =
        static_cast<unsigned long long>((j < NY ? y[j] : 0u) ^ flip) + carry;
    w[j] = static_cast<unsigned int>(t);
    carry = t >> 32;
  }
#pragma unroll
  for (int s = 0; s < QB; ++s) {
    const bool on = (q >> s) & 1;
#pragma unroll
    for (int j = NW - 1; j >= 0; --j) {
      const unsigned int src = j >= (1 << s) ? w[j - (1 << s)] : 0u;
      w[j] = on ? src : w[j];
    }
  }
#pragma unroll
  for (int j = 0; j < NW; ++j) word_sums[j] += w[j];
  neg_count += neg ? 1ULL : 0ULL;
}

// The end of a B11/B12 block: sum each thread's NW word sums and negative
// count over the block (warp shuffles, then shared memory) and add them to
// ws[0..NW-1] and, negated, to ws[NW] by one integer atomic each; set
// ws[NW + 1] to 1 if any thread saw an uncovered element or a special.
// Integer addition is associative, so the order of the atomics does not
// matter.
template <int NW>
__device__ __forceinline__ void flush_frame(unsigned long long (&word_sums)[NW],
                                            unsigned long long neg_count,
                                            bool bad,
                                            unsigned long long* ws) {
  __shared__ unsigned long long s_sums[32][NW + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      word_sums[j] += __shfl_down_sync(0xFFFFFFFFu, word_sums[j], off);
    }
    neg_count += __shfl_down_sync(0xFFFFFFFFu, neg_count, off);
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < NW; ++j) s_sums[warp][j] = word_sums[j];
    s_sums[warp][NW] = neg_count;
  }
  const int any_bad = __syncthreads_or(bad ? 1 : 0);
  const int warps = (blockDim.x + 31) >> 5;
  if (threadIdx.x <= NW) {
    unsigned long long t = 0ULL;
    for (int wi = 0; wi < warps; ++wi) t += s_sums[wi][threadIdx.x];
    if (threadIdx.x == NW) t = 0ULL - t;  // the count enters negated
    if (t != 0ULL) atomicAdd(&ws[threadIdx.x], t);
  }
  if (threadIdx.x == 0 && any_bad) atomicOr(&ws[NW + 1], 1ULL);
}

}  // namespace exblas
