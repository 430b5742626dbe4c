// Kernel B3 on Hopper: one correct rounding of sum_t v_t * 2^(p_t + e) for
// at most 128 int64 terms at static bit positions.
//
// Replaces exblas_tpu/ops/kernels/round_in_kernel.py::round_scaled_terms
// (_round_terms_kernel), the last step of the TPU's anchored sum and dot
// paths.  The TPU kernel gave each term a lane and folded the lanes through
// a float32 selection matmul (its vector unit has no cheap cross-lane
// integer sum); here one thread adds the terms into int64 limbs in local
// memory and rounds them (round.cuh round_scaled_terms, built on the
// add_scaled/round_limbs that B6's and B9's rounding kernels use).  On the
// card the anchored paths run that same rounding in the last blocks of
// their window kernels B11 and B12 (round.cuh finish_frame), so this
// kernel is off their main path: it is the TPU kernel's counterpart and
// the test bed of the device rounding.
//
// Bound on the H100: the work is a few hundred integer operations, so the
// launch itself is the cost (a few microseconds); chip_smoke.py takes the
// card's empty-launch time as its bound.  The exponent e = *eadj + eadd is
// read on the device: the anchored paths compute it from the data, and
// the host never waits for it.
#include <cuda_runtime.h>

#include "round.cuh"

namespace {

constexpr int kMaxTerms = 128;
constexpr int kMaxTermLimbs = 64;  // MAX_TERM_LIMBS in round_in_kernel.py

struct Positions {
  int p[kMaxTerms];
};

__global__ void round_terms_kernel(const long long* __restrict__ vals,
                                   Positions pos, int t, int nl,
                                   const int* __restrict__ eadj, int eadd,
                                   unsigned long long* __restrict__ out) {
  long long limbs[kMaxTermLimbs];
  *out = exblas::round_scaled_terms(vals, pos.p, t, limbs, nl, *eadj + eadd);
}

}  // namespace

extern "C" {

// vals: t int64 terms on the device; pos: t host ints (copied into the
// launch's parameters); eadj: one int32 on the device.  Writes the bits.
int round_terms_cuda(const void* vals, const void* pos, int t, int nl,
                     const void* eadj, int eadd, void* out, void* stream) {
  if (t < 1 || t > kMaxTerms || nl < 1 || nl > kMaxTermLimbs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Positions p{};
  const int* src = static_cast<const int*>(pos);
  for (int i = 0; i < t; ++i) p.p[i] = src[i];
  round_terms_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(vals), p, t, nl,
      static_cast<const int*>(eadj), eadd,
      static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
