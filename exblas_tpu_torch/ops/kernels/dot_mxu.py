"""The anchored-window ExDOT: kernel B12 (CUDA, ``csrc/dot_mxu.cu``), its
plain version, and the bits and Superacc paths built on it.

Counterpart of ``exblas_tpu/ops/kernels/dot_mxu.py``:

* :func:`dot_flat_cuda` <- ``_run_dot_kernel`` with the extraction of
  ``_dot_epilogue_terms`` (``_dot_flat_kernel``): each vector is covered
  by its own 160-bit window below its anchor (ea, eb), the one static
  kernel of the JAX package (``dot_mxu.py:83-106``); every exact product
  of two covered significands lands at bit sha + shb in [0, 214] of a
  320-bit frame whose bit 0 has exponent ea + eb + 2 - 320, and the frame
  is summed exactly.  ``rel`` is 11 int64 terms, term k at relative bit
  32 k: the canonical digits of the exact sum, terms 0..9 in [0, 2^32) and
  term 10 the sum shifted right by 320 bits (signed), so the terms do not
  depend on how the kernel split its work.  ``bad`` is set when a nonzero
  element of either vector leaves its window (each side checked on its
  own) or any element is NaN/Inf; the caller then discards the result.
  Only pairs covered on both sides are summed, so the terms are the same
  in the kernel and the plain version whatever the flag.
  :func:`dot_flat_torch` is its plain version and returns the same terms;
* :func:`dot_bits_mxu` / :func:`dot_acc_limbs_mxu`: the terms rounded
  once (by the kernel's last block with B3's device code, so a window
  pass is one launch; on the plain path by B3's plain version), or
  shifted into absolute DOT_FORMAT limbs.

The TPU kernel's stacked byte planes, sign masks, ones row and the
cross-plane matmul whose 7/8 of output it discarded served its vector
unit; the windows, the coverage rule and the exact sum are what is left.
"""

from __future__ import annotations

import torch

from ...core.rounding import rel_limbs_to_abs_limbs
from ...core.types import DOT_FORMAT
from ...utils import profiling
from . import _build
from ._build import check_cuda_f64, ptr, stream_of
from .round_in_kernel import (round_scaled_terms_torch, term_limbs_count,
                              terms_to_limbs)
from .sum_mxu import (_CHUNK, _bits, _check_anchor, _decode, _shifted_words,
                      canonical_terms, frame_positions, ws_flag)

__all__ = ["dot_flat_cuda", "dot_flat_torch", "pair_words",
           "signed_word_sums", "canonical_terms", "dot_bits_mxu",
           "dot_acc_limbs_mxu", "MAX_N_DOT_MXU", "WINDOW"]

# The JAX package's bound (dot_mxu.py:71), which also keeps each word sum
# of the 320-bit frame below 2^63.
MAX_N_DOT_MXU = 1 << 31
WINDOW = 160          # bits of each side's window (nwa = nwb = 5)
FRAME_WORDS = 10      # 32-bit words of the 2 * WINDOW frame
FRAME_OFFSET = 2 - 2 * WINDOW   # frame bit 0 = 2^(ea + eb + FRAME_OFFSET)


def _check_pair(a, b, name: str) -> int:
    check_cuda_f64(a, name)
    check_cuda_f64(b, name)
    if a.shape != b.shape or a.device != b.device:
        raise ValueError(f"{name}: operands differ: {tuple(a.shape)} on "
                         f"{a.device} vs {tuple(b.shape)} on {b.device}")
    if a.numel() > MAX_N_DOT_MXU:
        raise ValueError(f"{name}: n = {a.numel()} > MAX_N_DOT_MXU")
    return a.numel()


@profiling.spanned("exblas.launch.dot_flat_cuda")
def _dot_flat_ws(a: torch.Tensor, b: torch.Tensor, ea: torch.Tensor,
                 eb: torch.Tensor):
    """One launch of kernel B12; its workspace (14 int64): the terms, the
    flag, the bits of the rounded dot, and the ticket that tells the last
    block to carry and round the terms."""
    n = _check_pair(a, b, "dot_flat_cuda")
    _check_anchor(ea, a.device, "dot_flat_cuda")
    _check_anchor(eb, a.device, "dot_flat_cuda")
    ws = torch.zeros(FRAME_WORDS + 4, dtype=torch.int64, device=a.device)
    with torch.cuda.device(a.device):
        err = _build.library().dot_flat_cuda(
            ptr(a), ptr(b), n, ptr(ea), ptr(eb), ptr(ws),
            stream_of(a.device))
    _build.check(err, "dot_flat_cuda")
    dot_flat_cuda.launches += 1
    return ws


def dot_flat_cuda(a: torch.Tensor, b: torch.Tensor, ea: torch.Tensor,
                  eb: torch.Tensor):
    """Kernel B12 on two contiguous CUDA float64 tensors of one shape,
    n <= MAX_N_DOT_MXU, at 0-dim int32 anchors on the same device:
    (rel int64 (11,), bad 0-dim bool), both on the device (see the module
    doc)."""
    ws = _dot_flat_ws(a, b, ea, eb)
    return ws[:FRAME_WORDS + 1], ws_flag(ws, FRAME_WORDS + 1)


dot_flat_cuda.launches = 0


def pair_words(va, vb, base_a, base_b):
    """Kernel B12's view of pairs of int64 bit patterns against the windows
    whose bit 0 has exponent ``base_a``, ``base_b``: (words, q, neg, bad),
    the five 32-bit words y_0..y_4 of ma * mb << (s % 32) (0 for a pair not
    covered on both sides), placed at frame words q + j with q = s // 32,
    negative where the product is, and the flag of each pair."""
    ma, sha, add_a, bad_a = _decode(va, base_a, WINDOW)
    mb, shb, add_b, bad_b = _decode(vb, base_b, WINDOW)
    add = add_a & add_b
    ma = torch.where(add, ma, 0)
    s = torch.where(add, sha + shb, 0)
    la = [(ma >> (16 * i)) & 0xFFFF for i in range(4)]
    lb = [(mb >> (16 * j)) & 0xFFFF for j in range(4)]
    prod = [sum(la[i] * lb[k - i] for i in range(4) if 0 <= k - i < 4)
            for k in range(7)]                          # each < 2^34
    return (_shifted_words(prod, s & 31, 5), s >> 5, add & ((va ^ vb) < 0),
            bad_a | bad_b)


def signed_word_sums(words, q, neg) -> torch.Tensor:
    """The word sums B12's threads keep (11 int64): at frame word d, the
    words y_{d - q} of the positive products minus those of the negative
    ones."""
    sums = []
    for d in range(FRAME_WORDS + 1):
        w = sum(torch.where(q == d - j, y, 0)
                for j, y in enumerate(words) if d - j >= 0)
        sums.append(torch.where(neg, -w, w).sum())
    return torch.stack(sums)


def dot_flat_torch(a: torch.Tensor, b: torch.Tensor, ea, eb):
    """Plain version of :func:`dot_flat_cuda` on any device: the same
    terms and flag (anchors ints or one-element tensors)."""
    bits_a, bits_b = _bits(a), _bits(b)
    dev = bits_a.device

    def base(e):
        return torch.as_tensor(e, device=dev).to(torch.int64).reshape(
            ()) + (1 - WINDOW)

    base_a, base_b = base(ea), base(eb)
    rel = torch.zeros(FRAME_WORDS + 1, dtype=torch.int64, device=dev)
    bad = torch.zeros((), dtype=torch.bool, device=dev)
    for c in range(0, bits_a.numel(), _CHUNK):
        words, q, neg, bad_c = pair_words(bits_a[c:c + _CHUNK],
                                          bits_b[c:c + _CHUNK], base_a,
                                          base_b)
        rel += signed_word_sums(words, q, neg)
        bad |= bad_c.any()
    return canonical_terms(rel), bad


def _e_frame(ea, eb) -> torch.Tensor:
    return ea + eb      # int32: anchors lie within [-1023, 1032]


def dot_bits_mxu(a: torch.Tensor, b: torch.Tensor, ea: torch.Tensor,
                 eb: torch.Tensor, kernels: bool):
    """Correctly rounded exact dot of the pairs covered at (ea, eb): (bits
    0-dim int64, bad 0-dim bool) on the device; the caller discards the
    bits when ``bad`` is set.  One launch of B12, which rounds in its last
    block, or the plain B12 and B3."""
    if kernels:
        ws = _dot_flat_ws(a, b, ea, eb)
        return ws[FRAME_WORDS + 2], ws_flag(ws, FRAME_WORDS + 1)
    rel, bad = dot_flat_torch(a, b, ea, eb)
    return round_scaled_terms_torch(rel, frame_positions(FRAME_WORDS),
                                    _e_frame(ea, eb), FRAME_OFFSET), bad


def dot_acc_limbs_mxu(a: torch.Tensor, b: torch.Tensor, ea: torch.Tensor,
                      eb: torch.Tensor, kernels: bool):
    """The exact dot as absolute DOT_FORMAT limbs: (limbs int64 (L_DOT,),
    bad).  Every covered product is a multiple of 2^-2148 (absolute bit
    0), so the shift is exact."""
    rel, bad = (dot_flat_cuda if kernels else dot_flat_torch)(a, b, ea, eb)
    pos = frame_positions(FRAME_WORDS)
    limbs = terms_to_limbs(rel, pos, term_limbs_count(pos))
    p0 = _e_frame(ea, eb).to(torch.int64) + (FRAME_OFFSET
                                             + DOT_FORMAT.offset_bits)
    return rel_limbs_to_abs_limbs(limbs, p0, DOT_FORMAT), bad
