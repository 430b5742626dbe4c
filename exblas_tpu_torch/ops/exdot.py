"""ExDOT: exact (bit-reproducible, correctly rounded) dot product (PyTorch).

Counterpart of ``exblas_tpu/ops/exdot.py``; the API mirrors the reference's
``exdot(Ng, ag, inca, offseta, bg, incb, offsetb, fpe, early_exit)``.  The
accumulator covers the full product range down to ``2^-2148``, so products
that underflow double precision are still absorbed exactly.

``impl``, ``device``, the device rules and ``fpe``/``early_exit`` are those
of :mod:`.exsum`.  Both operands must lie on one device.

Routes, as in the JAX package (``exblas_tpu/ops/exdot.py``): for
``_DOT_MXU_MIN <= n <= MAX_N_DOT_MXU`` the anchored-window ladder
(:func:`_dot_mxu_ladder`, kernels B12 and B3), otherwise the exact kernel
B4 (``dot_kernel.py``); under both implementations alike.
"""

from __future__ import annotations

import torch

from ..core.accumulator import to_int32_limbs
from ..core.rounding import bits_to_float
from ..core.types import DOT_FORMAT, N_SPECIAL, Superacc
from ..utils import profiling
from .exsum import _validate_fpe, as_f64_slice, resolve_impl, target_device
from .kernels import dot_kernel, dot_mxu
from .kernels.dot_mxu import MAX_N_DOT_MXU, WINDOW
from .kernels.sum_mxu import (_ANCHOR_SLACK, device_anchor, exact_anchor,
                              resolve_anchor, sample_anchor)

__all__ = ["exdot", "exdot_acc", "exdot_bits"]

# The JAX package's threshold for the anchored ladder (``exdot.py:39-41``),
# kept so that both packages route alike.
_DOT_MXU_MIN = 1 << 20
# The span of the window pass: both sides' windows are WINDOW bits.
_WINDOW_SPAN = f"exblas.dot.window.nwa{WINDOW // 32}"


def _use_mxu(n: int) -> bool:
    return _DOT_MXU_MIN <= n <= MAX_N_DOT_MXU


def _dot_mxu_ladder(a, b, fast, exact):
    """The JAX package's routing (``exdot.py:44-130``), branched on the
    host.  Each side's (anchor, spread) is sampled and resolved against
    the boundary 160 + slack; ``over`` (a spread past it: no window fits)
    goes to the exact kernel; a spread in (160, 168], which only an exact
    resolution gives, runs its side at the anchor with the slack undone
    (``tight``).  The window pass runs at those anchors; if it flags, a
    pass that was ``tight`` goes to the exact kernel (a retry at the same
    exact anchors would flag again), and any other retries at the exact
    anchors, then falls to the exact kernel.  The JAX package runs the
    window pass even when ``over`` (unconditional on the TPU for its
    relayout, ``exdot.py:56-66``) and discards it; the port skips that
    pass, which changes no tier and no bit.  ``fast(a, b, ea, eb)`` gives
    (result, bad); returns (result, the tiers taken).  Host
    synchronizations: one per side for its sampled spread (two in the
    guard band), one per window pass for its flag, each counted in
    ``profiling.host_sync.counts``; the steps are the spans
    ``exblas.dot.route``, ``exblas.dot.window.nwa5`` (both sides' windows
    are 5 words), ``exblas.dot.retry`` and ``exblas.dot.exact``."""
    bound = WINDOW + _ANCHOR_SLACK
    with profiling.annotate("exblas.dot.route"):
        ea_r, spread_a = resolve_anchor(a, *sample_anchor(a), (bound,))
        eb_r, spread_b = resolve_anchor(b, *sample_anchor(b), (bound,))
        over = spread_a > bound or spread_b > bound
    if over:
        with profiling.annotate("exblas.dot.exact"):
            return exact(a, b), ("exact",)
    tight = spread_a > WINDOW or spread_b > WINDOW
    ea_use = ea_r - _ANCHOR_SLACK if spread_a > WINDOW else ea_r
    eb_use = eb_r - _ANCHOR_SLACK if spread_b > WINDOW else eb_r
    with profiling.annotate(_WINDOW_SPAN):
        out, bad = fast(a, b, device_anchor(ea_use, a.device),
                        device_anchor(eb_use, a.device))
        with profiling.host_sync("flag"):
            bad = bool(bad)
    if not bad:
        return out, ("fast",)
    if tight:
        with profiling.annotate("exblas.dot.exact"):
            return exact(a, b), ("fast", "exact")
    with profiling.annotate("exblas.dot.retry"):
        out, bad = fast(a, b, exact_anchor(a), exact_anchor(b))
        with profiling.host_sync("flag"):
            bad = bool(bad)
    if not bad:
        return out, ("fast", "retry")
    with profiling.annotate("exblas.dot.exact"):
        return exact(a, b), ("fast", "retry", "exact")


def _exdot_bits_mxu_auto(a, b, kernels: bool) -> torch.Tensor:
    """Bits through the anchored ladder (B12 + B3 in the window tiers, B4
    for the exact tier), or their plain versions.  The tiers taken are in
    ``_exdot_bits_mxu_auto.route``."""
    out, _exdot_bits_mxu_auto.route = _dot_mxu_ladder(
        a, b, lambda *v: dot_mxu.dot_bits_mxu(*v, kernels),
        dot_kernel.exdot_bits_cuda if kernels
        else dot_kernel.exdot_bits_torch)
    return out


def _exdot_acc_mxu_auto(a, b, kernels: bool) -> Superacc:
    """Superacc twin of :func:`_exdot_bits_mxu_auto` (same tiers): absolute
    DOT_FORMAT limbs with zero special counts.  The tiers taken are in
    ``_exdot_acc_mxu_auto.route``."""
    def fast(*v):
        limbs, bad = dot_mxu.dot_acc_limbs_mxu(*v, kernels)
        return Superacc(limbs=to_int32_limbs(limbs),
                        special=torch.zeros(N_SPECIAL, dtype=torch.int32,
                                            device=limbs.device),
                        fmt=DOT_FORMAT), bad

    out, _exdot_acc_mxu_auto.route = _dot_mxu_ladder(
        a, b, fast, dot_kernel.exdot_acc_cuda if kernels
        else dot_kernel.exdot_acc_torch)
    return out


_exdot_bits_mxu_auto.route = ()
_exdot_acc_mxu_auto.route = ()


def _operands(a, b, inca, offseta, incb, offsetb, fpe, device):
    _validate_fpe(fpe, "exdot")
    dev = target_device(a, b, device=device)
    # the sliced N-D shapes must agree, as in the JAX package
    a = as_f64_slice(a, inca, offseta, dev)
    b = as_f64_slice(b, incb, offsetb, dev)
    if a.shape != b.shape:
        raise ValueError(f"exdot: shape mismatch {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    return a.reshape(-1).contiguous(), b.reshape(-1).contiguous()


@profiling.spanned("exblas.exdot_acc")
def exdot_acc(a, b, inca: int = 1, offseta: int = 0, incb: int = 1,
              offsetb: int = 0, fpe: int = 3, early_exit: bool = False,
              impl: str | None = None, device=None) -> Superacc:
    """Exact dot product into a DOT_FORMAT Superacc."""
    a, b = _operands(a, b, inca, offseta, incb, offsetb, fpe, device)
    kernels = resolve_impl(impl, a.device) == "cuda"
    if _use_mxu(a.numel()):
        return _exdot_acc_mxu_auto(a, b, kernels)
    if kernels:
        return dot_kernel.exdot_acc_cuda(a, b)
    return dot_kernel.exdot_acc_torch(a, b)


@profiling.spanned("exblas.exdot_bits")
def exdot_bits(a, b, inca: int = 1, offseta: int = 0, incb: int = 1,
               offsetb: int = 0, fpe: int = 3, early_exit: bool = False,
               impl: str | None = None, device=None) -> torch.Tensor:
    """Exact dot product as binary64 bits: a 0-dim int64 tensor."""
    a, b = _operands(a, b, inca, offseta, incb, offsetb, fpe, device)
    kernels = resolve_impl(impl, a.device) == "cuda"
    if _use_mxu(a.numel()):
        return _exdot_bits_mxu_auto(a, b, kernels)
    if kernels:
        return dot_kernel.exdot_bits_cuda(a, b)
    return dot_kernel.exdot_bits_torch(a, b)


@profiling.spanned("exblas.exdot")
def exdot(a, b, inca: int = 1, offseta: int = 0, incb: int = 1,
          offsetb: int = 0, fpe: int = 3, early_exit: bool = False,
          impl: str | None = None, device=None) -> float:
    """Correctly rounded, reproducible dot product -> Python float."""
    return bits_to_float(exdot_bits(a, b, inca=inca, offseta=offseta,
                                    incb=incb, offsetb=offsetb, fpe=fpe,
                                    early_exit=early_exit, impl=impl,
                                    device=device))
