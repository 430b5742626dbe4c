"""ExSUM: exact (bit-reproducible, correctly rounded) summation (PyTorch).

Counterpart of ``exblas_tpu/ops/exsum.py``.  The API mirrors the reference's
``exsum(Ng, a, inca, offset, fpe, early_exit, parallel)``.  ``fpe`` is
validated and ``early_exit`` accepted for fidelity; neither changes the
launch or the bits: the CUDA kernels run one geometry for every call.

Devices: tensors stay where they are.  Numpy arrays and Python sequences
go to the current CUDA device, or to ``device`` when the caller names one
(``device="cpu"`` asks for the CPU); with no CUDA device and no
``device``, they raise.

Implementations ("impl"):
  * ``"torch"`` -- the plain PyTorch integer path (any device);
  * ``"cuda"``  -- the CUDA kernels (``ops/kernels/``);
  * ``None``    -- follows the device: CUDA tensors take the kernels, CPU
                   tensors the plain path.
``"cuda"`` on a CPU tensor raises; ``"torch"`` on a CUDA tensor runs the
plain path on the card, as asked.

Routes, as in the JAX package (``exblas_tpu/ops/exsum.py``): for
``_SUM_MXU_MIN <= n <= MAX_N_MXU`` the anchored-window ladder
(:func:`_exsum_bits_mxu_auto`, kernels B11 and B3), otherwise the exact
kernel B2 (``sum_kernel.py``); under both implementations alike.

:func:`exsum_segmented` (and its tensor twin
:func:`exsum_segmented_bits`) sums many segments at once.  The JAX
package runs it in XLA (``segment_sum``), with no Pallas kernel, so it is
plain PyTorch on both devices here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import deposit as dep
from ..core.accumulator import to_int32_limbs
from ..core.ieee import f64_bits
from ..core.rounding import (apply_specials, bits_to_float,
                             canonicalize_digits, round_digits_to_f64_bits)
from ..core.types import N_SPECIAL, SUM_FORMAT, Superacc
from ..utils import profiling
from .kernels import sum_kernel, sum_mxu
from .kernels.sum_mxu import (_ANCHOR_SLACK, MAX_N_MXU, device_anchor,
                              exact_anchor, resolve_anchor, sample_anchor)

__all__ = ["exsum", "exsum_acc", "exsum_bits", "exsum_segmented",
           "exsum_segmented_bits"]

# The JAX package's threshold for the anchored ladder (``exsum.py:46-49``),
# kept so that both packages route alike; PERF.md records the ladder
# against the exact kernel on this card around it.
_SUM_MXU_MIN = 1 << 20
# The ladder's windows: nwa words of 32 bits, the widest run with the
# anchor's slack undone, so its boundary carries the slack.
_SUM_TIERS = ((96, 3, 0), (128, 4, 0), (160 + _ANCHOR_SLACK, 5, _ANCHOR_SLACK))


def _validate_fpe(fpe: int, name: str = "exsum"):
    # Reference dispatch accepts 0..8 (src/cpu/blas/blas1/ExSUM.cpp:24-117).
    if not (0 <= int(fpe) <= 8):
        raise ValueError(
            f"{name}: fpe must be in [0, 8], got {fpe} "
            "(0/1: superacc-only; 2-8: FPE size in the reference)"
        )


def resolve_impl(impl: str | None, device: torch.device) -> str:
    """The implementation a call on ``device`` takes (see module doc)."""
    if impl is None:
        if device.type == "cuda":
            return "cuda"
        if device.type == "cpu":
            return "torch"
        raise ValueError(f"no exact path for device {device}")
    if impl == "cuda" and device.type != "cuda":
        raise ValueError(f"impl='cuda' needs a CUDA tensor, got {device}")
    if impl not in ("torch", "cuda"):
        raise ValueError(f"unknown impl {impl!r}")
    return impl


def target_device(*xs, device=None) -> torch.device:
    """The device a call on operands ``xs`` runs on (see module doc):
    ``device`` if given, else that of the tensor operands (which must
    agree), else the current CUDA device."""
    if device is not None:
        return torch.device(device)
    devs = {x.device for x in xs if isinstance(x, torch.Tensor)}
    if len(devs) > 1:
        raise ValueError(
            f"operands on several devices: {sorted(map(str, devs))}")
    if devs:
        return devs.pop()
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device for numpy or sequence input: pass CPU tensors "
            "or device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def as_f64(x, device: torch.device) -> torch.Tensor:
    """``x`` as a float64 tensor on ``device``, keeping its shape."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, dtype=np.float64))
    return x.to(device=device, dtype=torch.float64)


def as_f64_slice(x, inc: int, offset: int,
                 device: torch.device) -> torch.Tensor:
    """``x[offset::inc]`` by numpy's slicing rules (a negative ``inc`` or
    ``offset`` included), on the first axis of an N-D ``x`` as numpy and
    the JAX package slice it, as a float64 tensor on ``device``."""
    x = as_f64(x, device)
    if offset or inc != 1:
        r = range(x.shape[0])[offset::inc]
        x = x[torch.arange(r.start, r.stop, r.step, device=x.device)]
    return x


def as_f64_vector(x, inc: int, offset: int,
                  device: torch.device) -> torch.Tensor:
    """:func:`as_f64_slice`, flattened to a contiguous 1-D tensor."""
    return as_f64_slice(x, inc, offset, device).reshape(-1).contiguous()


def _use_ladder(n: int) -> bool:
    return _SUM_MXU_MIN <= n <= MAX_N_MXU


def _sum_ladder(x: torch.Tensor, fast, exact):
    """The JAX package's three tiers (``exsum.py:52-116``), branched on the
    host: route on the sampled (or, in the guard band, exact) spread to
    the narrowest window that fits it, or straight to the exact kernel;
    run the window kernel at the sampled anchor; if it flags an uncovered
    element or a special, retry the widest window at the exact anchor;
    if that flags too, run the exact kernel.  ``fast(x, anchor, nwa)``
    gives (result, bad); returns (result, the tiers taken in order).
    Host synchronizations: one for the sampled spread (two in the guard
    band), one per window pass for its flag, each counted in
    ``profiling.host_sync.counts``; the steps are the spans
    ``exblas.sum.route``, ``exblas.sum.window.nwa<k>``,
    ``exblas.sum.retry`` and ``exblas.sum.exact``."""
    with profiling.annotate("exblas.sum.route"):
        e_est, spread = resolve_anchor(x, *sample_anchor(x),
                                       [b for b, _, _ in _SUM_TIERS])
        tier = next((t for t in _SUM_TIERS if spread <= t[0]), None)
    if tier is None:
        with profiling.annotate("exblas.sum.exact"):
            return exact(x), ("exact",)
    _, nwa, deslack = tier
    with profiling.annotate(f"exblas.sum.window.nwa{nwa}"):
        out, bad = fast(x, device_anchor(e_est - deslack, x.device), nwa)
        with profiling.host_sync("flag"):
            bad = bool(bad)
    if not bad:
        return out, (f"nwa{nwa}",)
    with profiling.annotate("exblas.sum.retry"):
        out, bad = fast(x, exact_anchor(x), 5)
        with profiling.host_sync("flag"):
            bad = bool(bad)
    if not bad:
        return out, (f"nwa{nwa}", "retry")
    with profiling.annotate("exblas.sum.exact"):
        return exact(x), (f"nwa{nwa}", "retry", "exact")


def _exsum_bits_mxu_auto(x: torch.Tensor, kernels: bool) -> torch.Tensor:
    """Bits through the anchored ladder (B11 + B3 in each window tier, B2
    for the exact tier), or their plain versions.  The tiers taken are in
    ``_exsum_bits_mxu_auto.route``."""
    out, _exsum_bits_mxu_auto.route = _sum_ladder(
        x, lambda v, e, nwa: sum_mxu.sum_bits_mxu(v, e, nwa, kernels),
        sum_kernel.exsum_bits_cuda if kernels
        else sum_kernel.exsum_bits_torch)
    return out


def _exsum_acc_mxu_auto(x: torch.Tensor, kernels: bool) -> Superacc:
    """Superacc twin of :func:`_exsum_bits_mxu_auto` (same tiers): the
    window sum shifted into absolute SUM_FORMAT limbs with zero special
    counts (a special always ends in the exact kernel, which counts it).
    The tiers taken are in ``_exsum_acc_mxu_auto.route``."""
    def fast(v, e, nwa):
        limbs, bad = sum_mxu.sum_acc_limbs_mxu(v, e, nwa, kernels)
        return Superacc(limbs=to_int32_limbs(limbs),
                        special=torch.zeros(N_SPECIAL, dtype=torch.int32,
                                            device=v.device),
                        fmt=SUM_FORMAT), bad

    out, _exsum_acc_mxu_auto.route = _sum_ladder(
        x, fast, sum_kernel.exsum_acc_cuda if kernels
        else sum_kernel.exsum_acc_torch)
    return out


_exsum_bits_mxu_auto.route = ()
_exsum_acc_mxu_auto.route = ()


@profiling.spanned("exblas.exsum_acc")
def exsum_acc(x, inca: int = 1, offset: int = 0, fpe: int = 2,
              early_exit: bool = False, impl: str | None = None,
              device=None) -> Superacc:
    """Exact sum into a Superacc (mergeable, serializable)."""
    _validate_fpe(fpe)
    x = as_f64_vector(x, inca, offset, target_device(x, device=device))
    kernels = resolve_impl(impl, x.device) == "cuda"
    if _use_ladder(x.numel()):
        return _exsum_acc_mxu_auto(x, kernels)
    if kernels:
        return sum_kernel.exsum_acc_cuda(x)
    return sum_kernel.exsum_acc_torch(x)


@profiling.spanned("exblas.exsum_bits")
def exsum_bits(x, inca: int = 1, offset: int = 0, fpe: int = 2,
               early_exit: bool = False, impl: str | None = None,
               device=None) -> torch.Tensor:
    """Exact sum as binary64 bits: a 0-dim int64 tensor on the call's
    device."""
    _validate_fpe(fpe)
    x = as_f64_vector(x, inca, offset, target_device(x, device=device))
    kernels = resolve_impl(impl, x.device) == "cuda"
    if _use_ladder(x.numel()):
        return _exsum_bits_mxu_auto(x, kernels)
    if kernels:
        return sum_kernel.exsum_bits_cuda(x)
    return sum_kernel.exsum_bits_torch(x)


@profiling.spanned("exblas.exsum")
def exsum(x, inca: int = 1, offset: int = 0, fpe: int = 2,
          early_exit: bool = False, impl: str | None = None,
          parallel: bool = True, device=None) -> float:
    """Correctly rounded, reproducible sum(x[offset::inca]) -> Python float.

    ``parallel=False`` mirrors the reference's TBB knob: the sum runs
    single-threaded on the host through the native C++ backend, so the data
    is copied to host memory.  Results are bit-identical either way.
    """
    if not parallel:
        # as in the JAX package, the host path does not check fpe
        from ..cpu_backend import exsum_cpu

        x = as_f64_vector(x, inca, offset, torch.device("cpu"))
        return exsum_cpu(x.numpy(), num_threads=1)
    return bits_to_float(exsum_bits(x, inca=inca, offset=offset, fpe=fpe,
                                    early_exit=early_exit, impl=impl,
                                    device=device))


# Elements one pass of :func:`exsum_segmented_bits` decomposes at once:
# bounds its temporaries (about 200 bytes an element).
SEGMENT_CHUNK = 1 << 22


@profiling.spanned("exblas.exsum_segmented_bits")
def exsum_segmented_bits(x_bits, segment_ids,
                         num_segments: int) -> torch.Tensor:
    """Per-segment exact sums of int64 binary64 patterns -> int64 bits
    (num_segments,) on ``x_bits``' device: ``out[s]`` is the correctly
    rounded sum of ``x[segment_ids == s]``.  ``x_bits`` and the ids
    (tensors on one device) are flattened.  Ids outside
    ``[0, num_segments)`` are dropped, as ``jax.ops.segment_sum`` drops
    them; an empty segment gives +0.  Each element's four limb deposits go
    into (num_segments * 112) int64 limbs by ``index_add_`` (integer
    atomics on a card: exact in any order), a chunk of elements at a
    time; its specials are counted per segment and override the rounding
    in the JAX package's order."""
    if x_bits.dtype != torch.int64:
        raise TypeError(f"exsum_segmented_bits: expected int64 bit "
                        f"patterns, got {x_bits.dtype}")
    L = SUM_FORMAT.n_limbs
    bits = x_bits.reshape(-1)
    seg = segment_ids.reshape(-1).to(device=bits.device, dtype=torch.int64)
    if seg.shape != bits.shape:
        raise ValueError(f"exsum_segmented: {bits.numel()} values but "
                         f"{seg.numel()} segment ids")
    if num_segments == 0:
        return torch.zeros(0, dtype=torch.int64, device=bits.device)
    limbs = torch.zeros(num_segments * L, dtype=torch.int64,
                        device=bits.device)
    special = torch.zeros((num_segments, N_SPECIAL), dtype=torch.int64,
                          device=bits.device)
    offs = torch.arange(4, device=bits.device)[:, None]
    for i in range(0, bits.numel(), SEGMENT_CHUNK):
        s = seg[i:i + SEGMENT_CHUNK]
        # masked before the deposits: index_add_ raises on an id out of
        # range on the CPU, and a card would write out of bounds
        keep = (s >= 0) & (s < num_segments)
        s = torch.where(keep, s, 0)
        t = dep.sum_terms(bits[i:i + SEGMENT_CHUNK], SUM_FORMAT.offset_bits)
        pieces = torch.stack(t["pieces"]) * keep
        limbs.index_add_(0, (s * L + t["q"] + offs).reshape(-1),
                         pieces.reshape(-1))
        special.index_add_(0, s, torch.stack(
            [t["nan"], t["pinf"], t["ninf"]], dim=-1) * keep[:, None])
    digits, negative = canonicalize_digits(limbs.view(num_segments, L))
    bits_out = round_digits_to_f64_bits(digits, negative, SUM_FORMAT)
    return apply_specials(bits_out, special)


@profiling.spanned("exblas.exsum_segmented")
def exsum_segmented(x, segment_ids, num_segments: int,
                    device=None) -> np.ndarray:
    """Reproducible, correctly rounded per-segment sums in one batched pass
    -> a numpy float64 array of length ``num_segments``.

    ``out[s] = exsum(x[segment_ids == s])`` for every segment at once: the
    batched building block of the application studies (``apps/``).  Exact
    deposits make the result independent of element order and of the
    segment layout.  Devices follow the module's rule."""
    dev = target_device(x, segment_ids, device=device)
    if not isinstance(segment_ids, torch.Tensor):
        segment_ids = torch.from_numpy(np.asarray(segment_ids, np.int64))
    bits = exsum_segmented_bits(f64_bits(as_f64(x, dev)),
                                segment_ids.to(dev), int(num_segments))
    return bits.cpu().numpy().view(np.float64)
