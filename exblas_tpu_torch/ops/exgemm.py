"""ExGEMM: C := beta*C + alpha*op(A)@op(B) with exactly accumulated,
reproducible dot products (PyTorch).

Counterpart of ``exblas_tpu/ops/exgemm.py``.  The API mirrors reference
include/blas3.hpp:56 ``exgemm(transa, transb, m, n, k, alpha, a, lda, b,
ldb, beta, c, ldc, fpe, early_exit)``; the reference kernel's effective
semantics are ``C += A*B`` (its alpha/beta are unused), which is the
default here.  The full semantics, as in the JAX package:

* ``z_ik = fl(alpha * a_ik)`` (one correctly rounded multiply; exact when
  alpha == 1);
* ``acc_ij = sum_k exact(z_ik * b_kj)`` (+ exact c_ij when beta == 1, or
  the exact 106-bit product beta*c_ij otherwise; no C term when beta == 0
  or c is None);
* ``C_ij = Round(acc_ij)``: one correctly rounded conversion per element.

Bitwise identical under any k order, tiling or route.  The auto dispatch
follows ``_gemm_bits_auto`` of the JAX package: the cheapest rung
(sa, sb) of ``_MXU_LADDER`` whose spreads and beta*C coverage hold runs the
int8 slice kernel (``kernels/gemm_mxu.py``), else the exact kernel
(``kernels/gemm_kernel.py``) runs, and a per-element override sets the
NaN/Inf results when specials are present.  ``impl="cuda"`` (the default
on a CUDA device) runs the kernels, ``impl="torch"`` (the default on the
CPU) their plain versions through the same ladder.  Devices follow
:mod:`.exsum`: tensors stay where they are, numpy input goes to the CUDA
device unless ``device`` says otherwise.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import deposit as dep
from ..core.f64ops import f64_mul
from ..core.ieee import FRAC_MASK, decode_fields, f64_bits
from ..core.rounding import NINF_BITS, PINF_BITS, QNAN_BITS
from ..utils import profiling
from .exgemv import _apply_ld, _scalar_bits, gemm_acc
from .exsum import _validate_fpe, as_f64, resolve_impl, target_device
from .kernels import gemm_kernel, gemm_mxu
from .kernels.gemm_mxu import MXU_BETA_HEAD, analyze_gemm_operands

__all__ = ["exgemm", "exgemm_bits", "gemm_acc", "plan_gemm"]

# (sa, sb) slice-count rungs, ordered by cost (sa+1)*(sb+1): the cheapest
# pair with spread_a <= 8*sa, spread_b <= 8*sb and beta*C coverage wins.
_MXU_LADDER = gemm_mxu.MXU_LADDER
# k above this runs the exact kernel (the JAX package's cap, kept so that
# both packages route alike).
MXU_K_CAP = (1 << 22) - 2048
_FAR = 1 << 40  # beyond any exponent difference
_MAGNITUDE = (1 << 63) - 1  # every bit of a binary64 pattern but the sign


def _decode_indicators(bits):
    _, expf, mant = decode_fields(bits)
    zero, inf, nan = dep.classify(expf, mant)
    fin = ~(zero | inf | nan)
    pos = bits >= 0
    return dict(zero=zero, nan=nan, pinf=inf & pos, ninf=inf & ~pos,
                finp=fin & pos, finn=fin & ~pos)


def _special_masks_matmul(z_bits, b_bits):
    """Per-element special verdicts (nan, pinf, ninf) as bool (m, n), with
    the counting semantics of dep.product_terms (only count > 0 matters).
    The indicator products are float64 matrix products: counts are exact
    integers below 2^53."""
    A = _decode_indicators(z_bits)
    B = _decode_indicators(b_bits)

    def mm(x, y):
        return x.to(torch.float64) @ y.to(torch.float64)

    inf_a = A["pinf"] | A["ninf"]
    inf_b = B["pinf"] | B["ninf"]
    nan_c = (A["nan"].to(torch.float64).sum(dim=1, keepdim=True)
             + B["nan"].to(torch.float64).sum(dim=0, keepdim=True)
             + mm(inf_a, B["zero"]) + mm(A["zero"], inf_b))
    posb = B["finp"] | B["pinf"]
    negb = B["finn"] | B["ninf"]
    pinf_c = (mm(A["pinf"], posb) + mm(A["ninf"], negb)
              + mm(A["finp"], B["pinf"]) + mm(A["finn"], B["ninf"]))
    ninf_c = (mm(A["pinf"], negb) + mm(A["ninf"], posb)
              + mm(A["finp"], B["ninf"]) + mm(A["finn"], B["pinf"]))
    return nan_c > 0, pinf_c > 0, ninf_c > 0


def _device_scalar(v, device) -> torch.Tensor:
    """A host scalar as a 0-dim tensor on ``device``: a blocking copy on
    a card, counted as the host synchronization ``scalar``."""
    with profiling.host_sync("scalar"):
        return torch.tensor(v, device=device)


def _finite_nonzero(bits: int) -> bool:
    return (bits >> 52) & 0x7FF != 0x7FF and bits & _MAGNITUDE != 0


def _c_cover_bounds(c_bits, beta_bits: int, ea0, fb0):
    """(min of e_lsb - e_base, max of e_msb - e_base) over the finite
    nonzero beta*c products, as 0-dim int64 tensors (+-2^40 when there is
    none): the two numbers every rung's beta*C coverage test reads.  The
    lsb exponent of beta*c is the sum of the operands' (max(expf, 1) -
    1075); its msb lies at most 106 bits above."""
    dev = c_bits.device
    if not _finite_nonzero(beta_bits):
        return _device_scalar(_FAR, dev), _device_scalar(-_FAR, dev)
    e_lsb_b = max((beta_bits >> 52) & 0x7FF, 1) - 1075
    expf_c = (c_bits >> 52) & 0x7FF
    valid = (expf_c != 0x7FF) & ((c_bits & _MAGNITUDE) != 0)
    d = (expf_c.clamp(min=1) + (e_lsb_b - 1075 - 2)
         - (ea0[:, None] + fb0[None, :]))
    lo = torch.where(valid, d, _FAR).amin()
    hi = torch.where(valid, d, -_FAR).amax() + 106
    return lo, hi


def _mxu_c_cover(lo: int, hi: int, sa: int, sb: int) -> bool:
    """Whether every finite nonzero beta*c product, with the bounds
    (lo, hi) of :func:`_c_cover_bounds`, fits rung (sa, sb)'s relative
    accumulator window [anchor - 8(sa+sb), anchor + MXU_BETA_HEAD]."""
    return lo + 8 * (sa + sb) >= 0 and hi <= MXU_BETA_HEAD


def _beta_c_special_flags(c_bits, beta_bits: int):
    """Elementwise (nan, pinf, ninf) bools of the beta*c term, as
    dep.product_terms counts them: NaN or 0*Inf gives NaN, Inf times a
    finite nonzero gives Inf with the xor of the signs.  beta's class is
    read on the host."""
    c = c_bits.view(torch.float64)
    nan, inf = c.isnan(), c.isinf()
    expf_b = (beta_bits >> 52) & 0x7FF
    if expf_b == 0x7FF and beta_bits & FRAC_MASK:  # beta is NaN
        nan, inf = torch.ones_like(nan), torch.zeros_like(inf)
    elif expf_b == 0x7FF:                            # beta is +-Inf
        nan = nan | (c == 0)
        inf = ~nan
    elif beta_bits & _MAGNITUDE == 0:                # beta is +-0
        nan, inf = nan | inf, torch.zeros_like(inf)
    neg = (c_bits < 0) != (beta_bits < 0)
    return nan, inf & ~neg, inf & neg


@dataclasses.dataclass
class GemmPlan:
    """The auto dispatch's choice: ``rung`` (sa, sb) of the slice kernel,
    or None for the exact kernel; the anchors with all-zero rows/columns
    set to 0; whether the slice route needs the special override, and the
    beta*c special flags it then uses."""

    rung: tuple | None
    ea0: torch.Tensor | None = None
    fb0: torch.Tensor | None = None
    override: bool = False
    c_flags: tuple | None = None


@profiling.spanned("exblas.gemm.plan")
def plan_gemm(z_bits, b_bits, c_bits, beta_bits: int,
              beta_mode: str) -> GemmPlan:
    """The route of one ExGEMM call (see module doc).  An empty m, n or k
    takes the exact route, which gives the rounded beta*C alone."""
    if 0 in (*z_bits.shape, b_bits.shape[1]) or z_bits.shape[1] > MXU_K_CAP:
        return GemmPlan(rung=None)
    ea, fb, spread_a, spread_b, has_special_zb = analyze_gemm_operands(
        z_bits, b_bits)
    ea0 = torch.where(ea < -9000, 0, ea)
    fb0 = torch.where(fb < -9000, 0, fb)
    dev = z_bits.device
    lo = _device_scalar(_FAR, dev)
    hi = _device_scalar(-_FAR, dev)
    has_special_c = _device_scalar(False, dev)
    c_flags = None
    if beta_mode != "zero":
        lo, hi = _c_cover_bounds(c_bits, beta_bits, ea0, fb0)
        c_flags = _beta_c_special_flags(c_bits, beta_bits)
        has_special_c = (c_flags[0] | c_flags[1] | c_flags[2]).any()
    # One host sync per call: the JAX package picks the rung on the device
    # (lax.switch); here the packed flags come to the host once.
    packed = torch.stack(
        [spread_a, spread_b, has_special_zb.to(torch.int64),
         has_special_c.to(torch.int64), lo, hi])
    with profiling.host_sync("plan"):
        sp_a, sp_b, spec_zb, spec_c, lo, hi = packed.tolist()
    for sa, sb in _MXU_LADDER:
        if sp_a <= 8 * sa and sp_b <= 8 * sb and _mxu_c_cover(lo, hi, sa, sb):
            return GemmPlan(rung=(sa, sb), ea0=ea0, fb0=fb0,
                            override=bool(spec_zb or spec_c),
                            c_flags=c_flags)
    return GemmPlan(rung=None)


def _gemm_bits_auto(z_bits, b_bits, c_bits, beta_bits: int, beta_mode: str,
                    kernels: bool):
    """z (m, k), b (k, n), c (m, n) int64 bits -> (m, n) bits: the plan's
    route through the CUDA kernels (``kernels``) or their plain versions."""
    plan = plan_gemm(z_bits, b_bits, c_bits, beta_bits, beta_mode)
    if plan.rung is None:
        exact = (gemm_kernel.gemm_bits_cuda if kernels
                 else gemm_kernel.gemm_bits_torch)
        with profiling.annotate("exblas.gemm.exact"):
            return exact(z_bits, b_bits, c_bits, beta_bits, beta_mode)
    mxu = (gemm_mxu.gemm_bits_mxu_cuda if kernels
           else gemm_mxu.gemm_bits_mxu_torch)
    bits = mxu(z_bits, b_bits, c_bits, beta_bits, beta_mode, *plan.rung,
               ea=plan.ea0, fb=plan.fb0)
    if plan.override:
        with profiling.annotate("exblas.gemm.override"):
            nan_m, pos_m, neg_m = _special_masks_matmul(z_bits, b_bits)
            if plan.c_flags is not None:
                nan_m = nan_m | plan.c_flags[0]
                pos_m = pos_m | plan.c_flags[1]
                neg_m = neg_m | plan.c_flags[2]
            is_nan = nan_m | (pos_m & neg_m)
            bits = torch.where(neg_m, NINF_BITS, bits)
            bits = torch.where(pos_m, PINF_BITS, bits)
            bits = torch.where(is_nan, QNAN_BITS, bits)
    return bits


def _operands(transa, transb, a, b, c, m, n, k, lda, ldb, ldc, device):
    """op(A), op(B), C as float64 tensors on the call's device."""
    if lda is not None or ldb is not None or ldc is not None:
        if m is None or n is None or k is None:
            raise ValueError("exgemm: ld* require explicit m, n, k")
        # stored (pre-op) shapes follow BLAS: A is (m, k) unless transa
        if lda is not None:
            a = _apply_ld(a, *((m, k) if transa.upper() == "N" else (k, m)),
                          lda)
        if ldb is not None:
            b = _apply_ld(b, *((k, n) if transb.upper() == "N" else (n, k)),
                          ldb)
        if ldc is not None and c is not None:
            c = _apply_ld(c, m, n, ldc)
    dev = target_device(a, b, c, device=device)
    a = as_f64(a, dev)
    b = as_f64(b, dev)
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError("exgemm: a and b must be matrices")
    if transa.upper() == "T":
        a = a.t()
    if transb.upper() == "T":
        b = b.t()
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"exgemm: inner dims mismatch {a.shape[1]} vs "
                         f"{b.shape[0]}")
    if c is not None:
        c = as_f64(c, dev)
        if tuple(c.shape) != (a.shape[0], b.shape[1]):
            raise ValueError(f"exgemm: c must have shape "
                             f"({a.shape[0]}, {b.shape[1]})")
    return a, b, c


@profiling.spanned("exblas.exgemm_bits")
def exgemm_bits(transa: str, transb: str, alpha: float, a, b,
                beta: float = 1.0, c=None, fpe: int = 3,
                early_exit: bool = False, impl: str | None = None,
                m: int | None = None, n: int | None = None,
                k: int | None = None, lda: int | None = None,
                ldb: int | None = None, ldc: int | None = None,
                device=None) -> torch.Tensor:
    """Reproducible C := beta*C + alpha*op(A)@op(B) as int64 binary64 bits
    (m, n) on the operands' device.  ``fpe``/``early_exit`` are validated
    and accepted; they change neither the route nor the bits."""
    _validate_fpe(fpe, "exgemm")
    a, b, c = _operands(transa, transb, a, b, c, m, n, k, lda, ldb, ldc,
                        device)
    kernels = resolve_impl(impl, a.device) == "cuda"
    beta_mode = "zero" if (beta == 0.0 or c is None) else (
        "one" if beta == 1.0 else "general")
    with profiling.annotate("exblas.gemm.operands"):
        alpha_bits = _device_scalar(_scalar_bits(alpha), a.device)
        z_bits = f64_mul(alpha_bits, f64_bits(a))
        c_bits = f64_bits(c) if beta_mode != "zero" else None
    return _gemm_bits_auto(z_bits, f64_bits(b), c_bits, _scalar_bits(beta),
                           beta_mode, kernels)


@profiling.spanned("exblas.exgemm")
def exgemm(transa: str, transb: str, alpha: float, a, b, beta: float = 1.0,
           c=None, fpe: int = 3, early_exit: bool = False,
           impl: str | None = None, m: int | None = None,
           n: int | None = None, k: int | None = None,
           lda: int | None = None, ldb: int | None = None,
           ldc: int | None = None, device=None) -> torch.Tensor:
    """Reproducible C := beta*C + alpha*op(A)@op(B) (reference default:
    C += A@B) -> a new float64 tensor on the operands' device.

    Mirrors the full reference signature (include/blas3.hpp:56): flat
    column-major buffers are accepted with ``m``/``n``/``k`` and
    ``lda``/``ldb``/``ldc``.  ``fpe == 1`` selects the non-reproducible
    float64 control ``beta*C + (alpha*op(A)) @ op(B)``."""
    if int(fpe) == 1:
        from ..baselines import gemm_baseline

        a, b, c = _operands(transa, transb, a, b, c, m, n, k, lda, ldb, ldc,
                            device)
        return gemm_baseline(alpha * a, b, None if c is None else beta * c)
    bits = exgemm_bits(transa, transb, alpha, a, b, beta=beta, c=c, fpe=fpe,
                       early_exit=early_exit, impl=impl, m=m, n=n, k=k,
                       lda=lda, ldb=ldb, ldc=ldc, device=device)
    return bits.view(torch.float64)
