"""ExTRSV: solve op(T) x = b by reproducible blocked substitution (PyTorch).

Counterpart of ``exblas_tpu/ops/extrsv.py``.  The API mirrors reference
include/blas2.hpp:57 ``extrsv(uplo, transa, diag, n, a, lda, x, incx, fpe,
early_exit)`` (the reference solves in place over x = b; this returns a
new x).  Semantics, as in the JAX package (reference
ExTRSV.lnn.Superacc.cl:261-347):

* each row i carries an exact DOT_FORMAT superaccumulator seeded with b_i;
* in dependency order ``x_i = fl_div(Round(acc_i), t_ii)`` (unit diagonal:
  ``x_i = Round(acc_i)``), Round and the divide both correctly rounded, every
  NaN the canonical ``0x7FF8000000000000``;
* every update ``acc_j -= t_ji * x_i`` is an exact 106-bit product deposit,
  zero entries of T included (``0 * Inf`` counts as NaN).

Deposits are exact and commutative, so the bits do not depend on the block
size or the order of the updates.  Only the triangle ``uplo`` names is
read, and for ``diag="U"`` not the diagonal.  ``trans="T"`` and
``uplo="U"`` are reduced to the lower solve by a transpose and a flip of T,
as the JAX package does; that costs one copy of T here.

``impl="cuda"`` (the default on a CUDA device) runs kernel B10
(``kernels/trsv_kernel.py``); ``impl="torch"`` (the default on the CPU)
runs the plain blocked sweep :func:`solve_panel` with the JAX package's
block size.  Devices follow :mod:`.exsum`: tensors stay where they are,
numpy input goes to the CUDA device unless ``device`` says otherwise.
``fpe == 1`` runs the non-reproducible float64 control.
"""

from __future__ import annotations

import torch

from ..core import deposit as dep
from ..core.f64ops import f64_div
from ..core.ieee import f64_bits
from ..core.rounding import SIGN_BIT
from ..core.types import DOT_FORMAT, L_DOT, LIMB_BITS, N_SPECIAL
from ..utils import profiling
from .exgemv import (_apply_inc, _apply_ld, deposit_terms_rows, dot_rows_acc,
                     round_rows)
from .exsum import _validate_fpe, as_f64, resolve_impl, target_device
from .kernels import gemv_kernel

__all__ = ["extrsv", "extrsv_bits", "solve_diag_block", "solve_panel"]

# Zero limbs kept above a row's highest nonzero limb when it is rounded:
# 60 bits hold any carry out of int64 limbs.
_CARRY_LIMBS = 3


def _deposit_b(b_bits):
    """Each row's DOT_FORMAT accumulator (n, L) seeded exactly with b_i,
    and its special counts (n, 3)."""
    n = b_bits.shape[0]
    limbs = torch.zeros((n, L_DOT), dtype=torch.int64, device=b_bits.device)
    special = torch.zeros((n, N_SPECIAL), dtype=torch.int64,
                          device=b_bits.device)
    return deposit_terms_rows(limbs, special, b_bits)


def _round_row(limbs, special):
    """Round(acc) of one DOT_FORMAT row (L,) with counts (3,): ``round_rows``
    over the row's nonzero limbs and ``_CARRY_LIMBS`` above them, with that
    window's bit 0 put back -- the value, and so the bits, of the whole
    row, for a few dozen operations instead of several hundred."""
    nz = torch.nonzero(limbs).reshape(-1)
    if nz.numel() == 0:
        lo = hi = 0
    else:
        lo, hi = nz[[0, -1]].tolist()
    top = min(hi + 1 + _CARRY_LIMBS, L_DOT)
    return round_rows(limbs[lo:top], special,
                      offset_bits=DOT_FORMAT.offset_bits - LIMB_BITS * lo)


def solve_diag_block(td_bits, acc_blk, spec_blk, unit: bool):
    """Solve one (block, block) lower-triangular diagonal block given its
    rows' exact accumulators (b minus every deposit from the columns left
    of the block): x_i = Round(acc_i) / t_ii in order, each followed by the
    exact deposits -t_ji * x_i into the rows j > i.  The sequential heart
    of the solve; ``acc_blk`` (block, L) and ``spec_blk`` (block, 3) take
    the in-block deposits in place.  Returns x's bits (block,)."""
    block = td_bits.shape[0]
    xb = torch.empty(block, dtype=torch.int64, device=td_bits.device)
    seg = torch.arange(block, device=td_bits.device) * L_DOT
    flat = acc_blk.view(-1)
    for i in range(block):
        xi = _round_row(acc_blk[i], spec_blk[i])
        if not unit:
            xi = f64_div(xi, td_bits[i, i])
        xb[i] = xi
        if i + 1 < block:
            t = dep.product_terms(td_bits[i + 1:, i] ^ SIGN_BIT,
                                  xi.expand(block - i - 1),
                                  DOT_FORMAT.offset_bits)
            dep.segment_deposit_products(flat, t, seg[i + 1:])
            spec_blk[i + 1:] += torch.stack([t["nan"], t["pinf"], t["ninf"]],
                                            dim=-1)
    return xb


def solve_panel(t_bits, acc, special, unit: bool, block: int,
                kernels: bool = False):
    """Blocked sweep over a (p, p) lower-triangular panel given its rows'
    exact accumulators (b deposited, minus every deposit from the columns
    left of the panel): each diagonal block by :func:`solve_diag_block`,
    then the trailing update of the rows below it with the block's columns
    (``dot_rows_acc``, or with ``kernels`` the row kernel B7 on CUDA
    tensors, as the JAX package's ``impl="pallas"`` runs its GEMV kernel
    there).  ``acc`` (p, L) and ``special`` (p, 3) are updated in place; a
    last block shorter than ``block`` is solved as it is.  Returns x's
    bits (p,)."""
    p = t_bits.shape[0]
    x = torch.empty(p, dtype=torch.int64, device=t_bits.device)
    for base in range(0, p, block):
        end = min(base + block, p)
        x[base:end] = solve_diag_block(t_bits[base:end, base:end],
                                       acc[base:end], special[base:end],
                                       unit)
        if end == p:
            break
        if kernels:
            d_limbs, d_special = gemv_kernel.gemv_rows_acc_cuda(
                t_bits[end:, base:end], x[base:end], negate_z=True)
        else:
            d_limbs, d_special = dot_rows_acc(t_bits[end:, base:end]
                                              ^ SIGN_BIT, x[base:end])
        acc[end:] += d_limbs
        special[end:] += d_special
    return x


def _choose_block(n: int) -> int:
    # the JAX package's rule; the bits do not depend on it
    for b in (32, 16, 8, 4, 2, 1):
        if n % b == 0:
            return b
    return 1


def _operands(uplo, trans, diag, a, b, n, lda, incx, device):
    """(uplo, trans, diag) checked and upper-cased, and T and b as float64
    tensors on the call's device, with the BLAS buffer conventions
    applied."""
    uplo, trans, diag = uplo.upper(), trans.upper(), diag.upper()
    if uplo not in ("L", "U") or trans not in ("N", "T") or \
            diag not in ("N", "U"):
        raise ValueError("extrsv: uplo in L/U, trans in N/T, diag in N/U")
    if lda is not None:
        if n is None:
            raise ValueError("extrsv: lda requires explicit n")
        a = _apply_ld(a, n, n, lda)
    if incx != 1:
        b = _apply_inc(b, n if n is not None else len(a), incx, "extrsv x")
    dev = target_device(a, b, device=device)
    a, b = as_f64(a, dev), as_f64(b, dev)
    if b.dim() != 1:
        raise ValueError("extrsv: b must be 1-D")
    n = b.shape[0]
    if tuple(a.shape) != (n, n):
        raise ValueError(f"extrsv: a must be ({n}, {n})")
    return uplo, trans, diag, a, b


@profiling.spanned("exblas.extrsv_bits")
def extrsv_bits(uplo: str, trans: str, diag: str, a, b, fpe: int = 3,
                early_exit: bool = False, impl: str | None = None,
                n: int | None = None, lda: int | None = None,
                incx: int = 1, device=None) -> torch.Tensor:
    """Reproducible solve of op(T) x = b as int64 binary64 bits (n,) on the
    operands' device.  ``fpe``/``early_exit`` are validated and accepted;
    they change neither the route nor the bits."""
    _validate_fpe(fpe, "extrsv")
    uplo, trans, diag, t, b = _operands(uplo, trans, diag, a, b, n, lda,
                                        incx, device)
    kernels = resolve_impl(impl, t.device) == "cuda"
    if trans == "T":
        t = t.t()
        uplo = "U" if uplo == "L" else "L"
    if uplo == "U":
        # the upper solve is the lower solve of the flipped system P T P
        t = t.flip((0, 1))
        b = b.flip(0)
    from .kernels import trsv_kernel

    t_bits, b_bits = f64_bits(t), f64_bits(b)
    if kernels:
        bits = trsv_kernel.trsv_lower_x_cuda(t_bits, b_bits, diag == "U")
    else:
        bits = trsv_kernel.trsv_lower_x_torch(t_bits, b_bits, diag == "U",
                                              block=_choose_block(b.shape[0]))
    return bits.flip(0) if uplo == "U" else bits


@profiling.spanned("exblas.extrsv")
def extrsv(uplo: str, trans: str, diag: str, a, b, fpe: int = 3,
           early_exit: bool = False, impl: str | None = None,
           n: int | None = None, lda: int | None = None, incx: int = 1,
           device=None) -> torch.Tensor:
    """Reproducible triangular solve -> x as a new float64 tensor on the
    operands' device.

    Mirrors the full reference signature (include/blas2.hpp:57): pass a
    flat column-major buffer with ``n``/``lda`` and a strided right-hand
    side with ``incx`` (the returned solution is dense).  ``fpe == 1``
    selects the non-reproducible float64 control (the reference's DTRSV
    baseline, ExTRSV.cpp:80-81)."""
    if int(fpe) == 1:
        from ..baselines import trsv_baseline

        uplo, trans, diag, t, b = _operands(uplo, trans, diag, a, b, n, lda,
                                            incx, device)
        return trsv_baseline(uplo, trans, diag, t, b)
    bits = extrsv_bits(uplo, trans, diag, a, b, fpe=fpe,
                       early_exit=early_exit, impl=impl, n=n, lda=lda,
                       incx=incx, device=device)
    return bits.view(torch.float64)
