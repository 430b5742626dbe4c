"""ExGEMV: y := alpha*op(A)*x + beta*y with exactly accumulated,
reproducible row dot products (PyTorch), and the row helpers the matrix
routines share.

Counterpart of ``exblas_tpu/ops/exgemv.py``.  The API mirrors reference
include/blas2.hpp:95 ``exgemv(transa, m, n, alpha, a, lda, x, incx, beta,
y, incy, fpe, early_exit)``.  Semantics, as in the JAX package:

* ``z_j = fl(alpha * x_j)``: one correctly rounded multiply;
* each product ``a_ij * z_j`` is accumulated exactly (the 106-bit product
  into a DOT_FORMAT superaccumulator per row);
* ``beta == 0``: no y term; ``beta == 1``: y_i deposited exactly;
  otherwise the exact 106-bit product ``beta * y_i``.  The beta term goes
  into the absolute accumulator, so it has no coverage limit;
* ``y_i = Round(acc_i)``: one correctly rounded conversion per row.

The auto dispatch follows ``_gemv_bits_auto``: :func:`plan_gemv` analyses
the rows of A (kernel B8) and z, and the narrowest rung (nwa, nwz) of
``_GEMV_RUNGS`` whose spreads hold runs the int8 byte-plane kernel B9
(``kernels/gemv_mxu.py``); wider data, or k above ``MAX_K_MXU``, runs the
exact row kernel B7 (``kernels/gemv_kernel.py``) with the beta term and
the rounding here.  A per-row override sets the NaN/Inf results of the B9
route.  The rung is chosen on the host after one read of the packed
flags.  ``impl="cuda"`` (the default on a CUDA device) runs the kernels,
``impl="torch"`` (the default on the CPU) their plain versions through the
same ladder.  Devices follow :mod:`.exsum`: tensors stay where they are,
numpy input goes to the CUDA device unless ``device`` says otherwise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import deposit as dep
from ..core.accumulator import MAX_DOT_TERMS, check_n_terms
from ..core.f64ops import f64_mul
from ..core.ieee import f64_bits
from ..core.rounding import (NINF_BITS, PINF_BITS, QNAN_BITS,
                             apply_specials, canonicalize_digits,
                             round_digits_to_f64_bits)
from ..core.types import DOT_FORMAT, L_DOT, N_SPECIAL
from ..utils import profiling
from .exsum import _validate_fpe, as_f64, resolve_impl, target_device

__all__ = ["exgemv", "exgemv_bits", "plan_gemv", "dot_rows_acc",
           "gemm_acc", "deposit_terms_rows", "round_rows"]

# (nwa, nwz) word counts: 32*nwa / 32*nwz anchored bits per side.  The
# ladder picks the narrowest rung covering both the A rows' spread and
# z's; past 512 / 224 bits the exact kernel runs.
_GEMV_RUNGS = ((2, 2), (3, 3), (4, 4), (5, 4), (6, 5), (8, 6),
               (12, 7), (16, 7))
# Products the plain row deposit decomposes at once: bounds its
# temporaries.
PRODUCTS_PER_PASS = 1 << 21


def _scalar_bits(v: float) -> int:
    """The binary64 bit pattern of ``v`` as a signed 64-bit Python int."""
    return int(np.float64(v).view(np.int64))


def gemm_acc(z_bits, b_bits):
    """Exact DOT_FORMAT accumulators of z @ b: int64 limbs (m*n, L) and
    special counts (m*n, 3), by the plain product deposit, about
    ``PRODUCTS_PER_PASS`` products at a time."""
    m, k = z_bits.shape
    n = b_bits.shape[1]
    check_n_terms(k, MAX_DOT_TERMS)
    dev = z_bits.device
    limbs = torch.zeros(m * n * L_DOT, dtype=torch.int64, device=dev)
    special = torch.zeros((m * n, N_SPECIAL), dtype=torch.int64, device=dev)
    seg = torch.arange(m * n, device=dev).reshape(m, 1, n) * L_DOT
    kc = max(1, PRODUCTS_PER_PASS // max(1, m * n))
    for k0 in range(0, k, kc):
        t = dep.product_terms(z_bits[:, k0:k0 + kc, None],
                              b_bits[None, k0:k0 + kc, :],
                              DOT_FORMAT.offset_bits)
        dep.segment_deposit_products(limbs, t, seg)
        special += torch.stack([t[s].sum(dim=1).reshape(-1)
                                for s in ("nan", "pinf", "ninf")], dim=-1)
    return limbs.view(m * n, L_DOT), special


def dot_rows_acc(a_bits, z_bits):
    """Exact per-row dot accumulators of a (m, k) against z, int64 bits:
    limbs int64 (m, L) in DOT_FORMAT and special counts int64 (m, 3).  A
    z of shape (k,) is one vector for every row (:func:`gemm_acc` with
    one column); a z of shape (m, k) gives each row its own, as the JAX
    package's ``dot_rows_acc_xla`` takes it (the row dots of SpMV): the
    element-wise products are deposited into their rows, about
    ``PRODUCTS_PER_PASS`` at a time."""
    if z_bits.dim() == 1:
        return gemm_acc(a_bits, z_bits[:, None])
    m, k = a_bits.shape
    if tuple(z_bits.shape) != (m, k):
        raise ValueError(f"dot_rows_acc: z of shape {tuple(z_bits.shape)} "
                         f"for rows of shape {(m, k)}")
    check_n_terms(k, MAX_DOT_TERMS)
    dev = a_bits.device
    limbs = torch.zeros(m * L_DOT, dtype=torch.int64, device=dev)
    special = torch.zeros((m, N_SPECIAL), dtype=torch.int64, device=dev)
    rc = max(1, PRODUCTS_PER_PASS // max(1, k))
    for r0 in range(0, m, rc):
        rows = slice(r0, r0 + rc)
        t = dep.product_terms(a_bits[rows], z_bits[rows],
                              DOT_FORMAT.offset_bits)
        seg = torch.arange(r0, min(m, r0 + rc), device=dev)[:, None] * L_DOT
        dep.segment_deposit_products(limbs, t, seg)
        special[rows] += torch.stack([t[s].sum(dim=1)
                                      for s in ("nan", "pinf", "ninf")],
                                     dim=-1)
    return limbs.view(m, L_DOT), special


def deposit_terms_rows(limbs, special, bits):
    """Exactly deposit one double per row into (m, L) int64 limb rows and
    add its special counts to ``special`` (m, 3).  In place; returns both."""
    m, L = limbs.shape
    t = dep.sum_terms(bits.reshape(-1), DOT_FORMAT.offset_bits)
    base = torch.arange(m, device=limbs.device) * L + t["q"]
    flat = limbs.view(-1)
    for off, piece in enumerate(t["pieces"]):
        flat.index_add_(0, base + off, piece)
    special += torch.stack([t["nan"], t["pinf"], t["ninf"]], dim=-1)
    return limbs, special


def _apply_beta_rows(limbs, special, beta_bits: int, y_bits,
                     beta_mode: str):
    """Deposit the beta term into the (m, L) DOT_FORMAT rows, in place:
    y_i exactly for beta == 1, the exact 106-bit product beta*y_i for
    general beta (the reference's EFT beta cases,
    ExGEMV.Superacc.cl:259-293), nothing for beta == 0."""
    if beta_mode == "one":
        return deposit_terms_rows(limbs, special, y_bits)
    if beta_mode == "general":
        y = y_bits.reshape(-1)
        t = dep.product_terms(torch.full_like(y, beta_bits), y,
                              DOT_FORMAT.offset_bits)
        seg = torch.arange(y.numel(), device=y.device) * L_DOT
        dep.segment_deposit_products(limbs.view(-1), t, seg)
        special += torch.stack([t["nan"], t["pinf"], t["ninf"]], dim=-1)
    return limbs, special


def round_rows(limbs, special, offset_bits: int | None = None):
    """Batched correctly rounded conversion of DOT_FORMAT rows (..., L)
    with their special counts (..., 3) -> int64 bits (...,).  A window of
    limbs whose bit 0 is not DOT_FORMAT's passes its own ``offset_bits``."""
    digits, negative = canonicalize_digits(limbs)
    bits = round_digits_to_f64_bits(digits, negative, DOT_FORMAT,
                                    offset_bits)
    return apply_specials(bits, special)


def _apply_ld(a, m: int, n: int, lda: int):
    """Reinterpret a flat column-major buffer with leading dimension lda as
    the logical (m, n) matrix -- the BLAS convention of the reference
    signatures (include/blas2.hpp:57,95, blas3.hpp:56).  Takes a tensor
    (returns a view) or anything numpy reads."""
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a, np.float64)
    buf = a.reshape(-1)
    if lda < m or buf.shape[0] < lda * n:
        raise ValueError(f"lda={lda} too small for {m}x{n}")
    return buf[: lda * n].reshape(n, lda)[:, :m].T


def _apply_inc(v, n: int, inc: int, name: str):
    """BLAS vector stride: element i lives at v[i * inc].  Takes a tensor
    (returns a view) or anything numpy reads."""
    if inc == 1:
        return v
    if not isinstance(v, torch.Tensor):
        v = np.asarray(v, np.float64)
    buf = v.reshape(-1)
    if inc <= 0:
        raise ValueError(f"{name}: inc must be positive, got {inc}")
    out = buf[::inc]
    if out.shape[0] < n:
        raise ValueError(f"{name}: buffer too small for n={n}, inc={inc}")
    return out[:n]


# ---------------------------------------------------------------------------
# The auto dispatch
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GemvPlan:
    """The auto dispatch's choice: ``rung`` (nwa, nwz) of the byte-plane
    kernel, or None for the exact kernel; the row anchors ``ea0`` and the z
    anchor ``f0`` with the all-zero sentinels set to 0; whether the rung
    route needs the special override, and the beta*y special flags it then
    uses."""

    rung: tuple | None
    ea0: torch.Tensor | None = None
    f0: torch.Tensor | None = None
    override: bool = False
    y_flags: tuple | None = None


def plan_gemv(a_bits, z_bits, y_bits, beta_bits: int, beta_mode: str,
              kernels: bool) -> GemvPlan:
    """The route of one ExGEMV call on a (m, k), z (k,), y (m,) int64 bits
    (see module doc).  ``kernels``: analyse the rows with kernel B8."""
    # imported here: the kernel modules import this module's row helpers
    from .exgemm import _beta_c_special_flags
    from .kernels import gemv_mxu

    m, k = a_bits.shape
    if m == 0 or k == 0 or -(-k // 256) * 256 > gemv_mxu.MAX_K_MXU:
        return GemvPlan(rung=None)
    analyze = (gemv_mxu.analyze_gemv_rows_cuda if kernels
               else gemv_mxu.analyze_gemv_rows_torch)
    ea, spread_a, has_special_a = analyze(a_bits)
    f, spread_z, has_special_z = gemv_mxu.analyze_z(z_bits)
    has_special_y = torch.tensor(False, device=a_bits.device)
    y_flags = None
    if beta_mode != "zero":
        y_flags = _beta_c_special_flags(y_bits, beta_bits)
        has_special_y = (y_flags[0] | y_flags[1] | y_flags[2]).any()
    # One host sync per call: the JAX package picks the rung on the device
    # (lax.switch); here the packed flags come to the host once.
    sp_a, sp_z, spec = torch.stack(
        [spread_a.to(torch.int64), spread_z.to(torch.int64),
         (has_special_a | has_special_z | has_special_y).to(torch.int64)]
    ).tolist()
    for nwa, nwz in _GEMV_RUNGS:
        if sp_a <= 32 * nwa and sp_z <= 32 * nwz:
            return GemvPlan(rung=(nwa, nwz),
                            ea0=torch.where(ea < -9000, 0, ea),
                            f0=torch.where(f < -9000, 0, f),
                            override=bool(spec), y_flags=y_flags)
    return GemvPlan(rung=None)


def _gemv_bits_auto(a_bits, z_bits, y_bits, beta_bits: int, beta_mode: str,
                    kernels: bool):
    """a (m, k), z (k,), y (m,) int64 bits -> (m,) bits: the plan's route
    through the CUDA kernels (``kernels``) or their plain versions."""
    from .exgemm import _special_masks_matmul
    from .kernels import gemv_kernel, gemv_mxu

    plan = plan_gemv(a_bits, z_bits, y_bits, beta_bits, beta_mode, kernels)
    if plan.rung is None:
        rows_acc = (gemv_kernel.gemv_rows_acc_cuda if kernels
                    else gemv_kernel.gemv_rows_acc_torch)
        limbs, special = rows_acc(a_bits, z_bits)
        limbs, special = _apply_beta_rows(limbs, special, beta_bits, y_bits,
                                          beta_mode)
        return round_rows(limbs, special)
    mxu = (gemv_mxu.gemv_bits_mxu_cuda if kernels
           else gemv_mxu.gemv_bits_mxu_torch)
    bits = mxu(a_bits, z_bits, plan.ea0, plan.f0, y_bits, beta_bits,
               beta_mode, *plan.rung)
    if plan.override:
        nan_m, pos_m, neg_m = (x[:, 0] for x in
                               _special_masks_matmul(a_bits, z_bits[:, None]))
        if plan.y_flags is not None:
            nan_m = nan_m | plan.y_flags[0]
            pos_m = pos_m | plan.y_flags[1]
            neg_m = neg_m | plan.y_flags[2]
        is_nan = nan_m | (pos_m & neg_m)
        bits = torch.where(neg_m, NINF_BITS, bits)
        bits = torch.where(pos_m, PINF_BITS, bits)
        bits = torch.where(is_nan, QNAN_BITS, bits)
    return bits


def _operands(trans, a, x, beta, y, m, n, lda, incx, incy, device):
    """op(A), x and y (None when beta == 0) as float64 tensors on the
    call's device, with the BLAS buffer conventions applied."""
    trans = trans.upper()
    if trans not in ("N", "T"):
        raise ValueError(f"exgemv: trans must be 'N' or 'T', got {trans!r}")
    if lda is not None:
        if m is None or n is None:
            raise ValueError("exgemv: lda requires explicit m and n")
        a = _apply_ld(a, m, n, lda)
    dev = target_device(a, x, y, device=device)
    a = as_f64(a, dev)
    if a.dim() != 2:
        raise ValueError("exgemv: a must be 2-D")
    if trans == "T":
        a = a.t()
    m, n = a.shape
    x = as_f64(_apply_inc(x, n, incx, "exgemv x"), dev)
    if tuple(x.shape) != (n,):
        raise ValueError(f"exgemv: x must have shape ({n},)")
    if beta == 0.0:
        return a, x, None
    if y is None:
        raise ValueError("exgemv: beta != 0 requires y")
    y = as_f64(_apply_inc(y, m, incy, "exgemv y"), dev)
    if tuple(y.shape) != (m,):
        raise ValueError(f"exgemv: y must have shape ({m},)")
    return a, x, y


@profiling.spanned("exblas.exgemv_bits")
def exgemv_bits(trans: str, alpha: float, a, x, beta: float = 0.0, y=None,
                fpe: int = 3, early_exit: bool = False,
                impl: str | None = None, m: int | None = None,
                n: int | None = None, lda: int | None = None,
                incx: int = 1, incy: int = 1, device=None) -> torch.Tensor:
    """Reproducible y := alpha*op(A)*x + beta*y as int64 binary64 bits
    (m,) on the operands' device.  ``fpe``/``early_exit`` are validated
    and accepted; they change neither the route nor the bits.  A
    transposed A is copied to row-major order once (``trans="T"``)."""
    _validate_fpe(fpe, "exgemv")
    a, x, y = _operands(trans, a, x, beta, y, m, n, lda, incx, incy, device)
    kernels = resolve_impl(impl, a.device) == "cuda"
    beta_mode = "zero" if beta == 0.0 else ("one" if beta == 1.0
                                            else "general")
    alpha_bits = torch.tensor(_scalar_bits(alpha), device=a.device)
    z_bits = f64_mul(alpha_bits, f64_bits(x))
    y_bits = f64_bits(y) if y is not None else None
    return _gemv_bits_auto(f64_bits(a), z_bits, y_bits, _scalar_bits(beta),
                           beta_mode, kernels)


@profiling.spanned("exblas.exgemv")
def exgemv(trans: str, alpha: float, a, x, beta: float = 0.0, y=None,
           fpe: int = 3, early_exit: bool = False, impl: str | None = None,
           m: int | None = None, n: int | None = None,
           lda: int | None = None, incx: int = 1, incy: int = 1,
           device=None) -> torch.Tensor:
    """Reproducible y := alpha*op(A)*x + beta*y -> a new float64 tensor on
    the operands' device.

    Mirrors the full reference signature (include/blas2.hpp:95): pass a
    flat column-major buffer with ``m``/``n``/``lda`` and strided vectors
    with ``incx``/``incy`` (the returned y is dense).  ``fpe == 1``
    selects the non-reproducible float64 control (the reference's DGEMV.cl
    baseline, ExGEMV.cpp:92-94)."""
    if int(fpe) == 1:
        from ..baselines import gemv_baseline

        a, x, y = _operands(trans, a, x, beta, y, m, n, lda, incx, incy,
                            device)
        return gemv_baseline("N", alpha, a, x, beta=beta, y=y)
    bits = exgemv_bits(trans, alpha, a, x, beta=beta, y=y, fpe=fpe,
                       early_exit=early_exit, impl=impl, m=m, n=n, lda=lda,
                       incx=incx, incy=incy, device=device)
    return bits.view(torch.float64)
