"""Plain reference of ExGEMM: ``C + A @ B`` with every element correctly
rounded from its exact value, and the control, the same in float32.

Plain PyTorch, independent of the program.  Each row of A and each
column of B is cut into radix-2**s digits below its own top power of two
(exact scalings and truncations).  A float64 matrix product of two digit
matrices is exact, because every partial sum is an integer below 2**53
(``2*s + log2(k) <= 52``); a strided sample of every product is checked
against the same dot products in int64, so an inexact library product
raises rather than passes.  The products and the digits of C are added
as int64 limbs per element, carried and rounded once (:mod:`.bigint`).
Blocks of ``ROWS`` rows bound the temporaries.

Domain: alpha = 1, and beta = 1 with C or no C (upstream ExGEMM's
``C += A*B``); finite operands without subnormals.
"""

from __future__ import annotations

import math

import torch

from . import bigint

ROWS = 1024
RADIX_BITS = 20
_SAMPLES = 256


def _check_product(p, ad, bd) -> None:
    """Hold a strided sample of the float64 product ``p = ad @ bd`` of
    integral digit matrices against the same dot products in int64."""
    rows, cols = p.shape
    i = torch.arange(_SAMPLES, device=p.device) * 7919 % rows
    j = torch.arange(_SAMPLES, device=p.device) * 104729 % cols
    exact = (ad[i].to(torch.int64) * bd[:, j].t().to(torch.int64)).sum(1)
    if not bool((p[i, j].to(torch.int64) == exact).all()):
        raise ArithmeticError("a float64 product of digits was not exact")


def _scale(top):
    """A power of two above every element: one above the top exponent,
    and 0 for a row or column of zeros."""
    return torch.where(top == bigint.NONE, 0, top + 1)


def _c_limbs(c, base, s):
    """Limbs of ``c / 2**base`` (an integer per element): a list of
    float64 digit tensors, lowest first."""
    cs = c * bigint.pow2(-base)
    top = int(torch.where(c != 0, bigint.top_exponent(c) - base, 0).max())
    if top > 1023:
        raise ValueError("C lies too far above the products")
    out = []
    for p in range(top // s + 1):
        v = torch.trunc(cs * bigint.pow2(torch.tensor(-s * p)))
        out.append(torch.fmod(v, float(1 << s)))
    return out


def exact_bits(inputs: dict) -> torch.Tensor:
    """int64 (m, n): the bits of the correctly rounded ``C + A @ B``."""
    a, b, c = inputs["a"], inputs["b"], inputs.get("c")
    if inputs.get("alpha", 1.0) != 1.0 or (
            c is not None and inputs.get("beta", 1.0) != 1.0):
        raise NotImplementedError("the reference takes alpha = beta = 1")
    bigint.check_domain(a, b, c)
    m, k = a.shape
    n = b.shape[1]
    s = min(RADIX_BITS, (52 - math.ceil(math.log2(max(k, 2)))) // 2)
    ea = _scale(bigint.top_exponent(a).amax(1))      # (m,)
    fb = _scale(bigint.top_exponent(b).amax(0))      # (n,)
    ta = bigint.digit_count(a, ea[:, None], s)
    tb = bigint.digit_count(b, fb[None, :], s)
    bd = bigint.digits(b, fb[None, :], s, tb)
    top = ta + tb - 2
    out = torch.empty((m, n), dtype=torch.int64, device=a.device)
    for r0 in range(0, m, ROWS):
        rows = slice(r0, min(r0 + ROWS, m))
        ad = bigint.digits(a[rows], ea[rows, None], s, ta)
        # Digit pair (t, u) weighs 2**(ea + fb - s*(t+u+2)): limb
        # top-t-u over the base below, shifted up by `extra` limbs where
        # C reaches lower.
        base = ea[rows, None] + fb[None, :] - s * (top + 2)
        extra = 0
        if c is not None:
            cr = c[rows]
            lsb = bigint.top_exponent(cr) - 52
            under = torch.where(cr != 0, base - lsb, 0)
            extra = max(0, -(-int(under.max()) // s))
        base = base - s * extra
        cd = _c_limbs(c[rows], base, s) if c is not None else []
        limbs = torch.zeros((max(top + extra + 4, len(cd)) + 2,
                             *base.shape), dtype=torch.int64,
                            device=a.device)
        for t, at in enumerate(ad):
            for u, bu in enumerate(bd):
                p = at @ bu
                _check_product(p, at, bu)
                limbs[top - t - u + extra] += p.to(torch.int64)
        for q, d in enumerate(cd):
            limbs[q] += d.to(torch.int64)
        out[rows] = bigint.round_to_f64_bits(bigint.normalize(limbs, s),
                                             base, s)
    return out


def control_bits(inputs: dict) -> torch.Tensor:
    """The control: ``C + A @ B`` in float32 (TF32 off), widened."""
    a, b, c = inputs["a"], inputs["b"], inputs.get("c")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        p = a.to(torch.float32) @ b.to(torch.float32)
        if c is not None:
            p = p + c.to(torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return p.to(torch.float64).view(torch.int64)


def native_bits(inputs: dict) -> torch.Tensor:
    """Native float64 ``C + A @ B``: not correctly rounded."""
    a, b, c = inputs["a"], inputs["b"], inputs.get("c")
    p = a @ b if c is None else torch.addmm(c, a, b)
    return p.view(torch.int64)
