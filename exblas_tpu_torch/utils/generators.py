"""Test-input generators mirroring the reference's distributions.

A copy of the JAX package's ``exblas_tpu/utils/generators.py`` (this package
may not import that one): the same numpy draws for the same seeds, checked
by array equality in the tests.

Re-implementation (numpy, seedable) of reference src/common/common.cpp:18-150:
``randDouble`` (uniform mantissa x uniform exponent), ``init_fpuniform``
vector/matrix/triangular variants, ``init_lognormal`` variants,
``init_ill_cond`` (Ogita/Rump/Oishi Algorithm 6.1 ill-conditioned dot data),
and ``init_naive`` (all 1.1).  Unlike the reference (C ``rand()``), every
generator takes an explicit seed for deterministic tests.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "rand_double",
    "init_fpuniform",
    "init_fpuniform_matrix",
    "init_fpuniform_tr_matrix",
    "init_lognormal",
    "init_lognormal_matrix",
    "init_lognormal_tr_matrix",
    "init_ill_cond",
    "init_naive",
]


def _rng(seed):
    return np.random.RandomState(seed) if not isinstance(
        seed, np.random.RandomState) else seed


def rand_double(rng, emin: int, emax: int, neg_ratio: int = 1, size=None):
    """Uniform mantissa in [1, 2), uniform exponent in [emin, emax).

    Mirrors reference common.cpp:18-28 (incl. its convention that
    ``neg_ratio <= 1`` means all-positive and ``neg_ratio = k`` flips a sign
    with probability 1/k).
    """
    x = rng.uniform(1.0, 2.0, size)
    e = rng.randint(emin, max(emax, emin + 1), size)
    if neg_ratio > 1:
        flip = rng.randint(0, neg_ratio, size) == 0
        x = np.where(flip, -x, x)
    return np.ldexp(x, e)


def init_fpuniform(n: int, range: int, emax: int, seed=0) -> np.ndarray:
    """Reference common.cpp:30-33: exponents uniform in [emax-range, emax)."""
    rng = _rng(seed)
    return rand_double(rng, emax - range, emax, 1, size=n)


def init_fpuniform_matrix(m: int, n: int, range: int, emax: int,
                          seed=0) -> np.ndarray:
    """Reference common.cpp:35-46 (row-major; exponents in [0, range))."""
    rng = _rng(seed)
    return rand_double(rng, 0, range, 1, size=(m, n))


def init_fpuniform_tr_matrix(uplo: str, diag: str, n: int, range: int,
                             emax: int, seed=0) -> np.ndarray:
    """Reference common.cpp:48-64: triangular matrix; other half zeros."""
    rng = _rng(seed)
    a = rand_double(rng, emax - range, emax, 1, size=(n, n))
    a = np.triu(a) if uplo == "U" else np.tril(a)
    if diag == "U":
        np.fill_diagonal(a, 1.0)
    return a


def init_lognormal(n: int, mean: float = 0.0, stddev: float = 1.0,
                   seed=0) -> np.ndarray:
    """Reference common.cpp:66-73."""
    rng = _rng(seed)
    return rng.lognormal(mean, stddev, n)


def init_lognormal_matrix(m: int, n: int, mean: float = 0.0,
                          stddev: float = 1.0, seed=0) -> np.ndarray:
    """Reference common.cpp:75-90 fills 1.0 (disabled sampling -- a reference
    bug/disable noted in SURVEY §2.4); we generate real lognormal samples."""
    rng = _rng(seed)
    return rng.lognormal(mean, stddev, (m, n))


def init_lognormal_tr_matrix(uplo: str, diag: str, n: int, mean: float = 0.0,
                             stddev: float = 1.0, seed=0) -> np.ndarray:
    """Reference common.cpp:92-111."""
    rng = _rng(seed)
    a = rng.lognormal(mean, stddev, (n, n))
    a = np.triu(a) if uplo == "U" else np.tril(a)
    if diag == "U":
        np.fill_diagonal(a, 1.0)
    return a


def init_ill_cond(n: int, c: float, seed=0) -> np.ndarray:
    """Ogita/Rump/Oishi Algorithm 6.1 ill-conditioned dot-product data with
    anticipated condition number ``c``.  Mirrors reference common.cpp:113-145.
    """
    rng = _rng(seed)
    n2 = int(round(n / 2))
    a = np.zeros(n)
    b = np.log2(c)

    e = np.round(rng.uniform(0.0, 1.0, n2) * b / 2.0)
    if n2 > 0:
        e[0] = np.round(b / 2.0) + 1.0
    # reference sets e[n-1] = 0 before filling the second half
    a[:n2] = (2.0 * rng.uniform(0.0, 1.0, n2) - 1.0) * np.exp2(e)

    step = (b / 2.0) / max(n - n2, 1)
    e2 = step * np.arange(n - n2)
    a[n2:] = (2.0 * rng.uniform(0.0, 1.0, n - n2) - 1.0) * np.exp2(e2)
    return a


def init_naive(n: int) -> np.ndarray:
    """Reference common.cpp:147-150: all elements 1.1."""
    return np.full(n, 1.1)
