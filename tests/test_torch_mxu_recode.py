"""The int8 kernels' excess-128 recode and exact chunks, in plain PyTorch,
against the JAX package.  ``excess_digits`` is the plain model of the
recode that the digit kernel and the rung (2, 2) GEMV kernel run
(``csrc/mxu.cuh``); it must give ``make_digits``' digits, the port's and
the JAX package's, at every rung width, on negative elements, zeros,
subnormals and specials, elements whose top byte carries into the carry
digit, elements at the coverage edge and one bit past it.  The plain slice
paths must give the same bits whatever their chunk constant, and the
JAX package's bits.  Tolerance is zero.  The kernels themselves are held
against these plain versions on the card by ``chip_smoke.py``."""

import importlib

import numpy as np
import pytest
import torch

from exblas_tpu.core.ieee import split_f64
from exblas_tpu_torch.ops.kernels import gemm_mxu as tmxu
from exblas_tpu_torch.ops.kernels import gemv_mxu as vmxu

JGEMM = importlib.import_module("exblas_tpu.ops.exgemm")
JGEMV = importlib.import_module("exblas_tpu.ops.exgemv")
EGEMV = importlib.import_module("exblas_tpu_torch.ops.exgemv")

# every digit count a rung gives a side: the GEMM ladder's sa and sb, the
# GEMV rungs' 4 nwa and 4 nwz
WIDTHS = (8, 12, 16, 20, 24, 28, 32, 40, 48, 64)
K = 48
NAN_BITS = np.int64(0x7FF8000000000123)
PINF_BITS = np.int64(0x7FF0000000000000)
NEG = np.int64(-0x8000000000000000)


def _normal(rs, e, n, odd=False):
    """n normal binary64 bit patterns with leading-bit exponents e (array
    or int), random significands (odd ones if ``odd``) and signs."""
    e = np.broadcast_to(np.asarray(e, np.int64), (n,))
    frac = rs.randint(0, 1 << 52, size=n, dtype=np.int64)
    if odd:
        frac |= 1
    bits = ((e + 1023) << 52) | frac
    return np.where(rs.rand(n) < 0.5, bits | NEG, bits).astype(np.int64)


def recode_case(ns: int, seed: int):
    """(bits (rows, K) int64, anchors (rows,) int64): one row per kind of
    element, each anchored at (or above) its largest leading bit."""
    rs = np.random.RandomState(seed)
    rows, anchors = [], []
    # anywhere in the window of anchor 10, both signs
    rows.append(_normal(rs, rs.randint(10 - 8 * ns + 53, 11, size=K), K))
    anchors.append(10)
    # top byte >= 0x80 (leading bit at the anchor: a carry of +-1), the
    # largest significand, zeros of both signs and specials
    top = _normal(rs, 10, K)
    top[0] = np.int64((1033 << 52) | ((1 << 52) - 1))
    top[1] = top[0] | NEG
    top[2:6] = [0, NEG, NAN_BITS, PINF_BITS | NEG]
    rows.append(top)
    anchors.append(10)
    # the coverage edge (lsb at the lowest weight) and one bit past it
    edge = _normal(rs, -100 + 53 - 8 * ns, K, odd=True)
    edge[K // 2:] = _normal(rs, -100 + 52 - 8 * ns, K - K // 2, odd=True)
    edge[0] = _normal(rs, -100, 1)[0]
    rows.append(edge)
    anchors.append(-100)
    # subnormals under a subnormal anchor, and the smallest ones
    sub = rs.randint(1 << 30, 1 << 31, size=K, dtype=np.int64)
    sub = np.where(rs.rand(K) < 0.5, sub | NEG, sub)
    sub[:4] = [1, 1 | NEG, 3, 0]
    rows.append(sub)
    anchors.append(-1044)
    # the largest exponents
    rows.append(_normal(rs, rs.randint(1023 - 8 * ns + 53, 1024, size=K), K))
    anchors.append(1023)
    # an all-zero row, anchored at 0 as the dispatcher does
    rows.append(np.zeros(K, np.int64))
    anchors.append(0)
    return (torch.from_numpy(np.stack(rows)),
            torch.tensor(anchors, dtype=torch.int64))


@pytest.mark.parametrize("ns", WIDTHS)
def test_excess_digits_match_make_digits(ns):
    bits, anchors = recode_case(ns, 7000 + ns)
    for x, axis in ((bits, 0), (bits.t().contiguous(), 1)):
        want = tmxu.make_digits(x, anchors, ns, axis)
        got = tmxu.excess_digits(x, anchors, ns, axis)
        assert got.dtype == torch.int8 and got.shape == want.shape
        assert torch.equal(got, want), (ns, axis)
    # the carry digit is exercised both ways, and so is truncation
    digits = tmxu.excess_digits(bits, anchors, ns, 0)
    assert (digits[0] == 1).any() and (digits[0] == -1).any()


@pytest.mark.parametrize("ns", [8, 40])
def test_excess_digits_match_jax(ns):
    from exblas_tpu.ops.kernels.gemm_mxu import make_digits

    bits, anchors = recode_case(ns, 7100 + ns)
    X = split_f64(bits.numpy().view(np.float64))
    want = np.asarray(make_digits(X.hi, X.lo, anchors.numpy().astype(np.int32),
                                  ns, 0))
    got = tmxu.excess_digits(bits, anchors, ns, 0)
    assert np.array_equal(got.numpy(), want), ns


def test_exact_chunk():
    assert tmxu.exact_chunk(8, 8) == tmxu.K_CHUNK == 8192
    for sa, sb in ((8, 8), (8, 12), (16, 16), (40, 40), (48, 48)):
        kc = tmxu.exact_chunk(sa, sb)
        assert kc & (kc - 1) == 0
        pairs = min(sa, sb) + 1
        assert kc * pairs * 2 ** 14 < 2 ** 31 <= 2 * kc * pairs * 2 ** 14


def _mat(m, n, lo, hi, seed):
    rs = np.random.RandomState(seed)
    return ((1.0 + rs.rand(m, n)) * np.exp2(rs.randint(lo, hi, size=(m, n)))
            * np.where(rs.rand(m, n) < 0.5, -1.0, 1.0))


def _bits(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float64)).view(
        torch.int64)


def _u64(x):
    return np.asarray(x).astype(np.int64).view(np.uint64)


def test_gemm_bits_mxu_torch_chunk_free(monkeypatch):
    # the shape and beta the exgemm tests compile in JAX
    m, k, n = 5, 7, 9
    a, b, c = _mat(m, k, -5, 5, 31), _mat(k, n, -5, 5, 32), _mat(m, n, -3, 3,
                                                                 33)
    want = _u64(np.asarray(JGEMM.exgemm_bits("N", "N", 1.0, a, b, beta=1.0,
                                             c=c, impl="xla")).view(np.int64))
    one = int(np.float64(1.0).view(np.int64))
    got = {}
    for chunk in (tmxu.K_CHUNK, 3, 1):
        monkeypatch.setattr(tmxu, "K_CHUNK", chunk)
        got[chunk] = _u64(tmxu.gemm_bits_mxu_torch(
            _bits(a), _bits(b), _bits(c), one, "one", 8, 8).numpy())
    for chunk, bits in got.items():
        assert np.array_equal(bits, want), chunk


def test_gemv_bits_mxu_torch_chunk_free(monkeypatch):
    # the (7, 13) shape and beta = 0 the exgemv tests compile in JAX
    m, k = 7, 13
    rs = np.random.RandomState(34)
    a = rs.uniform(0.5, 1.0, (m, k)) * np.where(rs.rand(m, k) < 0.5, -1, 1)
    x = rs.uniform(-1.0, 1.0, k)
    alpha = 2.5
    want = _u64(np.asarray(JGEMV.exgemv_bits("N", alpha, a, x, beta=0.0,
                                             impl="xla")).view(np.int64))
    z = _bits(alpha * x)
    plan = EGEMV.plan_gemv(_bits(a), z, None, 0, "zero", False)
    assert plan.rung == (2, 2)
    got = {}
    for chunk in (vmxu.K_CHUNK, vmxu.KS, 5):
        monkeypatch.setattr(vmxu, "K_CHUNK", chunk)
        got[chunk] = _u64(vmxu.gemv_bits_mxu_torch(
            _bits(a), z, plan.ea0, plan.f0, None, 0, "zero", 2, 2).numpy())
    for chunk, bits in got.items():
        assert np.array_equal(bits, want), chunk
