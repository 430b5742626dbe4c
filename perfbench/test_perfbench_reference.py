"""The plain references against Python's exact arithmetic: math.fsum for
sums, fractions.Fraction for GEMMs and for the limb rounding."""

import math
import random
from fractions import Fraction

import pytest
import torch

from perfbench.reference import bigint, exgemm, exsum


def bits(v: float) -> int:
    return torch.tensor(v, dtype=torch.float64).view(torch.int64).item()


def round_limbs(limbs, base, s=20):
    t = torch.tensor(limbs, dtype=torch.int64)
    return bigint.round_to_f64_bits(bigint.normalize(t, s),
                                    torch.tensor(base), s).item()


@pytest.mark.parametrize("seed", range(6))
def test_limb_rounding_matches_fraction(seed):
    rng = random.Random(seed)
    for _ in range(300):
        count = rng.randint(1, 8)
        if rng.random() < 0.5:
            limbs = [rng.choice([0, 1, (1 << 20) - 1, 1 << 19,
                                 rng.randrange(1 << 20)])
                     for _ in range(count)] + [0]
        else:
            limbs = [rng.randrange(-(1 << 40), 1 << 40)
                     for _ in range(count)] + [0, 0, 0]
        base = rng.randint(-300, 200)
        value = sum(v << (20 * i) for i, v in enumerate(limbs))
        want = bits(float(Fraction(value) * Fraction(2) ** base)) \
            if value else 0
        assert round_limbs(limbs, base) == want


@pytest.mark.parametrize("seed", range(4))
def test_limb_rounding_ties(seed):
    """Exact halfway cases round to even; a sticky bit far below breaks
    the tie."""
    rng = random.Random(100 + seed)
    for _ in range(300):
        mant = rng.randrange(1 << 52, 1 << 53)
        shift = rng.randint(1, 60)
        value = (mant << shift) | (1 << (shift - 1))
        if rng.random() < 0.5 and shift > 1:
            value |= 1
        sign = rng.choice([1, -1])
        limbs = []
        rest = value
        while rest:
            limbs.append(sign * (rest & ((1 << 20) - 1)))
            rest >>= 20
        base = rng.randint(-100, 100)
        want = bits(float(Fraction(sign * value) * Fraction(2) ** base))
        assert round_limbs(limbs + [0, 0], base) == want


def test_limb_rounding_refuses_what_it_cannot_hold():
    with pytest.raises(ArithmeticError):
        round_limbs([0, 1 << 30], 0)          # no spare top limb
    with pytest.raises(ArithmeticError):
        round_limbs([1, 0], 2000)             # overflow
    assert round_limbs([0, 0, 0], 5) == 0


@pytest.mark.parametrize("seed", range(8))
def test_sum_matches_fsum(seed):
    rng = random.Random(seed)
    for _ in range(12):
        n = rng.randint(1, 2000)
        lo = rng.randint(-400, 100)
        hi = lo + rng.randint(0, 400)
        xs = [rng.choice([-1.0, 1.0]) * math.ldexp(rng.uniform(1, 2),
                                                  rng.randint(lo, hi))
              for _ in range(n)]
        if seed % 2:
            xs += [0.0, -xs[0]]
        got = exsum.exact_bits({"x": torch.tensor(xs, dtype=torch.float64)})
        assert got.item() == bits(math.fsum(xs))


def test_sum_in_blocks(monkeypatch):
    """Several blocks, and digits that differ between them."""
    monkeypatch.setattr(exsum, "BLOCK", 64)
    rng = random.Random(9)
    xs = [math.ldexp(rng.uniform(1, 2), rng.randint(-60, 60))
          for _ in range(1000)]
    got = exsum.exact_bits({"x": torch.tensor(xs, dtype=torch.float64)})
    assert got.item() == bits(math.fsum(xs))


def test_sum_domain():
    with pytest.raises(ValueError):
        exsum.exact_bits({"x": torch.tensor([1.0, math.inf], dtype=torch.float64)})
    with pytest.raises(ValueError):
        exsum.exact_bits({"x": torch.tensor([1.0, 5e-324],
                                            dtype=torch.float64)})
    assert exsum.exact_bits({"x": torch.zeros(4, dtype=torch.float64)}) == 0


def _matrix(rng, r, c, lo, hi, zeros=0.1):
    return torch.tensor(
        [[0.0 if rng.random() < zeros else
          rng.choice([-1.0, 1.0, 1.0]) * math.ldexp(rng.uniform(1, 2),
                                                    rng.randint(lo, hi))
          for _ in range(c)] for _ in range(r)], dtype=torch.float64)


def _fraction_gemm(a, b, c):
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.int64)
    for i in range(m):
        for j in range(n):
            v = sum((Fraction(a[i, q].item()) * Fraction(b[q, j].item())
                     for q in range(k)), Fraction(0))
            if c is not None:
                v += Fraction(c[i, j].item())
            out[i, j] = bits(float(v)) if v else 0
    return out


@pytest.mark.parametrize("seed", range(10))
def test_gemm_matches_fraction(seed, monkeypatch):
    monkeypatch.setattr(exgemm, "ROWS", 3)
    rng = random.Random(seed)
    m, k, n = rng.randint(1, 7), rng.randint(1, 30), rng.randint(1, 7)
    lo = rng.randint(-80, 20)
    hi = lo + rng.choice([1, 2, 50, 120])
    a, b = _matrix(rng, m, k, lo, hi), _matrix(rng, k, n, lo, hi)
    c = (None if seed == 3 else
         _matrix(rng, m, n, lo - rng.randint(0, 200), hi + rng.randint(0, 90)))
    got = exgemm.exact_bits({"a": a, "b": b, "c": c})
    assert torch.equal(got, _fraction_gemm(a, b, c))


def test_gemm_domain():
    a = torch.ones((2, 2), dtype=torch.float64)
    with pytest.raises(NotImplementedError):
        exgemm.exact_bits({"a": a, "b": a, "c": a, "beta": 2.0})
    with pytest.raises(ValueError):
        exgemm.exact_bits({"a": a * math.nan, "b": a, "c": a})


def test_inexact_product_is_caught():
    d = torch.full((4, 4), float((1 << 20) - 1), dtype=torch.float64)
    with pytest.raises(ArithmeticError):
        exgemm._check_product(d @ d + 1, d, d)


@pytest.mark.parametrize("routine", ["sum", "gemm"])
def test_controls_differ_from_the_exact_result(routine):
    """On upstream-like data the float32 control misses the correctly
    rounded result by many ulps (and the GEMM's native float64 by at
    least one)."""
    from perfbench import harness

    rng = random.Random(11)
    if routine == "sum":
        x = torch.tensor([math.ldexp(rng.uniform(1, 2), rng.randint(-2, -1))
                          for _ in range(1 << 14)], dtype=torch.float64)
        inp, ref = {"x": x}, exsum
    else:
        inp = {"a": _matrix(rng, 16, 256, 0, 1, 0),
               "b": _matrix(rng, 256, 16, 0, 1, 0),
               "c": _matrix(rng, 16, 16, 0, 1, 0)}
        ref = exgemm
    want = ref.exact_bits(inp)
    assert harness.ulp_gap(ref.control_bits(inp), want) > 1000
    if routine == "gemm":
        assert harness.ulp_gap(ref.native_bits(inp), want) >= 1
