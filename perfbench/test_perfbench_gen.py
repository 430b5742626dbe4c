"""The traffic generator: the same seed gives the same draws, in the
ranges upstream's generators draw."""

import pytest
import torch

from perfbench import gen, harness

MIXES = ["range2", "range50", "range300"]


@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("matrix", [False, True])
def test_same_seed_same_draws(mix, matrix):
    traffic = harness.load("traffic", mix)
    seed = 2**33 + 12345

    def draw(s):
        g = gen.generator(s, "cpu")
        return [gen.draw((64, 48), traffic, g, "cpu", matrix=matrix)
                for _ in range(2)]

    a, b, c = draw(seed), draw(seed), draw(seed + 1)
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int64), y.view(torch.int64))
    assert not torch.equal(a[0], c[0])
    assert not torch.equal(a[0], a[1])


@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("matrix", [False, True])
def test_exponents_and_mantissas_in_range(mix, matrix):
    traffic = harness.load("traffic", mix)
    x = gen.draw((1 << 16,), traffic, gen.generator(7, "cpu"), "cpu",
                 matrix=matrix)
    e = ((x.view(torch.int64) >> 52) & 0x7FF) - 1023
    lo, hi = ((0, traffic["range"]) if matrix else
              (traffic["emax"] - traffic["range"], traffic["emax"]))
    assert int(e.min()) == lo and int(e.max()) == hi - 1
    assert bool((x > 0).all())
    m = x / torch.ldexp(torch.ones_like(x), e.to(torch.float64))
    assert bool(((m >= 1) & (m < 2)).all())
    # every exponent of the range is drawn about equally often
    counts = torch.bincount(e - lo).to(torch.float64)
    assert float(counts.min() / counts.max()) > 0.5


def test_any_whole_seed():
    """Seeds past 64 bits wrap; a matrix takes no ``emax``."""
    traffic = {"range": 3, "emax": 7}
    a = gen.draw((256,), traffic, gen.generator(2**64 + 9, "cpu"), "cpu")
    b = gen.draw((256,), traffic, gen.generator(9, "cpu"), "cpu")
    assert torch.equal(a.view(torch.int64), b.view(torch.int64))
    m = gen.draw((16, 16), {"range": 3}, gen.generator(9, "cpu"), "cpu",
                 matrix=True)
    e = ((m.view(torch.int64) >> 52) & 0x7FF) - 1023
    assert int(e.min()) >= 0 and int(e.max()) <= 2
