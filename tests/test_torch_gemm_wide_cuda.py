"""The wgmma class kernel of rungs (8, 12) to (16, 16) (``csrc/gemm_mxu.cu``
``wgw::wide_kernel``) against the plain ``gemm_bits_mxu_torch`` on a CUDA
card, with K_CHUNK shrunk so that k spans several launches and their
words.  Needs a card and ``nvcc``; skips without them.  This file imports
no JAX, so that it runs where the port runs:

    python -m pytest tests/test_torch_gemm_wide_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from exblas_tpu_torch.ops.kernels import _build
from exblas_tpu_torch.ops.kernels import gemm_mxu as gm

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    try:
        _build.find_nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda")


def bits(m, n, lo, hi, seed, dev):
    """Bits of signed doubles with exponents in [lo, hi)."""
    rs = np.random.RandomState(seed)
    x = (1.0 + rs.rand(m, n)) * np.exp2(rs.randint(lo, hi, size=(m, n)))
    x *= np.where(rs.rand(m, n) < 0.5, -1.0, 1.0)
    return torch.from_numpy(x).to(dev).view(torch.int64)


@pytest.mark.parametrize("rung", gm.WG_RUNGS)
@pytest.mark.parametrize("mode,beta", [("zero", 0.0), ("one", 1.0),
                                       ("general", -0.75)])
def test_wide_rung_matches_plain_over_chunks(rung, mode, beta, card,
                                             monkeypatch):
    sa, sb = rung
    m, k, n = 70, 300, 50
    # spreads of 8 sa and 8 sb bits: covered at this rung, not below it
    z = bits(m, k, 0, 8 * sa - 53, 1, card)
    b = bits(k, n, 53 - 8 * sb, 0, 2, card)
    c = bits(m, n, 0, 10, 3, card)
    beta_bits = int(np.float64(beta).view(np.int64))
    w = gm.gemm_bits_mxu_cuda
    monkeypatch.setattr(gm, "K_CHUNK", 64)
    before = (w.wg_launches, w.class_buffers, w.round_launches)
    got = w(z, b, c, beta_bits, mode, sa, sb)
    torch.cuda.synchronize()
    moved = (w.wg_launches - before[0], w.class_buffers - before[1],
             w.round_launches - before[2])
    assert moved == (len(gm.wg_chunks(sa, sb, 320)), 0, 0)
    want = gm.gemm_bits_mxu_torch(z, b, c, beta_bits, mode, sa, sb)
    assert torch.equal(got, want)
