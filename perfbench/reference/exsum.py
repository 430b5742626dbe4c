"""Plain reference of ExSUM: the correctly rounded float64 of the exact
sum, and the control, the same sum in float32.

Plain PyTorch, independent of the program: each element is cut into
radix-2**s digits below one common power of two (exact scalings and
truncations), each digit column is summed in float64, which is exact
because every partial sum is an integer below 2**53, and the column sums
are carried and rounded as one big integer (:mod:`.bigint`).  Blocks of
``BLOCK`` elements bound the temporaries.
"""

from __future__ import annotations

import math

import torch

from . import bigint

BLOCK = 1 << 24
RADIX_BITS = 20


def exact_bits(inputs: dict) -> torch.Tensor:
    """0-dim int64: the bits of the correctly rounded sum of ``x``."""
    x = inputs["x"].reshape(-1)
    bigint.check_domain(x)
    n = x.numel()
    # A block's column sums stay below 2**53 (BLOCK * 2**20 = 2**44), and
    # the int64 column totals below 2**62.
    s = min(RADIX_BITS, 61 - math.ceil(math.log2(max(n, 2))))
    blocks = [x[i:i + BLOCK] for i in range(0, n, BLOCK)]
    tops = [bigint.top_exponent(b).max() for b in blocks]
    top = int(torch.stack(tops).max()) if blocks else bigint.NONE
    if top == bigint.NONE:
        return torch.zeros((), dtype=torch.int64, device=x.device)
    scale = torch.tensor(top + 1, device=x.device)
    count = max(bigint.digit_count(b, scale, s) for b in blocks)
    cols = torch.zeros(count, dtype=torch.int64, device=x.device)
    for b in blocks:
        for t, d in enumerate(bigint.digits(b, scale, s, count)):
            cols[t] += d.sum().to(torch.int64)
    # Digit t weighs 2**(scale - s*(t+1)): limb count-1-t over the base
    # 2**(scale - s*count); spare limbs take the carries.
    limbs = torch.zeros(count + 4, dtype=torch.int64, device=x.device)
    limbs[:count] = cols.flip(0)
    base = scale - s * count
    return bigint.round_to_f64_bits(bigint.normalize(limbs, s), base, s)


def control_bits(inputs: dict) -> torch.Tensor:
    """The control: the sum computed in float32, widened to float64.  The
    elements are first scaled by a power of two that brings the largest
    into [1, 2) (undone in float64), so that float32's range holds the
    sum of any mix."""
    x = inputs["x"].reshape(-1)
    top = int(bigint.top_exponent(x).max())
    top = 0 if top == bigint.NONE else top
    s = (x * bigint.pow2(-top)).to(torch.float32).sum(dtype=torch.float32)
    return (s.to(torch.float64) * bigint.pow2(top)).view(torch.int64)


def native_bits(inputs: dict) -> torch.Tensor:
    """Native float64 ``torch.sum``: not reproducible, and on these data
    not correctly rounded."""
    return inputs["x"].sum().view(torch.int64)
