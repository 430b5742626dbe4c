"""The warp accumulator of the exact row and dot kernels, in PyTorch.

Kernels B4 and B7 (``ops/kernels/csrc/warpacc.cuh``) give each warp one
DOT_FORMAT accumulator in three layers:

* a register window a lane: a signed 256-bit sum whose bit 0 is at limb
  ``base``, placed at the warp's first valid product (``base = q0 - 1``);
  a product whose LSB position p lies in ``[20 base, 20 base + 64)`` is
  added to it whole;
* int32 limbs in shared memory: every other valid product adds its 7
  signed digits there, by 32-bit atomics in any order;
* int64 limbs, into which the int32 layer is spilled on a fixed cadence
  and the window, summed over the warp, is flushed once at the end: its
  12 digits of bits [0, 240) at limbs ``base..``, and -1 at limb
  ``base + 12`` when the sum is negative.

Kernel B2 (``csrc/sum_kernel.cu``, ``warpacc.cuh`` ``SumAcc``) gives each
warp one SUM_FORMAT accumulator (112 limbs, bit 0 at 2^-1074) in the same
layers, its window sized to one significand: a signed 160-bit sum a lane
whose bit 0 is at limb ``base``; a *normal* double whose LSB position p
lies in ``[20 base, 20 base + 64)`` is added to it whole, every other
finite nonzero double (subnormals among them) adds its 4 signed digits to
the int32 layer, and the flush writes 8 digits of bits [0, 160) at limbs
``base..`` and -1 at limb ``base + 8`` when the sum is negative.

This module is the plain model of those accumulators, used by the tests: a
warp's products (or doubles) in the order its lanes add them (calls ``(c,
lane)``) go through the same placement, hit test, spill cadence and flush,
and the model reports the largest magnitude an int32 limb can reach
between two spills, whatever the order of the atomics -- the kernels'
overflow bound is that it stays below 2^31 (``SPILL_DIGITS`` digits below
2^20).  The call orders of the kernels are :func:`row_calls` (B7, a warp a
row), :func:`dot_calls` (B4) and :func:`sum_calls` (B2), the last two a
persistent grid's loop.
"""

from __future__ import annotations

import torch

from . import deposit as dep
from .types import (DOT_OFFSET_BITS, L_DOT, L_SUM, LIMB_BITS, LIMB_MASK,
                    SUM_OFFSET_BITS)

__all__ = ["SPILL_DIGITS", "WIN_SHIFT", "WIN_DIGITS", "SUM_WIN_DIGITS",
           "SUM_PER_STEP", "product_digits", "sum_digits", "warp_accumulate",
           "sum_warp_accumulate", "row_calls", "dot_calls", "sum_calls"]

SPILL_DIGITS = 2048  # warpacc.cuh kSpillDigits: 2048 * (2^20 - 1) < 2^31
WIN_SHIFT = 64       # kWinShift, kSumWinShift: the LSB offsets a hit may have
WIN_DIGITS = 12      # kWinDigits: the digits of a flushed product window
N_DIGITS = 7         # digits of a product shifted by r < 20 (< 2^125)
SUM_WIN_DIGITS = 8   # kSumWinDigits: the digits of a flushed 160-bit window
SUM_DIGITS = 4       # digits of a significand shifted by r < 20 (< 2^73)
SUM_PER_STEP = 8     # sum_kernel.cu kPerStep: the doubles a lane adds a step


def product_digits(a_bits, b_bits):
    """The exact products of int64 binary64 patterns as the kernels split
    them: (valid, p, digits (..., 7) signed, nan, pinf, ninf), where digit
    t is bits [20t, 20t + 20) of the product of the significands shifted
    left by r = p % 20, with the product's sign, p the position of its LSB
    (limb p // 20); zeros and specials are not valid and have no digits."""
    t = dep.product_terms(a_bits, b_bits, DOT_OFFSET_BITS)
    r = t["r"]
    # class k is < 2^30 at bit offset 14k + r: three pieces below 2^20 at
    # limbs (14k + r) // 20 + 0, 1, 2 of the product, then one carry pass
    acc = torch.zeros(r.shape + (N_DIGITS + 2,), dtype=torch.int64,
                      device=r.device)
    for k, c in enumerate(t["classes"]):
        pos = r + 14 * k
        lo, mid, hi = dep.split_value30(c, pos % LIMB_BITS)
        idx = (pos // LIMB_BITS).unsqueeze(-1)
        for off, piece in enumerate((lo, mid, hi)):
            acc.scatter_add_(-1, idx + off, piece.unsqueeze(-1))
    carry = torch.zeros_like(r)
    digits = []
    for j in range(N_DIGITS + 2):
        v = acc[..., j] + carry
        digits.append(v & LIMB_MASK)
        carry = v >> LIMB_BITS
    digits = torch.stack(digits[:N_DIGITS], -1) * t["s"].unsqueeze(-1)
    return (t["valid"], t["q"] * LIMB_BITS + r, digits, t["nan"], t["pinf"],
            t["ninf"])


def sum_digits(bits):
    """The doubles (int64 binary64 patterns) as kernel B2 splits them:
    (valid, normal, p, digits (..., 4) signed, nan, pinf, ninf), where digit
    t is bits [20t, 20t + 20) of the significand shifted left by
    r = p % 20, with the double's sign, p = max(expfield, 1) - 1 the
    position of its LSB in SUM_FORMAT (limb p // 20); zeros and specials
    are not valid and have no digits."""
    t = dep.sum_terms(bits, SUM_OFFSET_BITS)
    expf = (bits >> 52) & 0x7FF
    p = expf.clamp(min=1) - 1
    digits = torch.stack(t["pieces"], -1)
    return (t["valid"], expf != 0, p, digits, t["nan"], t["pinf"],
            t["ninf"])


def _carry_digits(d, n: int):
    """Canonical base-2^20 digits 0..n-1 of sum_j d[j] 2^(20 j) and the
    carry out of digit n - 1 (floor division)."""
    carry = torch.zeros((), dtype=torch.int64)
    out = []
    for j in range(n):
        v = (d[j] if j < d.numel() else 0) + carry
        out.append(v & LIMB_MASK)
        carry = v >> LIMB_BITS
    return torch.stack(out), carry


def warp_accumulate(a_bits, b_bits, per_step: int, lead: int = 0,
                    spill_steps: int | None = None):
    """One warp's accumulator, as ``warpacc.cuh``'s WarpAcc builds it.

    ``a_bits``, ``b_bits``: int64 (C, 32): call c of lane l adds
    ``a[c, l] * b[c, l]`` (0 * 0 where a lane has nothing).  The first
    ``lead`` calls are lone calls followed by a spill; the others form
    steps of ``per_step`` calls, with a spill after every ``spill_steps``
    steps (default: the kernels' cadence, ``SPILL_DIGITS // (32 *
    per_step)``) and at the end.  Returns (limbs int64 (216,) -- the int64
    layer after the flush, as the kernel leaves it --, special counts int64
    (3,), the largest magnitude an int32 limb can reach between two
    spills)."""
    valid, p, digits, nan, pinf, ninf = product_digits(a_bits, b_bits)
    return _layers(valid, valid, p, digits, (nan, pinf, ninf), per_step,
                   lead, spill_steps, L_DOT, WIN_DIGITS)


def sum_warp_accumulate(x_bits, per_step: int = SUM_PER_STEP, lead: int = 0,
                        spill_steps: int | None = None):
    """One warp's SUM_FORMAT accumulator, as ``warpacc.cuh``'s SumAcc
    builds it: ``x_bits`` int64 (C, 32), call c of lane l adds ``x[c, l]``
    (0 where a lane has nothing); ``lead``, ``spill_steps`` and the result
    as :func:`warp_accumulate`'s, with limbs (112,).  Only normal doubles
    are window hits: a subnormal always takes the int32 layer."""
    valid, normal, p, digits, nan, pinf, ninf = sum_digits(x_bits)
    return _layers(valid, valid & normal, p, digits, (nan, pinf, ninf),
                   per_step, lead, spill_steps, L_SUM, SUM_WIN_DIGITS)


def _layers(valid, can_hit, p, digits, specials, per_step: int, lead: int,
            spill_steps, n_limbs: int, win_digits: int):
    """The three layers of a warp accumulator over its calls' terms (see
    :func:`warp_accumulate`): ``valid`` terms place the window, those that
    ``can_hit`` with an LSB in the window's first WIN_SHIFT bits are hits,
    the other valid terms misses."""
    if spill_steps is None:
        spill_steps = SPILL_DIGITS // (32 * per_step)
    nd = digits.shape[-1]
    q = p // LIMB_BITS
    limbs = torch.zeros(n_limbs + nd + win_digits, dtype=torch.int64)
    special = torch.stack([s.sum() for s in specials])
    first = valid.reshape(-1).nonzero()
    if first.numel() == 0:
        return limbs[:n_limbs], special, 0
    base = max(int(q.reshape(-1)[first[0, 0]]) - 1, 0)
    sh = p - LIMB_BITS * base
    hit = can_hit & (sh >= 0) & (sh < WIN_SHIFT)
    miss = valid & ~hit
    # the int32 layer: per interval between spills and limb, the sums of
    # the positive and of the negative digits bound every partial sum
    c = torch.arange(valid.shape[0]).unsqueeze(1).expand_as(q)
    interval = torch.where(c < lead, c, lead + (c - lead) // (
        per_step * spill_steps))
    n_int = int(interval.max()) + 1
    cols = (interval * limbs.numel()).unsqueeze(-1) + q.unsqueeze(-1) + \
        torch.arange(nd)
    d = torch.where(miss.unsqueeze(-1), digits, torch.zeros_like(digits))
    pos = torch.zeros(n_int * limbs.numel(), dtype=torch.int64)
    neg = torch.zeros_like(pos)
    pos.index_add_(0, cols.reshape(-1), d.clamp(min=0).reshape(-1))
    neg.index_add_(0, cols.reshape(-1), (-d).clamp(min=0).reshape(-1))
    worst = int(torch.maximum(pos, neg).max())
    limbs += (pos - neg).view(n_int, -1).sum(0)
    # the window: its hits' digits at limbs q - base.., summed over the
    # warp, then its canonical digits and the sign digit (-1 if negative)
    rel = torch.zeros(win_digits + 1, dtype=torch.int64)
    dh = torch.where(hit.unsqueeze(-1), digits, torch.zeros_like(digits))
    at = torch.where(hit, q - base, torch.zeros_like(q)).unsqueeze(-1)
    rel.index_add_(0, (at + torch.arange(nd)).reshape(-1), dh.reshape(-1))
    flushed, sign = _carry_digits(rel, win_digits)
    if int(sign) not in (0, -1):
        raise AssertionError(f"window sum beyond its bits: carry {int(sign)}")
    limbs[base:base + win_digits] += flushed
    limbs[base + win_digits] += sign
    if bool((limbs[n_limbs:] != 0).any()):
        raise AssertionError("a digit fell past the format's top limb")
    return limbs[:n_limbs], special, worst


def row_calls(a_row, z, head: int, per_step: int = 8):
    """B7's calls for one row (``csrc/gemv_kernel.cu``): (a (C, 32), z
    (C, 32), lead).  A row that starts 8 bytes off 16 (``head`` 1) adds its
    first element alone (lane 0); then element ``head + 256 s + 2 (lane +
    32 u) + j`` is call ``per_step s + 2 u + j`` of lane, steps of
    ``per_step / 2`` 16-byte loads a lane."""
    k = a_row.numel()
    width = 32 * per_step
    steps = -(-(k - head) // width)
    i = torch.arange(steps * width)
    s, w = i // width, i % width
    lane, u, j = (w // 2) % 32, (w // 2) // 32, w % 2
    call = head + s * per_step + 2 * u + j
    e = head + i
    av = torch.zeros((head + steps * per_step, 32), dtype=torch.int64)
    zv = torch.zeros_like(av)
    ok = e < k
    av[call[ok], lane[ok]] = a_row[e[ok]]
    zv[call[ok], lane[ok]] = z[e[ok]]
    if head:
        av[0, 0], zv[0, 0] = a_row[0], z[0]
    return av, zv, head


def dot_calls(a, b, grid: int, w: int, head: int, threads: int = 256,
              per_step: int = 4):
    """B4's calls (``csrc/dot_kernel.cu``) for a grid of ``grid`` blocks
    of ``threads``: a list, warp by warp, of (a (C, 32), b (C, 32), lead).
    ``w`` elements a load (2: 16-byte loads, after ``head`` elements taken
    alone); unit i of the loop is element ``head + w i + j``, taken by
    thread ``i % T`` (T = grid * threads) at step ``i // (units T)`` as
    call ``per_step step + w u + j``, u = (i // T) % units.  Block 0's warp
    0 first adds the head element (lane 0) and the element left past the
    units (lane 1) as one lead call."""
    n = a.numel()
    units = per_step // w
    T = grid * threads
    nu = (n - head) // w
    tail = head + nu * w
    steps = -(-nu // (units * T))
    i = torch.arange(nu)
    tid, u, s = i % T, (i // T) % units, i // (units * T)
    out = []
    for warp in range(T // 32):
        lead = 1 if warp == 0 else 0
        av = torch.zeros((lead + steps * per_step, 32), dtype=torch.int64)
        bv = torch.zeros_like(av)
        sel = (tid // 32) == warp
        for j in range(w):
            call = lead + s[sel] * per_step + w * u[sel] + j
            e = head + w * i[sel] + j
            av[call, tid[sel] % 32] = a[e]
            bv[call, tid[sel] % 32] = b[e]
        if lead:
            if head:
                av[0, 0], bv[0, 0] = a[0], b[0]
            if tail < n:
                av[0, 1], bv[0, 1] = a[tail], b[tail]
        out.append((av, bv, lead))
    return out


def sum_calls(x, grid: int, head: int, threads: int = 256,
              per_step: int = SUM_PER_STEP):
    """B2's calls (``csrc/sum_kernel.cu``) for a grid of ``grid`` blocks of
    ``threads``: a list, warp by warp, of (x (C, 32), lead).  Pairs of
    elements in 16-byte loads after ``head`` (0 or 1) elements taken alone,
    in the order of :func:`dot_calls` with ``w`` 2: block 0's warp 0 first
    adds the head element (lane 0) and the element left past the pairs
    (lane 1) as one lead call."""
    return [(av, lead) for av, _, lead in dot_calls(
        x, x, grid, 2, head, threads=threads, per_step=per_step)]
