"""The warp accumulators of the exact row, dot and sum kernels B7, B4 and
B2 (``csrc/warpacc.cuh``), in their plain model ``core/warpacc.py``, held
bit for bit against the JAX package's Pallas kernels in interpret mode
(``gemv_rows_acc_pallas``, ``exdot_pallas``, ``exsum_pallas``) and the
port's plain versions on adversarial data: digits at 2^20 - 1 that all
miss the window, in the largest number the spill cadence lets an int32
limb take (its worst case), alternating signs, subnormals, the format's
top limbs and specials.  Also the row kernel's geometry
(``ops/kernels/gemv_kernel.py`` ``row_geometry``): every row and every k
covered once, k split only for small m.  Tolerance is zero.  The kernels
themselves are held against their plain versions on the card by
``chip_smoke.py``."""

import numpy as np
import pytest
import torch

from exblas_tpu.core.ieee import split_f64
from exblas_tpu_torch.core import warpacc as wa
from exblas_tpu_torch.core.types import DOT_FORMAT, SUM_FORMAT, Superacc
from exblas_tpu_torch.ops.kernels import dot_kernel as tdot
from exblas_tpu_torch.ops.kernels import gemv_kernel as tkern
from exblas_tpu_torch.ops.kernels import sum_kernel as tsum
from torch_parity import (assert_same_state, jax_state, pallas_interpret,
                          port_state)

SMS = 132  # H100 SXM
INT32_MAX = (1 << 31) - 1
# the spill cadence's worst case: 2048 digits of 2^20 - 1 in one limb
WORST = wa.SPILL_DIGITS * ((1 << 20) - 1)
QNAN_PAYLOAD = np.array([0xFFF0000000000123], np.uint64).view(np.float64)[0]


def _bits(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float64)).view(
        torch.int64)


# --- the row kernel's geometry -----------------------------------------------

GEOMETRY_K = (1, 2, 1023, 1024, 1025, 3000, 8192, 65537, (1 << 20) + 7,
              1 << 22)


@pytest.mark.parametrize("m", [1, 2, 3, 7, 8, 9, 64, 131, 1055, 1056, 1057,
                               4099, 8192])
def test_row_geometry_covers_each_row_and_k_once(m):
    for k in GEOMETRY_K:
        g = tkern.row_geometry(m, k, SMS)
        assert 1 <= g.warps <= tkern.MAX_WARPS and g.warps == min(8, m)
        assert g.span % tkern.K_CHUNK == 0 and g.blocks < 2**31
        assert g.zeroed == (g.splits > 1)
        # k is split only where m rows leave an SM fewer than 8, and then,
        # where k allows, into spans of whole chunks that bring the warps
        # to at least half of 8 an SM
        fill = SMS * tkern.FILL_ROWS
        assert g.splits == 1 or m < fill
        if m < fill and k >= tkern.K_CHUNK * fill:
            assert 2 * g.splits * m >= fill
        # the kernel's mapping: block b -> group b // splits, span
        # b % splits; warp w -> row group * warps + w (none past m)
        b = np.arange(g.blocks)
        group, span = b // g.splits, b % g.splits
        rows = (group[:, None] * g.warps + np.arange(g.warps)).ravel()
        spans = np.repeat(span, g.warps)
        live = rows < m
        cover = np.zeros((m, g.splits), np.int64)
        np.add.at(cover, (rows[live], spans[live]), 1)
        assert (cover == 1).all(), f"m={m} k={k}: rows covered unevenly"
        lo = np.arange(g.splits) * g.span
        hi = np.minimum(lo + g.span, k)
        assert lo[0] == 0 and hi[-1] == k and (hi > lo).all()
        assert (lo[1:] == hi[:-1]).all(), f"m={m} k={k}: spans overlap"


def test_row_geometry_rejects_empty_shapes():
    for m, k in ((0, 5), (5, 0), (-1, 1)):
        with pytest.raises(ValueError):
            tkern.row_geometry(m, k, SMS)


# --- the model against the JAX kernels ---------------------------------------

# (2^53 - 1)^2 shifted by r = 4: bits 58..109 set, so digits 3 and 4
# (bits 60..99) are 2^20 - 1
FULL = (2.0 - 2.0 ** -52)
K_ROW = 1 + wa.SPILL_DIGITS  # the window's product, then one interval
N_DOT = 1 + 2 * 16 * 256 * 2  # one lead element, then 16 steps a warp


def _row_data(kind):
    """(A (4, k), z) of one kind, and the rows' heads (0 or 1: rows that
    start 8 bytes off 16 take their first element alone)."""
    rs = np.random.RandomState(71)
    if kind == "max_digits":
        # element 0 places the window near 2^600; every other product is
        # FULL^2 ~ 2^2, far below it, with equal signs: each of 2048 misses
        # adds 2^20 - 1 to the same two int32 limbs of every warp
        a = np.full((4, K_ROW), FULL)
        z = np.full(K_ROW, FULL)
        a[:, 0], z[0] = 1.0, 2.0 ** 600
        a[1] *= -1.0
        return a, z, (1, 1, 1, 1)
    if kind == "alternating":
        # 240 bits of exponents: most products miss the 64-bit window
        a = rs.uniform(0.5, 1.0, (4, K_ROW)) * np.exp2(
            rs.randint(-60, 60, (4, K_ROW)))
        a *= np.where(np.arange(K_ROW) % 2 == 0, 1.0, -1.0)
        z = rs.uniform(0.5, 1.0, K_ROW) * np.exp2(rs.randint(-60, 60, K_ROW))
        a[2, 1::2] = -a[2, 0::2][:K_ROW // 2]  # row 2 cancels but for one
        z[1::2] = z[0::2][:K_ROW // 2]
        return a, z, (0, 1, 0, 1)
    k = 300  # 1600 binades; the JAX kernel's time grows with the range
    a = rs.uniform(-1, 1, (4, k)) * np.exp2(rs.randint(-600, 600, (4, k)))
    z = rs.uniform(-1, 1, k) * np.exp2(rs.randint(-400, 400, k))
    z[9] = 0.0
    a[0, 3], a[1, 4], a[1, 5] = np.inf, QNAN_PAYLOAD, -np.inf
    a[2, 9] = np.inf                        # Inf * 0: NaN
    a[3, :100] = 5e-324                     # subnormal products
    return a, z, (1, 0, 0, 1)


ROW_KINDS = ("max_digits", "alternating", "wide_specials")


@pytest.fixture(scope="module")
def jax_rows():
    """The JAX rows of every kind, one compiled shape."""
    from jax.experimental.pallas import tpu as pltpu
    from exblas_tpu.ops.kernels.gemv_kernel import gemv_rows_acc_pallas

    out = {}
    for kind in ROW_KINDS:
        a, z, _ = _row_data(kind)
        A, Z = split_f64(a), split_f64(z)
        with pltpu.force_tpu_interpret_mode():
            limbs, special = gemv_rows_acc_pallas(A.hi, A.lo, Z.hi, Z.lo,
                                                  k_rows=128)
        out[kind] = (np.asarray(limbs), np.asarray(special))
    return out


def _state(limbs, special):
    return port_state(Superacc(limbs=limbs, special=special, fmt=DOT_FORMAT))


@pytest.mark.parametrize("kind", ROW_KINDS)
def test_row_model_matches_pallas(kind, jax_rows):
    a, z, heads = _row_data(kind)
    plain = tkern.gemv_rows_acc_torch(_bits(a), _bits(z))
    worst = 0
    for i, head in enumerate(heads):
        av, zv, lead = wa.row_calls(_bits(a[i]), _bits(z), head)
        limbs, special, w = wa.warp_accumulate(av, zv, per_step=8, lead=lead)
        worst = max(worst, w)
        got = _state(limbs, special)
        want = jax_state(Superacc(limbs=jax_rows[kind][0][i],
                                  special=jax_rows[kind][1][i],
                                  fmt=DOT_FORMAT))
        assert_same_state(got, want, f"{kind} row {i} vs jax")
        assert_same_state(got, _state(plain[0][i], plain[1][i]),
                          f"{kind} row {i} vs plain")
    assert worst <= INT32_MAX
    if kind == "max_digits":
        assert worst == WORST


DOT_KINDS = ("max_digits", "alternating", "wide_specials")


def _dot_data(kind):
    rs = np.random.RandomState(72)
    if kind == "max_digits":
        a, b = np.full(N_DOT, FULL), np.full(N_DOT, -FULL)
        a[0], b[0] = 1.0, 2.0 ** 600
        return a, b
    if kind == "alternating":  # 240 bits of exponents, signs alternating
        a = rs.uniform(0.5, 1.0, N_DOT) * np.exp2(rs.randint(-60, 60, N_DOT))
        b = rs.uniform(0.5, 1.0, N_DOT) * np.exp2(rs.randint(-60, 60, N_DOT))
        return a * np.where(np.arange(N_DOT) % 2 == 0, 1.0, -1.0), b
    n = 2001  # 1200 binades; the JAX kernel's time grows with the range
    a = rs.uniform(0.5, 1.0, n) * np.exp2(rs.randint(-300, 300, n))
    b = rs.uniform(0.5, 1.0, n) * np.exp2(rs.randint(-300, 300, n))
    b[5], a[77], a[n - 1], b[9] = np.inf, -np.inf, QNAN_PAYLOAD, 0.0
    a[9] = np.inf                           # Inf * 0: NaN
    return a, b


@pytest.fixture(scope="module")
def jax_dots():
    return {kind: jax_state(pallas_interpret("exdot_pallas", *_dot_data(kind)))
            for kind in DOT_KINDS}


@pytest.mark.parametrize("kind", DOT_KINDS)
@pytest.mark.parametrize("w,head", [(2, 1), (1, 0)],
                         ids=["16-byte loads", "8-byte loads"])
def test_dot_model_matches_pallas(kind, w, head, jax_dots):
    a, b = _dot_data(kind)
    ab, bb = _bits(a), _bits(b)
    limbs = torch.zeros(216, dtype=torch.int64)
    special = torch.zeros(3, dtype=torch.int64)
    worst = 0
    for av, bv, lead in wa.dot_calls(ab, bb, grid=1, w=w, head=head):
        l, s, wst = wa.warp_accumulate(av, bv, per_step=4, lead=lead)
        limbs += l
        special += s
        worst = max(worst, wst)
    got = _state(limbs, special)
    assert_same_state(got, jax_dots[kind], f"{kind} vs jax")
    plain = tdot.exdot_acc_torch(torch.from_numpy(a), torch.from_numpy(b))
    assert_same_state(got, port_state(plain), f"{kind} vs plain")
    assert worst <= INT32_MAX
    if kind == "max_digits" and w == 2:
        assert worst == WORST


def test_spill_cadence_is_what_bounds_the_int32_limbs():
    """Twice the cadence would let a limb pass 2^31 on the worst case."""
    a, z, _ = _row_data("max_digits")
    row = np.concatenate([a[0], a[0, 1:]])
    zz = np.concatenate([z, z[1:]])
    av, zv, lead = wa.row_calls(_bits(row), _bits(zz), 1)
    *_, worst = wa.warp_accumulate(av, zv, per_step=8, lead=lead)
    assert worst == WORST
    *_, worst = wa.warp_accumulate(av, zv, per_step=8, lead=lead,
                                   spill_steps=16)
    assert worst == 2 * WORST > INT32_MAX


# --- B2's accumulator: one significand a term, SUM_FORMAT --------------------

# one lead element, then 8 steps of 8 doubles a lane: one spill interval
N_SUM = 1 + wa.SUM_PER_STEP * 8 * 256
SUM_KINDS = ("max_digits", "alternating", "wide_specials")


def _sum_data(kind, head):
    """x of one kind for a start ``head`` elements past 16 bytes (1: x[0]
    is the lead call's; 0: no lead call, so n is even)."""
    rs = np.random.RandomState(73)
    if kind == "max_digits":
        # x[0] places warp 0's window near 2^600; every other double is
        # FULL ~ 2^1, far below it: each of 2048 misses adds 2^20 - 1 to
        # the same int32 limb of warp 0
        x = np.full(N_SUM - 1 + head, FULL)
        x[0] = 2.0 ** 600
        return x
    if kind == "alternating":
        # 120 binades: most doubles miss the 64-bit window
        x = rs.uniform(0.5, 1.0, N_SUM) * np.exp2(rs.randint(-60, 60, N_SUM))
        return x * np.where(np.arange(N_SUM) % 2 == 0, 1.0, -1.0)
    n = 2001  # 1200 binades; the JAX kernel's time grows with the range
    x = rs.uniform(-1, 1, n) * np.exp2(rs.randint(-600, 600, n))
    x[:200] = rs.randint(1, 1 << 20, 200) * 5e-324       # subnormals
    x[200:300] = np.ldexp(rs.uniform(0.5, 1.0, 100), 1024)  # top limbs
    x[300:400] *= -1.0
    x[::97] = 0.0
    x[5], x[77], x[n - 1], x[1200] = np.inf, -np.inf, QNAN_PAYLOAD, -0.0
    return x


@pytest.fixture(scope="module")
def jax_sums():
    return {(kind, head): jax_state(pallas_interpret("exsum_pallas",
                                                     _sum_data(kind, head)))
            for kind in SUM_KINDS for head in (0, 1)
            if head == 1 or kind == "max_digits"}


def _sum_model(x, head, spill_steps=None):
    limbs = torch.zeros(112, dtype=torch.int64)
    special = torch.zeros(3, dtype=torch.int64)
    worst = 0
    for xv, lead in wa.sum_calls(_bits(x), grid=1, head=head):
        l, s, w = wa.sum_warp_accumulate(xv, lead=lead,
                                         spill_steps=spill_steps)
        limbs += l
        special += s
        worst = max(worst, w)
    return port_state(Superacc(limbs=limbs, special=special,
                               fmt=SUM_FORMAT)), worst


@pytest.mark.parametrize("kind", SUM_KINDS)
@pytest.mark.parametrize("head", [1, 0],
                         ids=["8 bytes off 16", "16-byte aligned"])
def test_sum_model_matches_pallas(kind, head, jax_sums):
    x = _sum_data(kind, head)
    got, worst = _sum_model(x, head)
    want = jax_sums[(kind, head if kind == "max_digits" else 1)]
    assert_same_state(got, want, f"{kind} vs jax")
    plain = tsum.exsum_acc_torch(torch.from_numpy(x))
    assert_same_state(got, port_state(plain), f"{kind} vs plain")
    assert worst <= INT32_MAX
    if kind == "max_digits":
        # aligned, x[0] takes a lane of warp 0's first step: 2047 misses
        assert worst == WORST - (1 - head) * ((1 << 20) - 1)


def test_sum_spill_cadence_is_what_bounds_the_int32_limbs():
    """Twice the sum's cadence would let a limb pass 2^31 on its worst
    case: 4096 misses of warp 0 at full digits."""
    x = np.concatenate([_sum_data("max_digits", 1), np.full(N_SUM - 1, FULL)])
    *_, worst = _sum_model(x, 1)
    assert worst == WORST
    *_, worst = _sum_model(x, 1, spill_steps=16)
    assert worst == 2 * WORST > INT32_MAX
