"""The anchored-window ExDOT of the PyTorch port (``ops/exdot.py``'s ladder,
``ops/kernels/dot_mxu.py``) held against the JAX package: every case of
``tests/test_dot_mxu.py`` through the port's ladder on CPU tensors with
the plain kernels, bit for bit against the exact oracle and JAX
``impl="xla"``, and tier for tier against JAX's own routing helpers; the
plain B12 against the Pallas kernel in interpret mode; and the Superacc
twin.  Tolerance is zero.  The CUDA kernels are held against the plain
versions on the card by ``chip_smoke.py``."""

import importlib

import numpy as np
import pytest
import torch

import exblas_tpu as xb
import exblas_tpu_torch as xt
from exblas_tpu.core.ieee import split_f64
from exblas_tpu_torch.core.rounding import round_superacc_to_f64_bits
from exblas_tpu_torch.ops.exdot import (_dot_mxu_ladder,
                                        _exdot_acc_mxu_auto,
                                        _exdot_bits_mxu_auto)
from exblas_tpu_torch.ops.kernels import dot_mxu, sum_mxu
from oracle import exact_dot
from torch_parity import (assert_same_bits, assert_same_state,
                          cached_jax_bits, jax_dot_bits, jax_dot_route,
                          jax_state, port_state, u64, window_pass_flags)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float64))


def _rng(seed):
    return np.random.default_rng(seed)


def _oracle_bits(a, b):
    return np.float64(exact_dot(a, b)).view(np.uint64)


def _uniform_pair(seed, n, lo=-1.0, hi=1.0):
    r = _rng(seed)
    return r.uniform(lo, hi, n), r.uniform(lo, hi, n)


def _zeros_and_signs():
    a, b = _uniform_pair(32, 2000)
    a[::5] = 0.0
    b[::7] = 0.0
    b[::3] *= -1.0
    return a, b


def _cancel():
    a, b = _uniform_pair(34, 1000)
    return np.concatenate([a, a]), np.concatenate([b, -b])


def _planted(pair, side, idx, val):
    a, b = (np.array(v, np.float64) for v in pair)
    (a if side == 0 else b)[idx] = val
    return a, b


def _asym(swap):
    a = xb.init_fpuniform(3000, 2, 0, seed=35)
    b = xb.init_fpuniform(3000, 50, -25, seed=36)
    return (b, a) if swap else (a, b)


# (name, (a, b), route) -- the cases of tests/test_dot_mxu.py, one per data
# pair, with the tiers they take; JAX's own routing replayed
# (jax_dot_route) gives the same.  x[77] lies in the first, sampled chunk,
# so "retry_exact_anchor" needs no retry; "retry_unsampled_outlier" puts the
# outlier in chunk 1, which the sampler skips.
CASES = [
    ("fast_path_uniform", lambda: _uniform_pair(31, 3000), ("fast",)),
    ("fast_path_zeros_and_signs", _zeros_and_signs, ("fast",)),
    ("all_negative_times_positive",
     lambda: (-np.abs(_rng(33).uniform(0.1, 1, 2200)),
              np.abs(_rng(133).uniform(0.1, 1, 2200))), ("fast",)),
    ("cancellation_exact_zero", _cancel, ("fast",)),
    ("asymmetric_spreads", lambda: _asym(False), ("fast",)),
    ("asymmetric_spreads_swapped", lambda: _asym(True), ("fast",)),
    ("illcond_nw5_tier",
     lambda: (xb.init_ill_cond(3000, 1e30, seed=37),
              _rng(38).uniform(0.5, 2.0, 3000)), ("fast",)),
    ("illcond_over_160",
     lambda: (xb.init_fpuniform(2000, 200, -100, seed=39),
              xb.init_fpuniform(2000, 2, 0, seed=40)), ("exact",)),
    ("retry_exact_anchor",
     lambda: _planted(_uniform_pair(41, 30000, 0.5, 1), 0, 77, 2.0**40),
     ("fast",)),
    ("retry_unsampled_outlier",
     lambda: _planted(_uniform_pair(41, 30000, 0.5, 1), 0, 8192 + 77,
                      2.0**40), ("fast", "retry")),
    ("vpu_fallback_unsampled_huge_outlier",
     lambda: _planted(_uniform_pair(42, 30000), 0, 12345, 1e300),
     ("fast", "retry", "exact")),
    ("vpu_fallback_hidden_tiny_subnormal",
     lambda: _planted(_uniform_pair(43, 3000), 1, 7, 5e-324),
     ("fast", "retry", "exact")),
    ("zero_hides_no_uncovered_partner",
     lambda: _planted(_planted(_uniform_pair(44, 3000), 0, 9, 0.0),
                      1, 9, 5e-324), ("fast", "retry", "exact")),
    ("subnormal_products",
     lambda: (_rng(44).uniform(0.5, 1, 2000) * 2.0**-520,
              _rng(144).uniform(0.5, 1, 2000) * 2.0**-520), ("fast",)),
] + [(f"padding_edge_size_{n}", lambda n=n: _uniform_pair(46 + n, n),
      ("fast",)) for n in (1, 127, 8192, 8193, 65536, 65537)]


@pytest.fixture(scope="module")
def jax_bits():
    """JAX's bits (``impl="xla"``) of a case, computed once a module and
    worker (on the zero-padded data: the same exact value) and shared by
    the tests that hold the port to them."""
    return cached_jax_bits(jax_dot_bits)


@pytest.mark.parametrize("name,gen,route", CASES, ids=[c[0] for c in CASES])
def test_ladder_bits_and_route(name, gen, route, jax_bits):
    a, b = gen()
    got = u64(_exdot_bits_mxu_auto(_t(a), _t(b), False))
    assert_same_bits(got, _oracle_bits(a, b), f"{name} vs exact oracle")
    assert_same_bits(got, jax_bits(name, a, b), f"{name} vs jax xla")
    assert _exdot_bits_mxu_auto.route == route == jax_dot_route(a, b), (
        name, _exdot_bits_mxu_auto.route)


@pytest.mark.parametrize("name,gen,route", CASES, ids=[c[0] for c in CASES])
def test_dot_bits_mxu_matches_jax(name, gen, route, jax_bits):
    """Each window pass of the plain path (dot_bits_mxu, kernels=False) at
    the anchors the ladder gives it: the flags the case's route implies,
    and JAX's bits from the pass that is not flagged."""
    a, b = gen()
    passes = []

    def fast(*v):
        bits, bad = dot_mxu.dot_bits_mxu(*v, False)
        passes.append((bool(bad), bits))
        return bits, bad

    _dot_mxu_ladder(_t(a), _t(b), fast, lambda *v: None)
    assert [bad for bad, _ in passes] == window_pass_flags(route)
    for bad, bits in passes:
        if not bad:
            assert_same_bits(bits, jax_bits(name, a, b), name)


@pytest.mark.parametrize("val", [np.inf, -np.inf, np.nan])
def test_specials_fall_back(val):
    a, b = _planted(_uniform_pair(45, 1500, 0.5, 1), 0, 5, val)
    got = np.uint64(u64(_exdot_bits_mxu_auto(_t(a), _t(b), False))).view(
        np.float64)
    if np.isnan(val):
        assert u64(np.float64(got).view(np.uint64)) == 0x7FF8000000000000
    else:
        assert got == val    # times positive b[5]
    assert _exdot_bits_mxu_auto.route == jax_dot_route(a, b) == ("exact",)


def test_tight_side_goes_exact():
    """A resolved spread in (160, 168] runs its side at the anchor with the
    slack undone; a flag from that pass goes straight to the exact kernel
    (a retry at the same exact anchors would flag again)."""
    r = np.random.RandomState(7)
    a = np.ldexp(r.uniform(0.5, 1, 3000), r.randint(-50, 50, 3000))
    a[0], a[1] = 2.0**51, 2.0**-52      # spread 51 + 8 - (-52 - 52) + 1 = 164
    b = r.uniform(0.5, 1, 3000)
    b[3] = 5e-324                        # b flags at any anchor near 0
    got = u64(_exdot_bits_mxu_auto(_t(a), _t(b), False))
    assert_same_bits(got, _oracle_bits(a, b), "tight")
    assert _exdot_bits_mxu_auto.route == ("fast", "exact") == jax_dot_route(
        a, b)
    b[3] = 0.75
    got = u64(_exdot_bits_mxu_auto(_t(a), _t(b), False))
    assert_same_bits(got, _oracle_bits(a, b), "tight covered")
    assert _exdot_bits_mxu_auto.route == ("fast",) == jax_dot_route(a, b)


def test_public_entries_take_the_ladder(monkeypatch):
    ed = importlib.import_module("exblas_tpu_torch.ops.exdot")
    monkeypatch.setattr(ed, "_DOT_MXU_MIN", 1000)
    a, b = _uniform_pair(8, 3000)
    want = _oracle_bits(a, b)
    _exdot_bits_mxu_auto.route = ()
    assert_same_bits(xt.exdot_bits(_t(a), _t(b)), want, "exdot_bits")
    assert _exdot_bits_mxu_auto.route == ("fast",)
    _exdot_acc_mxu_auto.route = ()
    acc = xt.exdot_acc(_t(a), _t(b))
    assert _exdot_acc_mxu_auto.route == ("fast",)
    assert_same_bits(round_superacc_to_f64_bits(acc), want, "exdot_acc")
    _exdot_bits_mxu_auto.route = ()
    assert_same_bits(xt.exdot_bits(_t(a[:999]), _t(b[:999])),
                     _oracle_bits(a[:999], b[:999]), "small")
    assert _exdot_bits_mxu_auto.route == ()


# --- the plain B12 against the Pallas kernel (interpret mode) ---------------

N_FLAT = 5000   # one (8, 8192) block: one grid step


def _pallas_dot_value(a, b, ea: int, eb: int):
    """(exact relative value as an int, flag) of JAX's _dot_epilogue_terms
    in interpret mode (one compile)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from exblas_tpu.ops.kernels import dot_mxu as jdm

    r8 = jdm.dot_pad_rows(len(a))
    pad = r8 * jdm.WIDE - len(a)
    planes = []
    for v in (a, b):
        s = split_f64(v)
        planes += [jnp.pad(p, (0, pad)).reshape(r8, jdm.WIDE)
                   for p in (s.hi, s.lo)]
    if _pallas_dot_value.fn is None:
        def terms(ha, la, hb, lb, e1, e2):
            vals, _, bad, _ = jdm._dot_epilogue_terms(ha, la, hb, lb, e1, e2)
            return vals, bad

        _pallas_dot_value.fn = jax.jit(terms)
    with pltpu.force_tpu_interpret_mode():
        vals, bad = _pallas_dot_value.fn(*planes, jnp.int32(ea),
                                         jnp.int32(eb))
    na = nb = 20
    pos = ([8 * c for c in range(na + nb - 1)]
           + [160 + 8 * p for p in range(na)]
           + [160 + 8 * p for p in range(nb)] + [320])
    return sum(int(v) << p for v, p in zip(np.asarray(vals).tolist(), pos)), \
        bool(bad)


_pallas_dot_value.fn = None


@pytest.mark.parametrize("flag_side", [None, 1])
def test_dot_flat_matches_pallas(flag_side):
    r = np.random.RandomState(11)
    a = np.ldexp(r.uniform(0.5, 1, N_FLAT), r.randint(-40, 40, N_FLAT))
    b = np.ldexp(r.uniform(0.5, 1, N_FLAT), r.randint(-40, 40, N_FLAT))
    a *= np.where(r.rand(N_FLAT) < 0.5, -1.0, 1.0)
    a[::13] = 0.0
    b[::17] = 0.0
    ea = int(sum_mxu.exact_anchor(_t(a)))
    eb = int(sum_mxu.exact_anchor(_t(b)))
    if flag_side is not None:
        a[26] = 0.0                       # a zero partner hides nothing
        b[26] = 2.0**-200
    rel, bad = dot_mxu.dot_flat_torch(_t(a), _t(b),
                                      torch.tensor(ea, dtype=torch.int32),
                                      torch.tensor(eb, dtype=torch.int32))
    got = sum(int(v) << (32 * k) for k, v in enumerate(rel.tolist()))
    want, want_bad = _pallas_dot_value(a, b, ea, eb)
    assert bool(bad) == want_bad == (flag_side is not None)
    if flag_side is None:
        assert got == want


# --- the Superacc twin --------------------------------------------------------

def test_acc_ladder_superacc_and_merge():
    """_exdot_acc_mxu_auto: absolute DOT_FORMAT state equal to JAX's
    exdot_acc(impl="xla"), and mergeable with an exact-kernel Superacc."""
    a1, b1 = _uniform_pair(47, 2600)
    a2 = xb.init_fpuniform(2000, 40, -20, seed=48)
    b2 = xb.init_fpuniform(2000, 40, -20, seed=49)
    acc1 = _exdot_acc_mxu_auto(_t(a1), _t(b1), False)
    assert _exdot_acc_mxu_auto.route == ("fast",)
    acc2 = xt.exdot_acc(_t(a2), _t(b2))
    assert_same_bits(round_superacc_to_f64_bits(acc1 + acc2),
                     _oracle_bits(np.concatenate([a1, a2]),
                                  np.concatenate([b1, b2])), "merge")
    rng = _rng(50)
    for a, b in ((a1, b1),
                 (-np.abs(rng.uniform(0.1, 1, 2500)),
                  np.abs(rng.uniform(0.1, 1, 2500))),
                 (rng.uniform(0.5, 1, 2000) * 2.0**-530,
                  rng.uniform(0.5, 1, 2000) * 2.0**-530)):
        acc = _exdot_acc_mxu_auto(_t(a), _t(b), False)
        assert_same_state(port_state(acc),
                          jax_state(xb.exdot_acc(a, b, impl="xla")), "state")
        assert_same_bits(round_superacc_to_f64_bits(acc), _oracle_bits(a, b),
                         "bits")


def test_cuda_wrapper_refuses_cpu_tensors():
    x = _t([1.0, 2.0])
    e = torch.tensor(0, dtype=torch.int32)
    before = dot_mxu.dot_flat_cuda.launches
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        dot_mxu.dot_flat_cuda(x, x, e, e)
    assert dot_mxu.dot_flat_cuda.launches == before


# --- B12's terms: the canonical digits of the exact value ---------------------

def _value(terms) -> int:
    return sum(int(v) << (32 * k) for k, v in enumerate(terms.tolist()))


def _flat_pairs(kind):
    r = np.random.RandomState(13)
    if kind == "mixed":
        a = np.ldexp(r.uniform(0.5, 1, N_FLAT), r.randint(-50, 50, N_FLAT))
        b = np.ldexp(r.uniform(0.5, 1, N_FLAT), r.randint(-50, 50, N_FLAT))
        a *= np.where(r.rand(N_FLAT) < 0.5, -1.0, 1.0)
        a[::11] = 0.0
        return a, b
    if kind == "frame_edges":
        # full significands at each window's top (leading bit at 2^0) or
        # bottom (LSB at 2^-159): products at frame bits 214, 107 and 0,
        # signs alternating
        def side(k):
            m = r.randint(1 << 52, 1 << 53, N_FLAT).astype(np.float64)
            x = np.ldexp(m, np.where(r.rand(N_FLAT) < 0.5, -52, -159))
            return x * np.where((np.arange(N_FLAT) >> k) % 2 == 0, 1.0, -1.0)
        a, b = side(0), side(1)
        a[0] = b[0] = 2.0 - 2.0 ** -52
        return a, b
    # negative total: the top term is negative
    a = -np.abs(np.ldexp(r.uniform(0.5, 1, N_FLAT),
                         r.randint(-30, 30, N_FLAT)))
    return a, np.abs(np.ldexp(r.uniform(0.5, 1, N_FLAT),
                              r.randint(-30, 30, N_FLAT)))


@pytest.mark.parametrize("kind", ["mixed", "frame_edges", "negative"])
def test_dot_flat_terms_are_the_old_layouts_value(kind):
    """The terms are the canonical digits (0 <= T_k < 2^32, T_10 the value
    >> 320) of the same exact value as the earlier layout's terms: the
    two's-complement word sums and minus the negative count at bit 320
    (sum_mxu._frame_terms, B11's layout), and as the kernel's own signed
    word sums."""
    a, b = _flat_pairs(kind)
    ea = int(sum_mxu.exact_anchor(_t(a)))
    eb = int(sum_mxu.exact_anchor(_t(b)))
    rel, bad = dot_mxu.dot_flat_torch(_t(a), _t(b), ea, eb)
    assert not bool(bad)
    va, vb = _t(a).view(torch.int64), _t(b).view(torch.int64)
    base = 1 - dot_mxu.WINDOW
    words, q, neg, _ = dot_mxu.pair_words(va, vb, ea + base, eb + base)
    old = sum_mxu._frame_terms(words, q, neg, dot_mxu.FRAME_WORDS)
    value = _value(old)
    assert _value(rel) == value == _value(dot_mxu.signed_word_sums(
        words, q, neg))
    assert all(0 <= int(v) < 1 << 32 for v in rel[:-1].tolist())
    assert int(rel[-1]) == value >> 320
    if kind == "negative":
        assert value < 0 and int(rel[-1]) < 0


def test_dot_flat_word_sums_fit_int64_at_max_n():
    """By the model: every word of a pair is below 2^32 (the largest
    significands at every frame offset reach 2^32 - 1), so the sums of one
    sign's words over MAX_N_DOT_MXU pairs -- what a thread, a block and the
    workspace hold -- stay below 2^63, and the last block's carry pass over
    the worst signed sums stays within int64."""
    full = float((1 << 53) - 1)
    # anchors 0 (windows from 2^-159): a's LSB at every covered shift sha,
    # b's at the top (shb = 107), so the products take every frame offset
    sh = np.arange(108)
    a = np.ldexp(full, sh - 159)
    b = np.ldexp(np.full(108, full), 107 - 159)
    va, vb = _t(a).view(torch.int64), _t(b).view(torch.int64)
    base = 1 - dot_mxu.WINDOW
    words, q, neg, bad = dot_mxu.pair_words(va, vb, base, base)
    assert not bool(bad.any()) and not bool(neg.any())
    top = max(int(w.max()) for w in words)
    assert top == (1 << 32) - 1
    n = dot_mxu.MAX_N_DOT_MXU
    worst = n * top
    assert worst < 1 << 63
    for sign in (1, -1):      # every sum at its worst, of either sign
        carry = 0
        for _ in range(dot_mxu.FRAME_WORDS + 1):
            t = sign * worst + carry
            assert -(1 << 63) <= t < 1 << 63
            carry = t >> 32
