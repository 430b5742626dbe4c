"""The anchored-window ExSUM of the PyTorch port (``ops/exsum.py``'s ladder,
``ops/kernels/sum_mxu.py``) held against the JAX package: every case of
``tests/test_sum_mxu.py`` through the port's ladder on CPU tensors with
the plain kernels, bit for bit against ``math.fsum`` and JAX
``impl="xla"``, and tier for tier against JAX's own routing helpers; the
routing helpers themselves; the plain B11 against the Pallas kernel in
interpret mode; ``rel_limbs_to_abs_limbs``; and the Superacc twin.
Tolerance is zero.  The CUDA kernels are held against the plain versions
on the card by ``chip_smoke.py``."""

import importlib
import math

import numpy as np
import pytest
import torch

import exblas_tpu as xb
import exblas_tpu_torch as xt
from exblas_tpu.core.ieee import split_f64
from exblas_tpu_torch.core.rounding import round_superacc_to_f64_bits
from exblas_tpu_torch.ops.exsum import (_exsum_acc_mxu_auto,
                                        _exsum_bits_mxu_auto, _sum_ladder)
from exblas_tpu_torch.ops.kernels import sum_mxu
from oracle import exact_sum
from torch_parity import (assert_same_bits, assert_same_state,
                          cached_jax_bits, jax_state, jax_sum_bits,
                          jax_sum_route, port_state, u64, window_pass_flags)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float64))


def _fsum_bits(x):
    """math.fsum's bits, or the exact oracle's where fsum overflows."""
    try:
        v = math.fsum(x)
    except OverflowError:
        v = exact_sum(x)
    return np.float64(v).view(np.uint64)


def _rng(seed):
    return np.random.default_rng(seed)


def _planted(x, idx, val):
    x = np.array(x, np.float64)
    x[idx] = val
    return x


def _zeros_mixed():
    x = _rng(12).uniform(-1, 1, 2000)
    x[::5] = 0.0
    return x


def _cancel():
    c = _rng(20).uniform(-1, 1, 1000)
    return np.concatenate([c, -c])


# (name, data) -- the cases of tests/test_sum_mxu.py, one per data set
CASES = [
    ("fast_path_uniform", lambda: _rng(11).uniform(-1, 1, 3000)),
    ("fast_path_zeros_mixed", _zeros_mixed),
    ("fast_path_subnormals",
     lambda: _rng(13).uniform(-1, 1, 2500) * 2.0**-1062),
    ("fast_path_outlier_within_slack",
     lambda: _planted(_rng(14).uniform(0.5, 1, 30000), 999, 40.0)),
    ("retry_exact_anchor",
     lambda: _planted(_rng(15).uniform(0.5, 1, 30000), 77, 2.0**40)),
    ("retry_unsampled_outlier",      # chunk 1 of 8192 is not sampled
     lambda: _planted(_rng(15).uniform(0.5, 1, 30000), 8192 + 77, 2.0**40)),
    ("vpu_fallback_wide_spread",
     lambda: xb.init_fpuniform(2000, 200, -100, seed=16)),
    ("vpu_fallback_outlier_huge",
     lambda: _planted(_rng(17).uniform(-1, 1, 30000), 12345, 1e300)),
    ("vpu_fallback_hidden_tiny_subnormal",
     lambda: _planted(_rng(18).uniform(-1, 1, 3000), 7, 5e-324)),
    ("overflow_pos", lambda: np.full(1500, 1.7e308)),
    ("overflow_neg", lambda: np.full(1500, -1.7e308)),
    ("exact_cancellation_positive_zero", _cancel),
    ("all_negative", lambda: -np.abs(_rng(21).uniform(0.1, 1, 2200))),
    ("near_max_cancels",
     lambda: np.array([8.9e307, -8.9e307, 1.0, -1.0] * 300 + [3.5])),
    ("wide_spread_nwa4_tier_50",
     lambda: xb.init_fpuniform(3000, 50, -25, seed=41)),
    ("wide_spread_nwa4_tier_66",
     lambda: xb.init_fpuniform(3000, 66, -33, seed=42)),
    ("beyond_128_goes_vpu", lambda: xb.init_fpuniform(3000, 80, -40, seed=43)),
    ("wide_outlier_retry_nwa4",
     lambda: _planted(xb.init_fpuniform(30000, 50, -25, seed=45), 123,
                      np.ldexp(1.0, 60))),
    ("illcond_1e30", lambda: xb.init_ill_cond(3000, 1e30, seed=90)),
    ("illcond_fpuniform_100",
     lambda: xb.init_fpuniform(3000, 100, -50, seed=91)),
    ("illcond_fpuniform_120",
     lambda: xb.init_fpuniform(3000, 120, -60, seed=92)),
    ("illcond_1e50", lambda: xb.init_ill_cond(3000, 1e50, seed=93)),
] + [(f"padding_edge_size_{n}",
      lambda n=n: np.random.default_rng(22 + n).uniform(-1, 1, n))
     for n in (1, 127, 128, 129, 65536, 65537)]

# The tiers each case takes: JAX's own routing replayed (jax_sum_route)
# gives the same.  Where a JAX test's name or comment says otherwise, it
# predates the current tiers or misses the sampler: x[77] and x[123] lie in
# the first chunk, which is sampled, and ill-conditioned data at c = 1e30
# (spread 119) and c = 1e50 (spread 163) at n = 3000 fit 128 and 160 bits.
ROUTES = {
    "fast_path_uniform": ("nwa3",),
    "fast_path_zeros_mixed": ("nwa3",),
    "fast_path_subnormals": ("nwa3",),
    "fast_path_outlier_within_slack": ("nwa3",),
    "retry_exact_anchor": ("nwa4",),
    "retry_unsampled_outlier": ("nwa3", "retry"),
    "vpu_fallback_wide_spread": ("exact",),
    "vpu_fallback_outlier_huge": ("nwa3", "retry", "exact"),
    "vpu_fallback_hidden_tiny_subnormal": ("nwa3", "retry", "exact"),
    "overflow_pos": ("nwa3",),
    "overflow_neg": ("nwa3",),
    "exact_cancellation_positive_zero": ("nwa3",),
    "all_negative": ("nwa3",),
    "near_max_cancels": ("exact",),
    "wide_spread_nwa4_tier_50": ("nwa4",),
    "wide_spread_nwa4_tier_66": ("nwa4",),
    "beyond_128_goes_vpu": ("nwa5",),
    "wide_outlier_retry_nwa4": ("exact",),
    "illcond_1e30": ("nwa4",),
    "illcond_fpuniform_100": ("nwa5",),
    "illcond_fpuniform_120": ("exact",),
    "illcond_1e50": ("nwa5",),
    **{f"padding_edge_size_{n}": ("nwa3",)
       for n in (1, 127, 128, 129, 65536, 65537)},
}


@pytest.fixture(scope="module")
def jax_bits():
    """JAX's bits (``impl="xla"``) of a case, computed once a module and
    worker (on the zero-padded data: the same exact value) and shared by
    the tests that hold the port to them."""
    return cached_jax_bits(jax_sum_bits)


@pytest.mark.parametrize("name,gen", CASES, ids=[c[0] for c in CASES])
def test_ladder_bits_and_route(name, gen, jax_bits):
    x = gen()
    got = u64(_exsum_bits_mxu_auto(_t(x), False))
    assert_same_bits(got, _fsum_bits(x), f"{name} vs math.fsum")
    assert_same_bits(got, jax_bits(name, x), f"{name} vs jax xla")
    route = _exsum_bits_mxu_auto.route
    assert route == ROUTES[name] == jax_sum_route(x), (name, route)


@pytest.mark.parametrize("name,gen", CASES, ids=[c[0] for c in CASES])
def test_sum_bits_mxu_matches_jax(name, gen, jax_bits):
    """Each window pass of the plain path (sum_bits_mxu, kernels=False) at
    the window and anchor the ladder gives it: the flags the case's route
    implies, and JAX's bits from the pass that is not flagged."""
    x = gen()
    passes = []

    def fast(v, e, nwa):
        bits, bad = sum_mxu.sum_bits_mxu(v, e, nwa, False)
        passes.append((bool(bad), bits))
        return bits, bad

    _sum_ladder(_t(x), fast, lambda v: None)
    assert [bad for bad, _ in passes] == window_pass_flags(ROUTES[name])
    for bad, bits in passes:
        if not bad:
            assert_same_bits(bits, jax_bits(name, x), name)


@pytest.mark.parametrize("val", [np.inf, -np.inf, np.nan])
def test_ladder_specials(val):
    x = _planted(_rng(19).uniform(-1, 1, 1500), 5, val)
    got = np.uint64(u64(_exsum_bits_mxu_auto(_t(x), False))).view(np.float64)
    if np.isnan(val):
        assert u64(np.float64(got).view(np.uint64)) == 0x7FF8000000000000
    else:
        assert got == val
    # the sample sees the special: no window pass at all
    assert _exsum_bits_mxu_auto.route == jax_sum_route(x) == ("exact",)


def test_public_entries_take_the_ladder(monkeypatch):
    """exsum/exsum_bits/exsum_acc route through the ladder for
    _SUM_MXU_MIN <= n <= MAX_N_MXU under impl="torch" (the kernels' rule
    alike), else to the exact kernel."""
    es = importlib.import_module("exblas_tpu_torch.ops.exsum")
    monkeypatch.setattr(es, "_SUM_MXU_MIN", 1000)
    x = xb.init_fpuniform(3000, 50, -25, seed=5)
    want = np.float64(math.fsum(x)).view(np.uint64)
    _exsum_bits_mxu_auto.route = ()
    assert_same_bits(xt.exsum_bits(_t(x)), want, "exsum_bits")
    assert _exsum_bits_mxu_auto.route == ("nwa4",)
    _exsum_acc_mxu_auto.route = ()
    acc = xt.exsum_acc(_t(x))
    assert _exsum_acc_mxu_auto.route == ("nwa4",)
    assert_same_bits(round_superacc_to_f64_bits(acc), want, "exsum_acc")
    _exsum_bits_mxu_auto.route = ()
    assert_same_bits(xt.exsum_bits(_t(x[:999])),
                     np.float64(math.fsum(x[:999])).view(np.uint64), "small")
    assert _exsum_bits_mxu_auto.route == ()


# --- the routing helpers against JAX's --------------------------------------

def _helper_data(n: int) -> np.ndarray:
    rs = np.random.RandomState(n)
    x = np.ldexp(rs.uniform(0.5, 1, n), rs.randint(-40, 40, n))
    x[rs.rand(n) < 0.1] = 0.0
    if n > 50:
        x[n // 3] = 3e-320                 # subnormal
        x[n // 2] = -5e-324
    return x


HELPER_SIZES = (1, 100, 8191, 8192, 16385, 3 * 8192 + 5, (1 << 17) + 3)


@pytest.mark.parametrize("n", HELPER_SIZES)
def test_routing_helpers_match_jax(n):
    from exblas_tpu.ops.kernels import sum_mxu as jsm

    x = _helper_data(n)
    variants = [x]
    if n >= 100:
        variants.append(_planted(x, n - 3, np.inf))      # a special
        # the extremes in a chunk the sampler skips (chunk 1 of 8192)
        variants.append(_planted(x, min(n - 1, 8192 + 17), 2.0**-200))
    for v in variants:
        hi = split_f64(v).hi
        e_s, s_s = sum_mxu.sample_anchor(_t(v))
        je_s, js_s = jsm.sample_anchor(hi)
        assert (int(e_s), int(s_s)) == (int(je_s), int(js_s))
        e_f, s_f = sum_mxu.full_anchor(_t(v))
        je_f, js_f = jsm.full_anchor(hi)
        assert (int(e_f), int(s_f)) == (int(je_f), int(js_f))
        assert int(sum_mxu.exact_anchor(_t(v))) == int(jsm.exact_anchor(hi))
        for bounds in ((96, 128, 168), (int(s_s) + 4,), (int(s_s) + 20,)):
            e_r, s_r = sum_mxu.resolve_anchor(_t(v), e_s, s_s, bounds)
            je_r, js_r = jsm.resolve_anchor(hi, je_s, js_s, bounds)
            assert (int(e_r), s_r) == (int(je_r), int(js_r)), bounds


def test_resolve_anchor_guard_band():
    """The JAX test's planted element: the sampler misses it, the guard
    band resolves it exactly, a spread outside the band stays sampled."""
    n = 8192 * 33
    x = np.full(n, 1.0)
    x[8192 * 9 + 5] = np.ldexp(1.0, -130)
    e_s, s_s = sum_mxu.sample_anchor(_t(x))
    e_f, s_f = sum_mxu.full_anchor(_t(x))
    assert int(s_f) > int(s_s)
    e_r, s_r = sum_mxu.resolve_anchor(_t(x), e_s, s_s, (int(s_s) + 4,))
    assert (int(e_r), s_r) == (int(e_f), int(s_f))
    e_r, s_r = sum_mxu.resolve_anchor(_t(x), e_s, s_s,
                                      (int(s_s) + sum_mxu._GUARD_BITS + 4,))
    assert (int(e_r), s_r) == (int(e_s), int(s_s))


# --- the plain B11 against the Pallas kernel (interpret mode) ---------------

N_FLAT = 5000   # one (512, 128) block: one grid step


def _pallas_sum_value(x, anchor: int, nwa: int):
    """(exact relative value as an int, flag) of JAX's _sum_epilogue_terms
    in interpret mode; one compile per nwa."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from exblas_tpu.ops.kernels import sum_mxu as jsm

    b = split_f64(x)
    r_pad = jsm.sum_pad_rows(len(x))
    pad = r_pad * 128 - len(x)
    hi2 = jnp.pad(b.hi, (0, pad)).reshape(r_pad, 128)
    lo2 = jnp.pad(b.lo, (0, pad)).reshape(r_pad, 128)
    fn = _pallas_sum_value.jitted.setdefault(nwa, jax.jit(
        lambda h, lo, e: jsm._sum_epilogue_terms(h, lo, e, nwa)[::2]))
    with pltpu.force_tpu_interpret_mode():
        vals, bad = fn(hi2, lo2, jnp.int32(anchor))
    pos = [32 * w + 8 * p for w in range(nwa) for p in range(4)] + [32 * nwa]
    return sum(int(v) << p for v, p in zip(np.asarray(vals).tolist(), pos)), \
        bool(bad)


_pallas_sum_value.jitted = {}


def _port_sum_value(x, anchor: int, nwa: int):
    rel, bad = sum_mxu.sum_flat_torch(_t(x), torch.tensor(anchor,
                                                          dtype=torch.int32),
                                      nwa)
    return sum(int(r) << (32 * k) for k, r in enumerate(rel.tolist())), \
        bool(bad), rel


@pytest.mark.parametrize("nwa,flagged", [(3, False), (4, False), (5, False),
                                         (3, True)])
def test_sum_flat_matches_pallas(nwa, flagged):
    rs = np.random.RandomState(nwa)
    span = {3: 30, 4: 60, 5: 90}[nwa]
    x = np.ldexp(rs.uniform(0.5, 1, N_FLAT), rs.randint(-span // 2,
                                                       span // 2, N_FLAT))
    x *= np.where(rs.rand(N_FLAT) < 0.5, -1.0, 1.0)
    x[::11] = 0.0
    anchor = int(sum_mxu.exact_anchor(_t(x)))
    if flagged:
        x[4321] = 2.0**-200          # below the window
    got, got_bad, rel = _port_sum_value(x, anchor, nwa)
    want, want_bad = _pallas_sum_value(x, anchor, nwa)
    assert got_bad == want_bad == flagged
    if not flagged:
        assert got == want
    # the canonical terms the kernel's last block writes
    assert all(0 <= int(v) < 1 << 32 for v in rel[:-1].tolist())
    assert int(rel[-1]) == got >> (32 * nwa)


# --- rel_limbs_to_abs_limbs --------------------------------------------------

@pytest.mark.parametrize("fmt_name", ["SUM_FORMAT", "DOT_FORMAT"])
def test_rel_limbs_to_abs_limbs_matches_jax(fmt_name):
    import jax.numpy as jnp
    import jax
    from exblas_tpu.core import rounding as jr
    from exblas_tpu.core import types as jt
    from exblas_tpu_torch.core import rounding as tr
    from exblas_tpu_torch.core import types as tt

    jfn = jax.jit(jr.rel_limbs_to_abs_limbs, static_argnums=2)
    rs = np.random.RandomState(3)
    lr = 12
    for p0 in (0, 7, 19, 20, 333, -1, -13, -20, -27):
        rel = rs.randint(-(1 << 40), 1 << 40, lr).astype(np.int64)
        if p0 < 0:
            # a multiple of 2^-p0: digits below absolute bit 0 vanish, one
            # digit may straddle it
            v = sum(int(r) << (20 * j) for j, r in enumerate(rel))
            v = (v >> -p0) << -p0
            rel = np.array([(v >> (20 * j)) & 0xFFFFF for j in range(lr)],
                           np.int64)
            rel[-1] = v >> (20 * (lr - 1))
        for sign in (1, -1):
            r = rel * sign
            got = tr.rel_limbs_to_abs_limbs(torch.from_numpy(r), p0,
                                            getattr(tt, fmt_name))
            want = jfn(jnp.asarray(r), jnp.int32(p0), getattr(jt, fmt_name))
            gd, gn = tr.canonicalize_digits(got)
            wd, wn = jr.canonicalize_digits(want[None, :])
            assert bool(gn) == bool(wn[0]), (p0, sign)
            assert np.array_equal(gd.numpy(), np.asarray(wd[0])), (p0, sign)


# --- the Superacc twin --------------------------------------------------------

def test_acc_ladder_superacc_and_merge():
    """_exsum_acc_mxu_auto: absolute SUM_FORMAT state equal to JAX's
    exsum_acc(impl="xla"), and mergeable with an exact-kernel Superacc."""
    x1 = _rng(51).uniform(-1, 1, 2600)
    x2 = xb.init_fpuniform(2000, 40, -20, seed=9)
    a1 = _exsum_acc_mxu_auto(_t(x1), False)
    assert _exsum_acc_mxu_auto.route == ("nwa3",)
    a2 = xt.exsum_acc(_t(x2))
    got = round_superacc_to_f64_bits(a1 + a2)
    assert_same_bits(got, np.float64(math.fsum(np.concatenate([x1, x2])))
                     .view(np.uint64), "merge")
    for data in (x1, -np.abs(_rng(52).uniform(0.1, 1, 2500)),
                 xb.init_ill_cond(3000, 1e30, seed=2)):
        acc = _exsum_acc_mxu_auto(_t(data), False)
        assert_same_state(port_state(acc),
                          jax_state(xb.exsum_acc(data, impl="xla")), "state")
        assert_same_bits(round_superacc_to_f64_bits(acc),
                         np.float64(math.fsum(data)).view(np.uint64), "bits")


def test_cuda_wrappers_refuse_cpu_tensors():
    x = _t([1.0, 2.0])
    e = torch.tensor(0, dtype=torch.int32)
    before = sum_mxu.sum_flat_cuda.launches
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        sum_mxu.sum_flat_cuda(x, e, 3)
    assert sum_mxu.sum_flat_cuda.launches == before


# --- B11's frame (core/window.py) ----------------------------------------------

@pytest.mark.parametrize("nwa", sum_mxu.NWA_TIERS)
def test_frame_places_every_shift_and_holds_max_n(nwa):
    """Every covered shift, with the largest, smallest and a random
    significand, puts its exact value in three words below 2^32 at frame
    words q..q + 2 within the nwa + 1 sums a sign (the top word of a
    frame at q = nwa - 2 is 0: the element ends below 2^(32 nwa)), and
    MAX_N_MXU elements keep every sum below 2^62."""
    from exblas_tpu_torch.core import window

    assert window.MAX_N == sum_mxu.MAX_N_MXU
    assert window.sums_bound() < 1 << 62
    rs = np.random.RandomState(nwa)
    for sh in range(32 * nwa - 52):
        for m in ((1 << 53) - 1, 1 << 52, 1,
                  int(rs.randint(1, 1 << 53, dtype=np.int64))):
            q, words = window.element_words(m, sh, nwa)
            assert all(0 <= w < 1 << 32 for w in words)
            assert q + 2 <= nwa and (q + 2 < nwa or words[2] == 0)
            assert sum(w << (32 * (q + j)) for j, w in enumerate(words)) \
                == m << sh, (m, sh)
