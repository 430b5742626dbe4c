"""Parity helpers for the PyTorch port's tests: the same float64 numpy input
goes through the JAX reference (``impl="xla"``, or a Pallas kernel entry in
TPU interpret mode) and through the port, and results compare as uint64
bits, or as canonical digits plus sign and special counts for
accumulators.  Tolerance is zero throughout."""

from __future__ import annotations

import functools

import numpy as np
import torch

import exblas_tpu as xb
import exblas_tpu_torch as xt
from exblas_tpu.core.ieee import split_f64
from exblas_tpu_torch.core.rounding import canonicalize_digits

U64 = (1 << 64) - 1


def u64(bits) -> int:
    """An int64/uint64 bit pattern (tensor, array or int) as a Python int in
    [0, 2^64)."""
    return int(np.asarray(bits.cpu() if isinstance(bits, torch.Tensor)
                          else bits).reshape(()).astype(np.uint64)) & U64


def port_state(acc):
    """(digits, negative, special) of a port Superacc, as numpy."""
    d, neg = canonicalize_digits(acc.limbs)
    return d.numpy(), bool(neg), acc.special.numpy().astype(np.int64)


@functools.lru_cache(maxsize=None)
def _jax_canonicalize():
    """The JAX package's ``canonicalize_digits``, compiled once a shape (it
    runs op by op, each call, when called eagerly)."""
    import jax
    from exblas_tpu.core.rounding import canonicalize_digits as jcanon

    return jax.jit(jcanon)


def jax_state(acc):
    """(digits, negative, special) of a JAX Superacc, canonicalized by the
    JAX package's own ``canonicalize_digits``."""
    d, neg = _jax_canonicalize()(acc.limbs)
    return (np.asarray(d).astype(np.int32), bool(neg),
            np.asarray(acc.special).astype(np.int64))


def assert_same_state(got, want, msg=""):
    gd, gn, gs = got
    wd, wn, ws = want
    assert gn == wn, f"{msg}: sign {gn} != {wn}"
    assert np.array_equal(gs, ws), f"{msg}: specials {gs} != {ws}"
    assert np.array_equal(gd, wd), (
        f"{msg}: digits differ at limbs {np.nonzero(gd != wd)[0][:8]}")


def assert_same_bits(got, want, msg=""):
    assert u64(got) == u64(want), (
        f"{msg}: {u64(got):#018x} != {u64(want):#018x}")


# --- port (plain PyTorch path on CPU tensors) ------------------------------

def port_sum_bits(x, **kw) -> int:
    return u64(xt.exsum_bits(torch.from_numpy(np.asarray(x, np.float64)),
                             **kw))


def port_dot_bits(a, b, **kw) -> int:
    return u64(xt.exdot_bits(torch.from_numpy(np.asarray(a, np.float64)),
                             torch.from_numpy(np.asarray(b, np.float64)),
                             **kw))


# --- JAX reference ---------------------------------------------------------

def jax_sum_bits(x, **kw) -> int:
    return u64(xb.exsum_bits(np.asarray(x, np.float64), impl="xla", **kw))


def jax_dot_bits(a, b, **kw) -> int:
    return u64(xb.exdot_bits(np.asarray(a, np.float64),
                             np.asarray(b, np.float64), impl="xla", **kw))


def zero_padded(*vs):
    """The vectors padded with +0.0 to 2^17 elements (or the next power of
    two above): the same exact sum or dot in one shape, so that JAX
    compiles its reference once for all the cases of a module."""
    n = max(1 << 17, 1 << (len(vs[0]) - 1).bit_length())
    return [np.concatenate([np.asarray(v, np.float64),
                            np.zeros(n - len(v))]) for v in vs]


def cached_jax_bits(fn):
    """A JAX reference ``fn`` memoized by case name, for a module-scoped
    fixture: ``get(name, *vectors)`` computes ``fn`` on the zero-padded
    vectors once a name and worker."""
    cache = {}

    def get(name, *vs):
        if name not in cache:
            cache[name] = fn(*zero_padded(*vs))
        return cache[name]

    return get


def pallas_interpret(entry: str, *arrays, rows: int = 8):
    """Run a Pallas kernel entry of the JAX package in TPU interpret mode
    (as tests/test_kernel_interpret.py does)."""
    from jax.experimental.pallas import tpu as pltpu
    from exblas_tpu.ops.kernels import dot_kernel, sum_kernel

    fn = {"exsum_pallas": sum_kernel.exsum_pallas,
          "exsum_bits_pallas": sum_kernel.exsum_bits_pallas,
          "exdot_pallas": dot_kernel.exdot_pallas,
          "exdot_bits_pallas": dot_kernel.exdot_bits_pallas}[entry]
    planes = []
    for a in arrays:
        b = split_f64(np.asarray(a, np.float64))
        planes += [b.hi, b.lo]
    with pltpu.force_tpu_interpret_mode():
        return fn(*planes, rows=rows)


# --- the anchored-window ladders' routes, from the JAX package's helpers ---
#
# The JAX ladders branch on the device, so the tier they take is not
# visible.  These replay their decisions (exsum.py:52-116, exdot.py:44-130)
# with the JAX package's own routing helpers and its per-element coverage
# check (gemv_mxu._slice_byte_words, plain jnp: no Pallas kernel runs).

def _jax_flag(bits, anchor: int, nwa: int) -> bool:
    import jax.numpy as jnp

    return bool(_jax_helpers()[1](bits.hi, bits.lo, jnp.int32(anchor), nwa))


def _jax_resolved(bits, boundaries):
    """(resolved anchor, resolved spread, exact anchor) as ints."""
    return tuple(int(v) for v in _jax_helpers()[0](bits.hi, boundaries))


def _jax_helpers():
    """The JAX routing helpers and coverage check, each jitted once (one
    compile per shape instead of one per eager operation)."""
    if not _JAX_HELPERS:
        import jax
        import jax.numpy as jnp
        from exblas_tpu.ops.kernels.gemv_mxu import _slice_byte_words
        from exblas_tpu.ops.kernels.sum_mxu import (exact_anchor,
                                                    resolve_anchor,
                                                    sample_anchor)

        def route(hi, boundaries):
            e, s = resolve_anchor(hi, *sample_anchor(hi), boundaries)
            return e, s, exact_anchor(hi)

        def flag(hi, lo, anchor, nwa):
            return jnp.any(_slice_byte_words(hi, lo, anchor, nwa,
                                             check=True)[2])

        _JAX_HELPERS.extend([jax.jit(route, static_argnums=1),
                             jax.jit(flag, static_argnums=3)])
    return _JAX_HELPERS


_JAX_HELPERS = []


def jax_sum_route(x) -> tuple:
    """The tiers JAX's ``_exsum_bits_mxu_auto`` takes on ``x``, in the
    port's names (``_exsum_bits_mxu_auto.route``)."""
    b = split_f64(np.asarray(x, np.float64))
    e, s, ex = _jax_resolved(b, (96, 128, 168))
    for bound, nwa, deslack in ((96, 3, 0), (128, 4, 0), (168, 5, 8)):
        if s <= bound:
            break
    else:
        return ("exact",)
    if not _jax_flag(b, e - deslack, nwa):
        return (f"nwa{nwa}",)
    if not _jax_flag(b, ex, 5):
        return (f"nwa{nwa}", "retry")
    return (f"nwa{nwa}", "retry", "exact")


def jax_dot_route(a, b) -> tuple:
    """The tiers JAX's ``_exdot_bits_mxu_auto`` takes on (a, b), in the
    port's names; the window pass JAX runs and discards when a spread is
    over every window is left out, as the port skips it."""
    ba = split_f64(np.asarray(a, np.float64))
    bb = split_f64(np.asarray(b, np.float64))
    ea, sa, xa = _jax_resolved(ba, (168,))
    eb, sb, xb_ = _jax_resolved(bb, (168,))
    if sa > 168 or sb > 168:
        return ("exact",)
    ea -= 8 if sa > 160 else 0
    eb -= 8 if sb > 160 else 0
    if not (_jax_flag(ba, ea, 5) or _jax_flag(bb, eb, 5)):
        return ("fast",)
    if sa > 160 or sb > 160:
        return ("fast", "exact")
    if not (_jax_flag(ba, xa, 5) or _jax_flag(bb, xb_, 5)):
        return ("fast", "retry")
    return ("fast", "retry", "exact")


def window_pass_flags(route) -> list:
    """The flags of the window passes a ladder's route takes: every pass
    but the last flagged, the last where the route ends in the exact
    tier."""
    passes = sum(t != "exact" for t in route)
    return [True] * (passes - 1) + [route[-1] == "exact"] if passes else []
