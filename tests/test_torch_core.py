"""The PyTorch port's core layer (``exblas_tpu_torch.core``, generators)
held bit for bit against the JAX package's: formats, decoding, deposits,
carry passes, canonical digits, rounding, status and serialization.
Tolerance is zero."""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

import exblas_tpu as xb
import exblas_tpu_torch as xt
from exblas_tpu.core import accumulator as jacc
from exblas_tpu.core import deposit as jdep
from exblas_tpu.core import rounding as jround
from exblas_tpu.core import serialization as jser
from exblas_tpu.core import status as jstatus
from exblas_tpu.core.ieee import split_f64
from exblas_tpu.core.types import DOT_FORMAT as JDOT_FORMAT
from exblas_tpu.core.types import Superacc as JSuperacc
from exblas_tpu_torch.core import accumulator as tacc
from exblas_tpu_torch.core import deposit as tdep
from exblas_tpu_torch.core import rounding as tround
from exblas_tpu_torch.core import serialization as tser
from exblas_tpu_torch.core import status as tstatus
from exblas_tpu_torch.core.ieee import decode_fields, f64_bits
from exblas_tpu_torch.core.types import (DOT_FORMAT, LIMB_BITS, SUM_FORMAT,
                                         Superacc)
from oracle import exact_dot, exact_sum
from torch_parity import (assert_same_state, jax_state, port_state, u64)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EDGES = np.array([
    0.0, -0.0, 5e-324, -5e-324, 3e-320, 2.2250738585072009e-308,
    2.2250738585072014e-308, -1.0, 1.0, 1.5, 2.0 ** -1022, 2.0 ** 1023,
    1.7976931348623157e308, -1.7976931348623157e308, np.inf, -np.inf,
    np.nan, -np.nan, 1e-310, -2.5e-310, 3.141592653589793, 1e300, -1e-300,
])


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float64))


def test_import_has_no_jax():
    """Importing the port pulls in neither JAX nor the JAX package and
    changes no global torch setting."""
    code = ("import sys, torch, exblas_tpu_torch\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('jax', 'jaxlib', 'exblas_tpu')]\n"
            "assert not bad, bad\n"
            "assert torch.get_default_dtype() == torch.float32\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


GENERATORS = [
    ("rand_double", lambda g: g.rand_double(np.random.RandomState(3), -40,
                                            40, 3, size=257)),
    ("fpuniform", lambda g: g.init_fpuniform(1001, 300, -150, seed=4)),
    ("fpuniform_matrix", lambda g: g.init_fpuniform_matrix(7, 9, 20, 0,
                                                           seed=5)),
    ("fpuniform_tr", lambda g: g.init_fpuniform_tr_matrix("U", "U", 9, 20,
                                                          5, seed=6)),
    ("lognormal", lambda g: g.init_lognormal(999, 0.0, 2.0, seed=7)),
    ("lognormal_matrix", lambda g: g.init_lognormal_matrix(5, 6, 1.0, 0.5,
                                                           seed=8)),
    ("lognormal_tr", lambda g: g.init_lognormal_tr_matrix("L", "N", 8,
                                                          seed=9)),
    ("ill_cond", lambda g: g.init_ill_cond(1001, 1e30, seed=10)),
    ("naive", lambda g: g.init_naive(33)),
]


@pytest.mark.parametrize("name,draw", GENERATORS,
                         ids=[g[0] for g in GENERATORS])
def test_generators_match_jax(name, draw):
    from exblas_tpu.utils import generators as jgen
    from exblas_tpu_torch.utils import generators as tgen

    got, want = draw(tgen), draw(jgen)
    assert got.dtype == want.dtype and np.array_equal(got, want,
                                                      equal_nan=True), name


def test_decode_fields_match_jax():
    b = split_f64(EDGES)
    js, je, jhi, jlo = (np.asarray(v).astype(np.int64)
                        for v in jdep.decode_fields(b.hi, b.lo))
    ts, te, tm = (v.numpy() for v in decode_fields(f64_bits(_t(EDGES))))
    assert np.array_equal(ts, js)
    assert np.array_equal(te, je)
    assert np.array_equal(tm, (jhi << 32) | jlo)


def _mixed(n=600, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.uniform(-1, 1, n) * np.exp2(rs.randint(-1074, 1024, n))
    return np.concatenate([x, EDGES])


def test_sum_terms_match_jax():
    x = _mixed()
    b = split_f64(x)
    j = jdep.sum_terms(b.hi, b.lo, SUM_FORMAT.offset_bits)
    t = tdep.sum_terms(f64_bits(_t(x)), SUM_FORMAT.offset_bits)
    for key in ("q", "nan", "pinf", "ninf", "valid"):
        assert np.array_equal(t[key].numpy(), np.asarray(j[key])), key
    for k in range(4):
        assert np.array_equal(t["pieces"][k].numpy(),
                              np.asarray(j["pieces"][k])), k


def test_product_terms_match_jax():
    a, c = _mixed(seed=1), _mixed(seed=2)[::-1].copy()
    ba, bc = split_f64(a), split_f64(c)
    j = jdep.product_terms(ba.hi, ba.lo, bc.hi, bc.lo, DOT_FORMAT.offset_bits)
    t = tdep.product_terms(f64_bits(_t(a)), f64_bits(_t(c)),
                           DOT_FORMAT.offset_bits)
    for key in ("q", "r", "s", "nan", "pinf", "ninf", "valid"):
        assert np.array_equal(t[key].numpy(), np.asarray(j[key])), key
    for k in range(7):
        assert np.array_equal(t["classes"][k].numpy(),
                              np.asarray(j["classes"][k])), k


def test_split_value30_matches_jax():
    rs = np.random.RandomState(3)
    c = rs.randint(0, 1 << 30, 500)
    r = rs.randint(0, 20, 500)
    j = jdep.split_value30(c.astype(np.uint32), r.astype(np.uint32))
    t = tdep.split_value30(torch.from_numpy(c), torch.from_numpy(r))
    for jp, tp in zip(j, t):
        assert np.array_equal(tp.numpy(), np.asarray(jp).astype(np.int64))


def test_mant_pieces14_matches_jax():
    b = split_f64(_mixed(seed=4))
    _, _, hi, lo = jdep.decode_fields(b.hi, b.lo)
    _, _, mant = decode_fields(f64_bits(_t(_mixed(seed=4))))
    for jp, tp in zip(jdep.mant_pieces14(hi, lo), tdep.mant_pieces14(mant)):
        assert np.array_equal(tp.numpy(), np.asarray(jp).astype(np.int64))


# --- limb states: exact integers with interesting rounding ----------------

def _limbs_from_int(v: int, n_limbs: int, rs) -> np.ndarray:
    """Redundant int32 limbs of the exact integer v: canonical digits of
    v mod 2^(20L), the sign parked in the top limb, then random
    value-preserving carries moved between neighbours."""
    m = v % (1 << (LIMB_BITS * n_limbs))
    limbs = np.array([(m >> (LIMB_BITS * j)) & 0xFFFFF
                      for j in range(n_limbs)], np.int64)
    if v < 0:
        limbs[-1] -= 1 << LIMB_BITS
    for j in rs.randint(0, n_limbs - 1, 6):
        c = int(rs.randint(-3, 4))
        limbs[j] += c << LIMB_BITS
        limbs[j + 1] -= c
    return limbs.astype(np.int32)


def _interesting_ints(fmt, rs):
    off = fmt.offset_bits
    ulp_max = 1 << (off + 971)
    vals = [0, 1, -1, 2, 3, (1 << 60) + 1, -(1 << 200) - 5]
    # exact doubles, ties to even both ways, and near-ties with sticky bits
    for e in (-1074, -1060, -1023, -1022, -1000, -1, 0, 52, 500, 969):
        k = off + e  # bit of 2^e
        if k < 1:
            continue
        m = int(rs.randint(1 << 52, 1 << 53))
        for mm in (m | 1, m & ~1):
            exact = mm << k
            half = 1 << (k - 1)
            vals += [exact, exact + half, exact - half, exact + half + 1,
                     -(exact + half)]
    # subnormal and underflow boundaries: 2^-1075 rounds to 0 (tie to even),
    # 3 * 2^-1076 rounds to 2^-1074; DOT_FORMAT reaches further down
    if off >= 1076:
        vals += [1 << (off - 1075), 3 << (off - 1076), (1 << (off - 1075)) + 1]
    # overflow boundary 2^1024 - 2^970 (rounds to Inf), and just below
    ovf = (1 << (off + 1024)) - (1 << (off + 970))
    vals += [ovf, ovf - 1, -ovf, -(ovf - 1), ulp_max * ((1 << 53) - 1),
             1 << (off + 1030)]
    for _ in range(30):
        top = int(rs.randint(0, fmt.n_limbs * LIMB_BITS - 70))
        v = int(rs.randint(1, 1 << 62)) << top
        v += int(rs.randint(0, 1 << 40)) << max(top - 50, 0)
        vals.append(v if rs.rand() < 0.5 else -v)
    return vals


def _batch(fmt, seed):
    rs = np.random.RandomState(seed)
    vals = _interesting_ints(fmt, rs)
    limbs = np.stack([_limbs_from_int(v, fmt.n_limbs, rs) for v in vals])
    special = np.zeros((len(vals), 3), np.int32)
    special[-6:] = [[1, 0, 0], [0, 1, 0], [0, 0, 2], [0, 3, 1], [2, 1, 1],
                    [0, 0, 0]]
    return limbs, special


@pytest.mark.parametrize("fmt", [SUM_FORMAT, DOT_FORMAT],
                         ids=["sum", "dot"])
def test_rounding_matches_jax(fmt):
    limbs, special = _batch(fmt, seed=fmt.n_limbs)
    jbits = np.asarray(jround.round_superacc_to_f64_bits(
        JSuperacc(limbs=limbs, special=special, fmt=fmt)))
    tbits = tround.round_superacc_to_f64_bits(
        Superacc(torch.from_numpy(limbs), torch.from_numpy(special), fmt))
    got = tbits.numpy().view(np.uint64)
    bad = np.nonzero(got != jbits)[0]
    assert bad.size == 0, [(int(i), hex(got[i]), hex(jbits[i]))
                           for i in bad[:5]]


@pytest.mark.parametrize("fmt", [SUM_FORMAT, DOT_FORMAT],
                         ids=["sum", "dot"])
def test_canonical_digits_match_jax(fmt):
    limbs, _ = _batch(fmt, seed=fmt.n_limbs + 1)
    jd, jn = jround.canonicalize_digits(limbs)
    td, tn = tround.canonicalize_digits(torch.from_numpy(limbs))
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert np.array_equal(tn.numpy(), np.asarray(jn))
    jneg = np.asarray(jround.negate_digits(np.asarray(jd)))
    assert np.array_equal(tround.negate_digits(td).numpy(), jneg)


def test_rounding_is_correct_vs_oracle():
    """The port's rounding of exact integers V against Fraction-exact
    rounding of V * 2^-1074 (tests/oracle.py)."""
    from fractions import Fraction
    from oracle import _round_fraction

    rs = np.random.RandomState(11)
    vals = _interesting_ints(SUM_FORMAT, rs)
    limbs = np.stack([_limbs_from_int(v, SUM_FORMAT.n_limbs, rs)
                      for v in vals])
    bits = tround.round_superacc_to_f64_bits(
        Superacc(torch.from_numpy(limbs), torch.zeros(len(vals), 3,
                                                      dtype=torch.int32),
                 SUM_FORMAT)).numpy()
    for v, b in zip(vals, bits):
        want = np.float64(_round_fraction(Fraction(v, 1 << 1074)))
        assert int(b) & ((1 << 64) - 1) == u64(want.view(np.uint64)), v


def test_status_matches_jax():
    rs = np.random.RandomState(5)
    vals = [0, 1 << 1074, (1 << 1074) + 1, 3,
            (1 << 2098) - (1 << 2044), -(1 << 2099), -(5 << 1000), 7]
    limbs = np.stack([_limbs_from_int(v, SUM_FORMAT.n_limbs, rs)
                      for v in vals])
    special = np.zeros((len(vals), 3), np.int32)
    special[-3:] = [[0, 1, 0], [0, 0, 1], [1, 0, 0]]
    j = np.asarray(jstatus.status_of(JSuperacc(limbs, special, SUM_FORMAT)))
    t = tstatus.status_of(Superacc(torch.from_numpy(limbs),
                                   torch.from_numpy(special), SUM_FORMAT))
    assert np.array_equal(t.numpy(), j), (t, j)
    assert set(t.tolist()) >= {0, 1, 2, 3, 4, 5}


def test_renorm_keeps_top_limb_whole():
    """Top-limb carry strip (ROADMAP queue C): a parked negative value must
    survive any number of carry passes, exactly as in the JAX package."""
    limbs = np.zeros(SUM_FORMAT.n_limbs, np.int64)
    limbs[:3] = [5, (1 << 20) - 1, 7]
    limbs[-1] = -1  # value: small positive digits - 2^(20*111)
    x = torch.from_numpy(limbs.copy())
    jx = limbs.copy()
    for _ in range(SUM_FORMAT.n_limbs + 2):
        x = tacc.renorm_pass(x)
        jx = np.asarray(jacc.renorm_pass(jx))
        assert np.array_equal(x.numpy(), jx)
    d, neg = tround.canonicalize_digits(x)
    d0, neg0 = tround.canonicalize_digits(torch.from_numpy(limbs))
    assert bool(neg) and bool(neg0) and torch.equal(d, d0)


def test_to_int32_limbs_and_merge_match_jax():
    rs = np.random.RandomState(6)
    wide = rs.randint(-(1 << 40), 1 << 40, (5, SUM_FORMAT.n_limbs))
    assert np.array_equal(tacc.to_int32_limbs(torch.from_numpy(wide)).numpy(),
                          np.asarray(jacc.to_int32_limbs(wide)))
    limbs = rs.randint(-(1 << 22), 1 << 22, (5, SUM_FORMAT.n_limbs))
    special = rs.randint(0, 3, (5, 3))
    jm = jacc.merge(JSuperacc(limbs.astype(np.int32),
                              special.astype(np.int32), SUM_FORMAT))
    tm = tacc.merge(Superacc(torch.from_numpy(limbs).to(torch.int32),
                             torch.from_numpy(special).to(torch.int32),
                             SUM_FORMAT))
    assert np.array_equal(tm.limbs.numpy(), np.asarray(jm.limbs))
    assert np.array_equal(tm.special.numpy(), np.asarray(jm.special))


def test_dump_matches_jax():
    x = np.array([1.5, -0.25, np.inf, 3e-320])
    j = xb.exsum_acc(x, impl="xla")
    t = xt.exsum_acc(_t(x))
    assert t.dump() == j.dump()
    assert "superacc[112x20b" in t.dump() and "+inf=1" in t.dump()


def test_state_interop_jax_to_port():
    """A JAX accumulator saved with save_superacc loads in the port, merges
    with a port accumulator and rounds to the bits of the whole sum."""
    x = xb.init_ill_cond(3000, 1e28, seed=31)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "jax.npz")
        jser.save_superacc(path, xb.exsum_acc(x[:1234], impl="xla"))
        restored = tser.load_superacc(path)
    assert restored.fmt == SUM_FORMAT
    total = restored + xt.exsum_acc(_t(x[1234:]))
    got = tround.round_superacc_to_f64_bits(total)
    assert u64(got) == u64(np.float64(exact_sum(x)).view(np.uint64))


def test_state_interop_port_to_jax():
    a = xt.init_fpuniform(2000, 60, -20, seed=32)
    b = xt.init_lognormal(2000, 0.0, 2.0, seed=33)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "port.npz")
        tser.save_superacc(path, xt.exdot_acc(_t(a[:1000]), _t(b[:1000])))
        restored = jser.load_superacc(path)
    assert restored.fmt == JDOT_FORMAT
    total = restored + xb.exdot_acc(a[1000:], b[1000:], impl="xla")
    got = np.asarray(jround.round_superacc_to_f64_bits(total))
    assert u64(got) == u64(np.float64(exact_dot(a, b)).view(np.uint64))
    # and both packages agree on the merged exact state
    port_total = tser.superacc_from_arrays(jser.superacc_to_arrays(total))
    assert_same_state(port_state(port_total), jax_state(total), "merged")


def test_missing_nvcc_raises(monkeypatch):
    from exblas_tpu_torch.ops.kernels import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_failed_build_raises(tmp_path):
    from exblas_tpu_torch.ops.kernels import _build

    src = tmp_path / "k.cu"
    src.write_text("this is not C++\n")
    out = tmp_path / "libk.so"
    with pytest.raises(RuntimeError, match="build failed"):
        _build.compile_library(
            out, [src], lambda o: [sys.executable, "-c",
                                   "raise SystemExit('compile error')"])
    assert not out.exists()


# --- f64ops: correctly rounded multiply and divide on bit patterns ---------

def _f64ops_pairs():
    """Every pair of EDGES plus random pairs whose products and quotients
    land in the subnormal range, overflow, or cancel signs; NaNs with
    payloads and signs among them."""
    payloads = np.array([0x7FF0000000000001, 0xFFF8000000000ABC,
                         0x7FF4000000000000], np.uint64).view(np.float64)
    edges = np.concatenate([EDGES, payloads])
    a, b = (x.reshape(-1) for x in np.meshgrid(edges, edges))
    rs = np.random.RandomState(51)
    n = 2000
    ra = (1 + rs.rand(n)) * np.exp2(rs.randint(-1074, 1024, n).astype(float))
    rb = (1 + rs.rand(n)) * np.exp2(rs.randint(-1074, 1024, n).astype(float))
    sign = np.where(rs.rand(n) < 0.5, -1.0, 1.0)
    return np.concatenate([a, ra * sign]), np.concatenate([b, rb])


@pytest.mark.parametrize("name", ["f64_mul", "f64_div", "f64_div_pair"])
def test_f64ops_match_jax(name):
    from exblas_tpu.core import f64ops as jops
    from exblas_tpu_torch.core import f64ops as tops

    a, b = _f64ops_pairs()
    A, B = split_f64(a), split_f64(b)
    with np.errstate(all="ignore"):
        native = a * b if name == "f64_mul" else a / b
    assert (native[np.isfinite(native)] != 0).any()
    assert (np.abs(native[np.isfinite(native)]) < 2.2250738585072014e-308
            ).any()  # subnormal results occur
    got = getattr(tops, name)(f64_bits(_t(a)), f64_bits(_t(b)))
    want = getattr(jops, name)(A.hi, A.lo, B.hi, B.lo)
    if name == "f64_div_pair":
        got_bits = (got[0].numpy().astype(np.uint64) << np.uint64(32)) | \
            got[1].numpy().astype(np.uint64)
        want = (np.asarray(want[0]).astype(np.uint64) << np.uint64(32)) | \
            np.asarray(want[1]).astype(np.uint64)
    else:
        got_bits = got.numpy().view(np.uint64)
        want = np.asarray(want).astype(np.uint64)
    bad = np.nonzero(got_bits != want)[0]
    assert bad.size == 0, (f"{name}: {bad.size} differ, e.g. "
                           f"{a[bad[:3]]} {b[bad[:3]]}")
    # NaN results are the canonical quiet NaN
    nan = np.isnan(got_bits.view(np.float64))
    assert nan.any() and (got_bits[nan] == 0x7FF8000000000000).all()
