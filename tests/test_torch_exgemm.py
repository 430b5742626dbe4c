"""ExGEMM in the PyTorch port held bit for bit against the JAX package:
the plain exact path and the plain slice path at several rungs against
``exgemm(..., impl="xla")`` (and the Fraction oracle at one tiny shape),
the preparation (anchors, spreads, digits, accumulator sizing) against the
JAX functions, the dispatcher's rung choice against a recomputation from
JAX's own analysis, the special override, invariance under a permutation
of k, the ``fpe == 1`` control and the device rules.  Tolerance is zero.
The JAX slice path (``impl="mxu"``) compiles every rung and is never
called here; the CUDA kernels are held against these plain versions on the
card by ``chip_smoke.py``."""

import contextlib
import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import exblas_tpu_torch as xt
from exblas_tpu.core.ieee import split_f64
from exblas_tpu_torch.core.f64ops import f64_mul
from exblas_tpu_torch.ops.exgemv import _scalar_bits
from exblas_tpu_torch.ops.kernels import gemm_mxu as tmxu
from exblas_tpu_torch.ops.kernels.gemm_kernel import gemm_bits_torch
from test_exgemm import oracle_gemm

E = importlib.import_module("exblas_tpu_torch.ops.exgemm")
jexgemm = importlib.import_module("exblas_tpu.ops.exgemm")

QNAN_PAYLOAD = np.array([0xFFF0000000000123], np.uint64).view(np.float64)[0]


def mat(m, n, lo, hi, seed, signed=True):
    """Doubles with uniform significands and exponents in [lo, hi)."""
    rs = np.random.RandomState(seed)
    x = (1.0 + rs.rand(m, n)) * np.exp2(rs.randint(lo, hi, size=(m, n)))
    if signed:
        x *= np.where(rs.rand(m, n) < 0.5, -1.0, 1.0)
    return x


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float64))


def _bits(x):
    return _t(x).view(torch.int64)


def u64(x):
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x).astype(np.int64).view(np.uint64)


def jax_bits(transa, transb, alpha, a, b, beta=1.0, c=None, **kw):
    return u64(np.asarray(jexgemm.exgemm_bits(transa, transb, alpha, a, b,
                                              beta=beta, c=c, impl="xla",
                                              **kw)
                          ).view(np.int64))


def port_bits(transa, transb, alpha, a, b, beta=1.0, c=None, **kw):
    return u64(xt.exgemm_bits(transa, transb, alpha, a, b, beta=beta, c=c,
                              device="cpu", **kw))


def beta_mode(beta, c):
    return "zero" if (beta == 0.0 or c is None) else (
        "one" if beta == 1.0 else "general")


def route_bits(route, alpha, a, b, beta=1.0, c=None):
    """One route of the plain path on op(A) = a, op(B) = b: "exact", or a
    rung (sa, sb) of the slice path (data must be covered, no specials)."""
    z = f64_mul(torch.tensor(_scalar_bits(alpha)), _bits(a))
    mode = beta_mode(beta, c)
    cb = _bits(c) if mode != "zero" else None
    if route == "exact":
        out = gemm_bits_torch(z, _bits(b), cb, _scalar_bits(beta), mode)
    else:
        out = tmxu.gemm_bits_mxu_torch(z, _bits(b), cb, _scalar_bits(beta),
                                       mode, *route)
    return u64(out)


def assert_bits(got, want, msg=""):
    same = got == want
    assert same.all(), (f"{msg}: {np.count_nonzero(~same)} differ, e.g. "
                        f"{got[~same][:3]} vs {want[~same][:3]}")


M, K, N = 5, 7, 9  # most JAX comparisons reuse one shape: few compiles


# --- the plain exact path and the public entry against JAX -----------------

@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (M, K, N), (16, 32, 8)])
def test_exgemm_matches_jax(m, k, n):
    a = mat(m, k, -30, 30, 1)
    b = mat(k, n, -30, 30, 2)
    c = mat(m, n, -30, 30, 3)
    want = jax_bits("N", "N", 1.0, a, b, 1.0, c)
    assert_bits(route_bits("exact", 1.0, a, b, 1.0, c), want, "exact")
    assert_bits(port_bits("N", "N", 1.0, a, b, 1.0, c), want, "public")


@pytest.mark.parametrize("alpha,beta,with_c", [
    (-2.5, 0.125, True), (1.0, 1.0, True), (3.0, 0.0, True),
    (1.0, 1.0, False)], ids=["general", "one", "zero", "no_c"])
def test_exgemm_scalars_match_jax(alpha, beta, with_c):
    a = mat(M, K, -20, 20, 4)
    b = mat(K, N, -20, 20, 5)
    c = mat(M, N, -20, 20, 6) if with_c else None
    want = jax_bits("N", "N", alpha, a, b, beta, c)
    assert_bits(route_bits("exact", alpha, a, b, beta, c), want, "exact")
    assert_bits(port_bits("N", "N", alpha, a, b, beta, c), want, "public")


@pytest.mark.parametrize("ta,tb", [("T", "T"), ("N", "T"), ("T", "N")])
def test_exgemm_transposes_match_jax(ta, tb):
    a = mat(M, K, -10, 10, 7)
    b = mat(K, N, -10, 10, 8)
    c = mat(M, N, -10, 10, 9)
    sa = a.T.copy() if ta == "T" else a
    sb = b.T.copy() if tb == "T" else b
    want = jax_bits("N", "N", 1.0, a, b, 1.0, c)
    assert_bits(port_bits(ta, tb, 1.0, sa, sb, 1.0, c), want, ta + tb)
    assert_bits(jax_bits(ta, tb, 1.0, sa, sb, 1.0, c), want, "jax " + ta + tb)


def test_exgemm_leading_dims_match_jax():
    a = mat(M, K, -10, 10, 10)
    b = mat(K, N, -10, 10, 11)
    c = mat(M, N, -10, 10, 12)

    def flat(x, ld):  # column-major with leading dimension ld, padded
        buf = np.full((x.shape[1], ld), 7.0)
        buf[:, :x.shape[0]] = x.T
        return buf.reshape(-1)

    kw = dict(m=M, n=N, k=K, lda=M + 3, ldb=K + 1, ldc=M + 2)
    args = (flat(a, M + 3), flat(b, K + 1))
    want = jax_bits("N", "N", 1.0, a, b, 1.0, c)
    assert_bits(port_bits("N", "N", 1.0, *args, 1.0, flat(c, M + 2), **kw),
                want, "ld")
    assert_bits(jax_bits("N", "N", 1.0, *args, 1.0, flat(c, M + 2), **kw),
                want, "jax ld")
    # a tensor buffer takes the same view
    got = xt.exgemm_bits("N", "N", 1.0, _t(args[0]), _t(args[1]), 1.0,
                         _t(flat(c, M + 2)), **kw)
    assert_bits(u64(got), want, "ld tensors")


def _special_case(kind):
    a = mat(M, K, -5, 5, 13)
    b = mat(K, N, -5, 5, 14)
    c = mat(M, N, -5, 5, 15)
    if kind == "nan_payload":
        a[1, 2] = QNAN_PAYLOAD
    elif kind == "inf":
        a[0, 0] = np.inf
        b[3, 4] = -np.inf
    elif kind == "inf_times_zero":
        a[2, 1] = np.inf
        b[1, :] = 0.0
    elif kind == "both_inf":
        a[3, 0] = np.inf
        a[3, 1] = np.inf
        b[0, 5] = 1.0
        b[1, 5] = -1.0
    elif kind == "c_specials":
        c[0, 0] = np.inf
        c[1, 1] = -np.inf
        c[2, 2] = QNAN_PAYLOAD
    return a, b, c


@pytest.mark.parametrize("kind", ["nan_payload", "inf", "inf_times_zero",
                                  "both_inf", "c_specials"])
@pytest.mark.parametrize("beta", [1.0, -0.75])
def test_exgemm_specials_match_jax(kind, beta):
    a, b, c = _special_case(kind)
    want = jax_bits("N", "N", 1.0, a, b, beta, c)
    assert_bits(route_bits("exact", 1.0, a, b, beta, c), want, "exact")
    # the public path: the slice route plus the special override
    got = _t(a).view(torch.int64)
    plan = E.plan_gemm(f64_mul(torch.tensor(_scalar_bits(1.0)), got),
                       _bits(b), _bits(c), _scalar_bits(beta),
                       beta_mode(beta, c))
    assert plan.rung == (8, 8) and plan.override
    assert_bits(port_bits("N", "N", 1.0, a, b, beta, c), want, "public")
    assert (want[np.isnan(np.asarray(want).view(np.float64))]
            == 0x7FF8000000000000).all()


def test_exgemm_underflow_and_exact_zero():
    # products far below 2^-1074 are kept exactly; a cancellation to an
    # exact zero gives +0.0
    a = mat(M, K, -600, -560, 16)
    b = mat(K, N, -600, -560, 17)
    c = np.zeros((M, N))
    c[0, 0] = 5e-324
    want = jax_bits("N", "N", 1.0, a, b, 1.0, c)
    # the rest underflow to zero, keeping the sign of the exact sum
    assert want[0, 0] == 1 and (want[1:] << np.uint64(1) == 0).all()
    assert_bits(route_bits("exact", 1.0, a, b, 1.0, c), want, "tiny exact")
    assert_bits(port_bits("N", "N", 1.0, a, b, 1.0, c), want, "tiny public")
    a2 = np.concatenate([a, -a], axis=1)
    b2 = np.concatenate([b, b], axis=0)
    got = port_bits("N", "N", 1.0, a2, b2, 0.0)
    assert (got == 0).all()  # +0.0, never -0.0
    assert (route_bits("exact", 1.0, a2, b2) == 0).all()


def test_exgemm_matches_oracle():
    a = mat(M, K, -40, 40, 18)
    b = mat(K, N, -40, 40, 19)
    c = mat(M, N, -40, 40, 20)
    want = u64(oracle_gemm(-1.5, a, b, 0.375, c).view(np.int64))
    assert_bits(port_bits("N", "N", -1.5, a, b, 0.375, c), want, "oracle")


# --- the plain slice path at several rungs ---------------------------------

RUNGS = [((8, 8), 10, 10), ((8, 12), 10, 40), ((12, 8), 40, 10),
         ((16, 16), 70, 70), ((40, 40), 250, 250)]


@pytest.mark.parametrize("rung,ra,rb", RUNGS,
                         ids=[f"{r[0][0]}x{r[0][1]}" for r in RUNGS])
@pytest.mark.parametrize("beta", [1.0, -0.75, 0.0])
def test_slice_rungs_match_jax(rung, ra, rb, beta):
    a = mat(M, K, -ra // 2, ra - ra // 2, 21)
    b = mat(K, N, -rb // 2, rb - rb // 2, 22)
    c = mat(M, N, -10, 10, 23)
    ea, fb, sp_a, sp_b, _ = tmxu.analyze_gemm_operands(_bits(a), _bits(b))
    assert sp_a <= 8 * rung[0] and sp_b <= 8 * rung[1]
    want = jax_bits("N", "N", 1.0, a, b, beta, c)
    assert_bits(route_bits(rung, 1.0, a, b, beta, c), want, str(rung))


def test_slice_negative_class0_sums():
    # every digit of A is a negative carry digit against positive B: the
    # class-0 sums are negative (the top-limb fault the TPU kernel had)
    rs = np.random.RandomState(20260820)
    a = -np.exp2(rs.randint(0, 3, size=(M, K))).astype(np.float64)
    b = np.exp2(rs.randint(0, 3, size=(K, N))).astype(np.float64)
    c = mat(M, N, -3, 3, 24)
    want = jax_bits("N", "N", 1.0, a, b, 1.0, c)
    for rung in ((8, 8), (12, 8), (16, 16)):
        assert_bits(route_bits(rung, 1.0, a, b, 1.0, c), want, str(rung))


# --- the preparation against the JAX functions ------------------------------

def _prep_inputs():
    # the dispatcher tests' shapes, so that JAX compiles its analysis once
    a = mat(M, K, -40, 40, 25)
    a[1, :] = 0.0                                    # all-zero row
    a[2, :3] = np.array([5e-324, -3e-320, 2.2e-308])  # subnormals
    a[3, 4] = 1e-310
    b = mat(K, N, -60, 10, 26)
    b[:, 2] = 0.0                                    # all-zero column
    b[5, 5] = -4e-322
    b[6, 6] = np.inf
    return a, b


def test_analyze_gemm_operands_matches_jax():
    from exblas_tpu.ops.kernels.gemm_mxu import analyze_gemm_operands

    a, b = _prep_inputs()
    A, B = split_f64(a), split_f64(b)
    want = analyze_gemm_operands(A.hi, A.lo, B.hi, B.lo)
    got = tmxu.analyze_gemm_operands(_bits(a), _bits(b))
    for g, w, name in zip(got, want, ("ea", "fb", "spread_a", "spread_b",
                                      "has_special")):
        assert np.array_equal(g.numpy(), np.asarray(w)), name


@pytest.mark.parametrize("n_slices", [1, 8, 12, 40])
def test_make_digits_matches_jax(n_slices):
    from exblas_tpu.ops.kernels.gemm_mxu import make_digits

    a, b = _prep_inputs()
    ea, fb, _, _, _ = tmxu.analyze_gemm_operands(_bits(a), _bits(b))
    ea0 = torch.where(ea < -9000, 0, ea)
    fb0 = torch.where(fb < -9000, 0, fb)
    for x, anc, axis in ((a, ea0, 0), (b, fb0, 1)):
        X = split_f64(x)
        want = np.asarray(make_digits(X.hi, X.lo, anc.numpy().astype(np.int32),
                                      n_slices, axis))
        got = tmxu.make_digits(_bits(x), anc, n_slices, axis)
        assert got.dtype == torch.int8
        assert np.array_equal(got.numpy(), want), (n_slices, axis)


def test_mxu_sizing_matches_jax():
    from exblas_tpu.ops.kernels import gemm_mxu as jmxu

    assert tmxu.MXU_BETA_HEAD == jmxu.MXU_BETA_HEAD
    for sa, sb in E._MXU_LADDER:
        assert tmxu._spill_run(sa, sb) == jmxu._spill_run(sa, sb)
        for mode in ("zero", "one", "general"):
            for k_pad in (32, 1024, 4096, 1 << 22):
                assert (tmxu.mxu_l_rel(sa, sb, mode, k_pad)
                        == jmxu.mxu_l_rel(sa, sb, mode, k_pad))
                # the kernel's accumulator holds every rung up to the k cap
                assert (tmxu.mxu_l_rel(sa, sb, mode, k_pad) + 3
                        <= tmxu.MAX_REL_LIMBS)


# --- the rungs of the wgmma class kernel (csrc/gemm_mxu.cu wgw) -----------

def test_wg_rungs_are_the_ladder_up_to_16():
    """Rungs (8, 12) to (16, 16) take the wgmma kernel, the wider ones keep
    the mma.sync one; the dispatcher climbs the kernels' ladder, and the C
    source's one table of instances (EXBLAS_WG_RUNGS) lists WG_RUNGS in
    order (gemm_mxu_attrs numbers the instances by it)."""
    assert E._MXU_LADDER is tmxu.MXU_LADDER
    assert tmxu.WG_RUNGS == ((8, 12), (12, 8), (8, 16), (16, 8), (12, 12),
                             (12, 16), (16, 12), (16, 16))
    src = (Path(tmxu.__file__).parent / "csrc" / "gemm_mxu.cu").read_text()
    table = re.search(r"#define EXBLAS_WG_RUNGS\(X\)((?:.*\\\n)*.*)",
                      src).group(1)
    rungs = re.findall(r"X\(\s*(\d+)\s*,\s*(\d+)\s*\)", table)
    assert tuple((int(a), int(b)) for a, b in rungs) == tmxu.WG_RUNGS


@pytest.mark.parametrize("rung", [(8, 8), (8, 12), (12, 16), (16, 16),
                                  (16, 20), (48, 48)])
def test_wrapper_routes_each_rung(rung, monkeypatch):
    """gemm_bits_mxu_cuda's class path by rung, its launches stubbed: wg88
    at (8, 8), the wgmma kernel at WG_RUNGS, mma.sync above (16, 16)."""
    taken = []
    for name in ("_gemm88_cuda", "_gemm_wide_cuda", "_gemm_classes_cuda"):
        monkeypatch.setattr(tmxu, name,
                            lambda *a, name=name: taken.append(name))
    monkeypatch.setattr(tmxu, "check_cuda_bits", lambda *a: None)
    monkeypatch.setattr(tmxu, "mxu_operands_cuda", tmxu.mxu_operands)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    z, b = _bits(mat(3, 4, 0, 9, 1)), _bits(mat(4, 2, 0, 9, 2))
    tmxu.gemm_bits_mxu_cuda(z, b, None, 0, "zero", *rung)
    want = ("_gemm88_cuda" if rung == (8, 8) else "_gemm_wide_cuda"
            if max(rung) <= 16 else "_gemm_classes_cuda")
    assert taken == [want]


@pytest.mark.parametrize("rung", tmxu.WG_RUNGS)
def test_wg_chunk_is_the_exact_chunk(rung, monkeypatch):
    """A launch covers the most k (a power of two) over which the int32
    class sums are exact: min(sa, sb) + 1 digit pairs of |d_s d_t| <= 2^14
    a k element; K_CHUNK shrinks it."""
    sa, sb = rung
    chunk = tmxu.wg_chunk(sa, sb)
    assert chunk == (4096 if rung == (16, 16) else 8192)
    assert chunk * (min(sa, sb) + 1) << 14 < 1 << 31
    assert 2 * chunk * (min(sa, sb) + 1) << 14 >= 1 << 31
    monkeypatch.setattr(tmxu, "K_CHUNK", 64)
    assert tmxu.wg_chunk(sa, sb) == 64


def test_wg_chunks(monkeypatch):
    assert tmxu.wg_chunks(16, 16, 4096) == [(0, 4096)]
    assert tmxu.wg_chunks(16, 16, 4096 + 32) == [(0, 4096), (4096, 32)]
    assert tmxu.wg_chunks(8, 12, 2 * 8192 + 64) == [(0, 8192), (8192, 8192),
                                                     (16384, 64)]
    monkeypatch.setattr(tmxu, "K_CHUNK", 64)
    assert tmxu.wg_chunks(12, 16, 160) == [(0, 64), (64, 64), (128, 32)]
    monkeypatch.setattr(tmxu, "K_CHUNK", 48)
    with pytest.raises(ValueError):
        tmxu.wg_chunks(16, 16, 96)


@pytest.mark.parametrize("rung", [(8, 8), *tmxu.WG_RUNGS])
def test_wg_words_hold_the_exact_value(rung):
    """An element's words (units of 2^(e_base - 8(sa+sb))) hold its largest
    exact value, MXU_K_CAP products below 2^e_base each and a beta*c up to
    MXU_BETA_HEAD bits above the anchor, with a sign bit; class 0's sum
    (relative bit 8(sa+sb), below 2^31) lands in them.  At (8, 8) they are
    wg88's three."""
    sa, sb = rung
    rel0, nw = 8 * (sa + sb), tmxu.wg_words(sa, sb)
    top = E.MXU_K_CAP * (1 << rel0) + (1 << (rel0 + tmxu.MXU_BETA_HEAD + 1))
    assert top < 1 << (64 * nw - 1)
    assert rel0 + 32 <= 64 * nw
    assert nw == {(8, 8): 3, (12, 16): 5, (16, 12): 5, (16, 16): 5}.get(
        rung, 4)


@pytest.mark.parametrize("chunk", [64, 8192])
def test_wide_wrapper_launches_and_words(chunk, monkeypatch):
    """_gemm_wide_cuda's launches at rung (16, 16), the C entry stubbed:
    one a chunk, first and last flagged, the words buffer (wg_words, m, n)
    int64 only where k spans more than one chunk, shared by the launches;
    wg_launches counts them."""
    calls, shapes = [], []

    class Lib:
        def mxu_gemm_wide_cuda(self, *args):
            calls.append(args)
            return 0

    empty = torch.empty

    def recording_empty(shape, **kw):
        shapes.append((tuple(shape), kw.get("dtype")))
        return empty(shape, **kw)

    monkeypatch.setattr(tmxu, "K_CHUNK", chunk)
    monkeypatch.setattr(tmxu._build, "library", Lib)
    monkeypatch.setattr(tmxu, "stream_of", lambda d: None)
    m, k, n = 3, 100, 5
    ops = tmxu.mxu_operands(_bits(mat(m, k, 0, 9, 3)),
                            _bits(mat(k, n, 0, 9, 4)), 16, 16)
    out = torch.empty((m, n), dtype=torch.int64)
    before = tmxu.gemm_bits_mxu_cuda.wg_launches
    monkeypatch.setattr(torch, "empty", recording_empty)
    tmxu._gemm_wide_cuda(ops, None, 0, 0, out)
    k_pad = ops.ad.shape[2]
    want = tmxu.wg_chunks(16, 16, k_pad)
    assert [(a[7], a[8]) for a in calls] == want
    assert [(a[17], a[18]) for a in calls] == [
        (int(i == 0), int(i == len(want) - 1)) for i in range(len(want))]
    assert all(a[2:4] == (16, 16) for a in calls)
    assert tmxu.gemm_bits_mxu_cuda.wg_launches - before == len(want)
    if len(want) > 1:
        assert shapes == [((5, m, n), torch.int64)]
        assert len({a[16].value for a in calls}) == 1
    else:
        assert shapes == [] and calls[0][16] is None


# --- the dispatcher ---------------------------------------------------------

def _jax_rung(a, b, c, beta):
    """The rung JAX's _gemm_bits_auto would pick, from its own analysis."""
    import jax.numpy as jnp
    from exblas_tpu.ops.exgemm import _MXU_LADDER, _mxu_c_cover
    from exblas_tpu.ops.exgemv import _scalar_bits as jscalar
    from exblas_tpu.ops.kernels.gemm_mxu import analyze_gemm_operands

    A, B = split_f64(a), split_f64(b)
    ea, fb, sp_a, sp_b, _ = analyze_gemm_operands(A.hi, A.lo, B.hi, B.lo)
    ea0 = jnp.where(ea < -9000, 0, ea)
    fb0 = jnp.where(fb < -9000, 0, fb)
    C = split_f64(c)
    bh, bl = jscalar(beta)
    for sa, sb in _MXU_LADDER:
        ok = int(sp_a) <= 8 * sa and int(sp_b) <= 8 * sb
        if beta_mode(beta, c) != "zero":
            ok = ok and bool(_mxu_c_cover(C.hi, C.lo, bh, bl, ea0, fb0,
                                          sa, sb))
        if ok:
            return (sa, sb)
    return None


DISPATCH = {
    "narrow": lambda: (mat(M, K, 0, 10, 27), mat(K, N, 0, 10, 28),
                       mat(M, N, 0, 10, 29), 1.0),
    "mixed": lambda: (mat(M, K, 0, 10, 27), mat(K, N, -20, 20, 28),
                      mat(M, N, 0, 10, 29), 1.0),
    "wide": lambda: (mat(M, K, -100, 100, 30), mat(K, N, -90, 90, 31),
                     mat(M, N, 0, 10, 32), -0.75),
    "uncovered": lambda: (mat(M, K, -300, 300, 33), mat(K, N, -10, 10, 34),
                          mat(M, N, 0, 10, 35), 1.0),
    "c_head_in": lambda: (np.ones((M, K)), np.ones((K, N)),
                          np.full((M, N), 2.0 ** 36), 1.0),
    "c_head_out": lambda: (np.ones((M, K)), np.ones((K, N)),
                           np.full((M, N), 2.0 ** 37), 1.0),
    "c_low": lambda: (np.ones((M, K)), np.ones((K, N)),
                      np.full((M, N), 2.0 ** -130), 1.0),
    "zero_rows": lambda: (np.vstack([np.zeros((1, K)), mat(M - 1, K, 0, 5,
                                                             36)]),
                          mat(K, N, 0, 5, 37), mat(M, N, 40, 45, 38), 0.5),
}


@pytest.mark.parametrize("case", list(DISPATCH))
def test_dispatcher_rung_matches_jax(case):
    a, b, c, beta = DISPATCH[case]()
    want_rung = _jax_rung(a, b, c, beta)
    plan = E.plan_gemm(_bits(a), _bits(b), _bits(c), _scalar_bits(beta),
                       beta_mode(beta, c))
    assert plan.rung == want_rung
    expected = {"narrow": (8, 8), "mixed": (8, 12), "uncovered": None,
                "c_head_in": (8, 8), "c_head_out": None, "c_low": (16, 16)}
    if case in expected:
        assert want_rung == expected[case]
    assert_bits(port_bits("N", "N", 1.0, a, b, beta, c),
                jax_bits("N", "N", 1.0, a, b, beta, c), case)


def test_dispatcher_k_cap_routes_exact(monkeypatch):
    a, b, c, beta = DISPATCH["narrow"]()
    plan = E.plan_gemm(_bits(a), _bits(b), _bits(c), _scalar_bits(beta),
                       "one")
    assert plan.rung == (8, 8)
    monkeypatch.setattr(E, "MXU_K_CAP", K - 1)
    plan = E.plan_gemm(_bits(a), _bits(b), _bits(c), _scalar_bits(beta),
                       "one")
    assert plan.rung is None
    assert_bits(port_bits("N", "N", 1.0, a, b, beta, c),
                jax_bits("N", "N", 1.0, a, b, beta, c), "k cap")


def test_beta_c_special_flags_match_jax():
    from exblas_tpu.ops.exgemm import _beta_c_special_flags
    from exblas_tpu.ops.exgemv import _scalar_bits as jscalar

    c = np.array([[0.0, -0.0, 1.5, -2.0], [np.inf, -np.inf, QNAN_PAYLOAD,
                                            5e-324]])
    C = split_f64(c)
    for beta in (1.0, -0.75, 0.0, -0.0, np.inf, -np.inf, np.nan):
        want = _beta_c_special_flags(C.hi, C.lo, *jscalar(beta))
        got = E._beta_c_special_flags(_bits(c), _scalar_bits(beta))
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w)), beta


def test_special_masks_match_jax():
    from exblas_tpu.ops.exgemm import _special_masks_matmul

    for kind in ("nan_payload", "inf", "inf_times_zero", "both_inf"):
        a, b, _ = _special_case(kind)
        A, B = split_f64(a), split_f64(b)
        want = _special_masks_matmul(A.hi, A.lo, B.hi, B.lo)
        got = E._special_masks_matmul(_bits(a), _bits(b))
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w)), kind


def test_exgemm_k_permutation_invariance():
    a = mat(M, 64, -30, 30, 39)
    b = mat(64, N, -30, 30, 40)
    ref = port_bits("N", "N", 1.0, a, b, 0.0)
    for seed in (41, 42):
        p = np.random.RandomState(seed).permutation(64)
        assert_bits(port_bits("N", "N", 1.0, a[:, p], b[p, :], 0.0), ref,
                    "perm")
        assert_bits(route_bits("exact", 1.0, a[:, p], b[p, :]), ref, "exact")


# --- fpe, the control and the device rules ----------------------------------

def test_exgemm_fpe1_control_and_validation():
    a = mat(M, K, -3, 3, 43)
    b = mat(K, N, -3, 3, 44)
    c = mat(M, N, -3, 3, 45)
    got = xt.exgemm("N", "N", 2.0, _t(a), _t(b), beta=0.5, c=_t(c), fpe=1)
    np.testing.assert_allclose(got.numpy(), 0.5 * c + (2.0 * a) @ b,
                               rtol=1e-13, atol=1e-13)
    with pytest.raises(ValueError, match="fpe"):
        xt.exgemm("N", "N", 1.0, _t(a), _t(b), fpe=9)
    with pytest.raises(ValueError, match="inner dims"):
        xt.exgemm("N", "N", 1.0, _t(a), _t(b.T))


def test_exgemm_device_rules(monkeypatch):
    a = mat(M, K, -3, 3, 46)
    b = mat(K, N, -3, 3, 47)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        xt.exgemm("N", "N", 1.0, a, b)
    want = port_bits("N", "N", 1.0, a, b, 0.0)
    got = xt.exgemm("N", "N", 1.0, _t(a), _t(b))
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    assert_bits(u64(got.view(torch.int64)), want, "cpu tensors")
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        xt.exgemm("N", "N", 1.0, _t(a), _t(b), impl="cuda")


def test_gemm_cuda_wrappers_refuse_cpu_tensors():
    from exblas_tpu_torch.ops.kernels import gemm_kernel

    z, b = _bits(mat(2, 3, 0, 2, 48)), _bits(mat(3, 2, 0, 2, 49))
    before = (gemm_kernel.gemm_bits_cuda.launches,
              tmxu.gemm_bits_mxu_cuda.launches)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        gemm_kernel.gemm_bits_cuda(z, b, None, 0, "zero")
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tmxu.gemm_bits_mxu_cuda(z, b, None, 0, "zero", 8, 8)
    assert before == (gemm_kernel.gemm_bits_cuda.launches,
                      tmxu.gemm_bits_mxu_cuda.launches)


# --- empty m, n or k (ROADMAP queue C, C3) ---------------------------------

C3_SHAPES = {"k0": (5, 0, 3), "m0": (0, 4, 3), "n0": (5, 4, 0)}


@pytest.mark.parametrize("with_c", [True, False], ids=["c", "no_c"])
@pytest.mark.parametrize("beta", [0.0, 1.0, 2.0, np.inf])
@pytest.mark.parametrize("shape", list(C3_SHAPES))
def test_exgemm_empty_dims_match_jax(shape, beta, with_c):
    """An empty m, n or k gives JAX ``impl="xla"``'s result: the rounded
    beta*C (zeros without C), or an empty (0, n) or (m, 0) array; the
    plan takes the exact route, which needs no operand analysis."""
    m, k, n = C3_SHAPES[shape]
    a, b = np.zeros((m, k)), np.zeros((k, n))
    c = np.arange(15.0).reshape(5, 3)[:m, :n] - 4.0 if with_c else None
    want = jax_bits("N", "N", 1.0, a, b, beta, c)
    got = port_bits("N", "N", 1.0, a, b, beta, c)
    assert got.shape == want.shape == (m, n)
    assert_bits(got, want, f"{shape} beta={beta}")
    assert xt.exgemm("N", "N", 1.0, a, b, beta, c,
                     device="cpu").shape == (m, n)
    z = torch.zeros((m, k), dtype=torch.int64)
    assert E.plan_gemm(z, torch.zeros((k, n), dtype=torch.int64), None, 0,
                       "zero").rung is None


def test_exgemm_k0_known_values():
    """The values of the fault report: 2*C with C, zeros without."""
    c = np.arange(15.0).reshape(5, 3)
    got = xt.exgemm("N", "N", 1.0, np.zeros((5, 0)), np.zeros((0, 3)), 2.0,
                    c, device="cpu")
    np.testing.assert_array_equal(got.numpy(), 2 * c)
    got = xt.exgemm("N", "N", 1.0, np.zeros((5, 0)), np.zeros((0, 3)), 2.0,
                    None, device="cpu")
    assert got.shape == (5, 3) and (got.view(torch.int64) == 0).all()
