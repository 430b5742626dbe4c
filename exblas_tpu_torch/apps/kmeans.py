"""Reproducible k-means (Rodinia kmeans analog).

The reference swaps the per-(cluster, feature) center update for exsum over
the gathered member features (reference kmeans_clustering.cpp:203-223);
membership assignment stays plain floating point (order-insensitive).

Port of ``exblas_tpu/apps/kmeans.py``.  The host path (``kmeans``,
``kmeans_experiment``) assigns in numpy float64 and updates the centers
with ``exsum_segmented``; the device path (``kmeans_step_device``,
``kmeans_device``) keeps the whole iteration on the card.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..core.f64ops import f64_div
from ..core.ieee import f64_bits
from ..ops.exsum import (as_f64, exsum_segmented, exsum_segmented_bits,
                         target_device)


def _assign(points, centers):
    d = ((points[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    return np.argmin(d, axis=1)


# ---------------------------------------------------------------------------
# Fully device-resident iteration (assignment matmul + exact update)
# ---------------------------------------------------------------------------
#
# One iteration: membership assignment as a float32 matmul (|x|^2 -
# 2 x.C^T + |c|^2), the center update as exact segmented limb deposits +
# one correctly rounded division, so the centers remain BIT-reproducible
# under any shuffle of the points while the whole loop stays on the device
# (the reference's kmeans assignment is plain float too,
# kmeans_clustering.cpp:180-201).  The JAX package passes float64 as
# uint32 bit pairs because the TPU has no float64; the port takes float64
# tensors (or their int64 bit patterns).

def _f32_from_bits(bits):
    """Truncating f64 -> f32 conversion from int64 binary64 patterns, as
    the JAX package's ``_f32_from_bits`` does it (not round to nearest):
    the significand's top 23 bits are kept; a rebiased exponent <= 0, a
    zero or a subnormal gives a signed zero, one >= 255 gives +-inf, and
    an exponent field of 0x7FF (infinities included) gives a NaN.

    Only used for the distance/argmin assignment step, which tolerates
    rounding."""
    sign = ((bits >> 63) & 1) << 31
    expf = (bits >> 52) & 0x7FF
    e32 = expf - 1023 + 127
    mant23 = (bits >> 29) & 0x7FFFFF
    f32 = sign | (e32.clamp(0, 254) << 23) | mant23
    f32 = torch.where(e32 >= 255, sign | 0x7F800000, f32)
    f32 = torch.where((e32 <= 0) | (expf == 0), sign, f32)
    f32 = torch.where(expf == 0x7FF, sign | 0x7FC00000, f32)
    # the 32-bit pattern as a signed int32, then viewed as float32
    f32 = torch.where(f32 >= 1 << 31, f32 - (1 << 32), f32)
    return f32.to(torch.int32).view(torch.float32)


@contextlib.contextmanager
def _full_f32_matmul():
    """float32 products in full float32 (no TF32) inside.  At PyTorch's
    default precision ("highest") nothing is touched.  Where the caller
    chose "high" or "medium", the precision, which PyTorch keeps per
    process, is "highest" for the whole process for the duration of the
    block and the caller's setting is restored after: a thread that
    changes or relies on it meanwhile races with the block."""
    saved = torch.get_float32_matmul_precision()
    if saved == "highest":
        yield
        return
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


def _as_bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous() if x.dtype == torch.int64 else f64_bits(x)


def kmeans_step_device(points, centers, k: int):
    """One reproducible k-means iteration on the tensors' device.

    points (n, nf), centers (k, nf): float64 tensors or their int64 bit
    patterns.  Returns (new centers float64 (k, nf), membership int64
    (n,)).  Centers are exact segmented sums divided by counts with one
    correctly rounded float64 division each -- bit-identical under any
    permutation of the points; an empty cluster gives +0.  The distances
    are float32 products without TF32 (see :func:`_full_f32_matmul` for
    the process-wide precision setting).
    """
    pb, cb = _as_bits(points), _as_bits(centers)
    n, nf = pb.shape
    p32 = _f32_from_bits(pb)
    c32 = _f32_from_bits(cb)
    with _full_f32_matmul():
        d = ((p32 * p32).sum(1, keepdim=True)
             - 2.0 * torch.matmul(p32, c32.T)
             + (c32 * c32).sum(1)[None, :])
    mem = torch.argmin(d, dim=1)  # the first index on ties, as in JAX

    seg = (mem[:, None] * nf
           + torch.arange(nf, device=pb.device)[None, :]).reshape(-1)
    sum_bits = exsum_segmented_bits(pb, seg, k * nf).reshape(k, nf)
    counts = torch.bincount(mem, minlength=k)
    cnt_bits = f64_bits(counts.to(torch.float64))[:, None]
    q = f64_div(sum_bits, cnt_bits.expand(k, nf))
    q = torch.where(counts[:, None] > 0, q, 0)
    return q.view(torch.float64), mem


def kmeans_device(points, k: int, iters: int = 5, init=None, device=None):
    """Device-resident reproducible k-means: returns (centers, membership)
    as numpy arrays (float64 (k, nf), int32 (n,)).

    Each iteration is :func:`kmeans_step_device`; centers are float64
    values reproducible bit-for-bit under any point shuffle (pass explicit
    ``init`` centers so the starting point is shuffle-independent too).
    It runs on ``device``, by default the points' (a tensor) or the
    current CUDA device."""
    dev = target_device(points, device=device)
    p = as_f64(points, dev)
    c = as_f64(points[:k] if init is None else init, dev)
    mem = None
    for _ in range(iters):
        c, mem = kmeans_step_device(p, c, k)
    return (c.cpu().numpy(),
            None if mem is None else mem.cpu().numpy().astype(np.int32))


def _update_centers_repro(points, membership, k, device=None):
    """All k*nf exact center sums in ONE batched segmented pass (the
    reference loops a scalar exsum per (cluster, feature),
    kmeans_clustering.cpp:203-223 -- O(k*nf) kernel launches)."""
    n, nf = points.shape
    seg = (np.repeat(membership, nf) * nf
           + np.tile(np.arange(nf), n)).astype(np.int64)
    sums = exsum_segmented(points.reshape(-1), seg, k * nf,
                           device=device).reshape(k, nf)
    counts = np.bincount(membership, minlength=k).astype(np.float64)
    safe = np.maximum(counts, 1.0)
    return np.where(counts[:, None] > 0, sums / safe[:, None], 0.0)


def _update_centers_control(points, membership, k, rng):
    nf = points.shape[1]
    centers = np.zeros((k, nf))
    for c in range(k):
        members = points[membership == c]
        cnt = len(members)
        if cnt:
            # float sum in randomized order: the non-reproducible control
            perm = rng.permutation(cnt)
            acc = np.zeros(nf)
            for i in perm:
                acc += members[i]
            centers[c] = acc / cnt
    return centers


def kmeans(points, k: int, iters: int = 5, reproducible: bool = True,
           rng=None, device=None):
    rng = rng or np.random.RandomState(0)
    dev = target_device(device=device) if reproducible else None
    centers = points[:k].copy()
    for _ in range(iters):
        membership = _assign(points, centers)
        if reproducible:
            centers = _update_centers_repro(points, membership, k, dev)
        else:
            centers = _update_centers_control(points, membership, k, rng)
    return centers, membership


def kmeans_experiment(n: int = 2000, nf: int = 4, k: int = 5,
                      repeats: int = 5, seed: int = 0, device=None) -> dict:
    """Shuffle-and-rerun: point order is permuted between repeats; the
    reproducible path must give bit-identical centers every time."""
    dev = target_device(device=device)
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1, 1, (n, nf)) * np.exp2(
        rng.randint(-20, 20, (n, nf)))
    # fixed initial centers regardless of shuffling
    init = pts[rng.choice(n, k, replace=False)].copy()

    def run(points, reproducible, rrng):
        centers = init.copy()
        for _ in range(3):
            membership = _assign(points, centers)
            if reproducible:
                centers = _update_centers_repro(points, membership, k, dev)
            else:
                centers = _update_centers_control(points, membership, k, rrng)
        return centers

    repro, control = set(), set()
    for _ in range(repeats):
        perm = rng.permutation(n)
        repro.add(run(pts[perm], True, rng).tobytes())
        control.add(run(pts[perm], False, rng).tobytes())
    return {"repro_unique": len(repro), "control_unique": len(control)}


def main(argv=None, device=None):
    """CLI: reproducible k-means on a Rodinia-format points file.

    python -m exblas_tpu_torch.apps.kmeans <points-file> [k] [repeats]
    (e.g. the reference's shipped ``kmeans (Rodinia)/data/100``).  The
    exact center updates run on the current CUDA device (``device`` names
    another).
    """
    import sys

    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        print(main.__doc__)
        return 1
    from .io import read_kmeans_points

    dev = target_device(device=device)
    pts = read_kmeans_points(argv[0])
    k = int(argv[1]) if len(argv) > 1 else 5
    repeats = int(argv[2]) if len(argv) > 2 else 5
    rng = np.random.RandomState(0)
    n = len(pts)
    init = pts[rng.choice(n, k, replace=False)].copy()

    repro, control = set(), set()
    for _ in range(repeats):
        perm = rng.permutation(n)
        shuffled = pts[perm]
        centers = init.copy()
        for _ in range(3):
            mem = _assign(shuffled, centers)
            centers = _update_centers_repro(shuffled, mem, k, dev)
        repro.add(centers.tobytes())
        centers = init.copy()
        for _ in range(3):
            mem = _assign(shuffled, centers)
            centers = _update_centers_control(shuffled, mem, k, rng)
        control.add(centers.tobytes())
    print(f"{argv[0]}: n={n} features={pts.shape[1]} k={k} "
          f"repeats={repeats}")
    print(f"reproducible path: {len(repro)} distinct result(s)   "
          f"{'OK' if len(repro) == 1 else 'FAILED'}")
    print(f"control path:      {len(control)} distinct result(s) "
          "(non-reproducible by design)")
    return 0 if len(repro) == 1 else 1


if __name__ == "__main__":
    raise SystemExit(main())
