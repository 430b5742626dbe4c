"""Reproducible triangular solve over a world of processes (PyTorch,
``torch.distributed``).

Counterpart of ``exblas_tpu/parallel/trsv.py``.  The reference solves TRSV
on one device only; the JAX package runs the same wavefront across a mesh,
and so does this module:

* T and b are ROW-SHARDED: rank d owns one contiguous block of nb rows and
  their exact DOT_FORMAT limb accumulators (seeded with b);
* the solve walks the nd diagonal blocks in order.  For block kb the
  owner alone solves its diagonal panel from its own accumulators
  (``ops.extrsv.solve_panel``, the single-device blocked sweep) and
  broadcasts the nb bits of x (``torch.distributed.broadcast``); every
  rank whose rows lie below the block then deposits -t_ji * x_i into them
  with the exact row kernel B7 (its plain version on a ``"cpu"`` mesh).
  The JAX package instead psums the owner's accumulators and panel and
  solves the panel on every device; the critical path is the same (every
  rank waits for the panel's x either way) and so are the bits;
* x is replicated, so every rank returns the same bits.

Limb deposits are exact and order-free, and every Round and divide happens
at the same dependency point with the same exact state, so the mesh
cannot change a bit.  Uneven n takes the identity extension
[[T, 0], [0, I]] x = [b, 0]: the padded rows solve to +0.0 and deposit
nothing into the real rows.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..core.ieee import f64_bits
from ..ops.extrsv import _choose_block, _deposit_b, solve_panel
from ..ops.exsum import as_f64, resolve_impl
from ..ops.kernels import gemv_kernel
from ..ops.kernels.gemm_kernel import ONE_BITS
from .distributed import AXIS, make_mesh, mesh_device

__all__ = ["extrsv_sharded"]


def extrsv_sharded(uplo: str, trans: str, diag: str, a, b,
                   mesh: DeviceMesh | None = None, axis: str = AXIS,
                   impl: str | None = None) -> torch.Tensor:
    """Reproducible op(T) x = b over the mesh -> x as int64 bits (n,) on
    this rank's device, the same on every rank: the bits of the
    single-device ``extrsv`` (see module doc).  ``impl`` ("torch" or
    "cuda"; None follows the mesh's device) picks the kernels or their
    plain versions."""
    uplo, trans, diag = uplo.upper(), trans.upper(), diag.upper()
    if uplo not in ("L", "U") or trans not in ("N", "T") or \
            diag not in ("N", "U"):
        raise ValueError("extrsv_sharded: uplo L/U, trans N/T, diag N/U")
    mesh = mesh or make_mesh()
    dev = mesh_device(mesh)
    kernels = resolve_impl(impl, dev) == "cuda"
    t, b = as_f64(a, dev), as_f64(b, dev)
    if b.dim() != 1:
        raise ValueError("extrsv_sharded: b must be 1-D")
    n = b.shape[0]
    if tuple(t.shape) != (n, n):
        raise ValueError(f"extrsv_sharded: a must be ({n}, {n})")
    if trans == "T":
        t = t.t()
        uplo = "U" if uplo == "L" else "L"
    if uplo == "U":
        # the upper solve is the lower solve of the flipped system P T P
        t = t.flip((0, 1))
        b = b.flip(0)

    nd, r = mesh.size(), mesh.get_local_rank(axis)
    nb = -(-n // nd)
    n_pad = nb * nd
    # this rank's rows of the identity-extended system
    lo, hi = min(r * nb, n), min((r + 1) * nb, n)
    t_mine = torch.zeros((nb, n_pad), dtype=torch.int64, device=dev)
    t_mine[:hi - lo, :n] = f64_bits(t[lo:hi])
    b_mine = torch.zeros(nb, dtype=torch.int64, device=dev)
    b_mine[:hi - lo] = f64_bits(b[lo:hi])
    rows = torch.arange(r * nb, (r + 1) * nb, device=dev)
    pad = rows[rows >= n]
    t_mine[pad - r * nb, pad] = ONE_BITS
    acc, spec = _deposit_b(b_mine)

    unit = diag == "U"
    sub = _choose_block(nb)
    rows_acc = (gemv_kernel.gemv_rows_acc_cuda if kernels
                else gemv_kernel.gemv_rows_acc_torch)
    group = mesh.get_group(axis)
    owners = mesh.mesh.reshape(-1).tolist()
    x = torch.empty(n_pad, dtype=torch.int64, device=dev)
    for kb in range(nd):
        cols = slice(kb * nb, (kb + 1) * nb)
        if r == kb:
            x[cols] = solve_panel(t_mine[:, cols], acc, spec, unit, sub,
                                  kernels)
        dist.broadcast(x[cols], src=owners[kb], group=group)
        if r > kb:
            # exact trailing deposit -t_ji * x_i into this rank's rows,
            # all of which lie below block kb
            d_limbs, d_spec = rows_acc(t_mine[:, cols], x[cols],
                                       negate_z=True)
            acc += d_limbs
            spec += d_spec
    bits = x[:n]
    return bits.flip(0) if uplo == "U" else bits
