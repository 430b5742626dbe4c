"""Reproducible GEMV / GEMM over a world of processes (PyTorch,
``torch.distributed``).

Counterpart of ``exblas_tpu/parallel/blas2.py``.  Two sharding strategies,
both bit-identical to the single-device result:

* row sharding (the "tensor-parallel" layout): each rank owns a block of
  output rows (or a block of C on a 2-D mesh) and computes it with the
  single-device kernels -- no reduction, trivially exact;
* k sharding (reduction-parallel): each rank accumulates a slice of the
  reduction dimension into per-row limb accumulators, merged by one int64
  ``all_reduce(SUM)`` (exact and associative, so the mesh size cannot
  change the bits) before one replicated rounding.

Every rank gets the same global operands, as in the JAX package, and
returns the whole result.  Where the JAX package gathers row-sharded
output (``out_specs=P(axis)``), each rank here writes its rows into a
zero-filled int64 tensor of the full shape and the ranks ``all_reduce``
it: exact, as one rank alone is nonzero at each entry.  The module uses
only ``all_reduce`` and ``broadcast``, the two collectives Gloo also takes
on CUDA tensors.

On a ``"cuda"`` mesh the blocks run the kernels: ``exgemv_sharded`` "rows"
the single-device GEMV dispatch (B8, then B9 or B7), "k" and the 2-D GEMV
the row kernel B7, the GEMM blocks the exact kernel B5 (the JAX mesh layer
calls its exact kernel, not the slice-kernel dispatch).  ``exgemm_sharded_k``
runs the plain product deposit ``gemm_acc``: its accumulators are the
per-element limbs, which no GEMM kernel writes out.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..core.f64ops import f64_mul
from ..core.ieee import f64_bits
from ..ops.exgemv import (_apply_beta_rows, _gemv_bits_auto, _scalar_bits,
                          gemm_acc, round_rows)
from ..ops.exsum import as_f64, resolve_impl
from ..ops.kernels import gemm_kernel, gemv_kernel
from .distributed import (AXIS, all_reduce_sum, make_mesh, mesh_device,
                          world_size)
from .distributed import shard as _shard  # ``shard`` is a keyword below

__all__ = ["exgemv_sharded", "exgemv_sharded_2d", "make_mesh_2d",
           "exgemm_sharded", "exgemm_sharded_2d", "exgemm_sharded_k"]


def make_mesh_2d(shape, axes=("rows", "k"),
                 device_type: str = "cuda") -> DeviceMesh:
    """A 2-D mesh over every rank of the default process group, e.g. (2, 4)
    for row-parallel x reduction-parallel; ``shape`` must hold the whole
    world."""
    nd = world_size(device_type)
    p, q = (int(s) for s in shape)
    if p * q != nd:
        raise ValueError(f"make_mesh_2d: shape {tuple(shape)} holds {p * q} "
                         f"ranks, but the world has {nd}")
    return init_device_mesh(device_type, (p, q), mesh_dim_names=tuple(axes))


def _beta_mode(beta: float, y) -> str:
    return "zero" if (beta == 0.0 or y is None) else (
        "one" if beta == 1.0 else "general")


def _rows_acc(a_bits, z_bits, kernels: bool):
    """Exact per-row accumulators of a block: kernel B7 or its plain
    version."""
    fn = (gemv_kernel.gemv_rows_acc_cuda if kernels
          else gemv_kernel.gemv_rows_acc_torch)
    return fn(a_bits, z_bits)


def _assemble(shape, blocks, groups, device) -> torch.Tensor:
    """The full int64 bits of ``shape`` from each rank's ``blocks`` (pairs
    of an index into the full tensor and the bits there): zero-filled,
    then summed over each group in ``groups`` in turn."""
    out = torch.zeros(shape, dtype=torch.int64, device=device)
    for index, bits in blocks:
        out[index] = bits
    for group in groups:
        all_reduce_sum(out, group)
    return out


def _gemv_operands(name, a, x, alpha, beta, y, trans, dev):
    """op(A) and z = fl(alpha * x) as int64 bits on ``dev``, the beta mode
    and y's bits (None for beta 0)."""
    a = as_f64(a, dev)
    if a.dim() != 2:
        raise ValueError(f"{name}: a must be 2-D")
    if trans.upper() == "T":
        a = a.t()
    elif trans.upper() != "N":
        raise ValueError(f"{name}: trans must be N/T, got {trans!r}")
    m, n = a.shape
    x = as_f64(x, dev).reshape(-1)
    if x.shape[0] != n:
        raise ValueError(f"{name}: x must have shape ({n},)")
    z_bits = f64_mul(torch.tensor(_scalar_bits(alpha), device=dev),
                     f64_bits(x))
    mode = _beta_mode(beta, y)
    y_bits = None
    if mode != "zero":
        y_bits = f64_bits(as_f64(y, dev).reshape(-1))
        if y_bits.shape[0] != m:
            raise ValueError(f"{name}: y must have shape ({m},)")
    return f64_bits(a.contiguous()), z_bits, mode, y_bits


def exgemv_sharded(a, x, alpha: float = 1.0, mesh: DeviceMesh | None = None,
                   axis: str = AXIS, shard: str = "rows",
                   impl: str | None = None, beta: float = 0.0, y=None,
                   trans: str = "N") -> torch.Tensor:
    """Reproducible y = alpha*op(A)@x + beta*y over the mesh -> int64 bits
    (m,) on this rank's device, the same on every rank.

    shard="rows": each rank runs the single-device dispatch on its rows.
    shard="k":    each rank accumulates its columns with B7; exact limb
                  all_reduce, then the beta term, replicated.
    Uneven m or k need not divide the mesh.  z = fl(alpha*x) is computed
    once; the beta term is deposited once per row, on the row's owner
    (rows) or replicated after the merge (k), so the mesh cannot change a
    bit.
    """
    mesh = mesh or make_mesh()
    dev = mesh_device(mesh)
    kernels = resolve_impl(impl, dev) == "cuda"
    a_bits, z_bits, mode, y_bits = _gemv_operands(
        "exgemv_sharded", a, x, alpha, beta, y, trans, dev)
    m = a_bits.shape[0]
    nd, r = mesh.size(), mesh.get_local_rank(axis)
    beta_bits = _scalar_bits(beta)
    group = mesh.get_group(axis)
    if shard == "rows":
        rows, lo, hi = _shard(a_bits, nd, r)
        y_rows = None if y_bits is None else y_bits[lo:hi]
        local = _gemv_bits_auto(rows, z_bits, y_rows, beta_bits, mode,
                                kernels)
        return _assemble((m,), [(slice(lo, hi), local)], [group], dev)
    if shard == "k":
        cols, lo, hi = _shard(a_bits, nd, r, 1)
        limbs, special = _rows_acc(cols, z_bits[lo:hi], kernels)
        all_reduce_sum(limbs, group)
        all_reduce_sum(special, group)
        limbs, special = _apply_beta_rows(limbs, special, beta_bits, y_bits,
                                          mode)
        return round_rows(limbs, special)
    raise ValueError(f"unknown shard strategy {shard!r}")


def exgemv_sharded_2d(a, x, alpha: float = 1.0,
                      mesh: DeviceMesh | None = None, beta: float = 0.0,
                      y=None, trans: str = "N") -> torch.Tensor:
    """Reproducible y = alpha*op(A)@x + beta*y over a 2-D (rows, k) mesh ->
    int64 bits (m,).

    A is sharded over both axes; each rank accumulates its block with B7,
    the accumulators are merged by an exact limb all_reduce over the k
    axis, and the beta term is deposited after the merge by the row
    block's owners.  Bit-identical for every mesh shape.
    """
    mesh = mesh or make_mesh_2d((1, world_size("cuda")))
    row_ax, k_ax = mesh.mesh_dim_names
    dev = mesh_device(mesh)
    kernels = mesh.device_type == "cuda"
    a_bits, z_bits, mode, y_bits = _gemv_operands(
        "exgemv_sharded_2d", a, x, alpha, beta, y, trans, dev)
    m = a_bits.shape[0]
    rows, rlo, rhi = _shard(a_bits, mesh.size(0), mesh.get_local_rank(row_ax))
    block, klo, khi = _shard(rows, mesh.size(1), mesh.get_local_rank(k_ax), 1)
    limbs, special = _rows_acc(block, z_bits[klo:khi], kernels)
    k_group = mesh.get_group(k_ax)
    all_reduce_sum(limbs, k_group)
    all_reduce_sum(special, k_group)
    limbs, special = _apply_beta_rows(
        limbs, special, _scalar_bits(beta),
        None if y_bits is None else y_bits[rlo:rhi], mode)
    return _assemble((m,), [(slice(rlo, rhi), round_rows(limbs, special))],
                     [mesh.get_group(row_ax)], dev)


def _gemm_operands(a, b, alpha, beta, c, transa, transb, dev):
    """op(A), op(B) and C (None for beta 0) as int64 bits on ``dev``, the
    alpha and beta bits and the beta mode."""
    for name, t in (("transa", transa), ("transb", transb)):
        if t.upper() not in ("N", "T"):
            raise ValueError(f"exgemm_sharded: {name} must be N/T, got "
                             f"{t!r}")
    a, b = as_f64(a, dev), as_f64(b, dev)
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError("exgemm_sharded: a and b must be matrices")
    if transa.upper() == "T":
        a = a.t()
    if transb.upper() == "T":
        b = b.t()
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"exgemm_sharded: inner dims mismatch {a.shape[1]} "
                         f"vs {b.shape[0]}")
    m, n = a.shape[0], b.shape[1]
    mode = _beta_mode(beta, c)
    c_bits = None
    if mode != "zero":
        c_bits = f64_bits(as_f64(c, dev))
        if tuple(c_bits.shape) != (m, n):
            raise ValueError(f"c must have shape ({m}, {n})")
    return (f64_bits(a.contiguous()), f64_bits(b.contiguous()), c_bits,
            _scalar_bits(alpha), _scalar_bits(beta), mode)


def _alpha_fold(a_bits, alpha_bits: int):
    """z = fl(alpha * A) elementwise on the local block (one correctly
    rounded multiply per element -- the single-device semantics)."""
    return f64_mul(torch.tensor(alpha_bits, device=a_bits.device), a_bits)


def _local_gemm_bits(z_bits, b_bits, c_bits, beta_bits: int, mode: str,
                     kernels: bool):
    """Exact C = beta*C + Z@B bits of one block: kernel B5 or its plain
    version."""
    fn = (gemm_kernel.gemm_bits_cuda if kernels
          else gemm_kernel.gemm_bits_torch)
    if c_bits is not None:
        c_bits = c_bits.contiguous()
    return fn(z_bits, b_bits.contiguous(), c_bits, beta_bits, mode)


def exgemm_sharded(a, b, mesh: DeviceMesh | None = None, axis: str = AXIS,
                   impl: str | None = None, alpha: float = 1.0,
                   beta: float = 0.0, c=None, transa: str = "N",
                   transb: str = "N") -> torch.Tensor:
    """Reproducible C = beta*C + alpha*op(A)@op(B) with op(A) (and C)
    row-sharded over the mesh -> int64 bits (m, n) on every rank.  Uneven
    m need not divide the mesh."""
    mesh = mesh or make_mesh()
    dev = mesh_device(mesh)
    kernels = resolve_impl(impl, dev) == "cuda"
    a_bits, b_bits, c_bits, alpha_bits, beta_bits, mode = _gemm_operands(
        a, b, alpha, beta, c, transa, transb, dev)
    rows, lo, hi = _shard(a_bits, mesh.size(), mesh.get_local_rank(axis))
    local = _local_gemm_bits(_alpha_fold(rows, alpha_bits), b_bits,
                             None if c_bits is None else c_bits[lo:hi],
                             beta_bits, mode, kernels)
    return _assemble((a_bits.shape[0], b_bits.shape[1]),
                     [(slice(lo, hi), local)], [mesh.get_group(axis)], dev)


def exgemm_sharded_2d(a, b, mesh: DeviceMesh | None = None,
                      impl: str | None = None, alpha: float = 1.0,
                      beta: float = 0.0, c=None, transa: str = "N",
                      transb: str = "N") -> torch.Tensor:
    """Reproducible C = beta*C + alpha*op(A)@op(B) over a 2-D (rows, cols)
    mesh -> int64 bits (m, n) on every rank.

    The tensor-parallel BLAS-3 layout: A row-sharded, B column-sharded,
    each block of C computed whole by one rank (k stays local, no
    reduction).  Bit-identical for every mesh shape.
    """
    mesh = mesh or make_mesh_2d((1, world_size("cuda")),
                                axes=("rows", "cols"))
    row_ax, col_ax = mesh.mesh_dim_names
    dev = mesh_device(mesh)
    kernels = resolve_impl(impl, dev) == "cuda"
    a_bits, b_bits, c_bits, alpha_bits, beta_bits, mode = _gemm_operands(
        a, b, alpha, beta, c, transa, transb, dev)
    rows, rlo, rhi = _shard(a_bits, mesh.size(0), mesh.get_local_rank(row_ax))
    cols, clo, chi = _shard(b_bits, mesh.size(1), mesh.get_local_rank(col_ax),
                            1)
    local = _local_gemm_bits(
        _alpha_fold(rows, alpha_bits), cols,
        None if c_bits is None else c_bits[rlo:rhi, clo:chi],
        beta_bits, mode, kernels)
    return _assemble((a_bits.shape[0], b_bits.shape[1]),
                     [((slice(rlo, rhi), slice(clo, chi)), local)],
                     [mesh.get_group(row_ax), mesh.get_group(col_ax)], dev)


def exgemm_sharded_k(a, b, mesh: DeviceMesh | None = None, axis: str = AXIS,
                     alpha: float = 1.0, beta: float = 0.0, c=None,
                     transa: str = "N", transb: str = "N") -> torch.Tensor:
    """Reproducible C = beta*C + alpha*op(A)@op(B) with the k (reduction)
    axis sharded -> int64 bits (m, n) on every rank.

    Each rank deposits its k-slice of products into exact per-element limb
    accumulators (``gemm_acc``, m*n*216 int64 limbs); an int64
    ``all_reduce`` merges them (the BLAS-3 analog of the reference's
    limb-wise MPI_Reduce), the exact beta*C deposit runs replicated after
    the merge, and one rounding finishes.  The decomposition-invariance
    anchor, not a throughput path: shard rows or columns for speed.
    """
    mesh = mesh or make_mesh()
    dev = mesh_device(mesh)
    a_bits, b_bits, c_bits, alpha_bits, beta_bits, mode = _gemm_operands(
        a, b, alpha, beta, c, transa, transb, dev)
    m, n = a_bits.shape[0], b_bits.shape[1]
    nd, r = mesh.size(), mesh.get_local_rank(axis)
    cols, _, _ = _shard(a_bits, nd, r, 1)
    rows, _, _ = _shard(b_bits, nd, r)
    limbs, special = gemm_acc(_alpha_fold(cols, alpha_bits), rows)
    group = mesh.get_group(axis)
    all_reduce_sum(limbs, group)
    all_reduce_sum(special, group)
    limbs, special = _apply_beta_rows(
        limbs, special, beta_bits,
        None if c_bits is None else c_bits.reshape(-1), mode)
    return round_rows(limbs, special).reshape(m, n)
