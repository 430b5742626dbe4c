"""Reproducible reductions over a world of processes: exact limb all_reduce
(PyTorch, ``torch.distributed``).

Counterpart of ``exblas_tpu/parallel/distributed.py``.  The reference
distributes ExSUM over MPI ranks by scattering raw doubles and reducing
normalized superaccumulators limb by limb with an integer ``MPI_Reduce``
(reference src/cpu/blas/blas1/ExSUM.cpp:33-63, 266-273): integer addition
is associative, so neither the reduction tree nor the rank count can
change the bits.

Here a mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
initialized default process group (started by ``torchrun``, or by
``init_process_group`` in each process): NCCL between cards, Gloo on the
CPU.  Every rank gets the same global input, takes its own contiguous
shard (the input zero-padded to a multiple of the world size, as the JAX
package shards it: +0.0 deposits nothing), accumulates it with the
single-device routing of ``ops/exsum.py``/``ops/exdot.py`` (the anchored
ladder at 2^20 elements or more, the exact kernels B2/B4 below), merges the
accumulators with one ``all_reduce(SUM)`` of int64 limbs and special
counts, and rounds once, replicated: every rank returns the same bits.

A ``"cuda"`` mesh runs each rank on its current CUDA device
(``torch.cuda.current_device()``), kernels and collectives alike; a
``"cpu"`` mesh runs the plain PyTorch path.  Nothing falls back from one
to the other.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..core.accumulator import to_int32_limbs
from ..core.rounding import round_superacc_to_f64_bits
from ..core.types import Superacc
from ..ops.exdot import exdot_acc
from ..ops.exsum import as_f64, exsum_acc, resolve_impl

__all__ = ["AXIS", "make_mesh", "psum_superacc", "exsum_sharded",
           "exdot_sharded"]

AXIS = "devices"


def world_size(device_type: str) -> int:
    """The size of the initialized default process group; raises when
    there is none, or when a ``"cuda"`` mesh is asked for without a card."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "no process group is initialized: start the processes with "
            "torchrun, or call torch.distributed.init_process_group in each")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a 'cuda' mesh needs a CUDA device; pass "
                           "device_type='cpu' to run on the CPU")
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    return dist.get_world_size()


def make_mesh(n_devices: int | None = None, axis: str = AXIS,
              device_type: str = "cuda") -> DeviceMesh:
    """A 1-D mesh over every rank of the default process group.  The JAX
    package's mesh of its first ``n_devices`` devices is a world of that
    many ranks here, so ``n_devices`` must be the world size."""
    nd = world_size(device_type)
    if n_devices is not None and n_devices != nd:
        raise ValueError(f"make_mesh: n_devices={n_devices}, but the world "
                         f"has {nd} ranks (start a world of that size)")
    return init_device_mesh(device_type, (nd,), mesh_dim_names=(axis,))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on: its current CUDA device on a
    ``"cuda"`` mesh, the CPU on a ``"cpu"`` one."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard(v: torch.Tensor, parts: int, index: int, dim: int = 0):
    """Part ``index`` of ``parts`` contiguous parts of ``v`` along ``dim``,
    after ``v`` is zero-padded there to a multiple of ``parts``: the shard
    a device of the JAX package's mesh receives.  Returns the part as a
    view of ``v`` (a block of columns keeps the matrix's row stride) and
    the range it covers in the unpadded ``v``, which may be shorter than
    a part or empty."""
    size = -(-v.shape[dim] // parts)
    lo = min(index * size, v.shape[dim])
    hi = min(lo + size, v.shape[dim])
    return v.narrow(dim, lo, hi - lo), lo, hi


def padded_shard(v: torch.Tensor, parts: int, index: int) -> torch.Tensor:
    """:func:`shard` of a 1-D ``v``, zero-padded to the full part size."""
    part, lo, hi = shard(v, parts, index)
    size = -(-v.shape[0] // parts)
    if hi - lo < size:
        part = torch.cat([part, part.new_zeros(size - (hi - lo))])
    return part


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """In-place integer ``all_reduce(SUM)`` over ``group``; returns ``t``."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def psum_superacc(acc: Superacc, mesh: DeviceMesh | None = None,
                  axis: str = AXIS) -> Superacc:
    """Exact merge of every rank's Superacc: one ``all_reduce(SUM)`` of the
    limbs and one of the special counts, on the wire as int64 (the JAX
    package psums int32 limbs, which holds about 2^10 devices).  The sum
    is renormalized into int32 limbs with the top limb kept whole, so a
    negative total keeps its borrowed -1 there."""
    mesh = mesh or make_mesh()
    group = mesh.get_group(axis)
    limbs = all_reduce_sum(acc.limbs.to(torch.int64), group)
    special = all_reduce_sum(acc.special.to(torch.int64), group)
    return Superacc(limbs=to_int32_limbs(limbs),
                    special=special.to(torch.int32), fmt=acc.fmt)


def _flat(x, device: torch.device) -> torch.Tensor:
    return as_f64(x, device).reshape(-1)


def exsum_sharded(x, mesh: DeviceMesh | None = None, axis: str = AXIS,
                  impl: str | None = None) -> torch.Tensor:
    """Reproducible sum of the global ``x`` over the mesh -> binary64 bits,
    a 0-dim int64 tensor on this rank's device, the same on every rank and
    for every mesh size and shard layout.  ``impl`` ("torch" or "cuda";
    None follows the mesh's device) picks the kernels or their plain
    versions; it does not change the bits."""
    mesh = mesh or make_mesh()
    dev = mesh_device(mesh)
    impl = resolve_impl(impl, dev)
    local = padded_shard(_flat(x, dev), mesh.size(), mesh.get_local_rank(axis))
    acc = exsum_acc(local, impl=impl)
    return round_superacc_to_f64_bits(psum_superacc(acc, mesh, axis))


def exdot_sharded(a, b, mesh: DeviceMesh | None = None, axis: str = AXIS,
                  impl: str | None = None) -> torch.Tensor:
    """Reproducible dot product of the global ``a`` and ``b`` over the mesh
    -> binary64 bits (see :func:`exsum_sharded`)."""
    mesh = mesh or make_mesh()
    dev = mesh_device(mesh)
    impl = resolve_impl(impl, dev)
    a, b = _flat(a, dev), _flat(b, dev)
    if a.shape != b.shape:
        raise ValueError(f"exdot_sharded: {a.numel()} vs {b.numel()} "
                         f"elements")
    nd, r = mesh.size(), mesh.get_local_rank(axis)
    acc = exdot_acc(padded_shard(a, nd, r), padded_shard(b, nd, r),
                    impl=impl)
    return round_superacc_to_f64_bits(psum_superacc(acc, mesh, axis))
