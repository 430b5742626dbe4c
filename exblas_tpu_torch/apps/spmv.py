"""Reproducible SpMV (Parboil spmv analog).

The reference gathers each row's A_ij * x_j products to doubles and reduces
them with exsum per row (reference src/gpu/examples/spmv (Parboil)/
StrongReproducibility/main.cpp:229-286).  Here rows are padded to a common
nnz and all rows are reduced in one batched exact pass (products are
accumulated exactly, which is stronger than the reference's
promote-then-sum).

Port of ``exblas_tpu/apps/spmv.py``.  The JAX package runs the row dots in
XLA (``dot_rows_acc_xla`` with a per-row z), outside any Pallas kernel, so
they are the port's plain row deposit (``ops/exgemv.py`` ``dot_rows_acc``)
on the call's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.ieee import f64_bits
from ..ops.exgemv import dot_rows_acc, round_rows
from ..ops.exsum import as_f64, target_device


def _rows_dot_exact(vals, gathered_x) -> torch.Tensor:
    """Per-row exact dot of equal-length (padded) rows: float64 tensors
    (m, nnz) on one device -> the correctly rounded float64 tensor (m,)."""
    limbs, special = dot_rows_acc(f64_bits(vals), f64_bits(gathered_x))
    return round_rows(limbs, special).view(torch.float64)


def make_random_csr(m: int, nnz_per_row: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    cols = np.stack([rng.choice(m, nnz_per_row, replace=False)
                     for _ in range(m)])
    vals = rng.uniform(-1, 1, (m, nnz_per_row)) * np.exp2(
        rng.randint(-25, 25, (m, nnz_per_row)))
    return vals, cols


def spmv_repro(vals, cols, x, device=None) -> np.ndarray:
    """y = A x, each row's products summed exactly and rounded once ->
    numpy float64 (m,).  ``vals``/``cols`` (m, nnz) padded rows, ``x`` the
    dense vector; the work runs on ``device``, by default the operands'
    (tensors) or the current CUDA device (numpy input)."""
    dev = target_device(vals, cols, x, device=device)
    if not isinstance(cols, torch.Tensor):
        cols = torch.from_numpy(np.asarray(cols, np.int64))
    gathered = as_f64(x, dev)[cols.to(dev)]
    return _rows_dot_exact(as_f64(vals, dev), gathered).cpu().numpy()


def spmv_control(vals, cols, x, rng):
    """Float SpMV with per-row randomized accumulation order."""
    m, nnz = vals.shape
    y = np.zeros(m)
    for i in range(m):
        order = rng.permutation(nnz)
        acc = 0.0
        for j in order:
            acc += vals[i, j] * x[cols[i, j]]
        y[i] = acc
    return y


def spmv_experiment(m: int = 200, nnz: int = 32, repeats: int = 5,
                    seed: int = 0, device=None) -> dict:
    dev = target_device(device=device)
    vals, cols = make_random_csr(m, nnz, seed)
    rng = np.random.RandomState(seed + 1)
    x = rng.uniform(-1, 1, m) * np.exp2(rng.randint(-25, 25, m))

    repro, control = set(), set()
    for _ in range(repeats):
        perm = rng.permutation(nnz)  # permute the nnz order within rows
        repro.add(spmv_repro(vals[:, perm], cols[:, perm], x,
                             device=dev).tobytes())
        control.add(spmv_control(vals[:, perm], cols[:, perm], x,
                                 rng).tobytes())
    return {"repro_unique": len(repro), "control_unique": len(control)}


def main(argv=None, device=None):
    """CLI: reproducible SpMV on a MatrixMarket file.

    python -m exblas_tpu_torch.apps.spmv <file.mtx> [repeats]
    (e.g. the reference's shipped ``spmv (Parboil)/data/jgl009.mtx`` or
    ``fidapm05.mtx``.)  Runs the strong-reproducibility protocol: SpMV is
    repeated with the nnz order shuffled; the exact path must be
    bit-identical every time while the float control diverges.  It runs
    on the current CUDA device (``device`` names another).
    """
    import sys

    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        print(main.__doc__)
        return 1
    from .io import mm_to_padded_rows, read_matrix_market

    dev = target_device(device=device)
    m, n, rows, cols, nzvals = read_matrix_market(argv[0])
    repeats = int(argv[1]) if len(argv) > 1 else 5
    vals, pcols = mm_to_padded_rows(m, n, rows, cols, nzvals)
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, n) * np.exp2(rng.randint(-25, 25, n))

    repro, control = set(), set()
    nnz = vals.shape[1]
    for _ in range(repeats):
        perm = rng.permutation(nnz)
        repro.add(spmv_repro(vals[:, perm], pcols[:, perm], x,
                             device=dev).tobytes())
        control.add(spmv_control(vals[:, perm], pcols[:, perm], x,
                                 rng).tobytes())
    print(f"{argv[0]}: {m}x{n}, {len(nzvals)} nonzeros, "
          f"padded row width {nnz}")
    print(f"reproducible path: {len(repro)} distinct result(s)   "
          f"{'OK' if len(repro) == 1 else 'FAILED'}")
    print(f"control path:      {len(control)} distinct result(s) "
          "(non-reproducible by design)")
    return 0 if len(repro) == 1 else 1


if __name__ == "__main__":
    raise SystemExit(main())
