"""Reproducible gridding (Parboil mri-gridding analog).

The reference accumulates each grid point's real/imag contributions through
exsum under a reproducibility flag (reference CPU_kernels.cpp:293-302,
920-929).  Here scattered complex samples are binned to cells and each
cell's contributions are reduced exactly.

Port of ``exblas_tpu/apps/gridding.py``: the two segmented passes run
``exsum_segmented`` on the call's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.exsum import exsum_segmented, target_device


def grid_repro(cells, values, n_cells, device=None):
    """Exact per-cell accumulation in two batched segmented passes
    (order-independent by construction; the reference loops exsum per grid
    point, CPU_kernels.cpp:293-302) -> numpy complex128 (n_cells,).  The
    passes run on ``device``, by default the current CUDA device."""
    dev = target_device(device=device)
    ids = torch.from_numpy(np.asarray(cells, np.int64)).to(dev)
    out_re = exsum_segmented(np.ascontiguousarray(values.real), ids,
                             n_cells, device=dev)
    out_im = exsum_segmented(np.ascontiguousarray(values.imag), ids,
                             n_cells, device=dev)
    return out_re + 1j * out_im


def grid_control(cells, values, n_cells):
    """Float scatter-add in arrival order (non-reproducible under shuffles):
    ``np.add.at`` adds in index order, as a loop of ``out[c] += v``
    does."""
    out = np.zeros(n_cells, dtype=np.complex128)
    np.add.at(out, np.asarray(cells), values)
    return out


def gridding_experiment(n_samples: int = 5000, n_cells: int = 16,
                        repeats: int = 5, seed: int = 0,
                        device=None) -> dict:
    dev = target_device(device=device)
    rng = np.random.RandomState(seed)
    cells = rng.randint(0, n_cells, n_samples)
    mag = np.exp2(rng.randint(-25, 25, n_samples).astype(np.float64))
    values = (rng.uniform(-1, 1, n_samples) * mag
              + 1j * rng.uniform(-1, 1, n_samples) * mag)

    repro, control = set(), set()
    for _ in range(repeats):
        perm = rng.permutation(n_samples)
        repro.add(grid_repro(cells[perm], values[perm], n_cells,
                             device=dev).tobytes())
        control.add(grid_control(cells[perm], values[perm],
                                 n_cells).tobytes())
    return {"repro_unique": len(repro), "control_unique": len(control)}


def main(argv=None, device=None):
    """CLI: reproducible gridding on a Parboil .uks input.

    python -m exblas_tpu_torch.apps.gridding <file.uks> [binsize] [repeats]
    (e.g. the reference's shipped ``mri-gridding (Parboil)/data/small/
    small.uks``; the binary .uks.data blob is stripped upstream, so a
    seeded synthetic sample stream matching the parameter file is used
    and reported.)  Samples are binned to oversampled grid cells and each
    cell's complex contributions are accumulated exactly, on the current
    CUDA device (``device`` names another).
    """
    import sys

    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        print(main.__doc__)
        return 1
    from .io import read_uks

    dev = target_device(device=device)
    params, samples = read_uks(argv[0])
    gridsize = [int(v) for v in params["gridding.matrixSize"]]
    binsize = int(argv[1]) if len(argv) > 1 else 128
    repeats = int(argv[2]) if len(argv) > 2 else 5
    kmax = params.get("aquisition.kmax", [150.0, 150.0, 150.0])

    # nearest-cell binning on the oversampled grid (the full Kaiser-Bessel
    # interpolation window of the reference is orthogonal to the
    # reproducibility protocol under study)
    idx = np.zeros(len(samples), np.int64)
    for d in range(3):
        cd = np.clip(((samples[:, 2 + d] / kmax[d]) * 0.5 + 0.5)
                     * gridsize[d], 0, gridsize[d] - 1).astype(np.int64)
        idx = idx * gridsize[d] + cd
    values = (samples[:, 0] * samples[:, 5]
              + 1j * samples[:, 1] * samples[:, 5])  # sdc-weighted
    # compress to occupied cells: the accumulators are per-occupied-cell
    # (the 256^3 dense grid is overwhelmingly empty)
    occupied, idx = np.unique(idx, return_inverse=True)
    n_cells = len(occupied)

    rng = np.random.RandomState(1)
    repro, control = set(), set()
    for _ in range(repeats):
        perm = rng.permutation(len(values))
        repro.add(grid_repro(idx[perm], values[perm], n_cells,
                             device=dev).tobytes())
        control.add(grid_control(idx[perm], values[perm],
                                 n_cells).tobytes())
    print(f"occupied cells: {n_cells}")
    synth = ("(synthetic stream: .uks.data stripped upstream)"
             if params["synthetic"] else "")
    print(f"{argv[0]}: {len(samples)} samples {synth}")
    print(f"grid {gridsize[0]}x{gridsize[1]}x{gridsize[2]}, binsize={binsize}")
    print(f"reproducible path: {len(repro)} distinct result(s)   "
          f"{'OK' if len(repro) == 1 else 'FAILED'}")
    print(f"control path:      {len(control)} distinct result(s) "
          "(non-reproducible by design)")
    return 0 if len(repro) == 1 else 1


if __name__ == "__main__":
    raise SystemExit(main())
