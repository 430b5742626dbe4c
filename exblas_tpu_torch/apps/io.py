"""Input readers for the application studies' real data sets (pure numpy).

A copy of ``exblas_tpu/apps/io.py``, so that the port imports nothing of
the JAX package; only :func:`reference_data_path` differs (it reads the
reference checkout's root from ``EXBLAS_REFERENCE_ROOT`` alone).  Native
analogs of the reference's loaders:

* :func:`read_matrix_market` -- MatrixMarket coordinate files
  (reference ``spmv (Parboil)/StrongReproducibility/mmio.cpp``; shipped
  inputs ``jgl009.mtx`` (pattern) and ``fidapm05.mtx`` (real)).
* :func:`read_uks` -- Parboil mri-gridding ``.uks`` parameter files plus the
  binary ``.uks.data`` sample stream of packed
  ``{float real, imag, kX, kY, kZ, sdc}`` records (reference ``UDTypes.h``
  ReconstructionSample, ``main.cpp:82-97``).  The reference tree ships only
  the small parameter file (the large binary blobs are stripped upstream),
  so when ``.data`` is absent a seeded synthetic sample stream matching the
  parameter file's k-space extents is generated -- clearly reported in the
  returned metadata.
* :func:`read_kmeans_points` -- Rodinia kmeans text format: one object per
  line, first column an id (ignored), remaining columns float features
  (reference ``kmeans.cpp:226-264``).
"""

from __future__ import annotations

import os

import numpy as np


def read_matrix_market(path: str):
    """Parse a MatrixMarket coordinate file -> (m, n, rows, cols, vals).

    Supports ``real``/``integer``/``pattern`` fields and
    ``general``/``symmetric``/``skew-symmetric`` symmetries (pattern entries
    get value 1.0; symmetric entries are mirrored).  Indices are returned
    0-based.
    """
    with open(path) as f:
        header = f.readline()
        if not header.startswith("%%MatrixMarket"):
            raise ValueError(f"{path}: not a MatrixMarket file")
        parts = header.lower().split()
        if parts[1] != "matrix" or parts[2] != "coordinate":
            raise ValueError(f"{path}: only coordinate matrices supported")
        field, symmetry = parts[3], parts[4]
        if field not in ("real", "integer", "pattern"):
            raise ValueError(f"{path}: unsupported field {field!r}")

        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        m, n, nnz = (int(v) for v in line.split())

        rows = np.empty(nnz, np.int64)
        cols = np.empty(nnz, np.int64)
        vals = np.empty(nnz, np.float64)
        for i in range(nnz):
            toks = f.readline().split()
            rows[i] = int(toks[0]) - 1
            cols[i] = int(toks[1]) - 1
            vals[i] = 1.0 if field == "pattern" else float(toks[2])

    if symmetry in ("symmetric", "skew-symmetric"):
        off = rows != cols
        sign = -1.0 if symmetry == "skew-symmetric" else 1.0
        r2, c2, v2 = cols[off], rows[off], sign * vals[off]
        rows = np.concatenate([rows, r2])
        cols = np.concatenate([cols, c2])
        vals = np.concatenate([vals, v2])
    return m, n, rows, cols, vals


def mm_to_padded_rows(m, n, rows, cols, vals):
    """Coordinate triplets -> padded per-row (vals, cols) arrays (the
    layout spmv_repro consumes; padding value 0.0 contributes nothing)."""
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    counts = np.bincount(rows, minlength=m)
    width = max(1, int(counts.max()))
    v = np.zeros((m, width), np.float64)
    c = np.zeros((m, width), np.int64)
    pos = np.zeros(m, np.int64)
    for r, cc, vv in zip(rows, cols, vals):
        v[r, pos[r]] = vv
        c[r, pos[r]] = cc
        pos[r] += 1
    return v, c


def read_uks(path: str, synth_seed: int = 0, synth_cap: int = 200000):
    """Load a Parboil mri-gridding input -> (params dict, samples (N, 6)).

    samples columns: real, imag, kX, kY, kZ, sdc.  If ``path + '.data'``
    is absent (the reference strips its large blobs), a seeded synthetic
    stream of min(numsamples, synth_cap) records within the parameter
    file's k-space extents is generated; params['synthetic'] reports it.
    """
    params = {}
    with open(path) as f:
        for line in f:
            if "=" not in line:
                continue
            key, val = line.strip().split("=", 1)
            toks = val.split()
            params[key] = [float(t) for t in toks] if len(toks) > 1 else (
                float(toks[0]) if "." in toks[0] else int(toks[0]))

    num = int(params["aquisition.numsamples"])
    data_path = path + ".data"
    if os.path.exists(data_path):
        raw = np.fromfile(data_path, dtype=np.float32, count=num * 6)
        samples = raw.reshape(-1, 6).astype(np.float64)
        params["synthetic"] = False
    else:
        n = min(num, synth_cap)
        rng = np.random.RandomState(synth_seed)
        kmax = params.get("aquisition.kmax", [150.0, 150.0, 150.0])
        samples = np.empty((n, 6))
        samples[:, 0] = rng.standard_normal(n) * np.exp2(
            rng.randint(-10, 10, n))  # real
        samples[:, 1] = rng.standard_normal(n) * np.exp2(
            rng.randint(-10, 10, n))  # imag
        for d in range(3):
            samples[:, 2 + d] = rng.uniform(-kmax[d], kmax[d], n)
        samples[:, 5] = rng.uniform(0.0, 1.0, n)  # sdc
        params["synthetic"] = True
    return params, samples


def read_kmeans_points(path: str) -> np.ndarray:
    """Rodinia kmeans text input -> (n_objects, n_features) float64
    (first column per line is an id and is dropped)."""
    rows = []
    with open(path) as f:
        for line in f:
            toks = line.replace(",", " ").split()
            if not toks:
                continue
            rows.append([float(t) for t in toks[1:]])
    return np.asarray(rows, np.float64)


def reference_data_path(*parts) -> str | None:
    """Path into the read-only reference checkout's shipped data, or None:
    the checkout's root is ``EXBLAS_REFERENCE_ROOT``; unset, nothing
    outside this repository is read and the result is None."""
    base = os.environ.get("EXBLAS_REFERENCE_ROOT")
    if base is None:
        return None
    p = os.path.join(base, *parts)
    return p if os.path.exists(p) else None
