"""Native C++ host backend (ctypes) for ExSUM: the ``parallel=False`` path.

Binds the repository's shared ``csrc/exsum_cpu.cpp`` -- the same source the
JAX package's ``cpu_backend.py`` builds -- with this package's own loader
(``ops/kernels/_build.py``), into ``build/kernels/``.  The C++ backend
accumulates in the same 112-limb base-2^20 format and merges threads
exactly; the final rounding goes through exact Python big-int rationals,
so this path is also an independent check of the package's rounding.
"""

from __future__ import annotations

import ctypes
import threading
from fractions import Fraction
from pathlib import Path

import numpy as np

from .core.types import L_SUM, LIMB_BITS
from .ops.kernels import _build

SRC = Path(__file__).resolve().parents[1] / "csrc" / "exsum_cpu.cpp"
LIB_PATH = _build.BUILD_DIR / "libexsum_cpu.so"

_lock = threading.Lock()
_lib = None


def _command(out: Path) -> list[str]:
    return ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
            str(SRC), "-o", str(out)]


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build.compile_library(
                LIB_PATH, [SRC], _command)))
            lib.exsum_cpu_acc.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ]
            lib.exsum_cpu_acc.restype = None
            lib.exsum_cpu_num_limbs.argtypes = []
            lib.exsum_cpu_num_limbs.restype = ctypes.c_int
            if lib.exsum_cpu_num_limbs() != L_SUM:
                raise RuntimeError("exsum_cpu.cpp limb count differs from "
                                   f"L_SUM={L_SUM}")
            _lib = lib
        return _lib


def exsum_cpu_acc(x, num_threads: int = 0):
    """Exact sum on the host -> (limbs int64 (L_SUM,), special int64 (3,))."""
    x = np.ascontiguousarray(x, dtype=np.float64).ravel()
    limbs = np.zeros(L_SUM, np.int64)
    special = np.zeros(3, np.int64)
    _library().exsum_cpu_acc(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(x.size),
        limbs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        special.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int(num_threads),
    )
    return limbs, special


def round_limbs_exact(limbs, special) -> float:
    """Correctly rounded conversion via exact big-int rationals."""
    nan_c, pinf, ninf = (int(v) for v in special)
    if nan_c > 0 or (pinf > 0 and ninf > 0):
        return float("nan")
    if pinf > 0:
        return float("inf")
    if ninf > 0:
        return float("-inf")
    v = sum(int(limb) << (LIMB_BITS * j) for j, limb in enumerate(limbs))
    if v == 0:
        return 0.0
    # Exact value is v / 2^1074.  The round-to-nearest-even overflow
    # boundary is 2^1024 - 2^970; float(Fraction) raises past DBL_MAX.
    overflow_num = (1 << 2098) - (1 << 2044)
    if v >= overflow_num:
        return float("inf")
    if v <= -overflow_num:
        return float("-inf")
    return float(Fraction(v, 1 << 1074))


def exsum_cpu(x, num_threads: int = 0) -> float:
    """Reproducible, correctly rounded sum on the host CPU (OpenMP)."""
    limbs, special = exsum_cpu_acc(x, num_threads)
    return round_limbs_exact(limbs, special)
