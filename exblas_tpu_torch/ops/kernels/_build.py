"""Build, load and launch the package's native libraries.

``ops/kernels/csrc/*.cu`` is compiled at first use by ``nvcc`` -- one
process per source, all at once, into objects -- and linked into one
shared library with a plain C interface, ``build/kernels/`` under the
checkout, loaded with ``ctypes``.  Every C entry point takes its
pointers and the CUDA stream as ``void*`` and returns ``cudaGetLastError()``
of its launches; :func:`check` raises if that is not 0.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_PATH = BUILD_DIR / "libexblas_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_N = ctypes.c_longlong
_I = ctypes.c_int
# C entry points: argument types, in order.
SIGNATURES = {
    "exsum_acc_cuda": (_P, _N, _P, _P, _P, _P),
    "exsum_bits_cuda": (_P, _N, _P, _P, _P),
    "exsum_attrs": (_P,),
    "exdot_acc_cuda": (_P, _P, _N, _P, _P, _P, _P),
    "exdot_bits_cuda": (_P, _P, _N, _P, _P, _P),
    "exdot_attrs": (_I, _P),
    "gemm_bits_cuda": (_P, _P, _P, _N, _I, _N, _N, _N, _P, _P),
    "mxu_classes_cuda": (_P, _P, _I, _I, _N, _N, _N, _N, _N, _N, _P, _P),
    "mxu_gemm88_cuda": (_P, _P, _N, _N, _N, _N, _N, _P, _P, _P, _N, _I, _N,
                        _N, _P, _I, _I, _P, _P),
    "mxu_gemm_wide_cuda": (_P, _P, _I, _I, _N, _N, _N, _N, _N, _P, _P, _P,
                           _N, _I, _N, _N, _P, _I, _I, _P, _P),
    "gemm_mxu_attrs": (_I, _P),
    "gemv_mxu_attrs": (_I, _P),
    "mxu_digits_cuda": (_P, _N, _N, _P, _I, _N, _N, _P, _P),
    "mxu_round_cuda": (_P, _I, _N, _N, _P, _P, _P, _N, _I, _N, _N, _I, _I,
                       _P, _P),
    "gemv_rows_acc_cuda": (_P, _P, _N, _N, _N, _I, _I, _I, _N, _P, _P, _P),
    "gemv_rows_attrs": (_P,),
    "gemv_analyze_cuda": (_P, _N, _N, _P, _P, _P, _P, _P),
    "gemv_mxu_classes_cuda": (_P, _P, _P, _N, _N, _N, _I, _I, _N, _P, _P),
    "gemv_mxu_round_cuda": (_P, _I, _P, _P, _P, _N, _I, _N, _I, _I, _P, _P),
    "trsv_lower_x_cuda": (_P, _P, _N, _I, _I, _I, _P, _P, _P, _P),
    "sum_flat_cuda": (_P, _N, _P, _I, _P, _P),
    "sum_flat_attrs": (_I, _P),
    "dot_flat_cuda": (_P, _P, _N, _P, _P, _P, _P),
    "dot_flat_attrs": (_I, _P),
    "round_terms_cuda": (_P, _P, _I, _I, _P, _I, _P, _P),
}

_lock = threading.Lock()
_lib = None


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(put the CUDA toolkit's bin/ on PATH)")
    return nvcc


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def object_path(src: Path) -> Path:
    return BUILD_DIR / f"{src.stem}.o"


def object_command(src: Path):
    """out -> the argv that compiles ``src`` into the object ``out``."""
    return lambda out: [find_nvcc(), *NVCC_FLAGS, "-c", "-o", str(out),
                        str(src)]


def build_command(out: Path) -> list[str]:
    """The link of every source's object into the library."""
    return [find_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(out),
            *(str(object_path(s)) for s in sources())]


def compile_library(out: Path, deps: list[Path], command,
                    force: bool = False) -> Path:
    """Run ``command(tmp_path)`` (an argv list) to build ``out`` unless it is
    newer than every file in ``deps``.  The result is renamed into place,
    so concurrent builders never load a half-written library.  Raises
    ``RuntimeError`` with the compiler's output on failure."""
    if (not force and out.exists() and out.stat().st_mtime
            >= max(p.stat().st_mtime for p in deps)):
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = command(tmp)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"build failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def build(force: bool = False) -> Path:
    """Compile the CUDA kernels into ``LIB_PATH`` (see module doc)."""
    srcs = sources()
    with ThreadPoolExecutor(max_workers=len(srcs)) as pool:
        objs = list(pool.map(
            lambda s: compile_library(object_path(s), [s, *headers()],
                                      object_command(s), force=force),
            srcs))
    return compile_library(LIB_PATH, objs, build_command, force=force)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def check_cuda_f64(x: torch.Tensor, name: str) -> None:
    """Raise unless ``x`` is a contiguous float64 tensor on a CUDA device."""
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got "
                         f"{getattr(x, 'device', type(x))}")
    if x.dtype != torch.float64:
        raise TypeError(f"{name}: expected float64, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def stream_of(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, for a C entry point."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    """A tensor's data pointer, for a C entry point."""
    return ctypes.c_void_p(t.data_ptr())
