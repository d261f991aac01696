"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` source becomes one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), compiled for
``sm_90a`` without fast math.  Libraries are built at first use into
``build/repro_torch_kernels/`` at the root of the checkout, named by a hash
of the sources and flags, so an unchanged tree reuses them.  All missing
libraries are compiled in parallel, one ``nvcc`` process per source.  A
failed build raises; nothing falls back.  ``build_log`` keeps what
``nvcc`` printed (``ptxas``: registers and shared memory per kernel).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# library name -> (source, exported C functions -> (ctypes argtypes, restype))
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIBRARIES = {
    "kan_fused_gemm": (
        "kan_fused_gemm.cu",
        {"kan_fused_gemm": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _I, _P], _I)},
    ),
    "kan_sparse_gemm": (
        "kan_sparse_gemm.cu",
        {
            "kan_sparse_gemm": (
                [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _I, _P], _I),
            "kan_sparse_gemm_tickets": ([_I, _I], ctypes.c_longlong),
            "kan_sparse_gemm_partials": ([_I, _I, _I], ctypes.c_longlong),
        },
    ),
}

_loaded: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}     # library -> nvcc output (ptxas report)


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin, default "
        "/usr/local/cuda): the CUDA kernels cannot be built"
    )


def _lib_path(name: str) -> Path:
    src = LIBRARIES[name][0]
    h = hashlib.sha256()
    for f in (CSRC / src, CSRC / "kan_common.cuh"):
        h.update(f.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, float]:
    """Compile every missing library, all ``nvcc`` processes at once.

    Returns seconds per library built now (absent if it was cached)."""
    names = list(LIBRARIES) if names is None else list(names)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / LIBRARIES[n][0])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp, out)
    errors, seconds = [], {}
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_log[n] = log
        seconds[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n} (rc={proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building it first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all([name])
    lib = ctypes.CDLL(str(_lib_path(name)))
    for fn, (argtypes, restype) in LIBRARIES[name][1].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")

