"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` source becomes one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), compiled for
``sm_90a`` without fast math.  Libraries are built at first use into
``build/repro_torch_kernels/`` at the root of the checkout, named by a hash
of the sources and flags, so an unchanged tree reuses them.  All missing
libraries are compiled in parallel, one ``nvcc`` process per source.  A
failed build raises; nothing falls back.  ``build_log`` keeps what
``nvcc`` printed (``ptxas``: registers, spills and shared memory per
kernel), also for a library built earlier: each library's log is kept
beside it (``<library>-<hash>.log``) and read back when it is loaded.
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
# libraries whose many template instances nvcc optimises on every core: the
# two longest builds, ~76 and ~41 s alone, ~35 and ~22 s so, with SASS and
# ptxas reports identical to the serial build's (CUDA 12.8, H100 host of 8
# cores); ``kan_int8_gemm``'s SASS differs that way, so it stays serial
SPLIT_COMPILE = {"kan_fused_gemm": ["--split-compile=0"],
                 "kan_sparse_gemm": ["--split-compile=0"]}

# library name -> (source, exported C functions -> (ctypes argtypes, restype));
# each library exports ``<name>_plan``, the launch plan its launcher uses
# (``kan_common.cuh``: PlanField; ``PLAN_INTS`` ints), which
# ``repro_torch.analysis.kernel_configs`` holds against ``ops.KERNELS``
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIBRARIES = {
    "kan_fused_gemm": (
        "kan_fused_gemm.cu",
        {
            "kan_fused_gemm": (
                [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _I, _P], _I),
            "kan_fused_gemm_tickets": ([_I, _I], ctypes.c_longlong),
            "kan_fused_gemm_partials": ([_I, _I, _I], ctypes.c_longlong),
            "kan_fused_gemm_plan": ([_I] * 8 + [_P], _I),
        },
    ),
    "kan_sparse_gemm": (
        "kan_sparse_gemm.cu",
        {
            "kan_sparse_gemm": (
                [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _I, _P], _I),
            "kan_sparse_gemm_tickets": ([_I, _I], ctypes.c_longlong),
            "kan_sparse_gemm_partials": ([_I, _I, _I], ctypes.c_longlong),
            "kan_sparse_gemm_plan": ([_I] * 8 + [_P], _I),
        },
    ),
    "paged_gather": (
        "paged_gather.cu",
        {"paged_gather": ([_P, _I, _P, _I, _I, _P], _I),
         "paged_gather_plan": ([_P, _I, _I, _I, _P], _I)},
    ),
    "kan_int8_gemm": (
        "kan_int8_gemm.cu",
        {
            "kan_int8_gemm": (
                [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P], _I),
            "kan_int8_gemm_tickets": ([_I, _I], ctypes.c_longlong),
            "kan_int8_gemm_accumulators": ([_I, _I, _I], ctypes.c_longlong),
            "kan_int8_gemm_plan": ([_I] * 8 + [_P], _I),
        },
    ),
    "kan_sparse_int8_gemm": (
        "kan_sparse_int8_gemm.cu",
        {
            "kan_sparse_int8_gemm": (
                [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P], _I),
            "kan_sparse_int8_gemm_tickets": ([_I, _I], ctypes.c_longlong),
            "kan_sparse_int8_gemm_accumulators": ([_I, _I, _I], ctypes.c_longlong),
            "kan_sparse_int8_gemm_plan": ([_I] * 7 + [_P], _I),
        },
    ),
    "bspline_lut": (
        "bspline_lut.cu",
        {"bspline_lut": ([_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P], _I),
         "bspline_lut_plan": ([_I, _I, _I, _P], _I)},
    ),
}

PLAN_INTS = 16                 # kan_common.cuh: kPlanInts

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
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS + SPLIT_COMPILE.get(name, [])).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, float]:
    """Compile every missing library, all ``nvcc`` processes at once.

    Returns each library's own ``nvcc`` seconds, from the common start to
    the end of its process (absent if it was cached)."""
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
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, *SPLIT_COMPILE.get(n, []), "-o", str(tmp),
               str(CSRC / LIBRARIES[n][0])]
        log = open(f"{tmp}.log", "w+")          # a file, not a pipe: nothing blocks nvcc
        procs[n] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), log, tmp, out)
    seconds = {}
    while len(seconds) < len(procs):      # each process's end, to 50 ms
        for n, (proc, *_) in procs.items():
            if n not in seconds and proc.poll() is not None:
                seconds[n] = time.perf_counter() - t0
        time.sleep(0.05)
    errors = []
    for n, (proc, log, tmp, out) in procs.items():
        log.seek(0)
        build_log[n] = log.read()
        log.close()
        if proc.returncode != 0:
            os.remove(log.name)
            errors.append(f"nvcc failed for {n} (rc={proc.returncode}):\n{build_log[n]}")
            continue
        os.replace(log.name, out.with_suffix(".log"))
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
    log_of(name)
    lib = ctypes.CDLL(str(_lib_path(name)))
    for fn, (argtypes, restype) in LIBRARIES[name][1].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    _loaded[name] = lib
    return lib


def log_of(name: str) -> str:
    """The ``nvcc`` output of library ``name``: this process's build, else
    the log kept beside the library ("" if there is none)."""
    if name not in build_log:
        try:
            build_log[name] = _lib_path(name).with_suffix(".log").read_text()
        except OSError:
            return ""
    return build_log[name]


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")

