"""Import hygiene of the port, and ``chip_smoke.py``'s refusals off the card.

``repro_torch`` runs where there is no JAX and no Triton (the GPU machine
has neither the JAX package's dependencies nor any need of them), so no
module of the port and no line of ``chip_smoke.py`` may import ``jax``,
``triton`` or anything of the JAX package ``repro``.
"""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "triton", "repro")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_source_of_the_port_imports_jax_triton_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = {str(f.relative_to(ROOT)): sorted(_imported_roots(f) & set(FORBIDDEN))
           for f in files}
    assert not {f: b for f, b in bad.items() if b}


def test_importing_every_module_loads_no_jax_triton_or_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
        "print(len(names), bad)\n" % (FORBIDDEN,)
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=ROOT, env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr
    n, bad = r.stdout.split(" ", 1)
    assert int(n) >= 20 and bad.strip() == "[]", r.stdout


# the modules the continuous paged engine added; the three serving ones are
# host bookkeeping and import not even torch
SLICE_MODULES = {"serve/scheduler.py": True, "serve/kv_pool.py": True,
                 "serve/prefix_cache.py": True, "kernels/paged_gather.py": False}


@pytest.mark.parametrize("module", sorted(SLICE_MODULES))
def test_continuous_paged_modules_import_neither_jax_nor_repro(module):
    roots = _imported_roots(PORT / module)
    assert not roots & set(FORBIDDEN)
    if SLICE_MODULES[module]:
        assert roots <= {"__future__", "dataclasses", "collections", "hashlib", "numpy"}


# the modules the integer KAN inference slice added
INT8_MODULES = ["core/quantization.py", "kernels/kan_int8_gemm.py", "kernels/bspline_lut.py",
                "kernels/kan_sparse_gemm.py", "core/kan_layer.py", "core/bspline.py"]


@pytest.mark.parametrize("module", INT8_MODULES)
def test_int8_slice_modules_import_neither_jax_nor_repro(module):
    assert not _imported_roots(PORT / module) & set(FORBIDDEN)


# the module the sampling slice added: torch and numpy integer ops only
@pytest.mark.parametrize("module", ["serve/threefry.py", "serve/speculative.py"])
def test_sampling_slice_modules_import_neither_jax_nor_repro(module):
    roots = _imported_roots(PORT / module)
    assert not roots & set(FORBIDDEN)
    assert roots <= {"__future__", "dataclasses", "numpy", "torch", "repro_torch"}


# the modules the GPipe and cost-model slice added: torch and the port only
@pytest.mark.parametrize("module", ["train/pipeline.py", "models/costs.py"])
def test_pipeline_and_costs_modules_import_neither_jax_nor_repro(module):
    roots = _imported_roots(PORT / module)
    assert not roots & set(FORBIDDEN)
    assert roots <= {"__future__", "math", "typing", "torch", "repro_torch"}


# the modules the kanlint slice added: the standard library, torch and the port
@pytest.mark.parametrize("module", ["analysis/__init__.py", "analysis/__main__.py",
                                    "analysis/findings.py", "analysis/ast_rules.py",
                                    "analysis/kernel_configs.py", "launch/lint.py",
                                    "kernels/plan.py"])
def test_kanlint_modules_import_neither_jax_nor_repro(module):
    roots = _imported_roots(PORT / module)
    assert not roots & set(FORBIDDEN)
    assert roots <= {"__future__", "argparse", "ast", "collections", "ctypes", "dataclasses",
                     "json", "os", "re", "sys", "torch", "repro_torch"}


def test_chip_smoke_sampling_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 6c's checks at the reduced width on the kernels' plain versions
    (every launch count 0): the threefry answers, seven sampled runs, a
    preemption, a trim that frees blocks, streams equal across runs.  Its
    many small torch ops run on one thread: on all the cores each of the
    suite's parallel workers would spin against the others (951.6 s in a
    6-worker run of the suite against ~20 s alone)."""
    import numpy as np
    import torch

    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    from repro_torch import configs

    cfg = configs.get_reduced("kanformer-100m").model
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = chip_smoke.sampling_path(torch, np, device="cpu", cfg=cfg)
    finally:
        torch.set_num_threads(threads)
    assert out["threefry"]["bits_equal_cpu"] and out["divergences"] == []
    assert out["runs"]["paged_preempt"]["n_preemptions"] >= 1
    assert out["runs"]["spec_paged_blocks4"]["blocks_freed_by_trims"] >= 1
    assert out["sampled_share"] >= chip_smoke.MIN_SAMPLED_SHARE


def test_every_csrc_source_is_built_by_one_library():
    from repro_torch.kernels import build

    sources = {src for src, _ in build.LIBRARIES.values()}
    assert sources == {p.name for p in (PORT / "kernels" / "csrc").glob("*.cu")}
    assert len(sources) == 6


def _smoke(cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                          text=True, timeout=300, cwd=cwd,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_chip_smoke_fails_without_a_card_and_prints_no_result():
    r = _smoke(ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "no CUDA device" in r.stderr


def test_chip_smoke_int8_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 7's checks run on the kernels' plain versions at a narrow
    width (on the CPU the wrappers launch nothing, so every count is 0)."""
    import numpy as np
    import torch

    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke

    out = chip_smoke.int8_path(torch, np, device="cpu", layers=(96, 32, 10), rows=64)
    assert out["rom_tables_checked"] == 7 and out["sparse_int8_cases"] == 18
    assert set(out["runs"]) == {"int8_2048", "int8_8", "fp32_auto_2048", "fp32_auto_8",
                                "lut_2048"}
    assert 0.5 <= out["top1_agreement"] <= 1.0 and out["fp32_kernel_vs_plain_err"] == 0.0


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _smoke(tmp_path)
    assert r.returncode != 0 and '"ok"' not in r.stdout


# the modules the mesh serving slice added
MESH_MODULES = ["dist/sharding.py", "launch/mesh.py", "analysis/sharding_audit.py"]


@pytest.mark.parametrize("module", MESH_MODULES)
def test_mesh_modules_import_neither_jax_nor_repro(module):
    assert not _imported_roots(PORT / module) & set(FORBIDDEN)


# the modules the mesh training slice added
MESH_TRAIN_MODULES = ["launch/elastic.py", "launch/train.py", "checkpoint/store.py",
                      "optim/adamw.py", "train/step.py"]


@pytest.mark.parametrize("module", MESH_TRAIN_MODULES)
def test_mesh_training_modules_import_neither_jax_nor_repro(module):
    assert not _imported_roots(PORT / module) & set(FORBIDDEN)
