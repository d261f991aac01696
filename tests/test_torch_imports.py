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


def _smoke(cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                          text=True, timeout=300, cwd=cwd,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_chip_smoke_fails_without_a_card_and_prints_no_result():
    r = _smoke(ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "no CUDA device" in r.stderr


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _smoke(tmp_path)
    assert r.returncode != 0 and '"ok"' not in r.stdout
