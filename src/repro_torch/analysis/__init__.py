"""kanlint for the port: static analysis and launch-budget checks.

The counterpart of ``repro/analysis`` (DESIGN.md section 8), with each rule
meaning in PyTorch and CUDA what it means there:

* **KL1xx AST lints** (``ast_rules.py``): KL100 (the source does not
  parse), KL102 (host syncs in the serving and training loops), KL103
  (float64 on a device path); and KL105 (``sharding_audit.py``: a public
  cache-mutating ``models/`` entry point threads the mesh's
  ``ShardingCtx``);
* **KL2xx launch budgets** (``kernel_configs.py``): every CUDA launcher's
  plan (``kernels/ops.py: KERNELS``) over a problem suite against the
  card's shared memory, alignment and grid limits, and coverage of the
  built libraries; on the card also each plan against the library's own
  ``<library>_plan`` export, and registers and spills from ``ptxas``.

Entry points: ``python -m repro_torch.analysis --check [paths]`` and
``python -m repro_torch.launch.lint``.  Suppression as in the reference:
``# kanlint: ignore[KLxxx]`` pragmas on the flagged line (with the reason),
and the checked-in ``kanlint.baseline.json``; the check fails only on
findings in neither.  Exit codes: 0 clean, 1 new findings, 2 usage error
(``--device cuda`` without a card included).

Not ported, for want of a torch meaning (ROADMAP.md): KL101, KL104 and the
retrace sentinel (tracing; they come with CUDA graphs), and the
autotuner's candidate spaces and measurement cache (with the tile
autotuner).
"""

from __future__ import annotations

import os

DEFAULT_BASELINE = "kanlint.baseline.json"
DEFAULT_PATHS = ["src/repro_torch"]


def collect_py_files(paths: list[str]) -> list[str]:
    out: list[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(
                d for d in dirs
                if d not in ("__pycache__", ".git") and not d.startswith(".")
            )
            out.extend(
                os.path.join(root, f) for f in sorted(files)
                if f.endswith(".py")
            )
    return out


def _rel(path: str) -> str:
    rel = os.path.relpath(path)
    return (path if rel.startswith("..") else rel).replace(os.sep, "/")


def run_check(
    paths: list[str],
    baseline_path: str | None = None,
    kernel_validator: bool = True,
    device: str = "cpu",
) -> dict:
    """Run every rule family; returns a report dict: ``{"new": [Finding],
    "baselined": [Finding], "files": int, "card": dict | None}``.
    ``device="cuda"`` adds the card half of KL2xx (``card``: its rows and
    the number of plans held to the exports); the caller checks that a
    card is there."""
    from repro_torch.analysis import ast_rules, findings, sharding_audit

    all_findings = []
    pragmas_by_path: dict[str, dict] = {}
    files = collect_py_files(paths)
    for path in files:
        rel = _rel(path)
        try:
            with open(path, encoding="utf-8") as fh:
                source = fh.read()
        except (OSError, UnicodeDecodeError):
            continue
        pragmas_by_path[rel] = findings.file_pragmas(source)
        all_findings.extend(ast_rules.lint_source(source, rel))
        all_findings.extend(sharding_audit.audit_source(source, rel))
    card = None
    if kernel_validator:
        from repro_torch.analysis import kernel_configs

        all_findings.extend(kernel_configs.validate_registry())
        if device == "cuda":
            import torch

            card = kernel_configs.validate_card(torch)
            all_findings.extend(card["findings"])
    kept = findings.apply_pragmas(all_findings, pragmas_by_path)
    baseline = findings.load_baseline(baseline_path or DEFAULT_BASELINE)
    new, old = findings.split_baselined(kept, baseline)
    return {"new": new, "baselined": old, "files": len(files), "card": card}
