"""Sharding-contract audit (kanlint KL105), the counterpart of
``repro/analysis/sharding_audit.py`` in torch terms.

The mesh serving contract: every public cache-mutating entry point of the
model layer (``models/``) threads a ``ShardingCtx`` (a ``shard``
parameter), since on a mesh a cache write must know which rows, blocks
and KV heads this rank holds: a write that does not would land in another
rank's rows, or in every rank's copy of a block only one of them owns.

The audit is syntactic: for every public module-level function of a
``models/`` module that takes a cache-like parameter (``cache``,
``caches``, ``cache_ckv``, ``pool``, ``pools``), require a ``shard``
parameter.  A function a mesh never reaches (the engine refuses its path
on a mesh, or nothing calls it) is allowlisted by a ``# kanlint:
ignore[KL105]`` pragma with the reason, which the reference's linter reads
too; the finding's message is the reference's, so baselines cross.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.findings import Finding

CACHE_PARAMS = {"cache", "caches", "cache_ckv", "pool", "pools"}


def _audited(path: str) -> bool:
    return "models" in path.split("/")


def audit_source(source: str, path: str) -> list[Finding]:
    if not _audited(path):
        return []
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return []                    # ast_rules reports the parse error
    out: list[Finding] = []
    for node in tree.body:           # module-level defs only
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if node.name.startswith("_"):
            continue                 # private helpers: their callers thread it
        params = {a.arg for a in node.args.args + node.args.kwonlyargs}
        if not params & CACHE_PARAMS or "shard" in params:
            continue
        out.append(Finding(
            "KL105", path, node.lineno,
            f"public cache-mutating entry point '{node.name}' neither threads "
            f"ShardingCtx nor is allowlisted",
            "add a shard=None parameter and write only this rank's rows, blocks and KV "
            "heads, or a '# kanlint: ignore[KL105] (reason)' pragma where no mesh "
            "reaches it",
        ))
    return out
