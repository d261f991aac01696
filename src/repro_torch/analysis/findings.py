"""Finding model, inline waivers, and the checked-in baseline (kanlint).

The port's copy of ``repro/analysis/findings.py``, with the same
behaviour, JSON and keys: a baseline either package writes, the other
reads.  Every rule in ``repro_torch.analysis`` reports :class:`Finding`s:
``file:line``, a stable rule id (``KL1xx`` AST lints, ``KL2xx`` kernel
launch budgets), a one-line message, and a fix hint.  Two suppression
mechanisms:

* **pragma**: a ``# kanlint: ignore[KL102]`` comment on the flagged line
  waives that rule there (for findings that are correct by intent, e.g. a
  deliberate per-chunk read, with the reason on the line);
* **baseline**: a checked-in JSON file of accepted pre-existing finding
  keys; the check fails only on findings NOT in it.  Keys are line-number
  independent (``rule:path:message``) so unrelated edits don't churn the
  baseline.
"""

from __future__ import annotations

import dataclasses
import json
import re


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str       # "KL101"
    path: str       # repo-relative, posix separators
    line: int       # 1-based
    message: str
    hint: str

    @property
    def key(self) -> str:
        """Baseline identity: deliberately excludes the line number so the
        baseline survives edits above the finding."""
        return f"{self.rule}:{self.path}:{self.message}"

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}" + (
            f"  [fix: {self.hint}]" if self.hint else ""
        )


_PRAGMA = re.compile(r"#\s*kanlint:\s*ignore\[([A-Z0-9,\s]+)\]")


def file_pragmas(source: str) -> dict[int, set[str]]:
    """line (1-based) -> set of waived rule ids on that line."""
    out: dict[int, set[str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _PRAGMA.search(line)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


def apply_pragmas(
    findings: list[Finding], pragmas_by_path: dict[str, dict[int, set[str]]]
) -> list[Finding]:
    kept = []
    for f in findings:
        waived = pragmas_by_path.get(f.path, {}).get(f.line, set())
        if f.rule not in waived:
            kept.append(f)
    return kept


def load_baseline(path: str) -> set[str]:
    """Accepted finding keys; a missing file is an empty baseline."""
    try:
        with open(path) as fh:
            data = json.load(fh)
    except OSError:
        return set()
    if not isinstance(data, dict):
        return set()
    keys = data.get("findings", [])
    return {k for k in keys if isinstance(k, str)}


def save_baseline(path: str, findings: list[Finding]) -> None:
    with open(path, "w") as fh:
        json.dump(
            {"findings": sorted({f.key for f in findings})}, fh, indent=1
        )
        fh.write("\n")


def split_baselined(
    findings: list[Finding], baseline: set[str]
) -> tuple[list[Finding], list[Finding]]:
    """-> (new findings that must fail CI, accepted baselined findings)."""
    new, old = [], []
    for f in findings:
        (old if f.key in baseline else new).append(f)
    return new, old
