"""Lint launcher: ``python -m repro_torch.launch.lint [paths...]``.

The launcher-flavoured front door to the port's kanlint
(``repro_torch.analysis``): runs the AST lints, the sharding audit and
the launch-budget validator, prints a per-rule summary, and exits non-zero on new
(non-baselined, non-waived) findings: the contract of ``python -m
repro_torch.analysis --check``, plus the summary table.
"""

from __future__ import annotations

import sys
from collections import Counter

from repro_torch.analysis import DEFAULT_PATHS, run_check
from repro_torch.analysis.__main__ import build_parser, card_missing, device_note


def main(argv=None) -> int:
    args = build_parser("python -m repro_torch.launch.lint").parse_args(argv)
    why = card_missing(args.device)
    if why:
        print(f"[lint] {why}", file=sys.stderr)
        return 2
    report = run_check(
        args.paths or DEFAULT_PATHS, baseline_path=args.baseline,
        kernel_validator=not args.no_kernel_validator, device=args.device,
    )
    new, old = report["new"], report["baselined"]
    for f in new:
        print(f.format())
    by_rule = Counter(f.rule for f in new)
    rules = " ".join(f"{r}={n}" for r, n in sorted(by_rule.items())) or "none"
    print(f"[lint] scanned {report['files']} files: "
          f"{len(new)} new finding(s) ({rules}), {len(old)} baselined"
          f"{device_note(args, report)}")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
