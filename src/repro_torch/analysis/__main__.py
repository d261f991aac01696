"""CLI: ``python -m repro_torch.analysis --check [paths]``.

Exit codes: 0 clean (or all findings baselined or waived), 1 new findings,
2 usage error (``--device cuda``, the default, without a card included).
``--update-baseline`` rewrites the baseline to the current finding set
(the sanctioned way to accept pre-existing debt: shrink it, never grow it
casually; DESIGN.md section 8).
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.analysis import DEFAULT_BASELINE, DEFAULT_PATHS, run_check


def build_parser(prog: str = "python -m repro_torch.analysis") -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog=prog)
    ap.add_argument("paths", nargs="*", default=DEFAULT_PATHS,
                    help="files/directories to lint (default: src/repro_torch)")
    ap.add_argument("--check", action="store_true",
                    help="explicit check mode (the default; kept so invocations read as "
                         "intent)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help=f"baseline file (default: {DEFAULT_BASELINE})")
    ap.add_argument("--update-baseline", action="store_true",
                    help="accept current findings into the baseline")
    ap.add_argument("--no-kernel-validator", action="store_true",
                    help="skip the KL2xx launch-budget checks")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default): also hold every launch plan to its library's "
                         "export and ptxas report on the card; cpu: the static rules and "
                         "the registry half only")
    return ap


def card_missing(device: str) -> str | None:
    """Why ``--device`` cannot be served here, or None."""
    if device != "cuda":
        return None
    import torch

    if not torch.cuda.is_available():
        return "--device cuda needs a CUDA card (use --device cpu for the static half)"
    return None


def device_note(args, report: dict) -> str:
    if args.no_kernel_validator:
        return ""
    card = report["card"]
    if card is None:
        return "; the card half of KL2xx did not run (--device cpu)"
    return f"; the card half held {card['plans']} plans to their exports"


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    why = card_missing(args.device)
    if why:
        print(f"[kanlint] {why}", file=sys.stderr)
        return 2
    report = run_check(
        args.paths or DEFAULT_PATHS, baseline_path=args.baseline,
        kernel_validator=not args.no_kernel_validator, device=args.device,
    )
    new, old = report["new"], report["baselined"]
    if args.update_baseline:
        from repro_torch.analysis.findings import save_baseline

        save_baseline(args.baseline, new + old)
        print(f"[kanlint] baseline updated: {len(new + old)} finding(s) "
              f"-> {args.baseline}")
        return 0
    for f in new:
        print(f.format())
    print(f"[kanlint] {report['files']} files: {len(new)} new finding(s), "
          f"{len(old)} baselined{device_note(args, report)}")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
