"""CLI: ``python -m ps_pytorch_tpu_torch.lint [paths] [options]`` (the
port of lint/__main__.py: the same flags, exit codes and JSON).

Exit codes: 0 = clean (every finding baselined or none), 1 = new
findings, 2 = usage error. ``--write-baseline`` rewrites the baseline
from the current findings (pruning stale entries) and exits 0.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .axes import discover_axes
from .core import (
    apply_baseline,
    lint_paths,
    load_baseline,
    render_text,
    scanned_files,
    to_baseline_json,
)
from .rules import RULE_IDS

DEFAULT_BASELINE = "lint_baseline_torch.json"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m ps_pytorch_tpu_torch.lint",
        description="Static analysis of the PyTorch/CUDA port (rules PSL001-PSL008).",
    )
    parser.add_argument("paths", nargs="*", default=["ps_pytorch_tpu_torch"],
                        help="files or directories to lint "
                             "(default: ps_pytorch_tpu_torch)")
    parser.add_argument("--format", choices=("text", "json"), default="text")
    parser.add_argument("--baseline", default=None,
                        help=f"baseline file (default: ./{DEFAULT_BASELINE} "
                             "if present)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="report every finding, ignoring any baseline")
    parser.add_argument("--write-baseline", action="store_true",
                        help="write current findings to the baseline file "
                             "and exit 0")
    parser.add_argument("--select", default=None,
                        help="comma-separated rule ids to enable "
                             "(default: all)")
    parser.add_argument("--verbose", action="store_true",
                        help="also list stale baseline entries")
    args = parser.parse_args(argv)

    missing = [p for p in args.paths if not os.path.exists(p)]
    if missing:
        print(
            f"pslint: no such file or directory: {', '.join(missing)}",
            file=sys.stderr,
        )
        return 2
    not_python = [
        p for p in args.paths
        if os.path.isfile(p) and not p.endswith(".py")
    ]
    if not_python:
        print(
            "pslint: not a python file (a clean exit would mean nothing "
            f"was linted): {', '.join(not_python)}",
            file=sys.stderr,
        )
        return 2
    if args.write_baseline and args.select:
        print(
            "pslint: --write-baseline cannot be combined with --select "
            "(the baseline must cover every rule)",
            file=sys.stderr,
        )
        return 2

    findings = lint_paths(args.paths)
    if args.select:
        selected = {r.strip().upper() for r in args.select.split(",") if r.strip()}
        unknown = selected - set(RULE_IDS) - {"PSL000"}
        if unknown:
            print(f"unknown rule id(s): {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2
        findings = [f for f in findings if f.rule in selected]

    baseline_path = args.baseline or (
        DEFAULT_BASELINE if os.path.exists(DEFAULT_BASELINE) else None
    )

    if args.write_baseline:
        path = args.baseline or DEFAULT_BASELINE
        with open(path, "w", encoding="utf-8") as f:
            json.dump(to_baseline_json(findings), f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"pslint: wrote {len(findings)} finding(s) to {path}")
        return 0

    baseline = []
    if baseline_path and not args.no_baseline:
        try:
            baseline = load_baseline(baseline_path)
        except (OSError, ValueError, KeyError) as e:
            print(f"pslint: cannot read baseline {baseline_path}: {e}",
                  file=sys.stderr)
            return 2
    if args.select:
        # out-of-scope baseline entries are neither matchable nor stale
        # under a rule filter — keep them out of the comparison entirely
        baseline = [b for b in baseline if b.rule in selected]
    # staleness is scoped to the files this run actually scanned: an
    # entry for an unscanned path is not "stale", it is out of scope
    new, matched, stale = apply_baseline(
        findings, baseline, scanned_paths=scanned_files(args.paths)
    )

    if args.format == "json":
        axes, axes_src = discover_axes(args.paths)
        print(json.dumps(
            {
                "version": 1,
                "tool": "pslint",
                "axes": axes,
                "axes_source": axes_src,
                "findings": [f.to_json() for f in findings],
                "new": [f.to_json() for f in new],
                "baselined": len(matched),
                "stale": [f.to_json() for f in stale],
            },
            indent=2,
            sort_keys=True,
        ))
    else:
        print(render_text(new, matched, stale, verbose=args.verbose))
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
