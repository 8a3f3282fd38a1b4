"""CLI: ``python -m ps_pytorch_tpu_torch.check [options]``.

Exit codes are JAX's pscheck's: 0 = every contract holds, 1 = findings,
2 = usage error. ``--write-contract`` regenerates the committed
accounting artifact (``check/comm_contract.json``) from the current
registry and exits 0; the other rules still run first, so a broken step
cannot silently re-baseline itself.

``--device`` (default ``cuda``, as every entry point of the port) is
where the registry's steps are recorded: without a card, pass ``--device
cpu`` (on the default a card-less machine raises). ``--select
PSC111,PSC112,PSC113,PSC114`` runs the psnumerics rules alone over the
same recorded steps.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys


def _load_registry(module_name: str):
    mod = importlib.import_module(module_name)
    get = getattr(mod, "get_contracts", None)
    if get is None:
        raise AttributeError(f"registry module {module_name!r} defines no get_contracts()")
    return list(get())


def main(argv=None) -> int:
    from .core import DEFAULT_CONTRACT

    parser = argparse.ArgumentParser(
        prog="python -m ps_pytorch_tpu_torch.check",
        description="communication-contract and precision-flow checker over a "
                    "recorded step (rules PSC101-PSC114).")
    parser.add_argument("--format", choices=("text", "json"), default="text")
    parser.add_argument("--contract", default=None,
                        help=f"accounting artifact (default: {DEFAULT_CONTRACT})")
    parser.add_argument("--write-contract", action="store_true",
                        help="regenerate the accounting artifact from the current registry "
                             "and exit 0 (the other rules still run)")
    parser.add_argument("--registry", default="ps_pytorch_tpu_torch.check.contracts",
                        help="module exposing get_contracts() (default: the committed "
                             "registry)")
    parser.add_argument("--only", default=None,
                        help="comma-separated config names to record (PSC104 stale-entry "
                             "checking is skipped)")
    parser.add_argument("--select", default=None,
                        help="comma-separated rule ids to enable (default: all)")
    parser.add_argument("--list", action="store_true",
                        help="list registry config names and exit")
    parser.add_argument("--device", default="cuda",
                        help="where the steps are recorded: cuda (the kernels) or cpu (their "
                             "plain versions)")
    args = parser.parse_args(argv)

    if args.write_contract and args.only:
        print("pscheck: --write-contract cannot be combined with --only (a partial write "
              "would drop the other configs' pinned rows)", file=sys.stderr)
        return 2
    if args.write_contract and args.select:
        print("pscheck: --write-contract cannot be combined with --select (a re-baseline "
              "must clear every rule, not a subset)", file=sys.stderr)
        return 2

    selected = None
    if args.select:
        from .rules import RULE_IDS

        selected = {r.strip().upper() for r in args.select.split(",") if r.strip()}
        unknown = selected - set(RULE_IDS)
        if unknown:
            print(f"unknown rule id(s): {', '.join(sorted(unknown))}", file=sys.stderr)
            return 2

    try:
        specs = _load_registry(args.registry)
    except (ImportError, AttributeError) as e:
        print(f"pscheck: cannot load registry: {e}", file=sys.stderr)
        return 2

    names = [s.name for s in specs]
    if args.list:
        print("\n".join(names))
        return 0

    only = None
    if args.only:
        only = [n.strip() for n in args.only.split(",") if n.strip()]
        unknown = sorted(set(only) - set(names))
        if unknown:
            print(f"pscheck: unknown config(s): {', '.join(unknown)}", file=sys.stderr)
            return 2

    from .. import resolve_device
    from .core import load_contract, render_text, run_checks, trace_registry, write_contract

    device = resolve_device(args.device)
    results = trace_registry(specs, only=only, device=device)

    if args.write_contract:
        findings = run_checks(results, contract=None)
        path = args.contract or DEFAULT_CONTRACT
        if os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        write_contract(path, results)
        print(f"pscheck: wrote {len(results)} config(s) to {path}")
        if findings:
            print(render_text(findings, len(results)))
            print(f"pscheck: WARNING: the artifact was written but {len(findings)} "
                  f"non-PSC104 finding(s) remain — the contract rules above still fail",
                  file=sys.stderr)
            return 1
        return 0

    contract_path = args.contract or (DEFAULT_CONTRACT if os.path.exists(DEFAULT_CONTRACT)
                                      else None)
    contract = None
    if contract_path:
        try:
            contract = load_contract(contract_path)
        except (OSError, ValueError, KeyError) as e:
            print(f"pscheck: cannot read contract {contract_path}: {e}", file=sys.stderr)
            return 2
    findings = run_checks(results, contract, check_stale=only is None)
    if selected is not None:
        findings = [f for f in findings if f.rule in selected]

    if args.format == "json":
        print(json.dumps({
            "version": 1,
            "tool": "pscheck",
            "device": str(device),
            "configs": [r.spec.name for r in results],
            "findings": [f.to_json() for f in findings],
            "collectives": {r.spec.name: r.summary for r in results},
        }, indent=2, sort_keys=True))
    else:
        print(render_text(findings, len(results)))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
