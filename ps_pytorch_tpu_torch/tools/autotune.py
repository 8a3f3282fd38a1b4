"""Autotune CLI (the port of tools/autotune.py): one command instead of
ten flags.

Searches the knob grid of a model (compress x bucket_bytes x overlap x
opt_placement x quant block x state layout x wire domain), pruning
invalid points with the PSC101-114 rules BEFORE costing them, ranking
the survivors with the trace-only cost model, and (optionally) running
short measured probes on the top-K. Writes a ranked, schema-valid
evidence record and prints the winning flag line.

  python -m ps_pytorch_tpu_torch.tools.autotune --model resnet18 --probe-top 3
      -> output/autotune/autotune_resnet18.json: every candidate recorded
         on the card, the card's profile measured there, the top 3 run
         4 real steps each
  python -m ps_pytorch_tpu_torch.tools.autotune --model resnet18 --probe-top 3 \\
      --probe ps_resnet18_int8_replicated_bucketed4096k
      -> the same, and the named int8 wire probed too (K2 on the card)
  python -m ps_pytorch_tpu_torch.tools.autotune --model lenet --trace-only \\
      --device cpu --profile PROFILE.json
      -> a CPU ranking under an explicit hardware profile

Apply the result:

  python -m ps_pytorch_tpu_torch.cli.train --config-json \\
      output/autotune/autotune_resnet18.json

On the card the profile is the card's own, measured at the start of the
search (``tune.costmodel.measure_card_profile``) unless ``--profile``
gives one; ``--ici-gbs`` / ``--dcn-gbs`` override its link figures. On
the CPU ``--profile`` is required: no hardware's figures are a default.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

DEFAULT_OUT_DIR = os.path.join("output", "autotune")


def main(argv=None) -> int:
    from ..tune import load_hardware_profile, run_search
    from ..tune.search import MODELS

    p = argparse.ArgumentParser("python -m ps_pytorch_tpu_torch.tools.autotune",
                                description="contract-guarded knob search; see the module "
                                            "docstring")
    p.add_argument("--model", required=True, choices=sorted(MODELS))
    p.add_argument("--grid", default="default", choices=("default", "smoke", "tiny"),
                   help="knob grid preset (smoke / tiny are the trimmed grids)")
    p.add_argument("--trace-only", action="store_true",
                   help="cost-model ranking only: record + rules + model, no probe")
    p.add_argument("--probe-top", type=int, default=0,
                   help="run short measured probes on the top-K modeled candidates (0 = none)")
    p.add_argument("--probe-steps", type=int, default=4, help="measured steps a probe")
    p.add_argument("--probe", default="",
                   help="comma-separated candidate names to probe beside the top-K (e.g. a "
                        "quantized wire the ranking puts lower, to measure its kernels)")
    p.add_argument("--profile", default=None,
                   help="hardware profile JSON (a HardwareProfile or an autotune record); "
                        "default on the card: measured now")
    p.add_argument("--ici-gbs", type=float, default=None, help="override the worker link GB/s")
    p.add_argument("--dcn-gbs", type=float, default=None, help="override the dcn link GB/s")
    p.add_argument("--out", default=None,
                   help=f"evidence record path (default: {DEFAULT_OUT_DIR}/autotune_<model>.json)")
    p.add_argument("--top", type=int, default=10, help="ranked rows to print")
    p.add_argument("--device", default="cuda",
                   help="where candidates are recorded and probed: cuda or cpu")
    args = p.parse_args(argv)

    probe_names = [n.strip() for n in args.probe.split(",") if n.strip()]
    if args.trace_only and (args.probe_top > 0 or probe_names):
        print("autotune: --trace-only and --probe-top / --probe are mutually exclusive",
              file=sys.stderr)
        return 2
    if args.probe_top < 0 or args.probe_steps < 1:
        print("autotune: --probe-top must be >= 0 and --probe-steps >= 1", file=sys.stderr)
        return 2

    profile = None
    if args.profile:
        profile = load_hardware_profile(args.profile, ici_gbs=args.ici_gbs,
                                        dcn_gbs=args.dcn_gbs)
    elif args.device != "cpu":
        from .. import resolve_device
        from ..check.contracts import MESH_DEVICES
        from ..tune import measure_card_profile

        preset = MODELS[args.model]
        profile = measure_card_profile(preset["network"], MESH_DEVICES,
                                       preset["probe_batch"] // MESH_DEVICES,
                                       resolve_device(args.device))
        over = {k: v for k, v in (("ici_gbs", args.ici_gbs), ("dcn_gbs", args.dcn_gbs))
                if v is not None}
        if over:
            profile = dataclasses.replace(profile, **over)
    else:
        print("autotune: a CPU search needs --profile (no hardware's figures are a default)",
              file=sys.stderr)
        return 2

    rec = run_search(args.model, grid=args.grid, profile=profile, probe_top=args.probe_top,
                     probe_steps=args.probe_steps, device=args.device, probe_names=probe_names,
                     progress=lambda msg: print(f"# {msg}", file=sys.stderr))

    out = args.out or os.path.join(DEFAULT_OUT_DIR, f"autotune_{args.model}.json")
    if os.path.dirname(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w", encoding="utf-8") as f:
        json.dump(rec, f, indent=2, sort_keys=False)
        f.write("\n")

    print(f"# {rec['n_candidates']} candidate(s) ranked, {rec['n_pruned']} pruned, "
          f"{rec['elapsed_s']}s -> {out}", file=sys.stderr)
    width = max((len(c["name"]) for c in rec["candidates"][:args.top]), default=4)
    print(f"{'rank':>4}  {'config':<{width}}  {'modeled_ms':>10}  {'comm_ms':>8}  "
          f"{'headroom':>8}  {'upd_ops':>7}")
    for c in rec["candidates"][:args.top]:
        cost = c["cost"]
        print(f"{c['rank']:>4}  {c['name']:<{width}}  {cost['modeled_step_s'] * 1e3:>10.4f}  "
              f"{cost['comm_s'] * 1e3:>8.4f}  {(cost['overlap_headroom'] or 0.0):>8.4f}  "
              f"{cost['update_path_ops']:>7}")
    if rec["best"] is not None:
        speed = rec["gate"]["modeled_speedup"]
        vs = f" ({speed}x the default's modeled cost)" if speed else ""
        print(f"# best: {rec['best']['name']}{vs}")
        print(f"# flags: {rec['best']['flag_line']}")
        print(f"# apply: python -m ps_pytorch_tpu_torch.cli.train --config-json {out}")
    return 0 if rec["n_candidates"] else 1


if __name__ == "__main__":
    sys.exit(main())
