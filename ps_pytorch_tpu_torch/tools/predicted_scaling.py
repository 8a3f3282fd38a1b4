"""Predicted multi-card scaling from the recorded PS step (the port of
tools/predicted_scaling.py; imports no JAX).

For each (worker count, compression mode) this records one REAL PS train
step at ``n`` stacked workers (``check/walker.record_step`` over the step
``check/contracts._cnn_ps_built`` builds, ``--batch`` images a worker),
reads each collective's kind, count and per-device bytes from the tape,
and folds them through the JAX tool's alpha-beta ring model to predict
the per-step collective cost and scaling efficiency.

What is measured vs modeled:
  measured  collective kinds / counts / per-device payload bytes, from
            the recorded step (the tape's axis calls and the kernels'
            declared reductions; ``check/walker.py``). A kernel node whose
            pieces come in runs of ``rows`` (one value cut into host
            groups) declares one collective a run, so a grid-wide
            collective counts once with its groups' bytes summed. The
            tape holds a collective's operand share; a row holds JAX's
            record's bytes, the buffer the ring redistributes: an
            all-gather's result, g times its operand (a reduce-scatter
            keeps its operand, where JAX's HLO gives its 1/g result; no
            mode records one). Gradient payloads do not depend on the
            batch.
  modeled   link time per collective, PER AXIS, as JAX's tool models
            it. The physical layout is hosts of 8 cards (JAX's v5e
            host; an HGX H100 host's 8 GPUs): a flat mode's one axis is
            one group of n spanning ceil(n / 8) hosts; the hierarchical
            mode's ICI axis is a group inside one host, its DCN axis
            ``hosts`` groups of one card a host, its tuple axis all n.
            Ring factors at the group size g: all-reduce 2(g-1)/g * S,
            gather / scatter / all-to-all (g-1)/g * S, permute S; a
            group inside a host costs S * factor / --ici-gbs, one across
            h hosts max(t_ici, t_dcn) with (per_host / c) groups sharing
            a host's NIC (c = g / h). Compute at n workers = t1 / n
            (fixed global batch, the reference's normalization).

No figure defaults. The rates come from ``--profile PATH`` (a
``tune.costmodel`` hardware profile or an autotune record; ``--ici-gbs``
/ ``--dcn-gbs`` override it) or from ``--ici-gbs`` and ``--dcn-gbs``
both given. ``t1`` comes from ``--t1``; on the card without it, it is
measured: one worker's uncompressed PS step of the network at b=1024,
f32 (``tune.costmodel._single_worker_step_s``; TF32 off, as the port's
tools run). Without rates, or on the CPU without ``--t1``, the tool
exits 2 naming what is missing. The report's ``model`` names every
input's source: "given" or "measured on <card>, <power limit>".

Each mode's collective kinds are held against the port's pscheck
contract (``check/comm_contract.json``; PSC104's artifact) for the
matching config: a kind on one side only exits 1, as does a row that
failed to record.

    python -m ps_pytorch_tpu_torch.tools.predicted_scaling --workers 8 16 32 \\
        --ici-gbs 450 --dcn-gbs 50 --out runs/predicted_scaling_h100.json
    python -m ps_pytorch_tpu_torch.tools.predicted_scaling --device cpu --network LeNet \\
        --workers 8 --t1 0.01 --ici-gbs 450 --dcn-gbs 50
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import torch

from ..parallel.mesh import DCN_AXIS, WORKER_AXIS

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTRACT = os.path.join(PKG, "check", "comm_contract.json")

# cards a host: JAX's v5e host, and an HGX H100 host's 8 GPUs
HOST_CARDS = 8
# a failure entry that is a deliberate skip, not a failed recording
SKIP = "skipped: "

# mode name -> PSConfig knobs. "hier" is the hierarchical DCN x ICI wire
# (dcn_hosts > 1): ICI reduce-scatter -> one int8 DCN crossing -> ICI
# all-gather, on max(2, n // 8) hosts
MODES = {
    "none": dict(compress=None),
    "int8": dict(compress="int8"),
    "int8_2round": dict(compress="int8_2round"),
    "hier_2round": dict(compress="int8_2round", hier=True),
}

# each mode's pscheck contract config: the recorded kinds must agree
MODE_CONTRACT_CONFIG = {
    "none": "ps_none_replicated",
    "int8": "ps_int8_replicated",
    "int8_2round": "ps_int8_2round_replicated",
    "hier_2round": "ps_hier_int8_2round_replicated",
}

# the walker's collective kind -> the name JAX's record gives it (the
# compiled HLO op's)
_JAXPR_TO_HLO_KIND = {
    "psum": "all-reduce",
    "pmax": "all-reduce",
    "pmin": "all-reduce",
    "all_gather": "all-gather",
    "psum_scatter": "reduce-scatter",
    "all_to_all": "all-to-all",
    "ppermute": "collective-permute",
}

# ring step-count factors per collective kind (the bytes multiplier):
# all-reduce moves every byte twice minus the 1/n it keeps; one-shot
# redistributions move (n-1)/n
_RING_FACTOR = {
    "all-reduce": lambda n: 2 * (n - 1) / n,
    "all-gather": lambda n: (n - 1) / n,
    "reduce-scatter": lambda n: (n - 1) / n,
    "all-to-all": lambda n: (n - 1) / n,
    "collective-permute": lambda n: 1.0,
}


def contract_cross_check(rows: list, contract: dict) -> dict:
    """Each row's collective-kind set against the pscheck contract entry
    for its mode; ok=None marks rows with no contract entry."""
    results = []
    for row in rows:
        cfg_name = MODE_CONTRACT_CONFIG.get(row["mode"])
        cfg = contract.get("configs", {}).get(cfg_name) if cfg_name else None
        if cfg is None:
            results.append({
                "workers": row["workers"], "mode": row["mode"],
                "config": cfg_name, "ok": None,
                "error": "no pscheck contract entry for this mode",
            })
            continue
        expected = sorted({
            _JAXPR_TO_HLO_KIND.get(c["kind"], c["kind"])
            for c in cfg.get("collectives", [])
        })
        measured = sorted(row.get("by_kind", {}))
        results.append({
            "workers": row["workers"], "mode": row["mode"],
            "config": cfg_name, "expected_kinds": expected,
            "measured_kinds": measured, "ok": expected == measured,
        })
    return {
        "ok": all(r["ok"] is not False for r in results),
        "results": results,
    }


def hosts_for(n: int, mode: str) -> int:
    return max(2, n // HOST_CARDS) if MODES[mode].get("hier") else 1


def group_of(axes, n: int, hosts: int) -> tuple:
    """(group size g, hosts spanned h) of a collective over ``axes``."""
    if hosts <= 1:
        return n, math.ceil(n / HOST_CARDS)
    if tuple(axes) == (DCN_AXIS,):
        return hosts, hosts          # one card of each host
    if tuple(axes) == (WORKER_AXIS,):
        return n // hosts, 1         # one host's cards
    return n, hosts                  # the grid's tuple axis


def row_from_tape(tape, n: int, mode: str, hosts: int) -> dict:
    """One row (JAX's child row) from a recorded step's tape: by kind, by
    (kind, g, h) class, and the kernel nodes the step ran."""
    per_host = (n // hosts) if hosts > 1 else min(n, HOST_CARDS)
    by_kind: dict = {}
    by_class: dict = {}
    kernel_nodes: dict = {}
    for node in tape.nodes:
        if node.op == "kernel":
            key = f"{node.kernel}:{node.name}"
            kernel_nodes[key] = kernel_nodes.get(key, 0) + 1
        runs = max(1, (node.info or {}).get("rows") or 1) if node.op == "kernel" else 1
        groups: dict = {}
        for p in node.payloads:
            groups.setdefault((p.kind, tuple(p.axes)), []).append(p.bytes)
        for (kind, axes), sizes in groups.items():
            hlo = _JAXPR_TO_HLO_KIND.get(kind, kind)
            g, h = group_of(axes, n, hosts)
            # the ring factor takes S as the whole buffer, as JAX's record
            # gives it: a gather's result, g of the tape's operand shares
            nbytes = sum(sizes) * (g if hlo == "all-gather" else 1)
            count = math.ceil(len(sizes) / runs)
            k = by_kind.setdefault(hlo, {"count": 0, "bytes": 0})
            k["count"] += count
            k["bytes"] += nbytes
            cls = by_class.setdefault(f"{hlo}|g{g}|h{h}", {
                "kind": hlo, "g": g, "h": h, "count": 0, "bytes": 0})
            cls["count"] += count
            cls["bytes"] += nbytes
    return {
        "workers": n, "mode": mode, "hosts": hosts,
        "per_host_model": per_host,
        "by_kind": by_kind,
        "by_class": by_class,
        "total_collective_bytes": sum(k["bytes"] for k in by_kind.values()),
        "n_collectives": sum(k["count"] for k in by_kind.values()),
        "kernel_nodes": dict(sorted(kernel_nodes.items())),
    }


def record_row(n: int, mode: str, network: str, batch: int, device) -> dict:
    """Record one real PS step at ``n`` stacked workers and read its row."""
    from ..check import walker
    from ..check.contracts import _cnn_ps_built
    from ..parallel.ps import PSConfig

    hosts = hosts_for(n, mode)
    cfg = PSConfig(num_workers=n, compress=MODES[mode]["compress"], dcn_hosts=hosts)
    built = _cnn_ps_built(cfg, network, 0, device, batch_per_worker=batch)
    t0 = time.perf_counter()
    tape, _ = walker.record_step(built.step, *built.args, devices=built.devices,
                                 **built.kwargs)
    row = row_from_tape(tape, n, mode, hosts)
    row["record_seconds"] = round(time.perf_counter() - t0, 3)
    return row


def predict(row: dict, t1: float, bw: float, dcn_bw: float | None = None) -> dict:
    """Fold one row through the alpha-beta model (JAX's arithmetic).

    With per-group axis classes (``row["by_class"]``: group size g and
    hosts spanned h per collective), the per-axis model applies: factors
    at g, intra-host classes on the ICI bandwidth, cross-host classes on
    the per-host DCN NIC with (per_host / c) groups sharing it (c = g/h
    cards of each group a host), pipelined-ring bottleneck max(ici, dcn).
    Without by_class it falls back to the flat single-bandwidth model at
    the total card count."""
    n = row["workers"]
    ici_s = dcn_s = 0.0
    if row.get("by_class") and dcn_bw:
        per_host = row.get("per_host_model") or min(n, 8)
        comm = 0.0
        for cls in row["by_class"].values():
            g, h = cls["g"], cls["h"]
            factor = _RING_FACTOR.get(cls["kind"], lambda k: 2 * (k - 1) / k)(g)
            link_bytes = cls["bytes"] * factor
            if h <= 1:
                t = link_bytes / bw
                ici_s += t
            else:
                c = max(1, g // h)
                t_dcn = (per_host / c) * link_bytes / dcn_bw
                # c == 1: every ring edge crosses hosts, no ICI segment
                t_ici = link_bytes / bw if c > 1 else 0.0
                t = max(t_ici, t_dcn)
                # the bottleneck leg takes the time: on a fast fabric the
                # cross-host ring can be ICI-bound
                if t_dcn >= t_ici:
                    dcn_s += t
                else:
                    ici_s += t
            comm += t
    else:
        comm = 0.0
        for kind, st in row["by_kind"].items():
            factor = _RING_FACTOR.get(kind, lambda k: 2 * (k - 1) / k)(n)
            comm += st["bytes"] * factor / bw
        ici_s = comm
    compute = t1 / n
    return {
        **row,
        "modeled_comm_s": round(comm, 6),
        "modeled_comm_ici_s": round(ici_s, 6),
        "modeled_comm_dcn_s": round(dcn_s, 6),
        "modeled_compute_s": round(compute, 6),
        "speedup_no_overlap": round(t1 / (compute + comm), 2),
        "speedup_full_overlap": round(t1 / max(compute, comm), 2),
        "efficiency_no_overlap": round(t1 / (compute + comm) / n, 4),
        "efficiency_full_overlap": round(t1 / max(compute, comm) / n, 4),
    }


def _rates(args) -> tuple:
    """(ici GB/s, its source, dcn GB/s, its source), or the missing inputs."""
    if args.profile:
        from ..tune.costmodel import load_hardware_profile

        prof = load_hardware_profile(args.profile, ici_gbs=args.ici_gbs,
                                     dcn_gbs=args.dcn_gbs)
        src = f"profile {args.profile} ({prof.name}; {prof.source})"
        return (prof.ici_gbs, "given: --ici-gbs" if args.ici_gbs else src,
                prof.dcn_gbs, "given: --dcn-gbs" if args.dcn_gbs else src), []
    missing = [f for f, v in (("--ici-gbs", args.ici_gbs), ("--dcn-gbs", args.dcn_gbs))
               if v is None]
    if missing:
        return None, missing
    return (args.ici_gbs, "given: --ici-gbs", args.dcn_gbs, "given: --dcn-gbs"), []


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("ps_pytorch_tpu_torch.tools.predicted_scaling",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workers", type=int, nargs="+", default=[8, 16, 32])
    p.add_argument("--modes", nargs="+", default=list(MODES), choices=list(MODES))
    p.add_argument("--network", default="ResNet18", choices=["LeNet", "ResNet18"])
    p.add_argument("--batch", type=int, default=8,
                   help="per-worker batch (payloads are batch-independent)")
    p.add_argument("--profile", default=None,
                   help="hardware profile JSON (tune.costmodel) or autotune record: "
                        "the link rates")
    p.add_argument("--ici-gbs", type=float, default=None,
                   help="one-way per-link GB/s inside a host (no default)")
    p.add_argument("--dcn-gbs", type=float, default=None,
                   help="one-way GB/s of a host's NIC (no default)")
    p.add_argument("--t1", type=float, default=None,
                   help="single-card step seconds at the global batch; on the card "
                        "measured when not given, on the CPU required")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--out", default=None)
    p.add_argument("--contract", default=None,
                   help="pscheck contract to cross-check the kinds against "
                        "(default: the port's check/comm_contract.json)")
    args = p.parse_args(argv)

    rates, missing = _rates(args)
    if args.device == "cpu" and args.t1 is None:
        missing.append("--t1 (only the card measures it)")
    if missing:
        print("predicted_scaling: no figure defaults; missing: " + ", ".join(missing),
              file=sys.stderr)
        raise SystemExit(2)
    from .. import resolve_device

    dev = resolve_device(args.device)
    ici_gbs, ici_src, dcn_gbs, dcn_src = rates
    if args.t1 is not None:
        t1, t1_src = args.t1, "given: --t1"
    else:
        from ..tune.costmodel import _single_worker_step_s, card_identity

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ident = card_identity()
        t1 = _single_worker_step_s(args.network, 1024, dev)
        t1_src = (f"measured on {ident['name']}, {ident['power_limit']}: one worker's "
                  f"uncompressed PS step of {args.network} at b=1024, f32, TF32 off "
                  "(tune.costmodel._single_worker_step_s, median of 5)")

    rows, failures = [], []
    for n in args.workers:
        for mode in args.modes:
            if MODES[mode].get("hier") and n < 4:
                failures.append({"workers": n, "mode": mode,
                                 "error": SKIP + "hier needs >=4 cards (2 hosts x 2)"})
                continue
            try:
                row = record_row(n, mode, args.network, args.batch, dev)
            except Exception as e:  # a failed recording is a row of failures
                failures.append({"workers": n, "mode": mode, "error": repr(e)[-500:]})
                continue
            finally:
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
            rows.append(predict(row, t1, ici_gbs * 1e9, dcn_bw=dcn_gbs * 1e9))
            print(f"# {n} workers / {mode}: "
                  f"{row['total_collective_bytes'] / 1e6:.2f} MB wire, "
                  f"{rows[-1]['speedup_no_overlap']}x-"
                  f"{rows[-1]['speedup_full_overlap']}x, kernel nodes "
                  f"{row['kernel_nodes']}", file=sys.stderr)

    contract_path = args.contract or CONTRACT
    contract_block = None
    if os.path.exists(contract_path):
        with open(contract_path) as f:
            contract_block = contract_cross_check(rows, json.load(f))
        contract_block["path"] = os.path.relpath(contract_path, os.path.dirname(PKG))
        for r in contract_block["results"]:
            if r["ok"] is False:
                print(f"# CONTRACT MISMATCH {r['workers']} workers / {r['mode']}: "
                      f"recorded kinds {r['measured_kinds']} != pscheck contract kinds "
                      f"{r['expected_kinds']} ({r['config']})", file=sys.stderr)
    elif args.contract:
        print(f"# contract {args.contract} not found; cross-check skipped",
              file=sys.stderr)

    report = {
        "contract_check": contract_block,
        "model": {
            "t1_seconds": t1, "t1_source": t1_src,
            "ici_gbs_one_way": ici_gbs, "ici_source": ici_src,
            "dcn_gbs_per_host": dcn_gbs, "dcn_source": dcn_src,
            "host_cards": HOST_CARDS,
            "network": args.network, "batch_per_worker": args.batch,
            "device": dev.type,
            "factors": (
                "per collective GROUP of size g spanning h hosts: "
                "all-reduce 2(g-1)/g; gather/scatter/a2a (g-1)/g; permute "
                "1. h=1 -> ICI link time; h>1 -> per-host NIC time "
                "(per_host/c groups share the NIC, c=g/h), pipelined-ring "
                "bottleneck max(ici, dcn)"
            ),
            "caveat": (
                "kinds/counts/per-device bytes measured from the recorded step's tape "
                "(one stacked PS step; a collective a leaf where XLA's HLO combines "
                "them); link time is an alpha-beta MODEL, not a measurement. Physical "
                "layout assumed: hosts of 8 cards, worker ids host-contiguous, so the "
                "flat modes' collectives are DCN-priced beyond 8 cards"
            ),
            "hier_note": (
                "hier rows at n>=16 model the real (n/8 hosts x 8 cards) layout; the "
                "n=8 hier row models a HYPOTHETICAL 2-host x 4-card pod (8 cards are "
                "one host, where hier degenerates to the flat scheme)"
            ),
        },
        "rows": rows,
        "failures": failures,
    }
    hdr = (f"{'n':>4} {'mode':>12} {'wire MB':>9} {'colls':>6} "
           f"{'comm ms':>9} {'ici ms':>8} {'dcn ms':>8} "
           f"{'eff (no ov)':>11} {'eff (full ov)':>13}")
    print(hdr)
    for r in rows:
        print(f"{r['workers']:>4} {r['mode']:>12} "
              f"{r['total_collective_bytes'] / 1e6:>9.2f} "
              f"{r['n_collectives']:>6} {r['modeled_comm_s'] * 1e3:>9.3f} "
              f"{r['modeled_comm_ici_s'] * 1e3:>8.3f} "
              f"{r['modeled_comm_dcn_s'] * 1e3:>8.3f} "
              f"{r['efficiency_no_overlap']:>11.3f} "
              f"{r['efficiency_full_overlap']:>13.3f}")
    if args.out:
        if os.path.dirname(args.out):
            os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"report -> {args.out}", file=sys.stderr)
    return report


def exit_code(report: dict) -> int:
    """1 on a kind-level mismatch against the pscheck artifact (a wire
    regression) or a row that failed to record (hier's skips below 4
    cards are not failures), else 0."""
    cc = report.get("contract_check")
    failed = [f for f in report["failures"] if not f["error"].startswith(SKIP)]
    return 1 if (cc and not cc["ok"]) or failed else 0


if __name__ == "__main__":
    sys.exit(exit_code(main()))
