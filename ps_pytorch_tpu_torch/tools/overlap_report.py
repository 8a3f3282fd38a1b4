"""How much of the PS step's gradient wire overlaps compute (the port of
tools/overlap_report.py; imports no JAX). Two modes:

  trace  read a ``--profile-dir`` capture (``*.pt.trace.json``, plain or
         gzipped: ``ProfileWindow``'s Chrome trace of ``torch.profiler``)
         and measure, on the card's timeline, the share of the wire's time
         that coincides with compute. The device events are kineto's GPU
         events (``kernel``, ``gpu_memcpy``, ``gpu_memset``); its
         ``gpu_user_annotation`` events are the GPU extent of a
         ``record_function`` range on one stream. A
         ``bucket_reduce_o<offset>`` range (the pipelined wire's bucket,
         ``parallel/collectives.py``) is that bucket's wire interval, as
         JAX's trace mode takes its named scope; a device event inside it
         on the same stream is that bucket's wire, not compute (JAX's
         scope-prefixed op names). NCCL kernels are collectives. The other
         kernels, and copies on the card, are compute when their names say
         so (``COMPUTE_KERNELS``);
         a kernel inside a ``bucket_update_o<offset>`` range is compute
         tagged with its bucket, and another bucket's update during a
         bucket's reduce counts as overlap where the bucket's own does
         not. Everything else lands in ``skipped``, listed by name. A
         trace without a device event (a CPU run's) is an error: the tool
         exits 1 and reports no fraction.
  tape   record the PS step once (``parallel/overlap.tape_overlap_headroom``
         over the step built from this CLI's config, ``--overlap on|off``)
         and report the schedule freedom its dataflow grants each gradient
         reduce: JAX's ``jaxpr`` mode over the port's recorded tape.

JAX's ``hlo`` and ``topology`` modes read a compiled XLA schedule and a
TPU topology. Eager PyTorch compiles no schedule and the card has no TPU
topology, so the tool refuses both, naming the deviation (ROADMAP.md).

  python -m ps_pytorch_tpu_torch.tools.overlap_report trace --profile-dir DIR
  python -m ps_pytorch_tpu_torch.tools.overlap_report tape --network LeNet \\
      --dataset MNIST --batch 8 --compress int8 --bucket-bytes 65536 --overlap on

Or ``python -m ps_pytorch_tpu_torch.tools.trace_report overlap <mode> ...``.
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import re
import sys
from typing import Dict, List, Optional, Tuple

# kineto's categories of work on the card, and of a record_function
# range's extent on it
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ANNOTATION_CAT = "gpu_user_annotation"

# lower-case substrings of a compute event's name: any "kernel" (as JAX's
# trace mode takes Pallas and custom kernels), ATen's, cuDNN's, cuBLAS's,
# CUTLASS's and CUB's kernels, the port's own (K1-K6), and a copy on the
# card (XLA's copy op); host transfers and memsets stay skipped
COMPUTE_KERNELS = (
    "kernel", "at::native::", "cudnn", "cublas", "cutlass", "gemm", "nvjet", "xmma",
    "sm90_", "sm80_", "cub::", "cunn_", "softmax", "winograd", "implicit_convolve",
    "quantize_rows", "rows_absmax", "rows_quantize", "quantize_kv_write", "accum_rescale",
    "flash_", "memcpy dtod",
)

# the port's own kernels (K1-K3's entries, K4-K6), counted launch by launch
PORT_KERNELS = ("absmax_many_kernel", "quantize_many_kernel", "quantize_rows", "rows_absmax",
                "rows_quantize", "quantize_kv_write", "accum_rescale", "flash_")

REFUSED = {
    "hlo": "eager PyTorch compiles no schedule to read: the port's schedule evidence is "
           "the tape mode, its timeline the trace mode (ROADMAP.md, declared deviations)",
    "topology": "the card has no TPU topology to compile for: the port's schedule evidence "
                "is the tape mode (ROADMAP.md, declared deviations)",
}

_BUCKET_ANY = re.compile(r"bucket_(reduce|update)_o(\d+)$")


class NoDeviceEvents(RuntimeError):
    """The trace holds no device event: nothing ran on a card, and no
    overlap can be read from it."""


def _is_nccl(name: str) -> bool:
    return "nccl" in name.lower()


def _is_compute(name: str) -> bool:
    low = name.lower()
    return any(k in low for k in COMPUTE_KERNELS)


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, t in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t))
        else:
            out.append((s, t))
    return out


def _inter(a, b) -> float:
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        s, t = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < t:
            tot += t - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def _top_names(events, k: int = 12) -> List[dict]:
    tot: Dict[str, float] = {}
    for e in events:
        tot[e["name"]] = tot.get(e["name"], 0.0) + e["dur"]
    ranked = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
    return [{"name": n, "total_ms": round(d / 1e3, 3)} for n, d in ranked]


def find_traces(profile_dir: str) -> List[str]:
    """The ``--profile-dir`` captures under ``profile_dir``, sorted."""
    pats = []
    for ext in ("*.pt.trace.json", "*.pt.trace.json.gz"):
        pats += glob.glob(os.path.join(profile_dir, "**", ext), recursive=True)
    return sorted(pats)


def load_trace(path: str) -> List[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data.get("traceEvents", []) if isinstance(data, dict) else data


def _lane(e: dict):
    """The (device, stream) lane of a GPU event."""
    return e.get("pid"), e.get("tid")


def _ranges(annotations: List[dict]) -> Dict[object, List[Tuple[float, float, str, int]]]:
    """The bucket ranges by lane: (start, end, "reduce" | "update", offset)."""
    out: Dict[object, List[Tuple[float, float, str, int]]] = {}
    for a in annotations:
        m = _BUCKET_ANY.search(a.get("name", ""))
        if m:
            out.setdefault(_lane(a), []).append(
                (a["ts"], a["ts"] + a["dur"], m.group(1), int(m.group(2))))
    return out


def _owner(e: dict, ranges) -> Optional[Tuple[str, int]]:
    """The innermost bucket range on ``e``'s lane that holds ``e``."""
    best = None
    for s, t, kind, off in ranges.get(_lane(e), ()):
        if s <= e["ts"] and e["ts"] + e["dur"] <= t and (best is None or t - s < best[0]):
            best = (t - s, kind, off)
    return None if best is None else (best[1], best[2])


def analyze_events(events: List[dict]) -> dict:
    """The trace mode's figures from one trace's events (see the module
    docstring); raises ``NoDeviceEvents`` when it holds none."""
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
           and e.get("dur") is not None]
    if not dev:
        raise NoDeviceEvents("no device events in the trace (kernel, gpu_memcpy, gpu_memset): "
                             "it was not taken on a card, or the profiler lost them")
    ann = [e for e in events if e.get("ph") == "X" and e.get("cat") == ANNOTATION_CAT
           and e.get("dur") is not None]
    ranges = _ranges(ann)
    reduce_ann = [a for a in ann if (m := _BUCKET_ANY.search(a.get("name", "")))
                  and m.group(1) == "reduce"]
    coll_events, comp_tagged, skipped = [], [], []
    port_kernels: Dict[str, Dict[str, int]] = {}
    for e in dev:
        own = _owner(e, ranges)
        if e.get("cat") == "kernel" and any(k in e["name"] for k in PORT_KERNELS):
            rec = port_kernels.setdefault(e["name"][:80], {"launches": 0, "in_bucket_reduce": 0})
            rec["launches"] += 1
            rec["in_bucket_reduce"] += bool(own and own[0] == "reduce")
        if (own and own[0] == "reduce") or _is_nccl(e["name"]):
            coll_events.append(e)
        elif e.get("cat") in ("kernel", "gpu_memcpy") and _is_compute(e["name"]):
            comp_tagged.append((e, own[1] if own else None))
        else:
            skipped.append(e)
    comp_events = [e for e, _ in comp_tagged]
    coll = [(e["ts"], e["ts"] + e["dur"]) for e in coll_events + reduce_ann]
    cm, pm = _merge(coll), _merge([(e["ts"], e["ts"] + e["dur"]) for e in comp_events])
    coll_time = sum(t - s for s, t in cm)
    overlap = _inter(cm, pm)
    per_bucket: Dict[int, List[Tuple[float, float]]] = {}
    for a in reduce_ann:
        off = int(_BUCKET_ANY.search(a["name"]).group(2))
        per_bucket.setdefault(off, []).append((a["ts"], a["ts"] + a["dur"]))
    rows = []
    for off in sorted(per_bucket):
        bm = _merge(per_bucket[off])
        bt = sum(t - s for s, t in bm)
        other = _merge([(e["ts"], e["ts"] + e["dur"]) for e, tag in comp_tagged if tag != off])
        ov = _inter(bm, other)
        rows.append({"bucket_offset": off, "ms": round(bt / 1e3, 3),
                     "overlapped_ms": round(ov / 1e3, 3),
                     "overlap_fraction": round(ov / bt, 4) if bt else None})
    return {
        "device_pids": sorted({e.get("pid") for e in dev}, key=str),
        "n_device_events": len(dev),
        "n_collective_events": len(coll_events),
        "n_compute_events": len(comp_events),
        "n_skipped_events": len(skipped),
        "skipped_ms": round(sum(e["dur"] for e in skipped) / 1e3, 3),
        "compute_ms": round(sum(e["dur"] for e in comp_events) / 1e3, 3),
        "collective_ms": round(coll_time / 1e3, 3),
        "overlapped_ms": round(overlap / 1e3, 3),
        "overlap_fraction": round(overlap / coll_time, 4) if coll_time else None,
        "per_bucket": rows or None,
        "n_bucket_ranges": len(reduce_ann),
        # each of the port's kernels: its launches, and how many of them
        # ran inside a bucket's reduce range
        "port_kernels": port_kernels,
        "top_compute_events": _top_names(comp_events),
        "top_skipped_events": _top_names(skipped),
    }


def run_trace(args) -> dict:
    if not args.profile_dir:
        return {"mode": "trace", "error": "--profile-dir is required"}
    pats = find_traces(args.profile_dir)
    if not pats:
        return {"mode": "trace", "error": f"no *.pt.trace.json(.gz) under {args.profile_dir}"}
    try:
        rep = analyze_events(load_trace(pats[-1]))
    except NoDeviceEvents as err:
        return {"mode": "trace", "trace_file": pats[-1], "error": str(err)}
    return {"mode": "trace", "trace_file": pats[-1], **rep}


def _build_step(args, device: str = "cpu"):
    """The PS step of this CLI's config on a recording axis, its state, a
    zero batch of ``--batch`` images and the step's draws."""
    import torch

    from ps_pytorch_tpu_torch.check.axes import recording_axis
    from ps_pytorch_tpu_torch.data import make_preprocessor
    from ps_pytorch_tpu_torch.models import build_model, init_model, input_shape_for
    from ps_pytorch_tpu_torch.optim import sgd
    from ps_pytorch_tpu_torch.parallel.mesh import WorkerAxis
    from ps_pytorch_tpu_torch.parallel.ps import (
        PSConfig,
        draw_step,
        init_ps_state,
        make_ps_train_step,
    )

    cfg = PSConfig(num_workers=args.workers, compress=args.compress,
                   num_aggregate=args.num_aggregate,
                   bucket_bytes=None if args.bucket_bytes < 0 else args.bucket_bytes,
                   overlap="pipelined" if args.overlap == "on" else "serial")
    net = build_model(args.network, num_classes=10)
    tx = sgd(0.1, momentum=0.9)
    params, stats = init_model(net, torch.Generator().manual_seed(0), device=device)
    state = init_ps_state(net, tx, cfg, params=params, batch_stats=stats, device=device)
    pre = make_preprocessor(args.dataset, train=True)
    step = make_ps_train_step(net, tx, cfg, mesh=recording_axis(WorkerAxis(args.workers)),
                              preprocess=pre, device=device)
    h, w, c = input_shape_for(args.network)
    batch = {"image": torch.zeros((args.batch, h, w, c), dtype=torch.uint8, device=device),
             "label": torch.zeros((args.batch,), dtype=torch.int64, device=device)}
    draws = draw_step(cfg, 1, 0, args.batch // args.workers, pre, net, device)
    return step, state, batch, draws


def run_tape(args) -> dict:
    """JAX's jaxpr mode over the recorded step: the schedule freedom of
    each gradient reduce (``overlap_fraction`` is the mean independent
    share)."""
    from ps_pytorch_tpu_torch.parallel.overlap import tape_overlap_headroom

    step, state, batch, draws = _build_step(args)
    rep = tape_overlap_headroom(step, state, batch, draws, devices=args.workers)
    fracs = sorted(p["independent_frac"] for p in rep.pop("per_collective"))
    rep["overlap_fraction"] = rep["overlap_headroom"]
    rep.update({"mode": "tape", "workers": args.workers, "network": args.network,
                "compress": args.compress, "overlap": args.overlap,
                "bucket_bytes": args.bucket_bytes,
                "independent_frac_min": fracs[0] if fracs else None,
                "independent_frac_max": fracs[-1] if fracs else None})
    return rep


def main(argv=None) -> int:
    p = argparse.ArgumentParser("ps_pytorch_tpu_torch.tools.overlap_report",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("mode", choices=["trace", "tape", "hlo", "topology"])
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--network", default="ResNet18")
    p.add_argument("--dataset", default="Cifar10")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--compress", default=None)
    p.add_argument("--num-aggregate", type=int, default=None)
    p.add_argument("--bucket-bytes", type=int, default=-1,
                   help="gradient wire granularity (-1 per-leaf, 0 one fused buffer, "
                        "N ~N-byte buckets)")
    p.add_argument("--overlap", choices=["on", "off"], default="off",
                   help="build the step with the pipelined bucket schedule")
    p.add_argument("--profile-dir", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if args.mode in REFUSED:
        print(f"overlap_report: mode {args.mode!r} has no counterpart on the port: "
              f"{REFUSED[args.mode]}", file=sys.stderr)
        return 2
    rep = {"trace": run_trace, "tape": run_tape}[args.mode](args)
    print(json.dumps(rep, indent=2))
    if args.out:
        if os.path.dirname(args.out):
            os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=2)
    if "error" in rep:
        print(f"overlap_report: {rep['error']}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
