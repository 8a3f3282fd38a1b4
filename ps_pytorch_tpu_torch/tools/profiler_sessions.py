"""Count the ``torch.profiler`` sessions one process opens and the device
events each of them records.

    python -m ps_pytorch_tpu_torch.tools.profiler_sessions loop \
        [--sessions 300] [--iters 10] [--workload k2|step] [--gap-s 0] \
        [--pads-ms 0[,20]] [--out F]
    python -m ps_pytorch_tpu_torch.tools.profiler_sessions run [--out F] -- SCRIPT [ARGS ...]

``loop`` opens ``--sessions`` back-to-back sessions (CPU and CUDA
activities) in one process, each over ``--iters`` calls of a workload:
``k2``, K2's one call over ResNet18's 62 leaves stacked for 8 workers
(the per-leaf wire's quantize of one step), or ``step``, one whole
ResNet18 8 x 128 PS step on that wire; ``--gap-s`` of host sleep between
sessions lets the process age, and ``--pads-ms`` of host sleep inside
each session, before its calls and after its sync, cycles over the
sessions. ``run`` runs a Python script in this process (``runpy``, as
``python SCRIPT ARGS`` would) with every session it opens counted:
``with profile(...)`` blocks and ``ProfileWindow`` captures alike.

Each session's stop prints one line to stderr: its index, where it was
started, its device and host events, and how the device clock sits
against the host's (each kernel's start minus its launch call's, which
is never negative in truth, and the first device event's start minus
the first host event's). A session started while another is open is
reported too. The summary (one JSON line on stdout, and ``--out`` when
given) holds the card (nvidia-smi name and power limit), torch's
version, the ``TEARDOWN_CUPTI`` setting of the environment, the sessions,
and the indices of those with no device event. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import runpy
import subprocess
import sys
import time
import traceback

import torch


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, check=True,
    ).stdout.strip().splitlines()[0]


class SessionLog:
    """Wraps ``torch.profiler.profile``'s ``start`` / ``stop`` for the life
    of the object's ``with`` block: each stop counts the session's device
    and host events from kineto's results."""

    def __init__(self):
        self.sessions = []
        self.open = 0
        self.nested = []
        self.tag = None  # a label the caller sets for the next sessions
        self._t0 = time.perf_counter()

    def _where(self) -> str:
        torch_dir = os.path.dirname(torch.__file__) + os.sep
        for frame in reversed(traceback.extract_stack()[:-3]):
            if not frame.filename.startswith(torch_dir):
                return f"{os.path.basename(frame.filename)}:{frame.lineno}"
        return "?"

    def __enter__(self):
        cls = torch.profiler.profile
        self._start, self._stop = cls.start, cls.stop
        log = self

        def start(prof):
            prof._session_where = log._where()
            if log.open:
                log.nested.append(len(log.sessions))
                print(f"profiler session {len(log.sessions)} started while {log.open} "
                      f"open ({prof._session_where})", file=sys.stderr)
            log.open += 1
            return log._start(prof)

        def stop(prof):
            out = log._stop(prof)
            log.open -= 1
            log.record(prof)
            return out

        cls.start, cls.stop = start, stop
        return self

    def __exit__(self, *exc):
        torch.profiler.profile.start = self._start
        torch.profiler.profile.stop = self._stop
        return False

    def record(self, prof) -> None:
        results = getattr(prof.profiler, "kineto_results", None)
        events = results.events() if results is not None else []
        cuda = torch.autograd.DeviceType.CUDA
        dev = [e for e in events if e.device_type() == cuda]
        host = [e for e in events if e.device_type() != cuda]
        rec = {"index": len(self.sessions), "where": getattr(prof, "_session_where", "?"),
               "at_s": round(time.perf_counter() - self._t0, 3), "tag": self.tag,
               "device_events": len(dev), "host_events": len(host)}
        rec.update(_clock_lag(dev, host))
        self.sessions.append(rec)
        print(f"profiler session {rec['index']} ({rec['where']}, {rec['at_s']} s, tag "
              f"{self.tag}): {len(dev)} device events, {len(host)} host events, launch lag "
              f"us {rec.get('lag_us')}, head room us {rec.get('head_us')}", file=sys.stderr)

    def summary(self) -> dict:
        empty = [s["index"] for s in self.sessions if s["device_events"] == 0]
        return {"card": _card(), "kind": torch.cuda.get_device_name(0),
                "torch": torch.__version__, "cuda": torch.version.cuda,
                "TEARDOWN_CUPTI": os.environ.get("TEARDOWN_CUPTI"),
                "sessions": len(self.sessions), "empty_sessions": empty,
                "first_empty": empty[0] if empty else None,
                "started_while_open": self.nested,
                "by_site": _by_site(self.sessions)}


def _clock_lag(dev: list, host: list) -> dict:
    """The device clock against the host's, from one session's events: each
    kernel's start minus its launch call's start (matched by correlation
    id; a true lag is >= 0), as [min, median, max] microseconds; and the
    head room, the first device event's start minus the first host
    event's."""
    if not dev:
        return {}
    launch = {e.correlation_id(): e.start_ns() for e in host if e.correlation_id()}
    lags = sorted((e.start_ns() - launch[e.correlation_id()]) / 1e3 for e in dev
                  if e.correlation_id() in launch)
    out = {"head_us": (min(e.start_ns() for e in dev) - min(e.start_ns() for e in host)) / 1e3
           if host else None}
    if lags:
        out["lag_us"] = [round(lags[0], 1), round(lags[len(lags) // 2], 1), round(lags[-1], 1)]
    return out


def _by_site(sessions: list) -> dict:
    out = {}
    for s in sessions:
        rec = out.setdefault(s["where"], {"sessions": 0, "empty": 0})
        rec["sessions"] += 1
        rec["empty"] += s["device_events"] == 0
    return out


def k2_workload(dev):
    """K2's one call over ResNet18's 62 leaves stacked for 8 workers."""
    from ps_pytorch_tpu_torch.models import build_model
    from ps_pytorch_tpu_torch.ops import quantize as q
    from ps_pytorch_tpu_torch.parallel.buckets import tree_leaves
    from ps_pytorch_tpu_torch.parallel.mesh import WorkerAxis

    params, _ = build_model("ResNet18").init(torch.Generator().manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(12)
    xs = [torch.randn((8,) + tuple(leaf.shape), generator=g, device=dev) * 0.01
          for leaf in tree_leaves(params)]
    axis = WorkerAxis(8)
    return lambda: q.quantize_int8_many(xs, axis, 0)


def step_workload(dev):
    """One ResNet18 8 x 128 PS step on the per-leaf int8 wire."""
    from ps_pytorch_tpu_torch.data import make_preprocessor, make_synthetic
    from ps_pytorch_tpu_torch.models import build_model
    from ps_pytorch_tpu_torch.optim import build_optimizer
    from ps_pytorch_tpu_torch.parallel.ps import PSConfig, init_ps_state, make_ps_train_step

    cfg = PSConfig(num_workers=8, num_aggregate=5, compress="int8")
    model = build_model("ResNet18")
    tx = build_optimizer("sgd", 0.1, momentum=0.9)
    state = init_ps_state(model, tx, cfg, torch.Generator().manual_seed(1), device=dev)
    step = make_ps_train_step(model, tx, cfg, preprocess=make_preprocessor("Cifar10", True),
                              seed=2, device=dev)
    data = make_synthetic("Cifar10", train_size=8 * 128)
    batch = {"image": torch.as_tensor(data.train_images).to(dev),
             "label": torch.as_tensor(data.train_labels).to(dev)}
    box = [state]

    def one():
        box[0], _ = step(box[0], batch)
    return one


def loop(args) -> SessionLog:
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    fn = {"k2": k2_workload, "step": step_workload}[args.workload](dev)
    fn()
    torch.cuda.synchronize()
    pads = [float(p) / 1e3 for p in args.pads_ms.split(",")]
    with SessionLog() as log:
        for i in range(args.sessions):
            pad = pads[i % len(pads)]
            log.tag = f"pad {pad * 1e3:g} ms"
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                time.sleep(pad)
                for _ in range(args.iters):
                    fn()
                torch.cuda.synchronize()
                time.sleep(pad)
            time.sleep(args.gap_s)
    return log


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    lp = sub.add_parser("loop")
    lp.add_argument("--sessions", type=int, default=300)
    lp.add_argument("--iters", type=int, default=10)
    lp.add_argument("--workload", default="k2", choices=("k2", "step"))
    lp.add_argument("--gap-s", type=float, default=0.0, help="host sleep between sessions")
    lp.add_argument("--pads-ms", default="0",
                    help="host sleep inside each session before its calls and after its "
                         "sync, cycled over the sessions (e.g. 0,20)")
    rp = sub.add_parser("run")
    rp.add_argument("script")
    rp.add_argument("args", nargs=argparse.REMAINDER)
    for p in (lp, rp):
        p.add_argument("--out", default=None, help="also write the summary JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiler_sessions: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rc = 0
    if args.mode == "loop":
        log = loop(args)
    else:
        script = os.path.abspath(args.script)
        sys.argv = [script] + [a for a in args.args if a != "--"]
        sys.path.insert(0, os.path.dirname(script))
        with SessionLog() as log:
            try:
                runpy.run_path(script, run_name="__main__")
            except SystemExit as stop:
                rc = stop.code if isinstance(stop.code, int) else (0 if stop.code is None else 1)
    summary = log.summary()
    summary["mode"] = args.mode
    summary["script_rc"] = rc
    line = json.dumps(summary)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
