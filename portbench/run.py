"""Run one cell of the port's benchmark on the card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (imports, the kernel library, the
weights and data made from the seed, the first steps, which the
reference follows) ends where the window starts; the window measures
for ``--seconds``; then the program's state is freed and the plain
reference follows the first steps to decide ``correct``. With
``--trace 0`` the result holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from the program's spans, the
harness's counters and a profiler capture after the window.

The last line of standard output is one JSON object; the numbers that
decide ``correct``, each with its limit, are the last lines of standard
error and the result's last key. Without a card, with fewer cards than
the cell asks for, or when the run loaded JAX or the JAX package, the run
exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# any kernel cache lives in the checkout, at a fixed path: the port builds
# its own library into ps_pytorch_tpu_torch/_build/ there, and these keep
# PyTorch's extension and Triton caches beside it should anything use them
CACHE = os.path.join(ROOT, "portbench", "_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")

EXIT_NO_CARD, EXIT_FORBIDDEN = 2, 3


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="one cell of the port's benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
            t_start: float = T_START, wrap_step=None) -> dict:
    """Set-up, the window, then the check: the result's fields."""
    import torch

    from portbench.harness import compare, spec

    driver = spec.driver_module(cell.driver).Driver(cell, seed, device, wrap_step=wrap_step)
    driver.setup()
    m = driver.measure(seconds, trace)
    dev = torch.device(device)
    peak = 0
    if dev.type == "cuda":
        peak = max(torch.cuda.max_memory_allocated(dev), m.peak_window_bytes)
    driver.release()
    numbers = driver.check()
    numbers = compare.compared(numbers, cell.limits)
    out = {
        "correct": compare.verdict(numbers, cell.limits),
        "attempted": int(m.attempted),
        "failed": int(m.failed),
        "metrics": {},
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": int(peak),
        },
    }
    if trace:
        t = m.trace
        out["device"]["busy_s"] = t.busy_us() / 1e6
        out["device"]["window_s"] = t.span_us() / 1e6
        facts = {"cell": cell, "window": m.window, "spans": m.spans, "trace": t,
                 "peak_window_bytes": m.peak_window_bytes, "work": m.work,
                 "device_kind": out["device"]["kind"]}
        for metric in cell.per_layer:
            value = spec.metric_reader(metric["name"]).read(facts)
            if value is not None:
                out["metrics"][metric["name"]] = {"value": float(value), "unit": metric["unit"]}
        out["breakdown"] = {"device_ops": t.top_ops(10), "idle_gaps": t.idle_gaps(10)}
    else:
        values = dict(m.end_to_end, setup_s=m.t_window - t_start)
        for metric in cell.end_to_end:
            if metric["name"] not in values:
                raise KeyError(f"the {cell.driver} driver gives no {metric['name']}")
            out["metrics"][metric["name"]] = {"value": float(values[metric["name"]]),
                                              "unit": metric["unit"]}
    out["checks"] = {k: {"value": v, "limit": cell.limits.get(k)} for k, v in numbers.items()}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from portbench.harness import guard, spec

    cell = spec.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s), found {have}",
              file=sys.stderr)
        return EXIT_NO_CARD
    result = execute(cell, args.seed, args.seconds, bool(args.trace))
    loaded = guard.forbidden_loaded()
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return EXIT_FORBIDDEN
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
