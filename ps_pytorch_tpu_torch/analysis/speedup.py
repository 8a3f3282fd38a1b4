"""Speedup tables from training logs (the port of analysis/speedup.py).

The reference's notebooks parse each worker's per-iteration log lines,
take for every step the SLOWEST worker's time ("normal": the step time the
synchronous protocol pays) and the FASTEST ("ideal": straggler-free), sum
over the steps and divide a baseline run's total by each run's. This does
the same from ``utils.parse_iter_line``, which reads the port's lines, the
JAX package's and the reference's alike:

    python -m ps_pytorch_tpu_torch.analysis.speedup --baseline logs/w1.log \\
        logs/w1.log logs/w2.log logs/w4.log

The port logs one line a global step, so "normal" equals "ideal" but for
logs of several processes.
"""

from __future__ import annotations

import argparse
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ps_pytorch_tpu_torch.utils import parse_iter_line


@dataclass
class RunStats:
    path: str
    steps: Dict[int, List[float]]  # step -> each worker's time cost
    losses: List[float] = field(default_factory=list)

    @property
    def total_normal(self) -> float:
        """The straggler-bound total: the slowest worker a step."""
        return sum(max(v) for v in self.steps.values())

    @property
    def total_ideal(self) -> float:
        """The straggler-free total: the fastest worker a step."""
        return sum(min(v) for v in self.steps.values())

    @property
    def mean_loss(self) -> Optional[float]:
        return sum(self.losses) / len(self.losses) if self.losses else None


def parse_log(path: str, max_step: Optional[int] = None) -> RunStats:
    steps: Dict[int, List[float]] = {}
    losses: List[float] = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            d = parse_iter_line(line)
            if d is None:
                continue
            step = int(d["step"])
            if max_step is not None and step > max_step:
                continue
            steps.setdefault(step, []).append(d["time_cost"])
            losses.append(d["loss"])
    return RunStats(path=path, steps=steps, losses=losses)


def speedups(runs: List[RunStats], baseline: RunStats) -> List[dict]:
    """Each run's speedup over the baseline (the notebooks' cell 5)."""
    return [{
        "log": r.path,
        "steps": len(r.steps),
        "total_s": round(r.total_normal, 4),
        "speedup": round(baseline.total_normal / r.total_normal, 4) if r.total_normal else None,
        "ideal_speedup": (round(baseline.total_ideal / r.total_ideal, 4)
                          if r.total_ideal else None),
    } for r in runs]


def main(argv=None):
    p = argparse.ArgumentParser("ps_pytorch_tpu_torch.analysis.speedup")
    p.add_argument("logs", nargs="+", help="per-configuration log files")
    p.add_argument("--baseline", default=None, help="baseline log (default: the first)")
    p.add_argument("--max-step", type=int, default=None,
                   help="only count steps <= N (the notebooks use 100)")
    p.add_argument("--json", action="store_true", help="print JSON instead of a table")
    args = p.parse_args(argv)

    runs = [parse_log(path, args.max_step) for path in args.logs]
    if args.baseline is None:
        baseline = runs[0]
    else:
        baseline = {r.path: r for r in runs}.get(args.baseline) or parse_log(
            args.baseline, args.max_step)
    rows = speedups(runs, baseline)
    if args.json:
        print(json.dumps(rows))
    else:
        print(f"{'log':40} {'steps':>6} {'total_s':>10} {'speedup':>8} {'ideal':>8}")
        for r in rows:
            print(f"{r['log']:40} {r['steps']:>6} {r['total_s']:>10} "
                  f"{r['speedup']!s:>8} {r['ideal_speedup']!s:>8}")
    return rows


if __name__ == "__main__":
    main()
