"""The readings the limits of ``correct`` are set from (not run by the
benchmark's runs).

    python3 portbench/calibrate.py --workload <cell> --seeds <n> [<n> ...] \
        [--variants K] [--out FILE]

For each seed, in one process: the cell's set-up (the program's first
steps, as a run takes them, at the cell's own size), the program's
state freed, then the numbers that decide ``correct`` against the plain
reference: the lower readings. For the first ``K`` seeds also the
control (the reference in the cell's lower precision, ``control`` in
``limits/<cell>.json``) and each planted fault of ``faults`` there (the
reference with the fault, in the program's place): the upper readings.
One JSON line a reading on standard output (and in ``--out``).
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="readings for the limits of correct")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from portbench.harness import spec

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.find_cell(args.workload)
    limits = spec.load_json(os.path.join(spec.PORTBENCH, "limits", f"{cell.name}.json"))
    variants = [("control", {"precision": limits["control"]})]
    variants += [(f"fault:{f}", {"fault": f}) for f in limits.get("faults", [])]
    sink = open(args.out, "a") if args.out else None
    try:
        for i, seed in enumerate(args.seeds):
            t0 = time.perf_counter()
            driver = spec.driver_module(cell.driver).Driver(cell, seed, "cuda")
            driver.setup()
            driver.release()
            rows = [("program", driver.check())]
            if i < args.variants:
                rows += [(name, driver.check_against(**kw)) for name, kw in variants]
            for name, numbers in rows:
                line = json.dumps({"cell": cell.name, "seed": seed, "side": name,
                                   "numbers": numbers, "s": time.perf_counter() - t0})
                print(line, flush=True)
                if sink is not None:
                    sink.write(line + "\n")
                    sink.flush()
            del driver
            torch.cuda.empty_cache()
    finally:
        if sink is not None:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
