"""The PS train step's throughput against the worker count (the port of
analysis/scaling_bench.py).

Times the PS step on the stacked backend at each ``--workers`` count:
weak scaling (the per-worker batch fixed, the reference's setup) by
default, ``--strong`` divides a fixed global batch instead. ``--workload
lm`` scales an LM parallelism over its shard count through
``cli.train_lm``'s steady-state window instead.

The stacked backend holds every worker on the one card, and the workers'
forward and backward passes run in turn there, so the curve shows what
the card does with N workers' work and what the wire costs on it, not
what N cards would do: the record says so
(``workers_in_turn_on_one_device``) beside the card's name and power
limit. ``--device cpu`` runs the same
harness on the CPU and says ``platform: cpu``.

    python -m ps_pytorch_tpu_torch.analysis.scaling_bench --network LeNet \\
        --batch-size 1024 --workers 1 2 4 8 --steps 20 --json out.json
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def bench_mesh(network, dataset, num_workers, per_worker_batch, steps, compress,
               device="cuda") -> dict:
    """Images a second of the PS step at ``num_workers`` stacked workers:
    two warm-up steps (cuDNN's algorithm search), then ``steps`` timed ones
    between two host syncs."""
    from ps_pytorch_tpu_torch.data import IMAGE_SHAPES, make_preprocessor
    from ps_pytorch_tpu_torch.models import build_model
    from ps_pytorch_tpu_torch.optim import build_optimizer
    from ps_pytorch_tpu_torch.parallel.ps import PSConfig, init_ps_state, make_ps_train_step
    from ps_pytorch_tpu_torch.utils import host_sync

    dev = torch.device(device)
    cfg = PSConfig(num_workers=num_workers, compress="int8" if compress else None)
    model = build_model(network)
    tx = build_optimizer("sgd", 0.01, momentum=0.9)
    state = init_ps_state(model, tx, cfg, torch.Generator().manual_seed(0), device=dev)
    step = make_ps_train_step(model, tx, cfg, preprocess=make_preprocessor(dataset, train=True),
                              seed=1, device=dev)
    shape = IMAGE_SHAPES[dataset]
    global_batch = per_worker_batch * num_workers
    rng = np.random.RandomState(0)
    batch = {
        "image": torch.from_numpy(rng.randint(0, 255, (global_batch,) + shape)
                                  .astype(np.uint8)).to(dev),
        "label": torch.from_numpy(rng.randint(0, 10, (global_batch,)).astype(np.int32)).to(dev),
    }
    for _ in range(2):
        state, m = step(state, batch)
    host_sync(state.params, m)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, batch)
    host_sync(state.params, m)  # the params chain orders the whole window
    dt = time.perf_counter() - t0
    return {
        "workers": num_workers,
        "per_worker_batch": per_worker_batch,
        "global_batch": global_batch,
        "step_time_s": round(dt / steps, 6),
        "images_per_sec": round(global_batch * steps / dt, 1),
        "final_loss": round(float(m["loss"]), 4),
    }


def bench_lm_mesh(parallelism, num_shards, batch, seq_len, steps, lm_kw,
                  device="cuda") -> dict:
    """Tokens a second of one LM parallelism at one shard count, through
    ``cli.train_lm`` (its steady window: the steps after its warm-up)."""
    from ps_pytorch_tpu_torch.cli.train_lm import main as lm_main

    # dp_sp sizes its sequence axis from --num-sp, every other scheme from
    # --num-shards
    axis_flag = "--num-sp" if parallelism == "dp_sp" else "--num-shards"
    out = lm_main([
        "--parallelism", parallelism, axis_flag, str(num_shards),
        "--num-dp", str(lm_kw.get("num_dp", 1)), "--batch-size", str(batch),
        "--seq-len", str(seq_len), "--max-steps", str(steps + 2),
        "--log-interval", str(steps + 2), "--dim", str(lm_kw.get("dim", 128)),
        "--depth", str(lm_kw.get("depth", 2)), "--heads", str(lm_kw.get("heads", 8)),
        "--device", device,
    ])
    dt, n_steady = out["steady_elapsed_s"], out["steady_steps"]
    return {
        "parallelism": parallelism,
        "shards": num_shards,
        "batch": batch,
        "seq_len": seq_len,
        "tokens_per_sec": round(batch * seq_len * n_steady / dt, 1),
        "final_loss": round(out["loss"], 4),
    }


def main(argv=None):
    p = argparse.ArgumentParser("ps_pytorch_tpu_torch.analysis.scaling_bench")
    p.add_argument("--workload", default="ps", choices=["ps", "lm"],
                   help="ps: the CNN PS step; lm: a transformer parallelism")
    p.add_argument("--network", default="LeNet")
    p.add_argument("--dataset", default="MNIST")
    p.add_argument("--batch-size", type=int, default=1024,
                   help="per-worker batch (weak scaling, the reference's setup)")
    p.add_argument("--workers", type=int, nargs="+", default=[1, 2, 4, 8])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--strong", action="store_true",
                   help="a fixed global batch divided across the workers")
    p.add_argument("--compress", action="store_true", help="the int8 gradient wire")
    p.add_argument("--parallelism", default="tp", choices=["dp_sp", "dp_tp", "tp", "pp", "moe"],
                   help="lm workload: the scheme to scale over --workers")
    p.add_argument("--seq-len", type=int, default=256)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--json", default=None, help="also write the record to this file")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("scaling_bench: no CUDA device is available (--device cpu runs "
                         "the harness on the CPU)")
    if args.device == "cuda":
        # the f32 step as the CPU computes it (chip_smoke's rule)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    rows = []
    for w in args.workers:
        if args.workload == "lm":
            # shards x an even k: divisible by the expert axis and by pp's
            # default 2 microbatches at every w
            batch = w * max(2 * (args.batch_size // 512), 2)
            rows.append(bench_lm_mesh(
                args.parallelism, w, batch, args.seq_len, args.steps,
                {"heads": 8, "depth": 2 if args.parallelism != "pp" else 8}, args.device))
        else:
            pw = args.batch_size // w if args.strong else args.batch_size
            rows.append(bench_mesh(args.network, args.dataset, w, pw, args.steps,
                                   args.compress, args.device))
        print(rows[-1], flush=True)
    base = rows[0]
    thr_key = "tokens_per_sec" if args.workload == "lm" else "images_per_sec"
    n_key = "shards" if args.workload == "lm" else "workers"
    for r in rows:
        thr = r[thr_key] / base[thr_key]
        r["speedup_vs_first"] = round(thr, 3)
        r["scaling_efficiency"] = round(thr / (r[n_key] / base[n_key]), 3)
    cuda = args.device == "cuda"
    result = {
        "platform": "cuda" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "card": _card() if cuda else None,
        # the stacked backend: every worker on the one device, run in turn
        "workers_in_turn_on_one_device": True,
        "network": args.network,
        "mode": "strong" if args.strong else "weak",
        # strong: --batch-size is the fixed global batch; weak: the
        # per-worker batch (each row's per_worker_batch is the figure)
        "batch_size_arg": args.batch_size,
        "rows": rows,
    }
    print(json.dumps(result))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
