"""Where the serving path's time goes on the card: ``torch.profiler``
windows over the chip_smoke serve configuration (d512 x 6 bf16, flash
prefill, int8 KV pool, 8 slots), and the device time of each kernel of
the port.

    python -m ps_pytorch_tpu_torch.tools.serve_profile [--ticks 40]

Two windows: the tick that admits 8 requests (8 prefills of 128 tokens
and one decode step), then ``--ticks`` steady full-batch decode ticks;
between them as many decode ticks without the profiler, each timed by
the host clock (mean, median and least: the profiler's own host cost a
recorded op inflates the windows' wall time, and the host's noise moves
single ticks).
Prints one JSON line: the card (nvidia-smi name and power limit) and, per
window, the wall time, the device's busy time and idle share (summed CUDA
kernel time over wall time; one stream, so kernels do not overlap), the
per-tick wall and device times, the device launches and device time a tick
split by kernel category (``CATEGORIES``: K1's KV pool write
``quantize_kv_write_kernel``; K4 ``flash_fwd_*_kernel``; index gathers
and scatters; cuBLAS; copies; the rest), the two port kernels' launches
and mean device time, and the top CUDA kernels by device time. Needs a
CUDA card.

To compare a parent checkout with this one on one card, run this file
against each package in turns (``PYTHONPATH=<parent> python
ps_pytorch_tpu_torch/tools/serve_profile.py``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, check=True,
    ).stdout.strip().splitlines()[0]


# substrings of CUDA kernel names, checked in this order
CATEGORIES = (
    ("K1 quantize_kv_write", ("quantize_kv_write_kernel",)),
    ("K4 flash_fwd", ("flash_fwd_",)),
    ("index gather / scatter", ("index_elementwise", "index_put", "indexSelect",
                                "index_kernel", "scatter_gather")),
    ("cuBLAS", ("gemm", "gemv", "nvjet", "cutlass", "xmma")),
    ("copy / cast", ("copy", "CatArray")),
)


def _category(name: str) -> str:
    for cat, keys in CATEGORIES:
        if any(k in name for k in keys):
            return cat
    return "other"


def _window(step, n: int) -> dict:
    """Profile ``n`` calls of ``step`` (each ends in a host sync): wall
    time, summed CUDA kernel time, idle share, per-kernel device time."""
    from ps_pytorch_tpu_torch.obs import padded_profile

    torch.cuda.synchronize()
    with padded_profile() as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            rec = kernels.setdefault(evt.name, [0, 0.0])
            rec[0] += 1
            rec[1] += evt.time_range.elapsed_us() / 1e6
    busy_s = sum(t for _, t in kernels.values())

    def port(name):
        hits = [(c, t) for k, (c, t) in kernels.items() if name in k]
        count = sum(c for c, _ in hits)
        total = sum(t for _, t in hits)
        return {"launches": count, "device_s": total,
                "mean_us": total / count * 1e6 if count else None}

    by_cat = {}
    for name, (c, t) in kernels.items():
        rec = by_cat.setdefault(_category(name), {"launches_per_tick": 0.0,
                                                  "device_us_per_tick": 0.0})
        rec["launches_per_tick"] += c / n
        rec["device_us_per_tick"] += t / n * 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:12]
    return {
        "ticks": n, "wall_s": wall_s, "wall_ms_per_tick": wall_s / n * 1e3,
        "device_busy_s": busy_s, "device_idle_share": 1.0 - busy_s / wall_s,
        "device_ms_per_tick": busy_s / n * 1e3,
        "cuda_kernel_launches": sum(c for c, _ in kernels.values()),
        "launches_per_tick": sum(c for c, _ in kernels.values()) / n,
        "by_category": by_cat,
        "K1_quantize_kv_write": port("quantize_kv_write_kernel"),
        "K4_flash_fwd": port("flash_fwd_"),  # both routes: mma and tf32
        "top_kernels": [{"name": k[:90], "count": c, "device_s": t}
                        for k, (c, t) in top],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ticks", type=int, default=40,
                    help="decode ticks in the unprofiled and in the profiled window "
                         "(at most 63: 128-token prompts in 256 positions)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("serve_profile: no CUDA device is available", file=sys.stderr)
        return 2
    from ps_pytorch_tpu_torch.models import TransformerConfig, init_transformer
    from ps_pytorch_tpu_torch.serve import Request, ServeConfig, ServingEngine

    dev = torch.device("cuda")
    cfg = TransformerConfig(vocab_size=2048, dim=512, depth=6, heads=8,
                            mlp_ratio=4, max_seq_len=256,
                            compute_dtype=torch.bfloat16, attention_impl="flash")
    params = init_transformer(cfg, torch.Generator().manual_seed(0), device=dev)
    engine = ServingEngine(cfg, params, ServeConfig(
        slots=8, max_len=256, max_prompt_len=128, kv_int8=True), device=dev)
    engine.warmup()
    rng = np.random.RandomState(0)
    # 8 requests fill the 8 slots: the window holds 8 prefills (the first
    # tick) and then steady full-batch decode ticks
    for i in range(8):
        engine.submit(Request(
            rid=i, prompt=rng.randint(0, cfg.vocab_size, 128).astype(np.int32),
            max_new_tokens=2 * args.ticks + 1))
    admit = _window(engine.tick, 1)  # 8 prefills + one decode step
    # full-batch decode ticks without the profiler (its per-op host cost
    # inflates the windows' wall time), then with it
    ticks_ms = []
    for _ in range(args.ticks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.tick()  # ends in the host's read of the new tokens
        torch.cuda.synchronize()
        ticks_ms.append((time.perf_counter() - t0) * 1e3)
    steady = _window(engine.tick, args.ticks)
    print(json.dumps({
        "card": _card(), "kind": torch.cuda.get_device_name(0),
        "config": "d512x6 vocab2048 bf16 flash-prefill int8-kv, 8 slots",
        "admit_tick": admit, "steady_decode": steady,
        "steady_decode_unprofiled": {
            "ticks": args.ticks, "mean_ms": float(np.mean(ticks_ms)),
            "p50_ms": float(np.median(ticks_ms)), "min_ms": float(np.min(ticks_ms))},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
