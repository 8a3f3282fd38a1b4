"""What holds the card's memory between training steps: ``cli.train.main``
on the chip_smoke training configuration (synthetic CIFAR-10, 8 stacked
workers of batch 128, lr 0.1, momentum 0.9, num-aggregate 5 random_k,
int8 per-tensor wire, f32 with TF32 off) with the allocator recording
where each block was allocated.

    python -m ps_pytorch_tpu_torch.tools.train_memory [--network VGG16] \\
        [--steps 12] [--at 1,3,12] [--min-mb 16] [-- <more cli.train flags>]

After each step named by ``--at`` (once the step's kernels are done) it
takes the allocator's snapshot and sums the live blocks of at least
``--min-mb`` MB by the Python frames that allocated them (the innermost
frame of this package and the innermost frame overall; a block that an
autograd backward allocated has no Python frame). Prints one JSON line:
the card (nvidia-smi name and power limit), and for each probed step the
bytes allocated, the high-water mark so far and the live blocks by site.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _site(frames) -> str:
    """``package frame <- innermost frame`` of an allocation's stack."""
    def show(f):
        return f"{os.path.basename(f['filename'])}:{f['line']} {f['name']}"

    py = [f for f in frames if f.get("filename", "").endswith(".py")]
    if not py:
        return "(no Python frame)"
    ours = next((f for f in py if f["filename"].startswith(PACKAGE)), None)
    inner = show(py[0])
    return inner if ours is None or ours is py[0] else f"{show(ours)} <- {inner}"


def live_blocks(min_bytes: int) -> dict:
    """Live blocks of at least ``min_bytes``, summed by allocation site:
    ``{site: [count, bytes]}``, largest first."""
    sites: dict = {}
    for seg in torch.cuda.memory._snapshot()["segments"]:
        for blk in seg["blocks"]:
            if blk["state"] != "active_allocated" or blk["size"] < min_bytes:
                continue
            frames = blk.get("frames") or []
            rec = sites.setdefault(_site(frames), [0, 0])
            rec[0] += 1
            rec[1] += int(blk["size"])
    return dict(sorted(sites.items(), key=lambda kv: -kv[1][1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--network", default="VGG16")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--at", default="1,3,12", help="steps after which to take a snapshot")
    ap.add_argument("--min-mb", type=float, default=16.0)
    args, extra = ap.parse_known_args(argv)
    if not torch.cuda.is_available():
        print("train_memory: no CUDA device is available", file=sys.stderr)
        return 2
    import ps_pytorch_tpu_torch.trainer as trainer_mod
    from ps_pytorch_tpu_torch.cli import train as cli_train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    at = {int(s) for s in args.at.split(",")}
    probes = {}
    make = trainer_mod.make_ps_train_step

    def probed_make(*a, **k):
        step = make(*a, **k)
        done = [0]

        def probed(*sa, **sk):
            out = step(*sa, **sk)
            done[0] += 1
            if done[0] in at:
                torch.cuda.synchronize()
                probes[done[0]] = {
                    "allocated_bytes": torch.cuda.memory_allocated(),
                    "peak_bytes": torch.cuda.max_memory_allocated(),
                    "live_by_site": live_blocks(int(args.min_mb * 2 ** 20))}
            return out

        return probed

    trainer_mod.make_ps_train_step = probed_make
    torch.cuda.memory._record_memory_history(max_entries=200_000, stacks="python")
    flags = ["--network", args.network, "--dataset", "Cifar10", "--num-workers", "8",
             "--batch-size", "128", "--lr", "0.1", "--momentum", "0.9", "--num-aggregate",
             "5", "--compress-grad", "compress", "--log-interval", "1", "--device", "cuda",
             "--max-steps", str(args.steps), "--no-checkpoints", *extra]
    cli_train.main(flags)
    torch.cuda.memory._record_memory_history(enabled=None)
    print(json.dumps({"card": _card(), "kind": torch.cuda.get_device_name(0),
                      "flags": " ".join(flags), "steps": probes}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
