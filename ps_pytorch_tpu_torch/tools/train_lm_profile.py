"""Where the LM training step's time goes on the card: a ``torch.profiler``
window over the LM-1 configuration of ``chip_smoke.py`` (the JAX bench's
LM leg: vocab 2048, d512, depth 6, 8 heads, seq 1024, batch 8, bf16 block
math over f32 params, remat, SGD lr 0.01 momentum 0.9) on the dp x sp
step with flash attention inside the ring.

    python -m ps_pytorch_tpu_torch.tools.train_lm_profile [--steps 5] \\
        [--seq-len 1024] [--batch-size 8] [--num-dp 1] [--num-sp 1] [--no-remat] \\
        [--dtype bfloat16|float32]

``--dtype float32`` runs the block math in f32, ``cli.train_lm``'s
default (K4, K5 and K6 on their TF32 route).

After ``--warmup`` steps, times ``--steps`` steps without the profiler,
then profiles as many, each ended by a host read of its loss as the CLI's
per-step log does. Prints one JSON line: the card (nvidia-smi name and
power limit), the wall time per step with and without the profiler,
tokens/s, the device's busy time and idle share (summed CUDA kernel time
over wall time; one stream, so kernels do not overlap), the device time
by category (K4's partial triple, K5, K6, cuBLAS matmuls, the loss's
softmax, the optimizer and other elementwise kernels), each port
kernel's mean and largest device time per launch, and the top kernels.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

# substrings of CUDA kernel names (each port kernel by its prefix, which
# both routes share: flash_fwd_{mma,tf32}_kernel, ...), checked in this order
CATEGORIES = (
    ("K4 flash_fwd / flash_partial", ("flash_fwd_",)),
    ("K5 flash_bwd_dq", ("flash_dq_",)),
    ("K6 flash_bwd_dkv", ("flash_dkv_",)),
    ("matmul (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma", "cublas")),
    ("softmax / log-softmax / gather", ("softmax", "gather", "nll")),
    ("reductions (norms, sums)", ("reduce_kernel",)),
    ("K/V ring rotations", ("roll_cuda_kernel",)),
    ("casts and copies", ("copy_kernel",)),
)

PORT_KERNELS = ("flash_fwd_", "flash_dq_", "flash_dkv_")


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _category(name: str) -> str:
    for cat, keys in CATEGORIES:
        if any(k in name for k in keys):
            return cat
    return "other (elementwise: norms, GELU, residuals, optimizer)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--num-dp", type=int, default=1)
    ap.add_argument("--num-sp", type=int, default=1)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"],
                    help="block math dtype (cli.train_lm --dtype)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_lm_profile: no CUDA device is available", file=sys.stderr)
        return 2
    from ps_pytorch_tpu_torch.obs import padded_profile

    from ps_pytorch_tpu_torch.cli.train_lm import make_synthetic_tokens
    from ps_pytorch_tpu_torch.models import TransformerConfig, init_transformer
    from ps_pytorch_tpu_torch.optim import build_optimizer
    from ps_pytorch_tpu_torch.parallel.dp_sp import (
        make_lm_train_step,
        make_mesh_2d,
        shard_tokens_2d,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = TransformerConfig(vocab_size=2048, dim=512, depth=6, heads=8,
                            max_seq_len=args.seq_len, remat=not args.no_remat,
                            attention_impl="flash",
                            compute_dtype=torch.bfloat16 if args.dtype == "bfloat16" else None)
    mesh = make_mesh_2d(args.num_dp, args.num_sp)
    tx = build_optimizer("sgd", 0.01, momentum=0.9)
    params = init_transformer(cfg, torch.Generator().manual_seed(1), device=dev)
    opt = tx.init(params)
    step = make_lm_train_step(cfg, tx, mesh)
    corpus = make_synthetic_tokens(2048, 64, args.seq_len, seed=2)
    rng = np.random.RandomState(3)

    def one():
        nonlocal params, opt
        tok = torch.from_numpy(corpus[rng.randint(0, len(corpus), args.batch_size)])
        params, opt, loss = step(params, opt, shard_tokens_2d(tok.to(dev), mesh))
        return float(loss)  # the CLI's per-step host read

    for _ in range(args.warmup):
        one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        one()
    torch.cuda.synchronize()
    plain_wall_s = time.perf_counter() - t0
    with padded_profile() as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            one()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels, port = {}, {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us = evt.time_range.elapsed_us()
            rec = kernels.setdefault(evt.name, [0, 0.0])
            rec[0] += 1
            rec[1] += us / 1e6
            for k in PORT_KERNELS:
                if k in evt.name:
                    port.setdefault(k, []).append(us)
    busy_s = sum(t for _, t in kernels.values())
    cats = {}
    for name, (c, t) in kernels.items():
        rec = cats.setdefault(_category(name), {"launches": 0, "device_s": 0.0})
        rec["launches"] += c
        rec["device_s"] += t
    for rec in cats.values():
        rec["share_of_device"] = rec["device_s"] / busy_s if busy_s else None
        rec["device_ms_per_step"] = rec["device_s"] / args.steps * 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:15]
    tokens = args.batch_size * args.seq_len
    print(json.dumps({
        "card": _card(), "kind": torch.cuda.get_device_name(0),
        "config": (f"LM vocab 2048 d512 x6 h8 seq {args.seq_len} batch {args.batch_size}, "
                   f"{args.dtype} block math, remat {not args.no_remat}, flash ring, "
                   f"dp {args.num_dp} x sp {args.num_sp}"),
        "steps": args.steps, "wall_ms_per_step": wall_s / args.steps * 1e3,
        "device_ms_per_step": busy_s / args.steps * 1e3,
        "device_idle_share": 1.0 - busy_s / wall_s,
        "unprofiled_wall_ms_per_step": plain_wall_s / args.steps * 1e3,
        "unprofiled_device_idle_share": 1.0 - busy_s / plain_wall_s,
        "unprofiled_tokens_per_s": tokens * args.steps / plain_wall_s,
        "cuda_kernel_launches_per_step": sum(c for c, _ in kernels.values()) / args.steps,
        "categories": cats,
        "port_kernels": {k: {"launches_per_step": len(v) / args.steps,
                             "mean_us": sum(v) / len(v), "max_us": max(v)}
                         for k, v in port.items()},
        "top_kernels": [{"name": k[:100], "count": c, "device_s": t} for k, (c, t) in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
