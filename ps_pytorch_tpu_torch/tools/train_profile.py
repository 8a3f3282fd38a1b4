"""Where the PS training step's time goes on the card: a ``torch.profiler``
window over the chip_smoke training configuration (ResNet18, synthetic
CIFAR-10, 8 stacked workers of batch 128, lr 0.1, momentum 0.9,
num-aggregate 5 random_k, f32 with TF32 off) on a chosen gradient wire
(default: the int8 per-tensor, per-leaf wire), network and compute dtype.

    python -m ps_pytorch_tpu_torch.tools.train_profile [--steps 5] [--block 0] \
        [--compress-grad compress|2round|none] [--wire-domain dequant|homomorphic] \
        [--bucket-bytes -1|0|N] [--opt-placement replicated|sharded] \
        [--network ResNet18|VGG16|...] [--dtype float32|bfloat16] \
        [--overlap off|on] [--dcn-hosts 1|H]

The batches come as the trainer's do, through ``data.prefetch_to_device``
(pinned staging, a copy stream, two in flight). After ``--warmup`` steps
(cuDNN picks its algorithms there), times
``--steps`` steps without the profiler, then profiles as many, each ended
by a host read of its metrics as the trainer's per-step log window does.
Prints one JSON line: the card (nvidia-smi name and power limit), the
wall time per step with and without the profiler, the device's busy time
and idle share (summed CUDA kernel time over wall time, against either
wall time; one stream, so kernels do not overlap, except the pipelined
wire's side stream under ``--overlap on``, where the summed time can
exceed the busy time), the device time by category (K2's
``absmax_many_kernel`` + ``quantize_many_kernel``, K1's shared-scale
``quantize_rows_scaled_many_kernel``, K1's round-2
``quantize_rows_many_kernel``, the int32 sum over workers, cuDNN
convolutions and the other kernels; the fill that zeroes K2's absmax
slots counts as other) and
the top CUDA kernels by device time, each port kernel's mean and
largest device time per launch, and the host's synchronizing CUDA
runtime calls a step (count and host ms). ``--block 128`` profiles the
block-scale wire instead; the wire flags take the values of
``cli.train``'s: ``--overlap on`` the pipelined bucket wire (with a
bucketed ``--bucket-bytes`` or ZeRO-1), ``--dcn-hosts H`` the
hierarchical wire on an H x 8/H grid. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

# substrings of CUDA kernel names, checked in this order
CATEGORIES = (
    ("K2 quantize_tensors", ("absmax_many_kernel", "quantize_many_kernel")),
    ("K1 quantize_rows_scaled_many", ("quantize_rows_scaled_many_kernel",)),
    # round 2 of the block-scale two-round wire
    ("K1 quantize_rows_many", ("quantize_rows_many_kernel",)),
    ("K3 accumulate_rescale", ("accum_rescale",)),
    ("integer sum over workers", ("sum_functor<int", "sum_functor<short")),
    ("cuDNN convolution", ("cudnn", "xmma", "conv", "implicit", "winograd", "fft",
                           "dgrad", "wgrad", "fprop", "cutlass", "sgemm", "gemm")),
    ("batch norm", ("batch_norm", "welford", "bn_")),
)


# the port's own kernels, reported launch by launch
PORT_KERNELS = ("absmax_many_kernel", "quantize_many_kernel",
                "quantize_rows_scaled_many_kernel", "quantize_rows_many_kernel",
                "accum_rescale")


# CUDA runtime calls that block the host until the card catches up (a
# pageable host-to-device copy is cudaMemcpyAsync and then a stream sync)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpyAsync",
              "cudaEventSynchronize")


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _category(name: str) -> str:
    for cat, keys in CATEGORIES:
        if any(k in name for k in keys):
            return cat
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--block", type=int, default=0, help="--quant-block-size")
    ap.add_argument("--compress-grad", default="compress", choices=("compress", "2round", "none"))
    ap.add_argument("--wire-domain", default="dequant", choices=("dequant", "homomorphic"))
    ap.add_argument("--bucket-bytes", type=int, default=-1,
                    help="-1 per-leaf, 0 one fused buffer, N ~N-byte buckets")
    ap.add_argument("--opt-placement", default="replicated", choices=("replicated", "sharded"))
    ap.add_argument("--network", default="ResNet18")
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--overlap", default="off", choices=("off", "on"))
    ap.add_argument("--dcn-hosts", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_profile: no CUDA device is available", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from ps_pytorch_tpu_torch.data import (
        BatchIterator,
        make_preprocessor,
        make_synthetic,
        prefetch_to_device,
    )
    from ps_pytorch_tpu_torch.models import build_model
    from ps_pytorch_tpu_torch.optim import build_optimizer
    from ps_pytorch_tpu_torch.parallel.ps import PSConfig, init_ps_state, make_ps_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    n, b = 8, 128
    compress = {"compress": "int8", "2round": "int8_2round", "none": None}[args.compress_grad]
    cfg = PSConfig(num_workers=n, num_aggregate=5, compress=compress,
                   quant_block_size=args.block, wire_domain=args.wire_domain,
                   bucket_bytes=None if args.bucket_bytes < 0 else args.bucket_bytes,
                   opt_placement=args.opt_placement,
                   overlap="pipelined" if args.overlap == "on" else "serial",
                   dcn_hosts=args.dcn_hosts)
    model = build_model(args.network, dtype=getattr(torch, args.dtype))
    tx = build_optimizer("sgd", 0.1, momentum=0.9)
    state = init_ps_state(model, tx, cfg, torch.Generator().manual_seed(1), device=dev)
    step = make_ps_train_step(model, tx, cfg, preprocess=make_preprocessor("Cifar10", True),
                              seed=2, device=dev)
    data = make_synthetic("Cifar10", train_size=n * b * 4)
    # the trainer's batch path: pinned staging, a copy stream, two in flight
    batches = prefetch_to_device(
        BatchIterator(data.train_images, data.train_labels, n * b, seed=0).forever(),
        size=2, device=dev)

    def one():
        nonlocal state
        state, m = step(state, next(batches))
        return float(m["loss"])  # the trainer's per-window host read

    for _ in range(args.warmup):
        one()
    # the same window without the profiler, whose own host cost inflates
    # the profiled wall time
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        one()
    torch.cuda.synchronize()
    plain_wall_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            one()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels, port, runtime = {}, {}, {}
    for evt in prof.events():
        if evt.name in SYNC_CALLS:
            rec = runtime.setdefault(evt.name, [0, 0.0])
            rec[0] += 1
            rec[1] += evt.time_range.elapsed_us() / 1e3
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
    print(json.dumps({
        "card": _card(), "kind": torch.cuda.get_device_name(0),
        "config": (f"{args.network} synthetic Cifar10 {args.dtype} (TF32 off), "
                   f"{n} workers x {b}, "
                   f"num-aggregate 5 random_k, --compress-grad {args.compress_grad} "
                   f"{'block-%d' % args.block if args.block else 'per-tensor'} "
                   f"--wire-domain {args.wire_domain} --bucket-bytes {args.bucket_bytes} "
                   f"--opt-placement {args.opt_placement} --overlap {args.overlap} "
                   f"--dcn-hosts {args.dcn_hosts}"),
        "steps": args.steps, "wall_ms_per_step": wall_s / args.steps * 1e3,
        "device_ms_per_step": busy_s / args.steps * 1e3,
        "device_idle_share": 1.0 - busy_s / wall_s,
        "unprofiled_wall_ms_per_step": plain_wall_s / args.steps * 1e3,
        "unprofiled_device_idle_share": 1.0 - busy_s / plain_wall_s,
        "unprofiled_images_per_s": n * b * args.steps / plain_wall_s,
        "cuda_kernel_launches_per_step": sum(c for c, _ in kernels.values()) / args.steps,
        "categories": cats,
        # host waits on the card, and the copies that may hide one
        "host_calls_per_step": {k: {"calls": c / args.steps, "host_ms": t / args.steps}
                                for k, (c, t) in runtime.items()},
        "port_kernels": {k: {"launches_per_step": len(v) / args.steps,
                             "mean_us": sum(v) / len(v), "max_us": max(v)}
                         for k, v in port.items()},
        "top_kernels": [{"name": k[:100], "count": c, "device_s": t} for k, (c, t) in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
