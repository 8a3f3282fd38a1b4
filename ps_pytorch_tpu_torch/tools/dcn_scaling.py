"""Multi-process (DCN) scaling sweep through the training CLI (the port of
tools/dcn_scaling.py; imports no JAX).

``analysis/scaling_bench`` scales the worker count inside one process.
This tool scales the number of real ``torch.distributed`` processes, the
DCN axis: K processes x D workers each, all running

    python -m ps_pytorch_tpu_torch.cli.train --dcn-hosts K --num-workers K*D \\
        --coordinator-address localhost:PORT --num-processes K --process-id I ...

(on the CPU: gloo, as the CLI picks it there), and reports weak-scaling
throughput from the per-step ``time_cost`` of process 0's metrics JSONL
(the median after the warm-up steps). On the card the K processes share
the one card over gloo, as ``chip_smoke.py`` phases 24 and 30b run them:
NCCL refuses two ranks on one GPU, and the CLI never switches to gloo on
its own, so each process joins a gloo group first (``--gloo-child``) and
then runs ``cli.train.main`` with the same flags but the coordinator's.

Every process shares one host's cores (and the card), so the numbers
show the harness's shape, not an interconnect: the record says
``contention: true``. What the sweep does prove is that the whole
multi-process path (the rendezvous, the hybrid grid's hops, the
metrics) runs at each K through the product CLI.

    python -m ps_pytorch_tpu_torch.tools.dcn_scaling --hosts 1 2 --per-host-devices 4 \\
        --steps 20 --device cpu --json runs/scaling_dcn_cpu.json
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def kill_all(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass


def wait_all(procs, timeout: float, log_tail) -> None:
    """Wait for every process under one shared deadline; on a timeout or a
    nonzero exit kill the whole group (coupled processes block each
    other's collectives) and raise with the failing process's log."""
    deadline = time.monotonic() + timeout
    for i, p in enumerate(procs):
        try:
            p.wait(timeout=max(5.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            kill_all(procs)
            raise RuntimeError(f"process {i} exceeded the shared {timeout}s deadline; "
                               f"group killed.\n{log_tail(i)[-3000:]}") from None
    bad = [(i, p.returncode) for i, p in enumerate(procs) if p.returncode]
    if bad:
        kill_all(procs)
        i, rc = bad[0]
        raise RuntimeError(f"process {i} exited rc={rc}.\n{log_tail(i)[-3000:]}")


def _train_argv(pid, n_procs, n_dev, tmp, args) -> list:
    argv = [
        "--network", args.network, "--dataset", args.dataset,
        "--batch-size", str(args.per_worker_batch * n_procs * n_dev),
        "--num-workers", str(n_procs * n_dev),
        "--max-steps", str(args.steps),
        "--log-interval", "1",  # a metrics record every step: the sweep reads each
        "--eval-freq", "0", "--no-checkpoints",
        "--metrics-file", os.path.join(tmp, f"metrics_{pid}.jsonl"),
        "--train-dir", os.path.join(tmp, "ckpt"),
        "--device", args.device,
    ]
    if n_procs > 1:
        argv += ["--dcn-hosts", str(n_procs)]
    if args.compress:
        argv += ["--compress-grad", "compress"]
    return argv


def _spawn(pid, port, n_procs, n_dev, tmp, args, out_file):
    argv = _train_argv(pid, n_procs, n_dev, tmp, args)
    if n_procs == 1:
        cmd = ["-m", "ps_pytorch_tpu_torch.cli.train"] + argv
    elif args.device == "cpu":
        cmd = (["-m", "ps_pytorch_tpu_torch.cli.train"] + argv
               + ["--coordinator-address", f"localhost:{port}",
                  "--num-processes", str(n_procs), "--process-id", str(pid)])
    else:
        cmd = (["-m", "ps_pytorch_tpu_torch.tools.dcn_scaling", "--gloo-child",
                f"localhost:{port}", str(n_procs), str(pid), "--"] + argv)
    # output to a file, not a pipe: a writer blocked on a full pipe would
    # stall every process's collectives
    return subprocess.Popen([sys.executable] + cmd, cwd=REPO, stdout=out_file,
                            stderr=subprocess.STDOUT)


def bench_hosts(n_procs: int, args) -> dict:
    port = free_port()
    n_dev = args.per_host_devices
    with tempfile.TemporaryDirectory() as tmp:
        logs = [os.path.join(tmp, f"out_{i}.log") for i in range(n_procs)]
        files = [open(log, "w") for log in logs]
        try:
            procs = [_spawn(i, port, n_procs, n_dev, tmp, args, files[i])
                     for i in range(n_procs)]

            def log_tail(i):
                files[i].flush()
                with open(logs[i]) as f:
                    return f.read()

            wait_all(procs, args.timeout, log_tail)
        finally:
            for f in files:
                f.close()
        with open(os.path.join(tmp, "metrics_0.jsonl")) as f:
            recs = [json.loads(line) for line in f if '"train"' in line]
    costs = [r["time_cost"] for r in recs if r.get("kind") == "train"]
    if not costs:
        raise RuntimeError(f"hosts={n_procs}: no train metrics recorded")
    # the warm-up steps (cuDNN's search, the first gloo rendezvous) out,
    # the median of the rest
    skip = min(max(2, len(costs) // 4), len(costs) - 1)
    steady = sorted(costs[skip:])
    med = steady[len(steady) // 2]
    global_batch = args.per_worker_batch * n_procs * n_dev
    return {
        "hosts": n_procs,
        "devices_per_host": n_dev,
        "workers": n_procs * n_dev,
        "global_batch": global_batch,
        "median_step_s": round(med, 6),
        "images_per_sec": round(global_batch / med, 1),
        "steps_timed": len(steady),
        "final_loss": recs[-1].get("loss"),
    }


def gloo_child(address: str, world: int, rank: int, train_argv: list) -> int:
    """One process of a card sweep: a gloo group over ``address``, then
    ``cli.train.main`` (the trainer takes the group's axis)."""
    import torch.distributed as dist

    from ps_pytorch_tpu_torch.cli import train as cli_train

    dist.init_process_group("gloo", init_method=f"tcp://{address}", world_size=world,
                            rank=rank)
    try:
        cli_train.main(train_argv)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--gloo-child":
        address, world, rank = argv[1], int(argv[2]), int(argv[3])
        return gloo_child(address, world, rank, [a for a in argv[4:] if a != "--"])
    p = argparse.ArgumentParser("ps_pytorch_tpu_torch.tools.dcn_scaling")
    p.add_argument("--hosts", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--per-host-devices", type=int, default=4,
                   help="stacked workers each process holds")
    p.add_argument("--per-worker-batch", type=int, default=64)
    p.add_argument("--network", default="LeNet")
    p.add_argument("--dataset", default="MNIST")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--compress", action="store_true")
    p.add_argument("--timeout", type=int, default=900)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)

    rows = []
    for k in args.hosts:
        rows.append(bench_hosts(k, args))
        print(rows[-1], flush=True)
    base = rows[0]
    for r in rows:
        thr = r["images_per_sec"] / base["images_per_sec"]
        r["speedup_vs_first"] = round(thr, 3)
        r["scaling_efficiency"] = round(thr / (r["hosts"] / base["hosts"]), 3)
    cuda = args.device == "cuda"
    card = None
    if cuda:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            stdout=subprocess.PIPE, text=True, check=True).stdout.strip().splitlines()[0]
    result = {
        "platform": "cuda" if cuda else "cpu",
        "card": card,
        "backend": "gloo",
        "contention": True,
        "note": ("torch.distributed processes on ONE machine"
                 + (", sharing its one card over gloo" if cuda else "")
                 + ": proves the multi-process DCN path end to end; throughput shape only "
                   "(the processes contend for the same cores, so efficiency is NOT an "
                   "interconnect measurement)"),
        "network": args.network,
        "mode": "weak",
        "per_worker_batch": args.per_worker_batch,
        "rows": rows,
    }
    print(json.dumps(result))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
