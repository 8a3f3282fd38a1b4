"""Long-context (T=8192) exactness of the flash ring against the full
attention oracle: value and gradient (the port of
tools/longcontext_cpu_check.py; imports no JAX).

Causal ring attention with the flash kernels inside every hop (K4's
partial triple forward, K5 + K6 backward: ``parallel/ring_attention.
make_ring_attention(axis, causal=True, impl="flash")`` on
``make_seq_mesh(devices)`` stacked shards), f32, against
``full_attention``, which materializes the whole ``[H, T, T]`` score
matrix the ring exists to avoid. It checks the value, then dq, dk and dv
of ``sum(o * w)`` with ``w`` a random weight on every position. Inputs
come from ``np.random.RandomState(0)``; the tolerances are the JAX
tool's: 2e-4 absolute on the value, ``2e-4 * max(1, max|oracle|)`` on
each gradient.

It runs on the card (the kernels; f32 inputs take their 3xTF32 route)
unless ``--device cpu`` is given (the kernels' plain versions); with no
card and no ``--device cpu`` it raises. The report has the JAX record's
keys (``runs/longcontext_t8192_cpu.json``), ``backend`` ``cuda`` or
``cpu``, and in place of ``pallas_interpret`` ``kernels``: the launches
of ``flash_partial`` (K4 ``normalize=False``), ``flash_bwd_dq`` (K5) and
``flash_bwd_dkv`` (K6) the run made, counted by their wrappers (none on
the CPU). On the card it also records the card's name and power limit.
Several ``--heads`` run one after another, each with its own report, under
``{"runs": [...], "all_pass": ...}``. Exit 1 when a check fails.

    python -m ps_pytorch_tpu_torch.tools.longcontext_check --seq 8192 --heads 1 8 \\
        --out runs/longcontext_t8192_h100.json
    python -m ps_pytorch_tpu_torch.tools.longcontext_check --seq 512 --devices 4 \\
        --device cpu
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

import numpy as np
import torch

from .. import resolve_device

KERNELS = ("flash_partial", "flash_bwd_dq", "flash_bwd_dkv")


def _counters() -> dict:
    # the module (the ops package re-exports the function of its name)
    fa = importlib.import_module("ps_pytorch_tpu_torch.ops.flash_attention")
    return {name: getattr(fa, name) for name in KERNELS}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _err(got: torch.Tensor, want: torch.Tensor) -> tuple:
    return (float((got - want).abs().max()), float(want.abs().max()))


def run_check(seq: int = 8192, dim: int = 64, heads: int = 1, devices: int = 8,
              grad: bool = True, device=None) -> tuple:
    """The check -> ``(report, arrays)``: ``arrays`` holds the inputs and
    the ring's output and gradients as numpy (``q``, ``k``, ``v``, ``w``,
    ``o``, ``dq``, ``dk``, ``dv``)."""
    from ..parallel.ring_attention import full_attention, make_ring_attention, make_seq_mesh

    dev = resolve_device(device)
    b, t, h, d = 1, seq, heads, dim
    axis = make_seq_mesh(devices)
    rng = np.random.RandomState(0)
    arrays = {name: rng.randn(b, t, h, d).astype(np.float32) for name in "qkv"}
    q, k, v = (torch.from_numpy(arrays[name]).to(dev) for name in "qkv")

    # the JAX record's key order; ``kernels`` is filled in at the end
    report = {"seq": t, "dim": d, "heads": h, "devices": devices,
              "backend": dev.type, "kernels": None, "checks": []}
    if dev.type == "cuda":
        from ..tune.costmodel import card_identity

        ident = card_identity()
        report["card"], report["power_limit"] = ident["name"], ident["power_limit"]
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0

    ring = make_ring_attention(axis, causal=True, impl="flash")
    with torch.no_grad():
        t0 = time.perf_counter()
        got = ring(q, k, v)
        _sync(dev)
        t_ring = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = full_attention(q, k, v, causal=True)
        _sync(dev)
        t_oracle = time.perf_counter() - t0
    err, scale = _err(got, want)
    arrays["o"] = got.cpu().numpy()
    del want
    report["checks"].append({
        "what": f"value: ring_flash(causal, {devices}-way SP) vs full_attention",
        "max_abs_err": err, "oracle_max_abs": scale,
        "ring_seconds": round(t_ring, 4), "oracle_seconds": round(t_oracle, 4),
        "pass": bool(err < 2e-4),
    })

    if grad:
        # gradient through the ring's backward (K5 + K6 a hop) against
        # autograd through the oracle, of a loss that weights every position
        arrays["w"] = rng.randn(*got.shape).astype(np.float32)
        w = torch.from_numpy(arrays["w"]).to(dev)
        del got
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        t0 = time.perf_counter()
        gr = torch.autograd.grad((ring(*leaves) * w).sum(), leaves)
        _sync(dev)
        t_g = time.perf_counter() - t0
        gf = torch.autograd.grad((full_attention(*leaves, causal=True) * w).sum(), leaves)
        for name, a, want_g in zip("qkv", gr, gf):
            e, s = _err(a, want_g)
            arrays["d" + name] = a.cpu().numpy()
            report["checks"].append({
                "what": f"grad d{name}: ring_flash custom-VJP vs oracle",
                "max_abs_err": e, "oracle_max_abs": s,
                # the gradients sum T-long reductions: the bound scales
                # with the oracle's own magnitude
                "pass": bool(e < 2e-4 * max(1.0, s)),
            })
        del gr, gf, leaves
        report["grad_seconds"] = round(t_g, 4)
    report["kernels"] = {name: fn.launches for name, fn in counters.items()}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    report["all_pass"] = all(c["pass"] for c in report["checks"])
    return report, arrays


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("ps_pytorch_tpu_torch.tools.longcontext_check",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--seq", type=int, default=8192)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--heads", type=int, nargs="+", default=[1],
                   help="one run a head count; with several, the report is "
                        "{runs: [...], all_pass}")
    p.add_argument("--devices", type=int, default=8)
    p.add_argument("--grad", action="store_true", default=True)
    p.add_argument("--no-grad", dest="grad", action="store_false")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if args.device == "cuda":
        # the oracle's f32 products in full f32 (the kernels' own route is 3xTF32)
        torch.backends.cuda.matmul.allow_tf32 = False
    runs = [run_check(args.seq, args.dim, h, args.devices, args.grad, args.device)[0]
            for h in args.heads]
    report = runs[0] if len(runs) == 1 else {
        "runs": runs, "all_pass": all(r["all_pass"] for r in runs)}
    print(json.dumps(report, indent=2))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"report -> {args.out}", file=sys.stderr)
    return report


if __name__ == "__main__":
    sys.exit(0 if main()["all_pass"] else 1)
