#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and PS-training paths on one H100
and hold each of its hand-written kernels against its plain PyTorch
version.

    python3 chip_smoke.py

Needs one CUDA card (exits non-zero without one, and without the
``ps_pytorch_tpu_torch`` package beside this file). Imports nothing of JAX.

Phases, one line each:

1. the card (nvidia-smi name and power limit), torch/CUDA versions, TF32 off;
2. build every kernel from ``ps_pytorch_tpu_torch/csrc`` (one nvcc per
   source, all at once; sm_90a);
3. K1 quantize_rows vs its plain version, bit-exact, at the serving path's
   shapes (prefill write [1024, 64] bf16, decode write [64, 64] bf16) and a
   ragged [1001, 128] f32, timed with CUDA events;
4. K4 flash_fwd vs its plain version at the prefill shape [1, 128, 8, 64]
   (bf16 and f32, causal) and an odd T = 100, timed beside
   ``scaled_dot_product_attention`` (the library yardstick, never called by
   the port) and its bound;
5. serve: d512 x 6 bf16 model, flash prefill, int8 KV pool, 8 slots,
   32 open-loop requests; every request completes, tokens in range, p50/p99
   finite, and the kernel launch counters match the work done;
6. f32 engine vs the port's per-sequence ``generate`` on the card;
7. K2 quantize_tensor vs its plain version, bit-exact (payload and scale),
   at the training wire's shapes: the largest ResNet18 leaf stacked for 8
   workers [8, 3, 3, 512, 512], a BN leaf [8, 512], the dense bias [8, 10],
   a ragged odd length and an all-zero tensor; timed, with its bound;
8. K1's shared-scale entry quantize_rows_scaled vs its plain version,
   bit-exact, at the largest leaf's block-128 rows [8 * 18432, 128];
9. train: ResNet18 at full width on synthetic CIFAR-10, 8 stacked workers,
   batch 128 each, lr 0.1, momentum 0.9, num-aggregate 5 (random_k), the
   int8 per-tensor wire, through ``cli.train.main``: every loss finite, no
   skipped step, K2 launched 62 times per step; step time p50 and images/s;
   then a short run on the block-128 wire (K1's shared-scale entry, 62
   launches per step);
10. train held on the card: one LeNet step at 8 workers on the card (the
   kernels) against the same step on the CPU (the plain versions), same
   params, batch and mask, for the per-tensor and block-128 wires, and a
   NaN-injected step that must leave the params alone;
11. K3 accumulate_rescale_int8 vs its plain version, bit-exact, at the
   homomorphic two-round wire's shapes: the ResNet18 fused stacked payload
   [8, 11173968], one region [8, 1396746], [8, 130], [258, 4096] and
   [1, 1], with divisors 5.0, 8.0 and a device-tensor divisor; timed, with
   its bound;
12. train ResNet18 (8 x 128, lr 0.1, momentum 0.9, num-aggregate 5) through
   ``cli.train.main`` on the autotune-best wire (``--compress-grad 2round
   --bucket-bytes 0 --wire-domain homomorphic``) for 10 steps: finite
   losses, no skipped step, exactly one K3 and one K2 launch per step;
   then 3 steps of the dequant two-round wire (1 + 8 K2 launches per step)
   and 3 of the ZeRO-1 placement on the two-round wire (one K2 per step);
13. one LeNet step at 8 workers, card vs CPU (phase 10's rule, with K
   times its bound on the two-round wires' coarser second rounding), on the
   autotune-best wire with EF, int8 homomorphic in 64 KiB buckets, the
   two-round dequant wire with block-128 scales and ZeRO-1 int8
   homomorphic, each with its launch counts;
14. the kernels JSON line, then the result line.

Any mismatch raises; the exit code is then non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_OPS_PER_S = {                 # H100 SXM dense peaks (f32: CUDA cores)
    torch.bfloat16: 989e12,
    torch.float32: 67e12,
    torch.int8: 1979e12,
}
ITERS = 200


class SmokeError(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = ITERS, warmup: int = 10) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back calls,
    measured with CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float, dtype) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_k1(quantize_rows, quantize_rows_plain, dev) -> dict:
    g = torch.Generator(device=dev).manual_seed(1)
    cases = [("prefill", 1024, 64, torch.bfloat16),
             ("decode", 64, 64, torch.bfloat16),
             ("ragged", 1001, 128, torch.float32)]
    out = {}
    for name, nb, bs, dt in cases:
        x = (torch.randn((nb, bs), generator=g, device=dev) * 3.0).to(dt)
        x[7] = 0.0  # an all-zero row: scale 0, inv 0
        q, s = quantize_rows(x)
        qp, sp = quantize_rows_plain(x)
        torch.cuda.synchronize()
        require(torch.equal(q, qp), f"K1 {name}: int8 payload differs from plain")
        require(torch.equal(s, sp), f"K1 {name}: scales differ from plain")
        elt = x.element_size()
        n_bytes = nb * bs * elt + nb * bs + nb * 4
        b_ms, b_by = bound_ms(n_bytes, 4.0 * nb * bs, torch.float32)
        out[name] = {
            "shape": [nb, bs], "dtype": str(dt).replace("torch.", ""),
            "max_abs_err": float((q.int() - qp.int()).abs().max()),
            "ms": time_ms(lambda: quantize_rows(x)),
            "plain_ms": time_ms(lambda: quantize_rows_plain(x)),
            "bound_ms": b_ms, "bound_by": b_by,
        }
    print("phase 3 K1 quantize_rows bit-exact vs plain: " + json.dumps(out))
    return out


def _qkv(b, t, h, d, dt, g, dev):
    """q, k, v as the engine hands them to attention: head-split views of
    one [B, T, 3*H*D] projection (strided, not contiguous)."""
    qkv = torch.randn((b, t, 3 * h * d), generator=g, device=dev).to(dt)
    return [a.reshape(b, t, h, d) for a in qkv.split(h * d, dim=-1)]


def phase_k4(flash_fwd, flash_fwd_plain, dev) -> dict:
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(2)
    cases = [("prefill_bf16", 128, torch.bfloat16, True, 2e-2, 1e-2),
             ("prefill_f32", 128, torch.float32, True, 1e-5, 0.0),
             ("odd_t100_f32_causal", 100, torch.float32, True, 1e-5, 0.0),
             ("odd_t100_f32", 100, torch.float32, False, 1e-5, 0.0)]
    b, h, d = 1, 8, 64
    out = {}
    for name, t, dt, causal, atol, rtol in cases:
        q, k, v = _qkv(b, t, h, d, dt, g, dev)
        o, lse = flash_fwd(q, k, v, causal=causal)
        op, lsep = flash_fwd_plain(q, k, v, causal, 1.0 / d ** 0.5)
        torch.cuda.synchronize()
        err = (o.float() - op.float()).abs()
        lim = atol + rtol * op.float().abs()
        require(bool((err <= lim).all()), f"K4 {name}: o off by {float(err.max())}")
        lse_err = float((lse - lsep).abs().max())
        require(lse_err <= (1e-4 if dt == torch.bfloat16 else 1e-5),
                f"K4 {name}: lse off by {lse_err}")
        pairs = t * (t + 1) // 2 if causal else t * t
        n_bytes = 4 * b * t * h * d * q.element_size() + b * h * t * 4
        b_ms, b_by = bound_ms(n_bytes, 4.0 * d * pairs * h * b, dt)
        qh, kh, vh = (a.transpose(1, 2) for a in (q, k, v))
        rec = {
            "shape": [b, t, h, d], "dtype": str(dt).replace("torch.", ""),
            "causal": causal, "max_abs_err": float(err.max()),
            "lse_max_abs_err": lse_err,
            "ms": time_ms(lambda: flash_fwd(q, k, v, causal=causal)),
            "plain_ms": time_ms(
                lambda: flash_fwd_plain(q, k, v, causal, 1.0 / d ** 0.5)),
            "library_ms": time_ms(
                lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)),
            "bound_ms": b_ms, "bound_by": b_by,
        }
        out[name] = rec
    print("phase 4 K4 flash_fwd vs plain: " + json.dumps(out))
    return out


def serve_config(dtype, impl):
    from ps_pytorch_tpu_torch.models import TransformerConfig

    # the repo's own serving shape: bench.py's serve leg (vocab 2048,
    # d512, depth 6, 8 heads, 128-token prompts + 128 new tokens)
    return TransformerConfig(vocab_size=2048, dim=512, depth=6, heads=8,
                             mlp_ratio=4, max_seq_len=256, compute_dtype=dtype,
                             attention_impl=impl)


def phase_serve(card: str, dev) -> dict:
    from ps_pytorch_tpu_torch.models import init_transformer
    from ps_pytorch_tpu_torch.obs import Tracer, summarize_spans
    from ps_pytorch_tpu_torch.ops.flash_attention import flash_fwd
    from ps_pytorch_tpu_torch.ops.quantize import quantize_rows
    from ps_pytorch_tpu_torch.serve import (
        ServeConfig, ServingEngine, TrafficConfig, make_requests, run_open_loop,
    )

    cfg = serve_config(torch.bfloat16, "flash")
    params = init_transformer(cfg, torch.Generator().manual_seed(0), device=dev)
    tracer = Tracer("chip_smoke_serve")
    engine = ServingEngine(cfg, params, ServeConfig(
        slots=8, max_len=256, max_prompt_len=128, kv_int8=True,
    ), tracer=tracer, device=dev)
    engine.warmup()
    tracer.drain()
    tc = TrafficConfig(n_requests=32, rate_rps=100.0, prompt_len_min=64,
                       prompt_len_max=128, new_tokens_min=64,
                       new_tokens_max=128, vocab_size=cfg.vocab_size, seed=0)
    requests = make_requests(tc)
    done = []
    tick = engine.tick

    def recording_tick():
        out = tick()
        done.extend(out)
        return out

    engine.tick = recording_tick
    p0, d0 = engine.n_prefills, engine.n_decode_steps
    flash_fwd.launches = 0
    quantize_rows.launches = 0
    summary = run_open_loop(engine, requests)
    torch.cuda.synchronize()
    launches = {"flash_fwd": flash_fwd.launches,
                "quantize_rows": quantize_rows.launches}
    prefills = engine.n_prefills - p0
    steps = engine.n_decode_steps - d0

    require(summary["requests_completed"] == 32 and len(done) == 32,
            f"serve: {summary['requests_completed']}/32 requests completed")
    by_rid = {c.rid: c for c in done}
    for r in requests:
        c = by_rid[r.rid]
        require(len(c.tokens) == r.max_new_tokens, f"serve: rid {r.rid} short")
        require(all(0 <= t < cfg.vocab_size for t in c.tokens),
                f"serve: rid {r.rid} token out of range")
    for key in ("p50_token_latency_s", "p99_token_latency_s"):
        require(summary[key] is not None and np.isfinite(summary[key]),
                f"serve: {key} not finite")
    require(prefills == 32, f"serve: {prefills} prefills for 32 requests")
    require(launches["flash_fwd"] == cfg.depth * prefills,
            f"serve: K4 launched {launches['flash_fwd']} times, expected "
            f"{cfg.depth} x {prefills} prefills")
    require(launches["quantize_rows"] == 2 * cfg.depth * (prefills + steps),
            f"serve: K1 launched {launches['quantize_rows']} times, expected "
            f"{2 * cfg.depth} x ({prefills} prefills + {steps} decode steps)")
    rec = {
        "card": card, "model": "d512x6 vocab2048 bf16 flash-prefill int8-kv",
        "slots": 8, "prefills": prefills, "decode_steps": steps,
        "launches": launches, "summary": summary,
        "phases": summarize_spans(tracer.drain()),
    }
    print("phase 5 serve: " + json.dumps(rec))
    return rec


def _top2_margin(cfg, params, prompt, upto: int, dev) -> float:
    """Greedy replay of the per-sequence path to the decode step that
    emits new token ``upto``; returns that step's top-2 logit margin."""
    from ps_pytorch_tpu_torch.models.decode import _decode_one, init_kv_cache, prefill

    t_prompt = len(prompt)
    buf = torch.zeros((1, t_prompt + upto + 1), dtype=torch.long, device=dev)
    buf[0, :t_prompt] = torch.from_numpy(prompt.astype(np.int64)).to(dev)
    cache = init_kv_cache(cfg, 1, 256, device=dev)
    with torch.no_grad():
        if t_prompt > 1:
            cache = prefill(cfg, params, buf[:, : t_prompt - 1], cache)
        for pos in range(t_prompt - 1, t_prompt + upto):
            logits, cache = _decode_one(cfg, params, cache, buf[:, pos], pos)
            buf[:, pos + 1] = torch.argmax(logits, dim=-1)
    top2 = torch.topk(logits[0], 2).values
    return float(top2[0] - top2[1])


def phase_exact(dev) -> dict:
    from ps_pytorch_tpu_torch.models import generate, init_transformer
    from ps_pytorch_tpu_torch.serve import Request, ServeConfig, ServingEngine

    cfg = serve_config(torch.float32, "flash")
    params = init_transformer(cfg, torch.Generator().manual_seed(3), device=dev)
    engine = ServingEngine(cfg, params, ServeConfig(
        slots=8, max_len=256, max_prompt_len=128, kv_int8=False), device=dev)
    engine.warmup()
    rng = np.random.RandomState(1)
    reqs = [Request(rid=i, prompt=rng.randint(0, cfg.vocab_size, p).astype(np.int32),
                    max_new_tokens=16)
            for i, p in enumerate((9, 16, 5, 13))]
    outs = engine.decode_requests(reqs)
    mismatches = []
    for c, r in zip(outs, reqs):
        want = generate(cfg, params, torch.from_numpy(r.prompt)[None], 16,
                        max_len=256, device=dev)[0, len(r.prompt):].cpu().numpy()
        got = np.asarray(c.tokens)
        if not np.array_equal(got, want):
            i = int(np.nonzero(got != want)[0][0])
            margin = _top2_margin(cfg, params, r.prompt, i, dev)
            mismatches.append({"rid": r.rid, "index": i, "top2_margin": margin})
            require(margin < 1e-4, f"exact: rid {r.rid} diverges at new token "
                    f"{i} with top-2 margin {margin}")
    rec = {"requests": len(reqs), "new_tokens": 16 * len(reqs),
           "mismatches_on_near_ties": mismatches}
    print("phase 6 f32 engine == per-sequence generate: " + json.dumps(rec))
    return rec

# ResNet18's largest leaf (BasicBlock_7/Conv_1 kernel) and the wire's
# worker count: the shapes the training path hands K2 and K1
RESNET18_LEAVES = 62
BIG_LEAF = (3, 3, 512, 512)
WORKERS = 8
# ResNet18's 11173962 parameters padded to n*s = 8 x 1396746: the fused
# two-round payload K3 sums per step
RESNET18_PADDED = 11173968


def phase_k2(dev) -> dict:
    from ps_pytorch_tpu_torch.ops.quantize import quantize_tensor, quantize_tensor_plain

    g = torch.Generator(device=dev).manual_seed(7)
    cases = [("largest_leaf", (WORKERS,) + BIG_LEAF), ("bn_leaf", (WORKERS, 512)),
             ("dense_bias", (WORKERS, 10)), ("ragged_odd", (WORKERS, 12345)),
             ("all_zero", (WORKERS, 4099))]
    out = {}
    for name, shape in cases:
        x = torch.randn(shape, generator=g, device=dev) * 0.01
        if name == "all_zero":
            x.zero_()
        q, s = quantize_tensor(x)
        qp, sp = quantize_tensor_plain(x)
        torch.cuda.synchronize()
        require(torch.equal(q, qp), f"K2 {name}: int8 payload differs from plain")
        require(torch.equal(s, sp), f"K2 {name}: scale differs from plain")
        if name == "all_zero":
            require(float(s) == 0.0 and not bool(q.any()), "K2 all_zero: scale or payload != 0")
        n = x.numel()
        # the contract's bound: x read once, q written once, one scale; the
        # two-launch design reads x twice (absmax, then quantize)
        b_ms, b_by = bound_ms(4 * n + n + 4, 4.0 * n, torch.float32)
        out[name] = {
            "shape": list(shape), "max_abs_err": float((q.int() - qp.int()).abs().max()),
            "scale_equal": True,
            "ms": time_ms(lambda: quantize_tensor(x)),
            "plain_ms": time_ms(lambda: quantize_tensor_plain(x)),
            "bound_ms": b_ms, "bound_by": b_by,
            "two_pass_floor_ms": (8 * n + n + 4) / HBM_BYTES_PER_S * 1e3,
        }
    print("phase 7 K2 quantize_tensor bit-exact vs plain: " + json.dumps(out))
    return out


def phase_k1_scaled(dev) -> dict:
    from ps_pytorch_tpu_torch.ops.quantize import (
        quantize_rows_scaled,
        quantize_rows_scaled_plain,
    )

    g = torch.Generator(device=dev).manual_seed(8)
    nb = int(np.prod(BIG_LEAF)) // 128
    x = torch.randn((WORKERS * nb, 128), generator=g, device=dev) * 0.01
    x.view(WORKERS, nb, 128)[:, 5] = 0.0  # one block all-zero on every worker
    absmax = x.abs().view(WORKERS, nb, 128).amax(dim=(0, 2))
    q, s = quantize_rows_scaled(x, absmax)
    qp, sp = quantize_rows_scaled_plain(x, absmax)
    torch.cuda.synchronize()
    require(torch.equal(q, qp), "K1 scaled: int8 payload differs from plain")
    require(torch.equal(s, sp), "K1 scaled: scales differ from plain")
    n = x.numel()
    b_ms, b_by = bound_ms(4 * n + 4 * nb + n + 4 * nb, 4.0 * n, torch.float32)
    out = {"shape": [WORKERS * nb, 128], "shared_rows": nb,
           "max_abs_err": float((q.int() - qp.int()).abs().max()),
           "ms": time_ms(lambda: quantize_rows_scaled(x, absmax)),
           "plain_ms": time_ms(lambda: quantize_rows_scaled_plain(x, absmax)),
           "bound_ms": b_ms, "bound_by": b_by}
    print("phase 8 K1 quantize_rows_scaled bit-exact vs plain: " + json.dumps(out))
    return out


TRAIN_ARGS = ["--network", "ResNet18", "--dataset", "Cifar10", "--num-workers",
              str(WORKERS), "--batch-size", "128", "--lr", "0.1", "--momentum", "0.9",
              "--num-aggregate", "5", "--compress-grad", "compress", "--log-interval",
              "1", "--device", "cuda", "--no-checkpoints"]


def _train(steps: int, extra=()) -> dict:
    from ps_pytorch_tpu_torch.cli import train as cli_train

    return cli_train.main(TRAIN_ARGS + ["--max-steps", str(steps), *extra])


def phase_train(card: str) -> dict:
    from ps_pytorch_tpu_torch.ops.quantize import quantize_rows_scaled, quantize_tensor

    steps = 20
    quantize_tensor.launches = 0
    quantize_rows_scaled.launches = 0
    out = _train(steps)
    torch.cuda.synchronize()
    k2, k1s = quantize_tensor.launches, quantize_rows_scaled.launches
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    require(len(losses) == steps and all(np.isfinite(v) for v in losses),
            f"train: losses {losses}")
    require(out["train"]["skipped_steps"] == 0.0, "train: a step was skipped")
    require(k2 == RESNET18_LEAVES * steps,
            f"train: K2 launched {k2} times, expected {RESNET18_LEAVES} x {steps}")
    require(k1s == 0, f"train: K1 scaled launched {k1s} times on the per-tensor wire")
    times = [h["time_cost"] for h in hist[3:]]  # after warm-up (cuDNN autotune)
    p50 = float(np.median(times))
    rec = {"card": card, "model": "ResNet18 synthetic Cifar10 f32 (TF32 off)",
           "workers": WORKERS, "batch_per_worker": 128, "steps": steps,
           "wire": "int8 per-tensor, num-aggregate 5 random_k",
           "launches": {"quantize_tensor": k2, "quantize_rows_scaled": k1s},
           "loss_first": losses[0], "loss_last": losses[-1],
           "step_ms_p50": p50 * 1e3, "step_ms_min": min(times) * 1e3,
           "step_ms_max": max(times) * 1e3,
           "images_per_s": WORKERS * 128 / p50, "val": out["val"]}
    print("phase 9 train ResNet18 int8 per-tensor: " + json.dumps(rec))

    steps_b = 3
    quantize_tensor.launches = 0
    quantize_rows_scaled.launches = 0
    out_b = _train(steps_b, ["--quant-block-size", "128"])
    torch.cuda.synchronize()
    k1s_b, k2_b = quantize_rows_scaled.launches, quantize_tensor.launches
    lb = [h["loss"] for h in out_b["history"]]
    require(all(np.isfinite(v) for v in lb), f"train block-128: losses {lb}")
    require(k1s_b == RESNET18_LEAVES * steps_b,
            f"train block-128: K1 scaled launched {k1s_b} times, expected "
            f"{RESNET18_LEAVES} x {steps_b}")
    require(k2_b == 0, f"train block-128: K2 launched {k2_b} times")
    rec_b = {"wire": "int8 block-128", "steps": steps_b,
             "launches": {"quantize_rows_scaled": k1s_b, "quantize_tensor": k2_b},
             "losses": lb,
             "step_ms_last": out_b["history"][-1]["time_cost"] * 1e3}
    print("phase 9b train ResNet18 int8 block-128: " + json.dumps(rec_b))
    rec["block128"] = rec_b
    return rec


def phase_k3(dev) -> dict:
    from ps_pytorch_tpu_torch.ops.quantize import (
        accumulate_rescale_int8,
        accumulate_rescale_plain,
    )

    g = torch.Generator(device=dev).manual_seed(11)
    cases = [("resnet18_fused", WORKERS, RESNET18_PADDED),
             ("resnet18_region", WORKERS, RESNET18_PADDED // WORKERS),
             ("ragged", WORKERS, 130), ("int16_capacity", 258, 4096), ("one", 1, 1)]
    out = {}
    for name, n, s in cases:
        recv = torch.randint(-127, 128, (n, s), generator=g, device=dev,
                             dtype=torch.int32).to(torch.int8)
        recv[:, 0] = 127  # a full-scale column
        err = 0
        for d in (5.0, 8.0, torch.tensor(float(n), device=dev)):
            k3 = accumulate_rescale_int8(recv, d)
            plain = accumulate_rescale_plain(recv, d)
            torch.cuda.synchronize()
            require(torch.equal(k3, plain), f"K3 {name} divisor {d}: differs from plain")
            err = max(err, int((k3.int() - plain.int()).abs().max()))
        # the contract's bound: recv read once, the int8 row written once;
        # n adds per column on the int8 path
        b_ms, b_by = bound_ms(n * s + s, float(n * s), torch.int8)
        out[name] = {
            "shape": [n, s], "max_abs_err": float(err),
            "ms": time_ms(lambda: accumulate_rescale_int8(recv, 5.0)),
            "plain_ms": time_ms(lambda: accumulate_rescale_plain(recv, 5.0), iters=20),
            "bound_ms": b_ms, "bound_by": b_by,
        }
    print("phase 11 K3 accumulate_rescale_int8 bit-exact vs plain: " + json.dumps(out))
    return out


def _pieces(cfg, params) -> int:
    """How many pieces the config's wire ships per step (one per leaf,
    or one per bucket of its plan), from the port's own geometry."""
    from ps_pytorch_tpu_torch.parallel.buckets import tree_layout, tree_leaves
    from ps_pytorch_tpu_torch.parallel.ps import state_plan

    if cfg.bucket_bytes is None and cfg.opt_placement != "sharded":
        return len(tree_leaves(params))
    return state_plan(cfg, tree_layout(params).total).n_buckets


def expected_launches(cfg, params) -> dict:
    """Kernel launches per step of ``cfg``'s wire, computed from the code:
    round 1 quantizes each piece once (K2 per tensor, K1 shared-scale per
    block); the dequant two-round wire requantizes each piece's N regions
    (K2 each, or one K1 fused launch over every region's rows); the
    homomorphic two-round wire runs K3 once per piece; the ZeRO-1 wire has
    round 1 only."""
    p = _pieces(cfg, params)
    block = bool(cfg.quant_block_size)
    two_round = cfg.compress == "int8_2round" and cfg.opt_placement != "sharded"
    hom = cfg.wire_domain == "homomorphic"
    return {
        "quantize_tensor": 0 if block else p * (1 + (WORKERS if two_round and not hom else 0)),
        "quantize_rows_scaled": p if block else 0,
        "quantize_rows": p if block and two_round and not hom else 0,
        "accumulate_rescale_int8": p if two_round and hom else 0,
    }


def _counters():
    from ps_pytorch_tpu_torch.ops import quantize as q

    return {name: getattr(q, name) for name in (
        "quantize_tensor", "quantize_rows_scaled", "quantize_rows", "accumulate_rescale_int8")}


def reset_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def phase_train_wires(card: str) -> dict:
    from ps_pytorch_tpu_torch.cli._flags import add_ps_flags, add_train_flags, ps_config_from
    from ps_pytorch_tpu_torch.models import build_model, init_model

    resnet, _ = init_model(build_model("ResNet18"), torch.Generator().manual_seed(0),
                           device="cpu")
    runs = [("autotune_best", 10, ["--compress-grad", "2round", "--bucket-bytes", "0",
                                   "--wire-domain", "homomorphic"]),
            ("2round_dequant", 3, ["--compress-grad", "2round", "--bucket-bytes", "0"]),
            ("zero1_2round", 3, ["--opt-placement", "sharded", "--compress-grad", "2round"])]
    parser = add_ps_flags(add_train_flags(argparse.ArgumentParser()))
    out = {}
    for name, steps, flags in runs:
        # the config cli.train builds from these flags
        cfg = ps_config_from(parser.parse_args(TRAIN_ARGS + flags), WORKERS)
        want = {k: v * steps for k, v in expected_launches(cfg, resnet).items()}
        reset_counts()
        res = _train(steps, flags)
        torch.cuda.synchronize()
        got = read_counts()
        hist = res["history"]
        losses = [h["loss"] for h in hist]
        require(len(losses) == steps and all(np.isfinite(v) for v in losses),
                f"train {name}: losses {losses}")
        require(res["train"]["skipped_steps"] == 0.0, f"train {name}: a step was skipped")
        require(got == want, f"train {name}: launches {got}, expected {want}")
        rec = {"flags": " ".join(flags), "steps": steps, "launches": got,
               "loss_first": losses[0], "loss_last": losses[-1]}
        if steps >= 10:
            times = [h["time_cost"] for h in hist[3:]]  # after cuDNN's warm-up
            p50 = float(np.median(times))
            rec.update({"card": card, "step_ms_p50": p50 * 1e3,
                        "step_ms_min": min(times) * 1e3, "step_ms_max": max(times) * 1e3,
                        "images_per_s": WORKERS * 128 / p50})
        out[name] = rec
    require(out["autotune_best"]["launches"]["accumulate_rescale_int8"] == 10,
            "train autotune_best: K3 not launched once per step")
    print("phase 12 train ResNet18 on the two-round / homomorphic / ZeRO-1 wires: "
          + json.dumps(out))
    return out


def _lenet_pair(dev, cfg_kw, faults=None):
    from ps_pytorch_tpu_torch.data import make_preprocessor
    from ps_pytorch_tpu_torch.models import build_model, init_model
    from ps_pytorch_tpu_torch.optim import build_optimizer
    from ps_pytorch_tpu_torch.parallel.ps import PSConfig, init_ps_state, make_ps_train_step
    from ps_pytorch_tpu_torch.resilience.faults import FaultPlan

    cfg = PSConfig(num_workers=WORKERS, **cfg_kw)
    model = build_model("LeNet")
    params, _ = init_model(model, torch.Generator().manual_seed(5), device="cpu")
    plan = FaultPlan(**faults) if faults else None
    out = {}
    for d in ("cpu", dev):
        tx = build_optimizer("sgd", 0.02, momentum=0.9)
        st = init_ps_state(model, tx, cfg, params=params, batch_stats={}, device=d)
        step = make_ps_train_step(model, tx, cfg, preprocess=make_preprocessor("MNIST", True),
                                  faults=plan, device=d)
        out[str(torch.device(d).type)] = (st, step)
    return out


def phase_held(dev) -> dict:
    """One LeNet step at 8 workers: card (kernels) vs CPU (plain
    versions). Tolerance: the two devices' f32 convolutions differ in
    their last bits, so a few int8 payloads round the other way; every
    param must agree within 1% of the step's largest update and at most
    1% of them may differ by more than 1e-6."""
    from ps_pytorch_tpu_torch.data import make_synthetic
    from ps_pytorch_tpu_torch.ops.quantize import quantize_rows_scaled, quantize_tensor
    from ps_pytorch_tpu_torch.parallel.ps import StepDraws

    d = make_synthetic("MNIST", train_size=WORKERS * 16, test_size=8, seed=4)
    batch = {"image": d.train_images, "label": d.train_labels}
    perm = torch.tensor([3, 0, 6, 1, 5, 2, 7, 4])
    out = {}
    for name, kw in (("per_tensor", dict(compress="int8", num_aggregate=5)),
                     ("block128", dict(compress="int8", quant_block_size=128,
                                       num_aggregate=5))):
        pair = _lenet_pair(dev, kw)
        res = {}
        for key, (st, step) in pair.items():
            k2, k1s = quantize_tensor.launches, quantize_rows_scaled.launches
            p0 = st.params.flat.detach().cpu().clone()
            st, m = step(st, batch, StepDraws(perm=perm))
            res[key] = (st.params.flat.detach().cpu(), p0, float(m["loss"]),
                        quantize_tensor.launches - k2, quantize_rows_scaled.launches - k1s)
        (pc, p0, lc, _, _), (pg, _, lg, k2g, k1g) = res["cpu"], res["cuda"]
        moved = float((pc - p0).abs().max())
        diff = (pc - pg).abs()
        require(float(diff.max()) <= 1e-2 * moved,
                f"held {name}: card vs CPU params differ by {float(diff.max())} "
                f"(update {moved})")
        frac = float((diff > 1e-6).float().mean())
        require(frac <= 0.01, f"held {name}: {frac:.4f} of params differ by > 1e-6")
        want = (8, 0) if name == "per_tensor" else (0, 8)
        require((k2g, k1g) == want,
                f"held {name}: launches K2 {k2g}, K1 scaled {k1g}, expected {want}")
        out[name] = {"max_abs_diff": float(diff.max()), "max_update": moved,
                     "frac_diff_gt_1e-6": frac, "loss_cpu": lc, "loss_cuda": lg}
    pair = _lenet_pair(dev, dict(compress="int8"), faults={"nan_grads": [1]})
    st, step = pair["cuda"]
    p0 = st.params.flat.clone()
    st, m = step(st, batch, StepDraws())
    require(torch.equal(st.params.flat, p0), "held nan: params moved on a NaN step")
    require(float(m["skipped_steps"]) == 1.0, "held nan: skipped_steps != 1")
    out["nan_step"] = {"params_unchanged": True, "skipped_steps": 1.0}
    print("phase 10 train held on the card vs CPU (LeNet, 8 workers): " + json.dumps(out))
    return out


def phase_held_wires(dev) -> dict:
    """Phase 10's card-vs-CPU rule on the wires of this slice, with one
    change for the two-round wires: their second rounding (K3's rescale
    by K, or round 2's requantize of the region sums) sits on a lattice up
    to K times coarser than round 1's, so one element that rounds the
    other way on the card moves its param by up to K times what a flip
    on the one-round wire does; there the bound is K% of the update."""
    from ps_pytorch_tpu_torch.data import make_synthetic
    from ps_pytorch_tpu_torch.parallel.ps import PSConfig, StepDraws

    d = make_synthetic("MNIST", train_size=WORKERS * 16, test_size=8, seed=4)
    batch = {"image": d.train_images, "label": d.train_labels}
    perm = torch.tensor([3, 0, 6, 1, 5, 2, 7, 4])
    wires = {
        "autotune_best_ef": dict(compress="int8_2round", bucket_bytes=0,
                                 wire_domain="homomorphic", num_aggregate=5,
                                 error_feedback=True),
        "int8_homomorphic_64k": dict(compress="int8", bucket_bytes=65536,
                                     wire_domain="homomorphic", num_aggregate=5),
        "2round_dequant_block128": dict(compress="int8_2round", quant_block_size=128,
                                        num_aggregate=5),
        "zero1_int8_homomorphic": dict(opt_placement="sharded", compress="int8",
                                       wire_domain="homomorphic", num_aggregate=5),
    }
    out = {}
    for name, kw in wires.items():
        pair = _lenet_pair(dev, kw)
        res = {}
        for key, (st, step) in pair.items():
            reset_counts()
            p0 = st.params.flat.detach().cpu().clone()
            st, m = step(st, batch, StepDraws(perm=perm))
            res[key] = (st.params.flat.detach().cpu(), p0, float(m["loss"]), read_counts(),
                        float(m["skipped_steps"]))
        (pc, p0, lc, _, _), (pg, _, lg, counts, skipped) = res["cpu"], res["cuda"]
        cfg = PSConfig(num_workers=WORKERS, **kw)
        coarse = cfg.compress == "int8_2round" and cfg.opt_placement != "sharded"
        bound = 1e-2 * (cfg.effective_aggregate if coarse else 1)
        moved = float((pc - p0).abs().max())
        diff = (pc - pg).abs()
        require(float(diff.max()) <= bound * moved,
                f"held {name}: card vs CPU params differ by {float(diff.max())} "
                f"(update {moved}, bound {bound} of it)")
        frac = float((diff > 1e-6).float().mean())
        require(frac <= 0.01, f"held {name}: {frac:.4f} of params differ by > 1e-6")
        require(skipped == 0.0, f"held {name}: the card skipped the step")
        want = expected_launches(cfg, pair["cpu"][0].params.tree())
        require(counts == want, f"held {name}: launches {counts}, expected {want}")
        out[name] = {"max_abs_diff": float(diff.max()), "max_update": moved,
                     "bound_fraction": bound, "frac_diff_gt_1e-6": frac, "loss_cpu": lc,
                     "loss_cuda": lg, "launches": counts}
    print("phase 13 wires held on the card vs CPU (LeNet, 8 workers): " + json.dumps(out))
    return out



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from ps_pytorch_tpu_torch.ops import _build
    from ps_pytorch_tpu_torch.ops.flash_attention import flash_fwd, flash_fwd_plain
    from ps_pytorch_tpu_torch.ops.quantize import quantize_rows, quantize_rows_plain

    # f32 comparisons on the card need full f32 products: TF32 off for
    # matmuls and for cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(smi)
    print(f"phase 1 device: {card} | torch {torch.__version__} | "
          f"cuda {torch.version.cuda} | tf32 off")

    t0 = time.perf_counter()
    _build.build()
    _build.load()
    print(f"phase 2 build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(os.path.basename(s) for s in _build.sources())} -> "
          f"{os.path.relpath(_build.library_path())})")

    k1 = phase_k1(quantize_rows, quantize_rows_plain, dev)
    k4 = phase_k4(flash_fwd, flash_fwd_plain, dev)
    serve = phase_serve(card, dev)
    phase_exact(dev)
    k2 = phase_k2(dev)
    k1s = phase_k1_scaled(dev)
    train = phase_train(smi)
    phase_held(dev)
    k3 = phase_k3(dev)
    wires = phase_train_wires(smi)
    phase_held_wires(dev)

    kernels = [
        {
            "name": "quantize_rows", "route": "cuda",
            "source": "ps_pytorch_tpu_torch/csrc/quantize_rows.cu",
            "replaces": "ps_pytorch_tpu/ops/quantize.py:101",
            "launches": serve["launches"]["quantize_rows"],
            "max_abs_err": max(r["max_abs_err"] for r in k1.values()),
            "ms": k1["prefill"]["ms"], "plain_ms": k1["prefill"]["plain_ms"],
            "bound_ms": k1["prefill"]["bound_ms"],
            "bound_by": k1["prefill"]["bound_by"], "library_ms": None,
        },
        {
            "name": "quantize_rows_scaled", "route": "cuda",
            "source": "ps_pytorch_tpu_torch/csrc/quantize_rows.cu",
            "replaces": "ps_pytorch_tpu/ops/quantize.py:101",
            "launches": train["block128"]["launches"]["quantize_rows_scaled"],
            "max_abs_err": k1s["max_abs_err"], "ms": k1s["ms"],
            "plain_ms": k1s["plain_ms"], "bound_ms": k1s["bound_ms"],
            "bound_by": k1s["bound_by"], "library_ms": None,
        },
        {
            "name": "quantize_tensor", "route": "cuda",
            "source": "ps_pytorch_tpu_torch/csrc/quantize_tensor.cu",
            "replaces": "ps_pytorch_tpu/ops/quantize.py:78",
            "launches": train["launches"]["quantize_tensor"],
            "max_abs_err": max(r["max_abs_err"] for r in k2.values()),
            "ms": k2["largest_leaf"]["ms"], "plain_ms": k2["largest_leaf"]["plain_ms"],
            "bound_ms": k2["largest_leaf"]["bound_ms"],
            "bound_by": k2["largest_leaf"]["bound_by"], "library_ms": None,
        },
        {
            "name": "accumulate_rescale", "route": "cuda",
            "source": "ps_pytorch_tpu_torch/csrc/accum_rescale.cu",
            "replaces": "ps_pytorch_tpu/ops/quantize.py:424",
            "launches": wires["autotune_best"]["launches"]["accumulate_rescale_int8"],
            "max_abs_err": max(r["max_abs_err"] for r in k3.values()),
            "ms": k3["resnet18_fused"]["ms"], "plain_ms": k3["resnet18_fused"]["plain_ms"],
            "bound_ms": k3["resnet18_fused"]["bound_ms"],
            "bound_by": k3["resnet18_fused"]["bound_by"], "library_ms": None,
        },
        {
            "name": "flash_fwd", "route": "cuda",
            "source": "ps_pytorch_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "ps_pytorch_tpu/ops/flash_attention.py:199",
            "launches": serve["launches"]["flash_fwd"],
            "max_abs_err": k4["prefill_bf16"]["max_abs_err"],
            "ms": k4["prefill_bf16"]["ms"],
            "plain_ms": k4["prefill_bf16"]["plain_ms"],
            "bound_ms": k4["prefill_bf16"]["bound_ms"],
            "bound_by": k4["prefill_bf16"]["bound_by"],
            "library_ms": k4["prefill_bf16"]["library_ms"],
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
