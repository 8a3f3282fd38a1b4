#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one H100 and hold each of
its hand-written kernels against its plain PyTorch version.

    python3 chip_smoke.py

Needs one CUDA card (exits non-zero without one, and without the
``ps_pytorch_tpu_torch`` package beside this file). Imports nothing of JAX.

Phases, one line each:

1. the card (nvidia-smi name and power limit), torch/CUDA versions, TF32 off;
2. build both kernels from ``ps_pytorch_tpu_torch/csrc`` with nvcc (sm_90a);
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
7. the kernels JSON line, then the result line.

Any mismatch raises; the exit code is then non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_OPS_PER_S = {                 # H100 SXM dense tensor-core peaks
    torch.bfloat16: 989e12,
    torch.float32: 67e12,
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
