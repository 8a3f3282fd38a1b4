#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, PS-training and LM-training
paths on one H100 and hold each of its hand-written kernels against its
plain PyTorch version.

    python3 chip_smoke.py

Needs one CUDA card (exits non-zero without one, and without the
``ps_pytorch_tpu_torch`` package beside this file). Imports nothing of JAX.

Phases, one line each:

1. the card (nvidia-smi name and power limit), torch/CUDA versions, TF32 off;
2. build every kernel from ``ps_pytorch_tpu_torch/csrc`` (one nvcc per
   source, all at once; sm_90a), then count the tensor-core instructions
   (HMMA / HGMMA, from ``cuobjdump -sass``) of each tensor-core
   instantiation: K4 bf16 (D 32, 64, 128; normalized and partial), K5 /
   K6 bf16 (D 32, 64, 128; f32 and bf16 out) and K5 / K6 f32 (D 32, 64,
   128; their TF32 ``HMMA.1688.F32.TF32`` lines); a zero fails the run;
   beside ptxas's registers and spill bytes, and the registers and spills
   of K2's and K1's multi-tensor kernels;
3. K1 quantize_rows vs its plain version, bit-exact, at the serving path's
   shapes (prefill write [1024, 64] bf16, decode write [64, 64] bf16) and a
   ragged [1001, 128] f32, timed with CUDA events;
4. K4 flash_fwd vs its plain version at the prefill shape [1, 128, 8, 64]
   (bf16 and f32, causal), at head dims 32 and 128 (bf16) and an odd
   T = 100, twice (the same bits); timed with CUDA events and
   ``torch.profiler``'s device time (which also shows the route: bf16 runs
   ``flash_fwd_mma_kernel``, f32 ``flash_fwd_scalar_kernel``) beside
   ``scaled_dot_product_attention`` (the library yardstick, never called by
   the port) and its bound;
5. serve: d512 x 6 bf16 model, flash prefill, int8 KV pool, 8 slots,
   32 open-loop requests; every request completes, tokens in range, p50/p99
   finite, and the kernel launch counters match the work done;
6. f32 engine vs the port's per-sequence ``generate`` on the card;
7. K2 (one-piece calls of ``quantize_tensors``) vs its plain version,
   bit-exact (payload and scale), at the training wire's shapes: the
   largest ResNet18 leaf stacked for 8 workers [8, 3, 3, 512, 512], a BN
   leaf [8, 512], the dense bias [8, 10], a ragged odd length and an
   all-zero tensor; timed, with its bound; then the per-leaf wire's step:
   ResNet18's 62 stacked leaves in one ``quantize_tensors`` call,
   bit-exact against the plain version, with its device time, host
   wrapper time and device launches a step beside the bound and the
   two-pass floor;
8. K1's shared-scale entry ``quantize_rows_scaled_many`` vs its plain
   version, bit-exact, at the largest leaf's block-128 rows [8, 18432,
   128], then the block-128 wire's step (the 62 leaves in one call) as in
   phase 7;
9. train: ResNet18 at full width on synthetic CIFAR-10, 8 stacked workers,
   batch 128 each, lr 0.1, momentum 0.9, num-aggregate 5 (random_k), the
   int8 per-tensor wire, through ``cli.train.main``: every loss finite, no
   skipped step, one K2 call per step (all 62 leaves); step time p50 and
   images/s; then a short run on the block-128 wire (one call of K1's
   shared-scale entry per step);
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
   losses, no skipped step, exactly one K3 and one K2 call per step;
   then 3 steps of the dequant two-round wire (two K2 calls per step:
   round 1, and round 2 over all eight regions) and 3 of the ZeRO-1
   placement on the two-round wire (one K2 call per bucket);
13. one LeNet step at 8 workers, card vs CPU (phase 10's rule, with K
   times its bound on the two-round wires' coarser second rounding), on the
   autotune-best wire with EF, int8 homomorphic in 64 KiB buckets, the
   two-round dequant wire with block-128 scales and ZeRO-1 int8
   homomorphic, each with its launch counts;
14. K4's partial triple flash_partial, K5 flash_bwd_dq and K6
   flash_bwd_dkv against their plain versions at the LM-1 attention shape
   [8, 1024, 8, 64] (one causal hop at offsets 0) and at an LM-ring hop
   [8, 2048, 8, 64] (four stacked shards x batch 2, per-shard offsets of
   hop 3: one shard's keys all masked), each in bf16 and f32, each twice
   (the same bits); timed with CUDA events and ``torch.profiler``'s
   device time (which also shows each call's route), with their bounds;
   K4-partial beside aten's forward and K5 + K6 beside its backward (the
   library yardsticks, never called by the port: wall and device time):
   for bf16 aten's flash forward and the backward sdpa picks by default,
   for f32 memory-efficient attention both ways;
15. LM-1: the JAX bench's LM leg at full width (vocab 2048, d512, depth
   6, 8 heads, seq 1024, batch 8, bf16 block math over f32 params, remat,
   SGD lr 0.01 momentum 0.9) through ``cli.train_lm.main`` at (dp 1,
   sp 1) with flash attention, 20 steps: every loss finite, launches per
   step exactly L n (1 + remat) K4-partial, L n K5 and L n K6; step p50
   and tokens/s; then 8 steps of the same at ``cli.train_lm``'s default
   ``--dtype float32`` (K5 / K6 on the TF32 route), the same checks;
16. LM-ring: the same model at seq 8192 on (dp 1, sp 4) stacked shards,
   batch 2, 5 steps, the same checks;
17. a small LM step at (dp 2, sp 4), f32: the card (kernels) against the
   CPU (plain versions) on the one-way ring, the bidirectional ring and
   Ulysses (K4 normalized + K5/K6 in the input dtype), each with its
   launch counts;
18. the kernels JSON line, then the result line.

Any mismatch raises; the exit code is then non-zero.

    python3 chip_smoke.py --phases 2,4,7,8,9,14 [--package-root DIR]

runs only the named phases (the build 2; the flash kernels 4 and 14; the
62-leaf wire steps of 7 and 8 alone; the ResNet18 run of 9), against the
``ps_pytorch_tpu_torch`` package under DIR when given (not phase 2, which
checks this tree's kernel list; another checkout:
a parent commit timed in turns with this one on the same card; a parent
without the multi-tensor entries runs its per-leaf loop of
``quantize_int8``), and prints their lines; no kernels line, no result
line.
"""

from __future__ import annotations

import argparse
import json
import os
import re
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
# f32 products on the tensor cores as 3xTF32, three TF32 products each: the
# least time the card needs for an f32-accurate product (the f32 flash
# kernels' bound)
TF32X3_OPS_PER_S = 494.7e12 / 3
ITERS = 200
# set by --package-root: the package timed is another checkout's, whose
# kernels may bear other names than this one's routes
OTHER_TREE = False


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


def device_ms(fn, iters: int = 10) -> tuple:
    """Device time per call from ``torch.profiler`` over ``iters``
    back-to-back calls: for each CUDA kernel name, its mean time per
    recorded launch times its launches per call (at least one), summed;
    and that per name (ms per call). Per-launch means keep the figure
    right when the trace drops some of a kernel's events: summed over the
    calls instead, one run read K5 at 0.16 ms a call where CUDA events
    timed 0.53 ms."""
    total, by_name, _ = device_profile(fn, iters)
    return total, by_name


def device_profile(fn, iters: int = 10) -> tuple:
    """``device_ms``'s figures and the device launches (kernels and
    memsets) per call, by name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = {}
    for _ in range(3):  # a trace may come back with no device events: take another
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                rec = seen.setdefault(evt.name[:80], [0, 0.0])
                rec[0] += 1
                rec[1] += evt.time_range.elapsed_us() / 1e3
        if seen:
            break
    require(bool(seen), "profiler: no device time recorded in three traces")
    per_call = {k: max(1, round(n / iters)) for k, (n, _) in seen.items()}
    by_name = {k: t / n * per_call[k] for k, (n, t) in seen.items()}
    return sum(by_name.values()), by_name, per_call


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the tensor-core instantiations: (kernel, D, variant), K4 by entry, the
# bf16 K5 / K6 by output type, the f32 (TF32) K5 / K6 one per D
TF32_KERNELS = ("flash_dq_tf32_kernel", "flash_dkv_tf32_kernel")
MMA_KERNELS = ([("flash_fwd_mma_kernel", d, f"normalize={n}")
                for d in (32, 64, 128) for n in ("true", "false")]
               + [(k, d, f"out={out}")
                  for k in ("flash_dq_mma_kernel", "flash_dkv_mma_kernel")
                  for d in (32, 64, 128) for out in ("f32", "bf16")]
               + [(k, d, "in=f32") for k in TF32_KERNELS for d in (32, 64, 128)])
_MANGLED_FWD = re.compile(r"(flash_fwd_mma_kernel)ILi(\d+)ELb([01])E")
_MANGLED_BWD = re.compile(r"(flash_d(?:q|kv)_mma_kernel)ILi(\d+)E(?:Li\d+E)?(f|13__nv_bfloat16)E")
_MANGLED_TF32 = re.compile(r"(flash_d(?:q|kv)_tf32_kernel)ILi(\d+)E")


def _instantiation(mangled: str):
    m = _MANGLED_FWD.search(mangled)
    if m is not None:
        return (m.group(1), int(m.group(2)),
                "normalize=" + ("true" if m.group(3) == "1" else "false"))
    m = _MANGLED_TF32.search(mangled)
    if m is not None:
        return (m.group(1), int(m.group(2)), "in=f32")
    m = _MANGLED_BWD.search(mangled)
    return None if m is None else (m.group(1), int(m.group(2)),
                                   "out=" + ("f32" if m.group(3) == "f" else "bf16"))


def _cuobjdump(nvcc: str) -> str:
    import shutil

    for cand in (os.path.join(os.path.dirname(nvcc), "cuobjdump"), shutil.which("cuobjdump")):
        if cand and os.path.exists(cand):
            return cand
    raise SmokeError("cuobjdump not found beside nvcc or on PATH")


def tensor_core_counts(lib_path: str, nvcc: str) -> dict:
    """Tensor-core instructions in the SASS of each K4 / K5 / K6
    tensor-core instantiation of the built library: HMMA / HGMMA lines,
    and for the f32 kernels only their TF32 ones (``HMMA.1688.F32.TF32``)."""
    sass = subprocess.run([_cuobjdump(nvcc), "-sass", lib_path], stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True, check=True).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = _instantiation(line.split("Function :")[1].strip())
            if current is not None:
                counts[current] = 0
        elif current is not None and re.search(
                r"\bHMMA\.\S*TF32" if current[0] in TF32_KERNELS else r"\bHG?MMA\.", line):
            counts[current] += 1
    return counts


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes ptxas reported for each K4 / K5 / K6
    tensor-core instantiation (``-Xptxas -v`` in the build's log)."""
    out, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = _instantiation(m.group(1))
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out.setdefault(current, {}).update(spill_stores=int(m.group(1)),
                                               spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(current, {})["registers"] = int(m.group(1))
    return out


# K2's and K1's multi-tensor kernels, whose registers and spills phase 2
# prints
QUANT_KERNELS = ("absmax_many_kernel", "quantize_many_kernel",
                 "quantize_rows_scaled_many_kernel")


def ptxas_quant_report(log: str) -> dict:
    """Registers and spill bytes ptxas reported for each of QUANT_KERNELS
    (each is one instantiation; ptxas names them mangled)."""
    out, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = next((k for k in QUANT_KERNELS
                            if re.search(r"\d%s" % k, m.group(1))), None)
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out.setdefault(current, {}).update(spill_stores=int(m.group(1)),
                                               spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(current, {})["registers"] = int(m.group(1))
    return out


def phase_build() -> dict:
    """Phase 2: build every kernel, then read the tensor-core instruction
    count of each K4 / K5 / K6 tensor-core instantiation from the
    library's SASS (a zero fails the run) and ptxas's registers and
    spills."""
    from ps_pytorch_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    seconds = time.perf_counter() - t0
    counts = tensor_core_counts(lib, _build._nvcc())
    regs = ptxas_report(_build.build_log())
    rec = {}
    for key in MMA_KERNELS:
        name = f"{key[0]}<D={key[1]}, {key[2]}>"
        require(counts.get(key, 0) > 0,
                f"build: {name} has {counts.get(key, 0)} tensor-core instructions")
        rec[name] = {"tensor_core_instructions": counts[key], **regs.get(key, {})}
    quant = ptxas_quant_report(_build.build_log())
    require(sorted(quant) == sorted(QUANT_KERNELS) and
            all("registers" in v for v in quant.values()),
            f"build: ptxas reported {sorted(quant)} of {QUANT_KERNELS}")
    print(f"phase 2 build: {seconds:.1f} s "
          f"({', '.join(os.path.basename(s) for s in _build.sources())} -> "
          f"{os.path.relpath(lib)}); K4/K5/K6 tensor-core SASS: " + json.dumps(rec)
          + "; K1/K2 multi-tensor: " + json.dumps(quant))
    return rec


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
        b_ms, b_by = bound_ms(n_bytes, 4.0 * nb * bs, PEAK_OPS_PER_S[torch.float32])
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


# Each flash kernel's route for each input type, chosen by dtype with no
# fallback from one to another: (kernel family, dtype) -> kernel
FLASH_ROUTE = {
    ("flash_fwd", torch.bfloat16): "flash_fwd_mma_kernel",
    ("flash_fwd", torch.float32): "flash_fwd_scalar_kernel",
    ("flash_dq", torch.bfloat16): "flash_dq_mma_kernel",
    ("flash_dq", torch.float32): "flash_dq_tf32_kernel",
    ("flash_dkv", torch.bfloat16): "flash_dkv_mma_kernel",
    ("flash_dkv", torch.float32): "flash_dkv_tf32_kernel",
}


def _device_route(what: str, fn, dt, family: str = "flash_fwd") -> tuple:
    """The flash kernel's own device time per call of ``fn`` (an entry of
    ``family``: K4 ``flash_fwd``, K5 ``flash_dq``, K6 ``flash_dkv``) and
    every kernel the call ran (tensor offsets add the small copies that
    build their device table); fails unless the one kernel of the family
    among them is the kernel of ``dt``'s route."""
    _, by_name = device_ms(fn)
    want = FLASH_ROUTE[(family, dt)]
    mine = [name for name in by_name if family + "_" in name]
    require(len(mine) == 1 and (OTHER_TREE or want in mine[0]),
            f"{what}: ran {sorted(by_name)}, expected one {want}")
    return by_name[mine[0]], sorted(by_name)


def phase_k4(flash_fwd, flash_fwd_plain, dev) -> dict:
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(2)
    # name, T, D, dtype, causal, atol, rtol
    cases = [("prefill_bf16", 128, 64, torch.bfloat16, True, 2e-2, 1e-2),
             ("prefill_f32", 128, 64, torch.float32, True, 1e-5, 0.0),
             ("odd_t100_f32_causal", 100, 64, torch.float32, True, 1e-5, 0.0),
             ("odd_t100_f32", 100, 64, torch.float32, False, 1e-5, 0.0),
             ("prefill_bf16_d32", 128, 32, torch.bfloat16, True, 2e-2, 1e-2),
             ("prefill_bf16_d128", 128, 128, torch.bfloat16, True, 2e-2, 1e-2),
             ("odd_t100_bf16_causal", 100, 64, torch.bfloat16, True, 2e-2, 1e-2)]
    b, h = 1, 8
    out = {}
    for name, t, d, dt, causal, atol, rtol in cases:
        q, k, v = _qkv(b, t, h, d, dt, g, dev)
        o, lse = flash_fwd(q, k, v, causal=causal)
        o2, lse2 = flash_fwd(q, k, v, causal=causal)
        op, lsep = flash_fwd_plain(q, k, v, causal, 1.0 / d ** 0.5)
        torch.cuda.synchronize()
        require(torch.equal(o, o2) and torch.equal(lse, lse2),
                f"K4 {name}: changed between two runs")
        err = (o.float() - op.float()).abs()
        lim = atol + rtol * op.float().abs()
        require(bool((err <= lim).all()), f"K4 {name}: o off by {float(err.max())}")
        lse_err = float((lse - lsep).abs().max())
        require(lse_err <= (1e-4 if dt == torch.bfloat16 else 1e-5),
                f"K4 {name}: lse off by {lse_err}")
        pairs = t * (t + 1) // 2 if causal else t * t
        n_bytes = 4 * b * t * h * d * q.element_size() + b * h * t * 4
        rate = TF32X3_OPS_PER_S if dt == torch.float32 else PEAK_OPS_PER_S[dt]
        b_ms, b_by = bound_ms(n_bytes, 4.0 * d * pairs * h * b, rate)
        qh, kh, vh = (a.transpose(1, 2) for a in (q, k, v))
        kernel = lambda: flash_fwd(q, k, v, causal=causal)
        sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)
        dev_ms, kernels = _device_route(f"K4 {name}", kernel, dt)
        rec = {
            "shape": [b, t, h, d], "dtype": str(dt).replace("torch.", ""),
            "causal": causal, "max_abs_err": float(err.max()),
            "lse_max_abs_err": lse_err,
            "ms": time_ms(kernel), "device_ms": dev_ms, "device_kernels": kernels,
            "plain_ms": time_ms(
                lambda: flash_fwd_plain(q, k, v, causal, 1.0 / d ** 0.5)),
            "library_ms": time_ms(sdpa), "library_device_ms": device_ms(sdpa)[0],
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


def resnet18_step_pieces(dev) -> list:
    """ResNet18's 62 leaves stacked for 8 workers, magnitudes varying by
    worker and leaf: the pieces the per-leaf wire quantizes in a step."""
    from ps_pytorch_tpu_torch.models import build_model
    from ps_pytorch_tpu_torch.parallel.buckets import tree_leaves

    params, _ = build_model("ResNet18").init(torch.Generator().manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(12)
    out = []
    for leaf in tree_leaves(params):
        scale = torch.exp(torch.randn((WORKERS,) + (1,) * leaf.dim(), generator=g, device=dev))
        out.append(torch.randn((WORKERS,) + tuple(leaf.shape), generator=g, device=dev)
                   * scale * 0.01)
    require(len(out) == RESNET18_LEAVES, f"ResNet18 has {len(out)} leaves")
    return out


def _wire_entry(block: int):
    """The quantize of one wire step over its pieces, through the
    package's own entry, and that entry's call counter: one
    ``quantize_int8_many`` call where the package has it, else (a parent
    tree) ``quantize_int8`` leaf by leaf, as its wire loop calls it."""
    from ps_pytorch_tpu_torch.ops import quantize as q
    from ps_pytorch_tpu_torch.parallel.mesh import WorkerAxis

    axis = WorkerAxis(WORKERS)
    if hasattr(q, "quantize_int8_many"):
        counter = q.quantize_rows_scaled_many if block else q.quantize_tensors
        return (lambda xs: q.quantize_int8_many(xs, axis, block)), counter
    counter = q.quantize_rows_scaled if block else q.quantize_tensor
    return (lambda xs: [q.quantize_int8(x, axis_name=axis, block_size=block,
                                        return_absmax=True) for x in xs]), counter


def host_ms(fn, reps: int = 20) -> float:
    """Median host time of one call of ``fn`` (the wrapper's enqueue
    cost), each call started on an idle card."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(times)) * 1e3


def wire_step_case(dev, block: int) -> dict:
    """The per-leaf wire's quantize of one ResNet18 step (62 stacked
    leaves; block 0: K2, block 128: K1's shared-scale entry), held
    bit-exact against the same call on CPU copies (the plain versions),
    with its device time, wall and host time, wrapper calls and device
    launches per step beside the bound (x read once, every output written
    once) and the two-pass floor (x read twice)."""
    from ps_pytorch_tpu_torch.ops import quantize as q

    xs = resnet18_step_pieces(dev)
    fn, counter = _wire_entry(block)
    c0 = counter.launches
    got = fn(xs)
    torch.cuda.synchronize()
    calls = counter.launches - c0
    want = fn([x.cpu() for x in xs])
    for i, ((qg, sg, ag), (qw, sw, aw)) in enumerate(zip(got, want)):
        require(torch.equal(qg.cpu(), qw) and torch.equal(sg.cpu(), sw)
                and torch.equal(ag.cpu(), aw),
                f"wire step block {block}: piece {i} differs from the plain version")
    if not OTHER_TREE:
        require(calls == 1, f"wire step block {block}: {calls} wrapper calls, expected 1")
    n_in = sum(x.numel() for x in xs)
    n_out = sum(qg.numel() + 4 * sg.numel() + 4 * ag.numel() for qg, sg, ag in got)
    dev_total, by_name, launches = device_profile(lambda: fn(xs))
    b_ms, b_by = bound_ms(4 * n_in + n_out, 4.0 * n_in, PEAK_OPS_PER_S[torch.float32])
    rec = {
        "pieces": len(xs), "elements": n_in, "wrapper_calls": calls,
        "device_launches": sum(launches.values()),
        "device_ms": dev_total, "device_kernels": {k[:60]: v for k, v in by_name.items()},
        "ms": time_ms(lambda: fn(xs), iters=50), "host_ms": host_ms(lambda: fn(xs)),
        "bound_ms": b_ms, "bound_by": b_by,
        "two_pass_floor_ms": (8 * n_in + n_out) / HBM_BYTES_PER_S * 1e3,
        "max_abs_err": 0.0,
    }
    if not OTHER_TREE:
        plain = (q.quantize_tensors_plain if not block else
                 lambda ys: q.quantize_rows_scaled_many_plain(ys, block))
        rec["plain_ms"] = time_ms(lambda: plain(xs), iters=5)
    return rec


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
        # the contract's bound: x read once, q written once, one scale
        b_ms, b_by = bound_ms(4 * n + n + 4, 4.0 * n, PEAK_OPS_PER_S[torch.float32])
        out[name] = {
            "shape": list(shape), "max_abs_err": float((q.int() - qp.int()).abs().max()),
            "scale_equal": True,
            "ms": time_ms(lambda: quantize_tensor(x)),
            "plain_ms": time_ms(lambda: quantize_tensor_plain(x)),
            "bound_ms": b_ms, "bound_by": b_by,
            "two_pass_floor_ms": (8 * n + n + 4) / HBM_BYTES_PER_S * 1e3,
        }
    out["resnet18_step"] = wire_step_case(dev, 0)
    print("phase 7 K2 quantize_tensors bit-exact vs plain: " + json.dumps(out))
    return out


def phase_k1_scaled(dev) -> dict:
    from ps_pytorch_tpu_torch.ops.quantize import (
        quantize_rows_scaled_many,
        quantize_rows_scaled_many_plain,
    )

    g = torch.Generator(device=dev).manual_seed(8)
    nb = int(np.prod(BIG_LEAF)) // 128
    x = torch.randn((WORKERS, nb * 128), generator=g, device=dev) * 0.01
    x.view(WORKERS, nb, 128)[:, 5] = 0.0  # one block all-zero on every worker
    (q, s, a), = quantize_rows_scaled_many([x], 128)
    (qp, sp, ap), = quantize_rows_scaled_many_plain([x], 128)
    torch.cuda.synchronize()
    require(torch.equal(q, qp), "K1 scaled: int8 payload differs from plain")
    require(torch.equal(s, sp) and torch.equal(a, ap), "K1 scaled: scales differ from plain")
    n = x.numel()
    b_ms, b_by = bound_ms(4 * n + n + 8 * nb, 4.0 * n, PEAK_OPS_PER_S[torch.float32])
    out = {"shape": [WORKERS, nb, 128], "shared_rows": nb,
           "max_abs_err": float((q.int() - qp.int()).abs().max()),
           "ms": time_ms(lambda: quantize_rows_scaled_many([x], 128)),
           "plain_ms": time_ms(lambda: quantize_rows_scaled_many_plain([x], 128)),
           "bound_ms": b_ms, "bound_by": b_by,
           "resnet18_step": wire_step_case(dev, 128)}
    print("phase 8 K1 quantize_rows_scaled_many bit-exact vs plain: " + json.dumps(out))
    return out


TRAIN_ARGS = ["--network", "ResNet18", "--dataset", "Cifar10", "--num-workers",
              str(WORKERS), "--batch-size", "128", "--lr", "0.1", "--momentum", "0.9",
              "--num-aggregate", "5", "--compress-grad", "compress", "--log-interval",
              "1", "--device", "cuda", "--no-checkpoints"]


def _train(steps: int, extra=()) -> dict:
    from ps_pytorch_tpu_torch.cli import train as cli_train

    return cli_train.main(TRAIN_ARGS + ["--max-steps", str(steps), *extra])


def phase_train(card: str) -> dict:
    """Phase 9. On another tree (``--package-root``) the launch counts
    are reported, not required: a parent counts its calls per leaf."""
    _, k2c = _wire_entry(0)
    _, k1c = _wire_entry(128)

    steps = 20
    k2c.launches = 0
    k1c.launches = 0
    out = _train(steps)
    torch.cuda.synchronize()
    k2, k1s = k2c.launches, k1c.launches
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    require(len(losses) == steps and all(np.isfinite(v) for v in losses),
            f"train: losses {losses}")
    require(out["train"]["skipped_steps"] == 0.0, "train: a step was skipped")
    require(OTHER_TREE or k2 == steps,
            f"train: K2 called {k2} times, expected once a step for {steps} steps")
    require(k1s == 0, f"train: K1 scaled launched {k1s} times on the per-tensor wire")
    times = [h["time_cost"] for h in hist[3:]]  # after warm-up (cuDNN autotune)
    p50 = float(np.median(times))
    rec = {"card": card, "model": "ResNet18 synthetic Cifar10 f32 (TF32 off)",
           "workers": WORKERS, "batch_per_worker": 128, "steps": steps,
           "wire": "int8 per-tensor, num-aggregate 5 random_k",
           "launches": {k2c.__name__: k2, k1c.__name__: k1s},
           "loss_first": losses[0], "loss_last": losses[-1],
           "step_ms_p50": p50 * 1e3, "step_ms_min": min(times) * 1e3,
           "step_ms_max": max(times) * 1e3,
           "images_per_s": WORKERS * 128 / p50, "val": out["val"]}
    print("phase 9 train ResNet18 int8 per-tensor: " + json.dumps(rec))

    steps_b = 3
    k2c.launches = 0
    k1c.launches = 0
    out_b = _train(steps_b, ["--quant-block-size", "128"])
    torch.cuda.synchronize()
    k1s_b, k2_b = k1c.launches, k2c.launches
    lb = [h["loss"] for h in out_b["history"]]
    require(all(np.isfinite(v) for v in lb), f"train block-128: losses {lb}")
    require(OTHER_TREE or k1s_b == steps_b,
            f"train block-128: K1 scaled called {k1s_b} times, expected once a step "
            f"for {steps_b} steps")
    require(k2_b == 0, f"train block-128: K2 launched {k2_b} times")
    rec_b = {"wire": "int8 block-128", "steps": steps_b,
             "launches": {k1c.__name__: k1s_b, k2c.__name__: k2_b},
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
        b_ms, b_by = bound_ms(n * s + s, float(n * s), PEAK_OPS_PER_S[torch.int8])
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
    """Wrapper calls per step of ``cfg``'s wire, computed from the code (a
    multi-tensor call counts once, however many pieces it takes): round 1
    quantizes every piece in one call (K2 per tensor, K1 shared-scale per
    block); the dequant two-round wire requantizes every region of every
    piece in a second K2 call per tensor, or with one K1 fused launch per
    piece over its regions' rows; the homomorphic two-round wire runs K3
    once per piece; the ZeRO-1 wire has round 1 only, one call per
    bucket."""
    p = _pieces(cfg, params)
    block = bool(cfg.quant_block_size)
    sharded = cfg.opt_placement == "sharded"
    two_round = cfg.compress == "int8_2round" and not sharded
    hom = cfg.wire_domain == "homomorphic"
    calls = p if sharded else 1
    return {
        "quantize_tensors": 0 if block else calls + (1 if two_round and not hom else 0),
        "quantize_rows_scaled_many": calls if block else 0,
        "quantize_rows": p if block and two_round and not hom else 0,
        "accumulate_rescale_int8": p if two_round and hom else 0,
    }


def _counters():
    from ps_pytorch_tpu_torch.ops import quantize as q

    return {name: getattr(q, name) for name in (
        "quantize_tensors", "quantize_rows_scaled_many", "quantize_rows",
        "accumulate_rescale_int8")}


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
    from ps_pytorch_tpu_torch.ops.quantize import quantize_rows_scaled_many, quantize_tensors
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
            k2, k1s = quantize_tensors.launches, quantize_rows_scaled_many.launches
            p0 = st.params.flat.detach().cpu().clone()
            st, m = step(st, batch, StepDraws(perm=perm))
            res[key] = (st.params.flat.detach().cpu(), p0, float(m["loss"]),
                        quantize_tensors.launches - k2,
                        quantize_rows_scaled_many.launches - k1s)
        (pc, p0, lc, _, _), (pg, _, lg, k2g, k1g) = res["cpu"], res["cuda"]
        moved = float((pc - p0).abs().max())
        diff = (pc - pg).abs()
        require(float(diff.max()) <= 1e-2 * moved,
                f"held {name}: card vs CPU params differ by {float(diff.max())} "
                f"(update {moved})")
        frac = float((diff > 1e-6).float().mean())
        require(frac <= 0.01, f"held {name}: {frac:.4f} of params differ by > 1e-6")
        want = (1, 0) if name == "per_tensor" else (0, 1)  # LeNet's 8 leaves, one call
        require((k2g, k1g) == want,
                f"held {name}: calls K2 {k2g}, K1 scaled {k1g}, expected {want}")
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


def _flash_counters():
    from ps_pytorch_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv,
        flash_bwd_dq,
        flash_fwd,
        flash_partial,
    )

    return {"flash_fwd": flash_fwd, "flash_partial": flash_partial,
            "flash_bwd_dq": flash_bwd_dq, "flash_bwd_dkv": flash_bwd_dkv}


def reset_flash_counts() -> None:
    for fn in _flash_counters().values():
        fn.launches = 0


def read_flash_counts() -> dict:
    return {name: fn.launches for name, fn in _flash_counters().items()}


def kept_pairs(b, h, tq, tk, causal, q_off, k_off) -> int:
    """The (query, key) pairs the mask keeps, over every row and head:
    the work this run's data needs (masked tiles are skipped)."""
    if not causal:
        return b * h * tq * tk
    qo = np.broadcast_to(np.asarray(q_off.cpu() if torch.is_tensor(q_off) else q_off), (b,))
    ko = np.broadcast_to(np.asarray(k_off.cpu() if torch.is_tensor(k_off) else k_off), (b,))
    q = np.arange(tq)
    return h * int(sum(np.clip(qo[r] + q - ko[r] + 1, 0, tk).sum() for r in range(b)))


def _near(what: str, got, want, tol) -> tuple:
    """Max abs error, required within ``tol`` of the result's largest
    magnitude (f32 sums in another order: the kernels tile by tile, K4
    with scalar FMAs, K5/K6 on the tensor cores, bf16 with P and dS as a
    bf16 hi + lo pair and f32 as 3xTF32; the plain versions over whole
    rows with matmuls); and that error over the largest magnitude."""
    err = float((got.float() - want.float()).abs().max())
    top = float(want.float().abs().max())
    require(err <= tol * max(1.0, top), f"{what} off its plain version by {err}")
    return err, err / top if top > 0 else 0.0


def _aten_yardsticks(q, k, v, do, scale, causal, iters) -> dict:
    """aten's attention on the same work as one K4-partial call and one K5
    + K6 pair (never called by the port). Forward: flash attention for
    bf16, memory-efficient attention for f32 (flash takes no f32); it
    returns (o, logsumexp), the same softmax work as K4's triple.
    Backward, (dq, dk, dv), K5 and K6 together: for bf16 what
    scaled_dot_product_attention picks by default, its fastest call (on
    the H100 cuDNN's flash backward); for f32 memory-efficient attention
    (``bwd_device_kernels`` names the kernels). Wall and device time."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    fwd_args = [x.transpose(1, 2) for x in (q, k, v)]
    qh, kh, vh = (x.detach().requires_grad_(True) for x in fwd_args)
    sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal, scale=scale)
    if q.dtype == torch.bfloat16:
        fwd = lambda: torch.ops.aten._scaled_dot_product_flash_attention(
            *fwd_args, dropout_p=0.0, is_causal=causal, scale=scale)
        oh = sdpa()
    else:
        fwd = lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
            *fwd_args, None, True, 0.0, is_causal=causal, scale=scale)
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            oh = sdpa()
    doh = do.transpose(1, 2)
    bwd = lambda: torch.autograd.grad(oh, (qh, kh, vh), doh, retain_graph=True)
    bwd_dev, bwd_kernels = device_ms(bwd)
    return {"fwd_ms": time_ms(fwd, iters), "fwd_device_ms": device_ms(fwd)[0],
            "bwd_ms": time_ms(bwd, iters=50), "bwd_device_ms": bwd_dev,
            "bwd_device_kernels": sorted(bwd_kernels)}


def phase_flash_train_kernels(dev) -> dict:
    """Phase 14: K4-partial, K5, K6 against their plain versions."""
    from ps_pytorch_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv,
        flash_bwd_dq,
        flash_bwd_plain,
        flash_fwd_plain,
        flash_partial,
        flash_partial_plain,
    )

    n, t_loc = 4, 2048
    me = torch.arange(n, device=dev)
    # hop 3 of a 4-shard ring, batch 2 per shard: shard i meets key block
    # (i + 3) % 4, so shard 0's keys all lie in its future
    ring_q = (me * t_loc).repeat_interleave(2)
    ring_k = (((me + 3) % n) * t_loc).repeat_interleave(2)
    cases = [("lm1_bf16", 8, 1024, torch.bfloat16, 0, 0),
             ("lm1_f32", 8, 1024, torch.float32, 0, 0),
             ("ring_hop_bf16", 8, t_loc, torch.bfloat16, ring_q, ring_k),
             ("ring_hop_f32", 8, t_loc, torch.float32, ring_q, ring_k)]
    h, d = 8, 64
    scale = d ** -0.5
    g = torch.Generator(device=dev).manual_seed(14)
    out = {}
    for name, b, t, dt, q_off, k_off in cases:
        q, k, v, do = (torch.randn((b, t, h, d), generator=g, device=dev).to(dt)
                       for _ in range(4))
        pv, m, l = flash_partial(q, k, v, True, scale, q_off, k_off)
        again = flash_partial(q, k, v, True, scale, q_off, k_off)
        pvp, mp, lp = flash_partial_plain(q, k, v, True, scale, q_off, k_off)
        o, lse = flash_fwd_plain(q, k, v, True, scale, q_off=q_off, k_off=k_off)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        bwd = (q, k, v, do, lse, delta, True, scale, q_off, k_off)
        dq = flash_bwd_dq(*bwd, out_dtype=torch.float32)
        dk, dv = flash_bwd_dkv(*bwd, out_dtype=torch.float32)
        dq2 = flash_bwd_dq(*bwd, out_dtype=torch.float32)
        dk2, dv2 = flash_bwd_dkv(*bwd, out_dtype=torch.float32)
        want = flash_bwd_plain(*bwd, out_dtype=torch.float32)
        torch.cuda.synchronize()
        errs, rel = {}, {}
        for key, got, ref, tol in (
                ("pv", pv, pvp, 2e-5), ("m", m, mp, 2e-6), ("l", l, lp, 2e-5),
                ("dq", dq, want[0], 5e-5), ("dk", dk, want[1], 5e-5), ("dv", dv, want[2], 5e-5)):
            errs[key], rel[key] = _near(f"{name} {key}", got, ref, tol)
        require(torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2),
                f"{name}: K5/K6 changed between two runs")
        require(all(torch.equal(x, y) for x, y in zip((pv, m, l), again)),
                f"{name}: K4-partial changed between two runs")
        pairs = kept_pairs(b, h, t, t, True, q_off, k_off)
        elt, act = q.element_size(), b * t * h * d
        stat = b * h * t * 4
        # bounds: each input read once, each output written once; 4 D
        # flops per kept pair forward (QK, PV), 6 D for K5, 8 D for K6,
        # at the rate of the input type's products (f32: 3xTF32)
        rate = TF32X3_OPS_PER_S if dt == torch.float32 else PEAK_OPS_PER_S[dt]
        bounds = {
            "partial": bound_ms(3 * act * elt + act * 4 + 2 * stat, 4.0 * d * pairs, rate),
            "dq": bound_ms(4 * act * elt + 2 * stat + act * 4, 6.0 * d * pairs, rate),
            "dkv": bound_ms(4 * act * elt + 2 * stat + 2 * act * 4, 8.0 * d * pairs, rate),
        }
        # fewer back-to-back calls where one call takes milliseconds
        slow = t > 1024 or dt == torch.float32
        iters, plain_iters = (50, 10) if slow else (ITERS, 20)
        rec = {"shape": [b, t, h, d], "dtype": str(dt).replace("torch.", ""),
               "kept_pairs": pairs, "max_abs_err": errs, "err_of_largest": rel}
        partial = lambda: flash_partial(q, k, v, True, scale, q_off, k_off)
        dev_ms, kernels = _device_route(f"{name} K4-partial", partial, dt)
        rec["partial"] = {
            "ms": time_ms(partial, iters), "device_ms": dev_ms, "device_kernels": kernels,
            "plain_ms": time_ms(lambda: flash_partial_plain(q, k, v, True, scale, q_off,
                                                            k_off), iters=plain_iters),
            "bound_ms": bounds["partial"][0], "bound_by": bounds["partial"][1]}
        plain_bwd_ms = time_ms(lambda: flash_bwd_plain(*bwd, out_dtype=torch.float32),
                               iters=plain_iters)
        for part, family, fn in (
                ("dq", "flash_dq", lambda: flash_bwd_dq(*bwd, out_dtype=torch.float32)),
                ("dkv", "flash_dkv", lambda: flash_bwd_dkv(*bwd, out_dtype=torch.float32))):
            dev_ms, kernels = _device_route(f"{name} {part}", fn, dt, family)
            rec[part] = {"ms": time_ms(fn, iters), "device_ms": dev_ms,
                         "device_kernels": kernels, "plain_ms": plain_bwd_ms,
                         "bound_ms": bounds[part][0], "bound_by": bounds[part][1]}
        # aten on the same work: causal at LM-1's offsets 0; on the ring
        # hop non-causal over the six rows whose shards keep every key (the
        # two of shard 0 keep none and get zeros)
        rows = slice(None) if name.startswith("lm1") else slice(2, None)
        lib = _aten_yardsticks(q[rows], k[rows], v[rows], do[rows], scale,
                               name.startswith("lm1"), iters)
        rec["partial"]["library_ms"] = lib["fwd_ms"]
        rec["partial"]["library_device_ms"] = lib["fwd_device_ms"]
        for part in ("dq", "dkv"):
            rec[part]["library_ms"] = lib["bwd_ms"]
            rec[part]["library_device_ms"] = lib["bwd_device_ms"]
        rec["library_device_kernels"] = lib["bwd_device_kernels"]
        rec["k5_plus_k6"] = {
            "ms": rec["dq"]["ms"] + rec["dkv"]["ms"], "library_ms": lib["bwd_ms"],
            "device_ms": rec["dq"]["device_ms"] + rec["dkv"]["device_ms"],
            "library_device_ms": lib["bwd_device_ms"],
            "bound_ms": rec["dq"]["bound_ms"] + rec["dkv"]["bound_ms"]}
        out[name] = rec
        print(f"phase 14 {name}: " + json.dumps(rec), flush=True)
    return out


# The JAX package's LM bench leg (bench.py:66, 582-595) at full width
LM_DEPTH = 6
LM_ARGS = ["--parallelism", "dp_sp", "--attention-impl", "flash", "--vocab-size", "2048",
           "--dim", "512", "--depth", str(LM_DEPTH), "--heads", "8",
           "--remat", "--lr", "0.01", "--momentum", "0.9", "--log-interval", "1",
           "--device", "cuda"]


def phase_lm(card: str, phase: str, steps: int, n_sp: int, batch: int, seq: int,
             dtype: str = "bfloat16") -> dict:
    """Phases 15-16: LM training through ``cli.train_lm.main``, with the
    flash launch counts of the formula (L n (1 + remat) K4-partial, L n
    K5, L n K6 per step)."""
    from ps_pytorch_tpu_torch.cli import train_lm

    flags = ["--dtype", dtype, "--seq-len", str(seq), "--batch-size", str(batch),
             "--num-sp", str(n_sp), "--max-steps", str(steps)]
    reset_flash_counts()
    res = train_lm.main(LM_ARGS + flags)
    torch.cuda.synchronize()
    got = read_flash_counts()
    hops = LM_DEPTH * n_sp
    want = {"flash_fwd": 0, "flash_partial": 2 * hops * steps,
            "flash_bwd_dq": hops * steps, "flash_bwd_dkv": hops * steps}
    hist = res["history"]
    losses = [h_["loss"] for h_ in hist]
    require(len(losses) == steps and all(np.isfinite(v) for v in losses),
            f"{phase}: losses {losses}")
    require(got == want, f"{phase}: launches {got}, expected {want}")
    times = [h_["time_cost"] for h_ in hist[2:]]  # after the first two steps
    p50 = float(np.median(times))
    rec = {"card": card, "flags": " ".join(LM_ARGS[:-2] + flags),
           "layout": f"dp 1 x sp {n_sp}", "steps": steps, "launches": got,
           "losses": losses, "step_ms_p50": p50 * 1e3, "step_ms_min": min(times) * 1e3,
           "step_ms_max": max(times) * 1e3, "tokens_per_s": batch * seq / p50,
           "steady_ms_per_step": res["steady_elapsed_s"] / res["steady_steps"] * 1e3,
           "params": res["params"]}
    print(f"{phase}: " + json.dumps(rec))
    return rec


def phase_lm_held(dev) -> dict:
    """Phase 17: one LM step at (dp 2, sp 4), f32 with TF32 off, card
    (kernels) vs CPU (plain versions) from the same params and tokens.
    Tolerance: the JAX package's own dp_sp bounds (loss rtol 1e-5,
    params rtol 2e-4 / atol 2e-5): the same f32 sums in other orders."""
    from ps_pytorch_tpu_torch import on_device
    from ps_pytorch_tpu_torch.cli.train_lm import make_synthetic_tokens
    from ps_pytorch_tpu_torch.models import TransformerConfig, init_transformer
    from ps_pytorch_tpu_torch.optim import build_optimizer
    from ps_pytorch_tpu_torch.parallel.buckets import tree_leaves
    from ps_pytorch_tpu_torch.parallel.dp_sp import (
        make_lm_train_step,
        make_mesh_2d,
        shard_tokens_2d,
    )

    depth, dp, sp = 2, 2, 4
    mesh = make_mesh_2d(dp, sp)
    tokens = torch.from_numpy(make_synthetic_tokens(256, 4, 256, seed=3))
    variants = {"ring": dict(sp_attention="ring"),
                "ring_bidirectional": dict(sp_attention="ring", bidirectional_ring=True),
                "ulysses": dict(sp_attention="ulysses")}
    out = {}
    for name, kw in variants.items():
        cfg = TransformerConfig(vocab_size=256, dim=256, depth=depth, heads=4,
                                max_seq_len=256, attention_impl="flash", remat=True, **kw)
        params = init_transformer(cfg, torch.Generator().manual_seed(9), device="cpu")
        res = {}
        for d in ("cpu", dev):
            tx = build_optimizer("sgd", 0.1, momentum=0.9)
            p = on_device(params, torch.device(d))
            step = make_lm_train_step(cfg, tx, mesh)
            reset_flash_counts()
            p2, _, loss = step(p, tx.init(p), shard_tokens_2d(tokens.to(d), mesh))
            res[torch.device(d).type] = ([x.detach().cpu() for x in tree_leaves(p2)],
                                         float(loss), read_flash_counts())
        (pc, lc, _), (pg, lg, counts) = res["cpu"], res[torch.device(dev).type]
        require(abs(lg - lc) <= 1e-5 * abs(lc), f"held LM {name}: loss {lg} vs CPU {lc}")
        worst = 0.0
        for a, b in zip(pg, pc):
            excess = (a - b).abs() - (2e-5 + 2e-4 * b.abs())
            worst = max(worst, float((a - b).abs().max()))
            require(bool((excess <= 0).all()), f"held LM {name}: params off by {worst}")
        if name == "ulysses":  # local flash attention over the gathered sequence
            want = {"flash_fwd": 2 * depth, "flash_partial": 0,
                    "flash_bwd_dq": depth, "flash_bwd_dkv": depth}
        else:  # each of the n offsets once per pass, both ring directions
            want = {"flash_fwd": 0, "flash_partial": 2 * depth * sp,
                    "flash_bwd_dq": depth * sp, "flash_bwd_dkv": depth * sp}
        require(counts == want, f"held LM {name}: launches {counts}, expected {want}")
        out[name] = {"loss_cpu": lc, "loss_cuda": lg, "max_abs_param_diff": worst,
                     "launches": counts}
    print("phase 17 LM step held on the card vs CPU (dp 2 x sp 4): " + json.dumps(out))
    return out



def main(argv=None) -> int:
    global OTHER_TREE
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run alone (2, 4, 7, 8, 9, 14; "
                         "2 on this tree only)")
    ap.add_argument("--package-root", default=None,
                    help="directory holding the ps_pytorch_tpu_torch package to time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if args.package_root is not None:
        sys.path.insert(0, os.path.abspath(args.package_root))
        OTHER_TREE = True
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

    if args.phases is not None:
        import ps_pytorch_tpu_torch

        print(f"package: {os.path.dirname(os.path.abspath(ps_pytorch_tpu_torch.__file__))}")
        alone = {2: phase_build,
                 4: lambda: phase_k4(flash_fwd, flash_fwd_plain, dev),
                 7: lambda: print("phase 7 K2 wire step: "
                                  + json.dumps(wire_step_case(dev, 0))),
                 8: lambda: print("phase 8 K1 shared-scale wire step: "
                                  + json.dumps(wire_step_case(dev, 128))),
                 9: lambda: phase_train(smi),
                 14: lambda: phase_flash_train_kernels(dev)}
        phases = [int(x) for x in args.phases.split(",")]
        require(set(phases) <= set(alone), f"--phases: {phases} not all in {sorted(alone)}")
        require(not (2 in phases and OTHER_TREE), "--phases: 2 checks this tree's kernels")
        for n in phases:
            alone[n]()
        return 0

    phase_build()

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
    fk = phase_flash_train_kernels(dev)
    lm1 = phase_lm(smi, "phase 15 LM-1 train_lm dp 1 x sp 1 flash", 20, 1, 8, 1024)
    lm1_f32 = phase_lm(smi, "phase 15b LM-1 f32 train_lm dp 1 x sp 1 flash", 8, 1, 8, 1024,
                       "float32")
    phase_lm(smi, "phase 16 LM-ring train_lm dp 1 x sp 4 flash", 5, 4, 2, 8192)
    phase_lm_held(dev)

    def flash_entry(name, source, site, part):
        rec = fk["lm1_bf16"][part]
        key = {"partial": ("pv", "m", "l"), "dq": ("dq",), "dkv": ("dk", "dv")}[part]
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": f"ps_pytorch_tpu/ops/flash_attention.py:{site}",
            "launches": lm1["launches"][name],
            "max_abs_err": max(c["max_abs_err"][k] for c in fk.values() for k in key),
            "ms": rec["ms"], "device_ms": rec["device_ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
        }
        # the f32 route at LM-1 (cli.train_lm's default dtype), launches
        # from phase 15b
        f32 = fk["lm1_f32"][part]
        entry["f32"] = {
            "launches": lm1_f32["launches"][name],
            "max_abs_err": max(c["max_abs_err"][k] for n_, c in fk.items()
                               if n_.endswith("f32") for k in key),
            **{k: f32[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "library_device_ms")}}
        return entry

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
            "name": "quantize_rows_scaled_many", "route": "cuda",
            "source": "ps_pytorch_tpu_torch/csrc/quantize_rows.cu",
            "replaces": "ps_pytorch_tpu/ops/quantize.py:101",
            "launches": train["block128"]["launches"]["quantize_rows_scaled_many"],
            "max_abs_err": max(k1s["max_abs_err"], k1s["resnet18_step"]["max_abs_err"]),
            "ms": k1s["resnet18_step"]["ms"], "plain_ms": k1s["resnet18_step"]["plain_ms"],
            "bound_ms": k1s["resnet18_step"]["bound_ms"],
            "bound_by": k1s["resnet18_step"]["bound_by"], "library_ms": None,
        },
        {
            "name": "quantize_tensors", "route": "cuda",
            "source": "ps_pytorch_tpu_torch/csrc/quantize_tensor.cu",
            "replaces": "ps_pytorch_tpu/ops/quantize.py:78",
            "launches": train["launches"]["quantize_tensors"],
            "max_abs_err": max(r["max_abs_err"] for r in k2.values()),
            "ms": k2["resnet18_step"]["ms"], "plain_ms": k2["resnet18_step"]["plain_ms"],
            "bound_ms": k2["resnet18_step"]["bound_ms"],
            "bound_by": k2["resnet18_step"]["bound_by"], "library_ms": None,
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
        flash_entry("flash_partial", "ps_pytorch_tpu_torch/csrc/flash_fwd.cu", 199, "partial"),
        flash_entry("flash_bwd_dq", "ps_pytorch_tpu_torch/csrc/flash_bwd.cu", 319, "dq"),
        flash_entry("flash_bwd_dkv", "ps_pytorch_tpu_torch/csrc/flash_bwd.cu", 337, "dkv"),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
