"""Serving entry (the port of ps_pytorch_tpu.cli.serve): continuous-batching
decode of a trained LM checkpoint under synthetic open-loop traffic, with
hot checkpoint rollover and the serving resilience layer.

It reads the checkpoints ``cli.train_lm`` writes (dense LMs; this
package's or the JAX package's, the same bytes), loads them into the
slot-pool engine (serve/engine.py) and drives it with a seeded Poisson
arrival schedule whose prompts are held-out walks of the SAME Markov
chain the model was trained on. With ``--poll-interval`` the engine
polls the checkpoint directory mid-serve and hot-swaps to newer weights
under the drain-then-swap rule (in-flight requests finish on the weights
that started them).

Resilience: ``--deadline`` gives every arrival a deadline (expired
requests terminate with an event), ``--slo-budget`` arms the admission
controller (serve/admission.py), ``--fault-plan`` injects the serve-side
faults (slow_decode / rollover_corrupt / spike), ``--traffic-spike``
drives the seeded burst directly, ``--events`` writes the request
lifecycle JSONL stream (validated against obs/schema.py).

Prefill attention is the model config's default ``"naive"``, as the JAX
CLI leaves it; ``--int8-kv`` stores the pool as int8 through kernel K1's
KV entry. ``--num-workers N`` views the slot pool as N bands (the
engine's declared deviation: one card, no bytes cross a link).

Prints exactly ONE JSON summary line (tokens/sec, goodput, p50/p99
per-token latency, lifecycle counts, rollovers).

  python -m ps_pytorch_tpu_torch.cli.serve --model-dir /tmp/lm \\
      --requests 32 --rate 50 --poll-interval 0.5 \\
      --deadline 2.0 --slo-budget 0.5 --traffic-spike 10,0.5,1.0
  ... --device cpu   # the plain versions
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from ..checkpoint import load_checkpoint_raw, load_latest_valid
from ..resilience.faults import resolve_fault_plan
from ..serve import AdmissionController, ServeConfig, ServingEngine, TrafficConfig
from ..serve.engine import checkpoint_model
from ..serve.traffic import make_requests, run_open_loop
from ..utils import get_logger

logger = get_logger()

# prime shift (distinct from evaluate_lm's 7919): served prompts are
# held-out walks of the training chain, and not the eval split either
SERVE_SEQUENCE_SEED_OFFSET = 104729


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("ps_pytorch_tpu_torch.cli.serve")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--step", type=int, default=None,
                   help="serve this checkpoint step (default: newest valid)")
    p.add_argument("--slots", type=int, default=8,
                   help="KV-cache slots (concurrent sequences)")
    p.add_argument("--max-len", type=int, default=0,
                   help="cache positions per slot (0 = model max_seq_len)")
    p.add_argument("--max-prompt-len", type=int, default=0,
                   help="prefill width (0 = --prompt-max)")
    p.add_argument("--int8-kv", action="store_true",
                   help="store the KV pool as int8 + per-(position, head) "
                        "block scales (serve/kv.py)")
    p.add_argument("--num-workers", type=int, default=0,
                   help="view the slot pool as N worker bands (0 = none)")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="compute dtype for the decode matmuls (weights "
                        "stay f32 in the flat buffer)")
    p.add_argument("--requests", type=int, default=32)
    p.add_argument("--rate", type=float, default=100.0,
                   help="open-loop Poisson arrival rate (requests/sec)")
    p.add_argument("--prompt-min", type=int, default=4)
    p.add_argument("--prompt-max", type=int, default=16)
    p.add_argument("--new-min", type=int, default=8)
    p.add_argument("--new-max", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--poll-interval", type=float, default=0.0,
                   help="poll for newer checkpoints every N seconds and "
                        "hot-roll onto them (0 = serve one step forever)")
    p.add_argument("--deadline", type=float, default=0.0,
                   help="per-request deadline in seconds from arrival "
                        "(0 = none); past-deadline requests terminate as "
                        "'expired' with a deadline_expired event")
    p.add_argument("--slo-budget", type=float, default=0.0,
                   help="arm SLO-aware admission control: shed arrivals "
                        "whose projected queue wait exceeds this many "
                        "seconds (0 = admit everything)")
    p.add_argument("--admit-window", type=float, default=0.25,
                   help="admission controller window seconds")
    p.add_argument("--shed-max-frac", type=float, default=0.9,
                   help="bounded shed rate: at most this fraction of a "
                        "window's arrivals is shed")
    p.add_argument("--recover-windows", type=int, default=2,
                   help="consecutive clean windows before shedding stops")
    p.add_argument("--recover-frac", type=float, default=0.5,
                   help="a window is clean when projected wait <= this "
                        "fraction of the SLO budget")
    p.add_argument("--drain-timeout", type=float, default=0.0,
                   help="drain watchdog: give up on a staged rollover "
                        "that pauses admissions longer than N seconds "
                        "(0 = wait forever)")
    p.add_argument("--fault-plan", type=str, default=None,
                   help="serve-side fault JSON (resilience/faults.py): "
                        "slow_decode ticks, rollover_corrupt steps, "
                        "spike [mult,start,dur]; or @path; env "
                        "PS_TPU_FAULTS")
    p.add_argument("--traffic-spike", type=str, default=None,
                   metavar="MULT,START,LEN",
                   help="seeded square-wave burst: arrivals in "
                        "[START, START+LEN) seconds come at MULT x "
                        "--rate (overrides the fault plan's spike)")
    p.add_argument("--events", type=str, default=None, metavar="FILE",
                   help="write the request-lifecycle event stream "
                        "(request_done/request_shed/deadline_expired/"
                        "rollover_abort/admission_adapt) as JSONL here")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the pre-traffic warmup (latency percentiles "
                        "then include the kernels' first launches)")
    p.add_argument("--summary-file", type=str, default=None,
                   help="also write the JSON summary here")
    p.add_argument("--trace", type=str, default=None, metavar="DIR",
                   help="host-phase span tracing (obs/trace.py): write "
                        "the serve span stream (trace_serve_p0.jsonl) "
                        "into DIR")
    args = p.parse_args(argv)

    cd = torch.bfloat16 if args.dtype == "bfloat16" else None
    if args.step is None:
        found = load_latest_valid(args.model_dir)
        if found is None:
            raise FileNotFoundError(f"no valid checkpoints in {args.model_dir}")
        step, raw = found
    else:
        step, raw = args.step, load_checkpoint_raw(args.model_dir, args.step)
    cfg, params = checkpoint_model(raw, cd)

    max_prompt = args.max_prompt_len or args.prompt_max
    max_len = args.max_len or cfg.max_seq_len
    # fail fast on traffic/pool geometry mismatches before the engine
    # is built: a bad combination would otherwise crash mid-serve
    if args.prompt_max > max_prompt:
        raise SystemExit(f"--prompt-max {args.prompt_max} exceeds the prefill width "
                         f"--max-prompt-len {max_prompt}")
    if args.prompt_max + args.new_max > max_len:
        raise SystemExit(f"--prompt-max {args.prompt_max} + --new-max {args.new_max} "
                         f"exceeds the slot length (--max-len {max_len})")
    serve_cfg = ServeConfig(slots=args.slots, max_len=max_len, max_prompt_len=max_prompt,
                            kv_int8=args.int8_kv)
    mesh = None
    if args.num_workers:
        from ..parallel.mesh import make_mesh

        mesh = make_mesh(args.num_workers)
    tracer = None
    if args.trace:
        from ..obs import Tracer

        tracer = Tracer(
            "serve", path=os.path.join(args.trace, "trace_serve_p0.jsonl"), annotate=True,
            geometry={"slots": serve_cfg.slots, "max_len": serve_cfg.max_len,
                      "kv_int8": serve_cfg.kv_int8, "num_workers": args.num_workers or 1})
    faults = resolve_fault_plan(args.fault_plan)
    spike = None
    if args.traffic_spike:
        parts = args.traffic_spike.split(",")
        if len(parts) != 3:
            raise SystemExit(f"--traffic-spike wants MULT,START,LEN, got "
                             f"{args.traffic_spike!r}")
        spike = tuple(float(x) for x in parts)
    elif faults is not None and faults.spike is not None:
        spike = faults.spike
    event_sink = None
    if args.events:
        # the metrics choke point (validates against obs/schema.py and
        # stamps t_wall); the stream opens with its own run_header
        from ..obs.schema import run_header
        from ..trainer import append_metrics_line

        def event_sink(rec):
            append_metrics_line(args.events, rec)

        event_sink(run_header("serve"))
    admission = None
    if args.slo_budget > 0:
        admission = AdmissionController(
            slo_budget_s=args.slo_budget, window_s=args.admit_window,
            shed_max_frac=args.shed_max_frac, recover_frac=args.recover_frac,
            recover_windows=args.recover_windows, event_sink=event_sink)
    engine = ServingEngine(
        cfg, params, serve_cfg, mesh=mesh, model_dir=args.model_dir, step=step,
        tracer=tracer, admission=admission, faults=faults, event_sink=event_sink,
        drain_timeout_s=args.drain_timeout or None, device=args.device)
    logger.info("serving step %d: %d slots x %d positions%s%s on %s", step, serve_cfg.slots,
                serve_cfg.max_len, " (int8 KV)" if args.int8_kv else "",
                f" over {args.num_workers} workers" if mesh is not None else "",
                engine.device)

    # prompts: held-out walks of the model's own training chain
    from .train_lm import make_synthetic_tokens

    data_seed = int(raw["data"]["seed"])
    corpus = make_synthetic_tokens(
        cfg.vocab_size, args.requests, max(args.prompt_max, 2), seed=data_seed,
        sequence_seed=data_seed + SERVE_SEQUENCE_SEED_OFFSET + args.seed)
    rows = iter(range(args.requests))
    tc = TrafficConfig(
        n_requests=args.requests, rate_rps=args.rate, prompt_len_min=args.prompt_min,
        prompt_len_max=args.prompt_max, new_tokens_min=args.new_min,
        new_tokens_max=args.new_max, vocab_size=cfg.vocab_size, seed=args.seed,
        spike=spike, deadline_s=args.deadline or None)
    requests = make_requests(tc, prompt_source=lambda rng, ln: corpus[next(rows), :ln])
    if not args.no_warmup:
        engine.warmup()
    try:
        summary = run_open_loop(engine, requests, poll_interval_s=args.poll_interval)
    finally:
        if tracer is not None:
            # the trailing partial window, also on an error
            tracer.flush()
    line = json.dumps(summary, sort_keys=True)
    print(line)
    if args.summary_file:
        with open(args.summary_file, "w", encoding="utf-8") as f:
            f.write(line + "\n")
    return summary


if __name__ == "__main__":
    main()
