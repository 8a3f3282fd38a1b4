"""The argparse surface of the JAX package's cli/_flags.py, flag for flag
(same names, same defaults), plus ``--device``.

Every flag parses, so a reference command line carries over unchanged.
A value the port does not run is refused with a pointer to ROADMAP.md
(by ``PSConfig``), never ignored. As
in the JAX package, ``--enable-gpu`` and ``--comm-type`` are accepted and
ignored (the device is ``--device``; weights never move).

``expand_config_json`` applies ``--config-json FILE`` (an autotune
record's best candidate, one candidate entry, or a bare ``{flag: value}``
object) by expanding the file's flags into argv before parsing, with the
JAX CLI's rejections and messages (cli/_flags.py:252-330 there).
"""

from __future__ import annotations

import argparse
import json
import logging

from ..parallel.ps import PSConfig
from ..trainer import TrainConfig

logger = logging.getLogger("ps_pytorch_tpu_torch")


def add_train_flags(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    d = TrainConfig()
    a = parser.add_argument
    a("--device", type=str, default="cuda",
      help="cuda (default; raises without a card) or cpu (the plain versions)")
    a("--batch-size", type=int, default=d.batch_size, help="per-worker training batch size")
    a("--test-batch-size", type=int, default=d.test_batch_size)
    a("--epochs", type=int, default=d.epochs)
    a("--max-steps", type=int, default=d.max_steps)
    a("--lr", type=float, default=d.lr)
    a("--momentum", type=float, default=d.momentum)
    a("--weight-decay", type=float, default=d.weight_decay)
    a("--optimizer", type=str, default=d.optimizer, choices=("sgd", "adam", "amsgrad"))
    a("--seed", type=int, default=d.seed)
    a("--log-interval", type=int, default=d.log_interval)
    a("--network", type=str, default=d.network)
    a("--dataset", type=str, default=d.dataset)
    a("--eval-freq", type=int, default=d.eval_freq)
    a("--train-dir", type=str, default=d.train_dir)
    a("--data-root", type=str, default=None)
    a("--no-synthetic", action="store_true")
    a("--resume", action="store_true")
    a("--no-checkpoints", action="store_true")
    a("--compress-checkpoints", action="store_true")
    a("--shard-mode", type=str, default=d.shard_mode, choices=("reshuffle", "disjoint"))
    a("--dtype", type=str, default=d.dtype, choices=("float32", "bfloat16"))
    a("--profile-dir", type=str, default=None)
    a("--profile-start", type=int, default=None)
    a("--profile-steps", type=int, default=d.profile_steps)
    a("--trace", type=str, default=None, metavar="DIR",
      help="write the loop's host spans to DIR/trace_train_p0.jsonl")
    a("--remat", action="store_true",
      help="recompute each ResNet block in the backward pass (saves memory)")
    a("--metrics-file", type=str, default=None,
      help="append the run's events, one JSON record a line")
    # --mode other than normal arms the straggler watchdog at
    # --kill-threshold seconds a step (a record, nothing is killed)
    a("--mode", type=str, default="normal")
    a("--kill-threshold", type=float, default=7.0)
    a("--comm-type", type=str, default="Bcast")
    a("--enable-gpu", type=str, default="")
    a("--straggler-storm-n", type=int, default=d.straggler_storm_n)
    a("--max-consecutive-skips", type=int, default=d.max_consecutive_skips)
    a("--fault-plan", type=str, default=None,
      help="a JSON FaultPlan (nan_grads, inf_grads, slow_steps, ckpt_write_fail, "
           "ckpt_corrupt: lists of steps; slow_s: seconds; sigterm: one step) or @path")
    a("--adapt-window", type=int, default=d.adapt_window)
    a("--wire-budget-bytes", type=int, default=None)
    return parser


def _num_aggregate(val: str) -> int:
    n = int(val)
    if n < 0:
        raise argparse.ArgumentTypeError(
            f"--num-aggregate must be >= 0 (0 = aggregate all workers), got {n}")
    return n


def _bucket_bytes(val: str) -> int:
    n = int(val)
    if n < -1:
        raise argparse.ArgumentTypeError(
            f"--bucket-bytes must be -1 (per-leaf), 0 (one fused buffer) or a "
            f"positive byte budget, got {n}")
    return n


def add_ps_flags(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    a = parser.add_argument
    a("--num-workers", type=int, default=0,
      help="virtual workers stacked on the one device (0 = 1)")
    a("--num-aggregate", type=_num_aggregate, default=0,
      help="aggregate only K of N worker gradients per step (0 = all)")
    a("--num-aggregate-min", type=int, default=0)
    a("--num-aggregate-max", type=int, default=0)
    a("--mask-mode", type=str, default="random_k", choices=("random_k", "first_k"))
    a("--compress-grad", type=str, default="none", choices=("compress", "none", "2round"),
      help="compress -> int8-quantized wire (exact int32 sum)")
    a("--error-feedback", action="store_true")
    a("--quant-block-size", type=int, default=0,
      help="per-block quantization scale granularity (0 = per-tensor)")
    a("--bucket-bytes", type=_bucket_bytes, default=-1)
    a("--overlap", type=str, default="off", choices=("on", "off"))
    a("--state-layout", type=str, default="flat", choices=("tree", "flat"))
    a("--quant-rounding", type=str, default="nearest", choices=("nearest", "stochastic"))
    a("--wire-domain", type=str, default="dequant", choices=("dequant", "homomorphic"))
    a("--precision-adapt", action="store_true")
    a("--opt-placement", type=str, default="replicated", choices=("replicated", "sharded"))
    a("--bn-mode", type=str, default="pmean", choices=("local", "pmean", "synced"))
    a("--grad-accum-steps", type=int, default=1)
    a("--dcn-hosts", type=int, default=1)
    a("--no-nonfinite-guard", action="store_true")
    a("--dynamic-loss-scale", action="store_true")
    a("--loss-scale-init", type=float, default=2.0 ** 15)
    a("--loss-scale-growth-interval", type=int, default=2000)
    a("--coordinator-address", type=str, default=None,
      help="host:port of rank 0's rendezvous: run one process per --process-id "
           "(NCCL, one process per card; gloo with --device cpu)")
    a("--num-processes", type=int, default=None)
    a("--process-id", type=int, default=None)
    return parser


def _config_json_flags(data) -> dict:
    """The flag dict of a --config-json file: a full autotune evidence
    record (the best candidate's flags apply), one candidate entry, or a
    bare {flag: value} object."""
    if not isinstance(data, dict):
        raise SystemExit(
            "--config-json: expected a JSON object (an autotune record "
            f"or a flag dict), got {type(data).__name__}"
        )
    if data.get("kind") == "autotune":
        best = data.get("best")
        if not best or "flags" not in best:
            raise SystemExit(
                "--config-json: autotune record has no best candidate "
                "to apply (every point was pruned?)"
            )
        return dict(best["flags"])
    if "flags" in data and isinstance(data["flags"], dict):
        return dict(data["flags"])
    return dict(data)


def expand_config_json(parser: argparse.ArgumentParser, argv: list) -> list:
    """Apply ``--config-json FILE`` by expanding the file's flags into
    the argv BEFORE parsing, so every value still goes through the
    parser's own types and choices.

    Rejections (SystemExit with the reason):
    - an unknown key: the file names a flag this CLI does not define;
    - a flag conflict: a flag set by the file ALSO appears explicitly
      on the command line (argparse prefix abbreviations included: an
      explicit ``--compress-g`` conflicts with a configured
      ``--compress-grad``), so neither silently wins.
    Flags NOT set by the file pass through untouched."""
    path = None
    rest: list = []
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok == "--config-json":
            if i + 1 >= len(argv):
                raise SystemExit("--config-json: missing FILE argument")
            path = argv[i + 1]
            i += 2
            continue
        if tok.startswith("--config-json="):
            path = tok.split("=", 1)[1]
            i += 1
            continue
        rest.append(tok)
        i += 1
    if path is None:
        return argv
    try:
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError) as e:
        raise SystemExit(f"--config-json: cannot read {path}: {e}")
    flags = _config_json_flags(data)

    by_option = {s: a for a in parser._actions for s in a.option_strings}
    unknown = sorted(k for k in flags if k not in by_option)
    if unknown:
        raise SystemExit(
            f"--config-json: unknown flag(s) {unknown} in {path} — not "
            f"part of this CLI (typo, or a record from a different tool?)"
        )
    explicit = set()
    for t in rest:
        if not t.startswith("--"):
            continue
        tok = t.split("=", 1)[0]
        # resolve argparse's prefix abbreviations, or an abbreviated
        # explicit flag would dodge the conflict check and then win
        matches = [o for o in by_option if o.startswith(tok)]
        explicit.add(matches[0] if len(matches) == 1 else tok)
    conflicts = sorted(k for k in flags if k in explicit)
    if conflicts:
        raise SystemExit(
            f"--config-json: flag(s) {conflicts} are set by {path} AND "
            f"passed explicitly — drop one side (the config file owns "
            f"the tuned knobs; explicit flags own everything else)"
        )
    expanded: list = []
    for k, v in flags.items():
        action = by_option[k]
        if action.nargs == 0:  # store_true / store_false
            if not isinstance(v, bool):
                raise SystemExit(
                    f"--config-json: {k} takes no value; expected a "
                    f"JSON boolean, got {v!r}"
                )
            if v:
                expanded.append(k)
        else:
            expanded.extend([k, str(v)])
    return expanded + rest


def train_config_from(args: argparse.Namespace) -> TrainConfig:
    return TrainConfig(
        network=args.network, dataset=args.dataset, batch_size=args.batch_size,
        test_batch_size=args.test_batch_size, epochs=args.epochs,
        max_steps=args.max_steps, lr=args.lr, momentum=args.momentum,
        weight_decay=args.weight_decay, optimizer=args.optimizer, seed=args.seed,
        log_interval=args.log_interval, eval_freq=args.eval_freq,
        train_dir=args.train_dir, save_checkpoints=not args.no_checkpoints,
        compress_checkpoints=args.compress_checkpoints, resume=args.resume,
        data_root=args.data_root, allow_synthetic=not args.no_synthetic,
        shard_mode=args.shard_mode, dtype=args.dtype, profile_dir=args.profile_dir,
        profile_start=args.profile_start, profile_steps=args.profile_steps,
        trace_dir=args.trace, remat=args.remat, metrics_file=args.metrics_file,
        straggler_threshold_s=args.kill_threshold if args.mode != "normal" else None,
        straggler_storm_n=args.straggler_storm_n,
        max_consecutive_skips=args.max_consecutive_skips, fault_plan=args.fault_plan,
        adapt_window=args.adapt_window, wire_budget_bytes=args.wire_budget_bytes,
    )


def ps_config_from(args: argparse.Namespace, num_workers: int) -> PSConfig:
    num_aggregate = args.num_aggregate
    if num_aggregate > num_workers:
        logger.warning("--num-aggregate %d exceeds num_workers %d: clamping to %d "
                       "(aggregate all workers)", num_aggregate, num_workers, num_workers)
        num_aggregate = num_workers
    return PSConfig(
        num_workers=num_workers,
        num_aggregate=num_aggregate or None,
        num_aggregate_min=args.num_aggregate_min or None,
        num_aggregate_max=args.num_aggregate_max or None,
        mask_mode=args.mask_mode,
        compress={"compress": "int8", "2round": "int8_2round",
                  "none": None}[args.compress_grad],
        quant_block_size=args.quant_block_size,
        quant_rounding=args.quant_rounding,
        wire_domain=args.wire_domain,
        bucket_bytes=None if args.bucket_bytes < 0 else args.bucket_bytes,
        state_layout=args.state_layout,
        overlap="pipelined" if args.overlap == "on" else "serial",
        error_feedback=args.error_feedback,
        precision_adapt=args.precision_adapt,
        opt_placement=args.opt_placement,
        bn_mode=args.bn_mode,
        grad_accum_steps=args.grad_accum_steps,
        dcn_hosts=args.dcn_hosts,
        nonfinite_guard=not args.no_nonfinite_guard,
        dynamic_loss_scale=args.dynamic_loss_scale,
        loss_scale_init=args.loss_scale_init,
        loss_scale_growth_interval=args.loss_scale_growth_interval,
    )
