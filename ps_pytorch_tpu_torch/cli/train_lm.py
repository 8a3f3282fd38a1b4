"""LM training entry of the port (the counterpart of
ps_pytorch_tpu.cli.train_lm), every scheme on virtual workers stacked on
the one card, selected by ``--parallelism``:

- ``dp_sp`` (default): a (dp x sp) grid, batch shards over dp, sequence
  shards over sp, ring (one-way or ``--bidirectional-ring``) or Ulysses
  attention, naive or on the flash kernels (K4's partial triple per ring
  hop forward, K5 + K6 backward);
- ``tp``: Megatron tensor parallelism over ``--num-shards`` shards (heads
  and MLP columns; ``--shard-vocab`` cuts the embedding and runs the loss
  vocab-parallel);
- ``dp_tp``: ``--num-dp`` data shards x ``--num-shards`` tensor shards;
- ``pp``: GPipe over ``--num-shards`` stages, ``--num-microbatches`` a step;
- ``moe``: Switch (``--top-k 1``) or GShard (``--top-k 2``) MoE, the
  ``--num-experts`` experts and the batch over ``--num-shards`` expert
  shards (``--capacity-factor``), two tiled all_to_alls a block;
- ``ep_sp``: ``--num-shards`` expert shards x ``--num-sp`` sequence
  shards (default 2), the ring or Ulysses over the sequence;
- ``pp_moe``: ``--num-shards`` stages x ``--num-ep`` expert shards,
  ``--num-microbatches`` a column.

Under ``--attention-impl flash`` tp, dp_tp, pp, moe and pp_moe run the
within-device attention on K4 (normalized) forward, K5 + K6 backward,
ep_sp's ring K4's partial triple a hop. The MoE schemes log the router's
load-balance aux and put it in each ``train_lm`` record (``aux_loss``).

  python -m ps_pytorch_tpu_torch.cli.train_lm --parallelism dp_sp \\
      --attention-impl flash --vocab-size 2048 --dim 512 --depth 6 \\
      --heads 8 --seq-len 1024 --batch-size 8 --dtype bfloat16 --remat \\
      --lr 0.01 --momentum 0.9 --max-steps 20
  ... --num-dp 2 --num-sp 4 --seq-len 256 --device cpu   # the plain versions
  ... --parallelism tp --num-shards 4 --shard-vocab
  ... --parallelism dp_tp --num-dp 2 --num-shards 4
  ... --parallelism pp --num-shards 2 --num-microbatches 4
  ... --parallelism moe --num-shards 4 --top-k 2
  ... --parallelism ep_sp --num-shards 2 --num-sp 2
  ... --parallelism pp_moe --num-shards 2 --num-ep 2 --num-microbatches 4

Every flag of the JAX CLI parses, plus ``--device`` (default ``cuda``;
without a card it raises unless ``--device cpu``). ``--num-sp 0``,
``--num-shards 0`` and ``--num-ep 0`` mean all devices (over the other
axis), which on the one card is 1; ep_sp's ``--num-sp 0`` means 2, as in
JAX. ``--optimizer adam|amsgrad`` runs ``optim.adam``
(``--momentum`` is then unused). ``--metrics-file F`` appends a
``run_header`` and one ``train_lm`` record a log window, as the JAX CLI
does. ``--profile-dir DIR`` captures steps 3 to min(12, max-steps) with
``torch.profiler`` (a Chrome trace under DIR; obs/profiler.py).

``--train-dir DIR`` writes ``model_step_N`` every ``--eval-freq`` steps
and after the last: the dict the JAX CLI's ``save_lm_checkpoint`` writes
(plain-layout params whatever the scheme: the MoE schemes' with the
expert shards joined, ``kind: "moe"``; ``step``, the ``model`` and
``data`` metadata a structure-free evaluator rebuilds the model from), in
its bytes, so either package's ``cli.evaluate_lm`` reads it unchanged.

Data is the JAX CLI's synthetic Markov chain (``make_synthetic_tokens``,
numpy, so both packages draw the same corpus and batches); the weights
come from a ``torch.Generator`` seeded with ``--seed`` (values differ
from ``jax.random``'s).
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..checkpoint import save_checkpoint
from ..models.transformer import TransformerConfig, init_transformer
from ..obs import ProfileWindow, run_header
from ..optim import build_optimizer
from ..optim.schedules import (
    constant_schedule,
    join_schedules,
    linear_schedule,
    warmup_cosine_decay_schedule,
)
from ..parallel.buckets import tree_leaves
from ..parallel import dp_sp, dp_tp, ep_sp, moe, pp, pp_moe, tp
from ..trainer import append_metrics_line
from ..utils import format_iter_line, get_logger, host_sync

logger = get_logger()

# one card: the JAX CLI's len(jax.devices())
N_DEVICES = 1
MOE_SCHEMES = ("moe", "ep_sp", "pp_moe")


def make_synthetic_tokens(
    vocab_size: int,
    n_sequences: int,
    seq_len: int,
    seed: int = 0,
    branching: int = 4,
    sequence_seed: Optional[int] = None,
) -> np.ndarray:
    """Sequences from a fixed sparse Markov chain (cli/train_lm.py:49):
    every token transitions uniformly to one of ``branching`` fixed
    successors, so the cross-entropy floor is log(branching) nats.
    ``seed`` fixes the transition table; ``sequence_seed`` (default =
    seed) draws the walks. numpy throughout: array for array the JAX
    package's corpus."""
    rng = np.random.RandomState(seed)
    successors = rng.randint(0, vocab_size, size=(vocab_size, branching))
    srng = rng if sequence_seed is None else np.random.RandomState(sequence_seed)
    toks = np.empty((n_sequences, seq_len), np.int32)
    toks[:, 0] = srng.randint(0, vocab_size, n_sequences)
    for t in range(1, seq_len):
        pick = srng.randint(0, branching, n_sequences)
        toks[:, t] = successors[toks[:, t - 1], pick]
    return toks


def lr_schedule(name: str, lr: float, warmup_steps: int, max_steps: int):
    """The learning rate of cli/train_lm.py:158-174: a warm-up cosine
    decay, a linear warm-up joined to a constant, or the constant."""
    if name == "cosine":
        return warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=lr, warmup_steps=warmup_steps,
            decay_steps=max(max_steps, warmup_steps + 1),
        )
    if warmup_steps > 0:
        return join_schedules(
            [linear_schedule(0.0, lr, warmup_steps), constant_schedule(lr)],
            [warmup_steps],
        )
    return lr


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("ps_pytorch_tpu_torch.cli.train_lm")
    a = parser.add_argument
    a("--device", type=str, default="cuda",
      help="cuda (default; raises without a card) or cpu (the plain versions)")
    a("--num-dp", type=int, default=1)
    a("--num-sp", type=int, default=0,
      help="sequence shards (0 = all remaining devices: 1 on one card)")
    a("--vocab-size", type=int, default=256)
    a("--dim", type=int, default=128)
    a("--depth", type=int, default=2)
    a("--heads", type=int, default=4)
    a("--seq-len", type=int, default=512)
    a("--batch-size", type=int, default=8,
      help="global sequences per step (divisible by num-dp)")
    a("--max-steps", type=int, default=100)
    a("--lr", type=float, default=0.1)
    a("--momentum", type=float, default=0.9)
    a("--optimizer", default="sgd", choices=["sgd", "adam", "amsgrad"])
    a("--weight-decay", type=float, default=0.0)
    a("--lr-schedule", default="constant", choices=["constant", "cosine"])
    a("--warmup-steps", type=int, default=0)
    a("--dtype", default="float32", choices=["float32", "bfloat16"])
    a("--seed", type=int, default=1)
    a("--log-interval", type=int, default=10)
    a("--remat", action="store_true")
    a("--bidirectional-ring", action="store_true")
    a("--parallelism", default="dp_sp",
      choices=["dp_sp", "dp_tp", "tp", "pp", "moe", "ep_sp", "pp_moe"])
    a("--sp-attention", default="ring", choices=["ring", "ulysses"])
    a("--attention-impl", default="naive", choices=["naive", "flash"],
      help="within-device attention (flash = the hand-written kernels)")
    a("--shard-vocab", action="store_true")
    a("--num-shards", type=int, default=0)
    a("--num-microbatches", type=int, default=2)
    a("--num-experts", type=int, default=8)
    a("--num-ep", type=int, default=0)
    a("--capacity-factor", type=float, default=1.25)
    a("--top-k", type=int, default=1, choices=(1, 2))
    a("--train-size", type=int, default=512, help="synthetic corpus size (sequences)")
    a("--metrics-file", type=str, default=None)
    a("--profile-dir", type=str, default=None)
    a("--train-dir", type=str, default=None)
    a("--eval-freq", type=int, default=0,
      help="checkpoint every N steps (no effect without --train-dir)")
    return parser


def check_flags(args: argparse.Namespace) -> None:
    if args.shard_vocab and args.parallelism not in ("tp", "dp_tp"):
        raise ValueError(
            "--shard-vocab is implemented for --parallelism tp/dp_tp only "
            "(the other schemes keep the embedding replicated and would "
            "silently ignore it)")


def _no_aux(step, shard=lambda tok: tok):
    """A dense scheme's run: its step on the sharded tokens, no aux."""
    def run(p, o, tok):
        return (*step(p, o, shard(tok)), None)

    return run


def build_scheme(args: argparse.Namespace, cfg: TransformerConfig, tx, dev):
    """The ``--parallelism`` scheme (cli/train_lm.py:201-372 of the JAX
    package): (params, opt_state, run(params, opt_state, tokens [B, T]) ->
    (params, opt_state, loss, aux: None but for the MoE schemes),
    to_plain(params) -> the plain-layout tree, the layout string)."""
    n_shards = args.num_shards or N_DEVICES
    g = torch.Generator().manual_seed(args.seed)
    if args.parallelism == "dp_sp":
        num_sp = args.num_sp or max(N_DEVICES // args.num_dp, 1)
        if args.seq_len % num_sp:
            raise ValueError(f"--seq-len must be divisible by num_sp={num_sp}")
        if args.batch_size % args.num_dp:
            raise ValueError(f"--batch-size must be divisible by num_dp={args.num_dp}")
        mesh = dp_sp.make_mesh_2d(args.num_dp, num_sp)
        params = init_transformer(cfg, g, device=dev)
        step = dp_sp.make_lm_train_step(cfg, tx, mesh)
        return (params, tx.init(params),
                _no_aux(step, lambda tok: dp_sp.shard_tokens_2d(tok, mesh)),
                lambda p: p, f"dp {args.num_dp} x sp {num_sp} ({args.sp_attention})")
    vocab = " (vocab-parallel)" if args.shard_vocab else ""

    def tp_plain(p):
        return tp.from_tp_layout(cfg, tp.unshard_params_tp(cfg, p, args.shard_vocab))

    if args.parallelism == "tp":
        mesh = tp.make_tp_mesh(n_shards)
        params, opt_state = tp.init_tp_state(cfg, tx, g, mesh, args.shard_vocab, dev)
        return (params, opt_state,
                _no_aux(tp.make_tp_train_step(cfg, tx, mesh, args.shard_vocab)),
                tp_plain, f"tp {n_shards}{vocab}")
    if args.parallelism == "dp_tp":
        num_tp = args.num_shards or max(N_DEVICES // args.num_dp, 1)
        if args.batch_size % args.num_dp:
            raise ValueError(f"--batch-size must be divisible by num_dp={args.num_dp}")
        mesh = dp_tp.make_mesh_dp_tp(args.num_dp, num_tp)
        params, opt_state = dp_tp.init_dp_tp_state(cfg, tx, g, mesh, args.shard_vocab, dev)
        step = dp_tp.make_dp_tp_train_step(cfg, tx, mesh, args.shard_vocab)
        return (params, opt_state,
                _no_aux(step, lambda tok: dp_tp.shard_tokens_dp(tok, mesh)),
                tp_plain, f"dp {args.num_dp} x tp {num_tp}{vocab}")
    if args.parallelism == "pp":
        if args.batch_size % args.num_microbatches:
            raise ValueError(f"--batch-size must be divisible by "
                             f"num_microbatches={args.num_microbatches}")
        mesh = pp.make_pp_mesh(n_shards)
        params, opt_state = pp.init_pp_state(cfg, tx, g, mesh, dev)
        return (params, opt_state,
                _no_aux(pp.make_pp_train_step(cfg, tx, mesh,
                                              num_microbatches=args.num_microbatches)),
                lambda p: pp.from_pp_layout(cfg, p),
                f"pp {n_shards} x {args.num_microbatches} microbatches")
    mcfg = moe.MoEConfig(num_experts=args.num_experts,
                         capacity_factor=args.capacity_factor, top_k=args.top_k)
    if args.parallelism == "ep_sp":
        num_sp = args.num_sp or 2
        num_ep = args.num_shards or max(N_DEVICES // num_sp, 1)
        if args.seq_len % num_sp:
            raise ValueError(f"--seq-len must be divisible by num_sp={num_sp}")
        if args.batch_size % num_ep:
            raise ValueError(f"--batch-size must be divisible by expert shards={num_ep}")
        mesh = ep_sp.make_mesh_ep_sp(num_ep, num_sp)
        params, opt_state = ep_sp.init_ep_sp_state(cfg, mcfg, tx, g, mesh, dev)
        step = ep_sp.make_ep_sp_train_step(cfg, mcfg, tx, mesh)
        return (params, opt_state,
                lambda p, o, tok: step(p, o, ep_sp.shard_tokens_ep_sp(tok, mesh)),
                lambda p: moe.unshard_params_moe(cfg, p),
                f"ep {num_ep} ({args.num_experts} experts) x sp {num_sp} "
                f"({args.sp_attention})")
    if args.parallelism == "pp_moe":
        num_ep = args.num_ep or max(N_DEVICES // n_shards, 1)
        per_col = args.batch_size // num_ep if num_ep else 0
        if args.batch_size % num_ep or per_col % args.num_microbatches:
            raise ValueError(f"--batch-size must split over ep={num_ep} then "
                             f"num_microbatches={args.num_microbatches}")
        mesh = pp_moe.make_mesh_pp_moe(n_shards, num_ep)
        params, opt_state = pp_moe.init_pp_moe_state(cfg, mcfg, tx, g, mesh, dev)
        step = pp_moe.make_pp_moe_train_step(cfg, mcfg, tx, mesh,
                                             num_microbatches=args.num_microbatches)
        return (params, opt_state,
                lambda p, o, tok: step(p, o, pp_moe.shard_tokens_pp_moe(tok, mesh)),
                # the plain MoE layout, for the evaluator
                lambda p: pp.from_pp_layout(cfg, pp_moe.unshard_params_pp_moe(cfg, p)),
                f"pp {n_shards} x ep {num_ep} ({args.num_experts} experts, "
                f"{args.num_microbatches} microbatches)")
    # moe
    if args.batch_size % n_shards:
        raise ValueError(f"--batch-size must be divisible by expert shards={n_shards}")
    mesh = moe.make_ep_mesh(n_shards)
    params, opt_state = moe.init_moe_state(cfg, mcfg, tx, g, mesh, dev)
    step = moe.make_moe_train_step(cfg, mcfg, tx, mesh)
    return (params, opt_state,
            lambda p, o, tok: step(p, o, moe.shard_moe_batch(tok, mesh)),
            lambda p: moe.unshard_params_moe(cfg, p),
            f"moe {args.num_experts} experts over {n_shards} shards")


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    check_flags(args)
    cfg = TransformerConfig(
        vocab_size=args.vocab_size, dim=args.dim, depth=args.depth,
        heads=args.heads, max_seq_len=args.seq_len, remat=args.remat,
        bidirectional_ring=args.bidirectional_ring,
        sp_attention=args.sp_attention, attention_impl=args.attention_impl,
        # params/grads/moments stay f32; block math runs in bf16
        compute_dtype=torch.bfloat16 if args.dtype == "bfloat16" else None,
    )
    tx = build_optimizer(
        args.optimizer, lr_schedule(args.lr_schedule, args.lr, args.warmup_steps,
                                    args.max_steps),
        momentum=args.momentum, weight_decay=args.weight_decay,
    )
    dev = resolve_device(args.device)
    params, opt_state, run, to_plain, layout = build_scheme(args, cfg, tx, dev)

    corpus = make_synthetic_tokens(
        args.vocab_size, args.train_size, args.seq_len, seed=args.seed + 1
    )
    n_params = sum(int(x.numel()) for x in tree_leaves(params))
    logger.info("LM %dx d%d h%d (%d params), seq %d, %s on %s", args.depth, args.dim,
                args.heads, n_params, args.seq_len, layout, dev)
    append_metrics_line(args.metrics_file, run_header("train_lm", geometry={
        "parallelism": args.parallelism, "dim": args.dim, "depth": args.depth,
        "heads": args.heads, "seq_len": args.seq_len, "params": n_params}))

    def save_lm_checkpoint(step_no: int) -> None:
        # cli/train_lm.py:397-420 of the JAX package: plain-layout params
        if args.train_dir is None:
            return
        save_checkpoint({
            "params": to_plain(params),
            "step": step_no,
            "model": {
                "kind": "moe" if args.parallelism in MOE_SCHEMES else "dense",
                "vocab_size": cfg.vocab_size, "dim": cfg.dim,
                "depth": cfg.depth, "heads": cfg.heads, "mlp_ratio": cfg.mlp_ratio,
                "max_seq_len": cfg.max_seq_len, "num_experts": args.num_experts,
                "capacity_factor": float(args.capacity_factor), "top_k": args.top_k,
            },
            "data": {"seed": args.seed + 1, "seq_len": args.seq_len},
        }, args.train_dir, step_no)

    rng = np.random.RandomState(args.seed + 2)
    loss = float("nan")
    history = []
    # steady-state window: everything after the first `warmup` steps,
    # bracketed by host syncs so tokens/s excludes set-up
    warmup = min(2, args.max_steps - 1)
    steady_t0 = None
    steady = {}
    # the profiler captures steps 3 .. min(12, max_steps), after set-up
    # and settling (cli/train_lm.py:434-486 of the JAX package)
    if args.profile_dir and args.max_steps < 3:
        logger.warning("--profile-dir set but max-steps < 3: tracing starts at step 3 "
                       "(after set-up and settling), so no trace will be written")
    pw = ProfileWindow(args.profile_dir, 3, max(min(12, args.max_steps) - 2, 1), device=dev)
    try:
        for step_no in range(1, args.max_steps + 1):
            pw.before_step(step_no)
            if step_no == warmup + 1 and args.max_steps > warmup:
                host_sync(params)
                steady_t0 = time.perf_counter()
            log_now = step_no % args.log_interval == 0 or step_no == 1
            if log_now:
                host_sync(params)  # dt measures ONE step, not the queue before it
            t0 = time.perf_counter()
            idx = rng.randint(0, len(corpus), args.batch_size)
            params, opt_state, loss, aux = run(params, opt_state,
                                               torch.from_numpy(corpus[idx]).to(dev))
            if log_now:
                loss = float(loss)
                host_sync(params)  # include the param update in dt
                dt = time.perf_counter() - t0
                logger.info(format_iter_line(
                    rank="mesh", step=step_no, epoch=1, seen=step_no * args.batch_size,
                    total=args.max_steps * args.batch_size, loss=loss, time_cost=dt,
                    forward=dt,
                ))
                record = {"kind": "train_lm", "parallelism": args.parallelism,
                          "step": step_no, "loss": loss, "time_cost": round(dt, 6)}
                if aux is not None:
                    # router balance: aux == 1 is perfectly balanced; a climb
                    # toward num_experts signals expert collapse
                    record["aux_loss"] = round(float(aux), 6)
                    logger.info("MoE load-balance aux: %.4f", record["aux_loss"])
                history.append(record)
                append_metrics_line(args.metrics_file, record)
            if args.eval_freq > 0 and step_no % args.eval_freq == 0:
                save_lm_checkpoint(step_no)
    finally:
        pw.close()
    if steady_t0 is not None:
        host_sync(params)
        steady = {"steady_steps": args.max_steps - warmup,
                  "steady_elapsed_s": time.perf_counter() - steady_t0}
    if args.eval_freq <= 0 or args.max_steps % args.eval_freq:
        save_lm_checkpoint(args.max_steps)
    # history: the per-log-window records, also in --metrics-file
    return {"loss": float(loss), "params": n_params, "layout": layout, **steady,
            "history": history, "profile": pw}


if __name__ == "__main__":
    main()
