"""LM training entry of the port (the counterpart of
ps_pytorch_tpu.cli.train_lm), ``--parallelism dp_sp``: a (dp x sp) grid
of virtual workers stacked on the one card, batch shards over dp,
sequence shards over sp, ring (one-way or ``--bidirectional-ring``) or
Ulysses attention, naive or on the flash kernels (K4's partial triple
per ring hop forward, K5 + K6 backward).

  python -m ps_pytorch_tpu_torch.cli.train_lm --parallelism dp_sp \\
      --attention-impl flash --vocab-size 2048 --dim 512 --depth 6 \\
      --heads 8 --seq-len 1024 --batch-size 8 --dtype bfloat16 --remat \\
      --lr 0.01 --momentum 0.9 --max-steps 20
  ... --num-dp 2 --num-sp 4 --seq-len 256 --device cpu   # the plain versions

Every flag of the JAX CLI parses, plus ``--device`` (default ``cuda``;
without a card it raises unless ``--device cpu``). ``--num-sp 0`` means
all remaining devices, which on the one card is 1. Values this slice
does not run are refused with a pointer to ROADMAP.md: the other
``--parallelism`` schemes, ``--optimizer adam|amsgrad``,
``--metrics-file``, ``--profile-dir`` and ``--train-dir`` (checkpoints).

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
from ..models.transformer import TransformerConfig, init_transformer
from ..optim import build_optimizer
from ..optim.schedules import (
    constant_schedule,
    join_schedules,
    linear_schedule,
    warmup_cosine_decay_schedule,
)
from ..parallel.buckets import tree_leaves
from ..parallel.dp_sp import make_lm_train_step, make_mesh_2d, shard_tokens_2d
from ..utils import format_iter_line, get_logger, host_sync

logger = get_logger()

# one card: the JAX CLI's len(jax.devices())
N_DEVICES = 1


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


def refuse_unported(args: argparse.Namespace) -> None:
    if args.parallelism != "dp_sp":
        raise NotImplementedError(
            f"--parallelism {args.parallelism} is not ported yet (ROADMAP.md "
            "queue 1 item 19): the port runs dp_sp")
    if args.metrics_file is not None:
        raise NotImplementedError(
            "--metrics-file (the metrics JSONL) is not ported yet (ROADMAP.md "
            "queue 1 item 10)")
    if args.profile_dir is not None:
        raise NotImplementedError(
            "--profile-dir is not ported yet (ROADMAP.md queue 1 item 16); "
            "tools/train_lm_profile.py profiles the card")
    if args.train_dir is not None:
        raise NotImplementedError(
            "--train-dir (LM checkpoints) is not ported yet (ROADMAP.md queue 1 "
            "item 9)")
    if args.shard_vocab:
        raise ValueError(
            "--shard-vocab is implemented for --parallelism tp/dp_tp only "
            "(the other schemes keep the embedding replicated and would "
            "silently ignore it)")


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    refuse_unported(args)
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
    num_sp = args.num_sp or max(N_DEVICES // args.num_dp, 1)
    if args.seq_len % num_sp:
        raise ValueError(f"--seq-len must be divisible by num_sp={num_sp}")
    if args.batch_size % args.num_dp:
        raise ValueError(f"--batch-size must be divisible by num_dp={args.num_dp}")
    dev = resolve_device(args.device)
    mesh = make_mesh_2d(args.num_dp, num_sp)
    params = init_transformer(cfg, torch.Generator().manual_seed(args.seed), device=dev)
    opt_state = tx.init(params)
    step = make_lm_train_step(cfg, tx, mesh)
    layout = f"dp {args.num_dp} x sp {num_sp} ({args.sp_attention})"

    corpus = make_synthetic_tokens(
        args.vocab_size, args.train_size, args.seq_len, seed=args.seed + 1
    )
    n_params = sum(int(x.numel()) for x in tree_leaves(params))
    logger.info("LM %dx d%d h%d (%d params), seq %d, %s on %s", args.depth, args.dim,
                args.heads, n_params, args.seq_len, layout, dev)

    rng = np.random.RandomState(args.seed + 2)
    loss = float("nan")
    history = []
    # steady-state window: everything after the first `warmup` steps,
    # bracketed by host syncs so tokens/s excludes set-up
    warmup = min(2, args.max_steps - 1)
    steady_t0 = None
    steady = {}
    for step_no in range(1, args.max_steps + 1):
        if step_no == warmup + 1 and args.max_steps > warmup:
            host_sync(params)
            steady_t0 = time.perf_counter()
        log_now = step_no % args.log_interval == 0 or step_no == 1
        if log_now:
            host_sync(params)  # dt measures ONE step, not the queue before it
        t0 = time.perf_counter()
        idx = rng.randint(0, len(corpus), args.batch_size)
        tokens = shard_tokens_2d(torch.from_numpy(corpus[idx]).to(dev), mesh)
        params, opt_state, loss = step(params, opt_state, tokens)
        if log_now:
            loss = float(loss)
            host_sync(params)  # include the param update in dt
            dt = time.perf_counter() - t0
            logger.info(format_iter_line(
                rank="mesh", step=step_no, epoch=1, seen=step_no * args.batch_size,
                total=args.max_steps * args.batch_size, loss=loss, time_cost=dt,
                forward=dt,
            ))
            history.append({"kind": "train_lm", "parallelism": args.parallelism,
                            "step": step_no, "loss": loss, "time_cost": round(dt, 6)})
    if steady_t0 is not None:
        host_sync(params)
        steady = {"steady_steps": args.max_steps - warmup,
                  "steady_elapsed_s": time.perf_counter() - steady_t0}
    # history: the per-log-window records the JAX CLI appends to
    # --metrics-file, kept in memory here
    return {"loss": float(loss), "params": n_params, **steady, "history": history}


if __name__ == "__main__":
    main()
