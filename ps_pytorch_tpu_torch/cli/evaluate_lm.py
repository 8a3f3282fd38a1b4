"""Out-of-band LM evaluator: perplexity on a held-out split (the port of
ps_pytorch_tpu.cli.evaluate_lm).

The LM counterpart of cli/evaluate.py. It reads the scheme-agnostic
checkpoints ``cli.train_lm`` writes, this package's or the JAX
package's (the same bytes), whatever the producer ran (dp_sp, tp, dp_tp,
pp, moe, ep_sp, pp_moe): dense checkpoints replay through
``apply_transformer`` on one device, MoE ones (``model.kind == "moe"``)
through ``parallel.moe.apply_moe_transformer`` with every expert local,
and ``--generate`` decodes either (``generate(..., moe=)``).

The eval split regenerates the SAME Markov chain the trainer used (the
transition table is fixed by the recorded data seed) but walks fresh
sequences (the sequence seed shifted by ``EVAL_SEQUENCE_SEED_OFFSET``),
so the perplexity is held-out. The forward is eager PyTorch: nothing is
compiled, so polling many checkpoints of one run recompiles nothing.

  python -m ps_pytorch_tpu_torch.cli.evaluate_lm --model-dir /tmp/lm --once
  ... --device cpu   # the plain versions
"""

from __future__ import annotations

import argparse
import math

import torch

from .. import DeviceLike, resolve_device
from ..checkpoint import (
    latest_valid_step,
    listify_raw,
    load_checkpoint_raw,
    poll_checkpoints,
)
from ..models.convert import params_from_jax
from ..models.decode import generate
from ..models.transformer import TransformerConfig, apply_transformer
from ..ops.metrics import next_token_nll
from ..parallel.moe import MoEConfig, apply_moe_transformer
from ..utils import get_logger
from .train_lm import make_synthetic_tokens

logger = get_logger()

EVAL_SEQUENCE_SEED_OFFSET = 7919  # prime shift: held-out walks, same chain


@torch.no_grad()
def evaluate_checkpoint(model_dir: str, step: int, eval_size: int = 64,
                        batch_size: int = 16, generate_tokens: int = 0,
                        device: DeviceLike = None) -> dict:
    """Loss and perplexity of checkpoint ``step`` on ``eval_size``
    held-out sequences; with ``generate_tokens`` also samples that many
    tokens (temperature 0.8, seeded by the step) from two held-out
    prompts."""
    dev = resolve_device(device)
    raw = load_checkpoint_raw(model_dir, step)
    m = raw["model"]
    params = params_from_jax(listify_raw(raw["params"]), device=dev)
    cfg = TransformerConfig(
        vocab_size=int(m["vocab_size"]), dim=int(m["dim"]), depth=int(m["depth"]),
        heads=int(m["heads"]), mlp_ratio=int(m["mlp_ratio"]),
        max_seq_len=int(m["max_seq_len"]),
    )
    moe = None
    if m["kind"] == "moe":
        moe = MoEConfig(num_experts=int(m["num_experts"]),
                        capacity_factor=float(m["capacity_factor"]),
                        top_k=int(m.get("top_k", 1)))
    seq_len = int(raw["data"]["seq_len"])
    seed = int(raw["data"]["seed"])
    toks = torch.from_numpy(make_synthetic_tokens(
        cfg.vocab_size, eval_size, seq_len, seed=seed,
        sequence_seed=seed + EVAL_SEQUENCE_SEED_OFFSET)).to(dev)

    total, count = 0.0, 0
    for i in range(0, eval_size, batch_size):
        t = toks[i: i + batch_size]
        logits = (apply_transformer(cfg, params, t) if moe is None
                  else apply_moe_transformer(cfg, moe, params, t)[0])
        total += float(next_token_nll(logits, t)) * t.shape[0]
        count += t.shape[0]
    nll = total / count
    out = {"step": step, "loss": nll, "perplexity": math.exp(nll)}

    if generate_tokens > 0:
        prompt = toks[:2, : min(8, seq_len // 2)]
        # clamp to the model's positional range (a sampling nicety must
        # never crash the long-running polling process)
        n_new = min(generate_tokens, cfg.max_seq_len - prompt.shape[1])
        if n_new < generate_tokens:
            logger.info("generation: clamping %d -> %d tokens (max_seq_len %d)",
                        generate_tokens, n_new, cfg.max_seq_len)
        sample = generate(cfg, params, prompt, max_new_tokens=n_new, temperature=0.8,
                          generator=torch.Generator(device=dev).manual_seed(step),
                          max_len=prompt.shape[1] + n_new, device=dev, moe=moe)
        out["samples"] = sample.cpu().tolist()
        for row in out["samples"]:
            logger.info("sample: %s", " ".join(map(str, row)))
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("ps_pytorch_tpu_torch.cli.evaluate_lm")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--eval-size", type=int, default=64,
                   help="held-out sequences per evaluation")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--once", action="store_true",
                   help="evaluate the latest checkpoint and exit")
    p.add_argument("--poll-interval", type=float, default=10.0)
    p.add_argument("--timeout", type=float, default=None,
                   help="stop after this long with no new checkpoint")
    p.add_argument("--generate", type=int, default=0,
                   help="also sample N tokens from 2 held-out prompts (KV-cache decode)")
    args = p.parse_args(argv)

    if args.once:
        # the newest VALID step: a damaged latest file must not end the
        # one-shot evaluation when an older good one exists
        step = latest_valid_step(args.model_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {args.model_dir}")
        steps = [step]
    else:
        steps = poll_checkpoints(args.model_dir, interval_s=args.poll_interval,
                                 timeout_s=args.timeout)
    results = {}
    for step in steps:
        r = evaluate_checkpoint(args.model_dir, step, args.eval_size, args.batch_size,
                                generate_tokens=args.generate, device=args.device)
        results[step] = r
        logger.info("LM Validation Step: %d, Loss: %.4f, Perplexity: %.3f",
                    r["step"], r["loss"], r["perplexity"])
    return results


if __name__ == "__main__":
    main()
