"""Out-of-band polling evaluator (the port of ps_pytorch_tpu.cli.evaluate;
parity: the reference's distributed_evaluator.py).

A separate process that shares only a filesystem with the trainer: it
polls ``--model-dir`` for new ``model_step_N`` checkpoints (every
``--poll-interval`` seconds), loads each, and reports test loss / Prec@1 /
Prec@5 in the reference's line format. ``--once`` evaluates the newest
valid checkpoint and exits; ``--timeout`` stops after that many idle
seconds. The checkpoints may come from this package's trainer or the JAX
package's: the files are the same.

``--data-root DIR`` (with ``--no-synthetic`` to refuse the synthetic
fallback) reads the test split from the on-disk formats
``data.prepare_data`` reads (MNIST idx, CIFAR pickles, SVHN .mat).

Checkpoints load structure-free (``checkpoint.load_checkpoint_raw``), so
the evaluator needs only ``--network`` / ``--dataset``, never the
trainer's optimizer, placement or BN mode. Per-worker (``bn_mode
local``) BN stats, stacked on a leading worker axis, are averaged. The
model runs on one device: ``--device cuda`` (default) or ``cpu``.

    python -m ps_pytorch_tpu_torch.cli.evaluate --model-dir output/models/ \\
        --network LeNet --dataset MNIST --once
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from .. import checkpoint as ckpt
from ..data import BatchIterator, make_preprocessor, prefetch_to_device, prepare_data
from ..models import apply_model, build_model, init_model
from ..ops.metrics import accuracy, cross_entropy_loss
from ..parallel.buckets import tree_leaves, tree_map
from ..trainer import average_metrics
from ..utils import format_eval_line, get_logger

logger = get_logger()


def _tensor(x, device: torch.device) -> torch.Tensor:
    return (x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))).to(device)


class Evaluator:
    """Loads step-tagged checkpoints and runs the test split on one device."""

    def __init__(self, network: str, dataset_name: str, model_dir: str,
                 eval_batch_size: int = 1000, data_root: Optional[str] = None,
                 allow_synthetic: bool = True, device: DeviceLike = None):
        self.model_dir = model_dir
        self.device = resolve_device(device)
        self.dataset = prepare_data(dataset_name, root=data_root,
                                    allow_synthetic=allow_synthetic)
        self.model = build_model(network, num_classes=self.dataset.num_classes)
        # only to recognize the expected batch_stats leaf ranks
        _, self._bn_template = init_model(self.model, torch.Generator().manual_seed(0),
                                          device="cpu")
        self._pre = make_preprocessor(dataset_name, train=False)
        self.eval_batch_size = eval_batch_size

    def _extract(self, raw: dict):
        """params / batch_stats of a raw checkpoint dict as tensors on the
        device; stacked per-worker BN stats averaged."""
        params = tree_map(lambda x: _tensor(x, self.device), raw["params"])
        batch_stats = tree_map(lambda x: _tensor(x, self.device), raw.get("batch_stats") or {})
        expected = tree_leaves(self._bn_template)
        got = tree_leaves(batch_stats)
        if expected and got and got[0].dim() == expected[0].dim() + 1:
            batch_stats = tree_map(lambda x: torch.mean(x, dim=0), batch_stats)
        return params, batch_stats

    @torch.no_grad()
    def _eval_batch(self, params, batch_stats, batch) -> dict:
        x = self._pre(torch.as_tensor(batch["image"]).to(self.device))
        labels = torch.as_tensor(batch["label"]).to(self.device).long()
        logits, _ = apply_model(self.model, params, batch_stats, x, train=False)
        prec1, prec5 = accuracy(logits, labels, (1, 5))
        return {"loss": cross_entropy_loss(logits, labels), "prec1": prec1, "prec5": prec5}

    def evaluate_step(self, step: int) -> dict:
        params, batch_stats = self._extract(ckpt.load_checkpoint_raw(self.model_dir, step))
        it = BatchIterator(self.dataset.test_images, self.dataset.test_labels,
                           self.eval_batch_size, shuffle=False)
        # the trainer's prefetch: pinned staging, a copy stream, two in flight
        out = average_metrics(lambda b: self._eval_batch(params, batch_stats, b),
                              prefetch_to_device(iter(it), size=2, device=self.device))
        logger.info(format_eval_line(step, out["loss"], out["prec1"], out["prec5"]))
        return out

    def run(self, poll_interval: float = 10.0, timeout: Optional[float] = None,
            once: bool = False) -> dict:
        results = {}
        if once:
            # newest VALID step: a damaged latest file must not end a
            # one-shot evaluation when an older good one exists
            step = ckpt.latest_valid_step(self.model_dir)
            if step is None:
                logger.info("no checkpoints in %s", self.model_dir)
                return results
            results[step] = self.evaluate_step(step)
            return results
        for step in ckpt.poll_checkpoints(self.model_dir, interval_s=poll_interval,
                                          timeout_s=timeout):
            results[step] = self.evaluate_step(step)
        return results


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser("ps_pytorch_tpu_torch.cli.evaluate")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    parser.add_argument("--eval-batch-size", type=int, default=1000)
    parser.add_argument("--model-dir", type=str, default="output/models/")
    parser.add_argument("--dataset", type=str, default="MNIST")
    parser.add_argument("--network", type=str, default="LeNet")
    parser.add_argument("--data-root", type=str, default=None)
    parser.add_argument("--no-synthetic", action="store_true")
    parser.add_argument("--poll-interval", type=float, default=10.0)
    parser.add_argument("--timeout", type=float, default=None,
                        help="stop after this many idle seconds (default: poll forever)")
    parser.add_argument("--once", action="store_true",
                        help="evaluate the newest checkpoint and exit")
    args = parser.parse_args(argv)
    ev = Evaluator(args.network, args.dataset, args.model_dir,
                   eval_batch_size=args.eval_batch_size, data_root=args.data_root,
                   allow_synthetic=not args.no_synthetic, device=args.device)
    return ev.run(poll_interval=args.poll_interval, timeout=args.timeout, once=args.once)


if __name__ == "__main__":
    main()
