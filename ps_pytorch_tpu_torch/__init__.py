"""PyTorch/CUDA port of ps_pytorch_tpu, for one NVIDIA H100.

The JAX package beside this one is the reference; each module here keeps
its counterpart's name so a reader can find it. This package imports
``torch`` and never JAX or anything of the JAX package.

Slices in place, on hand-written Hopper kernels (``csrc/``):

- serving: batched flash prefill into a slot pool, int8 block-scale KV
  cache, continuous-batching greedy decode, open-loop traffic (K1, K4);
  ``cli.serve`` with hot checkpoint rollover, SLO admission control and
  the serve-side faults;
- synchronous PS training: ``cli.train`` -> ``Trainer`` -> the PS step on
  N virtual workers stacked on one card, with the per-leaf int8
  gradient wire (K2 per tensor, K1's shared-scale entry per block);
- checkpoints: ``model_step_N`` in the JAX package's bytes, plain or
  compressed by the native codec (``ops/codec.py``), ``--resume`` and the
  polling evaluator ``cli.evaluate`` (``checkpoint.py``);
- Adam / AMSGrad (``optim/adam.py``), and the workers spread over the
  processes of a ``torch.distributed`` group (``parallel/mesh.py``
  ``ProcessWorkerAxis``: NCCL one process a card, gloo on the CPU), the
  shared scale's cross-process max between the halves of K2's and K1's
  split routes;
- the on-disk datasets (``data.prepare_data``), the native batch gather
  (``native/loader.cc`` through ``data/_native.py``) and the pinned
  device prefetch (``data.prefetch_to_device``); the adaptive gradient
  wire: stochastic rounding, the int4 / lattice codec, the adaptive
  aggregation count and per-bucket precision with their controllers
  (``resilience/elastic.py``, ``resilience/precision.py``), K3 dividing by
  the device count;
- pscheck (``check/``): the communication contracts PSC101-110 over a
  recorded step, the registry of the JAX package's 37 configurations and
  the port's committed accounting artifact.

What is still to port is listed in ROADMAP.md.

Device rule: every entry point takes an explicit ``device``. The default
is ``cuda``; without a card it raises unless the caller passed
``device="cpu"``. Nothing falls back to the CPU silently.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller says
    otherwise. Raises when CUDA is asked for (explicitly or by default)
    and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!r} (cuda or cpu)")
    return dev


def on_device(tree, device: torch.device):
    """Move every tensor of a nested dict/list tree to ``device`` (no-op
    for tensors already there)."""
    if isinstance(tree, dict):
        return {k: on_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(on_device(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


__all__ = ["DeviceLike", "on_device", "resolve_device"]
