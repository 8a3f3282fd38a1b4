"""Device-side batch preprocessing: normalize + (pad, random crop, random
flip) (the port of data/augment.py).

The random draws are explicit: ``draw_crop_flip`` takes them from a
``torch.Generator``, and ``random_crop_flip`` applies whatever draws it is
given, so the parity tests can feed it the offsets and flips JAX drew
(``jax.random.randint`` / ``bernoulli`` cannot be reproduced in torch).
The crop and flip move uint8 values, so they are exact on any device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass
class CropFlipDraws:
    """Per-image crop offsets (int ``[n, 2]``, row and column in
    ``[0, 2 * pad]``) and horizontal flips (bool ``[n]``)."""

    offsets: torch.Tensor
    flips: torch.Tensor


def draw_crop_flip(generator: torch.Generator, n: int, pad: int = 4) -> CropFlipDraws:
    """The draws of ``random_crop_flip`` for ``n`` images (augment.py:35,
    :41), from a CPU generator."""
    offsets = torch.randint(0, 2 * pad + 1, (n, 2), generator=generator)
    flips = torch.rand((n,), generator=generator) < 0.5
    return CropFlipDraws(offsets, flips)


def normalize(images: torch.Tensor, mean: np.ndarray, std: np.ndarray) -> torch.Tensor:
    """uint8 NHWC -> normalized f32, ``(x / 255 - mean) / std`` as XLA
    runs it under jit: both divisions by constants become multiplies by
    their f32 reciprocals."""
    dev = images.device
    r255 = float(np.float32(1.0) / np.float32(255.0))
    m = torch.from_numpy(np.asarray(mean, np.float32)).to(dev)
    rstd = torch.from_numpy(np.float32(1.0) / np.asarray(std, np.float32)).to(dev)
    return (images.float() * r255 - m) * rstd


def random_crop_flip(images: torch.Tensor, draws: CropFlipDraws, pad: int = 4,
                     pad_mode: str = "reflect") -> torch.Tensor:
    """NHWC batch: ``pad``-pixel pad, crop back to the original size at
    the drawn offsets, flip the drawn images horizontally. Returns f32
    holding the (exact) uint8 values."""
    n, h, w, _ = images.shape
    dev = images.device
    x = F.pad(images.permute(0, 3, 1, 2).float(), (pad, pad, pad, pad), mode=pad_mode)
    offs = draws.offsets.to(dev)
    rows = offs[:, 0, None] + torch.arange(h, device=dev)
    cols = offs[:, 1, None] + torch.arange(w, device=dev)
    idx = torch.arange(n, device=dev)[:, None, None]
    # the advanced indices around the channel slice put [n, h, w] first:
    # the result is NHWC again
    out = x[idx, :, rows[:, :, None], cols[:, None, :]]
    flips = draws.flips.to(dev)[:, None, None, None]
    return torch.where(flips, out.flip(2), out)


def preprocess_batch(images: torch.Tensor, mean: np.ndarray, std: np.ndarray, augment: bool,
                     draws: Optional[CropFlipDraws] = None, pad_mode: str = "reflect",
                     pad: int = 4) -> torch.Tensor:
    """The whole train / eval preprocessing (augment.py:46), with the
    crop and flip draws injected in place of JAX's key; ``augment=False``
    is the test path."""
    if augment:
        if draws is None:
            raise ValueError("this preprocessor augments: pass its draws")
        images = random_crop_flip(images, draws, pad, pad_mode)
    return normalize(images, mean, std)


@dataclasses.dataclass(frozen=True)
class Preprocessor:
    """``fn(images, draws=None)`` for one dataset, with the reference's
    augmentation policy (``augment``) baked in."""

    mean: np.ndarray
    std: np.ndarray
    augment: bool
    pad_mode: str = "reflect"
    pad: int = 4

    def draw(self, generator: torch.Generator, n: int) -> Optional[CropFlipDraws]:
        return draw_crop_flip(generator, n, self.pad) if self.augment else None

    def __call__(self, images: torch.Tensor,
                 draws: Optional[CropFlipDraws] = None) -> torch.Tensor:
        return preprocess_batch(images, self.mean, self.std, self.augment, draws,
                                self.pad_mode, self.pad)


def make_preprocessor(dataset_name: str, train: bool) -> Preprocessor:
    from .datasets import AUGMENT, NORM_STATS, PAD_MODE

    mean, std = NORM_STATS[dataset_name]
    return Preprocessor(mean, std, train and AUGMENT[dataset_name],
                        PAD_MODE.get(dataset_name, "reflect"))
