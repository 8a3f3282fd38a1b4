"""Datasets (the port's subset of data/datasets.py): the reference's
normalization statistics and augmentation policy, and the deterministic
synthetic datasets.

``make_synthetic`` is the JAX package's numpy code, so the port's images
and labels are bit-identical to the reference's for the same seed. The
on-disk readers (MNIST idx, CIFAR pickles, SVHN .mat) are not ported
yet: ``prepare_data`` serves the synthetic set and raises when asked for
files (ROADMAP.md). Nothing is downloaded.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

NORM_STATS = {
    "MNIST": (np.array([0.1307]), np.array([0.3081])),
    "Cifar10": (
        np.array([125.3, 123.0, 113.9]) / 255.0,
        np.array([63.0, 62.1, 66.7]) / 255.0,
    ),
    "Cifar100": (
        np.array([125.3, 123.0, 113.9]) / 255.0,
        np.array([63.0, 62.1, 66.7]) / 255.0,
    ),
    "SVHN": (
        np.array([0.4914, 0.4822, 0.4465]),
        np.array([0.2023, 0.1994, 0.2010]),
    ),
}

NUM_CLASSES = {"MNIST": 10, "Cifar10": 10, "Cifar100": 100, "SVHN": 10}
IMAGE_SHAPES = {
    "MNIST": (28, 28, 1),
    "Cifar10": (32, 32, 3),
    "Cifar100": (32, 32, 3),
    "SVHN": (32, 32, 3),
}
DATASET_NAMES = tuple(NUM_CLASSES)

# 4-pixel pad (reflect for CIFAR, zero for SVHN) + random crop + hflip;
# MNIST gets none (the reference's util.py:25-47, 91-95)
AUGMENT = {"MNIST": False, "Cifar10": True, "Cifar100": True, "SVHN": True}
PAD_MODE = {"Cifar10": "reflect", "Cifar100": "reflect", "SVHN": "constant"}


@dataclass
class Dataset:
    """In-memory split pair. images are uint8 [N,H,W,C]; labels int32 [N]."""

    name: str
    train_images: np.ndarray
    train_labels: np.ndarray
    test_images: np.ndarray
    test_labels: np.ndarray
    synthetic: bool = False

    @property
    def num_classes(self) -> int:
        return NUM_CLASSES[self.name]

    @property
    def norm_stats(self) -> Tuple[np.ndarray, np.ndarray]:
        return NORM_STATS[self.name]


def make_synthetic(name: str, train_size: int = 4096, test_size: int = 1024,
                   seed: int = 0) -> Dataset:
    """Deterministic class-structured fake data (datasets.py:185): each
    class has a fixed random template; samples are template + noise, so
    models can learn without any download."""
    h, w, c = IMAGE_SHAPES[name]
    k = NUM_CLASSES[name]
    rng = np.random.RandomState(seed)
    templates = rng.randint(0, 256, size=(k, h, w, c))

    def split(n, seed_):
        r = np.random.RandomState(seed_)
        y = r.randint(0, k, size=n)
        noise = r.normal(0, 32, size=(n, h, w, c))
        x = np.clip(templates[y] + noise, 0, 255).astype(np.uint8)
        return x, y.astype(np.int32)

    tr_x, tr_y = split(train_size, seed + 1)
    te_x, te_y = split(test_size, seed + 2)
    return Dataset(name, tr_x, tr_y, te_x, te_y, synthetic=True)


def prepare_data(name: str, root: Optional[str] = None, allow_synthetic: bool = True,
                 synthetic_train_size: int = 4096) -> Dataset:
    """The dataset by reference CLI name: the synthetic set. Reading
    files (``root`` given, or synthetic data refused) is not ported."""
    if name not in NUM_CLASSES:
        raise ValueError(f"unknown dataset {name!r}; choose from {DATASET_NAMES}")
    if root is not None or not allow_synthetic:
        raise NotImplementedError(
            "the on-disk dataset readers (idx / CIFAR pickle / SVHN .mat) are "
            "not ported yet (ROADMAP.md queue 1 item 4): drop --data-root and "
            "--no-synthetic to train on the synthetic set"
        )
    return make_synthetic(name, train_size=synthetic_train_size)
