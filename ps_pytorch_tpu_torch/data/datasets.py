"""Datasets (the port of data/datasets.py): the reference's
normalization statistics and augmentation policy, the on-disk readers
and the deterministic synthetic datasets.

The readers and ``make_synthetic`` are the JAX package's numpy code, so
the port's arrays are bit-identical to the reference's: images uint8
NHWC, labels int32. Nothing is downloaded. On-disk formats, looked for
under ``root`` (``--data-root``), else ``$PS_TPU_DATA_DIR``, else
``./data``:

- MNIST: the idx files (``train-images-idx3-ubyte`` etc., plain or
  ``.gz``);
- CIFAR-10 / CIFAR-100: the python pickle batches
  (``cifar-10-batches-py/data_batch_1..5`` + ``test_batch``;
  ``cifar-100-python/train`` + ``test``, fine labels);
- SVHN: ``train_32x32.mat`` / ``test_32x32.mat`` (scipy; HWCN -> NHWC,
  label 10 -> 0).
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
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


def _data_root(root: Optional[str]) -> str:
    return root or os.environ.get("PS_TPU_DATA_DIR", "./data")


# ---------------------------------------------------------------- raw readers


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(dims)


def _find(root: str, names) -> Optional[str]:
    """The first file named one of ``names`` in ``os.walk`` order (JAX's
    walk, kept as it is: the same tree finds the same file)."""
    for dirpath, _, files in os.walk(root):
        for n in names:
            if n in files:
                return os.path.join(dirpath, n)
    return None


def _load_mnist(root: str) -> Optional[Tuple[np.ndarray, ...]]:
    parts = []
    for stem in ("train-images-idx3-ubyte", "train-labels-idx1-ubyte",
                 "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"):
        p = _find(root, (stem, stem + ".gz"))
        if p is None:
            return None
        parts.append(_read_idx(p))
    tr_x, tr_y, te_x, te_y = parts
    return tr_x[..., None], tr_y.astype(np.int32), te_x[..., None], te_y.astype(np.int32)


def _load_cifar(root: str, fine: bool) -> Optional[Tuple[np.ndarray, ...]]:
    """CIFAR-10 (``fine=False``) or CIFAR-100's fine labels. As in JAX,
    CIFAR-100's ``train`` counts only under a path holding "cifar-100"."""
    def unpickle(p):
        with open(p, "rb") as f:
            return pickle.load(f, encoding="bytes")

    if not fine:
        first = _find(root, ("data_batch_1",))
        if first is None:
            return None
        d = os.path.dirname(first)
        batches = [unpickle(os.path.join(d, f"data_batch_{i}")) for i in range(1, 6)]
        test = unpickle(os.path.join(d, "test_batch"))
        tr_x = np.concatenate([b[b"data"] for b in batches])
        tr_y = np.concatenate([b[b"labels"] for b in batches])
        te_x, te_y = test[b"data"], np.asarray(test[b"labels"])
    else:
        trainp = _find(root, ("train",))
        if trainp is None or "cifar-100" not in trainp:
            return None
        d = os.path.dirname(trainp)
        tr = unpickle(os.path.join(d, "train"))
        te = unpickle(os.path.join(d, "test"))
        tr_x, tr_y = tr[b"data"], np.asarray(tr[b"fine_labels"])
        te_x, te_y = te[b"data"], np.asarray(te[b"fine_labels"])

    def to_hwc(a):
        return a.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)

    return to_hwc(tr_x), np.asarray(tr_y, np.int32), to_hwc(te_x), np.asarray(te_y, np.int32)


def _load_svhn(root: str) -> Optional[Tuple[np.ndarray, ...]]:
    import scipy.io

    trp = _find(root, ("train_32x32.mat",))
    tep = _find(root, ("test_32x32.mat",))
    if trp is None or tep is None:
        return None

    def load(p):
        m = scipy.io.loadmat(p)
        x = m["X"].transpose(3, 0, 1, 2)  # HWCN -> NHWC
        y = m["y"].astype(np.int32).reshape(-1)
        y[y == 10] = 0
        return x, y

    tr_x, tr_y = load(trp)
    te_x, te_y = load(tep)
    return tr_x, tr_y, te_x, te_y


# ------------------------------------------------------------------ synthetic


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
    """The dataset by reference CLI name (``--dataset``): the files under
    ``_data_root(root)`` when found, else the synthetic set, else (with
    ``allow_synthetic=False``) ``FileNotFoundError`` (datasets.py:211)."""
    if name not in NUM_CLASSES:
        raise ValueError(f"unknown dataset {name!r}; choose from {DATASET_NAMES}")
    root_dir = _data_root(root)
    loaded = None
    if os.path.isdir(root_dir):
        if name == "MNIST":
            loaded = _load_mnist(root_dir)
        elif name == "Cifar10":
            loaded = _load_cifar(root_dir, fine=False)
        elif name == "Cifar100":
            loaded = _load_cifar(root_dir, fine=True)
        elif name == "SVHN":
            loaded = _load_svhn(root_dir)
    if loaded is not None:
        return Dataset(name, *loaded)
    if not allow_synthetic:
        raise FileNotFoundError(f"no {name} data under {root_dir!r} and allow_synthetic=False")
    return make_synthetic(name, train_size=synthetic_train_size)
