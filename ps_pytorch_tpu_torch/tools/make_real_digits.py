"""Write REAL image data in the reference's on-disk formats (the port of
tools/make_real_digits.py; imports neither JAX nor scikit-learn).

The source is the package's copy of the UCI handwritten-digits set
(``ps_pytorch_tpu_torch/data/digits.csv.gz``, scikit-learn's bundled
file byte for byte; ``data/NOTICE``): 1797 genuine 8x8 grayscale scans of
human-written digits, read with numpy's ``loadtxt`` (64 pixel columns,
then the label). From it this writes drop-in stand-ins for the datasets
the reference trains on, as the JAX tool writes them, byte for byte:

- MNIST: digits upscaled to 28x28, the four idx files
  (``train-images-idx3-ubyte``, ...) ``data/datasets`` reads;
- CIFAR-10: upscaled to 32x32, replicated to RGB, the python pickle
  batches (``data_batch_1..5``, ``test_batch``);
- CIFAR-100: the same images in ``cifar-100-python/{train,test}``
  (``fine_labels``; 10 real classes of the 100 label space);
- SVHN: ``train_32x32.mat`` / ``test_32x32.mat`` (scipy.io, HWCN layout,
  label 10 for digit 0 as in the real SVHN).

The split is stratified and seeded (``RandomState(seed)``, every class in
both splits); the upscale is ``scipy.ndimage.zoom``'s bilinear. Needs
numpy and scipy, as the card's machine has them.

    python -m ps_pytorch_tpu_torch.tools.make_real_digits [--root DIR] [--test-fraction F]
"""

from __future__ import annotations

import argparse
import gzip
import os
import pickle
import struct

import numpy as np

DIGITS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
                      "digits.csv.gz")


def load_digits(path: str = DIGITS) -> tuple:
    """(images [1797, 8, 8] f64 in 0..16, labels [1797] int): the csv's
    64 pixel columns row by row, then the label (``load_digits``'s
    reading of the same file)."""
    with gzip.open(path, "rt") as f:
        data = np.loadtxt(f, delimiter=",")
    return data[:, :-1].reshape(-1, 8, 8), data[:, -1].astype(int)


def load_digits_split(test_fraction: float, seed: int = 0):
    images, target = load_digits()
    # pixel values are 0..16; rescale to the 0..255 uint8 range the
    # readers (and the reference's datasets) use
    images = np.round(images * (255.0 / 16.0)).astype(np.uint8)  # [N, 8, 8]
    labels = target.astype(np.int32)

    # deterministic stratified split so every class appears in both splits
    rng = np.random.RandomState(seed)
    train_idx, test_idx = [], []
    for c in range(10):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        n_test = max(1, int(round(len(idx) * test_fraction)))
        test_idx.extend(idx[:n_test])
        train_idx.extend(idx[n_test:])
    train_idx = np.sort(np.asarray(train_idx))
    test_idx = np.sort(np.asarray(test_idx))
    return (images[train_idx], labels[train_idx],
            images[test_idx], labels[test_idx])


def upscale(images: np.ndarray, size: int) -> np.ndarray:
    """[N, 8, 8] uint8 -> [N, size, size] uint8, bilinear."""
    from scipy.ndimage import zoom

    factor = size / images.shape[1]
    out = zoom(images.astype(np.float32), (1, factor, factor), order=1)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def write_idx(path: str, arr: np.ndarray) -> None:
    """idx (MNIST) format: >I magic (0x08 = ubyte, ndim in the low byte),
    then big-endian dims, then the raw bytes."""
    arr = np.ascontiguousarray(arr, np.uint8)
    with open(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | arr.ndim))
        f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        f.write(arr.tobytes())


def write_mnist_style(root: str, tr_x, tr_y, te_x, te_y) -> str:
    d = os.path.join(root, "real_digits_mnist")
    os.makedirs(d, exist_ok=True)
    write_idx(os.path.join(d, "train-images-idx3-ubyte"), upscale(tr_x, 28))
    write_idx(os.path.join(d, "train-labels-idx1-ubyte"), tr_y.astype(np.uint8))
    write_idx(os.path.join(d, "t10k-images-idx3-ubyte"), upscale(te_x, 28))
    write_idx(os.path.join(d, "t10k-labels-idx1-ubyte"), te_y.astype(np.uint8))
    return d


def write_cifar_style(root: str, tr_x, tr_y, te_x, te_y) -> str:
    """CIFAR-10 batch pickles: a dict with b"data" [N, 3072] (CHW flat,
    uint8) and b"labels"."""
    d = os.path.join(root, "real_digits_cifar", "cifar-10-batches-py")
    os.makedirs(d, exist_ok=True)

    def to_batch(x8, y):
        x = upscale(x8, 32)  # [N, 32, 32]
        x = np.repeat(x[:, None], 3, axis=1)  # grayscale -> RGB CHW
        return {b"data": x.reshape(len(x), -1), b"labels": y.tolist()}

    splits = np.array_split(np.arange(len(tr_x)), 5)
    for i, idx in enumerate(splits, start=1):
        with open(os.path.join(d, f"data_batch_{i}"), "wb") as f:
            pickle.dump(to_batch(tr_x[idx], tr_y[idx]), f)
    with open(os.path.join(d, "test_batch"), "wb") as f:
        pickle.dump(to_batch(te_x, te_y), f)
    return d


def write_cifar100_style(root: str, tr_x, tr_y, te_x, te_y) -> str:
    """cifar-100-python/{train,test} pickles with b"fine_labels"."""
    d = os.path.join(root, "real_digits_cifar100", "cifar-100-python")
    os.makedirs(d, exist_ok=True)

    def to_split(x8, y):
        x = np.repeat(upscale(x8, 32)[:, None], 3, axis=1)  # CHW RGB
        return {b"data": x.reshape(len(x), -1), b"fine_labels": y.tolist()}

    with open(os.path.join(d, "train"), "wb") as f:
        pickle.dump(to_split(tr_x, tr_y), f)
    with open(os.path.join(d, "test"), "wb") as f:
        pickle.dump(to_split(te_x, te_y), f)
    return d


def write_svhn_style(root: str, tr_x, tr_y, te_x, te_y) -> str:
    """train_32x32.mat / test_32x32.mat: X is HWCN uint8, y 1..10 with
    10 == digit 0 (the real SVHN label quirk the reader undoes)."""
    import scipy.io

    d = os.path.join(root, "real_digits_svhn")
    os.makedirs(d, exist_ok=True)

    def to_mat(path, x8, y):
        x = np.repeat(upscale(x8, 32)[..., None], 3, axis=3)  # NHWC
        y_svhn = np.where(y == 0, 10, y).astype(np.uint8).reshape(-1, 1)
        scipy.io.savemat(path, {"X": x.transpose(1, 2, 3, 0), "y": y_svhn})

    to_mat(os.path.join(d, "train_32x32.mat"), tr_x, tr_y)
    to_mat(os.path.join(d, "test_32x32.mat"), te_x, te_y)
    return d


def write_all(root: str, test_fraction: float = 0.2) -> tuple:
    """Every stand-in under ``root`` -> (mnist, cifar, cifar100, svhn) dirs
    and the split sizes."""
    tr_x, tr_y, te_x, te_y = load_digits_split(test_fraction)
    dirs = tuple(w(root, tr_x, tr_y, te_x, te_y) for w in (
        write_mnist_style, write_cifar_style, write_cifar100_style, write_svhn_style))
    return dirs, (len(tr_x), len(te_x))


def main(argv=None):
    p = argparse.ArgumentParser("ps_pytorch_tpu_torch.tools.make_real_digits",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default="./data")
    p.add_argument("--test-fraction", type=float, default=0.2)
    args = p.parse_args(argv)
    (m, c, c100, s), (n_train, n_test) = write_all(args.root, args.test_fraction)
    print(f"train={n_train} test={n_test}")
    print(f"mnist-style idx   -> {m}  (use PS_TPU_DATA_DIR={m})")
    print(f"cifar-style pkl   -> {c}  (use PS_TPU_DATA_DIR={os.path.dirname(c)})")
    print(f"cifar100-style    -> {c100}  (use PS_TPU_DATA_DIR={os.path.dirname(c100)})")
    print(f"svhn-style mat    -> {s}  (use PS_TPU_DATA_DIR={s})")
    return m, c, c100, s


if __name__ == "__main__":
    main()
