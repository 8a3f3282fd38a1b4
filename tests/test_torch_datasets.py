"""Port parity: the on-disk dataset readers (ps_pytorch_tpu_torch.data
.datasets) against the JAX package's ``prepare_data`` on files this test
writes in each format's real layout from ``make_synthetic``'s arrays:
MNIST idx (plain and gzip), the CIFAR-10 and CIFAR-100 python pickles,
and SVHN's scipy ``.mat`` (HWCN, label 10 for the digit 0). The arrays
must be equal, dtypes and layouts included (images uint8 NHWC, labels
int32), and the fallback to the synthetic set and the
``FileNotFoundError`` under ``allow_synthetic=False`` must behave as
JAX's.
"""

import gzip
import os
import pickle
import struct

import numpy as np
import pytest
import scipy.io

from ps_pytorch_tpu.data import prepare_data as jprepare
from ps_pytorch_tpu_torch.data import make_synthetic, prepare_data
from ps_pytorch_tpu_torch.data import datasets as td
from tests.test_torch_one_thread import _one_thread  # noqa: F401


def write_idx(path, a: np.ndarray, gz: bool) -> None:
    """The idx layout: magic 0x0000 08 ndim (ubyte), big-endian dims, bytes."""
    opener = gzip.open if gz else open
    with opener(path + (".gz" if gz else ""), "wb") as f:
        f.write(struct.pack(">I", 0x0800 | a.ndim))
        f.write(struct.pack(">" + "I" * a.ndim, *a.shape))
        f.write(np.ascontiguousarray(a, np.uint8).tobytes())


def write_mnist(root, d, gz: bool) -> None:
    os.makedirs(root, exist_ok=True)
    for stem, a in (("train-images-idx3-ubyte", d.train_images[..., 0]),
                    ("train-labels-idx1-ubyte", d.train_labels),
                    ("t10k-images-idx3-ubyte", d.test_images[..., 0]),
                    ("t10k-labels-idx1-ubyte", d.test_labels)):
        write_idx(os.path.join(root, stem), a.astype(np.uint8), gz)


def _chw_rows(x):
    return np.ascontiguousarray(x.transpose(0, 3, 1, 2).reshape(len(x), -1))


def write_cifar10(root, d, batches: int = 5) -> None:
    """``cifar-10-batches-py``: data_batch_1..5 and test_batch, each a
    pickled dict of bytes keys: ``data`` uint8 [n, 3072] (CHW rows),
    ``labels`` a list."""
    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base, exist_ok=True)
    parts = np.array_split(np.arange(len(d.train_images)), batches)
    for i, idx in enumerate(parts, 1):
        with open(os.path.join(base, f"data_batch_{i}"), "wb") as f:
            pickle.dump({b"data": _chw_rows(d.train_images[idx]),
                         b"labels": d.train_labels[idx].tolist()}, f)
    with open(os.path.join(base, "test_batch"), "wb") as f:
        pickle.dump({b"data": _chw_rows(d.test_images), b"labels": d.test_labels.tolist()}, f)


def write_cifar100(root, d) -> None:
    base = os.path.join(root, "cifar-100-python")
    os.makedirs(base, exist_ok=True)
    for name, x, y in (("train", d.train_images, d.train_labels),
                       ("test", d.test_images, d.test_labels)):
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump({b"data": _chw_rows(x), b"fine_labels": y.tolist(),
                         b"coarse_labels": (y // 5).tolist()}, f)


def write_svhn(root, d) -> None:
    os.makedirs(root, exist_ok=True)
    for name, x, y in (("train_32x32.mat", d.train_images, d.train_labels),
                       ("test_32x32.mat", d.test_images, d.test_labels)):
        y = np.where(y == 0, 10, y).astype(np.uint8).reshape(-1, 1)
        scipy.io.savemat(os.path.join(root, name), {"X": x.transpose(1, 2, 3, 0), "y": y})


def assert_same_dataset(t, j, want=None):
    assert t.name == j.name and t.synthetic == j.synthetic
    for f in ("train_images", "train_labels", "test_images", "test_labels"):
        a, b = getattr(t, f), getattr(j, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b)
        if want is not None:
            np.testing.assert_array_equal(a, getattr(want, f))
    assert t.train_labels.dtype == np.int32 and t.train_images.dtype == np.uint8


@pytest.mark.parametrize("gz", [False, True])
def test_torch_mnist_idx_matches_jax(tmp_path, gz):
    d = make_synthetic("MNIST", 50, 20, seed=4)
    write_mnist(str(tmp_path / "mnist" / "raw"), d, gz)
    t = prepare_data("MNIST", root=str(tmp_path), allow_synthetic=False)
    assert_same_dataset(t, jprepare("MNIST", root=str(tmp_path), allow_synthetic=False), d)
    assert t.train_images.shape == (50, 28, 28, 1) and not t.synthetic


def test_torch_cifar10_pickles_match_jax(tmp_path):
    d = make_synthetic("Cifar10", 60, 10, seed=5)
    write_cifar10(str(tmp_path), d)
    t = prepare_data("Cifar10", root=str(tmp_path), allow_synthetic=False)
    assert_same_dataset(t, jprepare("Cifar10", root=str(tmp_path), allow_synthetic=False), d)


def test_torch_cifar100_fine_labels_match_jax(tmp_path):
    d = make_synthetic("Cifar100", 40, 12, seed=6)
    write_cifar100(str(tmp_path), d)
    t = prepare_data("Cifar100", root=str(tmp_path), allow_synthetic=False)
    assert_same_dataset(t, jprepare("Cifar100", root=str(tmp_path), allow_synthetic=False), d)
    assert t.num_classes == 100


def test_torch_svhn_mat_matches_jax(tmp_path):
    d = make_synthetic("SVHN", 30, 9, seed=7)
    assert (d.train_labels == 0).any()  # label 10 -> 0 is exercised
    write_svhn(str(tmp_path / "svhn"), d)
    t = prepare_data("SVHN", root=str(tmp_path), allow_synthetic=False)
    assert_same_dataset(t, jprepare("SVHN", root=str(tmp_path), allow_synthetic=False), d)


def test_torch_cifar100_needs_its_directory_name_as_jax(tmp_path):
    """A ``train`` pickle outside a path holding "cifar-100" is not
    CIFAR-100 (datasets.py:145): the synthetic fallback, or the error."""
    d = make_synthetic("Cifar100", 8, 4, seed=8)
    write_cifar100(str(tmp_path), d)
    os.rename(tmp_path / "cifar-100-python", tmp_path / "other")
    t = prepare_data("Cifar100", root=str(tmp_path), synthetic_train_size=16)
    assert_same_dataset(t, jprepare("Cifar100", root=str(tmp_path), synthetic_train_size=16))
    assert t.synthetic
    for fn in (prepare_data, jprepare):
        with pytest.raises(FileNotFoundError):
            fn("Cifar100", root=str(tmp_path), allow_synthetic=False)


def test_torch_find_takes_the_first_file_in_walk_order_as_jax(tmp_path):
    """Two copies of MNIST in one tree: both packages read the same one."""
    a = make_synthetic("MNIST", 10, 5, seed=1)
    b = make_synthetic("MNIST", 10, 5, seed=2)
    write_mnist(str(tmp_path / "a"), a, gz=False)
    write_mnist(str(tmp_path / "b" / "c"), b, gz=True)
    t = prepare_data("MNIST", root=str(tmp_path))
    assert_same_dataset(t, jprepare("MNIST", root=str(tmp_path)))
    assert td._find(str(tmp_path), ("t10k-labels-idx1-ubyte",)) is not None


def test_torch_prepare_data_fallbacks_match_jax(tmp_path, monkeypatch):
    """No files: the synthetic set; with ``allow_synthetic=False``,
    FileNotFoundError; ``$PS_TPU_DATA_DIR`` is the root when none is
    given."""
    empty = str(tmp_path / "nothing")
    t = prepare_data("MNIST", root=empty, synthetic_train_size=32)
    assert_same_dataset(t, jprepare("MNIST", root=empty, synthetic_train_size=32))
    assert t.synthetic and t.train_images.shape == (32, 28, 28, 1)
    for fn in (prepare_data, jprepare):
        with pytest.raises(FileNotFoundError):
            fn("MNIST", root=empty, allow_synthetic=False)
    d = make_synthetic("Cifar10", 20, 5, seed=9)
    write_cifar10(str(tmp_path / "env"), d)
    monkeypatch.setenv("PS_TPU_DATA_DIR", str(tmp_path / "env"))
    assert td._data_root(None) == str(tmp_path / "env")
    assert_same_dataset(prepare_data("Cifar10", allow_synthetic=False),
                        jprepare("Cifar10", allow_synthetic=False), d)
    with pytest.raises(ValueError, match="unknown dataset"):
        prepare_data("ImageNet")


@pytest.mark.parametrize("name,network,writer", [
    ("MNIST", "LeNet", lambda root, d: write_mnist(os.path.join(root, "mnist"), d, gz=True)),
    ("SVHN", "ResNet18", lambda root, d: write_svhn(os.path.join(root, "svhn"), d)),
], ids=["mnist_idx_gz", "svhn_mat"])
def test_torch_cli_train_and_evaluate_read_the_files(tmp_path, name, network, writer):
    """``cli.train --data-root DIR --no-synthetic`` trains from the files
    (the log names no synthetic set) and ``cli.evaluate`` reads the same
    test split."""
    import logging

    from ps_pytorch_tpu_torch.cli import evaluate as cli_evaluate
    from ps_pytorch_tpu_torch.cli import train as cli_train

    d = make_synthetic(name, 16, 8, seed=10)
    writer(str(tmp_path), d)
    records = []

    class Grab(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    log = logging.getLogger("ps_pytorch_tpu_torch")
    h = Grab()
    log.addHandler(h)
    try:
        out = cli_train.main([
            "--device", "cpu", "--network", network, "--dataset", name, "--data-root",
            str(tmp_path), "--no-synthetic", "--num-workers", "2", "--batch-size", "2",
            "--test-batch-size", "8", "--max-steps", "2", "--log-interval", "1",
            "--compress-grad", "compress", "--eval-freq", "2", "--train-dir",
            str(tmp_path / "ck")])
    finally:
        log.removeHandler(h)
    assert len(out["history"]) == 2 and all(np.isfinite(x["loss"]) for x in out["history"])
    model_lines = [r for r in records if r.startswith("model ")]
    assert model_lines and "[synthetic]" not in model_lines[0] and name in model_lines[0]
    ev = cli_evaluate.main(["--device", "cpu", "--network", network, "--dataset", name,
                            "--data-root", str(tmp_path), "--no-synthetic", "--model-dir",
                            str(tmp_path / "ck"), "--eval-batch-size", "8", "--once"])
    assert np.isfinite(ev[2]["loss"])
