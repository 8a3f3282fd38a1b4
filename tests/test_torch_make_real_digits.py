"""Port parity: ps_pytorch_tpu_torch.tools.make_real_digits (which reads the
package's copy of the UCI digits with numpy) against the JAX repo's
tools/make_real_digits.py (which reads scikit-learn's ``load_digits``),
on the same root layout.

The idx and pickle files are byte-identical; the SVHN ``.mat`` files hold
equal arrays after ``scipy.io.loadmat`` (their headers carry a date). The
copy's sha256 is pinned, and its reading equals ``load_digits``'s.
"""

import hashlib
import importlib.util
import os

import numpy as np
import pytest
import scipy.io

from ps_pytorch_tpu_torch.tools import make_real_digits as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHA256 = "09f66e6debdee2cd2b5ae59e0d6abbb73fc2b0e0185d2e1957e9ebb51e23aa22"


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_make_real_digits_under_test", os.path.join(REPO, "tools", "make_real_digits.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def roots(tmp_path_factory, jax_tool):
    base = tmp_path_factory.mktemp("digits")
    got, want = str(base / "port"), str(base / "jax")
    port.main(["--root", got])
    jax_tool.main(["--root", want])
    return got, want


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_torch_the_digits_copy_is_pinned():
    with open(port.DIGITS, "rb") as f:
        blob = f.read()
    assert len(blob) == 57523 and hashlib.sha256(blob).hexdigest() == SHA256
    notice = os.path.join(os.path.dirname(port.DIGITS), "NOTICE")
    with open(notice) as f:
        text = f.read()
    for name in ("scikit-learn", "BSD 3-Clause", "Alpaydin", SHA256):
        assert name in text


def test_torch_the_copy_reads_as_load_digits():
    from sklearn.datasets import load_digits

    images, target = port.load_digits()
    d = load_digits()
    np.testing.assert_array_equal(images, d.images)
    np.testing.assert_array_equal(target, d.target)


def test_torch_the_writers_write_the_same_tree(roots):
    got, want = roots
    assert _files(got) == _files(want) and len(_files(got)) == 14


@pytest.mark.parametrize("path", [
    "real_digits_mnist/train-images-idx3-ubyte", "real_digits_mnist/train-labels-idx1-ubyte",
    "real_digits_mnist/t10k-images-idx3-ubyte", "real_digits_mnist/t10k-labels-idx1-ubyte",
    *[f"real_digits_cifar/cifar-10-batches-py/data_batch_{i}" for i in range(1, 6)],
    "real_digits_cifar/cifar-10-batches-py/test_batch",
    "real_digits_cifar100/cifar-100-python/train", "real_digits_cifar100/cifar-100-python/test",
])
def test_torch_idx_and_pickle_files_are_byte_identical(roots, path):
    got, want = roots
    with open(os.path.join(got, path), "rb") as a, open(os.path.join(want, path), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("name", ["train_32x32.mat", "test_32x32.mat"])
def test_torch_svhn_mat_arrays_are_equal(roots, name):
    got, want = (scipy.io.loadmat(os.path.join(r, "real_digits_svhn", name)) for r in roots)
    for key in ("X", "y"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def test_torch_the_split_is_stratified_and_seeded():
    tr_x, tr_y, te_x, te_y = port.load_digits_split(0.2)
    assert (len(tr_x), len(te_x)) == (1438, 359)
    assert set(np.unique(te_y)) == set(range(10)) == set(np.unique(tr_y))
    again = port.load_digits_split(0.2)
    np.testing.assert_array_equal(again[2], te_x)
