"""Port parity: the data path of the training slice
(ps_pytorch_tpu_torch.data, utils.logging) against the JAX package's
data/ and utils/logging.

- ``make_synthetic`` and the ``BatchIterator`` index streams are the same
  numpy code: bit-identical.
- ``random_crop_flip`` fed the draws JAX makes (``jax.random.split`` /
  ``randint`` / ``bernoulli`` as augment.py:31-41 draws them) moves the
  same pixels: bit-identical.
- ``normalize`` agrees within one f32 ulp of the result's magnitude: XLA
  fuses ``x * (1/255) - mean`` into one FMA before the multiply by
  ``1/std``, the port rounds after each op.
- the reference-format log lines are character-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_pytorch_tpu.data import augment as jaug
from ps_pytorch_tpu.data import datasets as jds
from ps_pytorch_tpu.data import loader as jld
from ps_pytorch_tpu.utils import logging as jlog
from ps_pytorch_tpu_torch.data import (
    BatchIterator,
    CropFlipDraws,
    draw_crop_flip,
    make_preprocessor,
    make_synthetic,
    normalize,
    prepare_data,
    random_crop_flip,
    shard_for_worker,
)
from ps_pytorch_tpu_torch.data import datasets as tds
from ps_pytorch_tpu_torch.utils import format_eval_line, format_iter_line, parse_iter_line


@pytest.mark.parametrize("name", ["MNIST", "Cifar10", "SVHN"])
def test_torch_make_synthetic_is_bit_identical(name):
    j = jds.make_synthetic(name, train_size=64, test_size=16, seed=3)
    t = make_synthetic(name, train_size=64, test_size=16, seed=3)
    for field in ("train_images", "train_labels", "test_images", "test_labels"):
        a, b = getattr(t, field), getattr(j, field)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert t.num_classes == j.num_classes and t.synthetic


def test_torch_dataset_tables_match():
    for name in jds.NORM_STATS:
        for a, b in zip(tds.NORM_STATS[name], jds.NORM_STATS[name]):
            np.testing.assert_array_equal(a, b)
    assert tds.AUGMENT == jds.AUGMENT and tds.PAD_MODE == jds.PAD_MODE
    assert tds.NUM_CLASSES == jds.NUM_CLASSES and tds.IMAGE_SHAPES == jds.IMAGE_SHAPES


@pytest.mark.parametrize("mode", ["reshuffle", "disjoint"])
def test_torch_batch_iterator_streams_are_bit_identical(mode):
    d = make_synthetic("MNIST", train_size=100, test_size=8, seed=1)
    for w in range(3):
        ti, tl, ts = shard_for_worker(d.train_images, d.train_labels, w, 3, mode, seed=7)
        ji, jl, js = jld.shard_for_worker(d.train_images, d.train_labels, w, 3, mode, seed=7)
        assert ts == js
        t_it, j_it = BatchIterator(ti, tl, 8, seed=ts), jld.BatchIterator(ji, jl, 8, seed=js)
        assert len(t_it) == len(j_it)
        for _ in range(2):  # two epochs: the RandomState stream carries over
            for tb, jb in zip(t_it.epoch(), j_it.epoch()):
                np.testing.assert_array_equal(tb["image"], jb["image"])
                np.testing.assert_array_equal(tb["label"], jb["label"])


def test_torch_batch_iterator_replicates_tiny_sets():
    d = make_synthetic("MNIST", train_size=3, test_size=3)
    it = BatchIterator(d.train_images, d.train_labels, 8, shuffle=False)
    jit_ = jld.BatchIterator(d.train_images, d.train_labels, 8, shuffle=False)
    tb, jb = next(iter(it)), next(iter(jit_))
    np.testing.assert_array_equal(tb["image"], jb["image"])


@pytest.mark.parametrize("pad_mode,name", [("reflect", "Cifar10"), ("constant", "SVHN")])
def test_torch_random_crop_flip_matches_jax_on_jax_draws(pad_mode, name):
    images = make_synthetic(name, train_size=16, test_size=2).train_images
    key = jax.random.key(4)
    want = np.asarray(jaug.random_crop_flip(key, jnp.asarray(images), pad_mode=pad_mode))
    # JAX's own draws, exactly as augment.py:31-41 makes them
    kc, kf = jax.random.split(key)
    offs = np.asarray(jax.random.randint(kc, (16, 2), 0, 9))
    flips = np.asarray(jax.random.bernoulli(kf, 0.5, (16,)))
    draws = CropFlipDraws(torch.from_numpy(offs.astype(np.int64)), torch.from_numpy(np.array(flips)))
    got = random_crop_flip(torch.from_numpy(images), draws, pad_mode=pad_mode)
    assert got.shape == want.shape and flips.any() and not flips.all()
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


@pytest.mark.parametrize("name", ["MNIST", "Cifar10"])
def test_torch_normalize_matches_jitted_jax(name):
    images = make_synthetic(name, train_size=32, test_size=2).train_images
    mean, std = tds.NORM_STATS[name]

    def jnorm(a):
        return jaug.normalize(a, mean, std)

    want = np.asarray(jax.jit(jnorm)(jnp.asarray(images)))
    got = normalize(torch.from_numpy(images), mean, std).numpy()
    ulp = np.finfo(np.float32).eps * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=ulp)


def test_torch_preprocessor_policy():
    train, test = make_preprocessor("Cifar10", True), make_preprocessor("Cifar10", False)
    assert train.augment and not test.augment and train.pad_mode == "reflect"
    assert not make_preprocessor("MNIST", True).augment
    assert make_preprocessor("SVHN", True).pad_mode == "constant"
    g = torch.Generator().manual_seed(0)
    d = draw_crop_flip(g, 64)
    assert d.offsets.min() >= 0 and d.offsets.max() <= 8 and d.flips.dtype == torch.bool
    images = torch.from_numpy(make_synthetic("Cifar10", 4, 2).train_images)
    with pytest.raises(ValueError):
        train(images)  # an augmenting preprocessor needs its draws
    assert train(images, train.draw(g, 4)).shape == (4, 32, 32, 3)


def test_torch_prepare_data_serves_synthetic_and_refuses_files():
    """No files under the root: the synthetic set, and with
    ``allow_synthetic=False`` JAX's FileNotFoundError (the readers came
    with their port: tests/test_torch_datasets.py)."""
    d = prepare_data("MNIST", root="/nonexistent", synthetic_train_size=32)
    assert d.synthetic and d.train_images.shape == (32, 28, 28, 1)
    with pytest.raises(FileNotFoundError):
        prepare_data("MNIST", root="/nonexistent", allow_synthetic=False)


def test_torch_log_lines_match_the_reference_format():
    kw = dict(rank="workers", step=12, epoch=2, seen=1024, total=32768, loss=1.23456,
              time_cost=0.5, fetch=0.01, forward=0.4)
    line = format_iter_line(**kw)
    assert line == jlog.format_iter_line(**kw)
    assert jlog.parse_iter_line(line) == parse_iter_line(line)
    assert parse_iter_line(line)["step"] == 12.0
    assert format_eval_line(5, 0.5, 91.25, 99.5) == jlog.format_eval_line(5, 0.5, 91.25, 99.5)
