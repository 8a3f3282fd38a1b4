"""Port parity: the dataset pre-download CLI (ps_pytorch_tpu_torch.cli
.prepare_data) against the JAX package's cli/prepare_data.py, on the CPU
and with no network: ``download`` is monkeypatched to False in both
packages, so the status comes from the files on disk. A root that holds
CIFAR-10 (written here in its pickle layout) and lacks MNIST gives the
same status dict on both sides, for the default dataset list and for a
chosen one; SVHN and MNIST written too flip to ready.
"""

import pytest

from ps_pytorch_tpu.cli import prepare_data as jcli
from ps_pytorch_tpu_torch.cli import prepare_data as tcli
from ps_pytorch_tpu_torch.data import make_synthetic
from tests.test_torch_datasets import write_cifar10, write_mnist, write_svhn


@pytest.fixture
def offline(monkeypatch):
    calls = []

    def no_download(name, root):
        calls.append(name)
        return False

    monkeypatch.setattr(tcli, "download", no_download)
    monkeypatch.setattr(jcli, "download", lambda name, root: False)
    return calls


@pytest.mark.parametrize("which", [None, ["Cifar10", "MNIST"]], ids=["all", "chosen"])
def test_torch_prepare_data_status_matches_jax(tmp_path, offline, which):
    write_cifar10(str(tmp_path), make_synthetic("Cifar10", 40, 10, seed=2))
    argv = ["--data-root", str(tmp_path)] + (["--datasets", *which] if which else [])
    got, want = tcli.main(argv), jcli.main(argv)
    assert got == want
    assert got["Cifar10"] is True and got["MNIST"] is False
    assert list(got) == (which or list(want))
    assert offline == list(got)  # each dataset tried the downloader first


def test_torch_prepare_data_sees_each_format(tmp_path, offline):
    write_cifar10(str(tmp_path), make_synthetic("Cifar10", 40, 10, seed=2))
    write_mnist(str(tmp_path / "mnist" / "raw"), make_synthetic("MNIST", 30, 10, seed=3), True)
    write_svhn(str(tmp_path), make_synthetic("SVHN", 30, 10, seed=5))
    argv = ["--data-root", str(tmp_path)]
    got = tcli.main(argv)
    assert got == jcli.main(argv)
    assert got == {"MNIST": True, "Cifar10": True, "Cifar100": False, "SVHN": True}


def test_torch_prepare_data_download_without_torchvision_is_false(tmp_path):
    """Without torchvision the downloader reports False and touches
    nothing (no network is needed to run the CLI)."""
    try:
        import torchvision  # noqa: F401
    except ImportError:
        assert tcli.download("MNIST", str(tmp_path)) is False
        assert list(tmp_path.iterdir()) == []
    else:
        pytest.skip("torchvision is installed: its downloader would reach the network")
