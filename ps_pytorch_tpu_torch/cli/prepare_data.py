"""Dataset pre-download CLI (the port of ps_pytorch_tpu.cli.prepare_data;
the reference's data_prepare.py role: fetch MNIST / CIFAR-10 / CIFAR-100
/ SVHN once before a parallel run, so workers never race on downloads).

For each dataset it tries torchvision's downloaders when torchvision is
importable; when that fails (no torchvision, no network) it reports
whether the files are already on disk in the formats ``data.prepare_data``
reads (MNIST idx, CIFAR pickles, SVHN ``*_32x32.mat``), and where to put
them otherwise. Returns ``{name: ready}``; it needs no network to run.

    python -m ps_pytorch_tpu_torch.cli.prepare_data --data-root ./data
"""

from __future__ import annotations

import argparse
import os

from ..data import prepare_data
from ..data.datasets import DATASET_NAMES
from ..utils import get_logger

logger = get_logger()

_TORCHVISION_NAMES = {"MNIST": "MNIST", "Cifar10": "CIFAR10", "Cifar100": "CIFAR100",
                      "SVHN": "SVHN"}  # SVHN takes split= instead of train=


def download(name: str, root: str) -> bool:
    """torchvision's downloader for ``name`` into ``root``; False when
    torchvision is missing or the download fails."""
    try:
        import torchvision.datasets as tvd
    except ImportError:
        logger.info("torchvision unavailable; cannot download %s", name)
        return False
    cls = getattr(tvd, _TORCHVISION_NAMES[name])
    try:
        if name == "SVHN":
            cls(root, split="train", download=True)
            cls(root, split="test", download=True)
        else:
            cls(root, train=True, download=True)
            cls(root, train=False, download=True)
        return True
    except Exception as e:  # no network: URLError and the like
        logger.info("download of %s failed (%s: %s)", name, type(e).__name__, e)
        return False


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser("ps_pytorch_tpu_torch.cli.prepare_data")
    parser.add_argument("--datasets", nargs="+", default=list(DATASET_NAMES),
                        choices=DATASET_NAMES)
    parser.add_argument("--data-root", type=str,
                        default=os.environ.get("PS_TPU_DATA_DIR", "./data"))
    args = parser.parse_args(argv)

    status = {}
    for name in args.datasets:
        ok = download(name, args.data_root)
        if not ok:
            try:
                ds = prepare_data(name, root=args.data_root, allow_synthetic=False)
                logger.info("%s already present (%d train samples)", name,
                            len(ds.train_labels))
                ok = True
            except FileNotFoundError:
                logger.info(
                    "%s missing. Place files under %s (MNIST: idx files; CIFAR: python "
                    "pickle batches; SVHN: *_32x32.mat) — training falls back to "
                    "synthetic data otherwise.", name, args.data_root)
        status[name] = ok
    return status


if __name__ == "__main__":
    main()
