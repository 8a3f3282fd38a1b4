"""Data of the port: the synthetic datasets, device-side preprocessing
and the per-worker batch iterators."""

from .augment import CropFlipDraws, draw_crop_flip, make_preprocessor, normalize, random_crop_flip
from .datasets import (
    AUGMENT,
    IMAGE_SHAPES,
    NORM_STATS,
    NUM_CLASSES,
    PAD_MODE,
    Dataset,
    make_synthetic,
    prepare_data,
)
from .loader import BatchIterator, shard_for_worker

__all__ = [
    "AUGMENT", "BatchIterator", "CropFlipDraws", "Dataset", "IMAGE_SHAPES",
    "NORM_STATS", "NUM_CLASSES", "PAD_MODE", "draw_crop_flip", "make_preprocessor",
    "make_synthetic", "normalize", "prepare_data", "random_crop_flip",
    "shard_for_worker",
]
