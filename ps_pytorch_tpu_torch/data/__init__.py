"""Data of the port: the on-disk readers and the synthetic datasets,
device-side preprocessing, the per-worker batch iterators over the
native gather, and the pinned device prefetch."""

from .augment import (
    CropFlipDraws,
    draw_crop_flip,
    make_preprocessor,
    normalize,
    preprocess_batch,
    random_crop_flip,
)
from .datasets import (
    AUGMENT,
    DATASET_NAMES,
    IMAGE_SHAPES,
    NORM_STATS,
    NUM_CLASSES,
    PAD_MODE,
    Dataset,
    make_synthetic,
    prepare_data,
)
from .loader import BatchIterator, gather_rows, prefetch_to_device, shard_for_worker

__all__ = [
    "AUGMENT", "BatchIterator", "CropFlipDraws", "DATASET_NAMES", "Dataset", "IMAGE_SHAPES",
    "NORM_STATS", "NUM_CLASSES", "PAD_MODE", "draw_crop_flip", "gather_rows",
    "make_preprocessor", "make_synthetic", "normalize", "prefetch_to_device", "prepare_data", "preprocess_batch",
    "random_crop_flip", "shard_for_worker",
]
