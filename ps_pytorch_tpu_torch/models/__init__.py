"""Models of the port: the CNN zoo of the PS training path (LeNet, the
ResNet family) and the dense transformer LM of the serving path.

``build_model`` / ``init_model`` / ``apply_model`` keep the JAX factory's
contract (models/__init__.py): a model is a small frozen description,
its params and BatchNorm stats are trees of tensors with the flax names
and layouts, and ``apply_model`` returns ``(logits, new_batch_stats)``.
The VGG names are registered as in JAX and raise ``NotImplementedError``
until they are ported (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import DeviceLike, on_device, resolve_device
from .convert import cnn_from_jax, params_from_jax, params_to_numpy
from .decode import generate, init_kv_cache, prefill
from .lenet import LeNet
from .resnet import (
    BasicBlock,
    Bottleneck,
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
    ResNet152,
)
from .transformer import (
    TransformerConfig,
    TransformerLM,
    apply_transformer,
    init_transformer,
)

MODEL_REGISTRY = {
    "LeNet": LeNet,
    "ResNet18": ResNet18,
    "ResNet34": ResNet34,
    "ResNet50": ResNet50,
    "ResNet101": ResNet101,
    "ResNet152": ResNet152,
}
# registered in the JAX package (models/vgg.py), not ported yet
VGG_NAMES = ("VGG11", "VGG11NoBN", "VGG13", "VGG13NoBN", "VGG16", "VGG16NoBN",
             "VGG19", "VGG19NoBN")

INPUT_SHAPES = {"LeNet": (28, 28, 1)}
DEFAULT_INPUT_SHAPE = (32, 32, 3)


def build_model(model_name: str, num_classes: int = 10,
                dtype: torch.dtype = torch.float32, bn_axis_name=None,
                remat: bool = False):
    """Construct a model by CLI name (parity: util.py:8-19)."""
    if model_name in VGG_NAMES:
        raise NotImplementedError(
            f"{model_name}: the VGG family is not ported yet (ROADMAP.md queue 1 "
            f"item 2)"
        )
    if model_name not in MODEL_REGISTRY:
        raise ValueError(
            f"unknown model {model_name!r}; choose from "
            f"{sorted(MODEL_REGISTRY) + list(VGG_NAMES)}"
        )
    if dtype != torch.float32:
        raise NotImplementedError(
            "bf16 compute for the CNNs is not ported yet (ROADMAP.md); f32 only"
        )
    if bn_axis_name is not None:
        raise NotImplementedError(
            "synced (cross-replica) BatchNorm is not ported yet (ROADMAP.md)")
    if remat:
        raise NotImplementedError("remat is not ported yet (ROADMAP.md)")
    return MODEL_REGISTRY[model_name](num_classes=num_classes)


def input_shape_for(model_name: str) -> Tuple[int, int, int]:
    return INPUT_SHAPES.get(model_name, DEFAULT_INPUT_SHAPE)


def init_model(model, generator: Optional[torch.Generator] = None,
               device: DeviceLike = None):
    """``(params, batch_stats)`` (batch_stats is ``{}`` for BN-free
    models). ``generator`` is a CPU ``torch.Generator``: the values are
    drawn on the CPU and moved, so every device gets the same weights."""
    dev = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    params, batch_stats = model.init(g)
    return on_device(params, dev), on_device(batch_stats, dev)


def apply_model(model, params, batch_stats, x: torch.Tensor, train: bool = False):
    """Uniform apply: NHWC ``x`` -> ``(logits, new_batch_stats)``."""
    return model.apply(params, batch_stats, x, train=train)


def param_count(params) -> int:
    from ..parallel.buckets import tree_leaves

    return sum(int(p.numel()) for p in tree_leaves(params))


__all__ = [
    "BasicBlock",
    "Bottleneck",
    "LeNet",
    "MODEL_REGISTRY",
    "ResNet",
    "ResNet18",
    "TransformerConfig",
    "TransformerLM",
    "apply_model",
    "apply_transformer",
    "build_model",
    "cnn_from_jax",
    "generate",
    "init_kv_cache",
    "init_model",
    "init_transformer",
    "input_shape_for",
    "param_count",
    "params_from_jax",
    "params_to_numpy",
    "prefill",
]
