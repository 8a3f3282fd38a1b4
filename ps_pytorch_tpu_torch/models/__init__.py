"""Models of the port: the CNN zoo of the PS training path (LeNet, the
ResNet family, VGG11-19 with and without BatchNorm) and the dense
transformer LM of the serving path.

``build_model`` / ``init_model`` / ``apply_model`` keep the JAX factory's
contract (models/__init__.py): a model is a small frozen description,
its params and BatchNorm stats are trees of tensors with the flax names
and layouts, and ``apply_model`` returns ``(logits, new_batch_stats)``.
``dtype`` is the compute dtype (f32 or bf16 over f32 params), ``remat``
recomputes the ResNets' blocks in the backward pass, and
``bn_axis_name`` marks a synced-BatchNorm model, which the PS step runs
layer-synchronously over its workers (``parallel/ps.py``).
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
from .vgg import VGG, vgg11, vgg11_bn, vgg13, vgg13_bn, vgg16, vgg16_bn, vgg19, vgg19_bn

# names as the reference CLI spells them (util.py:10-19), and the depths it
# defines but never wires
MODEL_REGISTRY = {
    "LeNet": LeNet,
    "ResNet18": ResNet18,
    "ResNet34": ResNet34,
    "ResNet50": ResNet50,
    "ResNet101": ResNet101,
    "ResNet152": ResNet152,
    "VGG11": vgg11_bn,  # the reference maps "VGG11" to vgg11_bn (util.py:18-19)
    "VGG11NoBN": vgg11,
    "VGG13": vgg13_bn,
    "VGG13NoBN": vgg13,
    "VGG16": vgg16_bn,
    "VGG16NoBN": vgg16,
    "VGG19": vgg19_bn,
    "VGG19NoBN": vgg19,
}

INPUT_SHAPES = {"LeNet": (28, 28, 1)}
DEFAULT_INPUT_SHAPE = (32, 32, 3)
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_model(model_name: str, num_classes: int = 10,
                dtype: torch.dtype = torch.float32, bn_axis_name: Optional[str] = None,
                remat: bool = False):
    """Construct a model by CLI name (parity: util.py:8-19). ``remat``
    is for the ResNet family only (LeNet and VGG are too shallow for it
    to matter), as in the JAX factory."""
    if model_name not in MODEL_REGISTRY:
        raise ValueError(
            f"unknown model {model_name!r}; choose from {sorted(MODEL_REGISTRY)}"
        )
    if dtype not in COMPUTE_DTYPES.values():
        raise ValueError(f"unsupported compute dtype {dtype} (float32 or bfloat16)")
    kwargs = dict(num_classes=num_classes, dtype=dtype)
    if model_name != "LeNet":
        kwargs["bn_axis_name"] = bn_axis_name
    if model_name.startswith("ResNet"):
        kwargs["remat"] = remat
    elif remat:
        raise ValueError(f"remat is only supported for the ResNet family, not {model_name!r}")
    return MODEL_REGISTRY[model_name](**kwargs)


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


def apply_model(model, params, batch_stats, x: torch.Tensor, train: bool = False,
                dropout=None):
    """Uniform apply: NHWC ``x`` -> ``(logits, new_batch_stats)``.
    ``dropout``: the Dropout keep-masks a train-mode VGG needs (the role
    of JAX's ``dropout_rng``; ``draw_dropout`` makes them)."""
    return model.apply(params, batch_stats, x, train=train, dropout=dropout)


def draw_dropout(model, batch_size: int, generator: torch.Generator) -> list:
    """One batch's Dropout keep-masks for ``model`` (none for a model
    without Dropout), drawn from ``generator`` on its device."""
    draw = getattr(model, "draw_dropout", None)
    return draw(batch_size, generator) if draw is not None else []


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
    "VGG",
    "apply_model",
    "apply_transformer",
    "build_model",
    "cnn_from_jax",
    "draw_dropout",
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
