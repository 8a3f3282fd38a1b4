"""VGG family, CIFAR variant (the port of models/vgg.py).

Configurations A/B/D/E (VGG-11/13/16/19) with or without BatchNorm: 3x3
convolutions with bias (padding 1), 2x2 max-pools at each ``"M"``, then
the CIFAR head Dropout(0.5) -> Dense 512 -> ReLU -> Dropout(0.5) -> Dense
512 -> ReLU -> Dense num_classes. The tree keeps flax's names: ``Conv_i``
(kernel, bias), ``BatchNorm_i`` (one per conv when ``batch_norm``),
``Dense_0..2``. VGG16-BN has 58 leaves and about 15.25 M params.

Dropout masks are draws: ``apply`` takes them from the caller (one
boolean keep-mask per Dropout layer, in call order; ``draw_dropout``
makes them from a ``torch.Generator``), because torch cannot reproduce
flax's ``make_rng("dropout")``. Train mode without masks raises, as
flax's Dropout without a ``dropout`` rng does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from .common import (
    batch_norm,
    conv,
    dense,
    dropout as apply_dropout,
    flatten_nhwc,
    he_normal,
    init_batch_norm,
    lecun_normal,
    nhwc_to_nchw,
)

# configuration tables (vgg.py:19-26 of the JAX package); "M" = 2x2 max-pool
CFGS = {
    "A": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "B": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "D": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"),
    "E": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512,
          "M", 512, 512, 512, 512, "M"),
}
DROPOUT_RATE = 0.5
HEAD_WIDTH = 512
INPUT_SHAPE = (32, 32, 3)  # CIFAR-10 / SVHN, NHWC


@dataclasses.dataclass(frozen=True)
class VGG:
    """VGG trunk + CIFAR classifier head (vgg.py:29-62 of the JAX package)."""

    cfg: Sequence[Union[int, str]]
    batch_norm: bool = False
    num_classes: int = 10
    dtype: torch.dtype = torch.float32
    bn_axis_name: Optional[str] = None

    def feature_dim(self) -> int:
        """Inputs of ``Dense_0``: the last conv's width times what the
        pools leave of the input's height and width."""
        h, w, c = INPUT_SHAPE
        for v in self.cfg:
            if v == "M":
                h, w = h // 2, w // 2
            else:
                c = int(v)
        return h * w * c

    def init(self, generator: torch.Generator) -> Tuple[Dict, Dict]:
        g = generator
        params, stats = {}, {}
        c_in, i = INPUT_SHAPE[-1], 0
        for v in self.cfg:
            if v == "M":
                continue
            params[f"Conv_{i}"] = {"kernel": he_normal((3, 3, c_in, int(v)), g),
                                   "bias": torch.zeros(int(v))}
            if self.batch_norm:
                params[f"BatchNorm_{i}"], stats[f"BatchNorm_{i}"] = init_batch_norm(int(v))
            c_in, i = int(v), i + 1
        widths = (self.feature_dim(), HEAD_WIDTH, HEAD_WIDTH, self.num_classes)
        for j in range(3):
            params[f"Dense_{j}"] = {"kernel": lecun_normal(widths[j:j + 2], g),
                                    "bias": torch.zeros(widths[j + 1])}
        return params, stats

    def dropout_shapes(self, batch_size: int) -> List[Tuple[int, int]]:
        """The keep-mask shape of each Dropout layer, in call order."""
        return [(batch_size, self.feature_dim()), (batch_size, HEAD_WIDTH)]

    def draw_dropout(self, batch_size: int, generator: torch.Generator) -> List[torch.Tensor]:
        """One batch's keep-masks (keep probability 1 - rate), on the
        generator's device."""
        return [torch.rand(s, generator=generator, device=generator.device) >= DROPOUT_RATE
                for s in self.dropout_shapes(batch_size)]

    def apply(self, params: Dict, batch_stats: Dict, x: torch.Tensor,
              train: bool = False, dropout=None) -> Tuple[torch.Tensor, Dict]:
        """NHWC ``x`` -> ``(f32 logits, batch stats)``; in train mode
        ``dropout`` holds the two keep-masks (rows: the batch's)."""
        if train and dropout is None:
            raise ValueError("VGG in train mode needs its Dropout keep-masks "
                             "(draw_dropout); flax needs a 'dropout' rng there too")
        new_stats: Dict = {}
        x = nhwc_to_nchw(x.to(self.dtype))
        i = 0
        for v in self.cfg:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = conv(x, params[f"Conv_{i}"], 1, 1)
            if self.batch_norm:
                name = f"BatchNorm_{i}"
                x = batch_norm(x, params[name], batch_stats[name], train, new_stats, name)
            x = F.relu(x)
            i += 1
        x = flatten_nhwc(x)
        for j in range(2):
            if train:
                x = apply_dropout(x, dropout[j].to(x.device), DROPOUT_RATE)
            x = F.relu(dense(x, params[f"Dense_{j}"]))
        logits = dense(x, params["Dense_2"]).float()
        return logits, (new_stats if train else batch_stats)


def _vgg(cfg_key: str, batch_norm: bool, num_classes: int, **kw) -> VGG:
    return VGG(cfg=CFGS[cfg_key], batch_norm=batch_norm, num_classes=num_classes, **kw)


def vgg11(num_classes: int = 10, **kw) -> VGG:
    return _vgg("A", False, num_classes, **kw)


def vgg11_bn(num_classes: int = 10, **kw) -> VGG:
    return _vgg("A", True, num_classes, **kw)


def vgg13(num_classes: int = 10, **kw) -> VGG:
    return _vgg("B", False, num_classes, **kw)


def vgg13_bn(num_classes: int = 10, **kw) -> VGG:
    return _vgg("B", True, num_classes, **kw)


def vgg16(num_classes: int = 10, **kw) -> VGG:
    return _vgg("D", False, num_classes, **kw)


def vgg16_bn(num_classes: int = 10, **kw) -> VGG:
    return _vgg("D", True, num_classes, **kw)


def vgg19(num_classes: int = 10, **kw) -> VGG:
    return _vgg("E", False, num_classes, **kw)


def vgg19_bn(num_classes: int = 10, **kw) -> VGG:
    return _vgg("E", True, num_classes, **kw)
