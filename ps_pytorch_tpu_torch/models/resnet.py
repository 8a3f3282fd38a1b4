"""CIFAR-style ResNet family (the port of models/resnet.py).

3x3 stem (no 7x7, no stem pool), 4 stages at 64/128/256/512 planes, a
4x4 average-pool head and a Linear classifier; BasicBlock (18/34) and
Bottleneck (50/101/152). The params tree keeps flax's names: ``Conv_0``,
``BatchNorm_0``, ``BasicBlock_<i>`` / ``Bottleneck_<i>`` (each with its
own ``Conv_j`` / ``BatchNorm_j``, the shortcut last), ``Dense_0``.
ResNet18 has 62 parameter leaves.

Convolutions and their gradients are cuDNN calls (``F.conv2d`` and
autograd), as the JAX package left them to XLA: no Pallas kernel runs on
this path. ``dtype`` is the compute dtype (bf16 over f32 params, logits
in f32). ``remat`` recomputes each residual block's activations in the
backward pass (``torch.utils.checkpoint``, non-reentrant), as flax's
``nn.remat`` does; the tree keeps the same keys. The recompute writes
no BatchNorm stats: the block's first run records them, so they are the
forward's bits.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import (
    batch_norm,
    conv,
    dense,
    flatten_nhwc,
    he_normal,
    init_batch_norm,
    lecun_normal,
    nhwc_to_nchw,
)


@dataclasses.dataclass(frozen=True)
class BasicBlock:
    """3x3 + 3x3 residual block (resnet.py:28-53). expansion = 1."""

    planes: int
    stride: int = 1
    expansion: int = 1

    def convs(self, in_planes: int):
        """(name, HWIO shape, stride, padding) of each conv, in flax's
        creation order; the shortcut comes last when the shape changes."""
        p = self.planes
        out = [("0", (3, 3, in_planes, p), self.stride, 1),
               ("1", (3, 3, p, p), 1, 1)]
        if self.has_shortcut(in_planes):
            out.append(("2", (1, 1, in_planes, self.expansion * p), self.stride, 0))
        return out

    def has_shortcut(self, in_planes: int) -> bool:
        return self.stride != 1 or in_planes != self.expansion * self.planes

    def __call__(self, x, p, stats, train, new_stats):
        def cbn(i, inp, stride, padding):
            out = conv(inp, p[f"Conv_{i}"], stride, padding)
            return batch_norm(out, p[f"BatchNorm_{i}"], stats.get(f"BatchNorm_{i}"),
                              train, new_stats, f"BatchNorm_{i}")

        out = F.relu(cbn(0, x, self.stride, 1))
        out = cbn(1, out, 1, 1)
        shortcut = cbn(2, x, self.stride, 0) if "Conv_2" in p else x
        return F.relu(out + shortcut)


@dataclasses.dataclass(frozen=True)
class Bottleneck:
    """1x1 -> 3x3 -> 1x1 residual block (resnet.py:56-81). expansion = 4."""

    planes: int
    stride: int = 1
    expansion: int = 4

    def convs(self, in_planes: int):
        p, e = self.planes, self.expansion
        out = [("0", (1, 1, in_planes, p), 1, 0),
               ("1", (3, 3, p, p), self.stride, 1),
               ("2", (1, 1, p, e * p), 1, 0)]
        if self.has_shortcut(in_planes):
            out.append(("3", (1, 1, in_planes, e * p), self.stride, 0))
        return out

    def has_shortcut(self, in_planes: int) -> bool:
        return self.stride != 1 or in_planes != self.expansion * self.planes

    def __call__(self, x, p, stats, train, new_stats):
        def cbn(i, inp, stride, padding):
            out = conv(inp, p[f"Conv_{i}"], stride, padding)
            return batch_norm(out, p[f"BatchNorm_{i}"], stats.get(f"BatchNorm_{i}"),
                              train, new_stats, f"BatchNorm_{i}")

        out = F.relu(cbn(0, x, 1, 0))
        out = F.relu(cbn(1, out, self.stride, 1))
        out = cbn(2, out, 1, 0)
        shortcut = cbn(3, x, self.stride, 0) if "Conv_3" in p else x
        return F.relu(out + shortcut)


@dataclasses.dataclass(frozen=True)
class ResNet:
    """CIFAR ResNet trunk (resnet.py:84-129)."""

    block: type
    num_blocks: Sequence[int]
    num_classes: int = 10
    dtype: torch.dtype = torch.float32
    bn_axis_name: Optional[str] = None
    remat: bool = False

    def _blocks(self):
        """(name, block, in_planes) of every residual block in order."""
        out, in_planes, idx = [], 64, 0
        for stage, (planes, stride) in enumerate(zip((64, 128, 256, 512), (1, 2, 2, 2))):
            for i in range(self.num_blocks[stage]):
                blk = self.block(planes=planes, stride=stride if i == 0 else 1)
                out.append((f"{self.block.__name__}_{idx}", blk, in_planes))
                in_planes = blk.expansion * planes
                idx += 1
        return out, in_planes

    def init(self, generator: torch.Generator) -> Tuple[Dict, Dict]:
        g = generator
        params, stats = {}, {}
        params["Conv_0"] = {"kernel": he_normal((3, 3, 3, 64), g)}
        params["BatchNorm_0"], stats["BatchNorm_0"] = init_batch_norm(64)
        blocks, feat = self._blocks()
        for name, blk, in_planes in blocks:
            bp, bst = {}, {}
            for i, shape, _, _ in blk.convs(in_planes):
                bp[f"Conv_{i}"] = {"kernel": he_normal(shape, g)}
                bp[f"BatchNorm_{i}"], bst[f"BatchNorm_{i}"] = init_batch_norm(shape[-1])
            params[name], stats[name] = bp, bst
        params["Dense_0"] = {"kernel": lecun_normal((feat, self.num_classes), g),
                             "bias": torch.zeros(self.num_classes)}
        return params, stats

    def apply(self, params: Dict, batch_stats: Dict, x: torch.Tensor,
              train: bool = False, dropout=None) -> Tuple[torch.Tensor, Dict]:
        """NHWC ``x`` -> ``(f32 logits, batch stats)`` (no Dropout:
        ``dropout`` changes nothing)."""
        new_stats: Dict = {}
        x = nhwc_to_nchw(x.to(self.dtype))
        x = conv(x, params["Conv_0"], 1, 1)
        x = F.relu(batch_norm(x, params["BatchNorm_0"], batch_stats["BatchNorm_0"],
                              train, new_stats, "BatchNorm_0"))
        blocks, _ = self._blocks()
        remat = self.remat and torch.is_grad_enabled()
        for name, blk, _ in blocks:
            sub: Dict = {}
            if remat:
                x = _remat_block(blk, x, params[name], batch_stats[name], train, sub)
            else:
                x = blk(x, params[name], batch_stats[name], train, sub)
            if train:
                new_stats[name] = sub
        x = F.avg_pool2d(x, 4, 4)
        logits = dense(flatten_nhwc(x), params["Dense_0"]).float()
        return logits, (new_stats if train else batch_stats)


def _remat_block(blk, x, p, stats, train, new_stats):
    """``blk`` under ``torch.utils.checkpoint``: its activations are
    recomputed in the backward pass. Only the first run writes its
    BatchNorm stats into ``new_stats``: the recompute (whose convolutions
    may pick other algorithms) leaves them alone."""
    ran = []

    def run(inp):
        sub: Dict = {}
        out = blk(inp, p, stats, train, sub)
        if not ran:
            new_stats.update(sub)
            ran.append(True)
        return out

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


def ResNet18(num_classes: int = 10, **kw) -> ResNet:
    return ResNet(block=BasicBlock, num_blocks=(2, 2, 2, 2), num_classes=num_classes, **kw)


def ResNet34(num_classes: int = 10, **kw) -> ResNet:
    return ResNet(block=BasicBlock, num_blocks=(3, 4, 6, 3), num_classes=num_classes, **kw)


def ResNet50(num_classes: int = 10, **kw) -> ResNet:
    return ResNet(block=Bottleneck, num_blocks=(3, 4, 6, 3), num_classes=num_classes, **kw)


def ResNet101(num_classes: int = 10, **kw) -> ResNet:
    return ResNet(block=Bottleneck, num_blocks=(3, 4, 23, 3), num_classes=num_classes, **kw)


def ResNet152(num_classes: int = 10, **kw) -> ResNet:
    return ResNet(block=Bottleneck, num_blocks=(3, 8, 36, 3), num_classes=num_classes, **kw)
