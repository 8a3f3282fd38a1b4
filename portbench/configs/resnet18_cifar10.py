"""Plain PyTorch reference of the CIFAR ResNet-18 (He et al.,
arXiv:1512.03385, in the CIFAR form of the reference's src/util.py zoo).

The model's forward pass in training mode with its BatchNorm running
statistics, written from the published description with torch
operations only; it imports nothing of the program. Leaves are named by
``/``-joined paths of the port's tree (``BasicBlock_3/Conv_1/kernel``);
a convolution kernel is HWIO and the linear kernel ``[in, out]``, as the
port stores them.

``precision`` is ``"f32"`` (the caller turns TF32 off) or ``"bf16"``:
every convolution and the linear layer take bfloat16 operands and give
f32 back, BatchNorm and the rest stay f32 (the control).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F


def _blocks(config: dict) -> List[Tuple[str, int, int, int]]:
    """(name, in_planes, planes, stride) of every BasicBlock in order."""
    out, in_planes, i = [], config["widths"][0], 0
    for planes, stride, n in zip(config["widths"], config["strides"], config["blocks_per_stage"]):
        for j in range(n):
            out.append((f"BasicBlock_{i}", in_planes, planes, stride if j == 0 else 1))
            in_planes, i = planes, i + 1
    return out


def convs(config: dict) -> List[Tuple[str, int, int, int, int, int, int]]:
    """(path, in, out, kernel, stride, padding, output side) of every
    convolution."""
    side = config["image_shape"][0]
    k0 = config["stem_kernel"]
    out = [("Conv_0", config["image_shape"][2], config["widths"][0], k0, 1, k0 // 2, side)]
    for name, cin, cout, stride in _blocks(config):
        side_out = side // stride
        out.append((f"{name}/Conv_0", cin, cout, 3, stride, 1, side_out))
        out.append((f"{name}/Conv_1", cout, cout, 3, 1, 1, side_out))
        if stride != 1 or cin != cout:
            out.append((f"{name}/Conv_2", cin, cout, 1, stride, 0, side_out))
        side = side_out
    return out


def _batch_norms(config: dict) -> List[Tuple[str, int]]:
    return [(path.replace("Conv_", "BatchNorm_"), cout) for path, _, cout, *_ in convs(config)]


def leaf_specs(config: dict):
    """(path, shape, init) of every parameter: He normal (fan out)
    kernels, BatchNorm scale 1 and bias 0, a LeCun normal linear layer."""
    specs = []
    for path, cin, cout, k, *_ in convs(config):
        specs.append((f"{path}/kernel", (k, k, cin, cout), ("normal", math.sqrt(2.0 / (k * k * cout)))))
    for path, c in _batch_norms(config):
        specs.append((f"{path}/scale", (c,), ("ones",)))
        specs.append((f"{path}/bias", (c,), ("zeros",)))
    feat, classes = config["widths"][-1], config["num_classes"]
    specs.append(("Dense_0/kernel", (feat, classes), ("normal", math.sqrt(1.0 / feat))))
    specs.append(("Dense_0/bias", (classes,), ("zeros",)))
    return specs


def stat_specs(config: dict):
    """(path, shape, init) of the BatchNorm running statistics."""
    specs = []
    for path, c in _batch_norms(config):
        specs.append((f"{path}/mean", (c,), ("zeros",)))
        specs.append((f"{path}/var", (c,), ("ones",)))
    return specs


def macs_per_sample(config: dict) -> int:
    """Multiply-accumulates of one image's forward pass: every
    convolution and the linear layer."""
    total = sum(cin * cout * k * k * side * side for _, cin, cout, k, _, _, side in convs(config))
    return total + config["widths"][-1] * config["num_classes"]


def _conv(x, w, stride, padding, precision):
    w = w.permute(3, 2, 0, 1)
    if precision == "bf16":
        return F.conv2d(x.bfloat16(), w.bfloat16(), stride=stride, padding=padding).float()
    return F.conv2d(x, w, stride=stride, padding=padding)


def forward(config: dict, params: Dict[str, torch.Tensor], stats: Dict[str, torch.Tensor],
            x: torch.Tensor, precision: str = "f32"):
    """Training-mode forward of NHWC f32 images: (f32 logits, the running
    statistics this batch leaves)."""
    bn_cfg = config["batch_norm"]
    new_stats: Dict[str, torch.Tensor] = {}

    def bn(h, path):
        mean = h.mean(dim=(0, 2, 3))
        var = ((h - mean[None, :, None, None]) ** 2).mean(dim=(0, 2, 3))
        with torch.no_grad():
            m = bn_cfg["momentum"]
            new_stats[f"{path}/mean"] = m * stats[f"{path}/mean"] + (1 - m) * mean.detach()
            new_stats[f"{path}/var"] = m * stats[f"{path}/var"] + (1 - m) * var.detach()
        h = (h - mean[None, :, None, None]) / torch.sqrt(var[None, :, None, None] + bn_cfg["eps"])
        return h * params[f"{path}/scale"][None, :, None, None] + params[f"{path}/bias"][None, :, None, None]

    k0 = config["stem_kernel"]
    h = x.permute(0, 3, 1, 2)
    h = F.relu(bn(_conv(h, params["Conv_0/kernel"], 1, k0 // 2, precision), "BatchNorm_0"))
    for name, cin, cout, stride in _blocks(config):
        o = F.relu(bn(_conv(h, params[f"{name}/Conv_0/kernel"], stride, 1, precision),
                      f"{name}/BatchNorm_0"))
        o = bn(_conv(o, params[f"{name}/Conv_1/kernel"], 1, 1, precision), f"{name}/BatchNorm_1")
        if stride != 1 or cin != cout:
            h = bn(_conv(h, params[f"{name}/Conv_2/kernel"], stride, 0, precision),
                   f"{name}/BatchNorm_2")
        h = F.relu(o + h)
    side = h.shape[-1]
    h = F.avg_pool2d(h, side).flatten(1)
    w, b = params["Dense_0/kernel"], params["Dense_0/bias"]
    if precision == "bf16":
        return (h.bfloat16() @ w.bfloat16()).float() + b, new_stats
    return h @ w + b, new_stats
