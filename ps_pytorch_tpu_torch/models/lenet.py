"""LeNet (the port of models/lenet.py).

conv(1->20, 5x5, valid) -> maxpool 2x2 -> relu -> conv(20->50, 5x5,
valid) -> maxpool 2x2 -> relu -> flatten(800) -> fc(500) ->
fc(num_classes), for 28x28x1 inputs. The flatten reads the NHWC order
flax flattens in (lenet.py:37), so ``Dense_0``'s 800 inputs line up with
the JAX kernel's rows.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .common import conv, dense, flatten_nhwc, lecun_normal, nhwc_to_nchw


@dataclasses.dataclass(frozen=True)
class LeNet:
    num_classes: int = 10
    dtype: torch.dtype = torch.float32

    def init(self, generator: torch.Generator) -> Tuple[Dict, Dict]:
        """(params, batch_stats); LeNet has no BatchNorm, so batch_stats
        is empty."""
        g = generator

        def layer(shape):
            return {"kernel": lecun_normal(shape, g), "bias": torch.zeros(shape[-1])}

        params = {
            "Conv_0": layer((5, 5, 1, 20)),
            "Conv_1": layer((5, 5, 20, 50)),
            "Dense_0": layer((800, 500)),
            "Dense_1": layer((500, self.num_classes)),
        }
        return params, {}

    def apply(self, params: Dict, batch_stats: Dict, x: torch.Tensor,
              train: bool = False, dropout=None) -> Tuple[torch.Tensor, Dict]:
        """NHWC ``x`` -> f32 logits, computed in ``dtype`` (no BatchNorm,
        no Dropout: ``train`` and ``dropout`` change nothing)."""
        x = nhwc_to_nchw(x.to(self.dtype))
        x = F.relu(F.max_pool2d(conv(x, params["Conv_0"]), 2, 2))
        x = F.relu(F.max_pool2d(conv(x, params["Conv_1"]), 2, 2))
        x = dense(flatten_nhwc(x), params["Dense_0"])
        return dense(x, params["Dense_1"]).float(), batch_stats
