"""The whole step's share of the card's peak, percent: the model's
operations a step (every convolution and the linear layer, forward and
backward, from the shapes: 6 x the forward's multiply-accumulates an
image, no recompute) x steps a second in the window, over the peak of
the precision the convolutions may use (TF32's where
``torch.backends.cudnn.allow_tf32`` is set, PyTorch's default, else
f32's)."""

from portbench.harness import costs, spec
from portbench.harness.readers import peak


def read(facts):
    p = peak(facts)
    if p is None:
        return None
    cell, w = facts["cell"], facts["work"]
    macs = spec.reference_module(cell).macs_per_sample(cell.config)
    flops = 6.0 * macs * w["images_per_step"] * w["steps_per_s"]
    return 100.0 * flops / costs.conv_peak(w["tf32_convs"], p)
