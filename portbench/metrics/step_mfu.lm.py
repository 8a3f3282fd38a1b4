"""The whole step's share of the card's peak, percent: 6 N + the causal
attention's operations a token (from the shapes, remat's recompute not
counted) x tokens a second in the window, over the peak of the cell's
compute dtype (bf16; f32 without TF32, PyTorch's default for f32 matrix
products)."""

from portbench.harness import costs
from portbench.harness.readers import peak


def read(facts):
    p = peak(facts)
    if p is None:
        return None
    w = facts["work"]
    per_token = costs.lm_train_flops_per_token(w["vocab"], w["dim"], w["depth"],
                                               w["mlp_ratio"], w["seq"])
    flops = per_token * w["tokens_per_step"] * w["steps_per_s"]
    return 100.0 * flops / costs.lm_peak(w["dtype"], p)
