"""K4's share of its roofline, percent (csrc/flash_fwd.cu; at dp 1 x
sp 1 the step runs its partial form, one launch a layer and one more a
layer under remat): per launch the larger of the operations at the
dtype's peak (bf16; f32 as 3xTF32) and the bytes at the memory's rate,
from (B, H, T, D, causal, dtype), x the launches, over K4's device
time."""

from portbench.harness import costs
from portbench.harness.readers import peak, roofline

K4 = ("flash_fwd_",)


def read(facts):
    p = peak(facts)
    if p is None:
        return None
    w = facts["work"]
    ops, nbytes = costs.flash_fwd_cost(w["batch"], w["heads"], w["seq"], w["head_dim"],
                                       costs.DTYPE_BYTES[w["dtype"]])
    bound = costs.bound_s(ops, nbytes, costs.flash_peak(w["dtype"], p), p)
    return roofline(facts["trace"], K4, bound)
