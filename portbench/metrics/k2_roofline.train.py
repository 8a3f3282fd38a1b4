"""K2's share of its roofline, percent: the least time the card could
take for one step's quantize (the worker-stacked f32 gradient read once,
the int8 payload and a scale a leaf written once, at the memory's rate)
over K2's device time a step (its two kernels)."""

from portbench.harness import costs
from portbench.harness.readers import peak, roofline

K2 = ("absmax_many_kernel", "quantize_many_kernel")


def read(facts):
    p = peak(facts)
    if p is None:
        return None
    w = facts["work"]
    nbytes = costs.k2_bytes(w["workers"], w["params"], w["leaves"])
    bound = nbytes / p["hbm_bytes_per_s"]
    # one call a step: the bound once a quantize_many launch
    return roofline(facts["trace"], K2, bound, launches_from=("quantize_many_kernel",))
