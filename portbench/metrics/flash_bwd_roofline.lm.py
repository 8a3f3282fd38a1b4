"""K5 + K6's share of their roofline, percent (csrc/flash_bwd.cu): per
layer the larger of the backward's operations without the kernels'
recompute (dP, dV, dQ, dK) at the dtype's peak and its bytes (q, k, v,
dO and the f32 row statistics in; dq, dk, dv out in f32) at the
memory's rate, from (B, H, T, D, causal, dtype), x the layers (K5's
launches), over K5's and K6's device time."""

from portbench.harness import costs
from portbench.harness.readers import peak, roofline

K5, K6 = "flash_dq_", "flash_dkv_"


def read(facts):
    p = peak(facts)
    if p is None:
        return None
    w, t = facts["work"], facts["trace"]
    if t.count(lambda n: K5 in n) != t.count(lambda n: K6 in n):
        return None
    ops, nbytes = costs.flash_bwd_cost(w["batch"], w["heads"], w["seq"], w["head_dim"],
                                       costs.DTYPE_BYTES[w["dtype"]])
    bound = costs.bound_s(ops, nbytes, costs.flash_peak(w["dtype"], p), p)
    return roofline(t, (K5, K6), bound, launches_from=(K5,))
