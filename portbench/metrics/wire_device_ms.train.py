"""Device ms a step of the gradient wire: K2's two kernels
(``absmax_many_kernel``, ``quantize_many_kernel``, csrc/quantize_tensor.cu)
and the integer sum over the workers (an int32 ``sum`` reduction)."""

from portbench.harness.readers import device_ms_per_step

WIRE = ("absmax_many_kernel", "quantize_many_kernel", "sum_functor<int")


def read(facts):
    return device_ms_per_step(facts["trace"], WIRE)
