"""Device ms a step in cuDNN's convolution kernels (forward, data and
weight gradients, their workspace fills and tensor conversions), from
the capture."""

from portbench.harness.readers import device_ms_per_step

# cuDNN's implicit-GEMM kernels (sm90_xmma_fprop / dgrad / wgrad ...), their
# workspace fills and tensor conversions; not its BatchNorm kernels
CONV = ("implicit_gemm", "_xmma_", "convertTensor", "init_device_workspace", "winograd")
NOT_CONV = ("batchnorm",)


def read(facts):
    return device_ms_per_step(facts["trace"], CONV, NOT_CONV)
