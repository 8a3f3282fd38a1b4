"""Device ms a step in cuBLAS's matrix products (the projections, the
MLP and the tied head, forward, recompute and backward), from the
capture."""

from portbench.harness.readers import device_ms_per_step

GEMM = ("nvjet", "gemm", "cutlass", "xmma", "cublas")
NOT_GEMM = ("flash_",)


def read(facts):
    return device_ms_per_step(facts["trace"], GEMM, NOT_GEMM)
