"""psnumerics on the port, report parity for the ResNet18 registry
specs, per leaf (62 sites) and in 11 buckets of 4 MiB: the port's
``NumericsReport`` equals the jit-patched JAX analyzer's, as in
tests/test_torch_numerics_parity.py, which holds the LeNet and serving
specs; tests/test_torch_numerics_resnet_wires.py holds the pipelined and
homomorphic ResNet18 specs.
"""

import pytest

from tests.test_torch_numerics_parity import (  # noqa: F401
    _one_thread,
    assert_parity,
    jax_exact_jit,
    quantized_specs,
)


@pytest.mark.parametrize("name", quantized_specs(True)[:2])
def test_torch_numerics_resnet18_report_equals_jaxs(name):
    assert_parity(name)
