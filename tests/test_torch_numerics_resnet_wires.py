"""psnumerics on the port, report parity for the pipelined and the
homomorphic ResNet18 registry specs (4 MiB buckets): the port's
``NumericsReport`` equals the jit-patched JAX analyzer's, as in
tests/test_torch_numerics_parity.py.
"""

import pytest

from tests.test_torch_numerics_parity import (  # noqa: F401
    _one_thread,
    assert_parity,
    jax_exact_jit,
    quantized_specs,
)


@pytest.mark.parametrize("name", quantized_specs(True)[2:])
def test_torch_numerics_resnet18_wire_report_equals_jaxs(name):
    assert_parity(name)
