"""psnumerics on the port, report parity: for every quantized registry
spec, the port's ``NumericsReport`` (check/numerics.py over the recorded
tape, on the CPU) equals the JAX analyzer's over the traced jaxpr, row
for row as multisets:

- sites: dtype, peak, pre_peak, primary, feeds_params, and how many
  scale roots each carries;
- accums: kind, dtype, axes, multiplier, peak_out, capacity, lattice,
  feeds_params;
- dequants: payload sites, feeds_params, scale roots, scale_literal;
- narrows: src, dst, downstream_of_reduce, feeds_params;
- residual coverage: sites covered, feeds_carry, feeds_params;
- the axis sizes;

up to the deviations ROADMAP.md queue 3 names, each pinned here
(``_DEVIATIONS``). Shapes and offsets are not compared: a plain-PyTorch
site of a worker-stacked operand keeps the worker dimension.

The JAX oracle: jax 0.9 names a nested ``jax.jit``'s primitive ``jit``
(0.4 named it ``pjit``), which ``ps_pytorch_tpu.check.numerics``'s
``_EXACT_CALLS`` does not list, so unpatched the JAX analyzer treats every
jitted helper as opaque and reports no peaks. The fixture ``jax_exact_jit``
adds ``"jit"`` to that set through pytest's ``monkeypatch`` for each test
and restores it after; the file on disk does not change.

The ResNet18 specs are in tests/test_torch_numerics_resnet.py.
"""

import pytest

import ps_pytorch_tpu  # noqa: F401  (installs the jax.shard_map alias)
from ps_pytorch_tpu.check import contracts as jcontracts
from ps_pytorch_tpu.check import core as jcore
from ps_pytorch_tpu.check import numerics as jnumerics
from ps_pytorch_tpu_torch.check import contracts
from ps_pytorch_tpu_torch.check.core import trace_spec
from ps_pytorch_tpu_torch.check.rules import (
    psc111_scale_provenance,
    psc112_error_feedback,
    psc113_capacity,
    psc114_downcast,
)
from tests.test_torch_one_thread import _one_thread  # noqa: F401


@pytest.fixture(autouse=True)
def jax_exact_jit(monkeypatch):
    """The JAX analyzer enters jax 0.9's ``jit`` equations exactly (a
    test-local patch of the reference, restored after each test)."""
    monkeypatch.setattr(jnumerics, "_EXACT_CALLS", jnumerics._EXACT_CALLS | {"jit"})


def numerics_findings(r):
    return (psc111_scale_provenance(r) + psc112_error_feedback(r) + psc113_capacity(r)
            + psc114_downcast(r))


def report_rows(rep) -> dict:
    """A report as the multisets the parity compares."""
    def rows(xs):
        return sorted(xs, key=repr)

    return {
        "sites": rows((s.dtype, s.peak, s.pre_peak, s.primary, s.feeds_params, len(s.roots))
                      for s in rep.sites),
        "accums": rows((a.kind, a.dtype, tuple(a.axes), a.multiplier, a.peak_out, a.capacity,
                        a.lattice, a.feeds_params) for a in rep.accums),
        "dequants": rows((len(d.payload_sites), d.feeds_params, len(d.scale_roots),
                          d.scale_literal) for d in rep.dequants),
        "narrows": rows((n.src, n.dst, n.downstream_of_reduce, n.feeds_params)
                        for n in rep.narrows),
        "residuals": rows((len(r.covered_sites), r.feeds_carry, r.feeds_params)
                          for r in rep.residuals),
        "axis_sizes": dict(rep.axis_sizes),
    }


def _ef_mirror(rep, rows):
    """``ef_mirror_quantizes_once``: JAX's error-feedback mirror
    (``local_quantized_contribution``) quantizes every bucket a second
    time, a primary site that feeds no parameter; the port's residual
    round-trips the wire's own quantization. Dropping the mirror sites
    (and their half of each residual's coverage) leaves the port's
    report."""
    mirror = [s for s in rep.sites if s.primary and not s.feeds_params]
    assert mirror and len(mirror) == len([s for s in rep.sites if s.primary
                                          and s.feeds_params])
    out = dict(rows)
    out["sites"] = sorted((r for r in rows["sites"] if not (r[3] and not r[4])), key=repr)
    mirror_ids = {s.sid for s in mirror}
    out["residuals"] = sorted(((len(r.covered_sites - mirror_ids), r.feeds_carry,
                                r.feeds_params) for r in rep.residuals), key=repr)
    return out


def _fused_softmax(rep, rows):
    """``fused_softmax_residuals``: JAX's softmax subtracts the row max
    in the jaxpr, a residual-shaped sub over dequantized keys that covers
    no site; the port's softmax is one aten op."""
    assert rep.residuals and all(not r.covered_sites for r in rep.residuals)
    return dict(rows, residuals=[])


_DEVIATIONS = {
    "ps_int8_2round_replicated_bucketed64k_homomorphic_ef_precadapt": _ef_mirror,
    "serve_decode_int8kv": _fused_softmax,
}


def quantized_specs(resnet: bool):
    return [s.name for s in contracts.get_contracts()
            if s.numerics is not None and s.numerics.quantized
            and ("resnet18" in s.name) == resnet]


def assert_parity(name: str) -> None:
    spec = next(s for s in contracts.get_contracts() if s.name == name)
    jspec = next(s for s in jcontracts.get_contracts() if s.name == name)
    mine = trace_spec(spec, device="cpu")
    theirs = jcore.trace_spec(jspec)
    assert numerics_findings(mine) == []
    assert numerics_findings(theirs) == []
    want = report_rows(theirs.numerics)
    if name in _DEVIATIONS:
        assert want != report_rows(mine.numerics), f"{name}: a stale deviation"
        want = _DEVIATIONS[name](theirs.numerics, want)
    got = report_rows(mine.numerics)
    for key in want:
        assert got[key] == want[key], (name, key)
    # the quantized wire is never a vacuous pass: sites, and integer sums
    assert got["sites"]
    if spec.numerics.accum_dtype:
        assert any(a[6] and a[1].startswith("int") for a in got["accums"])


def test_torch_numerics_quantized_specs_are_the_registry_s():
    names = quantized_specs(False) + quantized_specs(True)
    assert len(names) == 26  # every int8 wire, the homomorphic ones, the int8 KV pool
    assert set(_DEVIATIONS) <= set(names)


@pytest.mark.parametrize("name", quantized_specs(False))
def test_torch_numerics_report_equals_jaxs(name):
    assert_parity(name)
