"""psnumerics on the port (check/numerics.py): the JAX analyzer's own
pins (tests/test_numerics.py), over recorded steps on the CPU.

- capacity (PSC113): the int16 wire proved at 258 workers and refused at
  259 from the port's recorded stacked axis; the hierarchical worst case
  is the product of both axes; ``ACCUM_CAPACITY`` agrees with the
  recorded bounds of every quantized LeNet registry spec;
- error feedback (PSC112): the real EF step proven closed on both wires,
  the dropped and the double-counted residual flagged;
- the kernels' declared events (``KERNEL_EVENTS``) equal the events of
  their plain versions recorded without the decorator's folding;
- the psnumerics fixtures of tests/check_fixtures.py as port steps, each
  tripping its rule, and the closed EF loop passing;
- ``straight_line_tape``: a lattice sum through an unrolled loop is
  proven exact, where JAX's scan carry degrades to "cannot prove".

JAX's analyzer runs with ``"jit"`` added to its ``_EXACT_CALLS`` by the
``jax_exact_jit`` fixture (tests/test_torch_numerics_parity.py).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import ps_pytorch_tpu  # noqa: F401  (installs the jax.shard_map alias)
from ps_pytorch_tpu.check.numerics import analyze_numerics as j_analyze_numerics
from ps_pytorch_tpu.ops import quantize as jquantize
from ps_pytorch_tpu_torch.check import ContractSpec, GradReduce, NumericsPolicy, Built
from ps_pytorch_tpu_torch.check.axes import RecordingWorkerAxis
from ps_pytorch_tpu_torch.check.contracts import MESH_DEVICES, _cnn_ps_built, get_contracts
from ps_pytorch_tpu_torch.check.core import trace_spec
from ps_pytorch_tpu_torch.check.numerics import analyze_numerics
from ps_pytorch_tpu_torch.check.walker import recording
from ps_pytorch_tpu_torch.ops import quantize as Q
from ps_pytorch_tpu_torch.parallel.mesh import DCN_AXIS, WORKER_AXIS
from ps_pytorch_tpu_torch.parallel.ps import PSConfig
from tests.test_torch_check_fixtures import _built, _grads
from tests.test_torch_numerics_parity import (  # noqa: F401
    _one_thread,
    jax_exact_jit,
    numerics_findings,
    report_rows,
)

AX = WORKER_AXIS
N = 8


class _Result:
    """A bare report wrapped so the real rules can run on it."""

    def __init__(self, rep, policy):
        self.spec = ContractSpec(name="synthetic", build=None, axes=(AX,), numerics=policy)
        self.numerics = rep


def record(fn, *args, devices=N):
    """``fn(*args)`` recorded with its arguments as the step's inputs ->
    the report (every output counts as params unless ``fn`` returns a
    (params, carry) pair)."""
    with recording(devices) as tape:
        tape.mark_inputs(args)
        out = fn(*args)
        params = out[0] if isinstance(out, tuple) else out
        pv, ov = tape.value_ids(params), tape.value_ids(out)
    return analyze_numerics(tape, pv, ov)


# ------------------------------------------------- capacity (PSC113)

def test_torch_accum_capacity_table_matches_payload_math():
    assert Q.ACCUM_CAPACITY == {k: int(v) for k, v in jquantize.ACCUM_CAPACITY.items()}
    for name, cap in Q.ACCUM_CAPACITY.items():
        imax = int(np.iinfo(name).max)
        assert 127 * cap <= imax < 127 * (cap + 1)
    assert Q.ACCUM_CAPACITY["int16"] == 258
    assert Q.accum_dtype(258) == torch.int16 and Q.accum_dtype(259) == torch.int32


def _int16_wire_report(n):
    """The homomorphic int16 wire on a recording axis of ``n`` stacked
    workers: K2's shared-scale quantize, the int16 psum, the dequantize."""
    ax = RecordingWorkerAxis(n)

    def chain(g):
        q, scale = Q.quantize_int8(g, axis_name=ax)
        return ax.psum(q.to(torch.int16)).float() * scale

    g = torch.from_numpy(np.random.default_rng(0).standard_normal((n, 32), np.float32))
    return record(chain, g, devices=n)


def test_torch_int16_wire_proved_at_258_refused_at_259():
    """The 258-worker threshold comes from the recorded axis, not the
    config table: 127 * 258 = 32766 fits int16, 127 * 259 = 32893 does
    not, and the refusal is the analyzer's own bound."""
    pol = NumericsPolicy(quantized=True, accum_dtype="int16")
    rep = _int16_wire_report(258)
    (ev,) = [a for a in rep.accums if a.kind == "psum"]
    assert ev.dtype == "int16" and ev.multiplier == 258 and rep.axis_sizes == {AX: 258}
    assert ev.peak_out == 127.0 * 258 == 32766.0
    assert ev.capacity == 32767 and ev.peak_out <= ev.capacity
    assert numerics_findings(_Result(rep, pol)) == []

    rep = _int16_wire_report(259)
    (ev,) = [a for a in rep.accums if a.kind == "psum"]
    assert ev.multiplier == 259 and ev.peak_out == 127.0 * 259 == 32893.0 > ev.capacity
    findings = numerics_findings(_Result(rep, pol))
    assert any(f.rule == "PSC113" and "32893" in f.message for f in findings), findings


@pytest.fixture(scope="module")
def lenet_quantized():
    specs = [s for s in get_contracts() if s.numerics and s.numerics.quantized
             and s.numerics.accum_dtype and "resnet18" not in s.name]
    assert len(specs) >= 18
    return [trace_spec(s, device="cpu") for s in specs]


def test_torch_registry_recorded_bounds_fit_declared_capacity(lenet_quantized):
    """For every quantized (LeNet) registry config the analyzer's
    worst-case |sum| (recorded axis sizes x payload range) fits the
    accumulator ``ACCUM_CAPACITY`` picked; each hop's multiplier is the
    recorded size of its axes; the reduce rides the declared
    accumulator."""
    for r in lenet_quantized:
        name, pol, rep = r.spec.name, r.spec.numerics, r.numerics
        lattice = [a for a in rep.accums if a.lattice and a.dtype.startswith("int")]
        assert lattice, name
        for a in lattice:
            assert a.peak_out is not None and a.peak_out <= a.capacity, (name, a)
            if a.axes:
                assert a.multiplier == math.prod(rep.axis_sizes[ax] for ax in a.axes), (name, a)
            if a.kind in ("psum", "psum_scatter"):
                assert a.dtype == pol.accum_dtype, (name, a)
        total = math.prod(rep.axis_sizes.get(ax, 1) for ax in r.spec.axes)
        assert total == MESH_DEVICES <= Q.ACCUM_CAPACITY[pol.accum_dtype], name
        assert numerics_findings(r) == [], name


def test_torch_hier_worst_case_is_product_of_both_axes(lenet_quantized):
    """The hierarchical wire pays one bounded hop per axis (K3 over 4 ICI
    rows, then over 2 hosts): the scheme's capacity claim is the product
    of both recorded axis sizes."""
    r = next(r for r in lenet_quantized
             if r.spec.name == "ps_hier_int8_2round_replicated_bucketed_homomorphic")
    sizes = r.numerics.axis_sizes
    assert sizes == {DCN_AXIS: 2, WORKER_AXIS: 4}
    assert sizes[DCN_AXIS] * sizes[WORKER_AXIS] == MESH_DEVICES
    lattice = [a for a in r.numerics.accums if a.lattice]
    assert sorted({a.multiplier for a in lattice}) == [2, 4]
    for a in lattice:
        assert a.peak_out == 127.0 * a.multiplier <= a.capacity
    # each hop's requantize (K3) stays in range: pre-clamp |value| 127
    requants = [s for s in r.numerics.sites if not s.primary]
    assert len(requants) == 2 and all(s.pre_peak == 127.0 for s in requants)


# --------------------------- error-feedback closure (PSC112)

def _ef_spec(wire_domain, accum, error_feedback=True):
    cfg = PSConfig(num_workers=MESH_DEVICES, compress="int8", error_feedback=error_feedback,
                   wire_domain=wire_domain)
    return ContractSpec(
        name=f"ef_{wire_domain}", build=lambda device: _cnn_ps_built(cfg, "LeNet", 0, device),
        axes=(WORKER_AXIS,), grad_reduce=(GradReduce(WORKER_AXIS, ("psum",)),),
        numerics=NumericsPolicy(quantized=True, error_feedback=True, accum_dtype=accum))


@pytest.mark.parametrize("wd,accum", [("dequant", "int32"), ("homomorphic", "int16")])
def test_torch_real_error_feedback_step_proven_closed(wd, accum):
    """The engine's EF residual (the contribution the wire's own K2
    quantization returns) closes every primary wire site."""
    r = trace_spec(_ef_spec(wd, accum), device="cpu")
    assert numerics_findings(r) == []
    rep = r.numerics
    live = [res for res in rep.residuals if res.feeds_carry and not res.feeds_params]
    assert len(live) == 8  # one residual per LeNet param leaf
    covered = frozenset().union(*[res.covered_sites for res in live])
    primary = {s.sid for s in rep.sites if s.primary}
    assert primary and primary <= covered


def test_torch_error_feedback_dropped_residual_flagged():
    r = trace_spec(_ef_spec("dequant", "int32", error_feedback=False), device="cpu")
    findings = [f for f in numerics_findings(r) if f.rule == "PSC112"]
    assert len(findings) == 8 and all("residual" in f.message for f in findings)


def test_torch_error_feedback_double_count_flagged():
    """A residual carried to the next step AND folded into this step's
    update corrects the same error twice."""
    ax = RecordingWorkerAxis(N)

    def step(p, err, x):
        g = x * torch.cos(p) + err  # [N, 32], a row a worker
        scale = ax.pmax(g.abs().amax(1)) / 127.0
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        s = ax.psum(q.to(torch.int32))
        deq = s.float() * (scale / float(N))
        new_err = g - q.float() * scale
        return p - 0.1 * (deq + new_err.mean(0)), new_err  # applied AND carried

    rng = np.random.default_rng(0)
    args = [torch.from_numpy(rng.standard_normal(s, np.float32)) for s in ((32,), (32,), (N, 32))]
    rep = record(step, *args)
    pol = NumericsPolicy(quantized=True, error_feedback=True, accum_dtype="int32")
    findings = [f for f in numerics_findings(_Result(rep, pol)) if f.rule == "PSC112"]
    assert any("double" in f.message for f in findings), findings


# ------------------------------------- the kernels' declared events

_KERNEL_CASES = {
    # K2 per tensor, shared over the stacked workers
    "quantize_tensors": (lambda xs: Q.quantize_tensors(xs),
                         lambda xs: Q.quantize_tensors_plain(xs)),
    # K1 per row (the two-round wire's round 2)
    "quantize_rows_many": (lambda xs: Q.quantize_rows_many(xs),
                           lambda xs: Q.quantize_rows_many_plain(xs)),
    # K1 shared-scale blocks
    "quantize_rows_scaled_many": (lambda xs: Q.quantize_rows_scaled_many(xs, 32),
                                  lambda xs: Q.quantize_rows_scaled_many_plain(xs, 32)),
    # K2's split route (a process-spanning axis): this process's absmax,
    # then the quantize with it (the cross-process max between them)
    "quantize_tensors_given": (
        lambda xs: Q.quantize_tensors_given(xs, Q.tensors_absmax(xs)),
        lambda xs: Q.quantize_tensors_given_plain(xs, Q.tensors_absmax_plain(xs))),
    # K3 over the workers' rows of an int8 payload, the divisor a constant
    "accumulate_rescale_int8": (lambda xs: [Q.accumulate_rescale_int8(x, 8.0) for x in xs],
                                lambda xs: [Q.accumulate_rescale_plain(x, 8.0) for x in xs]),
}


@pytest.mark.parametrize("entry", sorted(_KERNEL_CASES))
def test_torch_kernel_node_declares_its_plain_versions_events(entry):
    kernel, plain = _KERNEL_CASES[entry]
    rng = np.random.default_rng(1)
    if entry == "accumulate_rescale_int8":
        xs = [torch.from_numpy(rng.integers(-127, 128, (N, s), dtype=np.int8))
              for s in (64, 96)]
        # the payload enters on the lattice: quantized in the step itself
        def wrap(fn):
            return lambda *xs: fn([Q.quantize_tensor_plain(x.float())[0] for x in xs])
    else:
        shapes = [(16, 32), (8, 32)] if entry == "quantize_rows_many" else [(N, 40), (N, 7)]
        xs = [torch.from_numpy(rng.standard_normal(s, np.float32)) for s in shapes]

        def wrap(fn):
            return lambda *xs: fn(list(xs))
    folded = report_rows(record(wrap(kernel), *xs))
    plain_rows = report_rows(record(wrap(plain), *xs))  # the plain ops unfolded
    assert folded == plain_rows
    assert folded["sites"]


def test_torch_kernel_node_is_one_node_with_the_same_events_as_the_plain_steps():
    """The recorded kernel node holds no aten op of its plain version."""
    xs = [torch.ones((N, 16)), torch.ones((N, 4))]
    with recording(N) as tape:
        tape.mark_inputs(xs)
        Q.quantize_tensors(xs)
    assert [n.op for n in tape.nodes] == ["kernel"]
    assert tape.nodes[0].info["numerics"] == "quantize"


# ---------------------------- the psnumerics fixtures as port steps

_NUM_INT32 = NumericsPolicy(quantized=True, accum_dtype="int32")


def _fixture(step, policy, param_len=32, ef=False):
    ax = RecordingWorkerAxis(N)
    build = _built(step(ax), param_len)
    if ef:
        def build(device, _b=build):
            b = _b(device)
            return Built(step=b.step, args=(b.args[0], torch.zeros_like(b.args[0]), b.args[1]),
                         select_params=lambda out: out[0], devices=N)
    return trace_spec(ContractSpec(name="fixture", build=build, axes=(AX,),
                                   grad_reduce=(GradReduce(AX, ("psum",)),), numerics=policy),
                      device="cpu")


def _quant(g, ax):
    scale = ax.pmax(g.abs().amax(1)) / 127.0
    return torch.clamp(g / scale, -127, 127).to(torch.int8), scale


def test_torch_fixture_fresh_scale_flagged_by_psc111():
    def step(ax):
        def f(p, x):
            g, losses = _grads(p, x)
            q, _ = _quant(g, ax)
            s = ax.psum(q.to(torch.int32))
            # BUG: the receiver recomputes the range from its own data
            wrong = x.abs().amax(1, keepdim=True) / 127.0
            return p - 0.1 * (s.float() * wrong[0]), ax.pmean(losses)
        return f

    r = _fixture(step, _NUM_INT32)
    assert {f.rule for f in numerics_findings(r)} == {"PSC111"}


def test_torch_fixture_dropped_residual_flagged_by_psc112():
    def step(ax):
        def f(p, x):
            g, losses = _grads(p, x)
            q, scale = _quant(g, ax)
            s = ax.psum(q.to(torch.int32))
            # BUG: error_feedback declared, no g - dequant(q) carried
            return p - 0.1 * (s.float() * (scale / N)), ax.pmean(losses)
        return f

    r = _fixture(step, NumericsPolicy(quantized=True, error_feedback=True, accum_dtype="int32"))
    assert {f.rule for f in numerics_findings(r)} == {"PSC112"}


def test_torch_fixture_widened_accum_flagged_by_psc113():
    def step(ax):
        def f(p, x):
            g, losses = _grads(p, x)
            q, scale = _quant(g, ax)
            s = ax.psum(q.to(torch.int32))  # BUG: int32 on a declared int16 wire
            return p - 0.1 * (s.float() * (scale / N)), ax.pmean(losses)
        return f

    r = _fixture(step, NumericsPolicy(quantized=True, accum_dtype="int16"))
    findings = numerics_findings(r)
    assert {f.rule for f in findings} == {"PSC113"}
    assert any("widened payload" in f.message for f in findings)


def test_torch_fixture_silent_downcast_flagged_by_psc114():
    def step(ax):
        def f(p, x):
            g, losses = _grads(p, x)
            g = ax.psum(g)
            new_p = (p - 0.1 * g).to(torch.bfloat16)  # BUG: silent f32 -> bf16
            return new_p.float(), ax.pmean(losses)
        return f

    r = _fixture(step, NumericsPolicy(quantized=False), param_len=8)
    findings = numerics_findings(r)
    assert [f.rule for f in findings] == ["PSC114"]
    assert "float32->bfloat16" in findings[0].message


def test_torch_fixture_ef_closed_passes():
    def step(ax):
        def f(p, err, x):
            g, losses = _grads(p, x)
            g = g + err
            q, scale = _quant(g, ax)
            s = ax.psum(q.to(torch.int32))
            new_err = g - q.float() * scale
            return p - 0.1 * (s.float() * (scale / N)), new_err, ax.pmean(losses)
        return f

    r = _fixture(step, NumericsPolicy(quantized=True, error_feedback=True, accum_dtype="int32"),
                 ef=True)
    assert numerics_findings(r) == []
    assert any(res.covered_sites and res.feeds_carry and not res.feeds_params
               for res in r.numerics.residuals)


# ------------------------------------ straight_line_tape (deviation)

def test_torch_straight_line_tape_proves_an_unrolled_loop_sum():
    """JAX's scan carry degrades a lattice sum to "cannot prove"
    (``numerics_scan_opaque``); the port's loop is unrolled on the tape,
    so the same sum is proven exact: 3 x 127 per worker, x 8 workers."""
    ax = RecordingWorkerAxis(N)

    def chain(g):
        q, scale = _quant(g, ax)
        w = q.to(torch.int32)
        acc = torch.zeros_like(w)
        for _ in range(3):
            acc = acc + w
        return ax.psum(acc).float() * scale

    rep = record(chain, torch.from_numpy(np.random.default_rng(2).standard_normal(
        (N, 16), np.float32)))
    (ev,) = [a for a in rep.accums if a.kind == "psum"]
    assert ev.peak_out == 3 * 127.0 * N and not ev.conservative
    assert numerics_findings(_Result(rep, _NUM_INT32)) == []

    def jchain(g):
        scale = lax.pmax(jnp.max(jnp.abs(g)), AX) / 127.0
        w = jnp.clip(jnp.round(g / scale), -127, 127).astype(jnp.int8).astype(jnp.int32)
        acc, _ = lax.scan(lambda c, _: (c + w, None), jnp.zeros_like(w), None, length=3)
        return lax.psum(acc, AX).astype(jnp.float32) * scale

    closed = jax.make_jaxpr(jchain, axis_env=[(AX, N)])(
        jax.ShapeDtypeStruct((16,), jnp.float32))
    jrep = j_analyze_numerics(closed, param_out_indices=[0], axis_sizes={AX: N})
    assert all(a.peak_out is None for a in jrep.accums if a.kind == "psum")
