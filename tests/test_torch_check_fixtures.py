"""pscheck on the port, the negative fixtures: one seeded-defect port step
for each non-numerics fixture of tests/check_fixtures.py, each a
miniature step ``(params, x) -> (new_params, metrics)`` over a recording
worker axis of 8 stacked workers, each tripping exactly its rule, and the
clean ``ok_psum`` passing. The module is itself the fixture registry
(``get_contracts``) that the CLI loads with ``--registry``.

- dead_axis: the (dcn x workers) grid declared, the gradient reduced over
  the ICI axis only (PSC101);
- metrics_only: the gradient psum dropped, only the metrics pmean rides
  the axis (PSC102, with the near-miss hint);
- fat_f32_wire: an int8 all_to_all whose partial sums return as a full
  f32 all_gather (PSC103);
- drift: a clean step; the test tampers its pinned bytes (PSC104);
- undonated: the step keeps a reference to the state it consumed, so the
  state outlives the caller's reference (PSC105, restated);
- donate_mismatch: the step returns the params as bf16 (PSC105);
- defused: a declared single fused bucket reduced as four psums (PSC106);
- serve_chatty / serve_f32_kv: a collective in a decode step; an f32 pool
  on a declared int8 pool (PSC107);
- adaptive_fat_wire: an adaptive envelope smaller than the psum (PSC108);
- adaptive_no_consensus: no host-consensus point declared (PSC110);
- homomorphic_widened: an int32 psum on a declared int16 wire (PSC103);
- depipelined: a pipelined 4-bucket plan reduced in one psum (PSC109).
"""

import contextlib
import io
import json

import pytest
import torch

from ps_pytorch_tpu_torch.check import (
    AdaptivePolicy,
    Built,
    ContractSpec,
    DonationSpec,
    FusionSpec,
    GradReduce,
    OverlapPolicy,
    ServePolicy,
    WireAllowance,
    WirePolicy,
)
from ps_pytorch_tpu_torch.check.__main__ import main as check_main
from ps_pytorch_tpu_torch.check.axes import RecordingHybridAxis, RecordingWorkerAxis
from ps_pytorch_tpu_torch.parallel.mesh import DCN_AXIS, WORKER_AXIS
from tests.test_torch_one_thread import _one_thread  # noqa: F401

AXIS = WORKER_AXIS
N = 8
REGISTRY = "tests.test_torch_check_fixtures"


def _grads(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Each worker's gradient of ``sum(p[:4] * x[w])``, stacked ``[N, L]``."""
    leaf = p.detach().requires_grad_(True)
    with torch.enable_grad():
        losses = (leaf[:4][None] * x).sum(1)
        rows = [torch.autograd.grad(losses[w], leaf, retain_graph=w < N - 1)[0]
                for w in range(N)]
    return torch.stack(rows), losses.detach()


def _built(step, param_len: int, x_cols: int = 4, devices: int = N) -> Built:
    def build(device):
        g = torch.Generator().manual_seed(0)
        p = torch.randn((param_len,), generator=g).to(device)
        x = torch.randn((N, x_cols), generator=g).to(device)
        return Built(step=step, args=(p, x), select_params=lambda out: out[0],
                     devices=devices)

    return build


def _clean_step(ax, cast=None, keep=None):
    def step(p, x):
        g, losses = _grads(p, x)
        new_p = p - 0.1 * ax.psum(g)
        if cast is not None:
            new_p = new_p.to(cast)
        if keep is not None:
            keep.append(p)  # BUG (undonated): the consumed state stays referenced
        return new_p, ax.pmean(losses)

    return step


def _dead_axis() -> ContractSpec:
    grid = RecordingHybridAxis(N, hosts=2, per_host=4)

    def step(p, x):
        g, losses = _grads(p, x)
        # BUG: reduced over the chip axis only: the dcn (host) axis is
        # declared but no collective consumes it
        g_host = grid.ici.psum(g.reshape(2, 4, -1).transpose(0, 1))  # [hosts, L]
        return p - 0.1 * g_host, grid.ici.pmean(losses.reshape(2, 4).T)

    return ContractSpec(name="dead_axis", build=_built(step, 8), axes=(DCN_AXIS, WORKER_AXIS),
                        grad_reduce=(GradReduce(WORKER_AXIS, ("psum",)),))


def _metrics_only() -> ContractSpec:
    ax = RecordingWorkerAxis(N)

    def step(p, x):
        g, losses = _grads(p, x)
        # BUG: no psum of g: each worker applies its own partial gradient;
        # only the metrics pmean touches the axis
        return p - 0.1 * g, ax.pmean(losses)

    return ContractSpec(name="metrics_only", build=_built(step, 8), axes=(AXIS,),
                        grad_reduce=(GradReduce(AXIS, ("psum",)),))


def _fat_f32_wire() -> ContractSpec:
    L = 4096  # a worker's region 512 floats -> a 2 KiB f32 all_gather
    ax = RecordingWorkerAxis(N)

    def step(p, x):
        g, losses = _grads(p, x)
        q = torch.clamp(g * 127.0, -127, 127).to(torch.int8)
        recv = ax.all_to_all(q.reshape(N, N, L // N))  # [region, sender, L/N]
        partial = recv.to(torch.int32).sum(1)
        # BUG: the partial sums return as FULL f32 instead of int8
        full = ax.all_gather(partial.float() / 127.0)
        return p - 0.1 * full, ax.pmean(losses)

    return ContractSpec(
        name="fat_f32_wire", build=_built(step, L), axes=(AXIS,),
        grad_reduce=(GradReduce(AXIS, ("all_to_all",)),),
        wire=WirePolicy(axes=(AXIS,), payload_dtype="int8", allow=(
            WireAllowance(kind="psum", dtype="float32", max_bytes=64, reason="metrics pmean"),
            WireAllowance(kind="all_gather", dtype="float32", max_bytes=1024,
                          reason="scale rows only"))))


def _drift() -> ContractSpec:
    return ContractSpec(name="drift", build=_built(_clean_step(RecordingWorkerAxis(N)), 8),
                        axes=(AXIS,), grad_reduce=(GradReduce(AXIS, ("psum",)),),
                        donation=DonationSpec(argnums=(0,), out_positions=(0,)))


_KEPT: list = []


def _undonated() -> ContractSpec:
    # BUG: the step keeps the params it consumed (a cache of last step's
    # state), so they outlive the caller's reference
    return ContractSpec(name="undonated",
                        build=_built(_clean_step(RecordingWorkerAxis(N), keep=_KEPT), 8),
                        axes=(AXIS,), grad_reduce=(GradReduce(AXIS, ("psum",)),),
                        donation=DonationSpec(argnums=(0,), out_positions=(0,)))


def _donate_mismatch() -> ContractSpec:
    # BUG: consumes f32 params but returns bf16 ones: the state changes
    # dtype from step to step
    return ContractSpec(name="donate_mismatch",
                        build=_built(_clean_step(RecordingWorkerAxis(N), cast=torch.bfloat16), 8),
                        axes=(AXIS,), grad_reduce=(GradReduce(AXIS, ("psum",)),),
                        donation=DonationSpec(argnums=(0,), out_positions=(0,)))


def _defused() -> ContractSpec:
    L = 32
    ax = RecordingWorkerAxis(N)

    def step(p, x):
        g, losses = _grads(p, x)
        # BUG: one fused bucket declared, the reduction runs per 8-element
        # "leaf": four psums on the gradient path
        g = torch.cat([ax.psum(g[:, i * 8:(i + 1) * 8]) for i in range(4)])
        return p - 0.1 * g, ax.pmean(losses)

    return ContractSpec(name="defused", build=_built(step, L), axes=(AXIS,),
                        grad_reduce=(GradReduce(AXIS, ("psum",)),),
                        fusion=FusionSpec(payload_bytes=L * 4, bucket_bytes=0))


def _serve_built(step):
    def build(device):
        pool = {"k": torch.zeros((N, 4), device=device), "v": torch.zeros((N, 4), device=device)}
        p = torch.ones((8,), device=device)
        tok = torch.arange(N, dtype=torch.int32, device=device)
        return Built(step=step, args=(p, pool, tok), select_params=lambda out: out[0],
                     devices=N)

    return build


def _serve_chatty() -> ContractSpec:
    ax = RecordingWorkerAxis(N)

    def step(p, pool, tok):
        stat = ax.pmean(tok.float() * p[0])  # BUG: a collective on the hot path
        pool["k"].add_(1.0)
        return pool, stat

    return ContractSpec(name="serve_chatty", build=_serve_built(step), axes=(AXIS,),
                        serve=ServePolicy(kv_argnum=1, quantized=False, kv_dtype="float32"))


def _serve_f32_kv() -> ContractSpec:
    def step(p, pool, tok):
        pool["k"].add_(p[0])
        return pool, tok

    # BUG: an int8 pool declared, plain f32 K/V stored
    return ContractSpec(name="serve_f32_kv", build=_serve_built(step), axes=(),
                        serve=ServePolicy(kv_argnum=1, quantized=True))


def _adaptive_fat_wire() -> ContractSpec:
    # a healthy step whose envelope (16 B) is smaller than its 8-element
    # f32 psum's 32 B: only PSC108 trips
    return ContractSpec(
        name="adaptive_fat_wire", build=_built(_clean_step(RecordingWorkerAxis(N)), 8),
        axes=(AXIS,), grad_reduce=(GradReduce(AXIS, ("psum",)),),
        adaptive=AdaptivePolicy(min_aggregate=2, max_aggregate=N, envelope_bytes=16,
                                consensus="trainer.Trainer._count_consensus"))


def _adaptive_no_consensus() -> ContractSpec:
    # BUG: a healthy adaptive step naming no host-consensus point
    return ContractSpec(
        name="adaptive_no_consensus", build=_built(_clean_step(RecordingWorkerAxis(N)), 8),
        axes=(AXIS,), grad_reduce=(GradReduce(AXIS, ("psum",)),),
        adaptive=AdaptivePolicy(min_aggregate=2, max_aggregate=N, envelope_bytes=64))


def _homomorphic_widened() -> ContractSpec:
    L = 4096
    ax = RecordingWorkerAxis(N)

    def step(p, x):
        g, losses = _grads(p, x)
        q = torch.clamp(g * 127.0, -127, 127).to(torch.int8)
        # BUG: the homomorphic wire's accumulator is int16 on 8 workers;
        # the psum widened to int32
        s = ax.psum(q.to(torch.int32))
        return p - 0.1 * (s.float() / (127.0 * N)), ax.pmean(losses)

    return ContractSpec(
        name="homomorphic_widened", build=_built(step, L), axes=(AXIS,),
        grad_reduce=(GradReduce(AXIS, ("psum",)),),
        wire=WirePolicy(axes=(AXIS,), payload_dtype="int16", allow=(
            WireAllowance(kind="psum", dtype="float32", max_bytes=64, reason="metrics pmean"),
            WireAllowance(kind="pmax", dtype="float32", max_bytes=4096, reason="scale rows"))))


def _depipelined() -> ContractSpec:
    # a healthy fused step whose contract CLAIMS a pipelined 4-bucket
    # schedule: one psum (under PSC106's budget) fails PSC109's per-bucket
    # dispatch; no serial twin is recorded beside it
    L = 32
    return ContractSpec(
        name="depipelined", build=_built(_clean_step(RecordingWorkerAxis(N)), L), axes=(AXIS,),
        grad_reduce=(GradReduce(AXIS, ("psum",)),),
        fusion=FusionSpec(payload_bytes=L * 4, bucket_bytes=L),
        overlap=OverlapPolicy(mode="pipelined", serial_twin=None))


def _ok_psum() -> ContractSpec:
    return ContractSpec(name="ok_psum", build=_built(_clean_step(RecordingWorkerAxis(N)), 8),
                        axes=(AXIS,), grad_reduce=(GradReduce(AXIS, ("psum",)),),
                        donation=DonationSpec(argnums=(0,), out_positions=(0,)))


def get_contracts():
    return (_dead_axis(), _metrics_only(), _fat_f32_wire(), _drift(), _undonated(),
            _donate_mismatch(), _defused(), _serve_chatty(), _serve_f32_kv(),
            _adaptive_fat_wire(), _adaptive_no_consensus(), _homomorphic_widened(),
            _depipelined(), _ok_psum())


FIXTURES = {"dead_axis", "metrics_only", "fat_f32_wire", "drift", "undonated",
            "donate_mismatch", "defused", "serve_chatty", "serve_f32_kv", "adaptive_fat_wire",
            "adaptive_no_consensus", "homomorphic_widened", "depipelined", "ok_psum"}


def _run_main(args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = check_main(args + ["--device", "cpu"])
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def fixture_contract(tmp_path_factory):
    """The fixture registry's artifact, with the `drift` config's pinned
    bytes tampered so PSC104 has something to catch."""
    path = tmp_path_factory.mktemp("check") / "contract.json"
    rc, _ = _run_main(["--registry", REGISTRY, "--write-contract", "--contract", str(path)])
    assert rc == 1  # written, though the broken fixtures trip their rules
    data = json.loads(path.read_text())
    assert set(data["configs"]) == FIXTURES
    data["configs"]["drift"]["collectives"][0]["bytes"] += 1
    path.write_text(json.dumps(data))
    return path


@pytest.mark.parametrize("name,rule", [
    ("dead_axis", "PSC101"),
    ("metrics_only", "PSC102"),
    ("fat_f32_wire", "PSC103"),
    ("drift", "PSC104"),
    ("undonated", "PSC105"),
    ("donate_mismatch", "PSC105"),
    ("defused", "PSC106"),
    ("serve_chatty", "PSC107"),
    ("serve_f32_kv", "PSC107"),
    ("adaptive_fat_wire", "PSC108"),
    ("adaptive_no_consensus", "PSC110"),
    ("homomorphic_widened", "PSC103"),
    ("depipelined", "PSC109"),
])
def test_torch_fixture_trips_exactly_one_rule(fixture_contract, name, rule):
    rc, out = _run_main(["--registry", REGISTRY, "--only", name, "--contract",
                         str(fixture_contract), "--format", "json"])
    assert rc == 1
    assert sorted({f["rule"] for f in json.loads(out)["findings"]}) == [rule], out


def test_torch_clean_fixture_passes(fixture_contract):
    rc, out = _run_main(["--registry", REGISTRY, "--only", "ok_psum", "--contract",
                         str(fixture_contract), "--format", "json"])
    assert rc == 0, out
    assert json.loads(out)["findings"] == []


def test_torch_psc102_names_the_metrics_near_miss(fixture_contract):
    rc, out = _run_main(["--registry", REGISTRY, "--only", "metrics_only", "--contract",
                         str(fixture_contract), "--format", "json"])
    (finding,) = json.loads(out)["findings"]
    assert "feeds only non-param outputs" in finding["message"]


def test_torch_psc105_names_the_leak_and_the_dtype(fixture_contract):
    """The restated donation contract's two halves: a consumed state that
    outlives the caller's reference, a returned state of another dtype."""
    _, out = _run_main(["--registry", REGISTRY, "--only", "undonated,donate_mismatch",
                        "--contract", str(fixture_contract), "--format", "json"])
    msgs = {f["config"]: f["message"] for f in json.loads(out)["findings"]}
    assert "stays alive after the caller drops it" in msgs["undonated"]
    assert "bfloat16" in msgs["donate_mismatch"]
