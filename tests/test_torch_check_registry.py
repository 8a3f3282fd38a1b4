"""pscheck on the port, the registry (ps_pytorch_tpu_torch/check): the 37
configurations of JAX's ``runs/comm_contract.json``, by its names, each
recorded on the CPU from the port's own step builders; zero findings; the
committed port artifact ``check/comm_contract.json`` round-trips
(PSC104); each config's accounting rows equal JAX's artifact in bytes per
(kind, axes, dtype), and in count, unless a named deviation of the spec
says otherwise (each pinned here); the pins of tests/test_check.py
(the int8 wire, ResNet18's per-leaf -> bucketed collapse, the homomorphic
shrink, the silent serving wire); the CLI's usage errors, ``--select``,
``--list``, and ``--select`` of the psnumerics rules (PSC111-114).
"""

import contextlib
import io
import json
from pathlib import Path

import pytest

from ps_pytorch_tpu_torch.check import (
    get_contracts,
    load_contract,
    run_checks,
    to_contract_json,
    trace_registry,
)
from ps_pytorch_tpu_torch.check.__main__ import main as check_main
from ps_pytorch_tpu_torch.check.contracts import (
    RESNET_BUCKET_BYTES,
    _ps_spec,
    canonical_spec,
    payload_bytes,
)
from ps_pytorch_tpu_torch.check.core import DEFAULT_CONTRACT, trace_spec
from tests.test_torch_one_thread import _one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
JAX_CONTRACT = REPO / "runs" / "comm_contract.json"


def _run_main(args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = check_main(args)
    return rc, buf.getvalue()


def _key(row):
    return (row["kind"], tuple(row["axes"]), row["dtype"])


@pytest.fixture(scope="module")
def results():
    return trace_registry(get_contracts(), device="cpu")


@pytest.fixture(scope="module")
def jax_contract():
    return json.loads(JAX_CONTRACT.read_text())["configs"]


def test_torch_registry_names_are_jaxs(jax_contract):
    names = [s.name for s in get_contracts()]
    assert len(names) == len(set(names)) == 37
    assert set(names) == set(jax_contract)


def test_torch_registry_contracts_hold(results):
    """THE gate: every scheme's recorded step meets its declared contract."""
    findings = run_checks(results, contract=None)
    assert findings == [], "\n".join(f"{f.config}: {f.rule} {f.message}" for f in findings)


def test_torch_committed_contract_roundtrips(results):
    """PSC104: the committed port artifact matches the live record, through
    run_checks and as raw JSON."""
    committed = load_contract(DEFAULT_CONTRACT)
    findings = run_checks(results, committed)
    assert findings == [], "\n".join(f"{f.config}: {f.rule} {f.message}" for f in findings)
    assert to_contract_json(results) == committed


def _deviation_gaps(spec, mine, jax_rows):
    """Every (key, aspect, port row, JAX row) where the port's row differs
    from JAX's, and the spec's deviations by key (a key may carry more
    than one)."""
    got = {_key(r): r for r in mine}
    want = {_key(r): r for r in jax_rows}
    devs = {}
    for d in spec.deviations:
        devs.setdefault(d.key, []).append(d)
    gaps = []
    for key in sorted(set(got) | set(want)):
        a, b = got.get(key), want.get(key)
        if a is None or b is None or a["bytes"] != b["bytes"]:
            gaps.append((key, "bytes", a, b))
        elif a["count"] != b["count"]:
            gaps.append((key, "count", a, b))
    return gaps, devs


# the psum deviations that make several calls of one JAX equation, each
# counted on its own calls: metrics (and BN stats, telemetry) feed no
# parameter, gradient pieces do
_CALL_SPLITS = {"batched_metrics_psum": False, "per_piece_grad_psum": True}


def test_torch_rows_equal_jaxs_unless_a_named_deviation_says_otherwise(results, jax_contract):
    """Per config and row: the same bytes as JAX's artifact, and the same
    count unless a deviation covers it. A count deviation allows only the
    count to differ; a bytes deviation the row. A psum count deviation
    accounts for its extra calls: each of ``_CALL_SPLITS`` allows the
    calls of its own kind (told apart by ``feeds_params``) less the one
    equation JAX makes of them. Every declared deviation is used (none is
    stale), and every PS config's rows agree in bytes but for
    ``ef_mirror_quantizes_once``."""
    for r in results:
        gaps, devs = _deviation_gaps(r.spec, r.summary, jax_contract[r.spec.name]["collectives"])
        used = set()
        for key, aspect, mine, theirs in gaps:
            assert key in devs, (r.spec.name, key, mine, theirs)
            aspects = {d.aspect for d in devs[key]}
            assert aspect == "count" or "bytes" in aspects, (r.spec.name, key, devs[key])
            used.add(key)
            names = {d.name for d in devs[key]}
            if aspect == "count" and names & set(_CALL_SPLITS):
                calls = [c for c in r.collectives if (c.kind, c.axes, c.dtype) == key]
                allowed = 0
                for name in names & set(_CALL_SPLITS):
                    n = sum(c.feeds_params == _CALL_SPLITS[name] for c in calls)
                    assert n > 1, (r.spec.name, key, name, n)
                    allowed += n - 1
                assert mine["count"] - theirs["count"] <= allowed, (r.spec.name, key, names)
        assert used == set(devs), (r.spec.name, set(devs) - used)
        if r.spec.name.startswith("ps_"):
            assert {d.name for k, a, _, _ in gaps if a == "bytes" for d in devs[k]} <= {
                "ef_mirror_quantizes_once"}, (r.spec.name, gaps)


@pytest.mark.parametrize("name,deviation,kind,aspect", [
    ("ps_int8_replicated", "batched_metrics_psum", "psum", "count"),
    ("ps_none_replicated", "batched_metrics_psum", "psum", "count"),
    ("ps_none_replicated", "per_piece_grad_psum", "psum", "count"),
    ("ps_none_replicated_bucketed64k", "per_piece_grad_psum", "psum", "count"),
    ("ps_resnet18_int8_replicated_bucketed", "batched_metrics_psum", "psum", "count"),
    ("ps_hier_int8_2round_replicated", "grouped_shared_scale", "pmax", "count"),
    ("ps_int8_2round_replicated_bucketed64k_homomorphic_ef_precadapt",
     "ef_mirror_quantizes_once", "pmax", "bytes"),
    ("dp_tp", "one_backward", "psum", "bytes"),
    ("pp", "unrolled_ticks", "ppermute", "bytes"),
    ("moe", "one_backward", "all_to_all", "bytes"),
    ("dp_tp_pp", "unrolled_ticks", "psum", "bytes"),
])
def test_torch_named_deviation_is_pinned(results, jax_contract, name, deviation, kind, aspect):
    """Each deviation of ROADMAP.md queue 3, pinned on one config: the
    difference it names is there, and of its kind. batched_metrics_psum:
    the port's metrics (and BN stats) are one call a tensor where JAX
    psums a tree in one equation, the same bytes; per_piece_grad_psum:
    the uncompressed wire's gradient pieces (leaves, or buckets) are one
    call each where JAX psums the list in one equation, together the f32
    gradient payload; grouped_shared_scale: one shared-scale quantize a
    group of the hierarchical grid; ef_mirror_quantizes_once: JAX's EF
    mirror pmaxes every bucket twice, the port once (half the bytes);
    one_backward and unrolled_ticks: the LM schemes' gradient psums and
    backward transposes are no call in the port, and its GPipe ticks are
    unrolled (their bounds: the next test)."""
    r = next(x for x in results if x.spec.name == name)
    gaps, devs = _deviation_gaps(r.spec, r.summary, jax_contract[name]["collectives"])
    hit = [(key, a, mine, theirs) for key, a, mine, theirs in gaps
           if key[0] == kind and deviation in {d.name for d in devs[key]}]
    assert hit, (name, gaps)
    for key, a, mine, theirs in hit:
        assert {d.aspect for d in devs[key] if d.name == deviation} == {aspect}
        if aspect == "count":
            assert mine["count"] > theirs["count"] and mine["bytes"] == theirs["bytes"]
    if deviation == "per_piece_grad_psum":
        ((key, _, _, _),) = hit
        grads = [c for c in r.collectives if (c.kind, c.axes, c.dtype) == key and c.feeds_params]
        assert len(grads) > 1 and sum(c.bytes for c in grads) == payload_bytes("LeNet")
    if deviation == "ef_mirror_quantizes_once":
        ((_, _, mine, theirs),) = hit
        assert 2 * mine["bytes"] == theirs["bytes"] and 2 * mine["count"] == theirs["count"]


def _lm_rows():
    """What the port's LM rows under one_backward / unrolled_ticks must be,
    from ``_lm_cfg()`` and the registry builders' geometry: dp_tp 4 x 2
    over batch 8; pp 2 stages, 2 microbatches over batch 4; moe 8 experts
    over batch 8; dp_tp_pp 2 x 2 x 2 over batch 4, 2 microbatches. Each
    key maps to ("fwd", calls, bytes a call): the forward's collectives
    only, and JAX moves twice them (its backward transposes); ("ticks",
    calls a tick, bytes a call): M + S - 1 unrolled ticks, where JAX's scan
    body moves them twice (forward and transposed); ("metrics",): the
    loss / aux scalars only; ("absent",): a gradient reduction the port
    makes inside autograd, no call."""
    import math

    from ps_pytorch_tpu_torch.check.contracts import _lm_cfg
    from ps_pytorch_tpu_torch.parallel.moe import MoEConfig

    cfg = _lm_cfg()
    T, D, L = cfg.max_seq_len, cfg.dim, cfg.depth

    def act(b):  # one [b, T, D] f32 activation a device
        return b * T * D * 4

    moe = MoEConfig(num_experts=8)
    slots = math.ceil(1 * T * moe.top_k * moe.capacity_factor / moe.num_experts)
    return {
        "dp_tp": {("psum", ("model",)): ("fwd", 2 * L, act(8 // 4)),
                  ("psum", ("workers",)): ("metrics",),
                  ("psum", ("workers", "model")): ("absent",)},
        "pp": {("ppermute", ("stage",)): ("ticks", 1, act(4 // 2)),
               ("psum", ("stage",)): ("absent",)},
        "moe": {("all_to_all", ("expert",)): ("fwd", 2 * L, moe.num_experts * slots * D * 4),
                ("psum", ("expert",)): ("metrics",)},
        "dp_tp_pp": {("ppermute", ("stage",)): ("ticks", 1, act(4 // 2 // 2)),
                     ("psum", ("model",)): ("ticks", 2 * (L // 2), act(4 // 2 // 2)),
                     ("psum", ("stage",)): ("absent",),
                     ("psum", ("workers",)): ("metrics",),
                     ("psum", ("workers", "model")): ("absent",),
                     ("psum", ("workers", "stage", "model")): ("absent",)},
    }


@pytest.mark.parametrize("name", ["dp_tp", "pp", "moe", "dp_tp_pp"])
def test_torch_lm_deviation_rows_are_held_to_the_forward_share(results, jax_contract, name):
    """A one_backward / unrolled_ticks row is held to a figure, not waived:
    the forward's collectives at their exact bytes (half JAX's), the
    unrolled ticks at M + S - 1 times the scan body's forward bytes, the
    metrics scalars within the metrics allowance, or no call at all."""
    r = next(x for x in results if x.spec.name == name)
    mine = {(k, a): row for (k, a, _), row in ((_key(x), x) for x in r.summary)}
    theirs = {(k, a): row for (k, a, _), row in ((_key(x), x) for x in jax_contract[name]["collectives"])}
    expect = _lm_rows()[name]
    devs = {(d.kind, d.axes): d.name for d in r.spec.deviations}
    assert set(devs) == set(expect), (name, set(devs) ^ set(expect))
    assert all(d.dtype == "float32" for d in r.spec.deviations)
    ticks = 2 + 2 - 1  # M + S - 1
    for key, (how, *fig) in expect.items():
        got, jax = mine.get(key), theirs[key]
        assert devs[key] == ("unrolled_ticks" if how == "ticks" else "one_backward"), key
        if how == "absent":
            assert got is None, (name, key, got)
        elif how == "metrics":
            assert got["bytes"] <= 64 and got["count"] <= jax["count"], (name, key, got)
            assert got["bytes"] < jax["bytes"], (name, key, got, jax)
        elif how == "fwd":
            calls, each = fig
            assert (got["count"], got["bytes"]) == (calls, calls * each), (name, key, got)
            assert (jax["count"], jax["bytes"]) == (2 * calls, 2 * calls * each), (name, key, jax)
        else:
            calls, each = fig
            assert (got["count"], got["bytes"]) == (ticks * calls, ticks * calls * each), (
                name, key, got)
            assert (jax["count"], jax["bytes"]) == (2 * calls, 2 * calls * each), (name, key, jax)


def test_torch_lm_specs_name_why_they_waive_jaxs_grad_reduce():
    """The LM schemes run one backward over the summed loss: JAX's
    GradReduce declarations cannot hold, and each spec declares none,
    with a one_backward psum deviation on each of the axes JAX reduces
    the gradient over to say why."""
    jax_axes = {"dp_tp": {"workers", "model"}, "pp": {"stage"}, "moe": {"expert"},
                "dp_tp_pp": {"workers", "stage", "model"}}
    specs = {s.name: s for s in get_contracts()}
    for name, axes in jax_axes.items():
        spec = specs[name]
        assert not spec.grad_reduce
        assert {a for d in spec.deviations if d.name == "one_backward" and d.kind == "psum"
                for a in d.axes} == axes, name


def test_torch_trace_spec_defaults_to_the_card():
    """``trace_spec`` and ``trace_registry`` run on the card unless the
    caller passes ``device="cpu"``: without a card they raise."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    spec = next(s for s in get_contracts() if s.name == "ps_int8_replicated")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trace_spec(spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trace_registry([spec])


def test_torch_committed_contract_pins_an_int8_wire():
    committed = load_contract(DEFAULT_CONTRACT)
    for name in ("ps_int8_2round_replicated", "ps_int8_2round_sharded",
                 "ps_hier_int8_2round_replicated"):
        int8_rows = [r for r in committed["configs"][name]["collectives"]
                     if r["dtype"] == "int8"]
        assert any(r["kind"] == "all_to_all" for r in int8_rows), name
    assert any(r["kind"] == "all_gather" and r["dtype"] == "int8"
               for r in committed["configs"]["ps_int8_2round_replicated"]["collectives"])


def test_torch_committed_contract_pins_bucketing_collapse():
    committed = load_contract(DEFAULT_CONTRACT)

    def grad_psums(name):
        return sum(r["count"] for r in committed["configs"][name]["collectives"]
                   if r["kind"] == "psum" and r["dtype"] == "int32")

    n_buckets = -(-payload_bytes("ResNet18") // RESNET_BUCKET_BYTES)
    assert grad_psums("ps_resnet18_int8_replicated") == 62  # one a leaf
    assert grad_psums("ps_resnet18_int8_replicated_bucketed") <= n_buckets
    assert grad_psums("ps_int8_replicated_bucketed") == 1


def test_torch_committed_contract_pins_homomorphic_wire_shrink():
    committed = load_contract(DEFAULT_CONTRACT)

    def rows(name):
        return committed["configs"][name]["collectives"]

    def one(name, kind, axes, dtype):
        (hit,) = [r for r in rows(name)
                  if r["kind"] == kind and r["axes"] == axes and r["dtype"] == dtype]
        return hit

    deq = one("ps_hier_int8_2round_replicated_bucketed", "all_gather", ["workers"], "float32")
    hom = one("ps_hier_int8_2round_replicated_bucketed_homomorphic", "all_gather",
              ["workers"], "int8")
    assert deq["bytes"] == 4 * hom["bytes"]
    assert all(r["bytes"] <= 64 for r in rows(
        "ps_hier_int8_2round_replicated_bucketed_homomorphic") if r["dtype"] == "float32")
    assert (one("ps_int8_replicated", "psum", ["workers"], "int32")["bytes"]
            == 2 * one("ps_int8_replicated_homomorphic", "psum", ["workers"], "int16")["bytes"])
    assert any(r["kind"] == "all_gather" and r["dtype"] == "float32"
               for r in rows("ps_int8_2round_replicated_bucketed"))
    assert not any(r["kind"] == "all_gather" and r["dtype"] == "float32"
                   for r in rows("ps_int8_2round_replicated_bucketed_homomorphic"))


def test_torch_homomorphic_allowance_list_strictly_shrinks():
    for kw in (dict(bucket_bytes=0), dict(dcn_hosts=2, bucket_bytes=0), dict()):
        placement = "replicated" if kw else "sharded"
        deq = _ps_spec("int8_2round", placement, **kw)
        hom = _ps_spec("int8_2round", placement, wire_domain="homomorphic", **kw)
        assert set(hom.wire.allow) < set(deq.wire.allow), (deq.name, hom.name)
    assert _ps_spec("int8", "replicated").wire is None
    assert _ps_spec("int8", "replicated", wire_domain="homomorphic").wire.payload_dtype == "int16"


def test_torch_committed_contract_pins_a_silent_serving_wire(results):
    committed = load_contract(DEFAULT_CONTRACT)
    for name in ("serve_decode", "serve_decode_int8kv"):
        entry = committed["configs"][name]
        assert entry["collectives"] == [] and entry["n_collectives"] == 0
        assert entry["total_bytes"] == 0 and entry["axes"] == []
    # the int8 pool's write is K1's KV entry, one node a layer
    r = next(x for x in results if x.spec.name == "serve_decode_int8kv")
    assert r.kernels == {"K1:quantize_kv_write": 2}


def test_torch_kernel_nodes_of_the_slice_path(results):
    """K2 on every int8 / int8_2round PS spec of the static nearest wire,
    K3 on the homomorphic two-round specs (two a piece on the
    hierarchical grid)."""
    by = {r.spec.name: r.kernels for r in results}
    assert by["ps_int8_replicated"] == {"K2:quantize_tensors": 1}
    assert by["ps_int8_replicated_bucketed64k_pipelined"] == {"K2:quantize_tensors": 27}
    assert by["ps_int8_2round_replicated_bucketed_homomorphic"] == {
        "K2:quantize_tensors": 1, "K3:accumulate_rescale_int8": 1}
    assert by["ps_hier_int8_2round_replicated_bucketed_homomorphic"]["K3:accumulate_rescale_int8"] == 2
    assert by["ps_none_replicated"] == {}


def test_torch_canonical_spec_is_the_bucketed_resnet18_wire():
    spec = canonical_spec()
    twin = _ps_spec("int8", "replicated", network="ResNet18", bucket_bytes=RESNET_BUCKET_BYTES)
    assert spec.name == twin.name + "_b128"
    assert spec.fusion == twin.fusion and spec.wire == twin.wire


# --------------------------------------------------------------- CLI usage

def test_torch_cli_usage_errors(tmp_path):
    rc, _ = _run_main(["--device", "cpu", "--only", "no_such_config"])
    assert rc == 2
    rc, _ = _run_main(["--device", "cpu", "--write-contract", "--only", "ps_int8_replicated",
                       "--contract", str(tmp_path / "c.json")])
    assert rc == 2 and not (tmp_path / "c.json").exists()
    rc, _ = _run_main(["--device", "cpu", "--registry", "tests.no_such_registry_xyz"])
    assert rc == 2
    rc, _ = _run_main(["--device", "cpu", "--select", "PSC999"])
    assert rc == 2


@pytest.mark.parametrize("rule", ["PSC111", "psc112", "PSC113", "PSC114"])
def test_torch_cli_refuses_the_numerics_rules_naming_item_26(rule, capsys):
    """Once the CLI refused the psnumerics rules (exit 2); they are
    ported now, so ``--select`` runs them like any other rule: a clean
    registry config exits 0, with no refusal."""
    rc = check_main(["--device", "cpu", "--only", "ps_int8_replicated_homomorphic",
                     "--select", f"PSC101,{rule}"])
    assert rc == 0
    captured = capsys.readouterr()
    assert "item 26" not in captured.err
    assert "0 finding(s) across 1 traced config(s)" in captured.out


def test_torch_cli_select_filters_findings():
    rc, out = _run_main(["--device", "cpu", "--only", "ps_int8_replicated", "--select",
                         "psc101,PSC104", "--format", "json"])
    assert rc == 0 and json.loads(out)["findings"] == []
    assert json.loads(out)["configs"] == ["ps_int8_replicated"]


def test_torch_cli_list_names_registry_configs():
    rc, out = _run_main(["--list"])
    assert rc == 0
    names = out.split()
    for name in ("ps_none_replicated", "ps_int8_2round_sharded", "ps_int8_replicated_bucketed",
                 "ps_resnet18_int8_replicated_bucketed", "dp_tp_pp", "serve_decode",
                 "serve_decode_int8kv"):
        assert name in names


def test_torch_cli_defaults_to_the_card():
    """Without ``--device cpu`` a card-less machine raises, as every entry
    point of the port does."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        check_main(["--only", "ps_int8_replicated"])
