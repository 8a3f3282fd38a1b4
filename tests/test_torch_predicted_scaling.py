"""Port parity: ps_pytorch_tpu_torch.tools.predicted_scaling against the JAX
package's tools/predicted_scaling.py.

The model is JAX's: the port's ``predict()`` gives exactly what JAX's
gives on every row of the committed ``runs/predicted_scaling*.json``
records and on the synthetic rows of tests/test_predicted_scaling.py.
The measurement is the port's own: a PS step recorded at 8 stacked LeNet
workers gives, for each mode, the collective kinds of the port's pscheck
contract (``check/comm_contract.json``), its bytes, and one collective
for each run of a grid-wide collective's host groups; and each (kind,
group, hosts) class the bytes JAX's compiled HLO gives the same step. No figure
defaults: without rates, or on the CPU without ``--t1``, the tool exits 2.
"""

import importlib.util
import json
import os

import pytest

from ps_pytorch_tpu_torch.tools import predicted_scaling as ps
from tests.test_torch_one_thread import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_ps():
    spec = importlib.util.spec_from_file_location(
        "jax_predicted_scaling_under_test", os.path.join(REPO, "tools", "predicted_scaling.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def contract():
    with open(ps.CONTRACT) as f:
        return json.load(f)


def _record(name):
    with open(os.path.join(REPO, "runs", name)) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["predicted_scaling.json", "predicted_scaling_dcn25gbps.json"])
def test_torch_predict_equals_jax_on_the_committed_rows(jax_ps, name):
    rec = _record(name)
    m = rec["model"]
    t1, bw, dcn = m["t1_seconds"], m["ici_gbs_one_way"] * 1e9, m["dcn_gbs_per_host"] * 1e9
    assert rec["rows"]
    for row in rec["rows"]:
        for dcn_bw in (dcn, None):
            assert ps.predict(row, t1, bw, dcn_bw=dcn_bw) == jax_ps.predict(
                row, t1, bw, dcn_bw=dcn_bw)
        assert ps.predict(row, t1, bw, dcn_bw=dcn) == row  # the record's own numbers


def _cls(kind, g, h, nbytes):
    return {f"{kind}|g{g}|h{h}": {"kind": kind, "g": g, "h": h, "count": 1, "bytes": nbytes}}


# tests/test_predicted_scaling.py's rows and arguments
SYNTHETIC = {
    "flat_bounds": ({"workers": 8, "mode": "none", "hosts": 1,
                     "by_kind": {"all-reduce": {"count": 1, "bytes": 44_700_000}},
                     "total_collective_bytes": 44_700_000, "n_collectives": 1},
                    (0.067, 45e9), {}),
    "flat_crosshost": ({"workers": 16, "mode": "none", "hosts": 1, "per_host_model": 8,
                        "by_kind": {"all-reduce": {"count": 1, "bytes": 44_700_000}},
                        "by_class": _cls("all-reduce", 16, 2, 44_700_000),
                        "total_collective_bytes": 44_700_000, "n_collectives": 1},
                       (0.067, 45e9), {"dcn_bw": 12.5e9}),
    "hier_dcn_stage": ({"workers": 32, "mode": "hier_2round", "hosts": 4, "per_host_model": 8,
                        "by_kind": {"all-to-all": {"count": 1, "bytes": 1_000_000},
                                    "reduce-scatter": {"count": 1, "bytes": 8_000_000}},
                        "by_class": {**_cls("all-to-all", 4, 4, 1_000_000),
                                     **_cls("reduce-scatter", 8, 1, 8_000_000)},
                        "total_collective_bytes": 9_000_000, "n_collectives": 2},
                       (0.067, 45e9), {"dcn_bw": 12.5e9}),
    "crosshost_ici_bound": ({"workers": 16, "mode": "none", "hosts": 1, "per_host_model": 8,
                             "by_kind": {"all-reduce": {"count": 1, "bytes": 44_700_000}},
                             "by_class": _cls("all-reduce", 16, 2, 44_700_000),
                             "total_collective_bytes": 44_700_000, "n_collectives": 1},
                            (0.067, 45e9), {"dcn_bw": 50e9}),
    "legacy": ({"workers": 8, "mode": "none", "hosts": 1,
                "by_kind": {"all-reduce": {"count": 1, "bytes": 10_000_000}},
                "total_collective_bytes": 10_000_000, "n_collectives": 1},
               (0.067, 45e9), {"dcn_bw": 12.5e9}),
    "unknown_kind": ({"workers": 4, "mode": "none", "hosts": 1,
                      "by_kind": {"mystery-op": {"count": 1, "bytes": 1_000_000}},
                      "total_collective_bytes": 1_000_000, "n_collectives": 1},
                     (0.1, 1e9), {}),
}


@pytest.mark.parametrize("case", sorted(SYNTHETIC))
def test_torch_predict_equals_jax_on_the_synthetic_rows(jax_ps, case):
    row, args, kw = SYNTHETIC[case]
    assert ps.predict(row, *args, **kw) == jax_ps.predict(row, *args, **kw)


def test_torch_ring_factors_and_names_are_jax_s(jax_ps):
    assert ps.MODES == jax_ps.MODES
    assert ps.MODE_CONTRACT_CONFIG == jax_ps.MODE_CONTRACT_CONFIG
    assert ps._JAXPR_TO_HLO_KIND == jax_ps._JAXPR_TO_HLO_KIND
    for kind, f in jax_ps._RING_FACTOR.items():
        assert [ps._RING_FACTOR[kind](g) for g in (2, 4, 8, 32)] == [f(g) for g in (2, 4, 8, 32)]


@pytest.mark.parametrize("mode", list(ps.MODES))
def test_torch_recorded_rows_hold_the_contract_kinds(mode, contract):
    row = ps.record_row(8, mode, "LeNet", 1, "cpu")
    check = ps.contract_cross_check([row], contract)
    assert check["ok"] and check["results"][0]["ok"], check
    cfg = contract["configs"][ps.MODE_CONTRACT_CONFIG[mode]]
    hosts = ps.hosts_for(8, mode)
    # the tape's per-device bytes are the contract's, the kinds JAX's
    # names; an all-gather's are its result's, g operand shares
    assert row["total_collective_bytes"] == sum(
        c["bytes"] * (ps.group_of(tuple(c["axes"]), 8, hosts)[0]
                      if c["kind"] == "all_gather" else 1) for c in cfg["collectives"])
    assert row["hosts"] == hosts and row["per_host_model"] == (4 if hosts > 1 else 8)
    if hosts == 1:
        assert row["n_collectives"] == cfg["n_collectives"]
        assert set(row["by_class"]) <= {f"{k}|g8|h1" for k in row["by_kind"]}
        return
    # the grouped scale pmaxes: one collective a run of host groups
    pmax = {tuple(c["axes"]): c["count"] for c in cfg["collectives"] if c["kind"] == "pmax"}
    assert row["by_class"]["all-reduce|g4|h1"]["count"] == pmax[("workers",)] // hosts
    assert row["by_class"]["all-reduce|g2|h2"]["count"] == pmax[("dcn",)] // 4
    assert row["n_collectives"] == cfg["n_collectives"] - (
        pmax[("workers",)] - pmax[("workers",)] // hosts) - (pmax[("dcn",)] - pmax[("dcn",)] // 4)
    assert row["kernel_nodes"] == {"K2:quantize_tensors": 3}


@pytest.fixture(scope="module")
def jax_rows(jax_ps):
    """JAX's tool's rows for LeNet at 8 workers, batch 1 a worker, from its
    compiled HLO (its child, with overlap_report's step-builder defaults it
    leaves out: no bucketing, serial)."""
    import argparse
    import contextlib
    import io

    import tools.overlap_report as orep

    build = orep._build_step

    def with_defaults(args, mesh, dcn_hosts=1):
        args.bucket_bytes, args.overlap = -1, "off"
        return build(args, mesh, dcn_hosts=dcn_hosts)

    rows = {}
    orep._build_step = with_defaults
    try:
        for mode in ps.MODES:
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                jax_ps.child(argparse.Namespace(one_workers=8, one_mode=mode,
                                                network="LeNet", batch=1))
            rows[mode] = json.loads(out.getvalue().strip().splitlines()[-1])
    finally:
        orep._build_step = build
    return rows


@pytest.mark.parametrize("mode", list(ps.MODES))
def test_torch_recorded_bytes_are_jax_s(mode, jax_rows):
    # every (kind, g, h) class carries the bytes JAX's HLO gives it (an
    # all-gather its result, g times the tape's operand share), so the
    # ring factors price the same buffers; counts differ where XLA
    # combines collectives
    row = ps.record_row(8, mode, "LeNet", 1, "cpu")
    want = jax_rows[mode]
    assert (row["hosts"], row["per_host_model"]) == (want["hosts"], want["per_host_model"])
    assert {k: c["bytes"] for k, c in row["by_class"].items()} == {
        k: c["bytes"] for k, c in want["by_class"].items()}
    assert {k: c["bytes"] for k, c in row["by_kind"].items()} == {
        k: c["bytes"] for k, c in want["by_kind"].items()}


def test_torch_group_layout_is_jax_s():
    # flat: one group of n over ceil(n / 8) hosts; hier: ICI in a host,
    # DCN one card a host, the tuple axis all n
    assert ps.group_of(("workers",), 16, 1) == (16, 2)
    assert ps.group_of(("workers",), 8, 1) == (8, 1)
    assert ps.group_of(("workers",), 32, 4) == (8, 1)
    assert ps.group_of(("dcn",), 32, 4) == (4, 4)
    assert ps.group_of(("dcn", "workers"), 32, 4) == (32, 4)
    assert [ps.hosts_for(n, "hier_2round") for n in (8, 16, 32)] == [2, 2, 4]


def test_torch_predicted_scaling_runs_on_the_cpu_with_given_figures(tmp_path, capsys):
    out = tmp_path / "ps.json"
    rep = ps.main(["--device", "cpu", "--network", "LeNet", "--workers", "8", "--modes",
                   "none", "int8", "--t1", "0.01", "--ici-gbs", "450", "--dcn-gbs", "50",
                   "--out", str(out)])
    assert json.loads(out.read_text()) == rep
    assert set(rep) == {"contract_check", "model", "rows", "failures"}
    assert rep["contract_check"]["ok"] and not rep["failures"]
    m = rep["model"]
    assert (m["t1_seconds"], m["ici_gbs_one_way"], m["dcn_gbs_per_host"]) == (0.01, 450, 50)
    assert {m["t1_source"], m["ici_source"], m["dcn_source"]} == {
        "given: --t1", "given: --ici-gbs", "given: --dcn-gbs"}
    assert [(r["workers"], r["mode"]) for r in rep["rows"]] == [(8, "none"), (8, "int8")]
    assert rep["rows"][1]["kernel_nodes"] == {"K2:quantize_tensors": 1}
    assert "eff (no ov)" in capsys.readouterr().out

    prof = tmp_path / "prof.json"
    prof.write_text(json.dumps({"name": "given card", "ici_gbs": 450.0, "dcn_gbs": 50.0,
                                "collective_launch_s": 1e-5, "op_cost_s": 1e-6}))
    rep = ps.main(["--device", "cpu", "--network", "LeNet", "--workers", "8", "--modes",
                   "none", "--t1", "0.01", "--profile", str(prof), "--dcn-gbs", "25"])
    assert (rep["model"]["ici_gbs_one_way"], rep["model"]["dcn_gbs_per_host"]) == (450, 25)
    assert rep["model"]["ici_source"].startswith("profile ")
    assert rep["model"]["dcn_source"] == "given: --dcn-gbs"


def test_torch_predicted_scaling_fails_on_a_row_that_failed_to_record(monkeypatch):
    def broken(*args):
        raise RuntimeError("kernel failed to launch")

    monkeypatch.setattr(ps, "record_row", broken)
    rep = ps.main(["--device", "cpu", "--network", "LeNet", "--workers", "2", "--modes",
                   "int8", "hier_2round", "--t1", "0.01", "--ici-gbs", "450", "--dcn-gbs", "50"])
    assert [f["mode"] for f in rep["failures"]] == ["int8", "hier_2round"]
    assert ps.exit_code(rep) == 1
    # hier's skip below 4 cards alone is no failure
    rep["failures"] = rep["failures"][1:]
    assert rep["failures"][0]["error"].startswith(ps.SKIP) and ps.exit_code(rep) == 0
    rep["contract_check"] = {"ok": False, "results": []}
    assert ps.exit_code(rep) == 1


@pytest.mark.parametrize("argv, missing", [
    (["--t1", "0.1"], "--ici-gbs, --dcn-gbs"),
    (["--t1", "0.1", "--dcn-gbs", "50"], "--ici-gbs"),
    (["--ici-gbs", "450", "--dcn-gbs", "50"], "--t1"),
])
def test_torch_predicted_scaling_has_no_default_figure(argv, missing, capsys):
    with pytest.raises(SystemExit) as e:
        ps.main(["--device", "cpu", "--network", "LeNet", "--workers", "8"] + argv)
    assert e.value.code == 2
    assert missing in capsys.readouterr().err
