"""The port's span front end against the JAX package's
(ps_pytorch_tpu_torch.obs.trace.chrome_trace_events,
ps_pytorch_tpu_torch.tools.trace_report, tools/window_report).

- ``chrome_trace_events`` gives JAX's dicts for the same header and spans
  (sync and async spans, an explicit pid and wall base).
- On one directory of streams (JAX ``Tracer`` streams of train and serve,
  a rerun appended to one file, and a ``cli.train --device cpu --trace``
  run of the port) and one metrics overlay, the port's tool and JAX's
  ``tools/trace_report.py`` give the same merged Chrome JSON and summary,
  byte for byte in the files they write; the ``--require-phases`` gate
  and the ``spans_dropped`` refusal agree, as do ``check_nesting`` and
  ``load_stream``.
- The ``window`` subcommand prints what JAX's ``tools/window_report.py``
  prints for the same records.
"""

import importlib.util
import json
import os
import time

import numpy as np
import pytest

from ps_pytorch_tpu.obs import Tracer as JTracer
from ps_pytorch_tpu.obs import chrome_trace_events as j_chrome
from ps_pytorch_tpu.trainer import append_metrics_line
from ps_pytorch_tpu_torch.cli import train as cli_train
from ps_pytorch_tpu_torch.obs import chrome_trace_events
from ps_pytorch_tpu_torch.tools import trace_report, window_report
from tests.test_torch_one_thread import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jtrace_report = _tool("trace_report")
jwindow_report = _tool("window_report")


def test_torch_chrome_trace_events_are_jaxs():
    rng = np.random.default_rng(0)
    t = JTracer("serve", pid=3)
    spans = []
    for i in range(12):
        s = {"kind": "span", "name": f"p{i % 3}", "cat": "phase",
             "t": float(rng.uniform(0, 5)), "dur": float(rng.uniform(0, 1)), "depth": i % 2,
             "step": i}
        if i % 4 == 0:
            s.update({"async": True, "slot": int(rng.integers(-1, 4))})
        spans.append(s)
    spans.append({"kind": "meta", "name": "ignored", "t": 0.0, "dur": 0.0})
    for pid in (None, 7):
        for t0 in (0.0, t.header["t_wall"] - 2.5):
            assert chrome_trace_events(t.header, spans, pid=pid, t0_wall=t0) == j_chrome(
                t.header, spans, pid=pid, t0_wall=t0)


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """A trace directory: JAX streams (train, serve, a rerun appended to
    the train file) and a port ``cli.train`` run's stream; a metrics
    overlay from the port run."""
    tmp = tmp_path_factory.mktemp("spans")
    d = tmp / "trace"
    d.mkdir()
    for run in range(2):
        t = JTracer("train", path=str(d / "trace_train_p0.jsonl"), pid=0)
        for step in (1, 2):
            with t.span("fetch", step=step):
                with t.span("h2d", step=step):
                    time.sleep(0.001)
            with t.span("dispatch", step=step + 2 * run):
                pass
        t.flush()
    s = JTracer("serve", path=str(d / "trace_serve_p0.jsonl"), pid=0)
    with s.span("decode_dispatch", tick=1):
        pass
    s.add("request", s.now() - 0.002, 0.002, cat="request", slot=1, rid=5)
    s.flush()
    metrics = tmp / "m.jsonl"
    append_metrics_line(str(metrics), {"kind": "grad_skip", "step": 2, "skipped_steps": 1,
                                       "skip_streak": 1})
    port = tmp / "port"
    cli_train.main(["--device", "cpu", "--network", "LeNet", "--num-workers", "2",
                    "--batch-size", "4", "--max-steps", "3", "--log-interval", "1",
                    "--eval-freq", "0", "--no-checkpoints", "--trace", str(port),
                    "--metrics-file", str(tmp / "port.jsonl")])
    for f in os.listdir(port):
        os.rename(port / f, d / f.replace("trace_train", "trace_porttrain"))
    return d, [str(metrics), str(tmp / "port.jsonl")]


def test_torch_merge_is_jaxs_on_the_same_streams(streams):
    d, metrics = streams
    files = trace_report.discover([str(d)])
    assert files == jtrace_report.discover([str(d)]) and len(files) == 3
    got = trace_report.merge(files, metrics)
    want = jtrace_report.merge(files, metrics)
    assert got == want
    trace, summary = got
    assert summary["nesting_ok"] and summary["n_overlay_events"] == 1
    assert {"fetch", "h2d", "dispatch", "decode_dispatch", "request"} <= set(summary["phases"])
    assert len({e["pid"] for e in trace["traceEvents"] if e.get("ph") == "X"}) == 4


def test_torch_main_writes_jaxs_files(streams, tmp_path, capsys):
    d, metrics = streams
    outs = {}
    for name, tool in (("port", trace_report), ("jax", jtrace_report)):
        out, sout = tmp_path / f"{name}.json", tmp_path / f"{name}_summary.json"
        argv = [str(d), "--out", str(out), "--summary-out", str(sout),
                "--require-phases", "fetch,dispatch,decode_dispatch"]
        for m in metrics:
            argv += ["--metrics", m]
        assert tool.main(argv) == 0
        outs[name] = (out.read_bytes(), sout.read_bytes(), capsys.readouterr().out)
    assert outs["port"] == outs["jax"]


def test_torch_require_phases_gate_is_jaxs(streams, tmp_path, capsys):
    d, _ = streams
    for tool in (trace_report, jtrace_report):
        assert tool.main([str(d), "--require-phases", "fetch,ckpt_save"]) == 1
        assert "ckpt_save" in capsys.readouterr().err
    # a ring that evicted spans leaves a spans_dropped marker: the gate refuses
    t = JTracer("train", path=str(tmp_path / "trace_small_p0.jsonl"), ring=2)
    for step in range(5):
        with t.span("fetch", step=step):
            pass
    t.flush()
    for tool in (trace_report, jtrace_report):
        assert tool.main([str(tmp_path), "--require-phases", "fetch"]) == 1
        assert "spans_dropped" in capsys.readouterr().err


def test_torch_nesting_and_segments_are_jaxs(streams):
    d, _ = streams
    rng = np.random.default_rng(1)
    for _ in range(50):
        spans = [{"t": float(a), "dur": float(b)} for a, b in rng.uniform(0, 1, (6, 2))]
        spans[0]["async"] = bool(rng.integers(2))
        assert trace_report.check_nesting(spans) == jtrace_report.check_nesting(spans)
    path = str(d / "trace_train_p0.jsonl")
    segs = trace_report.load_stream(path)
    assert segs == jtrace_report.load_stream(path) and len(segs) == 2


def test_torch_headerless_stream_is_refused_as_jax_does(tmp_path):
    p = tmp_path / "trace_bad.jsonl"
    p.write_text('{"kind": "span", "name": "x", "t": 0, "dur": 1}\n')
    empty = tmp_path / "trace_empty.jsonl"
    empty.write_text("")
    for tool in (trace_report, jtrace_report):
        with pytest.raises(SystemExit, match="run_header"):
            tool.merge([str(p)], [])
        with pytest.raises(SystemExit, match="no run_header"):
            tool.merge([str(empty)], [])


def test_torch_window_subcommand_prints_jaxs_table(tmp_path, capsys):
    recs = {
        "bench_resnet18.json": {"metric": "images_per_sec", "value": 1234.5, "unit": "img/s",
                                "vs_baseline": 1.1, "mfu": 0.3, "timestamp": "t"},
        "bench_broken.json": {"metric": "tokens_per_sec", "value": None, "error": "boom"},
        "overlap_trace.json": {"mode": "trace", "overlap_fraction": 0.25,
                               "collective_ms": 2.0, "overlapped_ms": 0.5,
                               "n_skipped_events": 3},
        "overlap_topology.json": {"error": "no topology"},
    }
    for name, rec in recs.items():
        (tmp_path / name).write_text(json.dumps(rec))
    (tmp_path / "bench_unreadable.json").write_text("{")
    assert trace_report.main(["window", str(tmp_path)]) == 0
    got = capsys.readouterr().out
    assert jwindow_report.main(str(tmp_path)) == 0
    assert got == capsys.readouterr().out
    assert window_report.main(str(tmp_path / "none")) == 0
    assert "no bench_*.json" in capsys.readouterr().out
