"""The port's overlap tool (ps_pytorch_tpu_torch.tools.overlap_report)
against JAX's tools/overlap_report.py.

- ``trace``: a hand-built kineto-shaped trace (``ProfileWindow``'s
  ``*.pt.trace.json``: GPU lanes by stream, ``gpu_user_annotation``
  ranges) with known intervals gives exact figures: the wire is what runs
  inside a ``bucket_reduce_o<off>`` range on its stream, a kernel on
  another stream during that range is compute, a bucket's own update is
  not overlap and another bucket's is, memsets and unknown kernels are
  skipped. The same intervals as an xprof-shaped trace (named scopes in
  the op names of a TPU lane) give, through JAX's ``run_trace``, the same
  ``overlap_fraction`` and ``per_bucket`` rows. A gzipped capture reads
  the same; a trace without device events is an error (exit 1), never a
  zero.
- ``tape``: the recorded LeNet 64 KiB int8 step at ``--overlap on|off``
  carries the keys of JAX's ``jaxpr`` mode, and both order the schedules
  alike (more headroom, a smaller first-dispatch prefix pipelined).
- ``hlo`` / ``topology`` are refused with the declared deviation.
"""

import argparse
import gzip
import importlib.util
import json
import os

import pytest

from ps_pytorch_tpu_torch.tools import overlap_report, trace_report
from tests.test_torch_one_thread import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAIN, SIDE = 7, 20  # the step's stream and the pipelined wire's side stream

spec = importlib.util.spec_from_file_location("overlap_report",
                                              os.path.join(REPO, "tools", "overlap_report.py"))
joverlap = importlib.util.module_from_spec(spec)
spec.loader.exec_module(joverlap)


def _gpu(cat, name, tid, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": tid, "ts": ts, "dur": dur,
            "args": {"device": 0, "stream": tid}}


def _kineto_events():
    k, a = (lambda *x: _gpu("kernel", *x)), (lambda *x: _gpu("gpu_user_annotation", *x))
    return [
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 99, "tid": 1, "ts": 0,
         "dur": 500},
        k("void at::native::vectorized_elementwise_kernel<4>", MAIN, 0, 100),
        k("sm90_xmma_fprop_implicit_gemm_f32f32", MAIN, 120, 60),
        a("bucket_update_o0", MAIN, 200, 50),
        k("void at::native::unrolled_elementwise_kernel<add>", MAIN, 210, 30),
        a("bucket_update_o4096", MAIN, 260, 20),
        k("void at::native::elementwise_kernel<128, 2>", MAIN, 260, 20),
        _gpu("gpu_memset", "Memset (Device)", MAIN, 290, 5),
        k("void mystery_op<4>", MAIN, 300, 10),
        a("bucket_reduce_o0", SIDE, 50, 100),
        k("absmax_many_kernel", SIDE, 50, 20),
        k("quantize_many_kernel", SIDE, 80, 60),
        a("bucket_reduce_o4096", SIDE, 190, 80),
        k("void at::native::reduce_kernel<512, 1>", SIDE, 195, 70),
        k("void at::native::vectorized_elementwise_kernel<4, copy>", SIDE, 400, 10),
    ]


def _xprof_events():
    """The same intervals as a TPU lane's ops: the scopes in their names."""
    def op(name, ts, dur):
        return {"ph": "X", "pid": 3, "name": name, "ts": ts, "dur": dur}

    return [
        {"ph": "M", "name": "process_name", "pid": 3, "args": {"name": "/device:TPU:0"}},
        op("fusion.1", 0, 100), op("convolution.2", 120, 60),
        op("bucket_update_o0/fusion.3", 210, 30), op("bucket_update_o4096/fusion.4", 260, 20),
        op("barrier-wait", 290, 5), op("copy-start.5", 300, 10),
        op("bucket_reduce_o0", 50, 100), op("bucket_reduce_o0/convert.6", 50, 20),
        op("bucket_reduce_o0/fusion.7", 80, 60), op("bucket_reduce_o4096", 190, 80),
        op("bucket_reduce_o4096/reduce.8", 195, 70), op("fusion.9", 400, 10),
    ]


def _write(path, events, gz=False):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with (gzip.open(path, "wt") if gz else open(path, "w")) as f:
        json.dump({"traceEvents": events}, f)


def test_torch_trace_figures_are_exact(tmp_path):
    _write(str(tmp_path / "steps_2_4_pid1.pt.trace.json"), _kineto_events())
    rep = overlap_report.run_trace(argparse.Namespace(profile_dir=str(tmp_path)))
    assert rep["n_device_events"] == 10
    assert (rep["n_collective_events"], rep["n_compute_events"], rep["n_skipped_events"]) == (
        3, 5, 2)
    # the wire [50, 150) + [190, 270); compute under it 50 + 30 and 30 + 10 us
    assert rep["collective_ms"] == 0.18 and rep["overlapped_ms"] == 0.12
    assert rep["overlap_fraction"] == round(120 / 180, 4)
    assert rep["compute_ms"] == 0.22 and rep["skipped_ms"] == 0.015
    assert rep["per_bucket"] == [
        # bucket 0: the main stream's compute and bucket 4096's update
        {"bucket_offset": 0, "ms": 0.1, "overlapped_ms": 0.08, "overlap_fraction": 0.8},
        # bucket 4096: bucket 0's update counts, its own update does not
        {"bucket_offset": 4096, "ms": 0.08, "overlapped_ms": 0.03, "overlap_fraction": 0.375},
    ]
    assert rep["n_bucket_ranges"] == 2
    assert rep["port_kernels"] == {"absmax_many_kernel": {"launches": 1, "in_bucket_reduce": 1},
                                   "quantize_many_kernel": {"launches": 1,
                                                            "in_bucket_reduce": 1}}
    assert [e["name"] for e in rep["top_skipped_events"]] == ["void mystery_op<4>",
                                                               "Memset (Device)"]


def test_torch_trace_matches_jaxs_run_trace_on_the_same_intervals(tmp_path):
    _write(str(tmp_path / "port" / "steps_2_4_pid1.pt.trace.json.gz"), _kineto_events(), gz=True)
    _write(str(tmp_path / "jax" / "plugins" / "profile" / "r" / "host.trace.json.gz"),
           _xprof_events(), gz=True)
    port = overlap_report.run_trace(argparse.Namespace(profile_dir=str(tmp_path / "port")))
    jax = joverlap.run_trace(argparse.Namespace(profile_dir=str(tmp_path / "jax")))
    assert port["trace_file"].endswith(".gz")
    for key in ("overlap_fraction", "per_bucket", "collective_ms", "overlapped_ms"):
        assert port[key] == jax[key], key
    assert set(jax) <= set(port)


def test_torch_trace_without_device_events_is_an_error(tmp_path, capsys):
    events = [e for e in _kineto_events() if e["cat"] == "cpu_op"]
    _write(str(tmp_path / "steps_1_2_pid1.pt.trace.json"), events)
    assert overlap_report.main(["trace", "--profile-dir", str(tmp_path)]) == 1
    out = json.loads(capsys.readouterr().out)
    assert "no device events" in out["error"] and "overlap_fraction" not in out
    assert trace_report.main(["overlap", "trace", "--profile-dir", str(tmp_path / "none")]) == 1


def test_torch_hlo_and_topology_are_refused(capsys):
    for mode in ("hlo", "topology"):
        assert overlap_report.main([mode]) == 2
        assert "ROADMAP.md" in capsys.readouterr().err


def test_torch_tape_mode_has_jaxs_keys_and_order(capsys):
    args = ["--network", "LeNet", "--dataset", "MNIST", "--batch", "8", "--compress", "int8",
            "--bucket-bytes", "65536"]
    port, jax = {}, {}
    for ov in ("off", "on"):
        assert overlap_report.main(["tape", *args, "--overlap", ov]) == 0
        port[ov] = json.loads(capsys.readouterr().out)
        jax[ov] = joverlap.main(["jaxpr", *args, "--overlap", ov])
        capsys.readouterr()
        assert set(port[ov]) == set(jax[ov])
        assert port[ov]["mode"] == "tape" and port[ov]["overlap"] == ov
    for rep in (port, jax):
        assert rep["on"]["overlap_fraction"] > 0
        assert rep["on"]["overlap_headroom"] > rep["off"]["overlap_headroom"]
        assert rep["on"]["first_dispatch_prefix"] < rep["off"]["first_dispatch_prefix"]
    assert port["on"]["n_collectives"] == port["off"]["n_collectives"]


@pytest.mark.parametrize("gz", [False, True])
def test_torch_find_traces_reads_both_forms(tmp_path, gz):
    name = "steps_1_2_pid3.pt.trace.json" + (".gz" if gz else "")
    _write(str(tmp_path / "a" / name), _kineto_events(), gz=gz)
    (path,) = overlap_report.find_traces(str(tmp_path))
    assert path.endswith(name)
    assert len(overlap_report.load_trace(path)) == len(_kineto_events())


class _Evt:
    """A stand-in for kineto's event: a start, a correlation id, a device."""

    def __init__(self, start_ns, corr, cuda):
        import torch

        self._s, self._c = start_ns, corr
        self._d = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU

    def start_ns(self):
        return self._s

    def correlation_id(self):
        return self._c

    def device_type(self):
        return self._d


def test_torch_session_log_counts_every_capture_and_reads_the_clock(tmp_path):
    """tools/profiler_sessions: every capture is counted (``with`` blocks
    and ``ProfileWindow`` alike), profile's methods are
    restored after, and a kernel placed before its launch reads as a
    negative lag."""
    import torch

    from ps_pytorch_tpu_torch.obs import ProfileWindow
    from ps_pytorch_tpu_torch.tools.profiler_sessions import SessionLog, _clock_lag

    start, stop = torch.profiler.profile.start, torch.profiler.profile.stop
    with SessionLog() as log:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            torch.ones(4).sum()
        w = ProfileWindow(str(tmp_path), 1, 1)
        w.before_step(1)
        torch.ones(4).sum()
        w.before_step(2)
    assert torch.profiler.profile.start is start and torch.profiler.profile.stop is stop
    assert [s["device_events"] for s in log.sessions] == [0, 0]
    assert all(s["host_events"] > 0 for s in log.sessions) and log.nested == []
    host = [_Evt(1_000, 1, False), _Evt(2_000, 2, False)]
    dev = [_Evt(6_000, 1, True), _Evt(1_500, 2, True)]
    assert _clock_lag(dev, host) == {"head_us": 0.5, "lag_us": [-0.5, 5.0, 5.0]}
    assert _clock_lag([], host) == {}
