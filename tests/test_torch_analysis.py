"""The port's analysis scripts against the JAX package's
(ps_pytorch_tpu_torch.analysis.speedup, .scaling_bench).

- ``speedup``: the same logs give the same table and JSON as
  analysis/speedup.py, for the port's iteration lines, the JAX package's
  and the reference's (several workers a step, other text around them),
  with ``--baseline`` and ``--max-step``.
- ``scaling_bench``: weak and ``--strong`` runs of LeNet at 1 and 2
  stacked workers on the CPU carry the record and row keys of JAX's
  analysis/scaling_bench.py (its two-point run on the 8-device CPU mesh),
  finite throughput and a first row of speedup 1.
"""

import json

import numpy as np

from analysis import scaling_bench as jscaling
from analysis import speedup as jspeedup
from ps_pytorch_tpu.utils import format_iter_line as jformat
from ps_pytorch_tpu_torch.analysis import scaling_bench, speedup
from ps_pytorch_tpu_torch.utils import format_iter_line
from tests.test_torch_one_thread import _one_thread  # noqa: F401


def _write_log(path, worker_times, fmt, losses=None, prefix="INFO: "):
    with open(path, "w") as f:
        for i, (step, times) in enumerate(worker_times.items()):
            for w, t in enumerate(times):
                loss = losses[i] if losses else 2.0
                f.write(prefix + fmt(rank=w, step=step, epoch=1, seen=step * 8, total=100,
                                     loss=loss, time_cost=t) + "\n")
            f.write("some other line, Step: 3\n")


def _reference_line(rank, step, epoch, seen, total, loss, time_cost):
    """The reference's worker line (its trainer's print): the same fields."""
    return (f"Worker: {rank}, Step: {step}, Epoch: {epoch} [{seen}/{total} "
            f"({100.0 * seen / total:.0f}%)], Loss: {loss:.4f}, Time Cost: {time_cost:.4f}, "
            f"FetchWeight: 0.0010, Forward: 0.0200, Backward: 0.0300, Comm Cost: 0.0040")


def test_torch_speedup_table_is_jaxs_on_every_line_format(tmp_path, capsys):
    rng = np.random.default_rng(0)
    logs = []
    for name, fmt in (("port", format_iter_line), ("jax", jformat), ("ref", _reference_line)):
        for workers in (1, 2, 4):
            times = {s: list(rng.uniform(0.1, 1.0, workers)) for s in range(1, 13)}
            path = tmp_path / f"{name}_w{workers}.log"
            _write_log(path, times, fmt, losses=list(rng.uniform(1, 3, 12)),
                       prefix="" if name == "ref" else "INFO: ")
            logs.append(str(path))
    runs = [speedup.parse_log(p) for p in logs]
    jruns = [jspeedup.parse_log(p) for p in logs]
    for r, j in zip(runs, jruns):
        assert (r.steps, r.losses, r.total_normal, r.total_ideal, r.mean_loss) == (
            j.steps, j.losses, j.total_normal, j.total_ideal, j.mean_loss)
    assert speedup.speedups(runs, runs[2]) == jspeedup.speedups(jruns, jruns[2])
    outs = []
    for argv in ([*logs, "--json"], [*logs, "--baseline", logs[4], "--max-step", "7"],
                 [logs[0], logs[1], "--baseline", str(tmp_path / "port_w4.log")]):
        got = speedup.main(argv)
        outs.append(capsys.readouterr().out)
        assert got == jspeedup.main(argv)
        assert outs[-1] == capsys.readouterr().out
    assert [r["log"] for r in json.loads(outs[0])] == logs


def test_torch_scaling_bench_has_jaxs_record(capsys):
    jax_rec = jscaling.main(["--network", "LeNet", "--batch-size", "4", "--workers", "1", "2",
                             "--steps", "1"])
    for extra in ([], ["--strong"]):
        rec = scaling_bench.main(["--device", "cpu", "--network", "LeNet", "--batch-size", "4",
                                  "--workers", "1", "2", "--steps", "1",
                                  *extra])
        assert set(jax_rec) <= set(rec)
        assert rec["platform"] == "cpu" and rec["card"] is None
        assert rec["workers_in_turn_on_one_device"] is True
        assert rec["mode"] == ("strong" if extra else "weak")
        assert [r["per_worker_batch"] for r in rec["rows"]] == ([4, 2] if extra else [4, 4])
        for row, jrow in zip(rec["rows"], jax_rec["rows"]):
            assert set(jrow) <= set(row)
            assert np.isfinite(row["images_per_sec"]) and np.isfinite(row["final_loss"])
        assert rec["rows"][0]["speedup_vs_first"] == 1.0
    capsys.readouterr()
