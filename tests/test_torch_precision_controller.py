"""Port parity: the adaptive controllers' host halves
(ps_pytorch_tpu_torch.resilience.elastic.AdaptiveMaskController and
resilience.precision.PrecisionController) against the JAX package's,
fed the same walltime and ``bucket_sqnorm`` sequences: the same counts,
tags, effective bytes and records, every record valid under the port's
``obs/schema.py``. Then their consensus over two gloo processes
(``Trainer._count_consensus`` / ``_tags_consensus``: the min over the
processes, in int32), with each process observing something else.
"""

import sys
import types

import numpy as np
import pytest

from ps_pytorch_tpu.parallel import PSConfig as JPSConfig
from ps_pytorch_tpu.parallel.ps import precision_hi_peak as jhi_peak
from ps_pytorch_tpu.parallel.ps import state_plan as jstate_plan
from ps_pytorch_tpu.resilience.elastic import AdaptiveMaskController as JMask
from ps_pytorch_tpu.resilience.precision import PrecisionController as JPrecision
from ps_pytorch_tpu.resilience.precision import effective_wire_bytes as jeffective
from ps_pytorch_tpu_torch.obs import validate_event
from ps_pytorch_tpu_torch.parallel.ps import PSConfig, precision_hi_peak, state_plan
from ps_pytorch_tpu_torch.resilience.elastic import AdaptiveMaskController
from ps_pytorch_tpu_torch.resilience.precision import PrecisionController, effective_wire_bytes
from tests.test_torch_distributed import _spawn
from tools.mp_util import free_port


@pytest.mark.parametrize("kw", [
    dict(compress="int8"), dict(compress="int8", wire_domain="homomorphic"),
    dict(compress="int8_2round"), dict(compress="int8", num_workers=300),
])
def test_torch_precision_hi_peak_and_plan_match_jax(kw):
    kw = dict(dict(num_workers=8, bucket_bytes=65536, precision_adapt=True), **kw)
    t, j = PSConfig(**kw), JPSConfig(**kw)
    assert precision_hi_peak(t) == jhi_peak(j)
    assert state_plan(t, 431080).sizes == jstate_plan(j, 431080).sizes


@pytest.mark.parametrize("window,init", [(1, None), (3, 5), (4, None)])
def test_torch_mask_controller_matches_jax(window, init):
    kw = dict(num_workers=8, num_aggregate_min=3, num_aggregate_max=7, num_aggregate=init)
    recs_t, recs_j = [], []
    t = AdaptiveMaskController(PSConfig(**kw), 0.5, window, event_sink=recs_t.append)
    j = JMask(JPSConfig(**kw), 0.5, window, event_sink=recs_j.append)
    times = np.random.RandomState(window).choice([0.1, 0.2, 0.9, 1.4], size=60,
                                                 p=[0.4, 0.3, 0.2, 0.1])
    for step, s in enumerate(times, start=2):
        assert t.record(step, float(s)) == j.record(step, float(s))
    assert t.adaptations == j.adaptations >= 2
    assert recs_t == recs_j
    for rec in recs_t:
        assert validate_event(dict(rec))["kind"] == "mask_adapt"


def test_torch_mask_controller_refusals_match_jax():
    for kw, thr, win in ((dict(num_workers=8), 0.5, 2),
                         (dict(num_workers=8, num_aggregate_min=2, num_aggregate_max=4), None, 2),
                         (dict(num_workers=8, num_aggregate_min=2, num_aggregate_max=4), 0.5, 0)):
        for cfg, cls in ((PSConfig(**kw), AdaptiveMaskController), (JPSConfig(**kw), JMask)):
            with pytest.raises(ValueError):
                cls(cfg, thr, win)


def _sqnorm_stream(n_buckets, steps, seed):
    """Per-bucket squared norms spanning the ladder's rungs, drifting, with
    one non-finite step."""
    rng = np.random.RandomState(seed)
    base = 10.0 ** rng.uniform(-11, 1, size=n_buckets)
    rows = []
    for i in range(steps):
        row = base * np.exp(rng.randn(n_buckets) * 0.05) * (1 + (i > steps // 2) * 3 *
                                                              (np.arange(n_buckets) % 3 == 0))
        rows.append(row.astype(np.float32))
    rows[steps // 3][1] = np.nan
    return rows


@pytest.mark.parametrize("compress,domain", [("int8", "dequant"), ("int8", "homomorphic"),
                                             ("int8_2round", "homomorphic")])
@pytest.mark.parametrize("budget_frac", [None, 0.6, 0.01])
def test_torch_precision_controller_matches_jax(compress, domain, budget_frac):
    kw = dict(num_workers=8, compress=compress, wire_domain=domain, bucket_bytes=4096,
              precision_adapt=True)
    t_cfg, j_cfg = PSConfig(**kw), JPSConfig(**kw)
    sizes = state_plan(t_cfg, 20000).sizes
    assert sizes == jstate_plan(j_cfg, 20000).sizes and len(sizes) >= 4
    static = effective_wire_bytes([2] * len(sizes), sizes, precision_hi_peak(t_cfg))
    budget = None if budget_frac is None else int(budget_frac * static)
    recs_t, recs_j = [], []
    t = PrecisionController(t_cfg, sizes, 2, budget_bytes=budget, event_sink=recs_t.append)
    j = JPrecision(j_cfg, sizes, 2, budget_bytes=budget, event_sink=recs_j.append)
    assert t.static_int8_bytes == j.static_int8_bytes == static
    for step, row in enumerate(_sqnorm_stream(len(sizes), 40, len(sizes)), start=1):
        np.testing.assert_array_equal(t.record(step, row), j.record(step, row))
        assert t.effective_bytes() == j.effective_bytes()
    assert t.adaptations == j.adaptations >= 1
    assert recs_t == recs_j
    for rec in recs_t:
        assert validate_event(dict(rec))["kind"] == "precision_adapt"
    tags = np.random.RandomState(1).randint(0, 4, size=len(sizes))
    for hi in (127, 4095, 32767, 40000):
        assert effective_wire_bytes(tags, sizes, hi) == jeffective(tags, sizes, hi)


# ------------------------------------------------------------- consensus


def _child_consensus(rank, port, out_path):
    """One of two processes: the trainer's consensus points over gloo,
    and both controllers closing their windows with them, each process
    seeing its own walltimes and telemetry."""
    import json

    import torch.distributed as dist

    from ps_pytorch_tpu_torch.parallel.mesh import ProcessWorkerAxis
    from ps_pytorch_tpu_torch.trainer import Trainer

    rank = int(rank)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    try:
        host = types.SimpleNamespace(mesh=ProcessWorkerAxis(4))
        count = Trainer._count_consensus(host, [6, 3][rank])
        tags = Trainer._tags_consensus(host, np.array([[3, 1, 2, 0], [2, 2, 3, 1]][rank]))
        kw = dict(num_workers=4, num_aggregate_min=1, num_aggregate_max=4, compress="int8",
                  bucket_bytes=4096, precision_adapt=True)
        cfg = PSConfig(**kw)
        mask = AdaptiveMaskController(cfg, 0.5, 2, consensus=lambda c: Trainer._count_consensus(
            host, c))
        sizes = state_plan(cfg, 9000).sizes
        prec = PrecisionController(cfg, sizes, 1, consensus=lambda v: Trainer._tags_consensus(
            host, v))
        counts, tag_rows = [], []
        for step in range(2, 14):
            slow = rank == 1 and step in (4, 5)
            counts.append(mask.record(step, 0.9 if slow else 0.1))
            row = np.full(len(sizes), 1.0, np.float32)
            row[rank] = 1e-12  # each process sees another quiet bucket
            tag_rows.append(prec.record(step, row).tolist())
        with open(out_path, "w") as f:
            json.dump({"count": count, "tags": tags.tolist(), "dtype": str(tags.dtype),
                       "counts": counts, "tag_rows": tag_rows}, f)
    finally:
        dist.destroy_process_group()


def test_torch_consensus_is_the_min_over_two_processes(tmp_path):
    import json

    port = free_port()
    paths = [str(tmp_path / f"r{r}.json") for r in range(2)]
    _spawn([[sys.executable, "-c",
             "import sys; from tests.test_torch_precision_controller import _child_consensus "
             "as c; c(*sys.argv[1:])", str(r), str(port), paths[r]] for r in range(2)])
    a, b = (json.load(open(p)) for p in paths)
    assert a["count"] == b["count"] == 3
    assert a["tags"] == b["tags"] == [2, 1, 2, 0] and a["dtype"] == "int32"
    # the slow steps of process 1 shrink both processes' count alike
    assert a["counts"] == b["counts"] and min(a["counts"]) < 4
    # each process would skip its own quiet bucket; both adopt both skips
    assert a["tag_rows"] == b["tag_rows"]
    assert a["tag_rows"][-1][:2] == [0, 0]
