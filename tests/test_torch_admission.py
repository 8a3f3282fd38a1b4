"""Port parity: ps_pytorch_tpu_torch.serve.admission.AdmissionController
against the JAX package's serve/admission.py.

The same signal sequences (``observe_tick``, ``record_admit``,
``offered``) go to both controllers; every decision, every projected
wait and every ``admission_adapt`` record must be identical, and so must
the counters after the run. The sequences cover entering shedding on a
projected wait, the bounded shed rate, hysteresis on the way out, a
window that closes late after a lull (no rate update), a clock rebased
under the controller, and a random drive. Config validation raises the
same ValueError on both sides.
"""

import numpy as np
import pytest

from ps_pytorch_tpu.serve.admission import AdmissionController as JAdmission
from ps_pytorch_tpu_torch.obs import validate_event
from ps_pytorch_tpu_torch.serve import AdmissionController

STATE = ("shedding", "shed_total", "admitted_total", "windows_closed", "adaptations",
         "_drain_rate", "_clean", "_depth")


def _drive(cls, ops, **kw):
    events = []
    ctl = cls(event_sink=events.append, **kw)
    out = []
    for op in ops:
        kind, t = op[0], op[1]
        if kind == "tick":
            ctl.observe_tick(t, op[2])
        elif kind == "admit":
            ctl.record_admit(t)
        else:
            out.append(ctl.offered(t, op[2]))
    return out, events, {k: getattr(ctl, k) for k in STATE}


def _burst(t0, admits, dt=0.01):
    """A window's worth of admissions, one tick each."""
    ops = []
    for i in range(admits):
        ops += [("tick", t0 + i * dt, 0), ("admit", t0 + i * dt)]
    return ops


def _scenario(name):
    if name == "enter_and_bounded_rate":
        # 10 admits in 0.1 s: 100 req/s; then a queue of 50 projects 0.5 s
        ops = _burst(0.0, 10) + [("tick", 0.1, 0)]
        ops += [("offer", 0.11 + 0.001 * i, 50) for i in range(12)]
        return ops, dict(slo_budget_s=0.3, window_s=0.1, shed_max_frac=0.5)
    if name == "hysteresis":
        ops = _burst(0.0, 10) + [("tick", 0.1, 0)]
        ops += [("offer", 0.11, 60), ("offer", 0.12, 60)]
        t = 0.2
        # windows that keep admitting with a short queue: two clean closes
        # (recover_windows 2) flip back; a dirty one in between resets
        for depth in (2, 40, 2, 2, 2):
            ops += _burst(t, 5, dt=0.015) + [("tick", t + 0.1, depth)]
            ops += [("offer", t + 0.1, depth)]
            t += 0.1
        return ops, dict(slo_budget_s=0.3, window_s=0.1, recover_windows=2)
    if name == "stale_window_after_lull":
        # a window left open through a 5 s lull closes late: its admits
        # must not collapse the rate estimate
        ops = _burst(0.0, 10) + [("tick", 0.1, 0)]
        ops += _burst(0.11, 3) + [("tick", 5.0, 0)]
        ops += [("offer", 5.01 + 0.001 * i, 20) for i in range(5)]
        return ops, dict(slo_budget_s=0.1, window_s=0.1)
    if name == "clock_rebased":
        ops = _burst(100.0, 10) + [("tick", 100.1, 0)]
        # run_open_loop re-zeros the clock: the window restarts
        ops += [("tick", 0.0, 3)] + _burst(0.01, 8) + [("tick", 0.1, 3)]
        ops += [("offer", 0.11 + 0.001 * i, 40) for i in range(6)]
        return ops, dict(slo_budget_s=0.2, window_s=0.1, shed_max_frac=0.9)
    rng = np.random.RandomState(7)
    ops, t = [], 0.0
    for i in range(600):
        t += float(rng.exponential(0.004))
        r = rng.rand()
        # overload and calm in turns of 150 signals
        depth = int(rng.randint(0, 40 if (i // 150) % 2 == 0 else 2))
        if r < 0.4:
            ops.append(("tick", t, depth))
        elif r < 0.7:
            ops.append(("admit", t))
        else:
            ops.append(("offer", t, depth))
    return ops, dict(slo_budget_s=0.05, window_s=0.05, shed_max_frac=0.8,
                     recover_frac=0.4, recover_windows=2)


@pytest.mark.parametrize("name", ["enter_and_bounded_rate", "hysteresis",
                                  "stale_window_after_lull", "clock_rebased", "random"])
def test_torch_admission_decisions_and_records_equal_jax(name):
    ops, kw = _scenario(name)
    got, got_ev, got_state = _drive(AdmissionController, ops, **kw)
    want, want_ev, want_state = _drive(JAdmission, ops, **kw)
    assert got == want
    assert got_ev == want_ev
    assert got_state == want_state
    for e in got_ev:
        validate_event(dict(e))
    sheds = sum(s for s, _ in got)
    if name == "enter_and_bounded_rate":
        # shedding entered at once; at most half a window's submits shed
        assert got_ev[0]["state"] == "shedding" and got[0][1] == pytest.approx(0.5)
        assert sheds == 6 and [s for s, _ in got] == [False, True] * 6
    if name in ("hysteresis", "random"):
        # every exit comes at least recover_windows closes after its entry
        states = [e["state"] for e in got_ev]
        assert states[:2] == ["shedding", "admitting"]
        for enter, leave in zip(got_ev[::2], got_ev[1::2]):
            assert leave["windows"] - enter["windows"] >= kw["recover_windows"]
    if name == "stale_window_after_lull":
        # the pre-lull 100 req/s estimate stands: 20 queued project 0.2 s
        assert got_state["_drain_rate"] == pytest.approx(100.0)
        assert got[0][1] == pytest.approx(0.2) and sheds == 4
    if name == "random":
        assert sheds > 0 and len(got_ev) >= 2


@pytest.mark.parametrize("kw,match", [
    (dict(slo_budget_s=0.0), "slo_budget_s"),
    (dict(slo_budget_s=1.0, window_s=0.0), "window_s"),
    (dict(slo_budget_s=1.0, shed_max_frac=0.0), "shed_max_frac"),
    (dict(slo_budget_s=1.0, shed_max_frac=1.5), "shed_max_frac"),
    (dict(slo_budget_s=1.0, recover_frac=1.0), "recover_frac"),
    (dict(slo_budget_s=1.0, recover_windows=0), "recover_windows"),
])
def test_torch_admission_config_validation_matches_jax(kw, match):
    with pytest.raises(ValueError, match=match) as mine:
        AdmissionController(**kw)
    with pytest.raises(ValueError, match=match) as ref:
        JAdmission(**kw)
    assert str(mine.value) == str(ref.value)


def test_torch_admission_projected_wait_edges_match_jax():
    """No evidence yet and an empty queue project 0; a zero drain rate
    projects the finite cap (valid JSON), as JAX's."""
    for cls in (AdmissionController, JAdmission):
        c = cls(slo_budget_s=1.0, window_s=0.1)
        assert c.projected_wait_s(10) == 0.0
        c.observe_tick(0.0, 0)
        c.record_admit(0.01)
        c.observe_tick(0.1, 5)
        assert c.projected_wait_s(0) == 0.0
        assert c.projected_wait_s(5) == pytest.approx(0.5)
        c._drain_rate = 0.0
        assert c.projected_wait_s(5) == 1e9
