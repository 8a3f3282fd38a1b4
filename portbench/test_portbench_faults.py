"""A whole run of a tiny cell on the CPU (the harness's look for a card
skipped) with the timed path broken underneath: ``correct`` has to come
out false, under the cell's own limits. And the sound run beside it,
and the control, read as the limits expect (CPU only)."""

import pytest
import torch

from portbench import run
from portbench.harness import compare
from portbench.tiny import tiny_cell

from ps_pytorch_tpu_torch.parallel import ps as ps_module
from ps_pytorch_tpu_torch.parallel.buckets import tree_map

SEED = 2 ** 31 + 77


@pytest.fixture(autouse=True)
def _few_threads():
    held = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(held)


# --- the PS step (Trainer._train_step: (state, batch, **kw) -> (state, metrics))


def ps_unchanged(step):
    def broken(state, batch, **kw):
        return state, step(state, batch, **kw)[1]
    return broken


def ps_half(step):
    def broken(state, batch, **kw):
        n = 3  # the tiny cell's workers
        half = {k: v.reshape((n, -1) + tuple(v.shape[1:]))[:, : v.shape[0] // n // 2]
                .reshape((-1,) + tuple(v.shape[1:])) for k, v in batch.items()}
        return step(state, half, **kw)
    return broken


# --- the LM step (run(params, opt, tokens) -> (params, opt, loss, aux))


def lm_unchanged(step):
    def broken(p, o, tok):
        out = step(p, o, tok)
        return p, o, out[2], out[3]
    return broken


def lm_half(step):
    return lambda p, o, tok: step(p, o, tok[: tok.shape[0] // 2])


def _run(kind, wrap=None):
    return run.execute(tiny_cell(kind), SEED, 2.5, False, device="cpu", wrap_step=wrap)


@pytest.mark.parametrize("kind,wrap", [
    ("ps", ps_unchanged), ("ps", ps_half), ("lm", lm_unchanged), ("lm", lm_half),
    ("lm_bf16", lm_unchanged), ("lm_bf16", lm_half)],
    ids=["ps-unchanged", "ps-half", "lm-unchanged", "lm-half", "lm_bf16-unchanged",
         "lm_bf16-half"])
def test_a_broken_step_is_not_correct(kind, wrap):
    out = _run(kind, wrap)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_ps_without_the_exchange_is_not_correct(monkeypatch):
    """Every worker's gradient replaced by worker 0's before the wire:
    what one worker alone would send, none of the others'."""
    real = ps_module.aggregate_gradients

    def alone(grads, axis, n, **kw):
        return real(tree_map(lambda g: g[:1].expand_as(g).contiguous(), grads), axis, n, **kw)

    monkeypatch.setattr(ps_module, "aggregate_gradients", alone)
    out = _run("ps")
    assert out["correct"] is False


@pytest.mark.parametrize("kind", ["lm", "lm_bf16"])
def test_a_sound_lm_run_is_correct(kind):
    assert _run(kind)["correct"] is True


@pytest.mark.parametrize("kind", ["ps", "lm", "lm_bf16"])
def test_the_control_fails_the_cells_limits(kind):
    """The reference in the next precision below the cell's (bf16 for
    ResNet18's TF32 convolutions, TF32 for f32, fp8 for bf16), in the
    program's place, fails the cell's limits."""
    from portbench.harness import spec

    cell = tiny_cell(kind)
    limits = spec.load_json(f"{spec.PORTBENCH}/limits/{cell.name}.json")
    driver = spec.driver_module(cell.driver).Driver(cell, SEED, "cpu")
    driver.setup()
    driver.release()
    numbers = driver.check_against(precision=limits["control"])
    assert not compare.verdict(compare.compared(numbers, cell.limits), cell.limits)
