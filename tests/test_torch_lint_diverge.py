"""pslint on the port, PSL006-PSL008 (ps_pytorch_tpu_torch/lint/diverge.py):
the divergence fixtures of tests/test_lint.py in their torch form, over
``ProcessWorkerAxis`` and ``torch.distributed`` (each trips exactly its
rule), the sanctioned idioms of the port's trainer and checkpoint writer
(rank 0 then ``broadcast_object``, the held error, ``min_over_hosts`` /
``any_host`` consensus, a deployment gate's single-process tail), the
pragmas, and the divergence rules over the port's own package.
"""

import pytest

from ps_pytorch_tpu_torch.lint import lint_paths
from ps_pytorch_tpu_torch.lint.axes import DEFAULT_AXES
from ps_pytorch_tpu_torch.lint.core import lint_source

from tests.test_torch_lint import PORT, REPO


def _lint(src: str):
    return lint_source(src, "snippet.py", DEFAULT_AXES)


# JAX's stranded save_checkpoint: rank 0's write fails and raises BEFORE the
# barrier every other process is already waiting at.
STRANDED_SAVE = """
import torch.distributed as dist

def save_checkpoint(axis, path, state, step):
    if axis.rank == 0:
        try:
            _write(path, state)
        except OSError as e:
            raise CheckpointWriteError(path) from e
    axis.barrier()
"""

# JAX's torn-replica resume: every process walks its OWN listing and
# restores whatever IT sees newest.
TORN_RESUME = """
import torch.distributed as dist
import ps_pytorch_tpu_torch.checkpoint as ckpt

def try_resume(target, train_dir):
    rank = dist.get_rank()
    steps = ckpt.available_steps(train_dir)
    for step in reversed(steps):
        try:
            return ckpt.load_checkpoint(target, train_dir, step)
        except OSError:
            continue
    return None
"""

# JAX's per-host agg_count: a clock heuristic adapts the count
# locally and feeds it straight into the step.
LOCAL_AGG_COUNT = """
import time
import numpy as np
import torch.distributed as dist

def train(state, batches, train_step, threshold):
    if dist.get_world_size() == 1:
        return state
    count = 1
    for batch in batches:
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch, np.int32(count))
        if time.perf_counter() - t0 > threshold:
            count = count + 1
    return state
"""

CROSSED_ORDER = """
import os
from ps_pytorch_tpu_torch.parallel.mesh import ProcessWorkerAxis

def reconcile(axis, path, a, b):
    if os.path.getmtime(path) > 100.0:
        a = axis.all_gather(a)
        b = axis.broadcast_object(b)
    else:
        b = axis.broadcast_object(b)
        a = axis.all_gather(a)
    return a, b
"""

# An env-var branch runs the barrier on one path only.
ASYMMETRIC_GUARD = """
import os
import torch.distributed as dist

def maybe_sync(axis, step):
    if os.environ.get("PS_EAGER_SYNC"):
        axis.barrier()
"""

# A per-process listing decides how many times each process rendezvouses.
DIVERGENT_LOOP = """
import os
import torch

def sweep(axis, d, x):
    if not torch.distributed.is_initialized():
        return x
    for name in os.listdir(d):
        x = axis.psum(x)
    return x
"""

# A rank-dependent run id stamped into the trace header.
RANK_RUN_ID = """
import torch.distributed as dist
from ps_pytorch_tpu_torch.obs.trace import Tracer

def tracer(path):
    return Tracer("train", path=path, run_id=f"run-{dist.get_rank()}")
"""


@pytest.mark.parametrize("src,rule", [
    (STRANDED_SAVE, "PSL006"),
    (TORN_RESUME, "PSL007"),
    (LOCAL_AGG_COUNT, "PSL007"),
    (CROSSED_ORDER, "PSL008"),
    (ASYMMETRIC_GUARD, "PSL006"),
    (DIVERGENT_LOOP, "PSL006"),
    (RANK_RUN_ID, "PSL007"),
], ids=["stranded-save", "torn-resume", "local-agg-count", "crossed-order",
        "asymmetric-guard", "divergent-loop", "rank-run-id"])
def test_torch_divergence_fixture_trips_exactly_its_rule(src, rule):
    findings = _lint(src)
    assert sorted({f.rule for f in findings}) == [rule], [
        (f.rule, f.line, f.message) for f in findings]


# The blessed idiom (trainer._try_resume_multihost's shape): rank 0 walks
# its listing, the choice is broadcast, every process acts on it.
RANK0_BROADCAST = """
import ps_pytorch_tpu_torch.checkpoint as ckpt
from ps_pytorch_tpu_torch.parallel.mesh import ProcessWorkerAxis

def resume(axis, target, train_dir):
    chosen = -1
    if axis.rank == 0:
        for step in reversed(ckpt.available_steps(train_dir)):
            chosen = step
            break
    chosen = int(axis.broadcast_object(chosen))
    if chosen < 0:
        return None
    return ckpt.load_checkpoint(target, train_dir, chosen)
"""

# Divergent control with no collective in either path, rejoined at a
# barrier every process reaches.
BARRIER_REJOIN = """
import torch.distributed as dist

def log_and_sync(axis, step):
    if axis.rank == 0:
        _write_summary(step)
    else:
        _noop(step)
    axis.barrier()
"""

# checkpoint.AsyncCheckpointer's shape: hold the error, reach every
# collective, re-raise after.
HELD_ERROR_SAVE = """
import torch.distributed as dist

def save_checkpoint(axis, path, state, step):
    err = None
    if axis.rank == 0:
        try:
            _write(path, state)
        except OSError as e:
            err = e
    ok = axis.broadcast_object(err is None)
    axis.barrier()
    if not ok:
        raise CheckpointWriteError(path)
"""

# A deployment gate's early return makes the rest single-process.
SINGLE_PROCESS_TAIL = """
import torch.distributed as dist
import ps_pytorch_tpu_torch.checkpoint as ckpt

def try_resume(target, train_dir):
    steps = ckpt.available_steps(train_dir)
    if dist.get_world_size() > 1:
        return _multihost_resume(target, steps)
    for step in reversed(steps):
        return ckpt.load_checkpoint(target, train_dir, step)
    return None

def _multihost_resume(target, steps):
    return None
"""

# The laundered choice flows through a module-local helper into the
# restore (trainer._restore_step's chain).
RESTORE_HELPER = """
import ps_pytorch_tpu_torch.checkpoint as ckpt
from ps_pytorch_tpu_torch.parallel.mesh import ProcessWorkerAxis

def _restore_step(target, train_dir, step):
    raw = ckpt.load_checkpoint_raw(train_dir, step)
    return ckpt.restore_from_raw(target, raw, step)

def resume(axis, target, train_dir):
    chosen = -1
    if axis.rank == 0:
        steps = ckpt.available_steps(train_dir)
        if steps:
            chosen = steps[-1]
    chosen = int(axis.broadcast_object(chosen))
    if chosen < 0:
        return None
    return _restore_step(target, train_dir, chosen)
"""

# The trainer's consensus (trainer.py's _count_consensus and the stop
# flag's any_host): clock-driven proposals agreed before the step.
CONSENSUS_LOOP = """
import time
import numpy as np
from ps_pytorch_tpu_torch.parallel.mesh import ProcessWorkerAxis

class Trainer:
    def __init__(self, mesh):
        self.mesh = mesh
        self.multi = isinstance(mesh, ProcessWorkerAxis)
        self.rank = mesh.rank if self.multi else 0
        self.run_id = mesh.broadcast_object(new_run_id()) if self.multi else new_run_id()

    def _count_consensus(self, proposed):
        return int(self.mesh.min_over_hosts(np.asarray([proposed], np.int32))[0])

    def train(self, batches):
        for batch in batches:
            t0 = time.perf_counter()
            count = self._count_consensus(self.propose(time.perf_counter() - t0))
            self.state, metrics = self.step(self.state, batch, agg_count=count)
            if self.multi and self.mesh.any_host(self.stop_requested):
                break
        return Tracer("train", path=f"trace_p{self.rank}.jsonl", run_id=self.run_id)
"""


@pytest.mark.parametrize("src", [
    RANK0_BROADCAST, BARRIER_REJOIN, HELD_ERROR_SAVE, SINGLE_PROCESS_TAIL,
    RESTORE_HELPER, CONSENSUS_LOOP,
], ids=["rank0-broadcast", "barrier-rejoin", "held-error-save", "single-process-tail",
        "restore-helper", "consensus-loop"])
def test_torch_sanctioned_multiprocess_idiom_is_clean(src):
    assert _lint(src) == []


def test_torch_consensus_is_what_launders():
    """The consensus loop with the agreement removed: the clock reaches
    the step, and the unagreed run id the trace header."""
    src = CONSENSUS_LOOP.replace(
        "return int(self.mesh.min_over_hosts(np.asarray([proposed], np.int32))[0])",
        "return int(proposed)").replace(
        "mesh.broadcast_object(new_run_id()) if self.multi else new_run_id()",
        "new_run_id()")
    assert sorted({(f.rule, f.line) for f in _lint(src)}) == [("PSL007", 20),
                                                              ("PSL007", 23)]


def test_torch_divergence_skips_modules_without_process_markers():
    src = LOCAL_AGG_COUNT.replace("import torch.distributed as dist\n", "").replace(
        "    if dist.get_world_size() == 1:\n        return state\n", "")
    assert "dist" not in src
    assert _lint(src) == []


def test_torch_diverge_ok_pragma_suppresses():
    src = ASYMMETRIC_GUARD.replace('if os.environ.get("PS_EAGER_SYNC"):',
                                   'if os.environ.get("PS_EAGER_SYNC"):  # psl: diverge-ok')
    assert _lint(src) == []


def test_torch_rule_scoped_ignore_covers_psl007():
    src = TORN_RESUME.replace(
        "return ckpt.load_checkpoint(target, train_dir, step)",
        "return ckpt.load_checkpoint(target, train_dir, step)  # psl: ignore[PSL007]")
    assert _lint(src) == []


def test_torch_seeded_generators_are_no_source():
    """A numpy generator built from a seed draws the same on every
    process; an unseeded draw is a source."""
    seeded = LOCAL_AGG_COUNT.replace(
        "t0 = time.perf_counter()", "t0 = 0.0").replace(
        "if time.perf_counter() - t0 > threshold:",
        "if np.random.RandomState(7).rand() > threshold:")
    assert _lint(seeded) == []
    assert {f.rule for f in _lint(seeded.replace("RandomState(7)", "RandomState()"))} == {
        "PSL007"}


def test_torch_divergence_gate_is_clean_over_the_port():
    """PSL006-008 over the port and chip_smoke.py: zero findings. The
    modules the pass analyzes (the process machinery's users) include the
    trainer, the checkpoint writer, the PS step and the CLI."""
    findings = lint_paths([str(PORT), str(REPO / "chip_smoke.py")])
    diverge = [f for f in findings if f.rule in ("PSL006", "PSL007", "PSL008")]
    assert diverge == [], "\n".join(f"{f.path}:{f.line}: {f.rule} {f.message}"
                                    for f in diverge)
    import ast

    from ps_pytorch_tpu_torch.lint.diverge import _module_is_multihost

    marked = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")
              if _module_is_multihost(ast.parse(p.read_text()))}
    assert {"trainer.py", "checkpoint.py", "parallel/ps.py", "parallel/mesh.py",
            "cli/train.py"} <= marked
    assert "models/resnet.py" not in marked


def test_torch_consensus_inventory_finds_the_declared_points():
    """PSC110's static half, kept as it was: the trainer's consensus
    helpers are consensus-shaped, its train loop is not."""
    from ps_pytorch_tpu_torch.lint.diverge import consensus_inventory

    inv = consensus_inventory()
    assert "trainer.Trainer._count_consensus" in inv
    assert "trainer.Trainer._tags_consensus" in inv
    assert "trainer.Trainer.train" not in inv


@pytest.mark.parametrize("module,old,new,rule", [
    ("checkpoint.py",
     "            except BaseException as e:  # held across the broadcast, raised below\n"
     "                err = e\n",
     "            except BaseException as e:\n                raise\n", "PSL006"),
    ("trainer.py", "        chosen = int(self.mesh.broadcast_object(chosen))\n", "", "PSL007"),
], ids=["checkpoint-raise-before-barrier", "trainer-resume-without-broadcast"])
def test_torch_real_idiom_is_what_keeps_the_module_clean(module, old, new, rule):
    """The port's own rank-0 idioms, broken: the checkpoint writer raising
    inside rank 0's branch strands the others at the barrier, and the
    trainer restoring rank 0's unbroadcast choice diverges."""
    src = (PORT / module).read_text()
    assert src.count(old) == 1
    findings = lint_source(src.replace(old, new), str(PORT / module), DEFAULT_AXES)
    assert {f.rule for f in findings} == {rule}, [(f.rule, f.line, f.message)
                                                  for f in findings]
