"""pslint on the port: AST rules for the port's hot-path hazards (the
port of lint/), with JAX's rule IDs, pragmas, flags, exit codes and
JSON shapes. Each rule is restated for what the port does: PyTorch
eager over a stacked worker axis, ``ProcessWorkerAxis`` over
``torch.distributed``, and CUDA kernels behind ctypes.

  PSL001  axis-name consistency: string-literal axis names where an axis
          is data (``axis_name=``, ``bn_axis_name=``, pscheck's ``axes=``
          / ``names=``, dicts keyed by axis names, ``in row["axes"]``)
          must match the ``*_AXIS`` constants declared in the port's
          ``parallel/`` (and should BE the constants).
  PSL002  recompilation hazards: ``torch.compile`` / TorchScript / CUDA
          graph capture / the kernel library's build-load inside loops,
          on a fresh lambda, or compiled-and-called per iteration.
  PSL003  impure replayed functions: ``print``, clock reads,
          ``np.random`` / ``random``, closure/global mutation inside
          what a compile, a graph capture or a ``torch.func`` transform
          runs once and replays.
  PSL004  hidden host syncs in hot paths: ``.item()``, ``.tolist()``,
          ``.cpu()``, ``.numpy()``, ``.to("cpu")``, ``synchronize()``,
          ``float(t)`` / ``np.asarray(t)`` of a step's output, in the
          trainer and the serve engine's loops, without an explicit
          ``# psl: sync-ok`` pragma (strict over ``obs/``).
  PSL005  consumed-state reuse: reading a variable after it was passed
          in a position pscheck's ``DonationSpec`` declares consumed.
  PSL006  divergent-collective guard: rank-divergent host state
          (``axis.rank``, ``get_rank()``, clocks, RNG, fs listings, env
          vars, caught exceptions) guards a branch/loop that runs a
          collective on one path but not the other, or raises out from
          under divergent control while a later collective still expects
          this process.
  PSL007  divergent traced value: a rank-divergent value flows into a
          step call, checkpoint restore, shared artifact, or run
          identity that must be bit-identical on every process.
  PSL008  divergent collective order: both paths of a tainted branch run
          collectives, but in different orders — cross-matched rendezvous.

PSL006-PSL008 (diverge.py) only analyze modules that engage the process
machinery; ``broadcast_object`` / ``min_over_hosts`` / ``any_host``
launder taint, so the blessed rank-0-then-broadcast idiom never fires.
``diverge.consensus_inventory`` is what pscheck's PSC110 reads.

Usage:
    python -m ps_pytorch_tpu_torch.lint [paths] [--format json] \\
        [--baseline lint_baseline_torch.json] [--write-baseline]

Suppression: ``# psl: ignore`` (all rules on that line),
``# psl: ignore[PSL001,PSL004]`` (specific rules), ``# psl: sync-ok``
(alias for ignore[PSL004]), ``# psl: donate-ok`` (alias for
ignore[PSL005]), ``# psl: diverge-ok`` (alias for
ignore[PSL006,PSL007,PSL008]). Legacy findings live in a checked-in
baseline (``lint_baseline_torch.json``, the port's own) so they don't
block the gate; new findings fail tests/test_torch_lint.py. The linter
imports neither torch nor jax, so it runs on any machine.
"""

from .core import (
    Finding,
    apply_baseline,
    baseline_counts,
    lint_paths,
    load_baseline,
    render_text,
    to_baseline_json,
)
from .rules import RULE_IDS, RULES  # noqa: I001 (rules before diverge: it imports rules)
from .diverge import consensus_inventory

__all__ = [
    "Finding",
    "RULES",
    "RULE_IDS",
    "apply_baseline",
    "baseline_counts",
    "consensus_inventory",
    "lint_paths",
    "load_baseline",
    "render_text",
    "to_baseline_json",
]
