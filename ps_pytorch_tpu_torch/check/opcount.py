"""Op-count probes over a recorded step (the port of check/opcount.py):
how much of the step is UPDATE path, everything downstream of the
gradient reduce?

- ``update_path_op_count`` / ``update_path_ops_from`` walk the tape
  FORWARD from the outputs of every reduce-kind collective
  (``walker.REDUCE_KINDS``: the gradient psum / psum_scatter /
  all_to_all family) and count the nodes that consume them, directly or
  transitively: JAX's forward walk (opcount.py:60-144), over tape nodes
  instead of equations. The reduce itself seeds the taint and is not
  counted. This is the number that collapses when the state goes flat
  (``PSConfig.state_layout="flat"``): one fused update instead of a
  chain a leaf.

- ``device_kernel_count`` counts what one call of a function launches
  on the device: the CUDA kernel events of ``torch.profiler`` on the
  card, the aten and kernel nodes of a recorded tape on the CPU (each
  an op the CPU runs). None where it cannot count. There is no HLO text
  in eager PyTorch, so JAX's ``hlo_op_count`` has no counterpart.
"""

from __future__ import annotations

from typing import Optional

from .walker import REDUCE_KINDS, Tape, record_step


def update_path_ops_from(tape: Tape) -> int:
    """Nodes downstream of a reduce-kind collective of ``tape``."""
    tainted = set()
    count = 0
    for node in tape.nodes:
        hit = any(p in tainted for p in node.parents)
        if hit:
            count += 1
        if hit or any(p.kind in REDUCE_KINDS for p in node.payloads):
            tainted.add(node.index)
    return count


def update_path_op_count(fn, *args, devices: int = 1, **kwargs) -> int:
    """``update_path_ops_from`` of one recorded call ``fn(*args,
    **kwargs)`` (it runs once)."""
    tape, _ = record_step(fn, *args, devices=devices, **kwargs)
    return update_path_ops_from(tape)


def device_kernel_count(fn, *args, **kwargs) -> Optional[int]:
    """The device work one call of ``fn(*args, **kwargs)`` launches: CUDA
    kernel events when a card runs it, else the tape's aten and kernel
    nodes; None when neither can be counted here."""
    import torch

    try:
        if torch.cuda.is_available():
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn(*args, **kwargs)
                torch.cuda.synchronize()
            n = sum(1 for e in prof.events()
                    if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
            return n or None
        tape, _ = record_step(fn, *args, **kwargs)
        return sum(1 for node in tape.nodes if node.op in ("aten", "kernel"))
    except Exception:  # a backend that cannot run or profile it here
        return None
