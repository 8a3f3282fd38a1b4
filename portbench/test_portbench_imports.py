"""What a run loads: no JAX, no JAX library, no JAX package, by whole
top-level name; and the references load nothing of the program (CPU
only)."""

import ast
import glob
import os
import subprocess
import sys

import pytest

from portbench.harness import guard, spec

REFERENCES = sorted(glob.glob(os.path.join(spec.PORTBENCH, "configs", "*.py"))
                    + glob.glob(os.path.join(spec.PORTBENCH, "drivers", "*_reference.py")))
PROGRAM = ("ps_pytorch_tpu_torch",)


def test_guard_compares_whole_top_level_names():
    names = ["ps_pytorch_tpu_torch", "ps_pytorch_tpu_torch.trainer", "jaxtyping", "jax",
             "jaxlib.xla_client", "ps_pytorch_tpu.ops", "flax.linen", "optax", "torch"]
    assert guard.forbidden_loaded(names) == ["flax.linen", "jax", "jaxlib.xla_client",
                                             "optax", "ps_pytorch_tpu.ops"]


def _imported(path):
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", REFERENCES, ids=os.path.basename)
def test_references_name_no_program_module(path):
    assert not (_imported(path) & set(PROGRAM + guard.FORBIDDEN))
    assert _imported(path) <= {"__future__", "math", "typing", "numpy", "torch"}


def _run(code):
    root = spec.ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()[-1]


def test_loading_the_references_loads_no_program_module():
    code = (
        "import sys\n"
        "from portbench.harness import spec\n"
        f"for i, p in enumerate({REFERENCES!r}):\n"
        "    spec.load_module(p, f'ref{i}')\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('ps_pytorch_tpu_torch', 'ps_pytorch_tpu', 'jax', 'jaxlib', 'flax', 'optax')))\n")
    assert _run(code) == "[]"


def test_a_run_of_each_driver_loads_nothing_forbidden():
    """A whole run of a tiny cell of each driver on the CPU (set-up, the
    window, the check), then the modules the process holds."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from portbench import run\n"
        "from portbench.harness import guard\n"
        "from portbench.tiny import tiny_cell\n"
        "for kind in ('ps', 'lm'):\n"
        "    run.execute(tiny_cell(kind), 7, 2.5, False, device='cpu')\n"
        "assert 'ps_pytorch_tpu_torch' in sys.modules\n"
        "print(guard.forbidden_loaded())\n")
    assert _run(code) == "[]"
