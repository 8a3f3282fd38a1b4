"""pslint on the port (ps_pytorch_tpu_torch/lint): one positive and one
negative fixture a rule for PSL001-PSL005, each JAX fixture of
tests/test_lint.py in its torch form (the positive trips exactly its
rule, the negative none); the port's own trainer and serve engine; the
gate over the port and chip_smoke.py against lint_baseline_torch.json;
and the CLI run where jax cannot be imported.

Pure-AST: the linter imports neither torch nor jax.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from ps_pytorch_tpu_torch.lint import apply_baseline, lint_paths, load_baseline
from ps_pytorch_tpu_torch.lint.axes import DEFAULT_AXES, discover_axes
from ps_pytorch_tpu_torch.lint.core import lint_source
from ps_pytorch_tpu_torch.lint.rules import collect_donor_factories

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "ps_pytorch_tpu_torch"


def _lint(src: str, path: str = "snippet.py", donors=None):
    return lint_source(src, path, DEFAULT_AXES, donors)


def _rules(findings):
    return [f.rule for f in findings]


# ------------------------------------------------------------------- PSL001

PSL001_POSITIVE = """
from ps_pytorch_tpu_torch.models import ResNet
from ps_pytorch_tpu_torch.parallel.ps import PSConfig

def cfg():
    return PSConfig(num_workers=8, axis_name="workers")

def model():
    return ResNet(bn_axis_name="wrokers")
"""

PSL001_DATA_POSITIVE = """
def price(rows, profile):
    sizes = {"workers": 8, "dcn": 2}
    return [profile.dcn if "dcn" in row.get("axes", ()) else profile.ici for row in rows]
"""

PSL001_NEGATIVE = """
from ps_pytorch_tpu_torch.models import ResNet
from ps_pytorch_tpu_torch.parallel.mesh import DCN_AXIS, WORKER_AXIS
from ps_pytorch_tpu_torch.parallel.ps import PSConfig

def cfg():
    return PSConfig(num_workers=8, axis_name=WORKER_AXIS)

def model():
    return ResNet(bn_axis_name=WORKER_AXIS)

def price(rows, profile):
    sizes = {WORKER_AXIS: 8, DCN_AXIS: 2}
    record = {"model": "ResNet18", "workers": 8}  # not a per-axis table
    return [profile.dcn if DCN_AXIS in row.get("axes", ()) else profile.ici
            for row in rows], "stage" in record, sizes
"""


def test_torch_psl001_flags_literal_and_unknown_axis():
    findings = _lint(PSL001_POSITIVE)
    assert _rules(findings) == ["PSL001", "PSL001"]
    assert "WORKER_AXIS" in findings[0].message  # known axis -> use constant
    assert "unknown mesh axis 'wrokers'" in findings[1].message  # typo


def test_torch_psl001_flags_axis_keyed_data():
    """A dict keyed only by axis names and a membership test against a
    row's ``axes`` name the axes as data: the known literals flag."""
    findings = _lint(PSL001_DATA_POSITIVE)
    assert [(f.rule, f.line) for f in findings] == [("PSL001", 3), ("PSL001", 3),
                                                    ("PSL001", 4)]
    assert "DCN_AXIS" in findings[2].message


def test_torch_psl001_constants_are_clean():
    assert _lint(PSL001_NEGATIVE) == []


def test_torch_psl001_axes_are_the_ports_declarations():
    """The axis table is read from the port's own parallel/ (mesh.py:40-41,
    tp.py, moe.py, pp.py, ring_attention.py), not JAX's."""
    axes, source = discover_axes([str(PORT)])
    assert source.replace("\\", "/").endswith("ps_pytorch_tpu_torch/parallel")
    assert axes == {"workers": "WORKER_AXIS", "dcn": "DCN_AXIS", "model": "TP_AXIS",
                    "stage": "PP_AXIS", "expert": "EP_AXIS", "seq": "SEQ_AXIS"}


# ------------------------------------------------------------------- PSL002

PSL002_POSITIVE = """
import torch

def hot_loop(batches, f):
    out = []
    for b in batches:
        step = torch.compile(f)            # compile in a loop
        out.append(torch.compile(lambda x: x + 1)(b))  # lambda + one-shot
    return out
"""

PSL002_NEGATIVE = """
import torch

def build(f):
    step = torch.compile(f)

    def run(batches):
        return [step(b) for b in batches]

    return run
"""


@pytest.mark.parametrize("src,count", [
    (PSL002_POSITIVE, 4),  # compile-in-loop x2, on a lambda, one-shot in the loop
    ("import torch\n\ndef f(g, batches):\n"
     "    return [torch.compile(g)(b) for b in batches]\n", 2),
    ("import torch\n\ndef f(fn, xs):\n    for x in xs:\n"
     "        g = torch.cuda.CUDAGraph()\n"
     "        with torch.cuda.graph(g):\n            fn(x)\n", 2),
    ("from ps_pytorch_tpu_torch.ops import _build\n\ndef f(xs):\n"
     "    while xs:\n        lib = _build.load()\n        xs.pop()\n", 1),
    ("import torch\n\ndef f(g, xs):\n    return [torch.jit.script(g) for _ in xs]\n", 1),
], ids=["loop-lambda-oneshot", "comprehension", "graph-capture", "kernel-load",
        "torchscript"])
def test_torch_psl002_flags_per_iteration_compiles(src, count):
    assert _rules(_lint(src)) == ["PSL002"] * count


@pytest.mark.parametrize("src", [
    PSL002_NEGATIVE,
    # compiling once and calling once is not a recompilation hazard
    "import torch\n\ndef f(g, x):\n    return torch.compile(g)(x)\n",
    # a for's iterable and a loop's else-body evaluate exactly once
    "import torch\n\ndef f(g, batches, x):\n"
    "    for y in torch.compile(g)(batches):\n        pass\n"
    "    else:\n        z = torch.compile(g)(x)\n    return z\n",
    # re.compile is no compiler
    "import re\n\ndef f(words):\n    return [re.compile(w) for w in words]\n",
], ids=["hoisted", "one-shot", "header-and-else", "re-compile"])
def test_torch_psl002_clean_cases(src):
    assert _lint(src) == []


# ------------------------------------------------------------------- PSL003

PSL003_POSITIVE = """
import time
import numpy as np
import torch

side_channel = []

@torch.compile
def step(x):
    print("step!", x)
    t0 = time.time()
    noise = np.random.randn(4)
    side_channel.append(t0)
    return x + torch.as_tensor(noise)
"""

PSL003_NEGATIVE = """
import torch

@torch.compile
def step(x, gen):
    acc = []
    for i in range(4):          # a LOCAL list is fine
        acc.append(x * i)
    noise = torch.randn(x.shape, generator=gen)
    return sum(acc) + noise
"""


def test_torch_psl003_flags_impurity_in_compiled_fn():
    assert _rules(_lint(PSL003_POSITIVE)) == ["PSL003"] * 4  # print, clock, np.random, append


def test_torch_psl003_pure_compiled_fn_is_clean():
    assert _lint(PSL003_NEGATIVE) == []


@pytest.mark.parametrize("src", [
    "import torch\n\ndef outer(xs):\n    def body(x):\n        print(x)\n        return x\n"
    "    return torch.func.vmap(body)(xs)\n",
    "from torch.func import grad\n\ndef outer(f, x):\n    def loss(p):\n"
    "        print(p)\n        return f(p)\n    return grad(loss)(x)\n",
    "import torch\n\ndef capture(g, fn, x, log):\n    with torch.cuda.graph(g):\n"
    "        y = fn(x)\n        log.append(y)\n    return y\n",
    "import torch\n\nclass F(torch.autograd.Function):\n    @staticmethod\n"
    "    def forward(ctx, x):\n        print(x)\n        return x\n\n"
    "def build():\n    return torch.compile(F.apply)\n",
], ids=["vmap", "func-grad", "graph-capture-body", "captured-autograd-function"])
def test_torch_psl003_replayed_bodies_are_checked(src):
    assert _rules(_lint(src)) == ["PSL003"]


def test_torch_psl003_eager_autograd_is_not_replayed():
    """``torch.autograd.grad`` runs eagerly, and an ``autograd.Function``
    nothing compiles or captures is eager too (the package's two)."""
    src = ("import torch\n\nclass F(torch.autograd.Function):\n    @staticmethod\n"
           "    def forward(ctx, x):\n        print(x)\n        return x\n\n"
           "def g(loss, leaves):\n    return torch.autograd.grad(loss, leaves)\n")
    assert _lint(src) == []


# ------------------------------------------------------------------- PSL004

PSL004_POSITIVE = """
import torch

def train(step, batches, state):
    for b in batches:
        state, metrics = step(state, b)
        m = metrics["prec1"].item()
        loss = float(metrics["loss"])
    return state
"""

PSL004_NEGATIVE = """
import torch

def train(step, batches, state, log_every=100):
    for i, b in enumerate(batches):
        state, metrics = step(state, b)
        if i % log_every == 0:
            metrics = {k: float(v) for k, v in metrics.items()}  # psl: sync-ok
            print(metrics["loss"])
    return state
"""


def test_torch_psl004_flags_per_step_syncs_in_hot_module():
    assert _rules(_lint(PSL004_POSITIVE, path="trainer.py")) == ["PSL004", "PSL004"]


@pytest.mark.parametrize("line", [
    "m = metrics['loss'].cpu()",
    "m = metrics['loss'].tolist()",
    "m = metrics['loss'].numpy()",
    "m = metrics['loss'].to('cpu')",
    "m = metrics['loss'].to(device=torch.device('cpu'))",
    "torch.cuda.synchronize()",
    "done.synchronize()",
    "m = np.asarray(metrics['loss'])",
    "m = bool(metrics['finite'])",
    "m = {k: int(v) for k, v in metrics.items()}",
], ids=["cpu", "tolist", "numpy", "to-cpu", "to-cpu-device", "cuda-synchronize",
        "event-synchronize", "np-asarray", "bool", "comprehension"])
def test_torch_psl004_each_torch_sync_trips(line):
    src = ("import numpy as np\nimport torch\n\ndef train(step, batches, state, done):\n"
           "    for b in batches:\n        state, metrics = step(state, b)\n"
           f"        {line}\n    return state\n")
    assert _rules(_lint(src, path="trainer.py")) == ["PSL004"]


def test_torch_psl004_only_applies_to_hot_modules():
    assert _lint(PSL004_POSITIVE, path="offline_eval.py") == []


def test_torch_psl004_sync_ok_pragma_suppresses():
    assert _lint(PSL004_NEGATIVE, path="trainer.py") == []


def test_torch_psl004_taint_is_flow_sensitive():
    """A periodic window read must NOT launder the per-step float() that
    runs BEFORE it — the taint follows statement order, including the
    loop back-edge; a host value (not a step's output) is no sync."""
    src = """
import torch

def train(step, batches, state, log_every=100):
    for i, b in enumerate(batches):
        state, metrics = step(state, b)
        loss = float(metrics["loss"])         # per-step sync: must flag
        n = int(i)                            # a host value: no sync
        if i % log_every == 0:
            metrics = {k: float(v) for k, v in metrics.items()}  # psl: sync-ok
    return state
"""
    findings = _lint(src, path="trainer.py")
    assert _rules(findings) == ["PSL004"]
    assert "float()" in findings[0].message and findings[0].line == 7


def test_torch_psl004_flags_while_test_sync():
    src = """
import torch

def train(step, state, b, metrics):
    while float(metrics["loss"]) > 0.1:
        state, metrics = step(state, b)
    return state
"""
    assert _rules(_lint(src, path="trainer.py")) == ["PSL004"]


PSL004_TICK = """
class Engine:
    def tick(self):
        self._pool, nxt = self._decode(self._pool)
        return nxt.cpu().numpy()
"""


def test_torch_psl004_serve_tick_is_a_hot_loop_body():
    """The serve engine's per-step entry point (tick) is a loop body by
    contract; the scope is THE serve engine module (a path-suffix entry)."""
    assert _rules(_lint(PSL004_TICK, path="ps_pytorch_tpu_torch/serve/engine.py")) == [
        "PSL004", "PSL004"]
    assert _lint(PSL004_TICK, path="tools/engine.py") == []
    assert _lint(PSL004_TICK, path="pipeline.py") == []


def test_torch_psl004_strict_over_obs():
    """Every function of obs/ is a hot-path body: a ``host_sync`` (the
    timing barrier, blessed elsewhere) is a finding there."""
    src = ("from ps_pytorch_tpu_torch.utils.sync import host_sync\n\n"
           "def span_end(t):\n    host_sync(t)\n")
    assert _rules(_lint(src, path="ps_pytorch_tpu_torch/obs/trace.py")) == ["PSL004"]
    assert _lint(src, path="ps_pytorch_tpu_torch/tools/train_profile.py") == []


def test_torch_psl004_real_trainer_is_windowed():
    """The port's trainer keeps metrics on the card between log windows;
    every intended read (the window's, the backpressure read, the armed
    watchdog's barrier, the precision controller's per-step norms) carries
    the pragma."""
    findings = [f for f in lint_paths([str(PORT / "trainer.py")]) if f.rule == "PSL004"]
    assert findings == []
    src = (PORT / "trainer.py").read_text()
    assert src.count("# psl: sync-ok") == 4


def test_torch_psl004_serve_tick_has_one_blessed_fetch():
    """The serve engine's only host sync is the scheduler's fused [slots]
    token read, and it carries the pragma — a further per-token sync in
    serve/ fails the gate."""
    findings = [f for f in lint_paths([str(PORT / "serve")])
                if f.rule in ("PSL002", "PSL004")]
    assert findings == []
    src = (PORT / "serve" / "engine.py").read_text()
    assert src.count("# psl: sync-ok") == 1
    without = src.replace("  # psl: sync-ok", "")
    assert _rules(lint_source(without, str(PORT / "serve" / "engine.py"),
                              DEFAULT_AXES)) == ["PSL004", "PSL004"]


# ------------------------------------------------------------------- PSL005

_SPEC = """
from ps_pytorch_tpu_torch.check.contracts import Built, ContractSpec, DonationSpec
from ps_pytorch_tpu_torch.parallel.ps import make_ps_train_step

def _spec(model, tx, cfg, state, batch):
    def build(device):
        step = make_ps_train_step(model, tx, cfg, device=device)
        return Built(step=step, args=(state, batch))
    return ContractSpec(name="ps", build=build,
                        donation=DonationSpec(argnums=(0,), out_positions=(0,)))
"""

PSL005_POSITIVE = _SPEC + """
def run(model, tx, cfg, state, batch):
    step = make_ps_train_step(model, tx, cfg)
    new_state, metrics = step(state, batch)
    return state  # the state the step consumed
"""

PSL005_NEGATIVE = _SPEC + """
def run(model, tx, cfg, state, batches):
    step = make_ps_train_step(model, tx, cfg)
    for batch in batches:
        state, metrics = step(state, batch)  # rebinds: fresh
    return state

def run_opted_out(model, tx, cfg, state, batch):
    step = make_ps_train_step(model, tx, cfg, donate=False)
    new_state, _ = step(state, batch)
    return state

def run_renamed(pair, state, batch):
    st, step = pair  # another scope's `step`, not the factory's
    new_state, _ = step(state, batch)
    return state
"""


def test_torch_psl005_flags_read_after_consumption():
    findings = [f for f in _lint(PSL005_POSITIVE) if f.rule == "PSL005"]
    assert len(findings) == 1 and findings[0].line == PSL005_POSITIVE.count("\n") - 0
    assert "'state' read after being consumed" in findings[0].message
    assert _rules(_lint(PSL005_POSITIVE)) == ["PSL005"]


def test_torch_psl005_rebind_and_opt_out_are_clean():
    assert _lint(PSL005_NEGATIVE) == []


def test_torch_psl005_loop_carries_consumption_to_next_iteration():
    src = _SPEC + """
def run(model, tx, cfg, state, batches):
    step = make_ps_train_step(model, tx, cfg)
    for b in batches:
        new_state = step(state, b)  # `state` consumed on iter 1, read on iter 2
    return new_state
"""
    assert len([f for f in _lint(src) if f.rule == "PSL005"]) >= 1


def test_torch_psl005_factories_are_the_ports_donation_specs():
    """The consumed positions come from pscheck's DonationSpecs in the
    port's check/contracts.py, read from source: the PS step's state, the
    LM steps' params and optimizer state, the decode step's KV pool."""
    tree = ast.parse((PORT / "check" / "contracts.py").read_text())
    donors = collect_donor_factories(tree)
    assert donors == {"make_ps_train_step": (0,), "make_dp_tp_train_step": (0, 1),
                      "make_pp_train_step": (0, 1), "make_moe_train_step": (0, 1),
                      "make_3d_train_step": (0, 1), "make_decode_step": (1,)}
    src = ("def serve(cfg, serve_cfg, params, pool, tok, pos, active):\n"
           "    decode = make_decode_step(cfg, serve_cfg)\n"
           "    out = decode(params, pool, tok, pos, active)\n"
           "    return out, pool\n")
    assert _rules(_lint(src, donors=donors)) == ["PSL005"]


def test_torch_psl005_factories_discovered_across_files(tmp_path):
    """A spec in one file, the unsafe call site in another: lint_paths
    links them."""
    (tmp_path / "spec.py").write_text(_SPEC)
    (tmp_path / "caller.py").write_text(
        "from ps_pytorch_tpu_torch.parallel.ps import make_ps_train_step\n"
        "def go(model, tx, cfg, state, b):\n"
        "    step = make_ps_train_step(model, tx, cfg)\n"
        "    out = step(state, b)\n"
        "    return state\n")
    assert [f.rule for f in lint_paths([str(tmp_path)])] == ["PSL005"]


# ------------------------------------------------------------------ the gate

def test_torch_lint_gate_is_clean_against_its_baseline():
    """THE gate: the port and chip_smoke.py give no finding beyond
    lint_baseline_torch.json, which is empty (every intended sync carries
    its pragma instead)."""
    findings = lint_paths([str(PORT), str(REPO / "chip_smoke.py")])
    baseline = load_baseline(str(REPO / "lint_baseline_torch.json"))
    assert baseline == []
    rel = [f.__class__(f.rule, str(Path(f.path).resolve().relative_to(REPO)), f.line,
                       f.col, f.message, f.text) for f in findings]
    new, _, _ = apply_baseline(rel, baseline)
    assert new == [], "\n".join(f"{f.path}:{f.line}: {f.rule} {f.message}" for f in new)


def test_torch_lint_cli_runs_without_jax():
    """The gate's exact command, in a process where ``import jax`` (and
    the JAX package) fails: exit 0. The linter's modules import neither
    torch nor jax."""
    code = ("import sys, runpy\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax', 'ps_pytorch_tpu'):\n"
            "    sys.modules[m] = None\n"
            "sys.argv = ['pslint', 'ps_pytorch_tpu_torch', 'chip_smoke.py',\n"
            "            '--baseline', 'lint_baseline_torch.json', '--format', 'json']\n"
            "runpy.run_module('ps_pytorch_tpu_torch.lint', run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(REPO), timeout=120)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    out = json.loads(proc.stdout)
    assert out["new"] == [] and out["tool"] == "pslint"
    assert out["axes_source"].replace("\\", "/").endswith("ps_pytorch_tpu_torch/parallel")
    for mod in sorted((PORT / "lint").glob("*.py")):
        imports = [ln.strip() for ln in mod.read_text().splitlines()
                   if ln.strip().startswith(("import ", "from "))]
        assert not any(("torch" in ln.replace("ps_pytorch_tpu_torch", "")) or "jax" in ln
                       for ln in imports), (mod.name, imports)
