"""The port's pslint engine held against the JAX package's on the same
sources: the machinery that does not depend on the language the linted
code targets. Pragmas (multi-line statements, decorator lines, a pragma
inside a string, a spaced bracket, the aliases), PSL000, the baseline's
JSON and its text-keyed multiset matching, stale entries scoped to the
scanned files, the CLI's exit codes, ``--select`` not leaking a pragma,
and each CLI reading the other's ``--format json`` output as a baseline.

The engines run under one stand-in rule set (calls ``h1(...)`` ..
``h8(...)`` are findings of PSL001 .. PSL008), so the comparison is of
the engines, not of the rules; the CLI cases use constructs both rule
sets flag alike (``psum(x, axis_name=...)`` and ``.item()`` in a
trainer's loop).
"""

import ast
import json
import subprocess
import sys

import pytest

import ps_pytorch_tpu.lint.core as jcore
import ps_pytorch_tpu.lint.rules as jrules
import ps_pytorch_tpu_torch.lint.core as tcore
import ps_pytorch_tpu_torch.lint.rules as trules
from ps_pytorch_tpu.lint.__main__ import main as jmain
from ps_pytorch_tpu_torch.lint.__main__ import main as tmain

from tests.test_torch_lint import REPO

ENGINES = {"jax": (jcore, jrules, jmain), "torch": (tcore, trules, tmain)}


class _StandIn:
    """A call ``h<k>(...)`` is a PSL00<k> finding at the call."""

    def __init__(self, k: int):
        self.rule_id = f"PSL00{k}"
        self.name = f"h{k}"

    def check(self, tree, path, axes, donors):
        for n in ast.walk(tree):
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) and n.func.id == self.name:
                yield n.lineno, n.col_offset, f"{self.name} called"


@pytest.fixture
def stand_in(monkeypatch):
    rules = [_StandIn(k) for k in range(1, 9)]
    for _, mod, _ in ENGINES.values():
        monkeypatch.setattr(mod, "RULES", rules)


SOURCES = {
    "multiline": "def f(g):\n    return h1(\n        g,\n        1,\n    )  # psl: ignore[PSL001]\n",
    "multiline-wrong-rule": "def f(g):\n    return h1(\n        g,\n    )  # psl: ignore[PSL002]\n",
    "decorator-line": ("def build(cfgs):\n    out = []\n    for c in cfgs:\n"
                       "        @h2(c)  # psl: ignore[PSL002]\n        def step(x):\n"
                       "            return x\n        out.append(step)\n    return out\n"),
    "wrapped-decorator": ("def build(cfgs):\n    for c in cfgs:\n        @h2(\n"
                          "            c,\n        )  # psl: ignore[PSL002]\n"
                          "        def step(x):\n            return x\n"),
    "def-line-pragma": ("def build(c):\n    @h2(c)\n    def step(x):  # psl: ignore[PSL002]\n"
                        "        return x\n    return step\n"),
    "pragma-in-string": 'def f(g):\n    s = " # psl: ignore"\n    return h1(g), s\n',
    "spaced-bracket": "def f(g):\n    return h1(h2(g))  # psl: ignore [PSL002]\n",
    "blanket": "def f(g):\n    return h1(h2(h3(g)))  # psl: ignore\n",
    "aliases": ("def f(g):\n    a = h4(h5(h1(g)))  # psl: sync-ok, donate-ok\n"
                "    b = h6(h7(h8(g)))  # psl: diverge-ok\n    return a, b\n"),
    "two-comments": "def f(g):\n    return h1(g)  # psl: sync-ok # psl: ignore[PSL001]\n",
    "identical-lines": "def f(g):\n    h3(g)\n    h3(g)\n    return g\n",
}


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_torch_engine_gives_jaxs_findings_on_the_same_source(stand_in, name):
    src = SOURCES[name]
    got = {key: [f.to_json() for f in core.lint_source(src, "snippet.py", {})]
           for key, (core, _, _) in ENGINES.items()}
    assert got["torch"] == got["jax"]
    # the cases do exercise suppression: not every one is empty or full
    if name in ("multiline", "decorator-line", "wrapped-decorator", "blanket"):
        assert got["torch"] == []
    if name in ("multiline-wrong-rule", "def-line-pragma", "pragma-in-string",
                "identical-lines"):
        assert got["torch"]
    if name == "aliases":  # the aliases cover PSL004-PSL008, not PSL001
        assert [f["rule"] for f in got["torch"]] == ["PSL001"]


def test_torch_psl000_is_jaxs(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def broken(:\n    pass\n")
    got = {key: [f.to_json() for f in core.lint_paths([str(bad)])]
           for key, (core, _, _) in ENGINES.items()}
    assert got["torch"] == got["jax"] and [f["rule"] for f in got["torch"]] == ["PSL000"]


def _pair(key, *args):
    return ENGINES[key][0].Finding(*args)


def test_torch_baseline_json_and_matching_are_jaxs(tmp_path):
    rows = [("PSL001", "a.py", 42, 0, "m", 'psum(g, axis_name="workers")'),
            ("PSL004", "b.py", 7, 3, "m", "x.item()"),
            ("PSL004", "b.py", 9, 3, "m", "x.item()")]
    out = {}
    for key, (core, _, _) in ENGINES.items():
        findings = [_pair(key, *r) for r in rows]
        blob = core.to_baseline_json(findings)
        path = tmp_path / f"{key}.json"
        path.write_text(json.dumps(blob, indent=2, sort_keys=True))
        other = "jax" if key == "torch" else "torch"
        moved = [_pair(key, "PSL001", "a.py", 99, 0, "m", 'psum(g, axis_name="workers")'),
                 _pair(key, "PSL004", "b.py", 8, 3, "m", "x.item()"),
                 _pair(key, "PSL004", "b.py", 10, 3, "m", "x.item()"),
                 _pair(key, "PSL004", "b.py", 11, 3, "m", "x.item()")]
        baseline = core.load_baseline(str(path))
        assert baseline == findings
        new, matched, stale = core.apply_baseline(moved, baseline)
        gone, _, stale_all = core.apply_baseline([], baseline)
        _, _, stale_scoped = core.apply_baseline([], baseline, scanned_paths=["b.py"])
        out[key] = {
            "blob": blob,
            "cross": [f.to_json() for f in ENGINES[other][0].load_baseline(str(path))],
            "split": [[f.to_json() for f in part] for part in (new, matched, stale)],
            "stale_all": [f.to_json() for f in stale_all],
            "stale_scoped": [f.to_json() for f in stale_scoped],
            "counts": sorted(core.baseline_counts(findings).items()),
        }
    assert out["torch"] == out["jax"]
    # text-keyed, multiset: line moves match, the third identical line is new
    assert [len(p) for p in out["torch"]["split"]] == [1, 3, 0]
    assert [f["path"] for f in out["torch"]["stale_scoped"]] == ["b.py", "b.py"]


_HOT = ("import jax\n\ndef f(bs):\n    for b in bs:\n"
        '        x = jax.lax.psum(b, axis_name="wrokers").item()  # psl: ignore[PSL004]\n'
        "    return x\n")


def _cli(key, argv, capsys, monkeypatch, cwd):
    monkeypatch.chdir(cwd)
    rc = ENGINES[key][2](argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_torch_cli_exit_codes_and_json_are_jaxs(tmp_path, capsys, monkeypatch):
    hot = tmp_path / "trainer.py"
    hot.write_text(_HOT)
    clean = tmp_path / "clean.py"
    clean.write_text("def f(x):\n    return x\n")
    (tmp_path / "notes.txt").write_text("not python\n")
    runs = {
        "findings": [str(hot), "--no-baseline", "--format", "json"],
        "select-other-rule": [str(hot), "--no-baseline", "--format", "json", "--select",
                              "PSL004"],
        "select-same-rule": [str(hot), "--no-baseline", "--format", "json", "--select",
                             "psl001"],
        "clean": [str(clean), "--no-baseline"],
        "missing-path": ["no_such_dir_xyz"],
        "not-python": [str(tmp_path / "notes.txt")],
        "unknown-rule": [str(hot), "--select", "PSL999"],
        "select-with-write": [str(hot), "--select", "PSL001", "--write-baseline",
                              "--baseline", str(tmp_path / "b.json")],
    }
    got = {}
    for key in ENGINES:
        for name, argv in runs.items():
            rc, out, err = _cli(key, argv, capsys, monkeypatch, tmp_path)
            rec = {"rc": rc, "err_kind": err.split(":")[0] if err else ""}
            if "--format" in argv:
                payload = json.loads(out)
                rec["keys"] = sorted(payload)
                rec["new"] = [(f["rule"], f["line"], f["col"], f["path"], f["text"])
                              for f in payload["new"]]
                rec["axes"] = (payload["axes"], payload["axes_source"])
            got[(key, name)] = rec
    assert not (tmp_path / "b.json").exists()
    for name in runs:
        assert got[("torch", name)] == got[("jax", name)], name
    assert {name: got[("torch", name)]["rc"] for name in runs} == {
        "findings": 1, "select-other-rule": 0, "select-same-rule": 1, "clean": 0,
        "missing-path": 2, "not-python": 2, "unknown-rule": 2, "select-with-write": 2}
    assert [r[0] for r in got[("torch", "findings")]["new"]] == ["PSL001"]


def test_torch_cli_reads_jaxs_json_as_a_baseline_and_back(tmp_path, capsys, monkeypatch):
    """``--format json``'s output IS a baseline, and the two CLIs' are
    interchangeable: each one's output baselines the other's run."""
    hot = tmp_path / "trainer.py"
    hot.write_text(_HOT)
    for src, dst in (("jax", "torch"), ("torch", "jax")):
        rc, out, _ = _cli(src, [str(hot), "--no-baseline", "--format", "json"], capsys,
                          monkeypatch, tmp_path)
        assert rc == 1
        base = tmp_path / f"from_{src}.json"
        base.write_text(out)
        rc, out, _ = _cli(dst, [str(hot), "--baseline", str(base)], capsys, monkeypatch,
                          tmp_path)
        assert rc == 0, out
        assert "1 baselined" in out and "0 stale" in out


def test_torch_stale_counts_only_scanned_paths_as_jax(tmp_path, capsys, monkeypatch):
    scanned = tmp_path / "scanned"
    scanned.mkdir()
    hot = scanned / "hot.py"
    hot.write_text("def f(x):\n    return x\n")
    got = {}
    for key, (core, _, _) in ENGINES.items():
        baseline = tmp_path / f"{key}_baseline.json"
        baseline.write_text(json.dumps(core.to_baseline_json([
            core.Finding("PSL001", str(hot), 1, 0, "m", "gone_line"),
            core.Finding("PSL001", "elsewhere/never_scanned.py", 1, 0, "m", "x")])))
        rc, out, _ = _cli(key, [str(scanned), "--baseline", str(baseline), "--format",
                                "json"], capsys, monkeypatch, tmp_path)
        rc_text, text, _ = _cli(key, [str(scanned), "--baseline", str(baseline),
                                      "--verbose"], capsys, monkeypatch, tmp_path)
        got[key] = (rc, json.loads(out)["stale"], rc_text, text)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == 0 and [s["path"] for s in got["torch"][1]] == [str(hot)]
    assert "1 stale baseline entry" in got["torch"][3]


def test_torch_module_cli_exit_status_is_the_return_code(tmp_path):
    """``python -m ps_pytorch_tpu_torch.lint`` exits with main's code (1
    on a new finding), as ``python -m ps_pytorch_tpu.lint`` does."""
    hot = tmp_path / "trainer.py"
    hot.write_text(_HOT)
    for mod in ("ps_pytorch_tpu.lint", "ps_pytorch_tpu_torch.lint"):
        proc = subprocess.run([sys.executable, "-m", mod, str(hot), "--no-baseline"],
                              capture_output=True, text=True, cwd=str(REPO), timeout=120)
        assert proc.returncode == 1, (mod, proc.stdout, proc.stderr)
        assert "pslint: 1 new finding(s) (PSL001: 1)" in proc.stdout
