"""Axis-name constant discovery for PSL001 (the port of lint/axes.py).

The source of truth for axis names is the set of module-level
``<NAME>_AXIS = "<literal>"`` assignments in the port's ``parallel/``
package (``parallel/mesh.py`` declares WORKER_AXIS/DCN_AXIS; tp/pp/moe/
ring_attention declare theirs next to the scheme they belong to). The
linter re-reads those declarations from source rather than importing the
package, so it runs anywhere python runs — no torch install required.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, Tuple

# fallback when no parallel/ package is reachable from the linted paths
# (e.g. linting a single file copied out of the tree). Mirrors
# parallel/{mesh,tp,pp,moe,ring_attention}.py (the one table of axis
# names as data: the pragma keeps PSL001's dict-key check off it).
DEFAULT_AXES: Dict[str, str] = {  # psl: ignore[PSL001]
    "workers": "WORKER_AXIS",
    "dcn": "DCN_AXIS",
    "model": "TP_AXIS",
    "stage": "PP_AXIS",
    "expert": "EP_AXIS",
    "seq": "SEQ_AXIS",
}

_AXIS_SUFFIX = "_AXIS"


def _axes_in_source(src: str) -> Dict[str, str]:
    """Top-level ``X_AXIS = "name"`` assignments of one module."""
    out: Dict[str, str] = {}
    try:
        tree = ast.parse(src)
    except SyntaxError:
        return out
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        if not (isinstance(node.value, ast.Constant) and isinstance(node.value.value, str)):
            continue
        for tgt in node.targets:
            if isinstance(tgt, ast.Name) and tgt.id.endswith(_AXIS_SUFFIX):
                out[node.value.value] = tgt.id
    return out


def _candidate_axis_dirs(paths: Iterable[str]) -> Iterable[str]:
    seen = set()
    for p in paths:
        d = os.path.abspath(p if os.path.isdir(p) else os.path.dirname(p) or ".")
        for _ in range(5):  # walk up a few levels looking for parallel/
            for cand in (
                os.path.join(d, "parallel"),
                os.path.join(d, "ps_pytorch_tpu_torch", "parallel"),
            ):
                if cand not in seen and os.path.isfile(os.path.join(cand, "mesh.py")):
                    seen.add(cand)
                    yield cand
            parent = os.path.dirname(d)
            if parent == d:
                break
            d = parent


def discover_axes(paths: Iterable[str]) -> Tuple[Dict[str, str], str]:
    """Map axis value -> constant name, plus a human-readable provenance.

    Declared constants win over the built-in defaults; defaults are kept
    as a floor so PSL001 still distinguishes "known axis spelled as a
    literal" from "axis name that exists nowhere" on partial checkouts.
    """
    axes = dict(DEFAULT_AXES)
    source = "builtin defaults"
    for d in _candidate_axis_dirs(paths):
        found: Dict[str, str] = {}
        for fname in sorted(os.listdir(d)):
            if not fname.endswith(".py"):
                continue
            try:
                with open(os.path.join(d, fname), "r", encoding="utf-8") as f:
                    found.update(_axes_in_source(f.read()))
            except OSError:
                continue
        if found:
            axes.update(found)
            source = os.path.relpath(d)
            break
    return axes, source
