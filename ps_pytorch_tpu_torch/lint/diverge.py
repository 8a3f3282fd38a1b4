"""The package's consensus-point inventory (the port of the PSC110
companion in lint/diverge.py; the divergence rules PSL006-PSL008 are
ROADMAP.md item 24).

A function is consensus-shaped when its body calls one of the port's
host-agreement primitives, ``ProcessWorkerAxis.broadcast_object``,
``min_over_hosts`` or ``any_host`` (``parallel/mesh.py``), at some line
L and returns at a line >= L: its result can carry the agreed value back
to every caller. The rule is JAX's (``broadcast_one_to_all`` /
``process_allgather`` there) with the port's primitives.
"""

from __future__ import annotations

import ast
import functools
import os
from typing import Dict, List, Optional, Tuple

# the port's host-agreement primitives (parallel/mesh.py ProcessWorkerAxis)
CONSENSUS_TAILS = {"broadcast_object", "min_over_hosts", "any_host"}

def _tail(node: ast.AST) -> str:
    """The last name of a call target: ``a.b.c`` -> ``c``."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _module_functions_with_class(tree: ast.Module) -> List[Tuple[str, ast.AST, Optional[str]]]:
    out: List[Tuple[str, ast.AST, Optional[str]]] = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append((node.name, node, None))
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out.append((sub.name, sub, node.name))
    return out


def _is_consensus_shaped(fn: ast.AST) -> bool:
    consensus_line = None
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and _tail(node.func) in CONSENSUS_TAILS:
            if consensus_line is None or node.lineno < consensus_line:
                consensus_line = node.lineno
    if consensus_line is None:
        return False
    return any(isinstance(node, ast.Return) and node.lineno >= consensus_line
               for node in ast.walk(fn))


@functools.lru_cache(maxsize=None)
def consensus_inventory() -> Dict[str, Tuple[str, int]]:
    """Map of consensus-shaped functions in the package: keys are
    package-relative dotted paths (``trainer.Trainer._count_consensus``),
    values (file path, line number)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    inventory: Dict[str, Tuple[str, int]] = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if not d.startswith(("_", "."))]
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            fpath = os.path.join(dirpath, fname)
            mod = os.path.relpath(fpath, root)[:-3].replace(os.sep, ".")
            if mod.endswith(".__init__"):
                mod = mod[: -len(".__init__")]
            try:
                with open(fpath, "r", encoding="utf-8") as fh:
                    tree = ast.parse(fh.read())
            except (OSError, SyntaxError):
                continue
            for name, node, cls in _module_functions_with_class(tree):
                if _is_consensus_shaped(node):
                    inventory[f"{mod}.{cls}.{name}" if cls else f"{mod}.{name}"] = (
                        fpath, node.lineno)
    return inventory
