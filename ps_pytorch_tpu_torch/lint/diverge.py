"""psdiverge on the port: rank-divergence taint analysis (PSL006-PSL008),
and the package's consensus-point inventory that pscheck's PSC110 reads
(the port of lint/diverge.py).

A run over processes (``ProcessWorkerAxis`` over ``torch.distributed``)
is SPMD at the host level: every process runs the same Python loop, and
any cross-process operation (a ``broadcast_object``, a ``barrier``, a
``save_checkpoint`` that meets the others at a barrier, the axis's
``psum`` / ``pmean`` / ``pmax`` / ``all_gather`` / ``all_to_all``) is a
rendezvous that every process must reach, in the same order, with
bit-identical control decisions. Host state that differs between
processes — the rank itself (``axis.rank``, ``self.rank``,
``dist.get_rank()``), wall clocks, unseeded RNG, filesystem listings,
env vars, caught-exception state — must therefore never decide
*whether*, *when*, or *with what values* a rendezvous runs, unless it is
first laundered through a consensus primitive (``broadcast_object``,
``min_over_hosts``, ``any_host``: parallel/mesh.py).

PSL006  divergent-collective guard — rank-divergent state guards a
        branch/loop that contains a collective on one path but not the
        other, or raises out from under divergent control while later
        collectives still expect this process.
PSL007  divergent traced value — a rank-divergent value flows into a
        step call, a checkpoint restore (``load_checkpoint``,
        ``restore_*``), a shared artifact write (``save_geometry``,
        ``write_contract``, ``json.dump``), or run identity
        (``run_header`` / ``Tracer`` ``run_id=``) that must be
        bit-identical on every process.
PSL008  divergent collective order — both branches of a tainted
        condition run collectives, but in different orders, so processes
        taking different branches rendezvous cross-matched and deadlock.

The blessed idiom is sanctioned by construction, not special-cased: a
``self.rank == 0`` branch with no collectives inside and a
``broadcast_object`` rejoin afterwards (``trainer._try_resume_multihost``,
``checkpoint.AsyncCheckpointer``'s held error) never fires, because
consensus primitives launder taint and a collective-free branch pair is
symmetric. ``dist.get_world_size()`` (and a ``ProcessWorkerAxis``'s
``.world``) compares and the trainer's ``multi`` flag are deployment
constants (every process agrees on them), so ``if not self.multi:
return ...`` early-exits flip the analysis into single-process context
instead of poisoning the tail; ``axis.size`` (the worker count) is no
source at all.

Only modules that engage the process machinery are analyzed: a file
with no ``ProcessWorkerAxis`` / ``get_rank`` / ``initialize_multihost``
or consensus-primitive identifier and no ``torch.distributed`` use in its
AST (string/docstring mentions do not count) has no rendezvous to strand
and is skipped.

``consensus_inventory()`` at the bottom is the pscheck companion: a
function is consensus-shaped when its body calls a consensus primitive
at some line L and returns at a line >= L, so its result can carry the
agreed value back to every caller.
"""

from __future__ import annotations

import ast
import functools
import os
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .rules import HostSyncRule, _dotted, _tail

# One source of truth for "is this call a step": PSL004's notion of the
# hot path and PSL007's notion of a traced-knob sink must agree.
STEP_CALL_RE = HostSyncRule.STEP_CALL_RE

# the port's host-agreement primitives (parallel/mesh.py ProcessWorkerAxis)
CONSENSUS_TAILS = {"broadcast_object", "min_over_hosts", "any_host"}

# --------------------------------------------------------------------------
# Taint sources: calls whose results differ between processes.

_CLOCK_TAILS = {
    "time",
    "time_ns",
    "monotonic",
    "monotonic_ns",
    "perf_counter",
    "perf_counter_ns",
    "process_time",
    "process_time_ns",
}
_RNG_PREFIXES = ("random.", "np.random.", "numpy.random.")
# generator constructors: given a seed they draw the same on every process
_SEEDED_RNG = {"RandomState", "default_rng", "Generator", "Random"}
_FS_DOTTED = {
    "os.listdir",
    "os.scandir",
    "os.walk",
    "os.stat",
    "glob.glob",
    "glob.iglob",
    "os.path.getmtime",
    "os.path.getctime",
    "os.path.getatime",
}
# Curated module-local/cross-module helpers whose return is known to be
# assembled from per-process filesystem or RNG state (checkpoint.py,
# obs/trace.py).
_DIVERGENT_RETURN_TAILS = {
    "available_steps",
    "latest_step",
    "latest_valid_step",
    "load_latest_valid",
    "new_run_id",
}

# Consensus primitives launder taint (their result is identical on all
# processes by construction: ProcessWorkerAxis.broadcast_object /
# min_over_hosts / any_host, parallel/mesh.py); the barrier is a
# rendezvous but returns nothing useful. ProcessWorkerAxis's tensor
# collectives and save_checkpoint (which meets the others at a barrier)
# are rendezvous too. All count as collectives for guard/order analysis.
_BARRIER_TAILS = {"barrier"}
_COLLECTIVE_TAILS = (CONSENSUS_TAILS | _BARRIER_TAILS
                     | {"save_checkpoint", "psum", "pmean", "pmax", "all_gather",
                        "all_to_all"})

# Sinks: traced-knob restore paths (load_checkpoint and every restore_*),
# shared-artifact writers, run identity.
_RESTORE_TAILS = {"load_checkpoint"}
_ARTIFACT_TAILS = {"save_geometry", "write_contract"}
_RUN_IDENTITY_TAILS = {"run_header", "Tracer"}

# Sentinel reason marking taint that flowed in from a function parameter
# (used during summary construction only; never shown to users).
_PARAM = "\x00param"


def _source_reason(call: ast.Call) -> Optional[str]:
    """Why the result of this call differs between processes, or None."""
    tail = _tail(call.func)
    dotted = _dotted(call.func)
    if tail == "get_rank":
        return f"process rank {dotted or tail}()"
    if tail in _CLOCK_TAILS and (
        dotted.startswith("time.") or dotted in _CLOCK_TAILS
    ):
        return f"wall/monotonic clock {dotted or tail}()"
    if "datetime" in dotted and tail in {"now", "utcnow", "today"}:
        return f"wall clock {dotted}()"
    if dotted == "os.urandom" or dotted in {"uuid.uuid1", "uuid.uuid4"}:
        return f"unseeded RNG {dotted}()"
    if dotted.startswith(_RNG_PREFIXES):
        if tail in _SEEDED_RNG and (call.args or call.keywords):
            return None  # a generator built from an explicit seed
        return f"unseeded RNG {dotted}()"
    if dotted in _FS_DOTTED or tail == "iterdir":
        return f"filesystem state {dotted or tail}()"
    if dotted == "os.getenv" or dotted.startswith("os.environ"):
        return f"environment variable {dotted}()"
    if tail in _DIVERGENT_RETURN_TAILS:
        return f"per-process value {tail}()"
    return None


def _is_env_subscript(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Subscript)
        and _dotted(node.value).startswith("os.environ")
    )


def _is_multi_flag(node: ast.AST) -> bool:
    """``self.multi`` / ``multi``: the trainer's "this run spans
    processes" flag, a deployment constant."""
    return ((isinstance(node, ast.Name) and node.id == "multi")
            or (isinstance(node, ast.Attribute) and node.attr == "multi"))


def _count_gate(test: ast.AST) -> Optional[str]:
    """Detect a deployment gate: ``dist.get_world_size() <cmp> <int>`` (or
    a ``ProcessWorkerAxis``'s ``.world``), or the ``multi`` flag, plain or
    negated.

    Returns "body-multi" if the body executes in the multi-process
    deployment, "body-single" if the body executes only single-process,
    or None if the test is not an exact count gate. A gate is valid when
    its truth value is the same for any count >= 2 (so the analysis may
    treat it as a deployment constant, not a divergent branch).
    """
    if _is_multi_flag(test):
        return "body-multi"
    if (isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not)
            and _is_multi_flag(test.operand)):
        return "body-single"
    if not (
        isinstance(test, ast.Compare)
        and len(test.ops) == 1
        and len(test.comparators) == 1
    ):
        return None
    lhs, op, rhs = test.left, test.ops[0], test.comparators[0]

    def is_count(node: ast.AST) -> bool:
        return ((isinstance(node, ast.Call) and _tail(node.func) == "get_world_size")
                or (isinstance(node, ast.Attribute) and node.attr == "world"))

    def const_int(node: ast.AST) -> Optional[int]:
        if isinstance(node, ast.Constant) and isinstance(node.value, int):
            return node.value
        return None

    if is_count(lhs) and const_int(rhs) is not None:
        count_left, k = True, const_int(rhs)
    elif is_count(rhs) and const_int(lhs) is not None:
        count_left, k = False, const_int(lhs)
    else:
        return None

    def truth(count: int) -> bool:
        a, b = (count, k) if count_left else (k, count)
        if isinstance(op, ast.Gt):
            return a > b
        if isinstance(op, ast.GtE):
            return a >= b
        if isinstance(op, ast.Lt):
            return a < b
        if isinstance(op, ast.LtE):
            return a <= b
        if isinstance(op, ast.Eq):
            return a == b
        if isinstance(op, ast.NotEq):
            return a != b
        raise _NotAGate()

    try:
        at1, at2, at_big = truth(1), truth(2), truth(2 ** 30)
    except _NotAGate:
        return None
    if at2 != at_big or at1 == at2:
        return None  # not a clean single-vs-multi split
    return "body-multi" if at2 else "body-single"


class _NotAGate(Exception):
    pass


def _boolop_count_gate(test: ast.AST) -> Optional[str]:
    """A count gate embedded in an ``and`` chain refines the body context
    (e.g. ``if self.multi and self.mesh.any_host(stop):``)."""
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        for value in test.values:
            gate = _count_gate(value)
            if gate is not None:
                return gate
    return None


def _assigned_names(stmts: List[ast.stmt]) -> Set[str]:
    """Names (incl. self.attr pseudo-names) assigned anywhere in stmts."""
    names: Set[str] = set()
    for stmt in stmts:
        for node in ast.walk(stmt):
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = (
                    node.targets if isinstance(node, ast.Assign) else [node.target]
                )
                for t in targets:
                    for leaf in ast.walk(t):
                        name = _target_name(leaf)
                        if name:
                            names.add(name)
    return names


def _target_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
        if node.value.id == "self":
            return f"self.{node.attr}"
    return None


def _terminates(stmts: List[ast.stmt]) -> bool:
    """Does this branch unconditionally leave the function?"""
    for stmt in stmts:
        if isinstance(stmt, (ast.Return, ast.Raise, ast.Continue, ast.Break)):
            return True
    return False


def _collective_tails(stmts: List[ast.stmt]) -> List[str]:
    """Ordered collective-call tails anywhere under stmts (incl. nested)."""
    tails: List[str] = []
    for stmt in stmts:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call):
                tail = _tail(node.func)
                if tail in _COLLECTIVE_TAILS:
                    tails.append(tail)
    return tails


# --------------------------------------------------------------------------
# Function summaries (interprocedural within one module).


class _Summary:
    __slots__ = ("returns_taint", "propagates", "param_sink", "has_collective")

    def __init__(self) -> None:
        self.returns_taint: Optional[str] = None  # reason, if any
        self.propagates = False  # param taint can reach the return value
        self.param_sink = False  # param taint can reach a sink
        self.has_collective = False

    def merge(self, other: "_Summary") -> bool:
        changed = False
        if other.returns_taint and not self.returns_taint:
            self.returns_taint = other.returns_taint
            changed = True
        for attr in ("propagates", "param_sink", "has_collective"):
            if getattr(other, attr) and not getattr(self, attr):
                setattr(self, attr, True)
                changed = True
        return changed


class _Finding:
    __slots__ = ("rule", "lineno", "col", "message")

    def __init__(self, rule: str, lineno: int, col: int, message: str) -> None:
        self.rule = rule
        self.lineno = lineno
        self.col = col
        self.message = message


class _Analysis:
    """One shared pass over a module; rule classes read `findings`."""

    def __init__(self, tree: ast.Module) -> None:
        self.findings: List[_Finding] = []
        self._summaries: Dict[str, _Summary] = {}
        self._class_taint: Dict[str, Dict[str, str]] = {}
        self._flagged: Set[Tuple[str, int]] = set()
        if not _module_is_multihost(tree):
            return
        self._build_summaries(tree)
        self._class_attr_fixed_point(tree)
        self._emit(tree)

    # -- summaries ---------------------------------------------------------

    def _build_summaries(self, tree: ast.Module) -> None:
        funcs = _module_functions(tree)
        # Bottom-seed every module-local function BEFORE the first scan:
        # a call to a not-yet-summarized local function must read as
        # "bottom, refined later", not as an unknown library call, or the
        # conservative unknown-call assumption from iteration 1 sticks
        # forever (merge only widens).
        for name, _node in funcs:
            self._summaries.setdefault(name, _Summary())
        for _ in range(5):  # fixed point over local call graph
            changed = False
            for name, node in funcs:
                summary = _Summary()
                walker = _FlowWalker(
                    self, summary_mode=True, summary=summary, fn=node
                )
                walker.run()
                summary.has_collective = self._fn_has_collective(node, funcs)
                if self._summaries[name].merge(summary):
                    changed = True
            if not changed:
                break

    def _fn_has_collective(
        self, node: ast.AST, funcs: List[Tuple[str, ast.AST]]
    ) -> bool:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                tail = _tail(sub.func)
                if tail in _COLLECTIVE_TAILS:
                    return True
                summary = self._summaries.get(tail or "")
                if summary is not None and summary.has_collective:
                    return True
        return False

    # -- class-level self.attr taint --------------------------------------

    def _class_attr_fixed_point(self, tree: ast.Module) -> None:
        for node in tree.body:
            if not isinstance(node, ast.ClassDef):
                continue
            tainted: Dict[str, str] = {}
            for _ in range(3):
                changed = False
                for method in node.body:
                    if not isinstance(
                        method, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ):
                        continue
                    walker = _FlowWalker(
                        self,
                        summary_mode=True,
                        summary=_Summary(),
                        fn=method,
                        seed_env=dict(tainted),
                        taint_params=False,
                    )
                    walker.run()
                    for name, reason in walker.self_attr_taint.items():
                        if name not in tainted:
                            tainted[name] = reason
                            changed = True
                if not changed:
                    break
            self._class_taint[node.name] = tainted

    # -- emission ----------------------------------------------------------

    def _emit(self, tree: ast.Module) -> None:
        # Module-level statements (rare, ctx unknown -> treated as multi).
        top = [
            s
            for s in tree.body
            if not isinstance(
                s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            )
        ]
        if top:
            _FlowWalker(self, body=top).run()
        for name, node, cls in _module_functions_with_class(tree):
            seed = dict(self._class_taint.get(cls, {})) if cls else {}
            _FlowWalker(self, fn=node, seed_env=seed).run()

    def flag(self, rule: str, lineno: int, col: int, message: str) -> None:
        key = (rule, lineno)
        if key in self._flagged:
            return
        self._flagged.add(key)
        self.findings.append(_Finding(rule, lineno, col, message))

    def summary_for(self, name: Optional[str]) -> Optional[_Summary]:
        if not name:
            return None
        return self._summaries.get(name)


_MARKERS = {"ProcessWorkerAxis", "get_rank", "initialize_multihost"} | CONSENSUS_TAILS


def _module_is_multihost(tree: ast.Module) -> bool:
    """Does the module engage the process machinery: ``ProcessWorkerAxis``,
    ``get_rank``, ``initialize_multihost``, a consensus primitive
    (``broadcast_object`` / ``min_over_hosts`` / ``any_host``: the
    checkpoint writer reaches its axis only through these) or
    ``torch.distributed``, as an identifier or an import (string and
    docstring mentions do not count)?"""
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and node.id in _MARKERS:
            return True
        if isinstance(node, ast.Attribute) and (
            node.attr in _MARKERS
            or (node.attr == "distributed" and _dotted(node) == "torch.distributed")
        ):
            return True
        if isinstance(node, ast.ImportFrom) and node.module and (
            node.module.startswith("torch.distributed")
            or (node.module == "torch" and any(a.name == "distributed" for a in node.names))
            or any(a.name in _MARKERS for a in node.names)
        ):
            return True
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.startswith("torch.distributed"):
                    return True
    return False


def _module_functions(tree: ast.Module) -> List[Tuple[str, ast.AST]]:
    return [(n, f) for n, f, _c in _module_functions_with_class(tree)]


def _module_functions_with_class(
    tree: ast.Module,
) -> List[Tuple[str, ast.AST, Optional[str]]]:
    out: List[Tuple[str, ast.AST, Optional[str]]] = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append((node.name, node, None))
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out.append((sub.name, sub, node.name))
    return out


# --------------------------------------------------------------------------
# The flow walker: one function (or the module top level) at a time.


class _FlowWalker:
    def __init__(
        self,
        analysis: _Analysis,
        fn: Optional[ast.AST] = None,
        body: Optional[List[ast.stmt]] = None,
        summary_mode: bool = False,
        summary: Optional[_Summary] = None,
        seed_env: Optional[Dict[str, str]] = None,
        taint_params: bool = True,
    ) -> None:
        self.analysis = analysis
        self.fn = fn
        self.body = body if body is not None else (fn.body if fn else [])
        self.summary_mode = summary_mode
        self.summary = summary
        self.env: Dict[str, str] = dict(seed_env or {})
        self.self_attr_taint: Dict[str, str] = {}
        # ctx: "multi" | "single" | None (unknown, treated as maybe-multi)
        self.ctx: Optional[str] = None
        self.control: List[str] = []  # reasons for enclosing tainted control
        self.events: List[Tuple[str, int, object]] = []  # (kind, lineno, data)
        if summary_mode and taint_params and fn is not None:
            for arg in _fn_args(fn):
                self.env[arg] = _PARAM

    # -- entry -------------------------------------------------------------

    def run(self) -> None:
        self._scan(self.body)
        if not self.summary_mode:
            self._check_stranded_raises()

    # -- taint evaluation --------------------------------------------------

    def taint_of(self, node: ast.AST) -> Optional[str]:
        """Reason this expression is process-divergent, or None."""
        if node is None:
            return None
        if isinstance(node, ast.Call):
            tail = _tail(node.func)
            if tail in CONSENSUS_TAILS or tail in _BARRIER_TAILS:
                return None  # consensus launders taint
            reason = _source_reason(node)
            if reason is not None:
                return reason
            summary = self.analysis.summary_for(tail)
            arg_taint = self._args_taint(node)
            if summary is not None:
                out = None
                if summary.returns_taint:
                    out = summary.returns_taint
                if summary.propagates and arg_taint:
                    out = out or arg_taint
                return out
            # Constructors (capitalized by convention): building an object
            # from per-process config (a trace path, a pid) is normal and
            # the object's identity is not a cross-process value — only
            # specific fields are, and those are checked at the sinks
            # (e.g. Tracer(run_id=...)). Propagating object taint here
            # cascades through every method touching the object.
            if tail and tail[0].isupper():
                return None
            # Unknown call: conservatively propagate arg/receiver taint.
            recv = (
                self.taint_of(node.func.value)
                if isinstance(node.func, ast.Attribute)
                else None
            )
            return arg_taint or recv
        if isinstance(node, ast.Name):
            return self.env.get(node.id)
        if isinstance(node, ast.Attribute):
            name = _target_name(node)
            if name and name in self.env:
                return self.env[name]
            if node.attr == "rank":
                # ProcessWorkerAxis.rank / the trainer's self.rank
                return f"process rank {_dotted(node) or node.attr}"
            # Any other attribute access is not a call and not a source;
            # propagate the base object's taint.
            return self.taint_of(node.value)
        if _is_env_subscript(node):
            return "environment variable os.environ[...]"
        if isinstance(node, ast.Subscript):
            return self.taint_of(node.value) or self.taint_of(node.slice)
        if isinstance(node, ast.BoolOp):
            for v in node.values:
                t = self.taint_of(v)
                if t:
                    return t
            return None
        if isinstance(node, ast.BinOp):
            return self.taint_of(node.left) or self.taint_of(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.taint_of(node.operand)
        if isinstance(node, ast.Compare):
            t = self.taint_of(node.left)
            if t:
                return t
            for c in node.comparators:
                t = self.taint_of(c)
                if t:
                    return t
            return None
        if isinstance(node, ast.IfExp):
            gate = _count_gate(node.test)
            if gate is not None and self.ctx != "single":
                # a deployment constant: the multi-process side decides
                return self.taint_of(node.body if gate == "body-multi" else node.orelse)
            return (
                self.taint_of(node.test)
                or self.taint_of(node.body)
                or self.taint_of(node.orelse)
            )
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            for e in node.elts:
                t = self.taint_of(e)
                if t:
                    return t
            return None
        if isinstance(node, ast.Dict):
            for e in list(node.keys) + list(node.values):
                t = self.taint_of(e)
                if t:
                    return t
            return None
        if isinstance(node, ast.JoinedStr):
            for v in node.values:
                t = self.taint_of(v)
                if t:
                    return t
            return None
        if isinstance(node, ast.FormattedValue):
            return self.taint_of(node.value)
        if isinstance(node, ast.Starred):
            return self.taint_of(node.value)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            t = None
            for gen in node.generators:
                t = t or self.taint_of(gen.iter)
            return t or self.taint_of(node.elt)
        if isinstance(node, ast.DictComp):
            t = None
            for gen in node.generators:
                t = t or self.taint_of(gen.iter)
            return t or self.taint_of(node.key) or self.taint_of(node.value)
        if isinstance(node, ast.Await):
            return self.taint_of(node.value)
        if isinstance(node, ast.NamedExpr):
            return self.taint_of(node.value)
        return None

    def _args_taint(self, call: ast.Call) -> Optional[str]:
        for arg in call.args:
            t = self.taint_of(arg)
            if t:
                return t
        for kw in call.keywords:
            t = self.taint_of(kw.value)
            if t:
                return t
        return None

    # -- statement scan ----------------------------------------------------

    def _scan(self, stmts: List[ast.stmt]) -> None:
        for stmt in stmts:
            self._stmt(stmt)

    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return  # nested defs are analyzed via their own summaries
        if isinstance(stmt, ast.Assign):
            self._assign(stmt.targets, stmt.value)
            self._expr_effects(stmt.value)
            return
        if isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._assign([stmt.target], stmt.value)
                self._expr_effects(stmt.value)
            return
        if isinstance(stmt, ast.AugAssign):
            taint = self.taint_of(stmt.value) or self.taint_of(stmt.target)
            self._bind(stmt.target, taint)
            self._expr_effects(stmt.value)
            return
        if isinstance(stmt, ast.Expr):
            self._expr_effects(stmt.value)
            return
        if isinstance(stmt, ast.Return):
            if stmt.value is not None:
                taint = self.taint_of(stmt.value)
                self._expr_effects(stmt.value)
                if taint and self.summary is not None and self.ctx != "single":
                    if taint == _PARAM:
                        self.summary.propagates = True
                    else:
                        self.summary.returns_taint = (
                            self.summary.returns_taint or taint
                        )
            return
        if isinstance(stmt, ast.Raise):
            self.events.append(("raise", stmt.lineno, list(self.control)))
            if stmt.exc is not None:
                self._expr_effects(stmt.exc)
            return
        if isinstance(stmt, ast.If):
            self._if(stmt)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._for(stmt)
            return
        if isinstance(stmt, ast.While):
            self._while(stmt)
            return
        if isinstance(stmt, ast.Try):
            self._try(stmt)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._expr_effects(item.context_expr)
                if item.optional_vars is not None:
                    self._bind(
                        item.optional_vars, self.taint_of(item.context_expr)
                    )
            self._scan(stmt.body)
            return
        if isinstance(stmt, ast.Assert):
            self._expr_effects(stmt.test)
            return
        if isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                name = _target_name(t)
                if name:
                    self.env.pop(name, None)
            return
        # Import, Global, Pass, Break, Continue, etc.: no taint effect.

    def _assign(self, targets: List[ast.expr], value: ast.expr) -> None:
        # Tuple-to-Tuple assigns bind elementwise.
        for target in targets:
            if (
                isinstance(target, ast.Tuple)
                and isinstance(value, ast.Tuple)
                and len(target.elts) == len(value.elts)
            ):
                for t, v in zip(target.elts, value.elts):
                    self._bind(t, self.taint_of(v))
                continue
            self._bind(target, self.taint_of(value))

    def _bind(self, target: ast.expr, taint: Optional[str]) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._bind(e, taint)
            return
        if isinstance(target, ast.Subscript):
            # A tainted value stored into a container taints the container;
            # a clean store does not clean it.
            if taint:
                name = _target_name(target.value)
                if name:
                    self.env[name] = taint
            return
        if isinstance(target, ast.Starred):
            self._bind(target.value, taint)
            return
        name = _target_name(target)
        if name is None:
            return
        if taint:
            self.env[name] = taint
            # Class-level attr taint only matters in multi-process context;
            # a single-process tail (after a count-gate early return) may
            # hold per-process state without poisoning every other method.
            if name.startswith("self.") and self.ctx != "single":
                self.self_attr_taint[name] = taint
        else:
            self.env.pop(name, None)  # clean assignment kills taint

    # -- expression effects (collectives + sinks inside any expression) ----

    def _expr_effects(self, node: ast.expr) -> None:
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            tail = _tail(sub.func)
            if tail in _COLLECTIVE_TAILS:
                self.events.append(("collective", sub.lineno, tail))
            else:
                summary = self.analysis.summary_for(tail)
                if summary is not None and summary.has_collective:
                    self.events.append(("collective", sub.lineno, tail))
            self._check_sink(sub, tail)

    def _check_sink(self, call: ast.Call, tail: Optional[str]) -> None:
        if self.ctx == "single":
            return
        arg_taint = self._args_taint(call)
        if not arg_taint:
            return
        if self.summary_mode:
            if arg_taint == _PARAM and self.summary is not None:
                if self._is_sink_call(call, tail):
                    self.summary.param_sink = True
            return
        if arg_taint == _PARAM:
            return
        sink = self._is_sink_call(call, tail)
        if not sink:
            return
        kind, reason = sink
        self._flag(
            "PSL007",
            call.lineno,
            call.col_offset,
            f"{kind} receives a process-divergent value "
            f"({reason or arg_taint}); this must be bit-identical on every "
            "process — launder it through broadcast_object/"
            "min_over_hosts/any_host first",
        )

    def _is_sink_call(
        self, call: ast.Call, tail: Optional[str]
    ) -> Optional[Tuple[str, Optional[str]]]:
        if tail and STEP_CALL_RE.search(tail):
            return f"traced step call {tail}()", None
        if tail in _RESTORE_TAILS or (tail or "").startswith("restore_"):
            return f"checkpoint restore {tail}()", None
        summary = self.analysis.summary_for(tail)
        if summary is not None and summary.param_sink:
            return f"call into {tail}() (reaches a divergence-sensitive sink)", None
        if tail in _ARTIFACT_TAILS:
            return f"shared artifact write {tail}()", None
        if tail == "dump" and _dotted(call.func).startswith("json."):
            taint = self.taint_of(call.args[0]) if call.args else None
            if taint and taint != _PARAM:
                return "shared artifact write json.dump()", taint
            return None
        if tail in _RUN_IDENTITY_TAILS:
            # Only the run_id kwarg must agree across processes; other
            # args (e.g. a per-process trace path) are intentionally
            # process-local.
            for kw in call.keywords:
                if kw.arg == "run_id":
                    taint = self.taint_of(kw.value)
                    if taint and taint != _PARAM:
                        return f"run identity {tail}(run_id=...)", taint
            return None
        return None

    # -- control flow ------------------------------------------------------

    def _if(self, stmt: ast.If) -> None:
        self._expr_effects(stmt.test)
        gate = _count_gate(stmt.test)
        if gate is not None:
            self._exact_count_gate(stmt, gate)
            return
        embedded = _boolop_count_gate(stmt.test)
        taint = self.taint_of(stmt.test)
        body_tails = _collective_tails(stmt.body)
        else_tails = _collective_tails(stmt.orelse)
        if taint and self.ctx != "single":
            if bool(body_tails) != bool(else_tails):
                self._flag(
                    "PSL006",
                    stmt.lineno,
                    stmt.col_offset,
                    f"branch on process-divergent state ({taint}) runs a "
                    "collective on one path but not the other — processes "
                    "taking different paths strand each other at the "
                    "rendezvous; hoist the collective out of the branch or "
                    "reach consensus first",
                )
            elif body_tails and else_tails and body_tails != else_tails:
                self._flag(
                    "PSL008",
                    stmt.lineno,
                    stmt.col_offset,
                    f"branch on process-divergent state ({taint}) orders "
                    f"collectives differently per path ({body_tails} vs "
                    f"{else_tails}) — processes taking different paths "
                    "rendezvous cross-matched and deadlock",
                )
        # Scan both branches, then join.
        before = dict(self.env)
        before_ctx = self.ctx
        pushed = bool(taint) and self.ctx != "single"
        if pushed:
            self.control.append(taint)
        if embedded == "body-multi":
            self.ctx = "multi" if before_ctx != "single" else "single"
        elif embedded == "body-single":
            self.ctx = "single"
        self._scan(stmt.body)
        body_env = self.env
        self.env = dict(before)
        self.ctx = before_ctx
        self._scan(stmt.orelse)
        else_env = self.env
        if pushed:
            self.control.pop()
        self.ctx = before_ctx
        # May-union join + implicit flow: anything assigned in either
        # branch of a tainted condition is control-dependent on it,
        # regardless of the branch-local value's own taint.
        joined: Dict[str, str] = {}
        for env in (body_env, else_env):
            for k, v in env.items():
                joined.setdefault(k, v)
        if taint and self.ctx != "single":
            for name in _assigned_names(stmt.body) | _assigned_names(stmt.orelse):
                if joined.get(name) != _PARAM:
                    joined[name] = taint
                if name.startswith("self."):
                    self.self_attr_taint.setdefault(name, taint)
        self.env = joined

    def _exact_count_gate(self, stmt: ast.If, gate: str) -> None:
        """``if dist.get_world_size() <cmp> k:`` (or ``if self.multi:``) — a
        deployment constant.

        The multi side's env is authoritative (divergence only matters
        when there are multiple processes); a terminating side flips the
        ambient ctx for the remainder of the function.
        """
        before = dict(self.env)
        before_ctx = self.ctx
        multi_body = gate == "body-multi"

        # body side
        self.ctx = ("multi" if multi_body else "single") if before_ctx != "single" else "single"
        self._scan(stmt.body)
        body_env = self.env
        body_terminates = _terminates(stmt.body)

        # else side
        self.env = dict(before)
        self.ctx = ("single" if multi_body else "multi") if before_ctx != "single" else "single"
        self._scan(stmt.orelse)
        else_env = self.env
        else_terminates = _terminates(stmt.orelse) if stmt.orelse else False

        multi_env = body_env if multi_body else else_env
        single_env = else_env if multi_body else body_env
        multi_terminates = body_terminates if multi_body else else_terminates
        single_terminates = else_terminates if multi_body else body_terminates

        if multi_terminates and not single_terminates:
            self.env = single_env
            self.ctx = "single"
        elif single_terminates and not multi_terminates:
            self.env = multi_env
            self.ctx = "multi" if before_ctx != "single" else "single"
        else:
            self.env = multi_env
            self.ctx = before_ctx

    def _for(self, stmt: ast.stmt) -> None:
        self._expr_effects(stmt.iter)
        taint = self.taint_of(stmt.iter)
        self._bind(stmt.target, taint)
        if taint and self.ctx != "single":
            tails = _collective_tails(stmt.body)
            if tails:
                self._flag(
                    "PSL006",
                    stmt.lineno,
                    stmt.col_offset,
                    f"loop over process-divergent state ({taint}) contains a "
                    f"collective ({tails[0]}) — iteration counts differ per "
                    "process, so some processes wait at a rendezvous others "
                    "never reach; agree on the iteration space first",
                )
        pushed = bool(taint) and self.ctx != "single"
        if pushed:
            self.control.append(taint)
        # Two passes propagate taint around the back edge; the emission
        # dedup set keeps findings single-shot.
        self._scan(stmt.body)
        self._scan(stmt.body)
        if pushed:
            self.control.pop()
        self._scan(stmt.orelse)

    def _while(self, stmt: ast.While) -> None:
        self._expr_effects(stmt.test)

        def check_once() -> None:
            taint = self.taint_of(stmt.test)
            if taint and self.ctx != "single":
                tails = _collective_tails(stmt.body)
                if tails:
                    self._flag(
                        "PSL006",
                        stmt.lineno,
                        stmt.col_offset,
                        f"while-loop guarded by process-divergent state "
                        f"({taint}) contains a collective ({tails[0]}) — "
                        "iteration counts differ per process, stranding the "
                        "rendezvous; use a consensus (all-reduce the "
                        "predicate) loop guard",
                    )

        check_once()
        taint = self.taint_of(stmt.test)
        pushed = bool(taint) and self.ctx != "single"
        if pushed:
            self.control.append(taint)
        self._scan(stmt.body)
        check_once()  # back edge may have tainted the predicate
        self._scan(stmt.body)
        taint2 = self.taint_of(stmt.test)
        if taint2 and not taint and self.ctx != "single":
            tails = _collective_tails(stmt.body)
            if tails:
                self._flag(
                    "PSL006",
                    stmt.lineno,
                    stmt.col_offset,
                    f"while-loop guarded by process-divergent state "
                    f"({taint2}) contains a collective ({tails[0]}) — "
                    "iteration counts differ per process, stranding the "
                    "rendezvous; use a consensus (all-reduce the "
                    "predicate) loop guard",
                )
        if pushed:
            self.control.pop()
        self._scan(stmt.orelse)

    def _try(self, stmt: ast.Try) -> None:
        before = dict(self.env)
        self._scan(stmt.body)
        after_body = dict(self.env)
        handler_envs: List[Dict[str, str]] = []
        for handler in stmt.handlers:
            self.env = dict(before)
            if handler.name:
                self.env[handler.name] = (
                    "caught-exception state (exceptions are per-process)"
                )
            self._scan(handler.body)
            handler_envs.append(self.env)
        # May-union join.
        joined = dict(after_body)
        for env in handler_envs:
            for k, v in env.items():
                joined.setdefault(k, v)
        self.env = joined
        self._scan(stmt.orelse)
        self._scan(stmt.finalbody)

    # -- PSL006(c): raise under divergent control, collective later --------

    def _check_stranded_raises(self) -> None:
        for i, (kind, lineno, data) in enumerate(self.events):
            if kind != "raise" or not data:
                continue
            later = [
                e for e in self.events[i + 1 :] if e[0] == "collective"
            ]
            if later:
                self._flag(
                    "PSL006",
                    lineno,
                    0,
                    f"raise under process-divergent control ({data[0]}) with "
                    f"a later collective ({later[0][2]} at line "
                    f"{later[0][1]}) still expecting this process — the "
                    "other processes block forever at the rendezvous; hold "
                    "the error, reach the collective, re-raise after "
                    "(see checkpoint.AsyncCheckpointer for the pattern)",
                )

    def _flag(self, rule: str, lineno: int, col: int, message: str) -> None:
        if self.summary_mode:
            return
        self.analysis.flag(rule, lineno, col, message)


def _fn_args(fn: ast.AST) -> List[str]:
    args = fn.args
    names = [
        a.arg
        for a in (
            list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)
        )
        if a.arg != "self"
    ]
    if args.vararg:
        names.append(args.vararg.arg)
    if args.kwarg:
        names.append(args.kwarg.arg)
    return names


# --------------------------------------------------------------------------
# Rule classes (registered in rules.RULES; share one analysis per tree).


def _shared_analysis(tree: ast.Module) -> _Analysis:
    cached = getattr(tree, "_psdiverge", None)
    if cached is None:
        cached = _Analysis(tree)
        tree._psdiverge = cached
    return cached


class _DivergeRuleBase:
    rule_id = ""

    def check(
        self, tree: ast.Module, path: str, axes, donors=None
    ) -> Iterator[Tuple[int, int, str]]:
        for f in _shared_analysis(tree).findings:
            if f.rule == self.rule_id:
                yield f.lineno, f.col, f.message


class DivergentGuardRule(_DivergeRuleBase):
    """PSL006: process-divergent state guards/strands a collective."""

    rule_id = "PSL006"


class DivergentTracedRule(_DivergeRuleBase):
    """PSL007: process-divergent value reaches a must-be-identical sink."""

    rule_id = "PSL007"


class DivergentOrderRule(_DivergeRuleBase):
    """PSL008: tainted branch orders collectives differently per path."""

    rule_id = "PSL008"


# --------------------------------------------------------------------------
# PSC110 companion: the package's consensus-point inventory.


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
