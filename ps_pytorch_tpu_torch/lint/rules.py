"""The pslint rules (PSL001-PSL008) restated for the port (the port of
lint/rules.py). Pure-AST: no torch import, no code execution.
PSL006-PSL008 (rank-divergence taint analysis) live in diverge.py and
are registered here.

Each rule is a class with `rule_id` and `check(tree, path, axes, donors)`
yielding (lineno, col, message) tuples. Shared helpers keep name
resolution (attribute-chain tails) consistent across rules.

The port runs PyTorch eagerly over a stacked worker axis (or
``ProcessWorkerAxis`` over ``torch.distributed``), with its kernels
behind ctypes. Each rule keeps the JAX rule's id and hazard and reads
the port's own form of it; its docstring says what it finds in the
package today.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

Finding3 = Tuple[int, int, str]


def _tail(func: ast.expr) -> Optional[str]:
    """`torch.cuda.synchronize` -> 'synchronize', `f` -> 'f', else None."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _dotted(node: ast.expr) -> str:
    """Best-effort dotted name: `np.random.uniform` -> 'np.random.uniform'."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _str_constants(node: ast.expr) -> Iterator[ast.Constant]:
    """String constants in `node`, descending through tuples/lists."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        yield node
    elif isinstance(node, (ast.Tuple, ast.List)):
        for elt in node.elts:
            yield from _str_constants(elt)


def _compound_bodies(stmt: ast.stmt) -> List[List[ast.stmt]]:
    """All statement blocks of a compound statement: body, orelse,
    finalbody, and every except-handler body."""
    bodies: List[List[ast.stmt]] = [stmt.body]
    for attr in ("orelse", "finalbody"):
        extra = getattr(stmt, attr, None)
        if extra:
            bodies.append(extra)
    for h in getattr(stmt, "handlers", []) or []:
        bodies.append(h.body)
    return bodies


def _arg(call: ast.Call, pos: int, kw: str) -> Optional[ast.expr]:
    if len(call.args) > pos and not any(
        isinstance(a, ast.Starred) for a in call.args[: pos + 1]
    ):
        return call.args[pos]
    for k in call.keywords:
        if k.arg == kw:
            return k.value
    return None


def _const_int_tuple(node: ast.expr) -> Tuple[int, ...]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        vals: List[int] = []
        for e in node.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, int):
                vals.append(e.value)
            else:
                return ()
        return tuple(vals)
    return ()


# ------------------------------------------------------------------- PSL001

class MeshAxisRule:
    """The port passes axes as objects (``WorkerAxis``), so an axis is
    named by a string only where it is data: ``PSConfig(axis_name=...)``,
    a model's ``bn_axis_name=``, the ``axes=`` of pscheck's contract
    specs and policies (and a ``Deviation``'s third argument), and the
    ``names=`` of ``check/axes.py``'s recording axes. A string literal
    there must match a declared ``*_AXIS`` constant of the port's
    ``parallel/`` and should BE the constant, so a rename there cannot
    orphan a contract; an unknown name is a finding of its own.

    Axis names also key data: a dict whose keys are all axis names (and
    whose values are no strings) is a per-axis table (``tune/search.py``'s
    ``{WORKER_AXIS: MESH_DEVICES}``),
    and ``name in row["axes"]`` tests an accounting row's axes
    (``tune/costmodel.py``). A known name spelled as a literal there is
    flagged too; other dict keys and membership tests are not axis
    positions and are left alone."""

    rule_id = "PSL001"

    AXIS_KEYWORDS = {"axis_name", "bn_axis_name", "axes", "names", "axis_names"}
    # func tail -> positional index of an axis-name argument
    AXIS_POSITIONAL = {"Deviation": 2}

    def check(self, tree: ast.AST, path: str, axes: Dict[str, str],
              donors: Dict[str, Tuple[int, ...]]) -> Iterable[Finding3]:
        known = ", ".join(sorted(axes))
        for node in ast.walk(tree):
            literals: List[ast.Constant] = []
            known_only = False
            if isinstance(node, ast.Call):
                for k in node.keywords:
                    if k.arg in self.AXIS_KEYWORDS:
                        literals.extend(_str_constants(k.value))
                pos = self.AXIS_POSITIONAL.get(_tail(node.func) or "")
                if pos is not None and len(node.args) > pos:
                    literals.extend(_str_constants(node.args[pos]))
            elif isinstance(node, ast.Dict):
                keys = [k for k in node.keys if k is not None]
                # a per-axis table: every key an axis name, no value a
                # string (a record such as {"model": "ResNet18"} is none)
                if keys and all(isinstance(k, ast.Constant) and isinstance(k.value, str)
                                and k.value in axes for k in keys) and not any(
                        isinstance(v, ast.Constant) and isinstance(v.value, str)
                        for v in node.values):
                    literals.extend(keys)  # type: ignore[arg-type]
                    known_only = True
            elif isinstance(node, ast.Compare):
                if (isinstance(node.left, ast.Constant) and isinstance(node.left.value, str)
                        and all(isinstance(op, (ast.In, ast.NotIn)) for op in node.ops)
                        and any(self._names_axes(c) for c in node.comparators)):
                    literals.append(node.left)
                    known_only = True
            for lit in literals:
                name = lit.value
                if name in axes:
                    yield (
                        lit.lineno,
                        lit.col_offset,
                        f"axis literal '{name}' — use the {axes[name]} "
                        f"constant from ps_pytorch_tpu_torch.parallel",
                    )
                elif not known_only:
                    yield (
                        lit.lineno,
                        lit.col_offset,
                        f"unknown mesh axis '{name}' (declared axes: {known})",
                    )

    @staticmethod
    def _names_axes(node: ast.expr) -> bool:
        """Does this expression read an ``axes`` / ``names`` field (an
        attribute, a subscript or a ``.get`` of that key)?"""
        for n in ast.walk(node):
            if isinstance(n, ast.Attribute) and n.attr in ("axes", "names"):
                return True
            if isinstance(n, ast.Constant) and n.value in ("axes", "names"):
                return True
        return False


# ------------------------------------------------------------------- PSL002

# the calls that compile or capture a program (torch.compile, TorchScript,
# CUDA graph capture) and the kernel library's build/load entry
# (ops/_build.py: nvcc and ctypes on first use)
COMPILE_CALLS = {
    "torch.compile", "torch.jit.script", "jit.script", "torch.jit.trace",
    "jit.trace", "torch.jit.trace_module", "torch.cuda.graph", "cuda.graph",
    "torch.cuda.CUDAGraph", "cuda.CUDAGraph", "CUDAGraph",
    "torch.cuda.make_graphed_callables", "make_graphed_callables",
    "_build.build", "_build.load",
}


def _is_compile_call(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and _dotted(node.func) in COMPILE_CALLS


class RecompilationRule:
    """A compiled or captured program must be built once, outside the
    hot path. Flags ``torch.compile``, ``torch.jit.script`` / ``trace``,
    CUDA graph capture (``torch.cuda.graph``, ``CUDAGraph``,
    ``make_graphed_callables``) and the kernel library's build/load
    entry (``_build.build`` / ``_build.load``) (a) called inside a
    per-iteration context — for/while loop bodies, while-tests,
    comprehension/generator element expressions (a for's iterable and
    else-bodies run once and are exempt), (b) applied to a lambda (a
    fresh callable per call never hits the compile cache), (c) compiled
    and immediately invoked inside such a context (``torch.compile(f)(x)``
    per iteration recompiles and discards; outside one, a single build +
    call is not a hazard).

    The package has no ``torch.compile``, TorchScript or CUDA graph
    today, and calls the library's ``load()`` once a wrapper call
    (cached after the first); the rule finds nothing there and guards
    what a later PR adds."""

    rule_id = "PSL002"

    _COMPREHENSIONS = (ast.ListComp, ast.SetComp, ast.DictComp,
                       ast.GeneratorExp)

    def check(self, tree: ast.AST, path: str, axes: Dict[str, str],
              donors: Dict[str, Tuple[int, ...]]) -> Iterable[Finding3]:
        yield from self._visit(tree, depth=0)

    def _check_node(self, node: ast.AST, depth: int) -> Iterator[Finding3]:
        if _is_compile_call(node):
            assert isinstance(node, ast.Call)
            what = _dotted(node.func)
            if depth > 0:
                yield (
                    node.lineno,
                    node.col_offset,
                    f"{what} called inside a loop — build the compiled "
                    "program once outside the hot path (each call "
                    "compiles or captures afresh)",
                )
            if node.args and isinstance(node.args[0], ast.Lambda):
                yield (
                    node.lineno,
                    node.col_offset,
                    f"{what} on a lambda — a fresh callable never hits "
                    "the compile cache across builders; hoist the body to "
                    "a module-level def (cache the result if built "
                    "per-config)",
                )
        if (
            isinstance(node, ast.Call)
            and _is_compile_call(node.func)
            # only certain-recompile sites: outside a loop, compiling
            # once and calling once is not a hazard
            and depth > 0
        ):
            yield (
                node.lineno,
                node.col_offset,
                "compile(...)(...) inside a loop compiles a fresh "
                "program every iteration and discards it — build it "
                "once, outside the loop",
            )

    def _visit(self, node: ast.AST, depth: int) -> Iterator[Finding3]:
        """Depth tracks how many per-iteration contexts enclose `node`.
        Loop HEADERS that run once (a for's iterable, else-bodies) stay at
        the enclosing depth; while-tests, loop bodies, and comprehension
        element/condition expressions are per-iteration."""
        yield from self._check_node(node, depth)
        if isinstance(node, (ast.For, ast.AsyncFor)):
            yield from self._visit(node.target, depth)
            yield from self._visit(node.iter, depth)  # evaluated once
            for n in node.body:
                yield from self._visit(n, depth + 1)
            for n in node.orelse:
                yield from self._visit(n, depth)  # else: runs once
        elif isinstance(node, ast.While):
            yield from self._visit(node.test, depth + 1)  # per iteration
            for n in node.body:
                yield from self._visit(n, depth + 1)
            for n in node.orelse:
                yield from self._visit(n, depth)
        elif isinstance(node, self._COMPREHENSIONS):
            first = node.generators[0]
            yield from self._visit(first.iter, depth)  # evaluated once
            for gen in node.generators:
                yield from self._visit(gen.target, depth + 1)
                for cond in gen.ifs:
                    yield from self._visit(cond, depth + 1)
            for gen in node.generators[1:]:
                yield from self._visit(gen.iter, depth + 1)
            if isinstance(node, ast.DictComp):
                yield from self._visit(node.key, depth + 1)
                yield from self._visit(node.value, depth + 1)
            else:
                yield from self._visit(node.elt, depth + 1)
        else:
            for child in ast.iter_child_nodes(node):
                yield from self._visit(child, depth)


# ------------------------------------------------------------------- PSL003

class TracedPurityRule:
    """Side effects inside what runs once and is replayed happen once (at
    compile or capture time) or never again: prints vanish, clock reads
    freeze, ``np.random`` / ``random`` draws become constants, and
    mutation of closure or global state desyncs from the replays.
    Replayed = decorated with ``torch.compile`` / ``torch.jit.script``,
    passed (by name, through ``functools.partial``, or as a lambda) to
    ``torch.compile`` / TorchScript / ``make_graphed_callables`` or to a
    ``torch.func`` transform (``vmap``, ``grad``, ``grad_and_value``,
    ``vjp``, ``jvp``, ``jacrev``, ``jacfwd``, ``functional_call``), the
    body of a ``with torch.cuda.graph(...)`` capture, and — in a module
    that compiles or captures — the ``forward`` / ``backward`` of a
    ``torch.autograd.Function`` subclass; every nested def inside one
    is replayed too.

    The package holds two ``autograd.Function`` subclasses
    (``ops/flash_attention._Flash``, ``parallel/ring_attention._RingFlash``)
    that no compile or capture reaches, and no ``torch.func`` transform;
    the rule finds nothing there today."""

    rule_id = "PSL003"

    # the transforms, by the module they come from
    FUNC_TRANSFORMS = {"vmap", "grad", "grad_and_value", "vjp", "jvp", "jacrev",
                       "jacfwd", "functional_call"}
    FUNC_MODULES = ("torch.func", "functorch")
    COMPILERS = {"torch.compile", "torch.jit.script", "jit.script", "torch.jit.trace",
                 "jit.trace", "torch.cuda.make_graphed_callables",
                 "make_graphed_callables", "torch.vmap"}
    CLOCK_CALLS = {
        "time.time", "time.perf_counter", "time.monotonic",
        "time.process_time", "datetime.datetime.now", "datetime.now",
    }
    MUTATORS = {"append", "extend", "insert", "pop", "remove", "clear",
                "update", "setdefault"}

    def _is_tracer(self, func: ast.expr, imported: Set[str]) -> bool:
        """A compiler, or a ``torch.func`` transform (``torch.func.vmap``,
        ``func.grad``, or a name imported from ``torch.func``);
        ``torch.autograd.grad`` is eager and is not one."""
        dotted = _dotted(func)
        if dotted in self.COMPILERS:
            return True
        tail = _tail(func)
        if tail not in self.FUNC_TRANSFORMS:
            return False
        if isinstance(func, ast.Name):
            return tail in imported
        return dotted.rsplit(".", 1)[0] in self.FUNC_MODULES + ("func",)

    def check(self, tree: ast.AST, path: str, axes: Dict[str, str],
              donors: Dict[str, Tuple[int, ...]]) -> Iterable[Finding3]:
        defs: Dict[str, List[ast.AST]] = {}
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs.setdefault(node.name, []).append(node)

        traced: List[ast.AST] = []
        seen: Set[int] = set()

        def mark(fn: ast.AST) -> None:
            if id(fn) not in seen:
                seen.add(id(fn))
                traced.append(fn)

        imported: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module in self.FUNC_MODULES:
                imported.update(a.asname or a.name for a in node.names)
        captures = False
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    d = dec.func if isinstance(dec, ast.Call) else dec
                    if _dotted(d) in ("torch.compile", "torch.jit.script", "jit.script"):
                        mark(node)
                        captures = True
            elif isinstance(node, ast.Call) and self._is_tracer(node.func, imported):
                captures = True
                for a in node.args:
                    # unwrap functools.partial(fn, ...): fn is what traces
                    if isinstance(a, ast.Call) and _tail(a.func) == "partial" and a.args:
                        a = a.args[0]
                    if isinstance(a, ast.Lambda):
                        mark(a)
                    elif isinstance(a, ast.Name):
                        for fn in defs.get(a.id, ()):
                            mark(fn)
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                if any(isinstance(item.context_expr, ast.Call)
                       and _dotted(item.context_expr.func) in ("torch.cuda.graph",
                                                               "cuda.graph")
                       for item in node.items):
                    captures = True
                    mark(node)
        if captures:
            for node in ast.walk(tree):
                if isinstance(node, ast.ClassDef) and any(
                        _dotted(b) in ("torch.autograd.Function", "autograd.Function",
                                       "Function") for b in node.bases):
                    for sub in node.body:
                        if (isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                                and sub.name in ("forward", "backward")):
                            mark(sub)

        for fn in traced:
            yield from self._check_traced(fn)

    def _check_traced(self, fn: ast.AST) -> Iterator[Finding3]:
        local: Set[str] = set()
        args = getattr(fn, "args", None)
        if isinstance(args, ast.arguments):
            for a in (
                list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)
                + ([args.vararg] if args.vararg else [])
                + ([args.kwarg] if args.kwarg else [])
            ):
                local.add(a.arg)
        for node in ast.walk(fn):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
                local.add(node.id)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                local.add(node.name)
                for a in (
                    list(node.args.posonlyargs) + list(node.args.args)
                    + list(node.args.kwonlyargs)
                    + ([node.args.vararg] if node.args.vararg else [])
                    + ([node.args.kwarg] if node.args.kwarg else [])
                ):
                    local.add(a.arg)

        for node in ast.walk(fn):
            if isinstance(node, ast.Global):
                yield (
                    node.lineno, node.col_offset,
                    "`global` inside a compiled or captured function — the "
                    "mutation happens once, at compile/capture time, and "
                    "never in the replays",
                )
            elif isinstance(node, ast.Call):
                dotted = _dotted(node.func)
                tail = _tail(node.func)
                if tail == "print" and isinstance(node.func, ast.Name):
                    yield (
                        node.lineno, node.col_offset,
                        "print() inside a compiled or captured function runs "
                        "at compile/capture time, not in the replays — print "
                        "on the host, around the call",
                    )
                elif dotted in self.CLOCK_CALLS:
                    yield (
                        node.lineno, node.col_offset,
                        f"{dotted}() inside a compiled or captured function "
                        "freezes to its compile-time value — time on the host, "
                        "around the call",
                    )
                elif re.match(r"^(np|numpy|random)\.", dotted) and (
                        dotted.startswith("random.") or ".random." in dotted):
                    yield (
                        node.lineno, node.col_offset,
                        f"{dotted}() inside a compiled or captured function is "
                        "drawn once and replayed as a constant — draw with a "
                        "torch.Generator and pass the draws in",
                    )
            elif isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
                # bare mutator statement (`lst.append(x)`): result unused,
                # so the call exists only for its side effect, which a
                # replay never repeats
                call = node.value
                if (
                    isinstance(call.func, ast.Attribute)
                    and call.func.attr in self.MUTATORS
                    and isinstance(call.func.value, ast.Name)
                    and call.func.value.id not in local
                ):
                    yield (
                        call.lineno, call.col_offset,
                        f"mutation of closure/global '{call.func.value.id}."
                        f"{call.func.attr}()' inside a compiled or captured "
                        "function — runs once, not in the replays; return the "
                        "value instead",
                    )
            elif (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Subscript)
                and isinstance(node.targets[0].value, ast.Name)
                and node.targets[0].value.id not in local
            ):
                yield (
                    node.lineno, node.col_offset,
                    f"subscript-assignment to closure/global "
                    f"'{node.targets[0].value.id}' inside a compiled or "
                    "captured function — runs once, not in the replays",
                )


# ------------------------------------------------------------------- PSL004

class HostSyncRule:
    """Hot-path loop bodies must not pull device values to the host every
    step: each read waits for the card and serializes the launch queue.
    The torch syncs: ``.item()``, ``.tolist()``, ``.cpu()``,
    ``.numpy()``, ``.to("cpu")``, ``torch.cuda.synchronize()`` and any
    ``Event`` / ``Stream`` ``.synchronize()``, always; ``float`` /
    ``int`` / ``bool`` and ``np.asarray`` / ``np.array`` of a value a
    step call returned (taint is flow-sensitive, as in JAX: a read that
    fetches untaints its target from that point on). Periodic,
    intentional reads carry a ``# psl: sync-ok`` pragma with their
    reason. Scope: modules named in HOT_MODULES — the training driver
    and the serving request loop (serve/engine.py), where a stray
    per-token read beyond the scheduler's one fused [slots] read would
    serialize every decode tick."""

    rule_id = "PSL004"

    # entries with a "/" match as path suffixes (pinning the rule to THE
    # serve engine, not any future module that happens to be named
    # engine.py); bare names match by basename
    HOT_MODULES = {"trainer.py", "serve/engine.py"}
    # directory trees where EVERY function is a hot-path loop body by
    # contract, scanned in STRICT mode: the observability layer runs
    # inside the training/serving tick, so any host sync it introduces
    # perturbs the run it measures. Strict mode additionally flags
    # utils/sync.host_sync — elsewhere the blessed timing barrier, here a
    # new sync the traced run would not otherwise have (the profiler
    # window's one stop barrier carries `# psl: sync-ok`).
    HOT_TREES = ("ps_pytorch_tpu_torch/obs/",)
    STEP_CALL_RE = re.compile(r"(^|[._])(train_|eval_)?step(_fn)?$")
    # a per-step entry point (the serving engine's tick()) IS a loop
    # body by contract — its caller invokes it once per decode step —
    # so its top level is scanned at loop depth 1 even though the
    # enclosing `while` lives in another function
    HOT_FN_RE = re.compile(r"^_?tick\w*$")
    # method calls that copy a device value to the host (or wait for it)
    SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
    # calls that make a host value of their (tainted) argument
    HOST_CASTS = {"float", "int", "bool"}
    HOST_ARRAYS = {"np.asarray", "numpy.asarray", "np.array", "numpy.array"}

    _COMPOUND = (ast.For, ast.AsyncFor, ast.While, ast.If, ast.With,
                 ast.AsyncWith, ast.Try)

    def _is_hot(self, path: str) -> bool:
        norm = path.replace(os.sep, "/")
        for mod in self.HOT_MODULES:
            if "/" in mod:
                if norm == mod or norm.endswith("/" + mod):
                    return True
            elif os.path.basename(path) == mod:
                return True
        return False

    def _in_hot_tree(self, path: str) -> bool:
        norm = "/" + path.replace(os.sep, "/")
        return any("/" + tree in norm for tree in self.HOT_TREES)

    def check(self, tree: ast.AST, path: str, axes: Dict[str, str],
              donors: Dict[str, Tuple[int, ...]]) -> Iterable[Finding3]:
        strict = self._in_hot_tree(path)
        if not strict and not self._is_hot(path):
            return
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # flow-sensitive: taint follows statement order, so a
                # periodic `metrics = {k: float(v) ...}` inside a log
                # window untaints only from that point on — per-step
                # syncs on the same name BEFORE the read still flag
                depth0 = (
                    1 if strict or self.HOT_FN_RE.match(node.name) else 0
                )
                yield from self._scan_block(
                    node.body, tainted=set(), loop_depth=depth0,
                    flagged=set(), strict=strict,
                )

    @staticmethod
    def _to_cpu(call: ast.Call) -> bool:
        """``x.to("cpu")``, ``x.to(device="cpu")``, ``x.to(torch.device("cpu"))``."""
        if _tail(call.func) != "to" or not isinstance(call.func, ast.Attribute):
            return False
        for a in list(call.args[:1]) + [k.value for k in call.keywords if k.arg == "device"]:
            if isinstance(a, ast.Constant) and a.value == "cpu":
                return True
            if (isinstance(a, ast.Call) and _tail(a.func) == "device" and a.args
                    and isinstance(a.args[0], ast.Constant) and a.args[0].value == "cpu"):
                return True
        return False

    def _sync_message(self, n: ast.Call, tainted: Set[str], strict: bool) -> Optional[str]:
        tail = _tail(n.func)

        def refs_tainted(expr: ast.expr) -> bool:
            return any(
                isinstance(m, ast.Name) and m.id in tainted
                for m in ast.walk(expr)
            )

        if tail in self.SYNC_METHODS and isinstance(n.func, ast.Attribute):
            if tail == "synchronize":
                return (
                    f"{_dotted(n.func) or '.synchronize'}() in a hot-path loop "
                    "waits for the card every step — keep the wait in the "
                    "periodic window or mark an intended one `# psl: sync-ok`"
                )
            return (
                f".{tail}() in a hot-path loop forces a device->host "
                "sync every step"
            )
        if self._to_cpu(n):
            return ".to('cpu') in a hot-path loop forces a device->host sync every step"
        if (
            tail in self.HOST_CASTS
            and isinstance(n.func, ast.Name)
            and n.args
            and refs_tainted(n.args[0])
        ):
            return (
                f"{tail}() on a device value in a hot-path loop "
                "forces a sync every step — read metrics "
                "periodically instead"
            )
        if (
            _dotted(n.func) in self.HOST_ARRAYS
            and n.args
            and refs_tainted(n.args[0])
        ):
            return (
                f"{_dotted(n.func)} on a device value in a hot-path loop "
                "copies to host synchronously every step"
            )
        if strict and tail == "host_sync":
            return (
                "host_sync in observability code adds a host sync the "
                "traced run would not otherwise pay — the tracer must "
                "reuse the driver's existing per-window sync points (a "
                "deliberate once-per-capture profiler barrier may carry "
                "`# psl: sync-ok`)"
            )
        return None

    def _flag_stmt(
        self, stmt: ast.stmt, tainted: Set[str], loop_depth: int,
        flagged: Set[int], strict: bool = False,
    ) -> Iterator[Finding3]:
        if loop_depth == 0:
            return
        # a comprehension over a device value binds device values
        # (`{k: float(v) for k, v in metrics.items()}`)
        tainted = set(tainted)
        for n in ast.walk(stmt):
            if isinstance(n, (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)):
                for gen in n.generators:
                    if any(isinstance(m, ast.Name) and m.id in tainted
                           for m in ast.walk(gen.iter)):
                        tainted |= {t.id for t in ast.walk(gen.target)
                                    if isinstance(t, ast.Name)}
        for n in ast.walk(stmt):
            if not isinstance(n, ast.Call) or id(n) in flagged:
                continue
            msg = self._sync_message(n, tainted, strict)
            if msg is not None:
                flagged.add(id(n))
                yield (n.lineno, n.col_offset, msg)

    def _fetches(self, call: ast.Call) -> bool:
        """A call that brings its value to the host (it untaints)."""
        tail = _tail(call.func)
        return ((tail in self.SYNC_METHODS and isinstance(call.func, ast.Attribute))
                or self._to_cpu(call) or tail in self.HOST_CASTS
                or _dotted(call.func) in self.HOST_ARRAYS or tail == "host_sync")

    def _apply_taint(self, stmt: ast.stmt, tainted: Set[str]) -> None:
        if not isinstance(stmt, ast.Assign):
            return
        calls = [n for n in ast.walk(stmt.value) if isinstance(n, ast.Call)]
        from_step = any(
            self.STEP_CALL_RE.search(_dotted(c.func) or "") for c in calls
        )
        fetched = any(self._fetches(c) for c in calls)
        names = {
            t.id
            for tgt in stmt.targets
            for t in ast.walk(tgt)
            if isinstance(t, ast.Name) and isinstance(t.ctx, ast.Store)
        }
        if from_step and not fetched:
            tainted |= names
        else:
            # any other rebinding (a host read, a fresh dict, ...) kills
            # the taint from this point in the flow on
            tainted -= names

    def _scan_block(
        self, stmts: List[ast.stmt], tainted: Set[str], loop_depth: int,
        flagged: Set[int], strict: bool = False,
    ) -> Iterator[Finding3]:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, self._COMPOUND):
                headers: List[Tuple[ast.expr, int]] = []
                for attr in ("test", "iter"):
                    header = getattr(stmt, attr, None)
                    if header is not None:
                        # a while-test re-runs every iteration, so it sits
                        # INSIDE its own loop; a for's iterable (and an
                        # if-test) evaluates at the enclosing depth
                        headers.append((header, loop_depth + 1
                                        if isinstance(stmt, ast.While) and attr == "test"
                                        else loop_depth))
                for item in getattr(stmt, "items", []) or []:
                    headers.append((item.context_expr, loop_depth))
                for header, header_depth in headers:
                    yield from self._flag_stmt(
                        ast.Expr(value=header), tainted, header_depth,
                        flagged, strict,
                    )
                bodies = _compound_bodies(stmt)
                if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                    # two passes: a step call at the top of the loop body
                    # re-taints names a window read untainted at the
                    # bottom, matching the next iteration's flow
                    for _ in range(2):
                        for b in bodies:
                            yield from self._scan_block(
                                b, tainted, loop_depth + 1, flagged, strict
                            )
                    if isinstance(stmt, ast.While):
                        # back-edge: the test re-runs with the body's taint
                        yield from self._flag_stmt(
                            ast.Expr(value=stmt.test), tainted,
                            loop_depth + 1, flagged, strict,
                        )
                else:
                    for b in bodies:
                        yield from self._scan_block(
                            b, tainted, loop_depth, flagged, strict
                        )
            else:
                yield from self._flag_stmt(
                    stmt, tainted, loop_depth, flagged, strict
                )
                self._apply_taint(stmt, tainted)


# ------------------------------------------------------------------- PSL005

# step factories: a call whose tail names a step builder
_FACTORY_RE = re.compile(r"^make_\w*step$")


def _spec_factories(fn: ast.AST, helpers: Dict[str, Set[str]]) -> Set[str]:
    """The step factories a spec builder reaches: each ``Built(step=...)``
    call inside it (``step=make_..._step(...)``, or a name bound to one),
    and those of the module-local helpers it calls."""
    bound: Dict[str, str] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            name = _tail(node.value.func)
            if name and _FACTORY_RE.match(name):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        bound[t.id] = name
    out: Set[str] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        tail = _tail(node.func)
        if tail == "Built":
            for k in node.keywords:
                if k.arg != "step":
                    continue
                if isinstance(k.value, ast.Call):
                    name = _tail(k.value.func)
                    if name and _FACTORY_RE.match(name):
                        out.add(name)
                elif isinstance(k.value, ast.Name) and k.value.id in bound:
                    out.add(bound[k.value.id])
        elif tail in helpers:
            out |= helpers[tail]
    return out


def collect_donor_factories(tree: ast.AST) -> Dict[str, Tuple[int, ...]]:
    """The port's consumed-state declarations: pscheck's contract specs
    (``check/contracts.py``) carry ``donation=DonationSpec(argnums=...)``
    (check/core.py restates donation: the step consumes those arguments
    and returns their successors) and a ``build`` that returns
    ``Built(step=make_..._step(...), ...)``. Each factory a spec's builder
    reaches (directly or through a module-local helper) maps to the
    spec's consumed positions, read from source as JAX's
    ``collect_donor_factories`` reads ``donate_argnums``."""
    if not any(isinstance(n, ast.Call) and _tail(n.func) == "DonationSpec"
               for n in ast.walk(tree)):
        return {}
    funcs = [n for n in ast.walk(tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    helpers: Dict[str, Set[str]] = {}
    for _ in range(2):  # a helper may call another helper
        for fn in funcs:
            found = _spec_factories(fn, helpers)
            if found:
                helpers[fn.name] = helpers.get(fn.name, set()) | found
    out: Dict[str, Tuple[int, ...]] = {}
    for fn in funcs:
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call) and _tail(node.func) == "DonationSpec"):
                continue
            nums = _const_int_tuple(_arg(node, 0, "argnums") or ast.Tuple(elts=[]))
            if not nums:
                continue
            for name in sorted(_spec_factories(fn, helpers)):
                out[name] = nums
    return out


class DonationReuseRule:
    """Reuse of consumed state. torch donates no buffers (check/core.py
    restates donation), so the hazard is the stale read: a step built by
    a factory that pscheck declares consuming (``DonationSpec`` in
    ``check/contracts.py``: ``make_ps_train_step``'s state,
    ``make_lm_train_step`` / ``make_dp_tp_train_step`` / ... 's params and
    optimizer state, ``make_decode_step``'s KV pool, which it writes in
    place) returns the successor of what it consumed, and a later read of
    the old name sees the state before the step (or, for the pool, the
    same buffer under two names) and keeps a second copy of it alive.
    Flags reads of a variable after it was passed in a consumed position
    without being rebound. Factories are discovered from the linted
    sources (and the port's own ``check/``); a call site that passes
    ``donate=False`` to a factory is exempt.

    The package's steps return fresh state, and its in-place writers
    return nothing (``ops.quantize.quantize_kv_write`` and
    ``serve.kv.write_slot`` / ``write_token`` write the pool's views;
    ``ServingEngine._try_swap`` ``copy_``s into the flat buffer): a read
    after them is the intended read of the new contents, so the rule
    guards the factories' step calls only."""

    rule_id = "PSL005"

    _COMPOUND = (ast.For, ast.AsyncFor, ast.While, ast.If, ast.With,
                 ast.AsyncWith, ast.Try)

    def check(self, tree: ast.AST, path: str, axes: Dict[str, str],
              donors: Dict[str, Tuple[int, ...]]) -> Iterable[Finding3]:
        # step vars assigned anywhere in the module (module level or any
        # function) are visible to nested scopes via closures — collect a
        # module-wide seed so `def run(...): step(...)` is still checked
        seed: Dict[str, Tuple[int, ...]] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                self._register(node, node.value, donors, seed)
        scopes: List[List[ast.stmt]] = [tree.body] + [
            n.body for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        for body in scopes:
            yield from self._scan_block(body, donors, dict(seed), {})

    def _register(
        self,
        stmt: ast.Assign,
        call: ast.Call,
        donors: Dict[str, Tuple[int, ...]],
        step_vars: Dict[str, Tuple[int, ...]],
    ) -> None:
        """`x = <factory>(...)`."""
        tail = _tail(call.func)
        targets = [t for t in stmt.targets if isinstance(t, ast.Name)]
        if not targets or tail not in donors:
            return
        opted_out = any(
            k.arg == "donate"
            and isinstance(k.value, ast.Constant)
            and k.value.value is False
            for k in call.keywords
        )
        for tgt in targets:
            if opted_out:
                step_vars.pop(tgt.id, None)
            else:
                step_vars[tgt.id] = donors[tail]

    def _process_exprs(
        self,
        nodes: List[ast.AST],
        step_vars: Dict[str, Tuple[int, ...]],
        consumed: Dict[str, str],
    ) -> Iterator[Finding3]:
        """Steps for one simple statement (or a compound header): report
        loads of consumed names, then apply this statement's consumption.

        Lambda bodies are excluded: their execution is deferred and their
        parameters shadow enclosing names, so neither their loads nor the
        step calls inside them happen at this statement."""

        def walk_no_lambda(node: ast.AST) -> Iterator[ast.AST]:
            if isinstance(node, (ast.Lambda, ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                return
            yield node
            for child in ast.iter_child_nodes(node):
                yield from walk_no_lambda(child)

        walked = [n for node in nodes for n in walk_no_lambda(node)]
        for n in walked:
            if (
                isinstance(n, ast.Name)
                and isinstance(n.ctx, ast.Load)
                and n.id in consumed
            ):
                yield (
                    n.lineno, n.col_offset,
                    f"'{n.id}' read after being consumed by "
                    f"{consumed[n.id]} — the step returned its successor; "
                    "rebind the result (the old name is stale and keeps "
                    "the old state alive)",
                )
                consumed.pop(n.id, None)  # one report per consumption
        for n in walked:
            if (
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Name)
                and n.func.id in step_vars
            ):
                for pos in step_vars[n.func.id]:
                    if pos < len(n.args) and isinstance(n.args[pos], ast.Name):
                        consumed[n.args[pos].id] = f"'{n.func.id}'"
        for n in walked:
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                consumed.pop(n.id, None)

    def _scan_block(
        self,
        stmts: List[ast.stmt],
        donors: Dict[str, Tuple[int, ...]],
        step_vars: Dict[str, Tuple[int, ...]],
        consumed: Dict[str, str],
    ) -> Iterator[Finding3]:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # nested scopes are scanned separately
            if isinstance(stmt, ast.Assign):
                # a name rebound to anything but a factory's step is no
                # longer that step (the module-wide seed may hold another
                # scope's `step`)
                for tgt in stmt.targets:
                    for t in ast.walk(tgt):
                        if isinstance(t, ast.Name) and isinstance(t.ctx, ast.Store):
                            step_vars.pop(t.id, None)
                if isinstance(stmt.value, ast.Call):
                    self._register(stmt, stmt.value, donors, step_vars)
            if isinstance(stmt, self._COMPOUND):
                headers: List[ast.AST] = []
                for attr in ("test", "iter", "target"):
                    v = getattr(stmt, attr, None)
                    if v is not None:
                        headers.append(v)
                for item in getattr(stmt, "items", []) or []:
                    headers.append(item.context_expr)
                    if item.optional_vars is not None:
                        headers.append(item.optional_vars)
                yield from self._process_exprs(headers, step_vars, consumed)
                bodies = _compound_bodies(stmt)
                if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                    # two passes: a consumption at the bottom of the loop
                    # body reaches a load at the top on the next iteration
                    shadow = dict(consumed)
                    for b in bodies:
                        for _ in self._scan_block(b, donors, step_vars, shadow):
                            pass
                    consumed.update(shadow)
                for b in bodies:
                    yield from self._scan_block(b, donors, step_vars, consumed)
            else:
                yield from self._process_exprs([stmt], step_vars, consumed)


# Imported at the bottom so diverge.py can reuse this module's helpers
# (STEP_CALL_RE, _dotted, _tail) without a circular import at load time.
from .diverge import (  # noqa: E402
    DivergentGuardRule,
    DivergentOrderRule,
    DivergentTracedRule,
)

RULES = [
    MeshAxisRule(),
    RecompilationRule(),
    TracedPurityRule(),
    HostSyncRule(),
    DonationReuseRule(),
    DivergentGuardRule(),
    DivergentTracedRule(),
    DivergentOrderRule(),
]
RULE_IDS = tuple(r.rule_id for r in RULES)
