"""psnumerics: precision-flow analysis over a recorded step (PSC111-114;
the port of check/numerics.py).

The walker (``walker.py``) measures WHERE the collectives are; this
module proves WHAT the quantized wire's numbers can be. A forward
abstract interpretation over the tape (``Tape.nodes`` in execution
order, each value by its id) tracks, per value,

- an interval bound (``lo`` / ``hi``): the worst-case value range on the
  integer lattice (int8 payloads enter at +-127 through the clamp;
  collectives and reductions multiply it by their summand counts);
- scale provenance (``roots``): the max-abs reductions (an ``abs``
  feeding a max) its scale chain descends from;
- payload provenance (``sites``): the quantization sites (bounded
  float -> int converts) it descends from;
- residual provenance (``deqs``): the dequantizations it descends from
  (the error-feedback closure, PSC112).

The transfer table is JAX's, keyed by aten overload instead of jaxpr
primitive (``_Analyzer._aten_value``): ``_to_copy`` is ``convert_element_type``,
``clamp`` / ``clamp_min`` / ``maximum`` the clamp, ``amax`` / ``max`` a
``reduce_max``, ``sum`` a ``reduce_sum`` over the summed dimensions,
``where`` a ``select_n``; a collective node multiplies by its recording
axis's summand count (the hierarchical grid's tuple axis by the product
of both sub-axes); a kernel node replays the events JAX's analyzer
derives from the jnp version of the same function (``KERNEL_EVENTS``,
declared on the wrapper by ``ops/_tape.kernel_entry(numerics=...)``, so
the CPU, which runs the plain versions inside the node, and the card,
which runs the kernels, give the same report).

Bounds are structural, never observed: a step's arguments (state,
batch, draws, the adaptive count in device memory) are unknown, as a
jaxpr's invars; a Python number in a call, a filled tensor
(``torch.full``, ``zeros``), and a small tensor the step closes over (a
jaxpr constvar, ``walker.Value.const``) are constants. No recorded value
of the data sets a bound.

Differences from the JAX analyzer:

- the tape is straight-line: the GPipe ticks and the worker loop run
  unrolled, so JAX's loop-carry fixpoint (``scan`` / ``while`` bounds
  degraded to unknown) has no counterpart and every event is
  ``conservative=False`` (ROADMAP.md queue 3, ``straight_line_tape``);
- a site of a worker-stacked operand keeps the worker dimension in its
  ``shape``, ``size`` and ``start_offset`` where the operand is plain
  PyTorch (JAX's per-device program sees one worker's rows); a kernel
  node declares per-worker shapes;
- node ids (``roots``) number the analyzer's own graph, not JAX's.

Everything here is pure data over the tape: nothing executes.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

from .walker import Ref, Tape

# the int8 wire's clamp and its scale's f32 reciprocal (ops/quantize.py)
_PEAK = 127.0
_RECIP_127 = float(np.float32(1.0) / np.float32(127.0))

_EMPTY: FrozenSet[int] = frozenset()

# integer dtypes: (min, max); float dtypes: mantissa bits (+ implicit)
_INT_RANGE = {
    "int8": (-128, 127), "uint8": (0, 255), "int16": (-32768, 32767),
    "int32": (-(2 ** 31), 2 ** 31 - 1), "int64": (-(2 ** 63), 2 ** 63 - 1),
}
_MANT = {"float64": 53, "float32": 24, "float16": 11, "bfloat16": 8,
         "float8_e4m3fn": 4, "float8_e5m2": 3}


def _is_int(dtype: str) -> bool:
    return dtype in _INT_RANGE


def _is_float(dtype: str) -> bool:
    return dtype in _MANT


def _int_cap(dtype: str) -> Optional[int]:
    r = _INT_RANGE.get(dtype)
    return None if r is None else r[1]


def _narrows(src: str, dst: str) -> bool:
    """True when a convert src->dst can silently lose precision."""
    if src == "bool" or dst == "bool":
        return False
    if _is_int(dst) and _is_float(src):
        return True  # drops fractions; only a quantize site may do this
    if _is_int(src) and _is_int(dst):
        (smin, smax), (dmin, dmax) = _INT_RANGE[src], _INT_RANGE[dst]
        return dmax < smax or dmin > smin
    if _is_float(src) and _is_float(dst):
        return _MANT[dst] < _MANT[src]
    return False  # int -> float: the lattice-aware check handles it


def _itemsize(dtype: str) -> int:
    return {"int8": 1, "uint8": 1, "int16": 2, "int32": 4, "int64": 8}.get(dtype, 8)


# ------------------------------------------------------------------ events


@dataclasses.dataclass(frozen=True)
class QuantSite:
    """A bounded float->int (or narrowing int->int) convert: one
    quantization point on the wire lattice."""

    sid: int
    dtype: str                     # target integer dtype
    shape: Tuple[int, ...]
    size: int
    start_offset: int              # cumulative grad-path element offset
    peak: Optional[float]          # clamp bound carried into the convert
    pre_peak: Optional[float]      # worst-case |value| BEFORE the clamp
    roots: FrozenSet[int]          # max-abs reductions its scale chain saw
    primary: bool                  # quantizes fresh float (not a requant)
    conservative: bool             # inside a loop body (never, on a tape)
    feeds_params: bool = False


@dataclasses.dataclass(frozen=True)
class DequantEvent:
    """A multiply (or divide) of lattice payload by a scale, leaving the
    integer lattice: the point PSC111 audits for scale provenance."""

    did: int
    payload_sites: FrozenSet[int]
    scale_roots: FrozenSet[int]
    scale_literal: bool            # scale is a static constant
    conservative: bool
    feeds_params: bool = False


@dataclasses.dataclass(frozen=True)
class AccumEvent:
    """One integer accumulation (psum / psum_scatter / reduce_sum /
    narrowing convert / int->float mantissa exit) with its worst-case
    |sum| against the dtype's capacity."""

    kind: str                      # psum|psum_scatter|reduce_sum|convert|mantissa|add|mul
    dtype: str                     # accumulator / target dtype
    axes: Tuple[str, ...]          # collective axes (empty for local ops)
    multiplier: Optional[int]      # summand count (None: unknown axis)
    peak_in: Optional[float]
    peak_out: Optional[float]
    capacity: Optional[int]
    lattice: bool                  # payload descends from a quant site
    conservative: bool
    feeds_params: bool = False


@dataclasses.dataclass(frozen=True)
class NarrowEvent:
    """A precision-narrowing convert (PSC114 raw material)."""

    src: str
    dst: str
    is_quant_site: bool
    downstream_of_reduce: bool
    conservative: bool
    feeds_params: bool = False


@dataclasses.dataclass(frozen=True)
class ResidualEvent:
    """A subtract whose subtrahend descends from a dequantization: the
    grad - dequant(quant(grad)) error-feedback residual shape."""

    rid: int
    covered_sites: FrozenSet[int]  # primary quant sites this closes
    feeds_carry: bool              # reaches a non-param step output
    feeds_params: bool             # double-count hazard when True
    conservative: bool


@dataclasses.dataclass
class NumericsReport:
    """The full precision-flow record for one recorded step."""

    sites: Tuple[QuantSite, ...]
    dequants: Tuple[DequantEvent, ...]
    accums: Tuple[AccumEvent, ...]
    narrows: Tuple[NarrowEvent, ...]
    residuals: Tuple[ResidualEvent, ...]
    axis_sizes: Dict[str, int]

    def grad_sites(self) -> List[QuantSite]:
        return [s for s in self.sites if s.feeds_params]


# ------------------------------------------------------------------- state


class _St:
    """Abstract value: interval + provenance. Never mutated once shared;
    ``bottom`` is the state of an unwritten buffer (``torch.empty``),
    the identity of ``_join``."""

    __slots__ = ("lo", "hi", "roots", "sites", "deqs", "is_abs", "pre", "post", "bottom")

    def __init__(self, lo=None, hi=None, roots=_EMPTY, sites=_EMPTY, deqs=_EMPTY,
                 is_abs=False, pre=None, post=False, bottom=False):
        self.lo = lo
        self.hi = hi
        self.roots = roots
        self.sites = sites
        self.deqs = deqs
        self.is_abs = is_abs
        self.pre = pre
        self.post = post
        self.bottom = bottom

    def peak(self) -> Optional[float]:
        if self.lo is None or self.hi is None:
            return None
        return max(abs(self.lo), abs(self.hi))


def _union(ins: Sequence[_St], lo=None, hi=None, is_abs=False, pre=None) -> _St:
    roots = sites = deqs = _EMPTY
    post = False
    for s in ins:
        roots |= s.roots
        sites |= s.sites
        deqs |= s.deqs
        post = post or s.post
    return _St(lo=lo, hi=hi, roots=roots, sites=sites, deqs=deqs, is_abs=is_abs, pre=pre,
               post=post)


def _join(a: _St, b: _St) -> _St:
    """Least upper bound: interval hull + provenance union."""
    if a.bottom:
        return b
    if b.bottom:
        return a
    lo = None if (a.lo is None or b.lo is None) else min(a.lo, b.lo)
    hi = None if (a.hi is None or b.hi is None) else max(a.hi, b.hi)
    pre = None if (a.pre is None or b.pre is None) else max(a.pre, b.pre)
    return _St(lo=lo, hi=hi, roots=a.roots | b.roots, sites=a.sites | b.sites,
               deqs=a.deqs | b.deqs, is_abs=a.is_abs and b.is_abs, pre=pre,
               post=a.post or b.post)


def _const(v: float) -> _St:
    return _St(lo=float(v), hi=float(v))


def _scalar_of(s: _St) -> Optional[float]:
    """The statically known scalar value, when the interval is a point."""
    if s.lo is not None and s.lo == s.hi:
        return s.lo
    return None


# a value as the pass carries it: (state, graph node)
_V = Tuple[_St, int]

# aten ops that pass their first operand's bounds through unchanged
# (JAX: reshape / transpose / slice / gather / copy ...)
_PASS = frozenset((
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand", "expand_as", "permute",
    "transpose", "t", "select", "slice", "unsqueeze", "squeeze", "as_strided", "unbind",
    "split", "split_with_sizes", "chunk", "narrow", "index", "index_select", "gather",
    "clone", "contiguous", "alias", "detach", "lift_fresh", "lift_fresh_copy", "flatten",
    "unflatten", "repeat", "flip", "roll", "view_as", "movedim", "diagonal", "take",
    "unfold", "_to_dense", "tile",
))
_CMP = frozenset((
    "gt", "lt", "ge", "le", "eq", "ne", "logical_and", "logical_or", "logical_not",
    "logical_xor", "bitwise_not", "isfinite", "isnan", "isinf", "all", "any",
))
_JOIN_ALL = frozenset(("cat", "stack", "hstack", "vstack", "concat"))
_UPDATE = frozenset(("index_put", "slice_scatter", "select_scatter", "scatter",
                     "masked_scatter", "index_copy", "diagonal_scatter", "as_strided_scatter"))
_RANDOM = frozenset(("arange", "rand", "randn", "randint", "randperm", "rand_like",
                     "randn_like", "randint_like", "normal", "uniform", "bernoulli",
                     "exponential", "multinomial", "linspace"))
_EMPTY_OPS = frozenset(("empty", "empty_like", "new_empty", "empty_strided",
                        "new_empty_strided"))
_DOT = frozenset(("mm", "bmm", "matmul", "addmm", "baddbmm", "convolution", "linear",
                  "addbmm", "dot", "mv", "einsum"))
_INDEX_OUT = frozenset(("argmax", "argmin", "topk", "sort", "argsort", "max", "min",
                        "kthvalue", "mode", "median"))

class _Analyzer:
    def __init__(self, tape: Tape):
        self.tape = tape
        self.axis_sizes: Dict[str, int] = dict(tape.axis_sizes)
        self._preds: List[List[int]] = [[]]  # graph node 0: constants
        self._sid = itertools.count()
        self._did = itertools.count()
        self._rid = itertools.count()
        self.sites: List[QuantSite] = []
        self._site_node: Dict[int, int] = {}
        self.dequants: List[DequantEvent] = []
        self._deq_node: Dict[int, int] = {}
        self._deq_payload: Dict[int, FrozenSet[int]] = {}
        self.accums: List[AccumEvent] = []
        self._accum_node: List[int] = []
        self.narrows: List[NarrowEvent] = []
        self._narrow_node: List[int] = []
        self.residuals: List[dict] = []
        self._anc_cache: Dict[int, FrozenSet[int]] = {}
        # value id -> (state, graph node); storage group -> written value ids
        self._env: Dict[int, _V] = {}
        self._writes: Dict[int, List[int]] = {}

    # -- graph ----------------------------------------------------------

    def _new_node(self, preds: Sequence[int]) -> int:
        self._preds.append(list(dict.fromkeys(preds)))
        return len(self._preds) - 1

    def _ancestors(self, starts: Sequence[int]) -> FrozenSet[int]:
        seen: set = set()
        stack = list(starts)
        while stack:
            n = stack.pop()
            if n in seen:
                continue
            seen.add(n)
            stack.extend(self._preds[n])
        return frozenset(seen)

    def _anc_of(self, node: int) -> FrozenSet[int]:
        got = self._anc_cache.get(node)
        if got is None:
            got = self._ancestors([node])
            self._anc_cache[node] = got
        return got

    # -- values ---------------------------------------------------------

    def _base(self, vid: int) -> _V:
        got = self._env.get(vid)
        if got is not None:
            return got
        v = self.tape.values[vid]
        if v.origin == "const" and v.const is not None:
            got = (_St(lo=v.const[0], hi=v.const[1]), 0)
        else:  # a step input (or a value made where nothing recorded): unknown
            got = (_St(), self._new_node([]))
        self._env[vid] = got
        return got

    def _get(self, x) -> _V:
        """The state of an argument: a ``Ref``'s value joined with every
        later write into its storage (a view written in place), or a
        Python number's constant."""
        if isinstance(x, Ref):
            st, node = self._base(x.vid)
            later = [w for w in self._writes.get(self.tape.values[x.vid].group, ()) if w > x.vid]
            if not later:
                return st, node
            nodes = [node]
            for w in later:
                wst, wn = self._env[w]
                st = _join(st, wst)
                nodes.append(wn)
            return st, self._new_node(nodes)
        if isinstance(x, bool) or not isinstance(x, (int, float)):
            return _St(), 0
        return _const(x), 0

    def _set(self, vid: int, v: _V) -> None:
        self._env[vid] = v
        if vid in self.tape.written:
            self._writes.setdefault(self.tape.values[vid].group, []).append(vid)

    def _dtype(self, vid: int) -> str:
        return self.tape.values[vid].dtype

    def _shape(self, vid: int) -> Tuple[int, ...]:
        return self.tape.values[vid].shape

    # -- the primitive transfers (JAX's, by primitive name) --------------

    def apply(self, name: str, ins: Sequence[_V], out_dtype: Optional[str] = None,
              **params) -> _V:
        """One primitive over ``ins``: a new graph node and its state
        (the counterpart of one jaxpr equation)."""
        node = self._new_node([n for _, n in ins])
        sts = [s for s, _ in ins]
        return self._transfer(name, sts, [n for _, n in ins], out_dtype, node, params), node

    def _transfer(self, name, sts, in_nodes, out_dtype, node, params) -> _St:
        s0 = sts[0] if sts else _St()

        if name == "convert":
            return self._convert(s0, params["src"], out_dtype, params.get("shape", ()), node)

        if name == "add":
            a, b = sts[0], sts[1]
            lo = None if (a.lo is None or b.lo is None) else a.lo + b.lo
            hi = None if (a.hi is None or b.hi is None) else a.hi + b.hi
            out = _union(sts, lo=lo, hi=hi)
            if out_dtype is not None and _is_int(out_dtype) and out.sites:
                peaks = [p for p in (a.peak(), b.peak()) if p is not None]
                self._accum(AccumEvent(
                    kind="add", dtype=out_dtype, axes=(), multiplier=2,
                    peak_in=max(peaks) if peaks else None, peak_out=out.peak(),
                    capacity=_int_cap(out_dtype), lattice=True, conservative=False), node)
            return out

        if name == "sub":
            a, b = sts[0], sts[1]
            lo = None if (a.lo is None or b.hi is None) else a.lo - b.hi
            hi = None if (a.hi is None or b.lo is None) else a.hi - b.lo
            out = _union(sts, lo=lo, hi=hi)
            if b.deqs:
                # the error-feedback residual shape: minuend - dequant(...)
                cand = _EMPTY
                for d in b.deqs:
                    cand |= self._deq_payload.get(d, _EMPTY)
                self.residuals.append({"rid": next(self._rid), "cand": cand,
                                       "minuend_node": in_nodes[0], "node": node})
            return out

        if name == "mul":
            return self._mul(sts, out_dtype, node)

        if name == "div":
            return self._div(sts, out_dtype, node)

        if name == "neg":
            return _union(sts, lo=None if s0.hi is None else -s0.hi,
                          hi=None if s0.lo is None else -s0.lo)

        if name == "abs":
            return _union(sts, lo=0.0, hi=s0.peak(), is_abs=True)

        if name == "sign":
            return _union(sts, lo=-1.0, hi=1.0)

        if name in ("max", "min"):
            a, b = sts[0], sts[1]
            ka, kb = _scalar_of(a), _scalar_of(b)
            if name == "max":
                lo = (max(x for x in (a.lo, b.lo) if x is not None)
                      if (a.lo is not None or b.lo is not None) else None)
                hi = None if (a.hi is None or b.hi is None) else max(a.hi, b.hi)
            else:
                lo = None if (a.lo is None or b.lo is None) else min(a.lo, b.lo)
                hi = (min(x for x in (a.hi, b.hi) if x is not None)
                      if (a.hi is not None or b.hi is not None) else None)
            # clamp: remember the unclamped operand's peak for the
            # saturation check at the eventual requant convert
            pre = None
            if ka is not None and kb is None:
                pre = b.pre if b.pre is not None else b.peak()
            elif kb is not None and ka is None:
                pre = a.pre if a.pre is not None else a.peak()
            out = _union(sts, lo=lo, hi=hi, pre=pre)
            out.is_abs = any(s.is_abs for s in sts)
            return out

        if name == "clamp":
            lo_b, x, hi_b = sts[0], sts[1], sts[2]
            pre = x.pre if x.pre is not None else x.peak()
            return _union([x], lo=_scalar_of(lo_b), hi=_scalar_of(hi_b), pre=pre)

        if name == "round":
            out = _union(sts, lo=s0.lo, hi=s0.hi, pre=s0.pre)
            out.is_abs = s0.is_abs
            return out

        if name in ("reduce_max", "pmax"):
            out = _union(sts, lo=s0.lo, hi=s0.hi)
            out.is_abs = s0.is_abs
            if name == "reduce_max" and s0.is_abs:
                out.roots = out.roots | {node}  # a max-abs reduction: a scale root
            return out

        if name in ("reduce_min", "pmin"):
            out = _union(sts, lo=s0.lo, hi=s0.hi)
            out.is_abs = s0.is_abs
            return out

        if name == "reduce_sum":
            return self._summed(sts, s0, params.get("mult"), (), "reduce_sum", out_dtype, node)

        if name in ("psum", "psum_scatter"):
            out = self._summed(sts, s0, params.get("mult"), params.get("axes", ()), name,
                               out_dtype, node)
            out.post = True
            return out

        if name in ("all_gather", "all_to_all", "ppermute"):
            out = _union(sts, lo=s0.lo, hi=s0.hi)
            if name == "all_to_all":
                out.post = True
            return out

        if name == "pass":
            out = _union(sts[:1], lo=s0.lo, hi=s0.hi, pre=s0.pre)
            out.is_abs = s0.is_abs
            return out

        if name == "join":
            out = sts[0]
            for s in sts[1:]:
                out = _join(out, s)
            return out

        if name == "cmp":
            return _union(sts, lo=0.0, hi=1.0)

        if name == "integer_pow":
            y, p = params.get("y"), s0.peak()
            if y is not None and p is not None and y >= 0:
                hi = float(p) ** int(y)
                return _union(sts, lo=0.0 if int(y) % 2 == 0 else -hi, hi=hi)
            return _union(sts)

        if name == "random":
            return _St()

        if name == "bottom":
            return _St(bottom=True)

        if name == "dot_general":
            # fold-style dequantization: a float contraction of lattice
            # payload against an operand carrying the scale row
            a, b = sts[0], sts[1]
            payload = other = None
            if a.sites and not b.sites:
                payload, other = a, b
            elif b.sites and not a.sites:
                payload, other = b, a
            if payload is not None and other.roots and out_dtype and _is_float(out_dtype):
                did = self._dequant(payload.sites, other.roots, False, node)
                out = _union(sts)
                out.sites, out.deqs = _EMPTY, out.deqs | {did}
                return out
            return _union(sts)

        return _union(sts)  # default: provenance union, bounds unknown

    def _accum(self, ev: AccumEvent, node: int) -> None:
        self.accums.append(ev)
        self._accum_node.append(node)

    def _dequant(self, sites, roots, literal: bool, node: int) -> int:
        did = next(self._did)
        self.dequants.append(DequantEvent(did=did, payload_sites=sites, scale_roots=roots,
                                          scale_literal=literal, conservative=False))
        self._deq_node[did] = node
        self._deq_payload[did] = sites
        return did

    def _summed(self, sts, s0, mult, axes, kind, out_dtype, node) -> _St:
        if mult is not None and s0.lo is not None and s0.hi is not None:
            lo, hi = min(s0.lo * mult, s0.hi * mult), max(s0.lo * mult, s0.hi * mult)
        else:
            lo = hi = None
        out = _union(sts, lo=lo, hi=hi)
        peak_out = None if hi is None else max(abs(lo), abs(hi))
        if out_dtype is not None and _is_int(out_dtype):
            self._accum(AccumEvent(
                kind=kind, dtype=out_dtype, axes=tuple(axes), multiplier=mult,
                peak_in=s0.peak(), peak_out=peak_out, capacity=_int_cap(out_dtype),
                lattice=bool(s0.sites), conservative=False), node)
        elif out_dtype is not None and _is_float(out_dtype) and s0.sites:
            # a float sum of lattice payload: the mantissa's capacity
            self._accum(AccumEvent(
                kind=kind, dtype=out_dtype, axes=tuple(axes), multiplier=mult,
                peak_in=s0.peak(), peak_out=peak_out, capacity=1 << _MANT[out_dtype],
                lattice=True, conservative=False), node)
        return out

    def _mul(self, sts, out_dtype, node) -> _St:
        a, b = sts[0], sts[1]
        payload = other = None
        if a.sites and not b.sites:
            payload, other = a, b
        elif b.sites and not a.sites:
            payload, other = b, a
        if payload is not None and _scalar_of(other) is not None:
            # a static scalar: an exact rescale, the payload stays on the
            # lattice; only a data-dependent scale dequantizes
            k = _scalar_of(other)
            lo = hi = None
            if payload.lo is not None and payload.hi is not None:
                lo, hi = sorted((payload.lo * k, payload.hi * k))
            out = _union(sts, lo=lo, hi=hi,
                         pre=None if payload.pre is None else payload.pre * abs(k))
            out.is_abs = payload.is_abs and k > 0
            return out
        if payload is not None and out_dtype is not None and _is_float(out_dtype):
            did = self._dequant(payload.sites, other.roots, False, node)
            out = _union(sts)
            out.sites, out.deqs = _EMPTY, out.deqs | {did}
            return out
        lo = hi = None
        if None not in (a.lo, a.hi, b.lo, b.hi):
            prods = [a.lo * b.lo, a.lo * b.hi, a.hi * b.lo, a.hi * b.hi]
            lo, hi = min(prods), max(prods)
        out = _union(sts, lo=lo, hi=hi)
        if out_dtype is not None and _is_int(out_dtype) and out.sites and hi is None:
            self._accum(AccumEvent(
                kind="mul", dtype=out_dtype, axes=(), multiplier=None, peak_in=None,
                peak_out=None, capacity=_int_cap(out_dtype), lattice=True,
                conservative=False), node)
        return out

    def _div(self, sts, out_dtype, node) -> _St:
        a, b = sts[0], sts[1]
        k = _scalar_of(b)
        if k is not None and k != 0.0:
            lo = hi = None
            if a.lo is not None and a.hi is not None:
                lo, hi = sorted((a.lo / k, a.hi / k))
            out = _union([a], lo=lo, hi=hi)
            out.is_abs = a.is_abs
            out.roots = a.roots | b.roots
            return out
        if a.sites and not b.sites and out_dtype is not None and _is_float(out_dtype):
            # dequant spelled as payload / inv_scale
            did = self._dequant(a.sites, b.roots, False, node)
            out = _union(sts)
            out.sites, out.deqs = _EMPTY, out.deqs | {did}
            return out
        return _union(sts)

    def _convert(self, s0: _St, src: str, dst: Optional[str], shape, node) -> _St:
        if dst is None or src == dst:
            out = _union([s0], lo=s0.lo, hi=s0.hi, pre=s0.pre)
            out.is_abs = s0.is_abs
            return out
        out = _union([s0], lo=s0.lo, hi=s0.hi, pre=s0.pre)
        out.is_abs = s0.is_abs
        narrowing = _narrows(src, dst)
        peak = s0.peak()
        if peak is None and _is_int(src):
            # an integer source has its dtype's bounds even when the
            # dataflow bound is unknown (an int8 pool argument)
            lo, hi = _INT_RANGE[src]
            out.lo, out.hi = float(lo), float(hi)
            peak = float(max(abs(lo), hi))
        if _is_int(dst) and (_is_float(src) or (_is_int(src) and narrowing)):
            cap = _int_cap(dst)
            if peak is not None and cap is not None and peak <= cap:
                if _itemsize(dst) > 2:
                    # a bounded cast into a wide int (index math, counters)
                    return out
                if _scalar_of(s0) is not None and not s0.roots and not s0.sites:
                    # a static constant cast onto the lattice: not a site
                    return out
                size = 1
                for d in shape:
                    size *= int(d)
                sid = next(self._sid)
                self.sites.append(QuantSite(
                    sid=sid, dtype=dst, shape=tuple(int(d) for d in shape), size=size,
                    start_offset=0, peak=peak, pre_peak=s0.pre, roots=s0.roots,
                    primary=not s0.sites, conservative=False))
                self._site_node[sid] = node
                out.sites = out.sites | {sid}
            else:
                self.narrows.append(NarrowEvent(src=src, dst=dst, is_quant_site=False,
                                                downstream_of_reduce=s0.post,
                                                conservative=False))
                self._narrow_node.append(node)
                if peak is not None and cap is not None and peak > cap:
                    self._accum(AccumEvent(
                        kind="convert", dtype=dst, axes=(), multiplier=1, peak_in=peak,
                        peak_out=peak, capacity=cap, lattice=bool(s0.sites),
                        conservative=False), node)
                out.lo = out.hi = None
            return out
        if _is_int(src) and _is_float(dst) and s0.sites:
            # a lattice value entering float: exactness needs the mantissa
            cap = 1 << _MANT[dst]
            if peak is None or peak > cap:
                self._accum(AccumEvent(
                    kind="mantissa", dtype=dst, axes=(), multiplier=1, peak_in=peak,
                    peak_out=peak, capacity=cap, lattice=True, conservative=False), node)
            return out
        if narrowing:
            self.narrows.append(NarrowEvent(src=src, dst=dst, is_quant_site=False,
                                            downstream_of_reduce=s0.post, conservative=False))
            self._narrow_node.append(node)
        return out

    # -- the tape ---------------------------------------------------------

    def run(self) -> None:
        for node in self.tape.nodes:
            if node.op == "aten":
                self._aten(node)
            elif node.op == "collective":
                self._collective(node)
            elif node.op == "kernel":
                self._kernel(node)

    def _refs(self, x, out: List[Ref]) -> List[Ref]:
        if isinstance(x, Ref):
            out.append(x)
        elif isinstance(x, tuple):
            for v in x:
                self._refs(v, out)
        return out

    def _aten(self, node) -> None:
        base = node.name.split(".")[1] if node.name.startswith("aten.") else node.name
        op = base[:-1] if base.endswith("_") and not base.endswith("__") else base
        a = node.args
        refs = self._refs(tuple(a.values()), [])
        out_dtype = self._dtype(node.outs[0]) if node.outs else None
        v = self._aten_value(op, a, refs, out_dtype)
        index = None
        for vid in node.outs:
            if op in _INDEX_OUT and self._dtype(vid) == "int64":
                # the positions an arg-reduction returns: [0, dim - 1]
                # (JAX's are int32 from the start and never converted)
                if index is None:
                    shape = self._shape(a["self"].vid)
                    dim = a.get("dim")
                    n = 1
                    for d in (shape if dim is None else (shape[dim],) if shape else ()):
                        n *= int(d)
                    index = self.apply("join", [(_const(0.0), 0), (_const(max(n - 1, 0)), 0)],
                                       "int64")
                self._set(vid, index)
            else:
                self._set(vid, v)

    def _aten_value(self, op: str, a: Dict[str, Any], refs: List[Ref], out_dtype) -> _V:
        x = a.get("self", a.get("input"))
        if op in ("_to_copy", "to", "type_as", "_autocast_to_reduced_precision"):
            src = self.tape.values[x.vid]
            return self.apply("convert", [self._get(x)], out_dtype, src=src.dtype,
                              shape=src.shape)
        if op in _PASS:
            return self.apply("pass", [self._get(x)] if isinstance(x, Ref)
                              else [self._get(r) for r in refs[:1]], out_dtype)
        if op in ("add", "sub", "rsub"):
            other = self._get(a.get("other"))
            alpha = a.get("alpha", 1)
            if alpha not in (None, 1):
                other = self.apply("mul", [other, (_const(alpha), 0)], out_dtype)
            if op == "rsub":
                return self.apply("sub", [other, self._get(x)], out_dtype)
            return self.apply(op, [self._get(x), other], out_dtype)
        if op in ("mul", "div"):
            v = self.apply(op, [self._get(x), self._get(a.get("other"))], out_dtype)
            if op == "div" and a.get("rounding_mode") is not None:
                v = self.apply("round", [v], out_dtype)
            return v
        if op in ("neg", "abs", "round", "floor", "ceil", "trunc"):
            return self.apply("round" if op in ("floor", "ceil", "trunc") else op,
                              [self._get(x)], out_dtype)
        if op in ("sign", "sgn"):
            return self.apply("sign", [self._get(x)], out_dtype)
        if op in ("maximum", "minimum", "fmax", "fmin") or (
                op in ("max", "min") and "other" in a):
            name = "max" if op in ("maximum", "max", "fmax") else "min"
            return self.apply(name, [self._get(x), self._get(a.get("other"))], out_dtype)
        if op == "clamp":
            lo, hi = a.get("min"), a.get("max")
            v = self._get(x)
            if lo is not None and hi is not None:
                return self.apply("clamp", [self._get(lo), v, self._get(hi)], out_dtype)
            if lo is not None:
                return self.apply("max", [v, self._get(lo)], out_dtype)
            if hi is not None:
                return self.apply("min", [v, self._get(hi)], out_dtype)
            return self.apply("pass", [v], out_dtype)
        if op == "clamp_min":
            return self.apply("max", [self._get(x), self._get(a.get("min"))], out_dtype)
        if op == "clamp_max":
            return self.apply("min", [self._get(x), self._get(a.get("max"))], out_dtype)
        if op in ("amax", "max"):
            return self.apply("reduce_max", [self._get(x)], out_dtype)
        if op in ("amin", "min"):
            return self.apply("reduce_min", [self._get(x)], out_dtype)
        if op in ("sum", "cumsum", "nansum"):
            shape = self._shape(x.vid)
            dims = a.get("dim")
            if dims is None or dims == ():
                dims = tuple(range(len(shape)))
            elif isinstance(dims, int):
                dims = (dims,)
            mult = 1
            for d in dims:
                mult *= int(shape[d]) if shape else 1
            return self.apply("reduce_sum", [self._get(x)], out_dtype, mult=mult)
        if op in _JOIN_ALL:
            return self.apply("join", [self._get(r) for r in refs], out_dtype)
        if op == "constant_pad_nd":
            return self.apply("join", [self._get(x), self._get(a.get("value", 0.0))], out_dtype)
        if op == "copy":
            return self.apply("pass", [self._get(a.get("src"))], out_dtype)
        if op in _UPDATE or op == "masked_fill":
            upd = a.get("src", a.get("values", a.get("value")))
            return self.apply("join", [self._get(x), self._get(upd)], out_dtype)
        if op == "where":
            return self.apply("join", [self._get(a.get("self")), self._get(a.get("other"))],
                              out_dtype)
        if op in _CMP:
            return self.apply("cmp", [self._get(r) for r in refs], out_dtype)
        if op == "pow" and isinstance(a.get("exponent"), int):
            return self.apply("integer_pow", [self._get(x)], out_dtype, y=a["exponent"])
        if op == "square":
            return self.apply("integer_pow", [self._get(x)], out_dtype, y=2)
        if op in ("full", "full_like", "new_full", "fill", "scalar_tensor"):
            val = a.get("fill_value", a.get("value", a.get("s")))
            if isinstance(val, Ref):
                return self.apply("pass", [self._get(val)], out_dtype)
            return self.apply("join", [self._get(val)], out_dtype)
        if op in ("zeros", "zeros_like", "new_zeros", "zero"):
            return self.apply("join", [(_const(0.0), 0)], out_dtype)
        if op in ("ones", "ones_like", "new_ones"):
            return self.apply("join", [(_const(1.0), 0)], out_dtype)
        if op in _EMPTY_OPS:
            return self.apply("bottom", [], out_dtype)
        if op == "arange":  # iota: its bounds are its static arguments
            start, end = a.get("start", 0), a.get("end")
            if isinstance(start, (int, float)) and isinstance(end, (int, float)) and end > start:
                return self.apply("join", [(_const(start), 0), (_const(end - 1), 0)], out_dtype)
        if op in _RANDOM:
            return self.apply("random", [self._get(r) for r in refs], out_dtype)
        if op in _DOT:
            mats = refs[-2:] if op in ("addmm", "baddbmm", "addbmm") else refs[:2]
            return self.apply("dot_general", [self._get(r) for r in mats]
                              + [self._get(r) for r in refs if r not in mats], out_dtype)
        return self.apply("union", [self._get(r) for r in refs], out_dtype)

    def _collective(self, node) -> None:
        info = node.info
        method = node.name.rsplit(".", 1)[-1]
        ins = [self._get(r) for r in self._refs((node.args.get("x"),), [])]
        out_dtype = self._dtype(node.outs[0]) if node.outs else None
        mult, axes = info.get("mult"), info.get("axes", ())
        if method in ("psum", "pmean", "psum_scatter"):
            kind = "psum_scatter" if method == "psum_scatter" else "psum"
            v = self.apply(kind, ins, out_dtype, mult=mult, axes=axes)
            if method == "pmean" and mult:
                v = self.apply("div", [v, (_const(mult), 0)], out_dtype)
        elif method in ("all_to_all", "all_to_all_tiled"):
            v = self.apply("all_to_all", ins, out_dtype)
        elif method in ("pmax", "absmax_max"):
            v = self.apply("pmax", ins, out_dtype)
        elif method in ("pmin", "all_true"):
            v = self.apply("pmin", ins, out_dtype)
        else:
            v = self.apply("all_gather", ins, out_dtype)
        for vid in node.outs:
            self._set(vid, v)

    def _kernel(self, node) -> None:
        events = KERNEL_EVENTS.get(node.info.get("numerics"))
        if events is None:  # a kernel with no declared numerics: provenance only
            ins = [self._get(r) for r in self._refs(tuple(node.args.values()), [])]
            v = self.apply("union", ins, None)
            for vid in node.outs:
                self._set(vid, v)
            return
        outs = events(self, node)
        for vid, v in zip(node.outs, outs):
            self._set(vid, v)

    # -- finalize ---------------------------------------------------------

    def finalize(self, param_vids: Optional[Sequence[int]],
                 out_vids: Sequence[int]) -> NumericsReport:
        param_set = set(out_vids if param_vids is None else param_vids)
        param_nodes = [self._get(Ref(v))[1] for v in param_set]
        nonparam_nodes = [self._get(Ref(v))[1] for v in out_vids if v not in param_set]
        anc_params = self._ancestors(param_nodes)
        anc_nonparams = self._ancestors(nonparam_nodes)
        sites: List[QuantSite] = []
        offset = 0
        for s in self.sites:
            feeds = self._site_node[s.sid] in anc_params
            s = dataclasses.replace(s, feeds_params=feeds, start_offset=offset)
            if feeds and s.primary:
                offset += s.size
            sites.append(s)
        dequants = [dataclasses.replace(d, feeds_params=self._deq_node[d.did] in anc_params)
                    for d in self.dequants]
        accums = [dataclasses.replace(a, feeds_params=n in anc_params)
                  for a, n in zip(self.accums, self._accum_node)]
        narrows = [dataclasses.replace(nv, feeds_params=n in anc_params)
                   for nv, n in zip(self.narrows, self._narrow_node)]
        residuals: List[ResidualEvent] = []
        for r in self.residuals:
            covered = {sid for sid in r["cand"] if sid in self._site_node
                       and r["minuend_node"] in self._anc_of(self._site_node[sid])}
            if covered:
                # a residual round-tripping a RE-quantization of the value
                # the wire quantized (JAX's mirror): sites quantizing the
                # SAME minuend with the SAME geometry are covered too
                geom = {(self.sites[sid].dtype, self.sites[sid].shape) for sid in covered}
                covered |= {s.sid for s in self.sites
                            if s.sid not in covered and (s.dtype, s.shape) in geom
                            and r["minuend_node"] in self._anc_of(self._site_node[s.sid])}
            residuals.append(ResidualEvent(
                rid=r["rid"], covered_sites=frozenset(covered),
                feeds_carry=r["node"] in anc_nonparams, feeds_params=r["node"] in anc_params,
                conservative=False))
        return NumericsReport(sites=tuple(sites), dequants=tuple(dequants),
                              accums=tuple(accums), narrows=tuple(narrows),
                              residuals=tuple(residuals), axis_sizes=dict(self.axis_sizes))


# ------------------------------------------------ the kernels' declared events


def _quantize_piece(an: _Analyzer, x: _V, shape, absmax: Optional[_V] = None,
                    shared: bool = False) -> Tuple[_V, _V, _V]:
    """The events of ``quantize_tensor_plain`` / ``quantize_rows_plain``
    (one piece): ``absmax = max(abs(x))`` (a scale root; with ``shared``
    the pmax over the workers), ``inv = where(absmax > 0, 127 /
    max(absmax, 1e-30), 0)``, ``q = int8(clip(round(x * inv), -127,
    127))``, ``scale = absmax * (1/127)``. ``absmax`` given: the split
    route's quantize with the cross-process absmax."""
    if absmax is None:
        absmax = an.apply("reduce_max", [an.apply("abs", [x], "float32")], "float32")
        if shared:
            absmax = an.apply("pmax", [absmax], "float32")
    den = an.apply("max", [absmax, (_const(1e-30), 0)], "float32")
    inv = an.apply("join", [an.apply("div", [(_const(_PEAK), 0), den], "float32"),
                            (_const(0.0), 0)], "float32")
    xi = an.apply("mul", [x, inv], "float32")
    clipped = an.apply("clamp", [(_const(-_PEAK), 0), an.apply("round", [xi], "float32"),
                                 (_const(_PEAK), 0)], "float32")
    q = an.apply("convert", [clipped], "int8", src="float32", shape=shape)
    scale = an.apply("mul", [absmax, (_const(_RECIP_127), 0)], "float32")
    return q, scale, absmax


def _pieces(node, key: str) -> List[Ref]:
    x = node.args.get(key)
    return list(x) if isinstance(x, tuple) else [x]


def _quantize_events(an: _Analyzer, node) -> List[_V]:
    """K1 / K2 quantize entries: per piece (q, scale[, absmax]), in the
    node's output order. A shared node's pieces are worker-stacked (the
    site is one worker's shape, the absmax a pmax); a ``rows`` node's
    pieces come in runs of one value's per-worker rows, one site a run."""
    xs = _pieces(node, "xs" if "xs" in node.args else "xb")
    per = len(node.outs) // max(len(xs), 1)
    shared = node.info.get("shared") is not None
    rows = node.info.get("rows") or 1
    outs: List[_V] = []
    for i in range(0, len(xs), rows):
        run = xs[i:i + rows]
        x = an.apply("join", [an._get(r) for r in run], "float32") if rows > 1 else an._get(run[0])
        shape = an._shape(run[0].vid)
        q, scale, absmax = _quantize_piece(an, x, shape[1:] if shared else shape, shared=shared)
        for _ in run:
            outs.extend((q, scale, absmax)[:per])
    return outs


def _quantize_given_events(an: _Analyzer, node) -> List[_V]:
    """The split route's quantize (K2 ``quantize_tensors_given``, K1
    ``quantize_rows_scaled_given``) with the cross-process absmax."""
    xs = _pieces(node, "xs")
    absmax = an._get(node.args["absmax"])
    outs: List[_V] = []
    for r in xs:
        outs.extend(_quantize_piece(an, an._get(r), an._shape(r.vid)[1:], absmax=absmax))
    return outs


def _absmax_events(an: _Analyzer, node) -> List[_V]:
    """The split route's absmax (K2 ``tensors_absmax``, K1
    ``rows_scaled_absmax``): each piece's max-abs reduction (a scale root
    each), the pieces' maxima side by side in one output."""
    maxima = [an.apply("reduce_max", [an.apply("abs", [an._get(r)], "float32")], "float32")
              for r in _pieces(node, "xs")]
    return [an.apply("join", maxima, "float32")]


def _kv_write_events(an: _Analyzer, node) -> List[_V]:
    """K1's KV entry: each of K and V quantized per row into the pool,
    written in place (JAX's dynamic_update_slice: the pool's old state
    joined with the update)."""
    outs = []
    for src, q_pool, s_pool in (("k", "k_q", "k_s"), ("v", "v_q", "v_s")):
        ref = node.args[src]
        q, scale, _ = _quantize_piece(an, an._get(ref), an._shape(ref.vid))
        outs.append(an.apply("join", [an._get(node.args[q_pool]), q], "int8"))
        outs.append(an.apply("join", [an._get(node.args[s_pool]), scale], "float32"))
    return outs  # the node's written outputs: k_q, k_s, v_q, v_s


def _accum_rescale_events(an: _Analyzer, node) -> List[_V]:
    """K3 (``accumulate_rescale_plain``): the exact int32 column sum of
    the n worker rows, ``acc / divisor`` in f32, round, clip to +-127,
    int8: a reduce_sum of multiplier n and a lattice requantize."""
    recv = node.args["recv"]
    n, shape = an._shape(recv.vid)[0], an._shape(recv.vid)[1:]
    acc = an.apply("reduce_sum", [an.apply("convert", [an._get(recv)], "int32", src="int8")],
                   "int32", mult=int(n))
    accf = an.apply("convert", [acc], "float32", src="int32")
    quot = an.apply("div", [accf, an._get(node.args["divisor"])], "float32")
    clipped = an.apply("clamp", [(_const(-_PEAK), 0), an.apply("round", [quot], "float32"),
                                 (_const(_PEAK), 0)], "float32")
    return [an.apply("convert", [clipped], "int8", src="float32", shape=shape)]


# kernel_entry(numerics=...) -> the events its node declares
KERNEL_EVENTS = {
    "quantize": _quantize_events,
    "quantize_given": _quantize_given_events,
    "absmax": _absmax_events,
    "kv_write": _kv_write_events,
    "accum_rescale": _accum_rescale_events,
}


def analyze_numerics(tape: Tape, param_vids: Optional[Sequence[int]] = None,
                     out_vids: Optional[Sequence[int]] = None) -> NumericsReport:
    """Run the precision-flow analysis over a recorded step.

    ``param_vids``: the value ids of the updated params
    (``Tape.value_ids(spec.select_params(out))``; None: every output
    counts as params, fully conservative); ``out_vids``: the value ids
    of every output of the step (the carry is what is not a param). The
    axis sizes are the recording axes' (``Tape.axis_sizes``)."""
    an = _Analyzer(tape)
    an.run()
    return an.finalize(param_vids, list(out_vids or param_vids or ()))
