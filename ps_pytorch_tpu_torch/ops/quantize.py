"""int8 symmetric quantization (the port of ops/quantize.py).

Six wrappers of hand-written kernels; CUDA tensors launch the kernel,
CPU tensors take the plain version beside it, with no fallback between
the two (the sixth, ``accumulate_rescale_int8``, is K3 below):

- ``quantize_kv_write`` — K1, KV entry (``csrc/quantize_rows.cu``): one
  layer's K and V ``[R, H, hd]``, every (position, head) row quantized
  with its own scale and stored straight into the serving pool's int8
  rows and f32 scales, in place, one launch (prefill: at ``(slot, 0..R)``;
  decode: at ``(s, pos[s])``, positions read on the device).
- ``quantize_rows_many`` — K1, per-row scales over a list of ``[NB, BS]``
  pieces in one call (the two-round wire's round 2), on the KV entry's
  lane groups over descriptor tables; ``quantize_rows`` is its one-piece
  form.
- ``quantize_rows_scaled_many`` — K1, shared-scale entry, multi-tensor:
  every worker-stacked piece of a step in one call, each cut into blocks
  whose absmax is taken over every worker (the pmax) and shared by them
  (the block-scale gradient wire).
- ``quantize_tensors`` — K2 (``csrc/quantize_tensor.cu``), multi-tensor:
  every piece of a step in one call, each with one absmax over the whole
  (worker-stacked) piece and one shared scale. ``quantize_tensor`` is its
  one-piece call.
- the split routes of K2 (``tensors_absmax``, ``quantize_tensors_given``)
  and of K1's shared-scale entry (``rows_scaled_absmax``,
  ``quantize_rows_scaled_given``): the same functions cut in two around
  the cross-process max of the absmax, for a worker axis that spans
  processes (``quantize_int8_many`` takes them there).

``quantize_int8_many`` is the gradient wire's entry over a step's pieces
(``quantize_int8(..., return_absmax=True)`` of each, one kernel call).
``quantize_rows_many.launches`` (and ``quantize_rows``') counts device
launches, one a descriptor table; each other multi-tensor wrapper's
``.launches`` counts its calls that launch: one per call, however many
pieces and launches the call takes. A call cuts its list into descriptor tables of at most ``MAX_PIECES`` pieces
(``plan_tensor_tables``, ``plan_rows_tables``: pure Python) that go to
the card as kernel parameters.

``quantize_int8(x, axis_name=..., block_size=...)`` / ``dequantize_int8``
keep the JAX signatures. With ``axis_name`` (a ``parallel.mesh.WorkerAxis``)
``x`` is worker-stacked ``[N, *shape]``: the absmax is taken over every
worker (the pmax) and each worker's payload is quantized with that
shared scale; the scale comes back once, without the worker dimension.

The arithmetic is quantize.py:147-186 as XLA runs it under jit, op for op:
``inv = where(absmax > 0, 127 / max(absmax, 1e-30), 0)`` (an IEEE
quotient), ``clip(round_half_even(x * inv), -127, 127)`` to int8, and
``scale = absmax * (1/127)``: inside a jitted program XLA rewrites the
division by the constant 127 into a multiply by the f32 constant 1/127,
and every JAX caller of these functions (the train step, the serving
engine) is jitted. Bit-exact against the JAX function under jit.

The homomorphic (compressed-domain) algebra: ``accum_capacity`` /
``accum_dtype`` size the exact integer accumulator of a shared-lattice
sum, ``homomorphic_rescale`` rounds an accumulation back onto the int8
lattice, and ``accumulate_rescale_int8`` fuses the two over the worker
rows of a payload: K3 (``csrc/accum_rescale.cu``) on a CUDA tensor,
``accumulate_rescale_plain`` on a CPU one.

Stochastic rounding (``rounding="stochastic"``: ``floor(x * inv + u)``
with ``u`` the caller's U[0, 1) draws, one per rounded element) and the
int4 / lattice codec (``quantize_lattice`` with a peak that may be a
device tensor, ``quantize_int4``, ``pack_int4`` / ``unpack_int4``, the
``PREC_*`` tags of the adaptive-precision wire) are computed in plain
PyTorch on either device, as the JAX package computes them in jnp
outside every Pallas kernel (quantize.py:145: no kernel unless the
rounding is nearest). The stochastic sum ``x * inv + u`` is one fused
multiply-add, as XLA contracts it on the CPU: the port takes the exact
product in f64 and rounds the sum once to f32.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ._tape import kernel_entry, shared_over

_INT8_PEAK = 127  # symmetric int8 payloads live in [-127, 127]

# the f32 constant XLA multiplies by where the JAX code divides by 127.0
RECIP_127 = float(np.float32(1.0) / np.float32(127.0))


def _inv_scale(absmax: torch.Tensor) -> torch.Tensor:
    """``where(absmax > 0, 127 / max(absmax, 1e-30), 0)`` as an IEEE
    quotient: PyTorch computes ``127.0 / t`` as ``reciprocal(t) * 127``,
    so the numerator is a tensor too."""
    c127 = torch.full_like(absmax, 127.0)
    return torch.where(
        absmax > 0, c127 / torch.clamp_min(absmax, 1e-30),
        torch.zeros((), dtype=torch.float32, device=absmax.device),
    )


def _quant(x: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    # torch.round rounds half to even, as jnp.round does
    return torch.clamp(torch.round(x.float() * inv), -127, 127).to(torch.int8)


def quantize_rows_plain(xb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1 (fused): f32/bf16 ``[NB, BS]`` -> (int8
    ``[NB, BS]``, f32 scale ``[NB, 1]``)."""
    absmax = xb.float().abs().amax(dim=1, keepdim=True)
    return _quant(xb, _inv_scale(absmax)), absmax * RECIP_127


def quantize_rows_many_plain(xs):
    """Plain PyTorch version of ``quantize_rows_many``: ``[(q, scale)]``
    of ``quantize_rows_plain`` over each piece."""
    return [quantize_rows_plain(x) for x in xs]


def _kv_geometry(k, v, k_q, k_s, v_q, v_s, slot, pos):
    """Check a KV pool write's operands -> (rows, heads, head_dim,
    max_len)."""
    if k.dim() != 3 or k.shape != v.shape or k.dtype != v.dtype:
        raise ValueError(f"quantize_kv_write takes K and V [R, H, hd] of one dtype, got "
                         f"{k.dtype} {tuple(k.shape)} and {v.dtype} {tuple(v.shape)}")
    rows, heads, hd = k.shape
    if (k_q.dim() != 4 or k_q.shape != v_q.shape or tuple(k_q.shape[2:]) != (heads, hd)
            or k_q.dtype != torch.int8 or v_q.dtype != torch.int8):
        raise ValueError(f"quantize_kv_write: int8 pools [slots, max_len, {heads}, {hd}], got "
                         f"{k_q.dtype} {tuple(k_q.shape)} and {v_q.dtype} {tuple(v_q.shape)}")
    slots, max_len = k_q.shape[:2]
    want = (slots, max_len, heads, 1)
    if (tuple(k_s.shape) != want or tuple(v_s.shape) != want
            or k_s.dtype != torch.float32 or v_s.dtype != torch.float32):
        raise ValueError(f"quantize_kv_write: f32 scale pools {want}, got {k_s.dtype} "
                         f"{tuple(k_s.shape)} and {v_s.dtype} {tuple(v_s.shape)}")
    if not all(t.is_contiguous() for t in (k_q, k_s, v_q, v_s)):
        raise ValueError("quantize_kv_write: the pool views must be contiguous")
    if (slot is None) == (pos is None):
        raise ValueError("quantize_kv_write takes a slot (prefill) or positions (decode)")
    if pos is None:
        if not 0 <= slot < slots or rows > max_len:
            raise ValueError(f"quantize_kv_write: slot {slot} of {slots}, {rows} positions of "
                             f"{max_len}")
    elif (tuple(pos.shape) != (rows,) or pos.dtype not in (torch.int32, torch.int64)
          or rows > slots):
        raise ValueError(f"quantize_kv_write: int positions [{rows}] for {slots} slots, got "
                         f"{pos.dtype} {tuple(pos.shape)}")
    operands = (k, v, k_q, k_s, v_q, v_s) + (() if pos is None else (pos,))
    if any(t.device != k.device for t in operands):
        raise ValueError(f"quantize_kv_write: operands on {sorted({str(t.device) for t in operands})}")
    return rows, heads, hd, max_len


def quantize_kv_write_plain(k, v, k_q, k_s, v_q, v_s, slot=None, pos=None) -> None:
    """Plain PyTorch version of K1's KV entry: ``quantize_rows_plain`` of
    every (position, head) row of K and V, then JAX's pool writes
    (serve/kv.py:62-113): a slice at a prefill, an index write at each
    slot's own position at a decode, where a negative position wraps once
    by ``max_len`` and one still outside ``[0, max_len)`` is dropped, as
    JAX's scatter drops it."""
    rows, heads, hd, max_len = _kv_geometry(k, v, k_q, k_s, v_q, v_s, slot, pos)
    if pos is not None:
        p = pos.long()
        p = torch.where(p < 0, p + max_len, p)
        keep = (p >= 0) & (p < max_len)
        sl, p = torch.arange(rows, device=p.device)[keep], p[keep]
    for x, q_pool, s_pool in ((k, k_q, k_s), (v, v_q, v_s)):
        q, s = quantize_rows_plain(x.reshape(rows * heads, hd))
        q, s = q.reshape(rows, heads, hd), s.reshape(rows, heads, 1)
        if pos is None:
            q_pool[slot, :rows] = q
            s_pool[slot, :rows] = s
        else:
            q_pool[sl, p] = q[keep]
            s_pool[sl, p] = s[keep]


def quantize_rows_scaled_plain(x: torch.Tensor, block_size: int):
    """Plain PyTorch version of K1's shared-scale entry for one
    worker-stacked piece ``[N, *shape]``: each worker's flattened piece is
    zero-padded to whole blocks, each block's absmax taken over every
    worker -> (int8 ``[N, nb, bs]``, f32 scale ``[nb, 1]``, f32 absmax
    ``[nb, 1]``)."""
    workers = x.shape[0]
    flat = x.reshape(workers, -1)
    n = flat.shape[1]
    nb = -(-n // block_size)
    if nb * block_size != n:
        flat = F.pad(flat, (0, nb * block_size - n))
    xb = flat.reshape(workers, nb, block_size)
    if nb == 0:
        absmax = torch.zeros((0, 1), dtype=torch.float32, device=x.device)
    else:
        absmax = xb.float().abs().amax(dim=(0, 2)).reshape(nb, 1)
    return _quant(xb, _inv_scale(absmax)[None]), absmax * RECIP_127, absmax


def quantize_rows_scaled_many_plain(xs, block_size: int):
    """Plain PyTorch version of ``quantize_rows_scaled_many``: the
    one-piece plain version over each piece."""
    return [quantize_rows_scaled_plain(x, block_size) for x in xs]


def quantize_tensor_plain(x: torch.Tensor, return_absmax: bool = False):
    """Plain PyTorch version of K2 for one piece: one absmax over all of
    ``x`` -> (int8 like ``x``, f32 scalar scale) [, the absmax]. An empty
    ``x`` has absmax 0."""
    if x.numel() == 0:
        absmax = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        absmax = x.float().abs().amax()
    q, scale = _quant(x, _inv_scale(absmax)), absmax * RECIP_127
    return (q, scale, absmax) if return_absmax else (q, scale)


def quantize_tensors_plain(xs):
    """Plain PyTorch version of ``quantize_tensors``: [(q, scale, absmax)]
    of the one-piece plain version over each piece."""
    return [quantize_tensor_plain(x, return_absmax=True) for x in xs]


# ------------------------------------------------- multi-tensor planning

# pieces in one descriptor table: csrc/common.cuh kMaxPieces (the table
# goes by value in the 4 KB kernel parameter space)
MAX_PIECES = 64
# elements a K2 block takes at a time: csrc/quantize_tensor.cu kChunk
K2_CHUNK = 8192


class TablePlan(NamedTuple):
    """One descriptor table of a multi-tensor call: the pieces it takes
    (indices into the call's list, in order) and the first work unit of
    each, then the table's total."""

    pieces: Tuple[int, ...]
    first: Tuple[int, ...]


def _tables(indices, units, max_pieces) -> List[TablePlan]:
    out = []
    for k in range(0, len(indices), max_pieces):
        part = indices[k:k + max_pieces]
        first = [0]
        for i in part:
            first.append(first[-1] + units[i])
        out.append(TablePlan(tuple(part), tuple(first)))
    return out


def plan_tensor_tables(lengths, max_pieces: int = MAX_PIECES,
                       chunk: int = K2_CHUNK) -> List[TablePlan]:
    """K2's launch plan for pieces of ``lengths`` elements: each
    non-empty piece is ``ceil(n / chunk)`` chunks, the pieces in order in
    tables of at most ``max_pieces``. Empty pieces get no work (their
    absmax and scale stay 0)."""
    units = [-(-int(n) // chunk) for n in lengths]
    return _tables([i for i, n in enumerate(lengths) if n], units, max_pieces)


def plan_rows_tables(nbs, max_pieces: int = MAX_PIECES) -> List[TablePlan]:
    """K1 shared-scale's launch plan: the work unit is one block-row of a
    piece (every worker's block r), ``nbs[i]`` of them for piece i; the
    non-empty pieces, in order, in tables of at most ``max_pieces``."""
    return _tables([i for i, nb in enumerate(nbs) if nb], list(nbs), max_pieces)


class _Layout:
    """Word offsets of a descriptor table (csrc/quantize_tensor.cu
    TensorTable, csrc/quantize_rows.cu RowsTable): ``header`` int64 words,
    then arrays of MAX_PIECES words (the last, of first units, one more)."""

    def __init__(self, header: int, arrays):
        self.header, self.offset, at = header, {}, header
        for name in arrays:
            self.offset[name] = at
            at += MAX_PIECES
        self.words = at + 1


_K2_TABLE = _Layout(2, ["x", "q", "n", "kind", "slot", "first"])
_K1_TABLE = _Layout(4, ["x", "q", "n", "nb", "kind", "slot", "first"])
_F32_VEC, _F32, _BF16, _BF16_VEC = 0, 1, 2, 3  # the kernels' load kinds
# int64 words of csrc/quantize_rows.cu KvWrite
_KV_WORDS = 18


def _padded(n: int) -> int:
    return -(-n // 16) * 16  # each piece's int8 output starts 16-byte aligned


def _strides(shape) -> Tuple[int, ...]:
    out, acc = [], 1
    for d in reversed(shape):
        out.append(acc)
        acc *= int(d)
    return tuple(reversed(out))


def _put(words: np.ndarray, layout: _Layout, name: str, values) -> None:
    at = layout.offset[name]
    words[at:at + len(values)] = values


@functools.lru_cache(maxsize=256)
def _tensor_call(shapes):
    """K2's per-shape work for pieces of ``shapes``, done once: the
    tables with every word but the pointers and load kinds, and each
    piece's int8 output view (shape, strides, offset into the call's
    buffer) and the buffer's length."""
    lengths = [int(np.prod(shape, dtype=np.int64)) for shape in shapes]
    q_off = np.cumsum([0] + [_padded(n) for n in lengths]).tolist()
    tables = []
    for t in plan_tensor_tables(lengths):
        words = np.zeros(_K2_TABLE.words, dtype=np.int64)
        words[:2] = [len(t.pieces), t.first[-1]]
        _put(words, _K2_TABLE, "n", [lengths[i] for i in t.pieces])
        _put(words, _K2_TABLE, "slot", list(t.pieces))
        _put(words, _K2_TABLE, "first", t.first)
        tables.append((t, words))
    views = [(shape, _strides(shape), q_off[i]) for i, shape in enumerate(shapes)]
    return tables, views, q_off[-1]


@functools.lru_cache(maxsize=256)
def _rows_call(workers, lengths, block_size):
    """K1 shared-scale's per-shape work, done once: the tables with every
    word but the pointers and load kinds, and each piece's three output
    views (shape, strides, offset): q into the call's int8 buffer, scale
    and absmax into its f32 buffer (every absmax row, then every scale
    row); and the two buffers' lengths."""
    nbs = [-(-n // block_size) for n in lengths]
    plan = plan_rows_tables(nbs)
    q_off = np.cumsum([0] + [_padded(workers * nb * block_size) for nb in nbs]).tolist()
    slot = np.cumsum([0] + nbs).tolist()
    tables = []
    for t in plan:
        words = np.zeros(_K1_TABLE.words, dtype=np.int64)
        words[:4] = [len(t.pieces), t.first[-1], workers, block_size]
        _put(words, _K1_TABLE, "n", [lengths[i] for i in t.pieces])
        _put(words, _K1_TABLE, "nb", [nbs[i] for i in t.pieces])
        _put(words, _K1_TABLE, "slot", [slot[i] for i in t.pieces])
        _put(words, _K1_TABLE, "first", t.first)
        tables.append((t, words))
    rows = slot[-1]
    views = [((workers, nb, block_size), (nb * block_size, block_size, 1), q_off[i],
              (nb, 1), (1, 1), rows + slot[i], slot[i])
             for i, nb in enumerate(nbs)]
    return tables, views, q_off[-1], rows


_checked_tables = False


def _lib():
    """The kernel library, with its table layouts checked against this
    module's once."""
    global _checked_tables
    from . import _build

    lib = _build.load()
    if not _checked_tables:
        got = (lib.ps_tensor_table_words(), lib.ps_rows_table_words(),
               lib.ps_kv_write_words())
        want = (_K2_TABLE.words, _K1_TABLE.words, _KV_WORDS)
        if got != want:
            raise _build.KernelBuildError(
                f"descriptor tables of {got} words in the library, {want} here")
        _checked_tables = True
    return lib


def _card_pieces(xs, what: str):
    """The pieces as the kernels take them (contiguous, f32 or bf16, one
    card), or None when every piece lies on the CPU."""
    if not any(x.is_cuda for x in xs):
        return None
    dev = xs[0].device
    if any(x.device != dev for x in xs):
        raise ValueError(f"{what}: the pieces lie on {sorted({str(x.device) for x in xs})}; "
                         f"one call takes one card")
    from . import _build

    for x in xs:
        if x.dtype not in _build.DTYPE_CODES:
            raise TypeError(f"{what}: unsupported dtype {x.dtype}")
    return [x.contiguous() for x in xs]


def _kernel_input(x: torch.Tensor, what: str) -> torch.Tensor:
    from . import _build

    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{what}: unsupported dtype {x.dtype}")
    return x.contiguous()


def _rows_width(xs, what: str) -> int:
    if (not xs or any(x.dim() != 2 or x.shape[1] != xs[0].shape[1] or x.dtype != xs[0].dtype
                      for x in xs) or xs[0].shape[1] < 1):
        raise ValueError(f"{what} takes [NB, BS] pieces of one BS >= 1 and one dtype, got "
                         f"{[(tuple(x.shape), str(x.dtype)) for x in xs]}")
    return int(xs[0].shape[1])


def row_lanes(hd: int, elt: int, offsets) -> Tuple[bool, int]:
    """K1's lanes a row (the KV entry, ``quantize_rows_many``) -> (vector
    path, group): a row of ``hd`` elements of ``elt`` bytes is ``hd * elt
    / 16`` lanes, one 16-byte load each, when that is a power of two up
    to 32 and every byte address and stride in ``offsets`` is 16-byte
    aligned; otherwise one warp loops over the row (group 32)."""
    lanes = hd * elt // 16
    if (hd * elt % 16 == 0 and 1 <= lanes <= 32 and lanes & (lanes - 1) == 0
            and all(int(a) % 16 == 0 for a in offsets)):
        return True, lanes
    return False, 32


def _rows_many_launch(xs_card, bs: int):
    """Launch K1's per-row kernel over card pieces ``[NB, BS]`` of one
    dtype (a launch per descriptor table) -> ``[(q [NB, BS], scale [NB,
    1])]`` views of one int8 and one f32 buffer, and the launches made.
    Every row's lanes load 16 bytes each when BS and every piece allow
    it (``row_lanes``), else one warp loops over the row."""
    from . import _build

    tables, views, q_len, rows = _rows_call(1, tuple(x.numel() for x in xs_card), bs)
    dev = xs_card[0].device
    q = torch.empty((q_len,), dtype=torch.int8, device=dev)
    scale = torch.empty((rows,), dtype=torch.float32, device=dev)
    ptrs = [x.data_ptr() for x in xs_card]
    vec, group = row_lanes(bs, xs_card[0].element_size(), ptrs)
    launches = 0
    if tables:
        lib = _lib()
        base = q.data_ptr()
        with torch.cuda.device(dev):
            stream = _build.stream_of(xs_card[0])
            for t, template in tables:
                words = template.copy()
                _put(words, _K1_TABLE, "x", [ptrs[i] for i in t.pieces])
                _put(words, _K1_TABLE, "q", [base + views[i][2] for i in t.pieces])
                code = lib.ps_quantize_rows_many(
                    words.ctypes.data, _build.DTYPE_CODES[xs_card[0].dtype], int(vec), group,
                    scale.data_ptr(), stream)
                launches += 1
                _build.check(code, "quantize_rows_many")
    # the scale of piece i starts at row slot[i] (its views' absmax offset)
    out = [(q.as_strided((ss[0], bs), (bs, 1), qo), scale.as_strided(ss, sst, ao))
           for _, _, qo, ss, sst, _, ao in views]
    return out, launches


@kernel_entry("K1", numerics="quantize")
def quantize_rows(xb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: per-row int8 quantization of ``[NB, BS]`` (f32 or bf16) ->
    (int8 ``[NB, BS]``, f32 scale ``[NB, 1]``): ``quantize_rows_many``'s
    one-piece call, with its own ``.launches``.

    Replaces ps_pytorch_tpu/ops/quantize.py:_quant_rows_kernel (Pallas,
    quantize.py:64, launched at :101) and fuses the absmax/scale that
    XLA computed outside it. Bound on the H100: bytes. A CPU tensor runs
    ``quantize_rows_plain``; a CUDA tensor launches the kernel or
    raises."""
    if xb.dim() != 2:
        raise ValueError(f"quantize_rows takes [NB, BS], got {tuple(xb.shape)}")
    if not xb.is_cuda:
        return quantize_rows_plain(xb)
    xb = _kernel_input(xb, "quantize_rows")
    nb, bs = xb.shape
    if xb.numel() == 0:
        return (torch.empty((nb, bs), dtype=torch.int8, device=xb.device),
                torch.empty((nb, 1), dtype=torch.float32, device=xb.device))
    (out,), launches = _rows_many_launch([xb], bs)
    quantize_rows.launches += launches
    return out


quantize_rows.launches = 0


@kernel_entry("K1", numerics="quantize")
def quantize_rows_many(xs):
    """K1, per-row scales over every piece of a list: each ``xs[i]`` is
    ``[NB_i, BS]`` (one BS and one dtype, f32 or bf16, one card, NB_i >=
    0) -> ``[(q int8 [NB_i, BS], scale f32 [NB_i, 1]), ...]``, each row
    with its own absmax. The two-round wire's round 2 over a step's
    pieces.

    Replaces ps_pytorch_tpu/ops/quantize.py:_quant_rows_kernel with the
    row absmax XLA computed around it, one wrapper call for the list and
    a launch per descriptor table of ``MAX_PIECES`` pieces
    (``plan_rows_tables``): a row is a group of lanes, 16 bytes a lane
    (a warp a 128-wide f32 row), one plain grid. Bound on the H100:
    bytes. CPU pieces run ``quantize_rows_many_plain``; CUDA pieces launch
    the kernel or raise. ``.launches`` counts the launches, one a table."""
    xs = list(xs)
    bs = _rows_width(xs, "quantize_rows_many")
    xs_card = _card_pieces(xs, "quantize_rows_many")
    if xs_card is None:
        return quantize_rows_many_plain(xs)
    out, launches = _rows_many_launch(xs_card, bs)
    quantize_rows_many.launches += launches
    return out


quantize_rows_many.launches = 0


@kernel_entry("K1", writes=(2, 3, 4, 5), numerics="kv_write")
def quantize_kv_write(k, v, k_q, k_s, v_q, v_s, slot=None, pos=None) -> None:
    """K1, KV entry: quantize one layer's K and V ``[R, H, hd]`` (f32 or
    bf16, any row and head strides) per (position, head) row and store
    the int8 rows into the layer's pool views ``k_q`` / ``v_q`` ``[slots,
    max_len, H, hd]`` and the f32 scales into ``k_s`` / ``v_s`` ``[slots,
    max_len, H, 1]``, in place. Prefill (``slot``): row t goes to ``(slot,
    t)``. Decode (``pos``, int ``[R]`` on the card): row s goes to ``(s,
    pos[s])``; a negative position wraps once by ``max_len`` and one
    still outside ``[0, max_len)`` is dropped, as JAX's scatter drops it.

    Replaces ps_pytorch_tpu/ops/quantize.py:_quant_rows_kernel as the
    serving pool calls it (serve/kv.py:62-113: ``_quant_rows``, then
    ``write_slot``'s ``dynamic_update_slice`` or ``write_token``'s
    scatter), the quantize and both writes of K and of V in one launch.
    The launch is the cost: a decode tick's call moves 16 KB at the
    serving shape. A CPU tensor runs ``quantize_kv_write_plain``; a CUDA
    tensor launches the kernel or raises. ``.launches`` counts calls."""
    rows, heads, hd, max_len = _kv_geometry(k, v, k_q, k_s, v_q, v_s, slot, pos)
    if not k.is_cuda:
        return quantize_kv_write_plain(k, v, k_q, k_s, v_q, v_s, slot, pos)
    from . import _build

    if k.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"quantize_kv_write: unsupported dtype {k.dtype}")
    k = k if k.stride(2) == 1 else k.contiguous()
    v = v if v.stride(2) == 1 else v.contiguous()
    elt = k.element_size()
    offsets = [t.data_ptr() for t in (k, v, k_q, v_q)]
    for x in (k, v):
        offsets += [x.stride(0) * elt if rows > 1 else 0, x.stride(1) * elt if heads > 1 else 0]
    vec, group = row_lanes(hd, elt, offsets)
    pos = None if pos is None else pos.contiguous()
    words = np.array([
        k.data_ptr(), v.data_ptr(), k.stride(0), v.stride(0), k.stride(1), v.stride(1),
        k_q.data_ptr(), v_q.data_ptr(), k_s.data_ptr(), v_s.data_ptr(),
        0 if pos is None else pos.data_ptr(),
        int(pos is not None and pos.dtype == torch.int64),
        rows, heads, hd, max_len, 0 if slot is None else slot, group,
    ], dtype=np.int64)
    lib = _lib()
    with torch.cuda.device(k.device):
        code = lib.ps_quantize_kv_write(words.ctypes.data, _build.DTYPE_CODES[k.dtype],
                                        int(vec), _build.stream_of(k))
    quantize_kv_write.launches += 1
    _build.check(code, "quantize_kv_write")


quantize_kv_write.launches = 0


@kernel_entry("K1", shared=True, numerics="quantize")
def quantize_rows_scaled_many(xs, block_size: int):
    """K1, shared-scale entry over every piece of a step: each ``xs[i]``
    is worker-stacked ``[N, *shape]`` (f32 or bf16, the same N for all,
    any length, 0 included), flattened per worker and cut into ``nb =
    ceil(n / block_size)`` blocks -> ``[(q int8 [N, nb, bs], scale f32
    [nb, 1], absmax f32 [nb, 1]), ...]``, block r's absmax the max over
    every worker's block r (the pmax), shared by them.

    Replaces the Pallas kernel of ``quantize_rows`` where its ``inv``
    came from a pmax'd absmax (ps_pytorch_tpu/ops/quantize.py:152-167),
    together with that absmax, which XLA computed around it. One wrapper
    call for the whole list: a launch per table of ``MAX_PIECES`` pieces
    (one for ResNet18's 62 leaves), no padded copy (the padding is read
    as 0 inside the kernel) and no absmax pass outside it. Bound on the
    H100: bytes (x read once, one int8 written per element). CPU pieces
    run ``quantize_rows_scaled_many_plain``; CUDA pieces launch the
    kernel or raise. ``.launches`` counts the calls that launch."""
    if block_size < 1:
        raise ValueError(f"quantize_rows_scaled_many: block_size {block_size} < 1")
    xs = list(xs)
    for x in xs:
        if x.dim() == 0 or x.shape[0] < 1 or x.shape[0] != xs[0].shape[0]:
            raise ValueError("quantize_rows_scaled_many takes worker-stacked [N, ...] pieces "
                             f"of one N, got {[tuple(x.shape) for x in xs]}")
    xs_card = _card_pieces(xs, "quantize_rows_scaled_many")
    if xs_card is None:
        return quantize_rows_scaled_many_plain(xs, block_size)
    from . import _build

    workers = xs[0].shape[0]
    lengths = tuple(x.numel() // workers for x in xs_card)
    tables, views, q_len, rows = _rows_call(workers, lengths, block_size)
    dev = xs_card[0].device
    q = torch.empty((q_len,), dtype=torch.int8, device=dev)
    stats = torch.empty((2 * rows,), dtype=torch.float32, device=dev)
    if tables:
        lib = _lib()
        ptrs = [x.data_ptr() for x in xs_card]
        base = q.data_ptr()
        with torch.cuda.device(dev):
            stream = _build.stream_of(xs_card[0])
            for t, template in tables:
                words = template.copy()
                _put(words, _K1_TABLE, "x", [ptrs[i] for i in t.pieces])
                _put(words, _K1_TABLE, "q", [base + views[i][2] for i in t.pieces])
                _put(words, _K1_TABLE, "kind", [_k1_kind(xs_card[i].dtype, ptrs[i], lengths[i],
                                                         block_size) for i in t.pieces])
                code = lib.ps_quantize_rows_scaled_many(
                    words.ctypes.data, stats.data_ptr(), stats.data_ptr() + 4 * rows, stream)
                _build.check(code, "quantize_rows_scaled_many")
        quantize_rows_scaled_many.launches += 1
    return [(q.as_strided(qs, qst, qo), stats.as_strided(ss, sst, so),
             stats.as_strided(ss, sst, ao)) for qs, qst, qo, ss, sst, so, ao in views]


quantize_rows_scaled_many.launches = 0


def _k1_kind(dtype, ptr: int, n: int, block_size: int) -> int:
    """A piece's load kind: four elements a lane in one load (f32 16-byte,
    bf16 8-byte aligned, n and the block a multiple of 4), or one a time."""
    whole = n % 4 == 0 and block_size % 4 == 0
    if dtype == torch.bfloat16:
        return _BF16_VEC if ptr % 8 == 0 and whole else _BF16
    return _F32_VEC if ptr % 16 == 0 and whole else _F32


@kernel_entry("K2", shared=True, numerics="quantize")
def quantize_tensors(xs):
    """K2: per-tensor int8 quantization of every piece of a step in one
    call: each ``xs[i]`` (any shape and length, 0 included; f32 or bf16;
    one card) gets one absmax over the whole piece (for a worker-stacked
    piece that is the pmax) and one scale -> ``[(q int8 like xs[i], scale
    f32 0-d, absmax f32 0-d), ...]``.

    Replaces ps_pytorch_tpu/ops/quantize.py:_quant_kernel (Pallas,
    quantize.py:58, launched at :78 once per piece) together with the
    absmax and inverse XLA computed around it. The call cuts the list
    into descriptor tables (``plan_tensor_tables``; one for ResNet18's 62
    leaves) and launches two kernels per table, the absmax of every piece
    and then its quantize; after one zeroing of the absmax slots nothing
    goes through the host. Bound on the H100: bytes. CPU pieces run
    ``quantize_tensors_plain``; CUDA pieces launch the kernels or raise.
    ``.launches`` counts the calls that launch."""
    xs = list(xs)
    xs_card = _card_pieces(xs, "quantize_tensors")
    if xs_card is None:
        return quantize_tensors_plain(xs)
    from . import _build

    tables, views, q_len = _tensor_call(tuple(x.shape for x in xs_card))
    dev = xs_card[0].device
    q = torch.empty((q_len,), dtype=torch.int8, device=dev)
    stats = torch.zeros((2, len(xs)), dtype=torch.float32, device=dev)  # absmax, scale
    if tables:
        lib = _lib()
        ptrs = [x.data_ptr() for x in xs_card]
        base = q.data_ptr()
        with torch.cuda.device(dev):
            stream = _build.stream_of(xs_card[0])
            for t, template in tables:
                words = template.copy()
                _put(words, _K2_TABLE, "x", [ptrs[i] for i in t.pieces])
                _put(words, _K2_TABLE, "q", [base + views[i][2] for i in t.pieces])
                _put(words, _K2_TABLE, "kind", [_k2_kind(xs_card[i].dtype, ptrs[i])
                                                for i in t.pieces])
                code = lib.ps_quantize_tensors(words.ctypes.data, stats.data_ptr(),
                                               stats.data_ptr() + 4 * len(xs), stream)
                _build.check(code, "quantize_tensors")
        quantize_tensors.launches += 1
    absmax, scale = stats.unbind(0)
    return [(q.as_strided(*view), sc, am)
            for view, sc, am in zip(views, scale.unbind(), absmax.unbind())]


quantize_tensors.launches = 0


def _k2_kind(dtype, ptr: int) -> int:
    if dtype == torch.bfloat16:
        return _BF16
    return _F32_VEC if ptr % 16 == 0 else _F32


def quantize_tensor(x: torch.Tensor, return_absmax: bool = False):
    """K2 on one piece: ``quantize_tensors([x])`` -> (int8 like ``x``, f32
    scalar scale) [, the device absmax the scale came from]. A CPU tensor
    runs ``quantize_tensor_plain`` (through ``quantize_tensors``, so a
    recorded step has the same K2 node on either device)."""
    q, scale, absmax = quantize_tensors([x])[0]
    return (q, scale, absmax) if return_absmax else (q, scale)


# ------------------------------------- the split route (a process-spanning axis)


def tensors_absmax_plain(xs) -> torch.Tensor:
    """Plain PyTorch version of ``tensors_absmax``."""
    dev = xs[0].device if xs else "cpu"
    return torch.stack([x.float().abs().amax() if x.numel() else
                        torch.zeros((), dtype=torch.float32, device=dev) for x in xs])


def quantize_tensors_given_plain(xs, absmax: torch.Tensor):
    """Plain PyTorch version of ``quantize_tensors_given``."""
    return [(_quant(x, _inv_scale(am)), am * RECIP_127, am) for x, am in zip(xs, absmax)]


def _split_check(xs, absmax, rows: int, what: str) -> None:
    if (absmax.dtype != torch.float32 or tuple(absmax.shape) != (rows,)
            or any(x.device != absmax.device for x in xs)):
        raise ValueError(f"{what} takes the f32 absmax [{rows}] on the pieces' device, got "
                         f"{absmax.dtype} {tuple(absmax.shape)} on {absmax.device}")


@kernel_entry("K2", numerics="absmax")
def tensors_absmax(xs) -> torch.Tensor:
    """K2's split route, first half: this process's absmax of every piece
    (the worker-stacked pieces of its local workers) -> f32 ``[len(xs)]``,
    0 for an empty piece. Launches ``absmax_many_kernel`` per descriptor
    table (``ps_absmax_tensors``, csrc/quantize_tensor.cu): the first of
    ``quantize_tensors``' two kernels, on its own so that the
    cross-process max can follow it. CPU pieces run
    ``tensors_absmax_plain``; ``.launches`` counts the calls that launch."""
    xs = list(xs)
    xs_card = _card_pieces(xs, "tensors_absmax")
    if xs_card is None:
        return tensors_absmax_plain(xs)
    from . import _build

    tables, _, _ = _tensor_call(tuple(x.shape for x in xs_card))
    absmax = torch.zeros((len(xs),), dtype=torch.float32, device=xs_card[0].device)
    if tables:
        lib = _lib()
        ptrs = [x.data_ptr() for x in xs_card]
        with torch.cuda.device(absmax.device):
            stream = _build.stream_of(xs_card[0])
            for t, template in tables:
                words = template.copy()
                _put(words, _K2_TABLE, "x", [ptrs[i] for i in t.pieces])
                _put(words, _K2_TABLE, "kind", [_k2_kind(xs_card[i].dtype, ptrs[i])
                                                for i in t.pieces])
                _build.check(lib.ps_absmax_tensors(words.ctypes.data, absmax.data_ptr(), stream),
                             "tensors_absmax")
        tensors_absmax.launches += 1
    return absmax


tensors_absmax.launches = 0


@kernel_entry("K2", numerics="quantize_given")
def quantize_tensors_given(xs, absmax: torch.Tensor):
    """K2's split route, second half: every piece quantized with the given
    (cross-process) absmax ``[len(xs)]`` -> ``[(q int8 like xs[i], scale
    f32 0-d, absmax f32 0-d), ...]``, as ``quantize_tensors`` returns.
    Launches ``quantize_many_kernel`` per descriptor table
    (``ps_quantize_tensors_given``). A NaN absmax gives scale NaN and an
    all-zero payload. CPU pieces run ``quantize_tensors_given_plain``;
    ``.launches`` counts the calls that launch."""
    xs = list(xs)
    _split_check(xs, absmax, len(xs), "quantize_tensors_given")
    xs_card = _card_pieces(xs, "quantize_tensors_given")
    if xs_card is None:
        return quantize_tensors_given_plain(xs, absmax)
    from . import _build

    tables, views, q_len = _tensor_call(tuple(x.shape for x in xs_card))
    dev = xs_card[0].device
    absmax = absmax.contiguous()
    q = torch.empty((q_len,), dtype=torch.int8, device=dev)
    scale = torch.zeros((len(xs),), dtype=torch.float32, device=dev)
    if tables:
        lib = _lib()
        ptrs = [x.data_ptr() for x in xs_card]
        base = q.data_ptr()
        with torch.cuda.device(dev):
            stream = _build.stream_of(xs_card[0])
            for t, template in tables:
                words = template.copy()
                _put(words, _K2_TABLE, "x", [ptrs[i] for i in t.pieces])
                _put(words, _K2_TABLE, "q", [base + views[i][2] for i in t.pieces])
                _put(words, _K2_TABLE, "kind", [_k2_kind(xs_card[i].dtype, ptrs[i])
                                                for i in t.pieces])
                _build.check(lib.ps_quantize_tensors_given(
                    words.ctypes.data, absmax.data_ptr(), scale.data_ptr(), stream),
                    "quantize_tensors_given")
        quantize_tensors_given.launches += 1
    return [(q.as_strided(*view), sc, am)
            for view, sc, am in zip(views, scale.unbind(), absmax.unbind())]


quantize_tensors_given.launches = 0


def _rows_split_plan(xs, block_size: int, what: str):
    if block_size < 1:
        raise ValueError(f"{what}: block_size {block_size} < 1")
    for x in xs:
        if x.dim() == 0 or x.shape[0] < 1 or x.shape[0] != xs[0].shape[0]:
            raise ValueError(f"{what} takes worker-stacked [N, ...] pieces of one N, got "
                             f"{[tuple(x.shape) for x in xs]}")
    workers = xs[0].shape[0] if xs else 1
    return _rows_call(workers, tuple(x.numel() // workers for x in xs), block_size)


def rows_scaled_absmax_plain(xs, block_size: int) -> torch.Tensor:
    """Plain PyTorch version of ``rows_scaled_absmax``."""
    dev = xs[0].device if xs else "cpu"
    parts = [quantize_rows_scaled_plain(x, block_size)[2].reshape(-1) for x in xs]
    return torch.cat(parts) if parts else torch.zeros((0,), dtype=torch.float32, device=dev)


def quantize_rows_scaled_given_plain(xs, block_size: int, absmax: torch.Tensor):
    """Plain PyTorch version of ``quantize_rows_scaled_given``."""
    out, at = [], 0
    for x in xs:
        workers = x.shape[0]
        flat = x.reshape(workers, -1)
        nb = -(-flat.shape[1] // block_size)
        flat = F.pad(flat, (0, nb * block_size - flat.shape[1]))
        am = absmax[at:at + nb].reshape(nb, 1)
        at += nb
        out.append((_quant(flat.reshape(workers, nb, block_size), _inv_scale(am)[None]),
                    am * RECIP_127, am))
    return out


@kernel_entry("K1", numerics="absmax")
def rows_scaled_absmax(xs, block_size: int) -> torch.Tensor:
    """K1's shared-scale split route, first half: block r's absmax of
    every piece over this process's workers -> f32 ``[sum of nb_i]``,
    piece by piece (``quantize_rows_scaled_many``'s blocking: each
    worker's flattened piece zero-padded to whole blocks). One launch of
    ``rows_absmax_many_kernel`` per descriptor table
    (``ps_rows_scaled_absmax_many``, csrc/quantize_rows.cu). CPU pieces
    run ``rows_scaled_absmax_plain``; ``.launches`` counts the calls that
    launch."""
    xs = list(xs)
    tables, _, _, rows = _rows_split_plan(xs, block_size, "rows_scaled_absmax")
    xs_card = _card_pieces(xs, "rows_scaled_absmax")
    if xs_card is None:
        return rows_scaled_absmax_plain(xs, block_size)
    from . import _build

    workers = xs[0].shape[0]
    lengths = [x.numel() // workers for x in xs_card]
    absmax = torch.empty((rows,), dtype=torch.float32, device=xs_card[0].device)
    if tables:
        lib = _lib()
        ptrs = [x.data_ptr() for x in xs_card]
        with torch.cuda.device(absmax.device):
            stream = _build.stream_of(xs_card[0])
            for t, template in tables:
                words = template.copy()
                _put(words, _K1_TABLE, "x", [ptrs[i] for i in t.pieces])
                _put(words, _K1_TABLE, "kind", [_k1_kind(xs_card[i].dtype, ptrs[i], lengths[i],
                                                         block_size) for i in t.pieces])
                _build.check(lib.ps_rows_scaled_absmax_many(words.ctypes.data,
                                                            absmax.data_ptr(), stream),
                             "rows_scaled_absmax")
        rows_scaled_absmax.launches += 1
    return absmax


rows_scaled_absmax.launches = 0


@kernel_entry("K1", numerics="quantize_given")
def quantize_rows_scaled_given(xs, block_size: int, absmax: torch.Tensor):
    """K1's shared-scale split route, second half: every worker's block r
    of every piece quantized with the given (cross-process) block absmax,
    laid out as ``rows_scaled_absmax`` returns it -> ``[(q int8 [N_loc,
    nb, bs], scale f32 [nb, 1], absmax f32 [nb, 1]), ...]``, as
    ``quantize_rows_scaled_many`` returns. One launch of
    ``rows_quantize_given_many_kernel`` per descriptor table
    (``ps_quantize_rows_scaled_given_many``). A NaN absmax gives its
    block scale NaN and an all-zero payload. CPU pieces run
    ``quantize_rows_scaled_given_plain``; ``.launches`` counts the calls
    that launch."""
    xs = list(xs)
    tables, views, q_len, rows = _rows_split_plan(xs, block_size, "quantize_rows_scaled_given")
    _split_check(xs, absmax, rows, "quantize_rows_scaled_given")
    xs_card = _card_pieces(xs, "quantize_rows_scaled_given")
    if xs_card is None:
        return quantize_rows_scaled_given_plain(xs, block_size, absmax)
    from . import _build

    dev = xs_card[0].device
    absmax = absmax.contiguous()
    q = torch.empty((q_len,), dtype=torch.int8, device=dev)
    scale = torch.empty((rows,), dtype=torch.float32, device=dev)
    if tables:
        lib = _lib()
        workers = xs[0].shape[0]
        ptrs = [x.data_ptr() for x in xs_card]
        base = q.data_ptr()
        with torch.cuda.device(dev):
            stream = _build.stream_of(xs_card[0])
            for t, template in tables:
                words = template.copy()
                _put(words, _K1_TABLE, "x", [ptrs[i] for i in t.pieces])
                _put(words, _K1_TABLE, "q", [base + views[i][2] for i in t.pieces])
                _put(words, _K1_TABLE, "kind", [_k1_kind(xs_card[i].dtype, ptrs[i],
                                                         xs_card[i].numel() // workers,
                                                         block_size) for i in t.pieces])
                _build.check(lib.ps_quantize_rows_scaled_given_many(
                    words.ctypes.data, absmax.data_ptr(), scale.data_ptr(), stream),
                    "quantize_rows_scaled_given")
        quantize_rows_scaled_given.launches += 1
    return [(q.as_strided(qs, qst, qo), scale.as_strided(ss, sst, ao),
             absmax.as_strided(ss, sst, ao)) for qs, qst, qo, ss, sst, _, ao in views]


quantize_rows_scaled_given.launches = 0


def quantize_int8_many(xs, axis_name, block_size: int = 0):
    """``quantize_int8(x, axis_name=axis_name, block_size=block_size,
    return_absmax=True)`` of every piece of ``xs`` (worker-stacked ``[N,
    *shape]``) in one kernel call: K2 per tensor, K1's shared-scale entry
    per block. The gradient wire's quantize of a step.

    On an axis that spans processes (``parallel.mesh.ProcessWorkerAxis``:
    ``xs`` holds this process's workers) the call takes the split route:
    this process's absmax (``tensors_absmax`` / ``rows_scaled_absmax``),
    the axis's cross-process max of it (``absmax_max``, NaN kept), then
    the quantize with that (``quantize_tensors_given`` /
    ``quantize_rows_scaled_given``): every process gets the one-process
    call's scales and its own workers' payloads."""
    if not hasattr(axis_name, "size"):
        raise TypeError(f"axis_name must be a parallel.mesh.WorkerAxis, got {axis_name!r}")
    xs = list(xs)
    split = hasattr(axis_name, "absmax_max")
    if not block_size:
        if split:
            return quantize_tensors_given(xs, axis_name.absmax_max(tensors_absmax(xs)))
        with shared_over(axis_name):  # a recorded step: the kernel's pmax
            return quantize_tensors(xs)
    for x in xs:
        if x.dim() == 0 or x.shape[0] != axis_name.local_size:
            raise ValueError(f"shared-scale quantize_int8 takes [{axis_name.local_size}, ...], "
                             f"got {tuple(x.shape)}")
    if split:
        absmax = axis_name.absmax_max(rows_scaled_absmax(xs, block_size))
        return quantize_rows_scaled_given(xs, block_size, absmax)
    with shared_over(axis_name):
        return quantize_rows_scaled_many(xs, block_size)


def _round(x: torch.Tensor, inv: torch.Tensor, rounding: str,
           uniform: Optional[torch.Tensor]) -> torch.Tensor:
    """``round(x * inv)`` (nearest, half to even, as ``jnp.round``) or
    ``floor(x * inv + u)`` (stochastic: ``P(up) = frac(x * inv)``, so
    unbiased; quantize.py:119). XLA fuses the stochastic sum into one
    multiply-add on the CPU; the product of two f32 is exact in f64, so
    the sum is taken there and rounded once to f32."""
    if rounding == "nearest":
        return torch.round(x * inv)
    if rounding == "stochastic":
        if uniform is None:
            raise ValueError("stochastic rounding needs uniform draws (U[0, 1) f32, "
                             "shaped like the rounded operand)")
        if tuple(uniform.shape) != tuple(x.shape):
            raise ValueError(f"uniform draws {tuple(uniform.shape)} do not match the rounded "
                             f"operand {tuple(x.shape)}")
        return torch.floor((x.double() * inv.double() + uniform.double()).float())
    raise ValueError(f"unknown rounding {rounding!r}")


def _blocks(x: torch.Tensor, block_size: int, stacked: bool) -> torch.Tensor:
    """The zero-padded block rows of ``x``'s flattened elements: ``[nb,
    bs]``, or ``[N, nb, bs]`` per worker when ``stacked``."""
    flat = x.reshape(x.shape[0], -1) if stacked else x.reshape(-1)
    n = flat.shape[-1]
    nb = -(-n // block_size)
    if nb * block_size != n:
        flat = F.pad(flat, (0, nb * block_size - n))
    return flat.reshape(flat.shape[:-1] + (nb, block_size))


def _shared_absmax(x: torch.Tensor, axis_name, block_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(operand, absmax)`` of the plain quantizers: the operand is ``x``
    or its block rows (``_blocks``), the absmax per tensor (0-d) or per
    block row (``[nb, 1]``), over every worker when ``axis_name`` is
    given (the pmax: the stacked axis's ``pmax`` over the workers' own
    maxima, a process-spanning axis's ``absmax_max`` over this process's).
    NaN propagates through the max, as through ``jnp.max``."""
    stacked = axis_name is not None
    split = hasattr(axis_name, "absmax_max")
    if block_size:
        xb = _blocks(x, block_size, stacked)
        absmax = xb.abs().amax(dim=-1, keepdim=True)
        if stacked:
            absmax = absmax.amax(0) if split else axis_name.pmax(absmax)
    else:
        xb = x
        if stacked and not split:
            absmax = axis_name.pmax(x.abs().reshape(x.shape[0], -1).amax(1))
        else:
            absmax = x.abs().amax()
    if split:
        absmax = axis_name.absmax_max(absmax)
    return xb, absmax


def quantize_int8(
    x: torch.Tensor,
    axis_name=None,
    block_size: int = 0,
    rounding: str = "nearest",
    uniform: Optional[torch.Tensor] = None,
    return_absmax: bool = False,
):
    """Symmetric int8 quantization.

    Per-tensor mode (``block_size=0``): q has x's shape, the scale is a
    scalar. Block mode: q is ``[n_blocks, block_size]`` over the
    zero-padded flattened tensor, the scale ``[n_blocks, 1]``; pass the
    original shape to ``dequantize_int8``.

    ``axis_name`` (a ``WorkerAxis``): ``x`` is worker-stacked ``[N,
    *shape]`` and the scales are shared over the workers. Per-tensor:
    q ``[N, *shape]``, one scalar scale. Block mode: each worker's
    flattened tensor is cut into blocks, q is ``[N, n_blocks,
    block_size]`` and the scale ``[n_blocks, 1]``.

    ``rounding="stochastic"`` takes ``uniform``, the U[0, 1) draws of
    every rounded element (shaped like q: the JAX function draws them from
    its ``key`` over the same operand), and runs in plain PyTorch on
    either device: the JAX function takes no Pallas kernel there either.

    ``return_absmax`` (shared or per-tensor scales) also returns the
    absmax the scales came from, shaped like them: a consumer that
    multiplies the scale by a constant multiplies the absmax by the
    folded constant instead (``fold_recip``)."""
    if axis_name is not None and not hasattr(axis_name, "size"):
        raise TypeError(
            f"axis_name must be a parallel.mesh.WorkerAxis, got {axis_name!r}"
        )
    if return_absmax and block_size and axis_name is None:
        raise ValueError("return_absmax needs shared (axis_name) or per-tensor scales")
    if rounding != "nearest":
        xb, absmax = _shared_absmax(x.float(), axis_name, block_size)
        q = torch.clamp(_round(xb, _inv_scale(absmax), rounding, uniform),
                        -_INT8_PEAK, _INT8_PEAK).to(torch.int8)
        scale = absmax * RECIP_127
        return (q, scale, absmax) if return_absmax else (q, scale)
    if uniform is not None:
        raise ValueError("uniform draws are for rounding='stochastic'")
    if not block_size:
        if hasattr(axis_name, "absmax_max"):
            # a process-spanning axis: the split route's pmax
            q, scale, absmax = quantize_int8_many([x], axis_name)[0]
            return (q, scale, absmax) if return_absmax else (q, scale)
        # one absmax over the whole (stacked) tensor is the pmax
        with shared_over(axis_name):
            return quantize_tensor(x, return_absmax)
    if axis_name is not None:
        q, scale, absmax = quantize_int8_many([x], axis_name, block_size)[0]
        return (q, scale, absmax) if return_absmax else (q, scale)
    flat = x.reshape(-1)
    n = flat.shape[-1]
    nb = -(-n // block_size)
    if nb * block_size != n:
        flat = F.pad(flat, (0, nb * block_size - n))
    return quantize_rows(flat.reshape(nb, block_size))


def fold_recip(denominator: float) -> float:
    """``RECIP_127 * f32(1/denominator)``, rounded once to f32: the
    constant XLA folds a dequantize scale's two constant multiplies into
    (``(absmax * (1/127)) * (1/K)`` becomes ``absmax * c`` under jit).
    ``absmax * fold_recip(K)`` is then the JAX program's ``scale / K``."""
    return float(np.float32(RECIP_127) * np.float32(np.float32(1.0) / np.float32(denominator)))


def dequantize_int8(
    q: torch.Tensor,
    scale: torch.Tensor,
    block_size: int = 0,
    shape: Optional[Tuple[int, ...]] = None,
) -> torch.Tensor:
    """Invert ``quantize_int8`` (q may be an int32 sum of int8 payloads).
    Block mode takes q ``[n_blocks, block_size]`` or, worker-stacked,
    ``[N, n_blocks, block_size]``, and ``shape`` without the worker
    dimension."""
    out = q.float() * scale
    if block_size:
        if shape is None:
            raise ValueError("block mode dequantization needs the original shape")
        n = 1
        for d in shape:
            n *= int(d)
        lead = tuple(out.shape[:-2])
        out = out.reshape(lead + (-1,))[..., :n].reshape(lead + tuple(shape))
    return out


# ------------------------------------------ int4 lattice codec + traced peak

_INT4_PEAK = 7    # symmetric int4 payloads live in [-7, 7] (two per byte)
_INT4_BIAS = 8    # nibble storage bias: value + 8 in [1, 15]

# per-bucket precision tags of the adaptive-precision wire
# (PSConfig.precision_adapt): a device int32 per bucket selects the
# lattice peak that bucket quantizes onto this window; the payload's dtype
# and the wire's bytes never change, only the values it carries
PREC_SKIP = 0   # peak 0: q == 0, scale == 0, EF keeps the whole gradient
PREC_4BIT = 1   # peak 7: the int4 lattice (pack_int4 ships 2 a byte)
PREC_INT8 = 2   # peak 127: the int8 lattice
PREC_HI = 3     # peak precision_hi_peak(cfg): the finest the payload carries
PRECISION_TAGS = (PREC_SKIP, PREC_4BIT, PREC_INT8, PREC_HI)
PRECISION_TAG_NAMES = ("skip", "4bit", "int8", "hi")


def precision_peaks(hi_peak: int) -> np.ndarray:
    """The tag -> lattice-peak table (f32 ``[4]``, indexed by a tag)."""
    return np.asarray([0.0, float(_INT4_PEAK), float(_INT8_PEAK), float(hi_peak)],
                      np.float32)


def precision_bytes_per_element(hi_peak: int) -> Tuple[float, ...]:
    """Effective wire bytes per gradient element by tag: skip ships
    nothing, int4 half a byte, int8 one, the HI tag the least integer
    width that holds its peak."""
    hi_bytes = 1.0 if hi_peak <= _INT8_PEAK else (2.0 if hi_peak <= 2 ** 15 - 1 else 4.0)
    return (0.0, 0.5, 1.0, hi_bytes)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int4 lattice values (int8 storage in [-7, 7]) two a byte: value + 8
    in the low / high nibble of a uint8. An odd count pads the last high
    nibble with the bias (value 0), so ``unpack_int4(pack_int4(q),
    q.numel())`` round-trips any length. The bias is added in int8, as
    JAX adds it."""
    flat = q.reshape(-1).to(torch.int8)
    if flat.numel() % 2:
        flat = F.pad(flat, (0, 1))
    lo = (flat[0::2] + _INT4_BIAS).to(torch.uint8)
    hi = (flat[1::2] + _INT4_BIAS).to(torch.uint8)
    return lo | (hi << 4)


def unpack_int4(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Invert ``pack_int4``: uint8 ``[ceil(n/2)]`` -> int8 ``[n]`` in [-7, 7]."""
    lo = (packed & 0xF).to(torch.int8) - _INT4_BIAS
    hi = ((packed >> 4) & 0xF).to(torch.int8) - _INT4_BIAS
    return torch.stack([lo, hi], dim=1).reshape(-1)[:n]


def quantize_lattice(x: torch.Tensor, peak, axis_name=None, block_size: int = 0,
                     hi_peak: int = _INT8_PEAK, out_dtype: torch.dtype = torch.int8):
    """Symmetric quantization onto a lattice of peak ``peak`` (0, 7, 127
    or ``hi_peak``): quantize.py:267, the adaptive-precision
    generalization of ``quantize_int8`` (the same block geometry and
    shared scales). Peak 0 gives ``q == 0`` and ``scale == 0``: the skip
    tag's bucket contributes nothing. Returns ``(q, scale)``, q in
    ``out_dtype`` (the wire's payload dtype).

    ``peak`` is a 0-d f32 tensor on ``x``'s device (a tag's peak, chosen on
    the device) or a Python number (a constant), and the two divide
    differently, as JAX does under jit:

    - ``inv = where(absmax > 0, peak / max(absmax, 1e-30), 0)``: a
      quotient either way (a tensor by a tensor here);
    - ``scale = where(peak > 0, absmax / max(peak, 1), 0)``: a quotient
      for a tensor peak; for a constant XLA folds ``max(peak, 1)`` and
      multiplies by its f32 reciprocal, as it does for ``/ 127`` in
      ``quantize_int8``. So at a tensor peak of 127 the payload equals
      ``quantize_int8``'s bit for bit and the scale may differ from
      ``absmax * (1/127)`` in its last bit (as in the JAX package).

    Plain PyTorch on either device: the JAX function takes no Pallas
    kernel. The traced clip at ``±peak`` bounds the values; the static
    one at ``±hi_peak`` is JAX's, kept for the same result."""
    x = x.float()
    xb, absmax = _shared_absmax(x, axis_name, block_size)
    if isinstance(peak, torch.Tensor):
        peak_f = peak.to(device=x.device, dtype=torch.float32).reshape(())
        scale = torch.where(peak_f > 0, absmax / torch.clamp_min(peak_f, 1.0),
                            torch.zeros((), device=x.device))
    else:
        peak_f = torch.full((), float(peak), dtype=torch.float32, device=x.device)
        scale = (absmax * float(np.float32(1.0) / np.float32(max(float(peak), 1.0)))
                 if peak > 0 else torch.zeros_like(absmax))
    inv = torch.where(absmax > 0, peak_f / torch.clamp_min(absmax, 1e-30),
                      torch.zeros((), device=x.device))
    q = torch.round(xb * inv)
    q = torch.minimum(torch.maximum(q, -peak_f), peak_f)
    q = torch.clamp(q, -float(hi_peak), float(hi_peak)).to(out_dtype)
    return q, scale


def quantize_int4(x: torch.Tensor, axis_name=None, block_size: int = 0):
    """Symmetric 4-bit quantization: ``quantize_lattice`` at the constant
    peak 7, int8 storage in [-7, 7] (``pack_int4`` ships two a byte)."""
    return quantize_lattice(x, float(_INT4_PEAK), axis_name=axis_name,
                            block_size=block_size, hi_peak=_INT4_PEAK, out_dtype=torch.int8)


def quantization_error(x: torch.Tensor, block_size: int = 0) -> torch.Tensor:
    """Max abs round-trip error of ``quantize_int8`` (quantize.py:459): a
    0-d tensor. XLA fuses ``q * scale - x`` into one multiply-add under
    jit; the product is exact in f64, so the difference is taken there
    and rounded once to f32."""
    x = x.float()
    q, s = quantize_int8(x, block_size=block_size)
    if block_size:
        n = x.numel()
        err = (q.double() * s.double()).reshape(-1)[:n].reshape(x.shape) - x.double()
    else:
        err = q.double() * s.double() - x.double()
    return err.float().abs().max()


# ------------------------------------------- homomorphic (compressed-domain)


def accum_capacity(dtype_name: str, peak: int = _INT8_PEAK) -> int:
    """Largest number of full-scale (``|q| = peak``) lattice payloads whose
    sum provably fits ``dtype_name``: ``floor(dtype_max / peak)``."""
    bits = {"int16": 15, "int32": 31}[dtype_name]
    return (2 ** bits - 1) // int(peak)


# the int8 lattice's capacities: int16 holds 258 workers (258 * 127 =
# 32766), int32 holds 16_909_320
ACCUM_CAPACITY = {
    "int16": accum_capacity("int16"),
    "int32": accum_capacity("int32"),
}


def accum_dtype(num_summands: int, peak: int = _INT8_PEAK) -> torch.dtype:
    """Smallest integer dtype that holds a sum of ``num_summands``
    payloads of ``|q| <= peak`` exactly: the wire dtype of a homomorphic
    psum (int16 through 258 workers on the int8 lattice). Past int32's
    capacity no accumulator is exact, and this raises."""
    if num_summands < 1:
        raise ValueError(f"accum_dtype needs >= 1 summand, got {num_summands}")
    if peak < 1:
        raise ValueError(f"accum_dtype needs peak >= 1, got {peak}")
    if num_summands <= accum_capacity("int16", peak):
        return torch.int16
    if num_summands <= accum_capacity("int32", peak):
        return torch.int32
    raise ValueError(
        f"homomorphic accumulation over {num_summands} full-scale "
        f"peak-{peak} payloads can overflow int32 (capacity "
        f"{accum_capacity('int32', peak)}) — use wire_domain='dequant'"
    )


def _divisor(divisor, device) -> torch.Tensor:
    """The rescale divisor as a 0-d f32 tensor on ``device``: a Python
    number becomes one through a fill (no host sync); a tensor must
    already be a one-element f32 on that device (the adaptive count)."""
    if isinstance(divisor, torch.Tensor):
        if divisor.numel() != 1 or divisor.dtype != torch.float32:
            raise TypeError(f"divisor must be a one-element f32 tensor, got "
                            f"{divisor.dtype} {tuple(divisor.shape)}")
        if divisor.device != torch.device(device):
            raise TypeError(f"divisor lies on {divisor.device}, the payload on {device}")
        return divisor.reshape(())
    return torch.full((), float(divisor), dtype=torch.float32, device=device)


def homomorphic_rescale(acc: torch.Tensor, divisor) -> torch.Tensor:
    """``clip(round_half_even(acc / divisor), -127, 127)`` to int8: an
    exact integer accumulation of at most ``divisor`` shared-lattice int8
    payloads, rounded back onto the lattice. The quotient is an IEEE f32
    division, tensor by tensor (``divisor`` a Python number or a 0-d f32
    tensor)."""
    q = torch.round(acc.float() / _divisor(divisor, acc.device))
    return torch.clamp(q, -_INT8_PEAK, _INT8_PEAK).to(torch.int8)


def accumulate_rescale_plain(recv: torch.Tensor, divisor) -> torch.Tensor:
    """Plain PyTorch version of K3: int8 ``[n, s]`` -> int8 ``[s]``, the
    exact int32 column sum then ``homomorphic_rescale``."""
    return homomorphic_rescale(recv.to(torch.int32).sum(0, dtype=torch.int32), divisor)


@kernel_entry("K3", numerics="accum_rescale")
def accumulate_rescale_int8(recv: torch.Tensor, divisor) -> torch.Tensor:
    """K3: exact integer accumulation over the worker rows of an int8
    payload ``[n, s]`` fused with the lattice rescale -> int8 ``[s]``.

    Replaces ps_pytorch_tpu/ops/quantize.py:_accum_rescale_kernel
    (Pallas, quantize.py:409, launched at :424). ``divisor`` is a Python
    number or a 0-d f32 tensor on the card; the kernel reads it from
    device memory, as the TPU read it from SMEM, so a changing divisor
    costs no host sync and no rebuild. Any ``n >= 1`` and any ``s``: no
    lane or block condition (the Pallas wrapper needed ``s % 128 == 0``);
    every row is read in aligned 16-byte words at any pitch and base
    address (csrc/accum_rescale.cu). The output is a fresh allocation,
    which the kernel stores in 16-byte words.
    Bound on the H100: bytes (``n*s`` int8 read once, ``s`` written). A
    CPU tensor runs ``accumulate_rescale_plain``; a CUDA tensor launches
    the kernel or raises."""
    if recv.dim() != 2 or recv.dtype != torch.int8:
        raise ValueError(f"accumulate_rescale_int8 takes int8 [n, s], got "
                         f"{recv.dtype} {tuple(recv.shape)}")
    if recv.shape[0] < 1:
        raise ValueError("accumulate_rescale_int8 needs at least one row")
    if not recv.is_cuda:
        return accumulate_rescale_plain(recv, divisor)
    from . import _build

    div = _divisor(divisor, recv.device)
    recv = recv.contiguous()
    n, s = recv.shape
    out = torch.empty((s,), dtype=torch.int8, device=recv.device)
    if s == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(recv.device):
        code = lib.ps_accumulate_rescale(recv.data_ptr(), n, s, div.data_ptr(),
                                         out.data_ptr(), _build.stream_of(recv))
    accumulate_rescale_int8.launches += 1
    _build.check(code, "accumulate_rescale_int8")
    return out


accumulate_rescale_int8.launches = 0
