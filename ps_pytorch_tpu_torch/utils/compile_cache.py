"""The kernel library built once, before the work that needs it (the
port's counterpart of utils/compile_cache.py).

The JAX package points XLA's persistent compilation cache at a directory
(``JAX_COMPILATION_CACHE_DIR``), so a re-run of a sweep compiles no
step. Eager PyTorch compiles no step, so that variable has no
counterpart here. What a run does compile is the hand-written kernel
library (``ops/_build.py``: nvcc over ``csrc/*.cu``, kept under
``ops/_build/<source hash>/``, so a later process with the same sources
builds nothing): ``enable_persistent_compile_cache`` builds and loads it
before the first candidate of a search or the first run of a sweep on
the card, so no candidate's time pays for nvcc. On the CPU it does
nothing: the plain versions need no build.
"""

from __future__ import annotations


def enable_persistent_compile_cache(device=None) -> None:
    """Build (or find) and load the kernel library when ``device`` is a
    card (``None`` means the card, as every entry point)."""
    from .. import resolve_device

    if resolve_device(device).type != "cuda":
        return
    from ..ops import _build

    _build.load()
