"""The modules a run may not load: JAX, its libraries and the JAX package.

Names are compared by their whole top-level part (before the first
dot): ``ps_pytorch_tpu_torch`` is the port and passes, ``ps_pytorch_tpu``
is the JAX package and does not.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ps_pytorch_tpu")


def forbidden_loaded(names: Iterable[str] = None) -> List[str]:
    names = list(sys.modules) if names is None else list(names)
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})
