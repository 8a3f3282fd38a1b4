"""Models of the port (serving slice: the dense transformer LM)."""

from .convert import params_from_jax, params_to_numpy
from .decode import generate, init_kv_cache, prefill
from .transformer import (
    TransformerConfig,
    TransformerLM,
    apply_transformer,
    init_transformer,
)

__all__ = [
    "TransformerConfig",
    "TransformerLM",
    "apply_transformer",
    "generate",
    "init_kv_cache",
    "init_transformer",
    "params_from_jax",
    "params_to_numpy",
    "prefill",
]
