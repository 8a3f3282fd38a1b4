"""The port's kernel wrappers, each beside its plain PyTorch version."""

from .flash_attention import flash_attention, flash_fwd, flash_fwd_plain
from .quantize import (
    accum_dtype,
    accumulate_rescale_int8,
    accumulate_rescale_plain,
    dequantize_int8,
    quantize_int8,
    quantize_rows,
    quantize_rows_plain,
    quantize_rows_scaled,
    quantize_rows_scaled_plain,
    quantize_tensor,
    quantize_tensor_plain,
)

__all__ = [
    "accum_dtype",
    "accumulate_rescale_int8",
    "accumulate_rescale_plain",
    "dequantize_int8",
    "flash_attention",
    "flash_fwd",
    "flash_fwd_plain",
    "quantize_int8",
    "quantize_rows",
    "quantize_rows_plain",
    "quantize_rows_scaled",
    "quantize_rows_scaled_plain",
    "quantize_tensor",
    "quantize_tensor_plain",
]
