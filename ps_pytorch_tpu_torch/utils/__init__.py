from .compile_cache import enable_persistent_compile_cache
from .logging import (
    ITER_LOG_RE,
    PhaseTimer,
    format_eval_line,
    format_iter_line,
    get_logger,
    parse_iter_line,
)
from .sync import host_sync

__all__ = ["ITER_LOG_RE", "PhaseTimer", "enable_persistent_compile_cache", "format_eval_line",
           "format_iter_line", "get_logger", "host_sync", "parse_iter_line"]
