from .logging import format_eval_line, format_iter_line, get_logger, parse_iter_line
from .sync import host_sync

__all__ = ["format_eval_line", "format_iter_line", "get_logger", "host_sync",
           "parse_iter_line"]
