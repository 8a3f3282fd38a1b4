from .logging import get_logger
from .sync import host_sync

__all__ = ["get_logger", "host_sync"]
