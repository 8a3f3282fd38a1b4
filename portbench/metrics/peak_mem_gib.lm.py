"""The allocator's peak over the window (``torch.cuda.max_memory_allocated``
after a reset at the window's start), GiB."""


def read(facts):
    return facts["peak_window_bytes"] / 2 ** 30 if facts["peak_window_bytes"] else None
