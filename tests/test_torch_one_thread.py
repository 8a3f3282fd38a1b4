"""The port's test modules on one CPU thread.

``_one_thread`` is a module fixture: a heavy port test file opts in with
``from tests.test_torch_one_thread import _one_thread  # noqa: F401``.
The port's steps are many small ops, and beside the other test processes
each op on a full thread pool waits on every core
(tests/test_torch_flash_backward.py measured it). The bit-for-bit
comparisons run both of their sides at this count.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_torch_one_thread_holds_the_module_on_one_thread():
    assert torch.get_num_threads() == 1
