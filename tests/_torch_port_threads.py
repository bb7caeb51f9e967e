"""The port's CPU test files share this fixture: imported into a test
module, it pins torch to one intra-op thread for that module."""

from __future__ import annotations

import pytest


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tiny models' ops are too small for the
    thread pool, and each file shares the machine's cores with the other
    test workers."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
