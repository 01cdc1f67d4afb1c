"""The ``one_thread`` fixture: torch on one intra-op thread for a test module.

Under xdist each of the tier-1 command's workers runs torch CPU code beside
five others; with torch's default thread pool they wait on busy cores (a
2-step tiny epoch took minutes, a JAX-parity file 3-4× its one-thread time).
A test module takes it with ``from helpers.threads import one_thread  # noqa: F401``.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
