"""One intra-op thread for the port's tests.

The suite runs as six pytest-xdist workers on one machine; a torch
process by default starts an OpenMP team as wide as the machine, so six
of them share the cores six times over, and the teams' busy waits then
cost tens of times the work (a bfloat16 CLI case: 8 s alone, 80 s beside
five busy processes, 8 s again with one thread).  The port's tests run
small tensors, for which one thread is as fast alone.  A test module
imports :func:`one_torch_thread` (after ``pytest.importorskip("torch")``)
to run its tests with one intra-op thread; the count is put back after
the module.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
