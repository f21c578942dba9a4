"""One intra-op thread for the port's CPU tests.

The Tier-1 run starts six pytest workers on one machine, and each
worker's torch would otherwise size its intra-op pool to the whole
machine: six such pools on eight cores spend most of their time waiting
on one another (test_torch_session_tpch.py took 15 s alone and 341 s in
a six-worker run; six copies of it at once took 724 s each with the
default pool and 23 s with one thread). Each port test module imports
`one_torch_thread`, an autouse fixture that holds torch to one thread
while the module runs and gives the pool back after it. Integer results
do not depend on the thread count; float ones are compared within the
tolerances the tests state."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
