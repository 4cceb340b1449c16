"""One intra-op thread for a port test module on the CPU.

The port's CPU tests run small models (a few layers, narrow widths), whose
ops are too small to gain from PyTorch's intra-op threads. Under the
suite's several xdist workers those threads oversubscribe the host's
cores: a reduced deepseek-v2-lite ZeRO step that takes 0.4 s on one thread
took over 20 s with a thread a core in every worker. A test module takes
the fixture by importing it (an autouse fixture runs for every test of the
module that imports it); the previous count is restored when the module's
tests end.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
