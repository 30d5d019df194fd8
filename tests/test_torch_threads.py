"""One intra-op thread for a port test module.

The tier-1 run puts six pytest-xdist workers on the host's cores, and
torch's default of one intra-op thread a core makes each worker's small
CPU ops wait on the others' (the same step ran 60 times slower inside the
suite than alone). A port test module that imports the fixture runs its
tests with one intra-op thread and puts the count back after::

    from test_torch_threads import one_intra_op_thread  # noqa: F401

Run pytest from the repo root, so that ``tests/`` is on the path.
``tests/test_torch_vision.py`` does not take it: its ResNet-50 parity
depends on the order of the convolutions' sums, which the thread count
changes.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_a_module_that_takes_it_runs_on_one_thread():
    assert torch.get_num_threads() == 1
