"""The second half of the op battery on the port's surface, held against
the JAX package as ``tests/test_torch_op_battery.py`` holds the first (see
its docstring for the tolerances and ``DEFERRED``)."""
import pytest

import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice
from test_torch_op_battery import HALF, RUN, check_coverage, run_case
from test_torch_threads import one_intra_op_thread  # noqa: F401

MINE = RUN[HALF:]


@pytest.fixture(autouse=True)
def _cpu():
    prev = (getattr(tdevice._state, "device", None),
            getattr(tdevice._state, "place", None))
    tp.set_device("cpu")
    yield
    tdevice._state.device, tdevice._state.place = prev


_RESULTS = {"fwd": set(), "grad": set(), "bf16": set(), "int": set()}


@pytest.mark.parametrize("c", MINE, ids=[c.name for c in MINE])
def test_op(c):
    run_case(c, _RESULTS)


def test_zz_coverage():
    check_coverage(MINE, _RESULTS)
