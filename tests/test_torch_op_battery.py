"""The op battery of ``tests/test_op_battery.py`` on the port's surface,
held against the JAX package (first half of the cases; the second half is
``tests/test_torch_op_battery_b.py``).

Each case's ``ours(paddle, *xs)`` takes the package as an argument, so the
same lambda runs on both. The inputs are the battery's, from the same
per-case seed.

- float32: the port's forward and each gradient are held to the case's
  torch oracle at the battery's tolerance (``atol`` forward,
  ``max(atol, 1e-4)`` gradients) and to the JAX package at twice that,
  since both packages sit within it of the same oracle;
- bfloat16 and int32: the port against the oracle at the battery's
  tolerances (5e-2 for bf16, exact for int32).

``DEFERRED`` names every case whose op lives in a module this port does
not have yet, with its ``ROADMAP.md`` item (none since the domain
libraries landed); the coverage test asserts that each of them is still
missing from the port (it raises ``AttributeError``) and that every other
case of the half ran, forward and gradient.
"""
import zlib

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice
from test_op_battery import CASES
from test_torch_threads import one_intra_op_thread  # noqa: F401

DEFERRED = {}

RUN = [c for c in CASES if c.name not in DEFERRED]
# the halves split where they did while the conv and pooling cases were
# deferred, so that no case moves from one file to the other
HALF = [c.name for c in RUN].index("as_strided")
MINE = RUN[:HALF]


@pytest.fixture(autouse=True)
def _cpu():
    prev = (getattr(tdevice._state, "device", None),
            getattr(tdevice._state, "place", None))
    tp.set_device("cpu")
    yield
    tdevice._state.device, tdevice._state.place = prev


def _inputs(c):
    return c.make(np.random.RandomState(zlib.crc32(c.name.encode())
                                        % (2 ** 31)))


def _to_paddle(p, a, dtype):
    t = p.to_tensor(a)
    if dtype == "bfloat16" and a.dtype == np.float32:
        t = t.astype("bfloat16")
    elif dtype == "int32" and a.dtype == np.float32:
        t = (t * 4).astype("int32")
    return t


def _to_torch(a, dtype):
    t = torch.tensor(np.asarray(a))
    if dtype == "int32" and a.dtype == np.float32:
        t = (t * 4).int()
    return t


def _f64(t):
    return np.asarray(t.numpy()).astype(np.float64)


def _grad_inputs(c, raw):
    return c.grad_inputs or tuple(
        i for i, a in enumerate(raw)
        if getattr(a, "dtype", None) == np.float32)


def _forward_and_grads(p, c, raw, which):
    xs = [_to_paddle(p, a, "float32") for a in raw]
    for i in which:
        xs[i].stop_gradient = False
    out = c.ours(p, *xs)
    fwd = _f64(out)
    if not which:
        return fwd, []
    out.sum().backward()
    return fwd, [_f64(xs[i].grad) for i in which]


def run_case(c, results):
    raw = _inputs(c)
    which = _grad_inputs(c, raw) if c.grad else ()
    theirs_in = [_to_torch(a, "float32") for a in raw]
    for i in which:
        theirs_in[i].requires_grad_(True)
    tout = c.theirs(*theirs_in)
    want = tout.detach().numpy().astype(np.float64)
    if which:
        tout.sum().backward()
    want_g = [theirs_in[i].grad.numpy().astype(np.float64) for i in which]

    got, got_g = _forward_and_grads(tp, c, raw, which)
    ref, ref_g = _forward_and_grads(jp, c, raw, which)
    tol = c.atol
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol,
                               err_msg=f"{c.name} f32 fwd vs torch")
    np.testing.assert_allclose(got, ref, atol=2 * tol, rtol=2 * tol,
                               err_msg=f"{c.name} f32 fwd vs jax")
    results["fwd"].add(c.name)
    gtol = max(c.atol, 1e-4)
    for i, g, w, r in zip(which, got_g, want_g, ref_g):
        np.testing.assert_allclose(g, w, atol=gtol, rtol=gtol,
                                   err_msg=f"{c.name} grad[{i}] vs torch")
        np.testing.assert_allclose(g, r, atol=2 * gtol, rtol=2 * gtol,
                                   err_msg=f"{c.name} grad[{i}] vs jax")
    if which:
        results["grad"].add(c.name)

    if "bfloat16" in c.dtypes:
        out = c.ours(tp, *[_to_paddle(tp, a, "bfloat16") for a in raw])
        np.testing.assert_allclose(_f64(out), want, atol=5e-2, rtol=5e-2,
                                   err_msg=f"{c.name} bf16 fwd")
        results["bf16"].add(c.name)
    if c.int_ok:
        got_i = np.asarray(c.ours(tp, *[_to_paddle(tp, a, "int32")
                                        for a in raw]).numpy())
        want_i = c.theirs(*[_to_torch(a, "int32") for a in raw]).numpy()
        np.testing.assert_array_equal(got_i.astype(np.int64),
                                      want_i.astype(np.int64),
                                      err_msg=f"{c.name} int32 fwd")
        results["int"].add(c.name)


def check_coverage(cases, results, deferred=()):
    """Every case of ``cases`` ran forward, and with its gradients where it
    has any; each ``deferred`` case is still missing from the port."""
    names = {c.name for c in cases}
    assert results["fwd"] == names, sorted(names - results["fwd"])
    want_grad = {c.name for c in cases if c.grad}
    assert results["grad"] == want_grad, sorted(want_grad - results["grad"])
    for c in deferred:
        raw = _inputs(c)
        with pytest.raises(AttributeError):
            c.ours(tp, *[_to_paddle(tp, a, "float32") for a in raw])


_RESULTS = {"fwd": set(), "grad": set(), "bf16": set(), "int": set()}


@pytest.mark.parametrize("c", MINE, ids=[c.name for c in MINE])
def test_op(c):
    run_case(c, _RESULTS)


def test_zz_coverage():
    assert set(DEFERRED) <= {c.name for c in CASES}
    assert all(item.split(":")[0] == "A.13 (e)" for item in DEFERRED.values())
    check_coverage(MINE, _RESULTS,
                   [c for c in CASES if c.name in DEFERRED])
