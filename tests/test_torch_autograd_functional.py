"""``paddle.autograd``'s functional transforms (``jvp``, ``vjp``,
``Jacobian``/``jacobian``, ``Hessian``/``hessian``) of the port, over
``torch.func``, against the JAX package's, over ``jax``'s, on the same
functions of the surface and the same inputs, f32 to 1e-5."""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice
from test_torch_threads import one_intra_op_thread  # noqa: F401

TOL = 1e-5
X = np.random.RandomState(0).randn(3, 4).astype(np.float32)
Y = np.random.RandomState(1).randn(4, 2).astype(np.float32)
V = np.random.RandomState(2).randn(3, 2).astype(np.float32)


@pytest.fixture(autouse=True)
def _cpu():
    prev = (getattr(tdevice._state, "device", None),
            getattr(tdevice._state, "place", None))
    tp.set_device("cpu")
    yield
    tdevice._state.device, tdevice._state.place = prev


def _f(p):
    return lambda x, y: p.tanh(p.matmul(x, y)) * 2.0


def _g(p):
    return lambda x: (p.sin(x) * x).sum()


def _np(t):
    return [_np(a) for a in t] if isinstance(t, (list, tuple)) else t.numpy()


def _both(fn):
    out = {}
    for p in (jp, tp):
        out[p] = fn(p)
    return out[jp], out[tp]


def _close(a, b):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
    else:
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)


def test_jvp_and_vjp_like_jax():
    def run(p):
        x, y, v = (p.to_tensor(a) for a in (X, Y, V))
        dx, dy = p.to_tensor(np.ones_like(X)), p.to_tensor(np.full_like(Y,
                                                                       0.5))
        j1 = p.autograd.jvp(_f(p), [x, y], [dx, dy])
        j2 = p.autograd.jvp(_g(p), x)
        v1 = p.autograd.vjp(_f(p), [x, y], v)
        v2 = p.autograd.vjp(_g(p), x)
        return [_np(j1), _np(j2), _np(v1), _np(v2)]

    want, got = _both(run)
    _close(want, got)
    assert isinstance(got[2][1], list) and len(got[2][1]) == 2


def test_jacobian_and_hessian_like_jax():
    def run(p):
        x, y = p.to_tensor(X), p.to_tensor(Y)
        jac = p.autograd.jacobian(_f(p), [x, y])
        single = p.autograd.Jacobian(lambda a: p.exp(a) * 3.0, x)
        hes = p.autograd.hessian(_g(p), x)
        # several inputs: one Jacobian each, by index (the reference's
        # numpy() of them raises)
        return [jac[0].numpy(), jac[1].numpy(), single.numpy(),
                single[1].numpy(), list(single.shape), hes.numpy(),
                hes[0].numpy()]

    want, got = _both(run)
    assert got[4] == want[4] == [3, 4, 3, 4]
    _close([want[i] for i in (0, 1, 2, 3, 5, 6)],
           [got[i] for i in (0, 1, 2, 3, 5, 6)])
    assert got[0].shape == (3, 2, 3, 4) and got[5].shape == (3, 4, 3, 4)
