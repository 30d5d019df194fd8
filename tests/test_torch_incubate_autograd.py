"""The port's ``paddle.incubate.autograd`` against the JAX package on the
CPU: ``vjp``, ``jvp``, ``Jacobian``, ``Hessian`` and ``grad`` (re-exported
from the port's ``autograd``) on the same inputs within f32 rounding, the
prim flag, and ``forward_grad``'s errors, which are the reference's."""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu.incubate.autograd as jag
import paddle_tpu_torch as tp
import paddle_tpu_torch.incubate.autograd as tag
from paddle_tpu_torch import device as tdevice
from test_torch_threads import one_intra_op_thread  # noqa: F401

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    prev = (getattr(tdevice._state, "device", None),
            getattr(tdevice._state, "place", None))
    tp.set_device("cpu")
    yield
    tdevice._state.device, tdevice._state.place = prev


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np(t):
    return np.asarray(t.numpy())


def _f(x):
    return (x * x * x).sum() + (x * 2.0).sin().sum()


def _vec(x):
    return x * x * x + x.sin()


def test_the_transforms_are_the_autograd_ones():
    import paddle_tpu_torch.autograd.functional as taf

    assert tag.vjp is taf.vjp and tag.jvp is taf.jvp
    assert tag.Jacobian is taf.Jacobian and tag.Hessian is taf.Hessian
    assert tag.grad is tp.autograd.grad


def test_vjp_and_jvp_like_jax():
    x, v = _x(5), _x(5, seed=1)
    outs = []
    for p, ag in ((jp, jag), (tp, tag)):
        t = p.to_tensor(x)
        out, g = ag.vjp(_f, t)
        o2, tan = ag.jvp(_vec, t, p.to_tensor(v))
        outs.append([_np(a) for a in (out, g, o2, tan)])
    for a, b in zip(*outs):
        np.testing.assert_allclose(b, a, atol=TOL, rtol=TOL)


def test_jacobian_and_hessian_like_jax():
    x = _x(4, seed=2)
    for cls, fn in (("Jacobian", _vec), ("Hessian", _f)):
        want = _np(getattr(jag, cls)(fn, jp.to_tensor(x)))
        got = _np(getattr(tag, cls)(fn, tp.to_tensor(x)))
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_grad_like_jax():
    x = _x(6, seed=3)
    res = []
    for p, ag in ((jp, jag), (tp, tag)):
        t = p.to_tensor(x, stop_gradient=False)
        (g,) = ag.grad([_f(t)], [t])
        res.append(_np(g))
    np.testing.assert_allclose(res[1], res[0], atol=TOL, rtol=TOL)


def test_prim_flag_and_forward_grad_errors_like_jax():
    for ag in (jag, tag):
        ag.disable_prim()
        assert ag._PRIM["enabled"] is False
        ag.enable_prim()
        assert ag._PRIM["enabled"] is True
    for p, ag in ((jp, jag), (tp, tag)):
        t = p.to_tensor(_x(3))
        with pytest.raises(TypeError, match="computed outputs"):
            ag.forward_grad(_f, t)
        with pytest.raises(NotImplementedError, match="jvp"):
            ag.forward_grad(_f(t), t)
