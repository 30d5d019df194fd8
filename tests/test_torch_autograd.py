"""The port's autograd (torch's, under Paddle's API) against the JAX
package's tape: ``backward`` with ``retain_graph``, ``paddle.grad`` with
``create_graph`` (double backward) and ``allow_unused``, hooks,
``PyLayer``, ``no_grad``, ``saved_tensors_hooks`` and ``stop_gradient`` on
leaves and non-leaves (the cases of ``tests/test_autograd.py``).

The same seeded numpy inputs go through both packages on the CPU;
gradients agree to 1e-6 relative unless stated.
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice
from test_torch_threads import one_intra_op_thread  # noqa: F401

RTOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    prev = (getattr(tdevice._state, "device", None),
            getattr(tdevice._state, "place", None))
    tp.set_device("cpu")
    yield
    tdevice._state.device, tdevice._state.place = prev


def _both(fn):
    """``fn(package)`` -> list of numpy arrays, on both packages; equal."""
    a, b = fn(jp), fn(tp)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y, x, rtol=RTOL, atol=1e-7)
    return b


def _leaf(p, vals):
    return p.to_tensor(np.asarray(vals, np.float32), stop_gradient=False)


@pytest.mark.parametrize("case", [
    "simple_chain", "two_uses_accumulate", "broadcast", "matmul",
    "stop_gradient_blocks", "retain_graph", "non_scalar_ones",
    "explicit_grad_tensor", "multi_output_split", "inplace_add_tracks",
    "accumulate_two_backwards"])
def test_backward_like_jax(case):
    rng = np.random.RandomState(0)
    a_np = rng.rand(3, 4).astype(np.float32)
    b_np = rng.rand(4, 2).astype(np.float32)

    def run(p):
        if case == "simple_chain":
            x = _leaf(p, [1.0, 2.0, 3.0])
            (x * x).sum().backward()
            return [x.grad.numpy()]
        if case == "two_uses_accumulate":
            x = _leaf(p, [2.0])
            (x * x + x * 3).backward()
            return [x.grad.numpy()]
        if case == "broadcast":
            x = _leaf(p, np.ones((3, 4)))
            b = _leaf(p, np.ones(4))
            ((x + b) ** 2).sum().backward()
            return [x.grad.numpy(), b.grad.numpy()]
        if case == "matmul":
            a, b = _leaf(p, a_np), _leaf(p, b_np)
            p.matmul(a, b).sum().backward()
            return [a.grad.numpy(), b.grad.numpy()]
        if case == "stop_gradient_blocks":
            x = _leaf(p, [1.0])
            y = x.detach() * 2
            assert y.stop_gradient
            (x * 2 + y).backward()
            return [x.grad.numpy()]
        if case == "retain_graph":
            x = _leaf(p, [1.0])
            y = x * 2
            y.backward(retain_graph=True)
            y.backward()
            return [x.grad.numpy()]
        if case == "non_scalar_ones":
            x = _leaf(p, [1.0, 2.0])
            (x * 3).backward()
            return [x.grad.numpy()]
        if case == "explicit_grad_tensor":
            x = _leaf(p, [1.0, 2.0])
            (x * 2).backward(p.to_tensor([1.0, 10.0]))
            return [x.grad.numpy()]
        if case == "multi_output_split":
            x = _leaf(p, np.arange(6))
            parts = p.split(x, 2)
            (parts[0].sum() * 2 + parts[1].sum()).backward()
            return [x.grad.numpy()]
        if case == "inplace_add_tracks":
            x = _leaf(p, [1.0])
            y = x * 2
            y.add_(p.to_tensor([5.0]))
            y.backward()
            return [x.grad.numpy()]
        x = _leaf(p, [1.0, 2.0])
        (x * 2).sum().backward()
        (x * x).sum().backward()
        return [x.grad.numpy()]

    _both(run)


def test_backward_twice_raises_without_retain():
    for p in (jp, tp):
        x = _leaf(p, [1.0])
        y = x * 2
        y.backward()
        with pytest.raises(RuntimeError):
            y.backward()


def test_no_grad_and_int_outputs():
    for p in (jp, tp):
        x = _leaf(p, [1.0])
        with p.no_grad():
            y = x * 2
        assert y.stop_gradient
        assert p.argmax(_leaf(p, [3.0, 1.0])).stop_gradient

        @p.no_grad()
        def f(t):
            return t * 3

        assert f(x).stop_gradient
        with p.set_grad_enabled(False):
            assert (x * 2).stop_gradient
        assert not (x * 2).stop_gradient
    assert tp.is_grad_enabled()


def test_clear_grad():
    for p in (jp, tp):
        x = _leaf(p, [1.0])
        (x * 2).backward()
        x.clear_grad()
        assert x.grad is None


@pytest.mark.parametrize("case", ["grad_api", "intermediate", "double",
                                  "double_sin", "allow_unused",
                                  "grad_outputs"])
def test_paddle_grad_like_jax(case):
    def run(p):
        if case == "grad_api":
            x = _leaf(p, [2.0])
            (gx,) = p.grad(x * x, x)
            assert x.grad is None
            return [gx.numpy()]
        if case == "intermediate":
            x = _leaf(p, [2.0])
            h = x * 3
            (gh,) = p.grad(h * h, h)
            return [gh.numpy()]
        if case == "double":
            x = _leaf(p, [3.0])
            (gx,) = p.grad(x * x * x, x, create_graph=True)
            (ggx,) = p.grad(gx, x)
            return [gx.numpy(), ggx.numpy()]
        if case == "double_sin":
            x = _leaf(p, [0.5])
            (g1,) = p.grad(p.sin(x), x, create_graph=True)
            (g2,) = p.grad(g1, x)
            return [g2.numpy()]
        if case == "allow_unused":
            x, z = _leaf(p, [1.0]), _leaf(p, [1.0])
            with pytest.raises(RuntimeError):
                p.grad(x * 2, z)
            (gz,) = p.grad(x * 2, [z], allow_unused=True)
            assert gz is None
            return []
        x = _leaf(p, [1.0, 2.0])
        (gx,) = p.grad([x * x], [x], grad_outputs=[p.to_tensor([3.0, 5.0])])
        return [gx.numpy()]

    _both(run)


def test_hooks_like_jax():
    def run(p):
        x = _leaf(p, [1.0])
        x.register_hook(lambda g: g * 10)
        (x * 2).backward()
        y = _leaf(p, [1.0])
        h = y * 2
        seen = []
        h.register_hook(lambda g: seen.append(g.numpy()) or g)
        (h * 3).backward()
        z = _leaf(p, [1.0])
        handle = z.register_hook(lambda g: g * 10)
        handle.remove()
        (z * 2).backward()
        assert len(seen) == 1
        return [x.grad.numpy(), seen[0], y.grad.numpy(), z.grad.numpy()]

    _both(run)


def _exp_layer(p):
    class Exp(p.PyLayer):
        @staticmethod
        def forward(ctx, x):
            y = p.exp(x)
            ctx.save_for_backward(y)
            return y

        @staticmethod
        def backward(ctx, dy):
            (y,) = ctx.saved_tensor
            return dy * y

    return Exp


def _muladd_layer(p):
    class MulAdd(p.PyLayer):
        @staticmethod
        def forward(ctx, a, b, scale):
            ctx.save_for_backward(a, b)
            return a * b * scale + a

        @staticmethod
        def backward(ctx, dy):
            a, b = ctx.saved_tensor
            return dy * (b * 2.0 + 1), dy * a * 2.0

    return MulAdd


def test_pylayer_like_jax():
    def run(p):
        x = _leaf(p, [1.0, -0.5])
        _exp_layer(p).apply(x).sum().backward()
        a, b = _leaf(p, [2.0]), _leaf(p, [3.0])
        out = _muladd_layer(p).apply(a, b, 2.0)
        out.backward()
        return [x.grad.numpy(), out.numpy(), a.grad.numpy(), b.grad.numpy()]

    _both(run)


def test_pylayer_saved_tensor_is_also_callable():
    """Paddle's ``ctx.saved_tensor()`` form beside the reference's tuple."""
    class Square(tp.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor()
            return dy * 2 * x

    x = _leaf(tp, [3.0])
    Square.apply(x).backward()
    np.testing.assert_allclose(x.grad.numpy(), [6.0])


def test_saved_tensors_hooks_see_tensors():
    """torch's saved-tensor hooks under Paddle's names: the pack hook gets
    a Tensor, the unpack hook's Tensor feeds the backward. The gradient is
    the JAX package's (whose hooks are a stub)."""
    packed = []

    def pack(t):
        packed.append(t)
        return t.numpy()

    def unpack(a):
        return tp.to_tensor(a)

    x = _leaf(tp, [1.5, -2.0])
    with tp.autograd.saved_tensors_hooks(pack, unpack):
        y = (x * x).sum()
    y.backward()
    assert packed and all(isinstance(t, tp.Tensor) for t in packed)
    xj = _leaf(jp, [1.5, -2.0])
    with jp.autograd.saved_tensors_hooks(pack, unpack):
        yj = (xj * xj).sum()
    yj.backward()
    np.testing.assert_allclose(x.grad.numpy(), xj.grad.numpy(), rtol=RTOL)


def test_stop_gradient_leaves_and_non_leaves():
    def run(p):
        w = p.to_tensor(np.array([1.0, 2.0], np.float32))
        assert w.stop_gradient
        w.stop_gradient = False
        h = w * 2
        assert not h.stop_gradient
        h.stop_gradient = True
        out = (h * w).sum()
        out.backward()
        return [w.grad.numpy()]

    _both(run)


def numeric_grad(fn, x_np, eps=1e-3):
    x_np = x_np.astype(np.float64)
    g = np.zeros_like(x_np)
    it = np.nditer(x_np, flags=["multi_index"])
    while not it.finished:
        idx = it.multi_index
        xp, xm = x_np.copy(), x_np.copy()
        xp[idx] += eps
        xm[idx] -= eps
        g[idx] = (fn(xp) - fn(xm)) / (2 * eps)
        it.iternext()
    return g


def _softmax_np(a):
    e = np.exp(a - a.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


@pytest.mark.parametrize("op,np_fn", [
    (lambda p, t: p.exp(t).sum(), lambda a: np.exp(a).sum()),
    (lambda p, t: p.tanh(t).sum(), lambda a: np.tanh(a).sum()),
    (lambda p, t: p.sqrt(t + 2).sum(), lambda a: np.sqrt(a + 2).sum()),
    (lambda p, t: (t ** 3).sum(), lambda a: (a ** 3).sum()),
    (lambda p, t: (p.nn.functional.softmax(t) * t).sum(axis=None),
     lambda a: (_softmax_np(a) * a).sum()),
    (lambda p, t: p.mean(t * t), lambda a: (a * a).mean()),
    (lambda p, t: p.concat([t, t * 2], axis=0).sum(),
     lambda a: np.concatenate([a, a * 2]).sum()),
    (lambda p, t: (t.reshape([6]).cumsum() * t.reshape([6])).sum(),
     lambda a: (a.reshape(6).cumsum() * a.reshape(6)).sum()),
], ids=["exp", "tanh", "sqrt", "cube", "softmax", "mean", "concat",
        "cumsum"])
def test_grad_matches_numeric_and_jax(op, np_fn):
    x_np = np.random.RandomState(3).rand(2, 3).astype(np.float32) + 0.1

    def run(p):
        x = p.to_tensor(x_np, stop_gradient=False)
        op(p, x).backward()
        return [x.grad.numpy()]

    (g,) = _both(run)
    np.testing.assert_allclose(g, numeric_grad(np_fn, x_np), rtol=2e-2,
                               atol=2e-3)
