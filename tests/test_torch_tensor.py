"""The port's Paddle ``Tensor`` against the JAX package's: creation,
metadata, host interop, indexing and in-place ops (the cases of
``tests/test_tensor_basics.py``), plus what the port's design adds: an
in-place op rebinds and never writes through a view, ``stop_gradient`` on
integer data, ``numpy()`` of bfloat16, and a ``Parameter`` that keeps its
``torch.nn.Parameter``.

Both packages run on the CPU; values compare exactly unless a tolerance is
stated.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice
from test_torch_threads import one_intra_op_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _cpu():
    prev = (getattr(tdevice._state, "device", None),
            getattr(tdevice._state, "place", None))
    tp.set_device("cpu")
    yield
    tdevice._state.device, tdevice._state.place = prev


def _same(fn, atol=0.0):
    """``fn(package)`` on both packages: equal values, shape and dtype."""
    a, b = fn(jp), fn(tp)
    assert a.shape == b.shape
    assert a.dtype.name == b.dtype.name, (a.dtype, b.dtype)
    np.testing.assert_allclose(np.asarray(b.numpy(), np.float64),
                               np.asarray(a.numpy(), np.float64), atol=atol)


@pytest.mark.parametrize("make", [
    lambda p: p.to_tensor([[1.0, 2.0], [3.0, 4.0]]),
    lambda p: p.to_tensor([1, 2, 3]),
    lambda p: p.to_tensor([1, 2], dtype="float16"),
    lambda p: p.to_tensor(3.5),
    lambda p: p.to_tensor(np.arange(6, dtype=np.int32).reshape(2, 3)),
    lambda p: p.zeros([2, 3]),
    lambda p: p.ones([2, 3], dtype="int32"),
    lambda p: p.full([2, 2], 7, dtype="int32"),
    lambda p: p.full([2, 2], 7),
    lambda p: p.full([2, 2], 2.5),
    lambda p: p.arange(5),
    lambda p: p.arange(0.0, 1.0, 0.25),
    lambda p: p.linspace(0, 1, 5),
    lambda p: p.eye(3),
    lambda p: p.zeros_like(p.ones([2, 3])),
    lambda p: p.full_like(p.ones([2, 3]), 5),
    lambda p: p.ones([2]).astype("int64"),
    lambda p: p.tril_indices(4, 4, 0),
], ids=["list_f", "list_i", "f16", "scalar", "np_i32", "zeros", "ones_i32",
        "full_i32", "full_int", "full_float", "arange", "arange_f",
        "linspace", "eye", "zeros_like", "full_like", "astype",
        "tril_indices"])
def test_creation_like_jax(make):
    _same(make, atol=1e-7)


def test_metadata():
    for p in (jp, tp):
        t = p.ones([2, 3, 4])
        assert t.shape == [2, 3, 4]
        assert t.ndim == 3 and t.size == 24 and t.numel() == 24
        assert t.stop_gradient is True
        assert p.float32 == "float32" and p.float32 == np.float32
        assert p.float32 != "int32"
        assert t.dtype == p.float32
        assert "Tensor" in repr(t)
        s = p.to_tensor(3.5)
        assert s.item() == pytest.approx(3.5) and float(s) == 3.5
    assert tp.ones([1]).place == tp.CPUPlace()
    assert tp.float32 == torch.float32


def test_indexing_like_jax():
    _same(lambda p: p.arange(12).reshape([3, 4])[1])
    _same(lambda p: p.arange(12).reshape([3, 4])[:, 1])
    _same(lambda p: p.arange(12).reshape([3, 4])[1:, 2:])
    _same(lambda p: p.arange(10)[p.to_tensor([1, 3, 5])])
    _same(lambda p: p.arange(6)[p.arange(6) > 3])
    _same(lambda p: p.arange(24).reshape([2, 3, 4])[..., 1])

    def setitem(p):
        x = p.zeros([3, 3])
        x[1] = 5.0
        x[0, 0] = p.to_tensor(2.0)
        return x

    _same(setitem)
    rows = [list(p.arange(6).reshape([2, 3])) for p in (jp, tp)]
    assert len(rows[1]) == 2
    np.testing.assert_array_equal(rows[1][1].numpy(), rows[0][1].numpy())


def test_inplace_like_jax():
    def add_(p):
        x = p.ones([2])
        x.add_(p.ones([2]))
        return x

    def fill_zero(p):
        x = p.ones([2, 2])
        x.fill_(3.0)
        y = p.ones([2, 2])
        y.zero_()
        return x + y

    def set_value(p):
        x = p.ones([2, 2])
        x.set_value(np.full((2, 2), 9, np.float32))
        return x

    for fn in (add_, fill_zero, set_value):
        _same(fn)


def test_inplace_op_does_not_write_through_a_view():
    """``y = x.reshape(...)`` then ``x.add_(1)``: ``y`` is unchanged, as in
    the reference, though torch's reshape is a view of x's storage."""
    for p in (jp, tp):
        x = p.to_tensor(np.arange(6, dtype=np.float32))
        y = x.reshape([2, 3])
        t = x.T
        x.add_(p.ones([6]))
        np.testing.assert_array_equal(y.numpy(), np.arange(6).reshape(2, 3))
        np.testing.assert_array_equal(t.numpy(), np.arange(6))
        np.testing.assert_array_equal(x.numpy(), np.arange(6) + 1)


def test_setitem_does_not_write_through_a_slice():
    for p in (jp, tp):
        x = p.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
        row = x[0]
        x[0] = 9.0
        np.testing.assert_array_equal(row.numpy(), [0, 1, 2])
        np.testing.assert_array_equal(x.numpy()[0], [9, 9, 9])


def test_inplace_keeps_autograd_of_saved_tensors():
    """A rebind leaves the tensors autograd saved alone: no version-counter
    error, and the gradient is the reference's."""
    grads = []
    for p in (jp, tp):
        w = p.to_tensor(np.array([1.0, 2.0], np.float32), stop_gradient=False)
        h = w * 3
        y = (h * h).sum()        # saves h for the backward
        h.add_(p.ones([2]))
        y.backward()
        grads.append(w.grad.numpy())
    np.testing.assert_array_equal(grads[1], grads[0])


def test_stop_gradient_on_integer_data_is_a_noop():
    """The reference lets an int tensor's ``stop_gradient`` be set False and
    never differentiates it; torch cannot ``requires_grad_`` an int tensor,
    so the port keeps it a no-op."""
    t = tp.to_tensor([1, 2, 3])
    t.stop_gradient = False
    assert t.stop_gradient is True
    f = tp.to_tensor([1.0, 2.0])
    f.stop_gradient = False
    assert f.stop_gradient is False and f._data.requires_grad


def test_stop_gradient_true_on_a_non_leaf_detaches():
    x = tp.to_tensor([1.0, 2.0], stop_gradient=False)
    y = x * 2
    assert y.stop_gradient is False
    y.stop_gradient = True
    assert y.stop_gradient is True and y._data.grad_fn is None
    z = x * 3 + y
    z.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), [3.0, 3.0])


def test_numpy_of_bfloat16_is_an_exact_float32_upcast():
    vals = np.array([1.0, 1.0078125, -3.25, 65280.0], np.float32)
    t = tp.to_tensor(vals).astype("bfloat16")
    out = t.numpy()
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, vals)
    ref = jp.to_tensor(vals).astype("bfloat16").numpy()
    np.testing.assert_array_equal(out, ref.astype(np.float32))
    assert t[1].item() == 1.0078125


def test_parameter_keeps_its_torch_parameter():
    layer = tp.nn.Linear(3, 2)
    p = layer.weight
    held = p._data
    assert isinstance(held, torch.nn.Parameter) and held.requires_grad
    p.set_value(np.ones((3, 2), np.float32))
    p.copy_(tp.full([3, 2], 2.0))
    p.add_(tp.ones([3, 2]))
    p[0] = 7.0
    assert p._data is held
    np.testing.assert_array_equal(p.numpy()[1:], 3.0)
    np.testing.assert_array_equal(p.numpy()[0], 7.0)


def test_to_tensor_of_torch_and_tensor():
    src = torch.arange(4, dtype=torch.float32)
    t = tp.to_tensor(src)
    assert t.dtype == tp.float32 and t.place == tp.CPUPlace()
    u = tp.to_tensor(t, dtype="float64", stop_gradient=False)
    assert u.dtype == tp.float64 and not u.stop_gradient
    assert t.stop_gradient


def test_operators_like_jax():
    a = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    b = np.abs(np.random.RandomState(1).randn(3, 4)).astype(np.float32) + 1
    for fn in (lambda x, y: x + y, lambda x, y: 2.0 - x, lambda x, y: x * 3,
               lambda x, y: x / y, lambda x, y: 1.0 / y, lambda x, y: x ** 2,
               lambda x, y: 2.0 ** x, lambda x, y: -x, lambda x, y: abs(x),
               lambda x, y: x @ y.T, lambda x, y: (x > 0).astype("float32"),
               lambda x, y: x // y, lambda x, y: x % y):
        _same(lambda p: fn(p.to_tensor(a), p.to_tensor(b)), atol=1e-5)


def test_default_place_is_the_card():
    """With no place asked for, the first tensor resolves the card: where
    there is none, making a tensor raises (no quiet CPU fallback)."""
    tdevice._state.device = tdevice._state.place = None
    if torch.cuda.is_available():
        assert tp.ones([1]).place == tp.CUDAPlace(0)
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tp.ones([1])
