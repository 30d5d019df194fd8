"""The port's conv and pooling functionals and layers, and its activation
and loss layers, against the JAX package on the CPU.

Each case runs ``fn(package, *inputs)`` in both packages on the same
seeded float32 numpy inputs and compares the output and the gradient of
``sum(out ** 2)`` with respect to every input (on the JAX side through
``jax.value_and_grad`` of the reference's functional, jitted): 1e-4 (absolute and
relative) through a conv, whose sums run in another order in each
library, 1e-5 through a pool. Layers run on weights carried across by
``convert.layer_state_from_numpy``, with the same ``state_dict`` names
and shapes; their forward is held everywhere and their parameters'
gradients for ``Conv2D`` and ``Conv2DTranspose`` (the functionals'
gradients are held on their own). The NHWC padding forms are held
forward, their NCHW twins with gradients. The JAX side's op-by-op
compiles are most of this file's time, which sets the number of cases. The inputs are continuous random
values, so no pooling window holds a tie (XLA and torch may route a tied
window's gradient to different cells). The activation and loss layers
are held forward only: the op battery holds their functionals'
gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as jp
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.jit import functional_call
import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.convert import layer_state_from_numpy

CONV_TOL = 1e-4
POOL_TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    prev = (getattr(tdevice._state, "device", None),
            getattr(tdevice._state, "place", None))
    tp.set_device("cpu")
    yield
    tdevice._state.device, tdevice._state.place = prev


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _run_port(fn, xs, grad):
    ins = [tp.to_tensor(x, stop_gradient=not grad) for x in xs]
    out = fn(tp, *ins)
    res = [np.asarray(out.numpy(), np.float64)]
    if grad:
        (out * out).sum().backward()
        res += [np.asarray(i.grad.numpy(), np.float64) for i in ins]
    return res


def _run_jax_eager(fn, xs, grad):
    ins = [jp.to_tensor(x, stop_gradient=not grad) for x in xs]
    out = fn(jp, *ins)
    res = [np.asarray(out.numpy(), np.float64)]
    if grad:
        (out * out).sum().backward()
        res += [np.asarray(i.grad.numpy(), np.float64) for i in ins]
    return res


def _run_jax(fn, xs, grad, eager=False):
    """The reference's functional on Tensors over the traced arrays, under
    one ``jax.jit(jax.value_and_grad(...))``: the derivative rules its
    eager tape applies op by op, in one compile (the tape compiles every
    op on its own, several times slower here). ``eager`` takes the tape:
    the reference's average pool reduces from a traced zero under jit,
    which reverse mode cannot differentiate."""
    if eager:
        return _run_jax_eager(fn, xs, grad)

    def f(*arrays):
        out = fn(jp, *[JTensor(a) for a in arrays])._data
        return jnp.sum(out * out), out

    arrays = [jnp.asarray(x) for x in xs]
    if not grad:
        return [np.asarray(jax.jit(f)(*arrays)[1], np.float64)]
    (_, out), grads = jax.jit(jax.value_and_grad(
        f, argnums=tuple(range(len(xs))), has_aux=True))(*arrays)
    return [np.asarray(a, np.float64) for a in (out,) + tuple(grads)]


def both(fn, xs, tol, grad=True, eager=False):
    """``fn`` in both packages: output and input gradients equal to
    ``tol``; returns the port's output."""
    want = _run_jax(fn, xs, grad, eager)
    got = _run_port(fn, xs, grad)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol, err_msg=str(i))
    return got[0]


# -- convs -----------------------------------------------------------------------
PADDINGS = {
    "int": 1,
    "list": [1, 2],
    "2n": [0, 1, 1, 2],
    "full_rank": "full_rank",
    "SAME": "SAME",
    "VALID": "VALID",
}


def _full_rank(fmt):
    if fmt == "NCHW":
        return [[0, 0], [0, 0], [1, 2], [0, 1]]
    return [[0, 0], [1, 2], [0, 1], [0, 0]]


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("form", list(PADDINGS))
def test_conv2d_padding_forms_at_stride_2(form, fmt):
    pad = _full_rank(fmt) if form == "full_rank" else PADDINGS[form]
    x = _x(2, 3, 9, 8, seed=1)
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    w, b = _x(4, 3, 3, 3, seed=2), _x(4, seed=3)

    def padding_of(p):
        # the reference reads a 2-d full-rank padding as a 2n list of pairs
        # (lax refuses it): it gets the same pads as a 2n list
        return [1, 2, 0, 1] if p is jp and form == "full_rank" else pad

    out = both(lambda p, a, k, c: p.nn.functional.conv2d(
        a, k, c, stride=2, padding=padding_of(p), data_format=fmt),
        [x, w, b], CONV_TOL, grad=fmt == "NCHW")
    assert out.shape[-1 if fmt == "NHWC" else 1] == 4


@pytest.mark.parametrize("case", [
    dict(groups=2, dilation=2, padding=2),
    dict(groups=3, stride=[2, 1], padding="SAME", dilation=[1, 2]),
    dict(groups=1, stride=3, padding=[2, 0, 1, 1]),
])
def test_conv2d_groups_dilation(case):
    x = _x(2, 6, 11, 10, seed=4)
    w = _x(6, 6 // case["groups"], 3, 3, seed=5)
    both(lambda p, a, k: p.nn.functional.conv2d(a, k, **case), [x, w],
         CONV_TOL)


@pytest.mark.parametrize("fmt", ["NCL", "NLC"])
def test_conv1d(fmt):
    x = _x(2, 3, 13, seed=6)
    if fmt == "NLC":
        x = np.ascontiguousarray(x.transpose(0, 2, 1))
    pad = "SAME" if fmt == "NCL" else [[0, 0], [2, 1], [0, 0]]
    both(lambda p, a, k, c: p.nn.functional.conv1d(
        a, k, c, stride=2, padding=pad, dilation=2, data_format=fmt),
        [x, _x(5, 3, 3, seed=7), _x(5, seed=8)], CONV_TOL)


@pytest.mark.parametrize("fmt", ["NDHWC"])
def test_conv3d(fmt):
    x = _x(1, 2, 5, 6, 5, seed=9)
    if fmt == "NDHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 4, 1))
    full = [[0, 0], [1, 0], [0, 1], [1, 1]]
    full.insert(1 if fmt == "NCDHW" else 4, [0, 0])
    both(lambda p, a, k: p.nn.functional.conv3d(
        a, k, stride=2, padding=full, data_format=fmt),
        [x, _x(3, 2, 3, 3, 3, seed=10)], CONV_TOL)


@pytest.mark.parametrize("case", [
    dict(stride=2, output_padding=1),
    dict(stride=2, padding=1, output_padding=1),
    dict(stride=3, padding=[1, 2], groups=2),
    dict(stride=2, padding=[0, 2, 1, 0], dilation=2),
    dict(stride=2, padding="SAME"),
    dict(stride=3, padding="VALID", data_format="NHWC"),
    dict(stride=2, padding=1, output_size=[15, 13]),
])
def test_conv2d_transpose(case):
    groups = case.get("groups", 1)
    x = _x(2, 4, 8, 7, seed=11)
    if case.get("data_format") == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    w = _x(4, 6 // groups, 3, 3, seed=12)
    both(lambda p, a, k, c: p.nn.functional.conv2d_transpose(
        a, k, c, **case), [x, w, _x(6, seed=13)], CONV_TOL)


def test_conv_transpose_1d_3d():
    both(lambda p, a, k: p.nn.functional.conv1d_transpose(
        a, k, stride=2, padding=1, output_padding=1),
        [_x(2, 3, 9, seed=14), _x(3, 2, 4, seed=15)], CONV_TOL)
    both(lambda p, a, k: p.nn.functional.conv3d_transpose(
        a, k, stride=2, padding="SAME"),
        [_x(1, 2, 3, 4, 3, seed=16), _x(2, 3, 3, 3, 3, seed=17)], CONV_TOL)


def test_conv_layer_default_initializer():
    """Weight and bias from ``Uniform(-1 / sqrt(fan_in), 1 / sqrt(fan_in))``
    with ``fan_in = in * prod(k) / groups``, as the reference draws them."""
    layer = tp.nn.Conv2D(8, 16, 3, groups=2)
    bound = 1 / np.sqrt(8 * 9 / 2)
    for p in (layer.weight, layer.bias):
        a = p.numpy()
        assert np.abs(a).max() <= bound
        assert a.std() > bound / 3
    assert tp.nn.Conv2D(8, 16, 3, bias_attr=False).bias is None


def test_conv_transpose_output_size_adds_rows_at_the_end():
    """``output_size`` one above the pads' size equals ``output_padding``
    1 (Paddle's rule; the reference ignores ``output_size``)."""
    F = tp.nn.functional
    x = tp.to_tensor(_x(2, 4, 8, 7, seed=18))
    w = tp.to_tensor(_x(4, 3, 3, 3, seed=19))
    a = F.conv2d_transpose(x, w, stride=2, padding=1, output_size=[16, 14])
    b = F.conv2d_transpose(x, w, stride=2, padding=1, output_padding=1)
    assert a.shape == [2, 3, 16, 14]
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError, match="output_size"):
        F.conv2d_transpose(x, w, stride=2, padding=1, output_size=[17, 13])


# -- pools -----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["max", "avg"])
@pytest.mark.parametrize("case", [
    dict(kernel_size=2),
    dict(kernel_size=3, stride=2, padding=1),
    dict(kernel_size=3, stride=2, padding="SAME"),
    dict(kernel_size=[3, 2], stride=[2, 1], padding=[0, 1, 1, 2]),
    dict(kernel_size=2, stride=2, padding=[2, 2]),
])
def test_pool2d(kind, case):
    both(lambda p, a: getattr(p.nn.functional, f"{kind}_pool2d")(a, **case),
         [_x(2, 3, 9, 8, seed=20)], POOL_TOL, eager=kind == "avg")


@pytest.mark.parametrize("exclusive", [True, False])
@pytest.mark.parametrize("padding", [1, [0, 1, 1, 2]])
def test_avg_pool2d_exclusive_with_padding(exclusive, padding):
    both(lambda p, a: p.nn.functional.avg_pool2d(
        a, 3, 2, padding, exclusive=exclusive), [_x(2, 3, 8, 9, seed=21)],
        POOL_TOL, eager=True)


@pytest.mark.parametrize("kind", ["max", "avg"])
def test_pool2d_nhwc(kind):
    x = np.ascontiguousarray(_x(2, 3, 9, 8, seed=22).transpose(0, 2, 3, 1))
    both(lambda p, a: getattr(p.nn.functional, f"{kind}_pool2d")(
        a, 3, 2, 1, data_format="NHWC"), [x], POOL_TOL, eager=kind == "avg")


def test_pool1d_pool3d():
    for name, x, kw in (
            ("max_pool1d", _x(2, 3, 11, seed=23), dict(kernel_size=3,
                                                        stride=2, padding=1)),
            ("avg_pool1d", _x(2, 3, 11, seed=24), dict(kernel_size=3,
                                                        stride=2, padding=1,
                                                        exclusive=False)),
            ("max_pool3d", _x(1, 2, 5, 6, 5, seed=25), dict(
                kernel_size=2, stride=2, padding="SAME")),
            ("avg_pool3d", _x(1, 2, 5, 6, 5, seed=26), dict(
                kernel_size=3, stride=2, padding=1))):
        both(lambda p, a: getattr(p.nn.functional, name)(a, **kw), [x],
             POOL_TOL, eager=name.startswith("avg"))


@pytest.mark.parametrize("padding", [0, [1, 0]])
def test_max_pool2d_mask_like_jax(padding):
    x = _x(2, 3, 9, 8, seed=27)
    _, want = jp.nn.functional.max_pool2d(jp.to_tensor(x), 3, 2, padding,
                                          return_mask=True)
    out, got = tp.nn.functional.max_pool2d(tp.to_tensor(x), 3, 2, padding,
                                           return_mask=True)
    assert got.dtype == tp.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))
    # every mask entry names the window's maximum in the unpadded input
    flat = x.reshape(2, 3, -1)
    picked = np.take_along_axis(flat, got.numpy().reshape(2, 3, -1), -1)
    np.testing.assert_array_equal(picked.reshape(out.shape), out.numpy())


@pytest.mark.parametrize("case", [
    ("adaptive_avg_pool2d", (2, 3, 7, 9), dict(output_size=[3, None])),
    ("adaptive_max_pool2d", (2, 3, 7, 9), dict(output_size=[3, 2])),
    ("adaptive_avg_pool1d", (2, 3, 10), dict(output_size=3)),
    ("adaptive_max_pool3d", (1, 2, 5, 3, 4), dict(output_size=[2, 3, 2])),
])
def test_adaptive_pools_sizes_that_do_not_divide(case):
    name, shape, kw = case
    both(lambda p, a: getattr(p.nn.functional, name)(a, **kw),
         [_x(*shape, seed=28)], POOL_TOL)


def test_adaptive_avg_pool2d_nhwc_and_lp_pool():
    x = np.ascontiguousarray(_x(2, 3, 7, 9, seed=29).transpose(0, 2, 3, 1))
    both(lambda p, a: p.nn.functional.adaptive_avg_pool2d(
        a, [3, 4], data_format="NHWC"), [x], POOL_TOL)
    both(lambda p, a: p.nn.functional.lp_pool2d(
        a, 2, 2, 1, norm_type=3.0), [_x(2, 3, 8, 8, seed=30)], POOL_TOL,
         eager=True)


def test_arguments_the_reference_ignores_raise():
    F = tp.nn.functional
    x = tp.to_tensor(_x(1, 2, 8, 8))
    x1 = tp.to_tensor(_x(1, 2, 8))
    x3 = tp.to_tensor(_x(1, 2, 4, 4, 4))
    for call in (lambda: F.max_pool2d(x, 2, ceil_mode=True),
                 lambda: F.avg_pool2d(x, 2, ceil_mode=True),
                 lambda: F.avg_pool2d(x, 2, divisor_override=3),
                 lambda: F.avg_pool3d(x3, 2, divisor_override=3),
                 lambda: F.max_pool1d(x1, 2, return_mask=True),
                 lambda: F.max_pool3d(x3, 2, return_mask=True),
                 lambda: F.adaptive_max_pool1d(x1, 2, return_mask=True),
                 lambda: F.adaptive_max_pool2d(x, 2, return_mask=True),
                 lambda: F.adaptive_max_pool3d(x3, 2, return_mask=True),
                 lambda: tp.nn.MaxPool2D(2, ceil_mode=True),
                 lambda: tp.nn.AvgPool2D(2, exclusive=False),
                 lambda: tp.nn.MaxPool2D(2, return_mask=True),
                 lambda: tp.nn.AvgPool1D(2, data_format="NLC"),
                 lambda: tp.nn.AvgPool3D(2, divisor_override=2),
                 lambda: tp.nn.AdaptiveMaxPool2D(2, return_mask=True),
                 lambda: tp.nn.AdaptiveAvgPool2D(2, data_format="NHWC"),
                 lambda: tp.nn.Conv2D(2, 2, 3, padding_mode="reflect")):
        with pytest.raises(NotImplementedError, match="ignores"):
            call()
    # the mask forms the reference computes wrong, or not at all
    with pytest.raises(NotImplementedError, match="NCHW"):
        F.max_pool2d(x, 2, data_format="NHWC", return_mask=True)
    with pytest.raises(NotImplementedError, match="an int or a 2-list"):
        F.max_pool2d(x, 2, padding="SAME", return_mask=True)
    with pytest.raises(TypeError, match="unexpected"):
        tp.nn.MaxPool2D(2, dilation=2)
    # the defaults, spelled out, are fine
    tp.nn.MaxPool2D(2, ceil_mode=False, data_format="NCHW",
                    return_mask=False)
    tp.nn.AdaptiveAvgPool3D(2, data_format="NCDHW")


# -- layers ----------------------------------------------------------------------
@pytest.fixture
def fast_jax_init(monkeypatch):
    """The JAX layers' initializers as zeros from numpy: a random
    initializer compiles for each new shape (about a second a layer), and
    :func:`seeded` writes every weight afterwards."""
    from paddle_tpu import dtypes as jdt
    from paddle_tpu.nn import initializer as jinit

    def zeros(self, shape, dtype):
        return jnp.asarray(np.zeros(shape, jdt.to_np(dtype)))

    for cls in (jinit.Constant, jinit.Normal, jinit.TruncatedNormal,
                jinit.Uniform, jinit.XavierNormal, jinit.XavierUniform,
                jinit.KaimingNormal, jinit.KaimingUniform):
        monkeypatch.setattr(cls, "_init_array", zeros)


def _seeded_value(name, shape, rng):
    """A weight of a trained net's scale: a conv or ``Linear`` weight with
    variance 1 / fan_in, a 1-D weight (a norm's gain) near 1, a bias or a
    running mean near 0, a running variance near 1."""
    a = rng.randn(*shape).astype(np.float32)
    if len(shape) >= 2:
        fan_in = shape[0] if len(shape) == 2 else int(np.prod(shape[1:]))
        return a / np.float32(np.sqrt(fan_in))
    if name.endswith("_variance"):
        return 1 + 0.1 * np.abs(a)
    if name.endswith("weight"):
        return 1 + 0.1 * a
    return 0.1 * a


def seeded(jl, tl, seed=0):
    """The same seeded numpy weights into the JAX layer (``set_state_dict``)
    and the port's (``convert.layer_state_from_numpy``), after checking
    that both have the same ``state_dict`` names, in order, and shapes."""
    own = tl.state_dict()
    theirs = jl.state_dict()
    assert list(theirs) == list(own)
    rng = np.random.RandomState(seed)
    state = {}
    for k, v in own.items():
        assert list(v.shape) == list(theirs[k].shape), k
        state[k] = _seeded_value(k, list(v.shape), rng)
    jl.set_state_dict(state)
    layer_state_from_numpy(state, tl)
    return state


def _layer_pair(make, xs, tol, grad=True):
    """The layer in both packages on :func:`seeded` weights: the output,
    and with ``grad`` every parameter's and input's gradient of
    ``sum(out ** 2)`` (the JAX side through ``jit.functional_call`` under
    ``jax.value_and_grad``)."""
    jl, tl = make(jp), make(tp)
    state = seeded(jl, tl)
    names = [n for n, _ in jl.named_parameters()]

    def f(params, *arrays):
        out = functional_call(jl, params, *arrays)[0]
        return jnp.sum(out * out), out

    params = {n: jnp.asarray(state[n]) for n in names}
    arrays = [jnp.asarray(x) for x in xs]
    if grad:
        (_, out), (gp, *gx) = jax.jit(jax.value_and_grad(
            f, argnums=tuple(range(len(xs) + 1)), has_aux=True))(
                params, *arrays)
        want = [out] + [gp[n] for n in names] + list(gx)
    else:
        want = [jax.jit(f)(params, *arrays)[1]]
    ins = [tp.to_tensor(x, stop_gradient=not grad) for x in xs]
    out = tl(*ins)
    got = [out.numpy()]
    if grad:
        (out * out).sum().backward()
        got += ([q.grad.numpy() for q in tl.parameters()]
                + [i.grad.numpy() for i in ins])
    outs = [[np.asarray(a, np.float64) for a in want],
            [np.asarray(a, np.float64) for a in got]]
    for i, (w, g) in enumerate(zip(*outs)):
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol, err_msg=str(i))


@pytest.mark.parametrize("case", [
    ("Conv1D", (3, 4, 3), dict(stride=2, padding=1), (2, 3, 9)),
    ("Conv2D", (4, 6, 3), dict(stride=2, padding="SAME", groups=2),
     (2, 4, 9, 8)),
    ("Conv2D", (3, 5, [3, 2]), dict(bias_attr=False, dilation=2),
     (2, 3, 9, 8)),
    ("Conv3D", (2, 3, 3), dict(padding=1), (1, 2, 4, 5, 4)),
    ("Conv1DTranspose", (3, 4, 3), dict(stride=2, output_padding=1),
     (2, 3, 6)),
    ("Conv2DTranspose", (4, 6, 3), dict(stride=2, padding=1, groups=2),
     (2, 4, 5, 6)),
    ("Conv3DTranspose", (2, 3, 2), dict(stride=2), (1, 2, 3, 3, 3)),
])
def test_conv_layers(case, fast_jax_init):
    name, args, kw, shape = case
    # the functionals' gradients are held above; the layers' parameter
    # gradients are held for the 2-D pair
    _layer_pair(lambda p: getattr(p.nn, name)(*args, **kw),
                [_x(*shape, seed=31)], CONV_TOL, grad="2D" in name)


@pytest.mark.parametrize("case", [
    ("MaxPool1D", (3, 2, 1), (2, 3, 9)),
    ("MaxPool2D", (3, 2, 1), (2, 3, 9, 8)),
    ("MaxPool3D", (2, 2), (1, 2, 4, 5, 4)),
    ("AvgPool1D", (3, 2, 1), (2, 3, 9)),
    ("AvgPool2D", (2, 2), (2, 3, 9, 8)),
    ("AvgPool3D", (3, 2, 1), (1, 2, 4, 5, 4)),
    ("AdaptiveAvgPool1D", (4,), (2, 3, 9)),
    ("AdaptiveAvgPool2D", ((3, 5),), (2, 3, 9, 8)),
    ("AdaptiveAvgPool3D", (2,), (1, 2, 4, 5, 4)),
    ("AdaptiveMaxPool1D", (4,), (2, 3, 9)),
    ("AdaptiveMaxPool2D", (3,), (2, 3, 9, 8)),
    ("AdaptiveMaxPool3D", (2,), (1, 2, 4, 5, 4)),
    ("LPPool2D", (2.0, 2, 2), (2, 3, 8, 8)),
])
def test_pool_layers(case, fast_jax_init):
    name, args, shape = case
    _layer_pair(lambda p: getattr(p.nn, name)(*args), [_x(*shape, seed=32)],
                POOL_TOL, grad=False)


# -- activation and loss layers, forward -------------------------------------------
ACTIVATIONS = [
    ("ReLU", ()), ("ReLU6", ()), ("Sigmoid", ()), ("Tanh", ()), ("Silu", ()),
    ("Mish", ()), ("LogSigmoid", ()), ("Tanhshrink", ()), ("Softsign", ()),
    ("Hardswish", ()), ("GLU", ()), ("GELU", (True,)), ("LeakyReLU", (0.2,)),
    ("PReLU", (6, 0.1)), ("ELU", (0.5,)), ("CELU", (1.5,)), ("SELU", ()),
    ("Hardshrink", (0.3,)), ("Softshrink", (0.3,)), ("Hardsigmoid", ()),
    ("Hardtanh", (-0.5, 0.5)), ("Softmax", (1,)), ("LogSoftmax", ()),
    ("Softplus", (2.0, 10.0)), ("ThresholdedReLU", (0.5,)), ("Maxout", (3,)),
    ("Swish", ()),
]


@pytest.mark.parametrize("name,args", ACTIVATIONS,
                         ids=[a[0] for a in ACTIVATIONS])
def test_activation_layers(name, args, fast_jax_init):
    x = _x(2, 6, 4, 4, seed=33)
    jl, tl = getattr(jp.nn, name)(*args), getattr(tp.nn, name)(*args)
    seeded(jl, tl)
    want = np.asarray(jl(jp.to_tensor(x)).numpy())
    got = tl(tp.to_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_rrelu_layer_eval():
    x = _x(2, 6, seed=34)
    jl, tl = jp.nn.RReLU(), tp.nn.RReLU()
    jl.eval()
    tl.eval()
    np.testing.assert_allclose(tl(tp.to_tensor(x)).numpy(),
                               np.asarray(jl(jp.to_tensor(x)).numpy()),
                               atol=1e-6, rtol=1e-6)


def _probs(*shape, seed):
    return 1 / (1 + np.exp(-_x(*shape, seed=seed)))


LOSSES = [
    ("CrossEntropyLoss", (), lambda: (_x(6, 5, seed=35),
                                      np.arange(6) % 5)),
    ("CrossEntropyLoss", dict(label_smoothing=0.1, reduction="sum"),
     lambda: (_x(6, 5, seed=36), np.arange(6) % 5)),
    ("MSELoss", (), lambda: (_x(4, 3, seed=37), _x(4, 3, seed=38))),
    ("L1Loss", ("sum",), lambda: (_x(4, 3, seed=39), _x(4, 3, seed=40))),
    ("NLLLoss", (), lambda: (_x(6, 5, seed=41), np.arange(6) % 5)),
    ("BCELoss", (), lambda: (_probs(4, 3, seed=42),
                             (_x(4, 3, seed=43) > 0).astype(np.float32))),
    ("BCEWithLogitsLoss", (), lambda: (_x(4, 3, seed=44),
                                       (_x(4, 3, seed=45) > 0).astype(
                                           np.float32))),
    ("SmoothL1Loss", ("mean", 0.5), lambda: (_x(4, 3, seed=46),
                                             _x(4, 3, seed=47))),
    ("KLDivLoss", ("sum",), lambda: (_x(4, 3, seed=48),
                                     _probs(4, 3, seed=49))),
    ("SoftMarginLoss", (), lambda: (_x(4, 3, seed=50), np.sign(
        _x(4, 3, seed=51)).astype(np.float32))),
    ("HingeEmbeddingLoss", (), lambda: (_x(4, 3, seed=52), np.sign(
        _x(4, 3, seed=53)).astype(np.float32))),
    ("MultiLabelSoftMarginLoss", (), lambda: (_x(4, 3, seed=54), (
        _x(4, 3, seed=55) > 0).astype(np.float32))),
    ("PoissonNLLLoss", (), lambda: (_x(4, 3, seed=56), np.abs(
        _x(4, 3, seed=57)))),
    ("GaussianNLLLoss", (), lambda: (_x(4, 3, seed=58), _x(4, 3, seed=59),
                                     np.abs(_x(4, 3, seed=60)) + 0.1)),
    ("MarginRankingLoss", (0.1,), lambda: (_x(4, seed=61), _x(4, seed=62),
                                           np.sign(_x(4, seed=63)).astype(
                                               np.float32))),
    ("CosineEmbeddingLoss", (0.2,), lambda: (_x(4, 3, seed=64),
                                             _x(4, 3, seed=65),
                                             np.sign(_x(4, seed=66)).astype(
                                                 np.float32))),
    ("TripletMarginLoss", (), lambda: (_x(4, 3, seed=67), _x(4, 3, seed=68),
                                       _x(4, 3, seed=69))),
]


@pytest.mark.parametrize("name,args,make", LOSSES,
                         ids=[f"{n}{i}" for i, (n, _, _) in
                              enumerate(LOSSES)])
def test_loss_layers(name, args, make):
    xs = make()
    kw = args if isinstance(args, dict) else {}
    pos = () if isinstance(args, dict) else args
    vals = []
    for p in (jp, tp):
        layer = getattr(p.nn, name)(*pos, **kw)
        vals.append(np.asarray(layer(*[p.to_tensor(x) for x in xs]).numpy()))
    np.testing.assert_allclose(vals[1], vals[0], atol=1e-5, rtol=1e-5)
