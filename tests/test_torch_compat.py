"""The long tail of the surface on the port against the JAX package, on
the CPU, f32: ``ops/compat.py``'s functions the op battery does not hold,
``nn.functional``'s compat functionals and ``nn``'s compat layers (weights
carried by name with ``convert.layer_state_from_numpy``). Forward within
``TOL`` of the JAX package's, and the gradient of the output's sum with
respect to each float input where the case says so, within ``GTOL``
(sums in other orders). The random ops, ``flash_attn_varlen_qkvpacked``'s
refusal and the in-place activations' rebinding are held on the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as jp
from paddle_tpu.core.tensor import Tensor as JTensor
import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.convert import layer_state_from_numpy

import torch_numpy_init
from test_torch_threads import one_intra_op_thread  # noqa: F401

TOL, GTOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _numpy_jax_init(monkeypatch):
    torch_numpy_init.install(monkeypatch)


@pytest.fixture(autouse=True)
def _cpu():
    prev = (getattr(tdevice._state, "device", None),
            getattr(tdevice._state, "place", None))
    tp.set_device("cpu")
    yield
    tdevice._state.device, tdevice._state.place = prev


def _std(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _i64(a):
    return np.asarray(a, np.int64)


#: name -> (inputs from a RandomState, fn(paddle, *tensors), grad)
CASES = {
    # ops/compat.py beyond the battery
    "gammaln": (lambda r: [np.abs(_std(r, 3, 4)) + 0.5],
                lambda p, x: p.gammaln(x), True),
    "gammainc": (lambda r: [np.abs(_std(r, 6)) + 0.5,
                            np.abs(_std(r, 6)) + 0.1],
                 lambda p, a, x: p.gammainc(a, x), False),
    "gammaincc": (lambda r: [np.abs(_std(r, 6)) + 0.5,
                             np.abs(_std(r, 6)) + 0.1],
                  lambda p, a, x: p.gammaincc(a, x), False),
    "multigammaln": (lambda r: [np.abs(_std(r, 5)) + 2.0],
                     lambda p, x: p.multigammaln(x, 3), True),
    "cumulative_trapezoid": (lambda r: [_std(r, 3, 6)],
                             lambda p, y: p.cumulative_trapezoid(y, dx=0.5),
                             True),
    "reduce_as": (lambda r: [_std(r, 2, 3, 4), _std(r, 3, 1)],
                  lambda p, x, t: p.reduce_as(x, t), True),
    "histogram_bin_edges": (lambda r: [_std(r, 10)],
                            lambda p, x: p.histogram_bin_edges(x, 4), False),
    "block_diag": (lambda r: [_std(r, 2, 2), _std(r, 1, 3)],
                   lambda p, a, b: p.block_diag([a, b]), True),
    "vecdot": (lambda r: [_std(r, 3, 4), _std(r, 3, 4)],
               lambda p, a, b: p.vecdot(a, b), True),
    "combinations": (lambda r: [_std(r, 4)],
                     lambda p, x: p.combinations(x, 2), True),
    "combinations_r": (lambda r: [_std(r, 3)],
                       lambda p, x: p.combinations(x, 2, True), False),
    "cartesian_prod": (lambda r: [_std(r, 2), _std(r, 3)],
                       lambda p, a, b: p.cartesian_prod([a, b]), True),
    "select_scatter": (lambda r: [_std(r, 3, 4), _std(r, 4)],
                       lambda p, x, v: p.select_scatter(x, v, 0, 1), True),
    "slice_scatter": (lambda r: [_std(r, 4, 6), _std(r, 4, 2)],
                      lambda p, x, v: p.slice_scatter(x, v, [1], [1], [5],
                                                      [2]), True),
    "diagonal_scatter": (lambda r: [_std(r, 4, 4), _std(r, 3)],
                         lambda p, x, v: p.diagonal_scatter(x, v, 1), True),
    "shard_index": (lambda r: [_i64([[1], [6], [11], [19]])],
                    lambda p, x: p.shard_index(x, 20, 2, 1), False),
    "reverse": (lambda r: [_std(r, 3, 4)],
                lambda p, x: p.reverse(x, [0, 1]), True),
    "view_as": (lambda r: [_std(r, 3, 4), _std(r, 2, 6)],
                lambda p, x, o: p.view_as(x, o), False),
    "as_real_complex": (lambda r: [_std(r, 3, 2)],
                        lambda p, x: p.as_real(p.as_complex(x)), False),
    "sgn": (lambda r: [_std(r, 5)], lambda p, x: p.sgn(x), False),
    "positive": (lambda r: [_std(r, 5)], lambda p, x: p.positive(x), True),
    "bitwise_invert": (lambda r: [_i64([0, 3, -4])],
                       lambda p, x: p.bitwise_invert(x), False),
    # nn.functional compat
    "sequence_mask": (lambda r: [_i64([3, 1, 4])],
                      lambda p, x: p.nn.functional.sequence_mask(x), False),
    "lp_pool1d": (lambda r: [np.abs(_std(r, 2, 3, 9)) + 0.1],
                  lambda p, x: p.nn.functional.lp_pool1d(x, 2, 3, 2), True),
    "max_unpool2d": (
        lambda r: [_std(r, 1, 2, 2, 2),
                   _i64([[[[0, 3], [9, 14]], [[5, 2], [12, 11]]]])],
        lambda p, x, i: p.nn.functional.max_unpool2d(x, i, 2), True),
    "max_unpool1d": (lambda r: [_std(r, 1, 2, 3), _i64([[[0, 3, 5],
                                                         [1, 2, 4]]])],
                     lambda p, x, i: p.nn.functional.max_unpool1d(x, i, 2),
                     True),
    "fractional_max_pool2d": (
        lambda r: [_std(r, 1, 2, 7, 7)],
        lambda p, x: p.nn.functional.fractional_max_pool2d(x, 3), True),
    "fractional_max_pool3d": (
        lambda r: [_std(r, 1, 1, 5, 5, 5)],
        lambda p, x: p.nn.functional.fractional_max_pool3d(x, 2), True),
    "dice_loss": (lambda r: [np.abs(_std(r, 4, 3)), _i64([[0], [2], [1],
                                                          [2]])],
                  lambda p, x, y: p.nn.functional.dice_loss(x, y), True),
    "hsigmoid_loss": (
        lambda r: [_std(r, 4, 5), _i64([1, 5, 0, 3]), _std(r, 5, 5),
                   _std(r, 5, 1)],
        lambda p, x, y, w, b: p.nn.functional.hsigmoid_loss(x, y, 6, w, b),
        True),
    "npair_loss": (lambda r: [_std(r, 4, 5), _std(r, 4, 5),
                              _i64([0, 1, 0, 2])],
                   lambda p, a, b, y: p.nn.functional.npair_loss(a, b, y),
                   True),
    "margin_cross_entropy": (
        lambda r: [np.tanh(_std(r, 4, 6)), _i64([0, 5, 2, 2])],
        lambda p, x, y: p.nn.functional.margin_cross_entropy(x, y), True),
    "rnnt_loss": (
        lambda r: [_std(r, 2, 4, 3, 5), _i64([[1, 2], [3, 1]]),
                   _i64([4, 3]), _i64([2, 1])],
        lambda p, x, y, tl, ul: p.nn.functional.rnnt_loss(x, y, tl, ul),
        True),
    "gather_tree": (
        lambda r: [_i64([[[2, 5], [7, 1]], [[4, 3], [0, 6]],
                         [[8, 9], [2, 2]]]),
                   _i64([[[0, 0], [0, 0]], [[1, 0], [0, 0]],
                         [[1, 1], [1, 0]]])],
        lambda p, i, q: p.nn.functional.gather_tree(i, q), False),
    "temporal_shift": (lambda r: [_std(r, 4, 8, 2, 2)],
                       lambda p, x: p.nn.functional.temporal_shift(x, 2),
                       True),
    "sparse_attention": (
        lambda r: [_std(r, 1, 2, 4, 8), _std(r, 1, 2, 4, 8),
                   _std(r, 1, 2, 4, 8),
                   np.array([[[0, 1, 3, 4, 6], [0, 2, 3, 5, 8]]], np.int32),
                   np.array([[[0, 0, 1, 2, 1, 3, 0, 0],
                              [0, 1, 1, 0, 2, 0, 1, 3]]], np.int32)],
        lambda p, q, k, v, o, c: p.nn.functional.sparse_attention(
            q, k, v, o, c), True),
    "triplet_margin_with_distance_loss": (
        lambda r: [_std(r, 4, 5), _std(r, 4, 5), _std(r, 4, 5)],
        lambda p, a, b, c: p.nn.functional.triplet_margin_with_distance_loss(
            a, b, c, swap=True), True),
    "multi_margin_loss": (
        lambda r: [_std(r, 4, 5), _i64([0, 4, 2, 2])],
        lambda p, x, y: p.nn.functional.multi_margin_loss(x, y, p=2), True),
    "adaptive_log_softmax_with_loss": (
        lambda r: [_std(r, 5, 6), _i64([0, 1, 2, 4, 5]), _std(r, 6, 4),
                   _std(r, 6, 2), _std(r, 6, 2)],
        lambda p, x, y, hw, t0, t1:
            p.nn.functional.adaptive_log_softmax_with_loss(
                x, y, hw, [t0, t1], [2, 4, 6])[1], True),
    "flash_attn_qkvpacked": (
        lambda r: [_std(r, 2, 8, 3, 2, 16)],
        lambda p, qkv: p.nn.functional.flash_attn_qkvpacked(
            qkv, causal=True)[0], True),
}


def _float_args(raw):
    return tuple(i for i, a in enumerate(raw) if a.dtype == np.float32)


def _run_eager(p, name, raw):
    """``fn`` on the package's eager tape: its output, and the gradient of
    its sum in each float input (zeros where the output does not reach
    the input)."""
    _, fn, grad = CASES[name]
    xs = [p.to_tensor(a) for a in raw]
    if grad:
        for i in _float_args(raw):
            xs[i].stop_gradient = False
    out = fn(p, *xs)
    got = np.asarray(out.numpy())
    if not grad:
        return got, []
    out.sum().backward()
    return got, [np.zeros_like(raw[i]) if xs[i].grad is None
                 else xs[i].grad.numpy() for i in _float_args(raw)]


#: cases whose reference reads a value on the host, which jit refuses
EAGER = {"sequence_mask", "fractional_max_pool2d"}


def _run_jax(name, raw):
    """The reference's function on Tensors over traced arrays under one
    ``jax.jit(jax.value_and_grad(...))`` in the float inputs (its eager
    tape compiles every op on its own, several times slower)."""
    _, fn, grad = CASES[name]
    if name in EAGER:
        return _run_eager(jp, name, raw)

    def f(*arrays):
        out = fn(jp, *[JTensor(a) for a in arrays])._data
        return jnp.sum(out.real if jnp.iscomplexobj(out) else out), out

    arrays = [jnp.asarray(a) for a in raw]
    if not grad:
        return np.asarray(jax.jit(f)(*arrays)[1]), []
    (_, out), grads = jax.jit(jax.value_and_grad(
        f, argnums=_float_args(raw), has_aux=True))(*arrays)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", sorted(CASES))
def test_like_jax(name):
    raw = CASES[name][0](np.random.RandomState(7))
    want, want_g = _run_jax(name, raw)
    got, got_g = _run_eager(tp, name, raw)
    assert got.shape == want.shape and got.dtype.kind == want.dtype.kind
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert len(got_g) == len(want_g)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, rtol=GTOL, atol=GTOL)


#: the compat layers whose weights, state or arguments add to their
#: functionals' cases: (build(paddle), inputs)
LAYERS = {
    "PairwiseDistance": (lambda p: p.nn.PairwiseDistance(),
                         lambda r: [_std(r, 4, 5), _std(r, 4, 5)]),
    "Softmax2D": (lambda p: p.nn.Softmax2D(), lambda r: [_std(r, 2, 3, 2, 2)]),
    "Unflatten": (lambda p: p.nn.Unflatten(1, [2, 3]),
                  lambda r: [_std(r, 4, 6)]),
    "ZeroPad1D": (lambda p: p.nn.ZeroPad1D([1, 2]),
                  lambda r: [_std(r, 2, 3, 4)]),
    "ZeroPad3D": (lambda p: p.nn.ZeroPad3D([1, 0, 2, 1, 0, 1]),
                  lambda r: [_std(r, 1, 2, 2, 3, 3)]),
    "HSigmoidLoss": (lambda p: p.nn.HSigmoidLoss(5, 6),
                     lambda r: [_std(r, 4, 5), _i64([1, 5, 0, 3])]),
    "AdaptiveLogSoftmaxWithLoss": (
        lambda p: p.nn.AdaptiveLogSoftmaxWithLoss(6, 8, [3, 5]),
        lambda r: [_std(r, 4, 6), _i64([0, 4, 6, 7])]),
    "SpectralNorm": (lambda p: p.nn.SpectralNorm([4, 5], power_iters=2),
                     lambda r: [_std(r, 4, 5)]),
}


def _layer_out(out):
    return out[-1] if isinstance(out, (list, tuple)) else out


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_like_jax(name):
    build, make = LAYERS[name]
    jp.seed(2)
    jl, tl = build(jp), build(tp)
    state = {n: t.numpy() for n, t in jl.state_dict().items()}
    assert list(tl.state_dict()) == list(state)
    layer_state_from_numpy(state, tl)
    raw = make(np.random.RandomState(8))
    res = []
    for p, layer in ((jp, jl), (tp, tl)):
        xs = [p.to_tensor(a) for a in raw]
        res.append(np.asarray(_layer_out(layer(*xs)).numpy()))
        res.append({n: t.numpy() for n, t in layer.state_dict().items()})
    np.testing.assert_allclose(res[2], res[0], rtol=TOL, atol=TOL)
    for n, t in res[1].items():      # SpectralNorm's u and v move
        np.testing.assert_allclose(res[3][n], t, rtol=TOL, atol=TOL)


def test_parameter_dict_and_dynamic_decode():
    pd = tp.nn.ParameterDict({"a": tp.create_parameter([2], "float32")})
    pd["b"] = tp.create_parameter([3], "float32")
    assert list(pd) == ["a", "b"] and len(pd) == 2
    assert [list(p.shape) for p in pd.values()] == [[2], [3]]
    assert len(pd.parameters()) == 2
    jp.seed(3)
    jcell = jp.nn.GRUCell(1, 4)
    tcell = tp.nn.GRUCell(1, 4)
    layer_state_from_numpy({n: t.numpy() for n, t in
                            jcell.state_dict().items()}, tcell)
    outs = []
    for p, cell in ((jp, jcell), (tp, tcell)):
        dec = p.nn.BeamSearchDecoder(cell, start_token=1, end_token=3,
                                     beam_size=2)
        toks, state = p.nn.dynamic_decode(
            dec, inits=p.zeros([1, 4]), max_step_num=5)
        outs.append((toks.numpy(), state.numpy()))
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=TOL, atol=TOL)


def test_varlen_packed_raises_unless_padded():
    qkv = tp.to_tensor(np.random.RandomState(1).randn(2, 8, 3, 2, 16)
                       .astype(np.float32))
    cu = tp.to_tensor(np.array([0, 8, 16], np.int32))
    out, _ = tp.nn.functional.flash_attn_varlen_qkvpacked(qkv, cu, cu, 8, 8)
    want, _ = tp.nn.functional.flash_attn_qkvpacked(qkv)
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    with pytest.raises(NotImplementedError, match="cu_seqlens_q"):
        tp.nn.functional.flash_attn_varlen_qkvpacked(
            qkv, tp.to_tensor(np.array([0, 5, 16], np.int32)), cu, 11, 8)


@pytest.mark.parametrize("kw, match", [
    (dict(scale=0.5), "scale"),
    (dict(max_seqlen_q=6), "max_seqlen_q"),
    (dict(max_seqlen_k=7), "max_seqlen_k"),
])
def test_varlen_packed_raises_on_ignored_arguments(kw, match):
    qkv = tp.to_tensor(np.random.RandomState(1).randn(2, 8, 3, 2, 16)
                       .astype(np.float32))
    cu = tp.to_tensor(np.array([0, 8, 16], np.int32))
    args = {"max_seqlen_q": 8, "max_seqlen_k": 8, **kw}
    with pytest.raises(NotImplementedError, match=match):
        tp.nn.functional.flash_attn_varlen_qkvpacked(qkv, cu, cu, **args)


def test_inplace_activations_rebind():
    for fn, args in (("hardtanh_", ()), ("leaky_relu_", (0.1,)),
                     ("thresholded_relu_", (0.5,))):
        a = np.array([-2.0, -0.3, 0.2, 0.7, 3.0], np.float32)
        got = {}
        for p in (jp, tp):
            x = p.to_tensor(a)
            out = getattr(p.nn.functional, fn)(x, *args)
            assert out is x
            got[p] = x.numpy()
        np.testing.assert_allclose(got[tp], got[jp], rtol=TOL, atol=TOL)
    w = tp.create_parameter([3], "float32")
    data = w._data
    tp.nn.functional.hardtanh_(w)
    assert w._data is data                 # a Parameter is written into


def test_random_and_dlpack():
    tp.seed(0)
    x = tp.ones([64, 8, 4])
    assert tp.nn.functional.feature_alpha_dropout(x, 0.5, False) is x
    y = tp.nn.functional.feature_alpha_dropout(x, 0.5, True).numpy()
    per_channel = y.reshape(64, 8, 4)
    assert np.all(per_channel.std(-1) == 0)      # one draw a channel
    assert len(np.unique(np.round(y, 5))) == 2
    ln = tp.log_normal(0.0, 0.5, [2000])
    assert ln.shape == [2000] and float(ln.min()) > 0
    assert abs(float(np.log(ln.numpy()).mean())) < 0.05
    g = tp.standard_gamma(tp.full([4000], 3.0))
    assert abs(float(g.mean()) - 3.0) < 0.15
    t = tp.to_tensor(np.arange(6, dtype=np.float32))
    back = tp.from_dlpack(tp.to_dlpack(t))
    np.testing.assert_array_equal(back.numpy(), t.numpy())
    jx = jp.from_dlpack(tp.to_dlpack(t))
    np.testing.assert_array_equal(jx.numpy(), t.numpy())
    z = tp.to_tensor([1.0, 2.0])
    assert tp.increment(z, 2.0) is z and z.numpy().tolist() == [3.0, 4.0]
    s = tp.to_tensor(np.array([[1, 2], [3, 4]], np.float32))
    s.index_fill_(tp.to_tensor(np.array([1])), 0, 9.0)
    assert s.numpy().tolist() == [[1, 2], [9, 9]]
