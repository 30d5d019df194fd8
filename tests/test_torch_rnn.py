"""``paddle.nn``'s recurrent layers of the port against the JAX package on
the CPU, f32, on the same weights (the reference's names and layouts,
carried by ``convert.layer_state_from_numpy``): the three cells, ``RNN``
and ``BiRNN`` over a cell, and ``SimpleRNN``/``LSTM``/``GRU`` at 2 layers,
forward and bidirectional, where the port runs PyTorch's multi-layer op
and the reference its cells step by step. Outputs, final states and the
gradients of every parameter and of the input within 1e-5 (sums in other
orders); the arguments the reference drops raise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as jp
from paddle_tpu.jit import functional_call
import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.convert import layer_state_from_numpy

import torch_numpy_init
from test_torch_threads import one_intra_op_thread  # noqa: F401

TOL = 1e-5
B, T, IN, H = 3, 4, 6, 5


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


def _pair(build):
    jp.seed(1)
    jm = build(jp)
    tm = build(tp)
    state = {n: t.numpy() for n, t in jm.state_dict().items()}
    assert list(tm.state_dict()) == list(state)
    layer_state_from_numpy(state, tm)
    return jm, tm


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _flat(o)]
    return [out]


def _x(shape=(B, T, IN)):
    return np.random.RandomState(2).randn(*shape).astype(np.float32)


def _loss(outs, sq):
    """The first output's sum plus the other outputs' sums of squares."""
    return sum((sq(o) for o in outs[1:]), outs[0].sum())


def _run_jax(m, x):
    """The JAX layer through ``jit.functional_call`` under one
    ``jax.jit(jax.value_and_grad(...))`` in its parameters and input."""
    params = {n: q._data for n, q in m.named_parameters()}

    def f(params, x):
        outs = _flat(functional_call(m, params, x)[0])
        return _loss(outs, lambda o: jnp.sum(o * o)), outs

    (_, outs), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    return ([np.asarray(o) for o in outs],
            {n: np.asarray(g) for n, g in gp.items()}, np.asarray(gx))


def _run_port(m, x):
    xt = tp.to_tensor(x, stop_gradient=False)
    outs = _flat(m(xt))
    _loss(outs, lambda o: (o * o).sum()).backward()
    return ([o.numpy() for o in outs],
            {n: q.grad.numpy() for n, q in m.named_parameters()},
            xt.grad.numpy())


def _check(build, x):
    jm, tm = _pair(build)
    (jo, jg, jx), (to, tg, tx) = _run_jax(jm, x), _run_port(tm, x)
    assert len(jo) == len(to)
    for a, b in zip(to, jo):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    assert sorted(tg) == sorted(jg)
    for n, g in jg.items():
        np.testing.assert_allclose(tg[n], g, rtol=TOL, atol=TOL, err_msg=n)
    np.testing.assert_allclose(tx, jx, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("cell", ["SimpleRNNCell", "LSTMCell", "GRUCell"])
def test_cell_step_like_jax(cell):
    _check(lambda p: getattr(p.nn, cell)(IN, H), _x()[:, 0])


def test_rnn_and_birnn_wrappers_like_jax():
    _check(lambda p: p.nn.RNN(p.nn.LSTMCell(IN, H), is_reverse=True), _x())
    _check(lambda p: p.nn.BiRNN(p.nn.GRUCell(IN, H), p.nn.GRUCell(IN, H)),
           _x())


@pytest.mark.parametrize("net,direction", [
    ("LSTM", "forward"), ("LSTM", "bidirect"), ("GRU", "bidirect")])
def test_two_layer_nets_like_jax(net, direction):
    _check(lambda p: getattr(p.nn, net)(IN, H, num_layers=2,
                                        direction=direction), _x())


def test_time_major_like_jax():
    _check(lambda p: p.nn.GRU(IN, H, num_layers=2, time_major=True),
           _x((T, B, IN)))


@pytest.mark.parametrize("activation", ["tanh", "relu"])
def test_simple_rnn_like_its_cells(activation):
    """The reference's ``SimpleRNN`` hands its cells the weight
    attributes where they take ``activation`` (the module docstring), so
    the port's is held against its own cells run step by step through
    ``BiRNN`` (the cells are held against the JAX package above)."""
    tp.seed(3)
    net = tp.nn.SimpleRNN(IN, H, num_layers=2, direction="bidirect",
                          activation=activation)
    x = tp.to_tensor(np.random.RandomState(4).randn(B, T, IN).astype(
        np.float32))
    out, h = net(x)
    want, hs = x, []
    for layer in net.layer_list:
        assert layer.rnn_fw.cell.activation == activation
        want, (h_fw, h_bw) = layer(want)
        hs += [h_fw, h_bw]
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(h.numpy(), tp.stack(hs).numpy(), rtol=TOL,
                               atol=TOL)
    # the reference's: activation="relu" raises, and "tanh" hands its cells
    # activation=None, which they run as relu
    with pytest.raises(TypeError):
        jp.nn.SimpleRNN(IN, H, activation="relu")
    assert jp.nn.SimpleRNN(IN, H).layer_list[0].cell.activation is None


def test_dropped_arguments_raise():
    lstm = tp.nn.LSTM(IN, H)
    x = tp.randn([B, T, IN])
    h0 = tp.zeros([1, B, H])
    with pytest.raises(NotImplementedError, match="initial_states"):
        lstm(x, (h0, h0))
    with pytest.raises(NotImplementedError, match="sequence_length"):
        lstm(x, sequence_length=tp.to_tensor([4, 3, 2]))
    rnn = tp.nn.RNN(tp.nn.GRUCell(IN, H))
    with pytest.raises(NotImplementedError, match="sequence_length"):
        rnn(x, sequence_length=tp.to_tensor([4, 3, 2]))
    cell = tp.nn.LSTMCell(IN, H)
    h, (h2, c) = cell(x[:, 0])
    assert h.shape == [B, H] and c.shape == [B, H]
    assert cell.state_shape == ((H,), (H,))
