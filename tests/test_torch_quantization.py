"""The port's ``paddle.quantization`` against the JAX package on the CPU.

Both packages take the same seeded float32 numpy inputs and weights.

- ``_fake_quant``: the forward values equal the reference's bit for bit
  (the same expression, round half to even in both), and the gradient is
  the identity (the straight-through estimator).
- One ``QuantedLinear``: output and gradients within f32 rounding (1e-5).
- A 2-layer hidden-32 BERT under ``QAT``, as phase ``compression`` holds
  the card to the CPU, the port's quanter recording its codes
  (``chip_smoke._RecordedQuanter``). Fake quantization is a step function:
  an ulp of difference between XLA's and torch's f32 sums moves a code
  near a rounding boundary by a level, ``s / qmax`` (``s`` the site's
  scale). So: with each package's own codes, in one eager forward of the
  reference, every activation code of the reference within one level of
  the port's, the weights' codes equal, and the loss within
  ``qat_moved_bound`` (twice the first-order effect of the
  codes that moved, ``(s / qmax) |dL/dx|`` each, from the port's run,
  which keeps each site's own gradient) plus 1e-5 of it; and with every
  reference site quantized to the port's codes and scales, the loss
  within 1e-5 and each gradient within 1e-4 of its leaf's norm.
- ``PTQ``: each layer's ``static_scales`` equals the largest ``|x|`` of its
  inputs over the calibration batches, exactly, and the converted model's
  output equals the reference's.
- The registry (``quanter``, ``BaseObserver``, ``BaseQuanter``) and the
  departures from the reference toward Paddle: ``quantize(inplace=False)``
  leaves the model as it was, ``add_layer_config(layer)`` configures that
  layer only, and ``GroupWiseWeightObserver.scales()`` reads
  ``group_size``.

The JAX side runs one forward and one backward a case, eagerly.
"""
import copy

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.quantization as jq
import paddle_tpu_torch as tp
import paddle_tpu_torch.quantization as tq
import torch_numpy_init
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.convert import layer_state_from_numpy
from test_torch_threads import one_intra_op_thread  # noqa: F401

TOL = 1e-5
QMAX = 127.0
BERT = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_seq_len=16, dropout=0.0)


@pytest.fixture(autouse=True)
def _cpu():
    prev = (getattr(tdevice._state, "device", None),
            getattr(tdevice._state, "place", None))
    tp.set_device("cpu")
    yield
    tdevice._state.device, tdevice._state.place = prev


def _x(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _np(t):
    return np.asarray(t.numpy())


def _hex(a):
    return np.asarray(a, np.float32).view(np.uint32)


# -- fake quantization --------------------------------------------------------
@pytest.mark.parametrize("bits", [8, 4])
def test_fake_quant_values_bit_for_bit_and_ste_gradient(bits):
    x = _x(6, 33, scale=3.0)
    x[0, :4] = [0.5, 1.5, -2.5, 0.0]       # halves: round half to even
    for scale in (float(np.abs(x).max()), 0.7):
        jx = jp.to_tensor(x, stop_gradient=False)
        tx = tp.to_tensor(x, stop_gradient=False)
        jy = jq._fake_quant(jx, jp.to_tensor(np.float32(scale)), bits)
        ty = tq._fake_quant(tx, tp.to_tensor(np.float32(scale)), bits)
        np.testing.assert_array_equal(_hex(_np(ty)), _hex(_np(jy)))
        (ty * tp.to_tensor(x)).sum().backward()
        np.testing.assert_array_equal(_np(tx.grad), x)  # identity
    # a float scale (PTQ's static scale) is an f32 scalar on x's device
    np.testing.assert_array_equal(
        _np(tq._fake_quant(tp.to_tensor(x), 0.7, bits)),
        _np(jq._fake_quant(jp.to_tensor(x), jp.to_tensor(0.7), bits)))


def test_fake_quant_promotes_as_jax():
    x = _x(4, 8)
    xb = tp.to_tensor(x).astype("bfloat16")
    assert tq._fake_quant(xb, xb.abs().max()).dtype == tp.bfloat16
    assert tq._fake_quant(xb, tp.to_tensor(1.0)).dtype == tp.float32


def _linear_pair(seed=0):
    jl, tl = jp.nn.Linear(24, 16), tp.nn.Linear(24, 16)
    state = {"weight": _x(24, 16, seed=seed, scale=0.3),
             "bias": _x(16, seed=seed + 1, scale=0.1)}
    jl.set_state_dict(state)
    layer_state_from_numpy(state, tl)
    return jl, tl


def test_quanted_linear_like_jax():
    jl, tl = _linear_pair()
    cfg_j, cfg_t = jq.QuantConfig(), tq.QuantConfig()
    jm, tm = jq.QuantedLinear(jl, cfg_j), tq.QuantedLinear(tl, cfg_t)
    x = _x(5, 24, seed=3)
    jx = jp.to_tensor(x, stop_gradient=False)
    tx = tp.to_tensor(x, stop_gradient=False)
    jy, ty = jm(jx), tm(tx)
    np.testing.assert_allclose(_np(ty), _np(jy), atol=TOL, rtol=TOL)
    (jy ** 2).sum().backward()
    (ty ** 2).sum().backward()
    for a, b in ((tx, jx), (tl.weight, jl.weight), (tl.bias, jl.bias)):
        np.testing.assert_allclose(_np(a.grad), _np(b.grad), atol=TOL,
                                   rtol=TOL)


# -- QAT on a small BERT ------------------------------------------------------
def _bert_pair(monkeypatch):
    from paddle_tpu.models.bert import BertConfig as JCfg
    from paddle_tpu.models.bert import BertForPretraining as JBert
    from paddle_tpu_torch.models import BertConfig, BertForPretraining

    torch_numpy_init.install(monkeypatch, std=0.1)
    jm = JBert(JCfg(**BERT))
    tm = BertForPretraining(BertConfig(**BERT))
    layer_state_from_numpy(
        {n: _np(t) for n, t in jm.state_dict().items()}, tm)
    return jm, tm


def _bert_batch(seed=1, b=3, s=12):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, BERT["vocab_size"], (b, s)).astype(np.int64)
    labels = np.full((b, s), -100, np.int64)
    labels[:, ::3] = rng.randint(0, BERT["vocab_size"], (b, (s + 2) // 3))
    nsp = rng.randint(0, 2, (b,)).astype(np.int64)
    types = rng.randint(0, 2, (b, s)).astype(np.int64)
    return ids, labels, nsp, types


class _JaxLoss(jp.nn.Layer):
    def __init__(self, model):
        super().__init__()
        self.m = model

    def forward(self, *batch):
        return self.m.loss(*batch)


def _jax_loss_and_grads(jm, *batch):
    """The reference model's loss and parameter gradients, its layers run
    under one ``jax.jit(jax.value_and_grad(...))`` (``jit.functional_call``)
    in place of the eager tape."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.jit import functional_call

    wrapper = _JaxLoss(jm)
    params = {n: p._data for n, p in wrapper.named_parameters()}

    def f(params, *arrays):
        return functional_call(wrapper, params, *arrays)[0]

    loss, grads = jax.jit(jax.value_and_grad(f))(
        params, *[jnp.asarray(a) for a in batch])
    return float(loss), {n[2:]: np.asarray(g) for n, g in grads.items()}


class _JaxCodes:
    """A reference quanter: records its codes and scales (``replay`` None,
    eagerly: the reference's own fake quantization with the codes read off
    in numpy), or quantizes to the port's recorded codes and scales under
    ``jax.jit``."""

    def __init__(self, replay=None):
        self.replay = replay
        self.codes = []

    def __call__(self, x):
        import jax
        import jax.numpy as jnp

        if self.replay is None:
            a = _np(x)
            s = np.float32(max(np.abs(a).max(), 1e-8))
            self.codes.append((np.clip(np.round(a / s * np.float32(QMAX)),
                                       -QMAX - 1, QMAX), s))
            return jq._fake_quant(x, x.abs().max())
        q, sc = self.replay[len(self.codes)]
        self.codes.append(None)
        deq = jnp.asarray((q * torch.clamp_min(sc, 1e-8) / QMAX).numpy())
        return jp.core.dispatch.apply_op(
            lambda a: a + jax.lax.stop_gradient(deq - a), x)


def qat_moved_bound(codes, other, sites):
    """How far a QAT loss may move when another run's activation codes
    ``other`` stand where ``codes`` stood. ``codes`` and ``other``: per
    site ``(q, s)``, the codes and the abs-max scale; ``sites``: per site
    ``(x, dL/dx)`` of the run of ``codes``. To first order the loss moves
    by ``sum over moved elements |dq| (s / qmax) |dL/dx|``, each moved
    code's own effect through the straight-through gradient; twice that,
    because that gradient carries a moved value through the sites after
    it as if they passed it on, where they may absorb it (and a code they
    move there is counted at its own site). Codes that did not move add
    nothing."""
    bound = 0.0
    for (q, s), (q2, _), (_, gx) in zip(codes, other, sites):
        dq = np.abs(np.asarray(q, np.float64) - np.asarray(q2, np.float64))
        bound += (float(np.asarray(s)) / QMAX
                  * float((dq * np.abs(np.asarray(gx, np.float64))).sum()))
    return 2.0 * bound


def test_qat_bert_loss_and_grads_within_the_level_bound(monkeypatch):
    from chip_smoke import _RecordedQuanter, _retain_site_inputs

    jm, tm = _bert_pair(monkeypatch)
    state = {n: _np(t) for n, t in jm.state_dict().items()}
    t_act, t_w = _RecordedQuanter(), _RecordedQuanter()
    tm = tq.QAT(tq.QuantConfig(t_act, t_w)).quantize(tm, inplace=True)
    n_quanted = sum(isinstance(m, tq.QuantedLinear) for m in tm.sublayers())
    assert n_quanted == 6 * BERT["num_layers"] + 3
    ids, labels, nsp, types = _bert_batch()
    tsites = _retain_site_inputs(tm, tq.QuantedLinear)
    loss = tm.loss(tp.to_tensor(ids), tp.to_tensor(labels),
                   tp.to_tensor(nsp), tp.to_tensor(types))
    loss.backward()
    tl = float(loss)
    tg = {n: _np(q.grad) for n, q in tm.named_parameters()}
    assert len(tsites) == len(t_act.codes) == n_quanted

    def jax_model(act, w):
        jm.set_state_dict(state)
        return jq.QAT(jq.QuantConfig(act, w)).quantize(
            copy.deepcopy(jm), inplace=True)

    # the reference's own codes: each within one level of the port's, the
    # weights' equal, its loss within the moved codes' bound
    j_act, j_w = _JaxCodes(), _JaxCodes()
    with jp.no_grad():
        jl = float(jax_model(j_act, j_w).loss(
            jp.to_tensor(ids), jp.to_tensor(labels), jp.to_tensor(nsp),
            jp.to_tensor(types)))
    for mine, theirs, most in ((t_act, j_act, 1), (t_w, j_w, 0)):
        assert len(theirs.codes) == n_quanted
        for (q, _), (ref, _) in zip(mine.codes, theirs.codes):
            assert np.abs(q.numpy() - ref).max() <= most
    loss_b = qat_moved_bound(
        t_act.codes, j_act.codes,
        [(x.detach().numpy(), x.grad.numpy()) for x in tsites])
    assert abs(tl - jl) <= loss_b + TOL * abs(jl), (tl, jl, loss_b)
    # every site quantized to the port's codes: f32 rounding only
    pl, pg = _jax_loss_and_grads(
        jax_model(_JaxCodes(t_act.codes), _JaxCodes(t_w.codes)), ids,
        labels, nsp, types)
    assert abs(tl - pl) <= TOL * abs(pl), (tl, pl)
    assert sorted(tg) == sorted(pg)
    for name, g in pg.items():
        err = np.abs(tg[name] - g).max()
        # + 1e-7: the key biases' exact gradient is 0 (rounding noise)
        assert err <= 1e-4 * np.linalg.norm(g) + 1e-7, (name, err)


def test_qat_optimizer_after_quantize_steps_the_inner_linears():
    model = tp.nn.Sequential(tp.nn.Linear(8, 8), tp.nn.ReLU(),
                             tp.nn.Linear(8, 4))
    before = {k: _np(v).copy() for k, v in model.state_dict().items()}
    q = tq.QAT(tq.QuantConfig()).quantize(model)      # a deep copy
    assert all(isinstance(q[i], tq.QuantedLinear) for i in (0, 2))
    assert isinstance(model[0], tp.nn.Linear)          # left as it was
    keys = list(q.state_dict())
    assert keys == ["0.inner.weight", "0.inner.bias", "2.inner.weight",
                    "2.inner.bias"]
    assert [p.name for p in q.parameters()] == [
        q[0].inner.weight.name, q[0].inner.bias.name,
        q[2].inner.weight.name, q[2].inner.bias.name]
    opt = tp.optimizer.AdamW(learning_rate=1e-2, parameters=q.parameters())
    x = tp.to_tensor(_x(4, 8))
    (q(x) ** 2).mean().backward()
    opt.step()
    for k, v in q.state_dict().items():
        assert not np.array_equal(_np(v), before[k.replace(".inner", "")])
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(_np(v), before[k])


def test_reference_quantizes_in_place_even_when_asked_not_to():
    """A reference fault, recorded: ``QAT.quantize(inplace=False)``
    changes the given model."""
    model = jp.nn.Sequential(jp.nn.Linear(4, 4))
    jq.QAT(jq.QuantConfig()).quantize(model, inplace=False)
    assert isinstance(model[0], jq.QuantedLinear)


# -- PTQ ----------------------------------------------------------------------
def test_ptq_static_scales_exact_and_converted_output_like_jax():
    jl, tl = _linear_pair(seed=4)
    jmodel = jp.nn.Sequential(jl, jp.nn.ReLU(), jp.nn.Linear(16, 24))
    tmodel = tp.nn.Sequential(tl, tp.nn.ReLU(), tp.nn.Linear(16, 24))
    state = {k: _np(v) for k, v in jmodel.state_dict().items()}
    layer_state_from_numpy(state, tmodel)
    jptq, tptq = jq.PTQ(jq.QuantConfig()), tq.PTQ(tq.QuantConfig())
    jmodel = jptq.quantize(jmodel, inplace=True)
    tmodel = tptq.quantize(tmodel, inplace=True)
    batches = [_x(5, 24, seed=10 + i, scale=1 + i) for i in range(2)]
    for b in batches:
        jmodel(jp.to_tensor(b))
        tmodel(tp.to_tensor(b))
    jptq.convert(jmodel)
    tptq.convert(tmodel)
    # each layer's scale is its inputs' largest |x|, exactly: layer 2's
    # inputs are the port's own first-layer outputs; against the
    # reference's, which its f32 GEMM rounds otherwise, within rounding
    hidden = [_np(tp.nn.functional.relu(tl(tp.to_tensor(b))))
              for b in batches]
    want0 = max(float(np.abs(b).max()) for b in batches)
    assert tmodel[0].static_scales == want0 == jmodel[0].static_scales
    assert tmodel[2].static_scales == max(float(np.abs(h).max())
                                          for h in hidden)
    np.testing.assert_allclose(tmodel[2].static_scales,
                               jmodel[2].static_scales, rtol=1e-6)
    x = _x(3, 24, seed=20)
    np.testing.assert_allclose(_np(tmodel(tp.to_tensor(x))),
                               _np(jmodel(jp.to_tensor(x))), atol=TOL,
                               rtol=TOL)


def test_absmax_observer_reads_the_host_only_in_scale():
    obs = tq.AbsmaxObserver()
    assert obs.scale() == 0.0
    for i, s in enumerate((2.0, 5.0, 1.0)):
        obs.observe(tp.to_tensor(_x(3, 4, seed=i, scale=s)))
        assert isinstance(obs._absmax, torch.Tensor)
    want = max(float(np.abs(_x(3, 4, seed=i, scale=s)).max())
               for i, s in enumerate((2.0, 5.0, 1.0)))
    assert obs.scale() == want


# -- registry, config and observers -------------------------------------------
def test_registry_like_jax():
    for q in (jq, tq):
        @q.quanter("MyQuanter")
        class MyQuanter(q.BaseQuanter):
            def __call__(self, x):
                return x

        assert q.MyQuanter is MyQuanter
        assert q.BaseObserver.register(int) is int
        assert q.BaseQuanter.register(str) is str
        with pytest.raises(NotImplementedError):
            q.BaseObserver().observe(None)
        with pytest.raises(NotImplementedError):
            q.BaseQuanter()(None)
    assert (tq.quanters.FakeQuanterWithAbsMaxObserver
            is tq.FakeQuanterWithAbsMax)
    assert tq.observers.AbsmaxObserver is tq.AbsmaxObserver


class _Halve(tq.BaseQuanter):
    def __call__(self, x):
        return x * 0.5


def test_add_layer_config_configures_the_given_layer_only():
    """Paddle's semantics; the reference sets the quanters of every layer
    (recorded as a reference fault)."""
    model = tp.nn.Sequential(tp.nn.Linear(6, 6), tp.nn.Linear(6, 6))
    cfg = tq.QuantConfig()
    cfg.add_layer_config(model[1], weight=_Halve())
    q = tq.QAT(cfg).quantize(model)
    assert cfg.quanters_of(q[0].inner)[1] is cfg.weight
    assert isinstance(cfg.quanters_of(q[1].inner)[1], _Halve)
    jcfg = jq.QuantConfig()
    jcfg.add_layer_config(None, weight=_Halve())
    assert isinstance(jcfg.weight, _Halve)    # every layer's, in both
    cfg.add_layer_config(weight=_Halve())
    assert isinstance(cfg.quanters_of(q[0].inner)[1], _Halve)


def test_groupwise_observer_reads_group_size():
    w = _x(256, 8, seed=5)
    jo = jq.observers.GroupWiseWeightObserver(group_size=128)
    to = tq.observers.GroupWiseWeightObserver(group_size=64)
    jo.observe(jp.to_tensor(w))
    to.observe(tp.to_tensor(w))
    assert to.scale() == jo.scale() == float(np.abs(w).max())
    np.testing.assert_array_equal(
        to.scales().numpy(), np.abs(w).reshape(4, 64, 8).max(1))
