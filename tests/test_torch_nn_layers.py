"""The port's ``nn.Layer`` and its common, container, norm and transformer
layers against the JAX package (the cases of ``tests/test_nn_layers.py``
for the layers this port has), on weights carried across by
``convert.layer_state_from_numpy``.

Each layer pair is built in both packages; the JAX layer's
``state_dict()`` (whose names must equal the port's, in order) is loaded
into the port's, the same seeded numpy inputs go through both, and the
outputs agree to 1e-5 (absolute and relative, float32; 2e-5 through
attention), with every parameter's and input's gradient wherever no other
test holds it. The default initializers are held by distribution, since
the random streams differ.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.convert import layer_state_from_numpy
from test_torch_threads import one_intra_op_thread  # noqa: F401

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    prev = (getattr(tdevice._state, "device", None),
            getattr(tdevice._state, "place", None))
    tp.set_device("cpu")
    yield
    tdevice._state.device, tdevice._state.place = prev


def carry(jl, tl):
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    assert list(state) == list(tl.state_dict())
    layer_state_from_numpy(state, tl)


def _run(p, layer, xs, train, grad):
    layer.train() if train else layer.eval()
    ins = [p.to_tensor(x, stop_gradient=not (grad and x.dtype == np.float32))
           for x in xs]
    out = layer(*ins)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    res = [np.asarray(o.numpy(), np.float64) for o in outs]
    if grad:
        total = None
        for o in outs:
            s = (o * o).sum()
            total = s if total is None else total + s
        total.backward()
        res += [np.asarray(p_.grad.numpy(), np.float64)
                for p_ in layer.parameters() if p_.grad is not None]
        res += [np.asarray(i.grad.numpy(), np.float64) for i in ins
                if not i.stop_gradient]
    return res


def pair(make, xs, train=False, grad=True, tol=TOL):
    """``make(package)`` in both packages on carried weights; outputs and
    gradients of ``sum(out^2)`` equal to ``tol``."""
    jl, tl = make(jp), make(tp)
    carry(jl, tl)
    a = _run(jp, jl, xs, train, grad)
    b = _run(tp, tl, xs, train, grad)
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_allclose(y, x, atol=tol, rtol=tol, err_msg=str(i))
    return jl, tl


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# -- infrastructure --------------------------------------------------------------
def test_parameters_and_state_dict_names_like_jax():
    def net(p):
        return p.nn.Sequential(p.nn.Linear(4, 8), p.nn.LayerNorm(8),
                               p.nn.Linear(8, 2))

    for make in (net, lambda p: p.nn.TransformerEncoder(
            p.nn.TransformerEncoderLayer(16, 4, 24, dropout=0.0), 2),
            lambda p: p.nn.BatchNorm2D(3),
            lambda p: p.nn.Transformer(16, 4, 1, 1, 24, dropout=0.0)):
        jl, tl = make(jp), make(tp)
        assert list(jl.state_dict()) == list(tl.state_dict())
        assert [q.shape for q in jl.parameters()] == \
            [q.shape for q in tl.parameters()]
    lin = tp.nn.Linear(4, 3)
    assert set(dict(lin.named_parameters())) == {"weight", "bias"}
    assert lin.weight.shape == [4, 3] and not lin.weight.stop_gradient
    assert "_mean" in dict(tp.nn.BatchNorm2D(3).named_buffers())


def test_layer_infra():
    l1, l2 = tp.nn.Linear(4, 3), tp.nn.Linear(4, 3)
    missing, unexpected = l2.set_state_dict(l1.state_dict())
    assert missing == [] and unexpected == []
    np.testing.assert_array_equal(l1.weight.numpy(), l2.weight.numpy())
    net = tp.nn.Sequential(tp.nn.Linear(2, 2), tp.nn.Dropout(0.5))
    net.eval()
    assert not net[1].training
    net.train()
    assert net[1].training
    calls = []
    h = l1.register_forward_post_hook(lambda layer, i, o: calls.append(1))
    pre = l1.register_forward_pre_hook(lambda layer, i: (i[0] * 2,))
    y = l1(tp.ones([1, 4]))
    np.testing.assert_allclose(
        y.numpy(), 2 * l1.weight.numpy().sum(0)[None] + l1.bias.numpy(),
        rtol=1e-6)
    h.remove()
    pre.remove()
    l1(tp.ones([1, 4]))
    assert calls == [1]
    seen = []
    tp.nn.Sequential(tp.nn.Linear(2, 2), tp.nn.Linear(2, 2)).apply(
        lambda m: seen.append(type(m).__name__))
    assert seen.count("Linear") == 2
    ll = tp.nn.LayerList([tp.nn.Linear(2, 2)])
    ll.append(tp.nn.Linear(2, 2))
    assert len(ll) == 2 and isinstance(ll[1], tp.nn.Linear)
    ld = tp.nn.LayerDict({"a": tp.nn.Linear(2, 2)})
    assert "a" in ld and len(ld.parameters()) == 2
    pl = tp.nn.ParameterList([tp.create_parameter([2, 3])])
    assert len(pl) == 1 and pl[0].shape == [2, 3]


def test_dtype_change_keeps_parameters_live():
    """``bfloat16()`` writes a new torch.nn.Parameter into each same Paddle
    Parameter: a list taken before names the live tensors."""
    net = tp.nn.Sequential(tp.nn.Linear(4, 8), tp.nn.LayerNorm(8))
    before = net.parameters()
    held = [q._data for q in before]
    net.bfloat16()
    after = net.parameters()
    assert all(a is b for a, b in zip(before, after))
    assert all(q.dtype == tp.bfloat16 for q in before)
    assert all(isinstance(q._data, torch.nn.Parameter)
               and q._data.requires_grad for q in before)
    assert all(q._data is not h for q, h in zip(before, held))
    net(tp.ones([2, 4]).astype("bfloat16")).sum().backward()
    assert all(q.grad is not None and q.grad.dtype == tp.bfloat16
               for q in before)
    net.float()
    assert all(q.dtype == tp.float32 for q in net.parameters())
    same = [q._data for q in net.parameters()]
    net.to(dtype="float32")
    assert all(q._data is s for q, s in zip(net.parameters(), same))


# -- forward (and backward) on carried weights -----------------------------------
#: gradients are held where no other test holds them: the layers whose
#: functionals' gradients the op battery holds (F.linear, F.layer_norm,
#: F.group_norm, F.local_response_norm, F.batch_norm in eval,
#: F.cosine_similarity and the parameterless ones) and BERT's Linear and
#: LayerNorm parameters (tests/test_torch_bert.py) are held forward only
@pytest.mark.parametrize("name,make,xs,train,grad", [
    ("linear", lambda p: p.nn.Linear(5, 3), [_x(2, 4, 5)], False, False),
    ("linear_nobias", lambda p: p.nn.Linear(5, 3, bias_attr=False),
     [_x(4, 5)], False, False),
    ("layernorm", lambda p: p.nn.LayerNorm(8), [_x(3, 8) * 3 + 1], False,
     False),
    ("layernorm_2d", lambda p: p.nn.LayerNorm([4, 6]), [_x(2, 4, 6)], False,
     False),
    ("rmsnorm", lambda p: p.nn.RMSNorm(8), [_x(3, 8)], False, True),
    ("groupnorm", lambda p: p.nn.GroupNorm(2, 6), [_x(2, 6, 3, 3)], False,
     False),
    ("instancenorm", lambda p: p.nn.InstanceNorm2D(3), [_x(2, 3, 4, 4)],
     False, True),
    ("lrn", lambda p: p.nn.LocalResponseNorm(3), [_x(2, 5, 3, 3)], False,
     False),
    ("batchnorm_eval", lambda p: p.nn.BatchNorm1D(3), [_x(6, 3)], False,
     False),
    ("batchnorm_train", lambda p: p.nn.BatchNorm2D(2, momentum=0.5),
     [_x(4, 2, 3, 3) * 5], True, True),
    ("bilinear", lambda p: p.nn.Bilinear(3, 4, 5),
     [_x(2, 3), _x(2, 4, seed=1)], False, True),
    ("cosine", lambda p: p.nn.CosineSimilarity(),
     [_x(3, 4), _x(3, 4, seed=2)], False, False),
    ("sequential", lambda p: p.nn.Sequential(p.nn.Linear(6, 5),
                                             p.nn.LayerNorm(5),
                                             p.nn.Linear(5, 3)),
     [_x(4, 6)], False, False),
    ("flatten", lambda p: p.nn.Flatten(), [_x(2, 3, 4)], False, False),
    ("pixelshuffle", lambda p: p.nn.PixelShuffle(2), [_x(1, 8, 2, 2)], False,
     False),
    ("pad2d", lambda p: p.nn.Pad2D([1, 2, 0, 1], value=0.5),
     [_x(1, 2, 3, 3)], False, False),
    ("upsample", lambda p: p.nn.Upsample(scale_factor=2, mode="nearest"),
     [_x(1, 2, 3, 3)], False, False),
    ("dropout_eval", lambda p: p.nn.Dropout(0.5), [_x(4, 4)], False, False),
    ("identity", lambda p: p.nn.Identity(), [_x(4, 4)], False, False),
], ids=lambda v: v if isinstance(v, str) else "")
def test_layer_like_jax(name, make, xs, train, grad):
    pair(make, xs, train=train, grad=grad)


def test_batchnorm_running_stats_like_jax():
    jl, tl = pair(lambda p: p.nn.BatchNorm2D(2, momentum=0.5),
                  [_x(4, 2, 3, 3) * 5], train=True, grad=False)
    np.testing.assert_allclose(tl._mean.numpy(), jl._mean.numpy(), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(tl._variance.numpy(), jl._variance.numpy(),
                               rtol=TOL, atol=TOL)


def test_embedding_like_jax():
    ids = np.array([[1, 2, 0], [3, 4, 0]], np.int64)
    pair(lambda p: p.nn.Embedding(10, 4), [ids])
    _, tl = pair(lambda p: p.nn.Embedding(10, 4, padding_idx=0), [ids])
    np.testing.assert_array_equal(tp.nn.Embedding(10, 4, padding_idx=0)
                                  .weight.numpy()[0], 0.0)


@pytest.mark.parametrize("name,make,xs", [
    ("encoder_layer", lambda p: p.nn.TransformerEncoderLayer(
        16, 4, 24, dropout=0.0), [_x(2, 5, 16)]),
    ("decoder", lambda p: p.nn.TransformerDecoder(
        p.nn.TransformerDecoderLayer(16, 4, 24, dropout=0.0), 1),
     [_x(2, 4, 16), _x(2, 6, 16, seed=1)]),
], ids=lambda v: v if isinstance(v, str) else "")
def test_transformer_layers_like_jax(name, make, xs):
    """Outputs and gradients. ``MultiHeadAttention`` alone, with its masks
    and caches, is ``tests/test_torch_sdpa.py``'s."""
    pair(make, xs, tol=2e-5)


@pytest.mark.parametrize("name,make,xs", [
    ("transformer", lambda p: p.nn.Transformer(16, 4, 1, 1, 24, dropout=0.0),
     [_x(2, 6, 16), _x(2, 4, 16, seed=1)]),
    ("mha_kdim_vdim", lambda p: p.nn.MultiHeadAttention(16, 4, kdim=12,
                                                        vdim=10),
     [_x(2, 5, 16), _x(2, 7, 12, seed=1), _x(2, 7, 10, seed=2)]),
    ("encoder_prenorm_gelu", lambda p: p.nn.TransformerEncoder(
        p.nn.TransformerEncoderLayer(16, 4, 24, dropout=0.0,
                                     activation="gelu",
                                     normalize_before=True), 2,
        p.nn.LayerNorm(16)), [_x(2, 5, 16)]),
], ids=lambda v: v if isinstance(v, str) else "")
def test_transformer_forward_like_jax(name, make, xs):
    """Forward on carried weights: the whole ``Transformer`` and a
    pre-norm gelu encoder stack (whose layers' gradients the test above
    holds), and keys and values of other widths."""
    pair(make, xs, grad=False, tol=2e-5)


def test_transformer_masks_like_jax():
    mask = np.tril(np.ones((4, 4), np.float32))
    add_mask = np.where(mask > 0, 0.0, -1e9).astype(np.float32)[None, None]

    jl = jp.nn.TransformerDecoder(
        jp.nn.TransformerDecoderLayer(16, 4, 24, dropout=0.0), 1)
    tl = tp.nn.TransformerDecoder(
        tp.nn.TransformerDecoderLayer(16, 4, 24, dropout=0.0), 1)
    carry(jl, tl)
    tgt, mem = _x(2, 4, 16), _x(2, 6, 16, seed=1)
    outs = []
    for p, layer in ((jp, jl), (tp, tl)):
        layer.eval()
        bool_mask = p.to_tensor(mask > 0)
        a = layer(p.to_tensor(tgt), p.to_tensor(mem),
                  tgt_mask=p.to_tensor(add_mask))
        b = layer(p.to_tensor(tgt), p.to_tensor(mem), tgt_mask=bool_mask)
        outs.append((a.numpy(), b.numpy()))
    for j, t in zip(outs[0], outs[1]):
        np.testing.assert_allclose(t, j, atol=2e-5, rtol=2e-5)
    sq = [p.nn.Transformer.generate_square_subsequent_mask(4).numpy()
          for p in (jp, tp)]
    np.testing.assert_array_equal(sq[1], sq[0])


def test_grad_flows_through_layers():
    net = tp.nn.Sequential(tp.nn.Linear(4, 8), tp.nn.LayerNorm(8),
                           tp.nn.Linear(8, 1))
    net(tp.ones([2, 4])).sum().backward()
    assert all(q.grad is not None for q in net.parameters())
    net.clear_gradients()
    assert all(q.grad is None for q in net.parameters())


def test_dropout_train_vs_eval():
    d = tp.nn.Dropout(0.5)
    x = tp.ones([1000])
    d.eval()
    np.testing.assert_array_equal(d(x).numpy(), x.numpy())
    d.train()
    y = d(x).numpy()
    zeros = (y == 0).mean()
    assert 0.4 < zeros < 0.6
    np.testing.assert_allclose(y[y != 0], 2.0)
    tp.seed(7)
    a = tp.nn.functional.dropout(x, 0.3).numpy()
    tp.seed(7)
    b = tp.nn.functional.dropout(x, 0.3).numpy()
    np.testing.assert_array_equal(a, b)
    yc = tp.nn.functional.dropout(tp.ones([64, 32]), 0.5, axis=1).numpy()
    assert ((yc == 0).all(0) | (yc != 0).all(0)).all()


# -- losses --------------------------------------------------------------------------
@pytest.mark.parametrize("fn", [
    lambda p, a, b, y: p.nn.functional.cross_entropy(a, y),
    lambda p, a, b, y: p.nn.functional.cross_entropy(a, y, reduction="none"),
    lambda p, a, b, y: p.nn.functional.cross_entropy(a, y, ignore_index=1),
    lambda p, a, b, y: p.nn.functional.cross_entropy(a, y,
                                                     label_smoothing=0.1),
    lambda p, a, b, y: p.nn.functional.cross_entropy(
        a, p.nn.functional.softmax(b), soft_label=True),
    lambda p, a, b, y: p.nn.functional.cross_entropy(a, y.unsqueeze(-1)),
    lambda p, a, b, y: p.nn.functional.cross_entropy(
        a, y, weight=p.to_tensor(np.arange(1, 6, dtype=np.float32))),
    lambda p, a, b, y: p.nn.functional.mse_loss(a, b),
    lambda p, a, b, y: p.nn.functional.smooth_l1_loss(a, b, delta=0.5),
    lambda p, a, b, y: p.nn.functional.binary_cross_entropy_with_logits(
        a, (b > 0).astype("float32"),
        pos_weight=p.to_tensor(np.full(5, 2.0, np.float32))),
    lambda p, a, b, y: p.nn.functional.kl_div(
        p.nn.functional.log_softmax(a), p.nn.functional.softmax(b),
        reduction="batchmean"),
    lambda p, a, b, y: p.nn.functional.sigmoid_focal_loss(
        a, (b > 0).astype("float32")),
    lambda p, a, b, y: p.nn.functional.gaussian_nll_loss(
        a, b, p.ones([6, 5]) * 0.5, full=True),
    lambda p, a, b, y: p.nn.functional.log_loss(
        p.nn.functional.sigmoid(a), (b > 0).astype("float32")),
], ids=["ce", "ce_none", "ce_ignore", "ce_smooth", "ce_soft", "ce_label_col",
        "ce_weight", "mse", "huber", "bce_pos_weight", "kl_batchmean",
        "focal", "gaussian_nll", "log_loss"])
def test_losses_like_jax(request, fn):
    """Outputs; and the input's gradient for the cross-entropy variants
    (the battery holds the default forms' gradients)."""
    grad = request.node.callspec.id.startswith("ce")
    a, b = _x(6, 5), _x(6, 5, seed=1)
    y = np.random.RandomState(2).randint(0, 5, 6).astype(np.int64)
    res = []
    for p in (jp, tp):
        ta = p.to_tensor(a, stop_gradient=not grad)
        out = fn(p, ta, p.to_tensor(b), p.to_tensor(y))
        if grad:
            out.sum().backward()
        res.append((out.numpy(),) + ((ta.grad.numpy(),) if grad else ()))
    for x, z in zip(res[0], res[1]):
        np.testing.assert_allclose(z, x, atol=TOL, rtol=TOL)


def test_ctc_loss_like_jax():
    """The loss (torch's CTC; the reference's own dynamic program), at full
    input lengths, which the reference's ignores."""
    lp = _x(8, 2, 5)
    labels = np.array([[1, 2, 1], [3, 3, 0]], np.int32)
    in_len = np.array([8, 8], np.int64)
    lab_len = np.array([3, 2], np.int64)
    res = [p.nn.functional.ctc_loss(
        p.to_tensor(lp), p.to_tensor(labels), p.to_tensor(in_len),
        p.to_tensor(lab_len)).numpy() for p in (jp, tp)]
    np.testing.assert_allclose(res[1], res[0], rtol=1e-5)


# -- initializers ------------------------------------------------------------------
@pytest.mark.parametrize("init,check", [
    ("Normal(0.0, 0.02)", lambda a: abs(a.mean()) < 2e-3
     and abs(a.std() - 0.02) < 2e-3),
    ("TruncatedNormal(0.0, 1.0)", lambda a: a.min() >= -2 and a.max() <= 2
     and abs(a.std() - 0.88) < 0.03),
    ("Uniform(-0.5, 0.5)", lambda a: a.min() >= -0.5 and a.max() <= 0.5
     and abs(a.std() - 1 / np.sqrt(12)) < 0.01),
    ("XavierUniform()", lambda a: np.abs(a).max() <= np.sqrt(6 / 300) + 1e-6
     and abs(a.std() - np.sqrt(2 / 300)) < 0.005),
    ("XavierNormal()", lambda a: abs(a.std() - np.sqrt(2 / 300)) < 0.005),
    ("KaimingNormal()", lambda a: abs(a.std() - np.sqrt(2 / 100)) < 0.01),
    ("KaimingUniform()", lambda a: np.abs(a).max() <= np.sqrt(6 / 100) + 1e-6
     and abs(a.std() - np.sqrt(2 / 100)) < 0.01),
    ("Constant(0.5)", lambda a: (a == 0.5).all()),
    ("Orthogonal()", lambda a: np.allclose(a.T @ a, np.eye(200), atol=1e-4)),
])
def test_initializers_by_distribution(init, check):
    """The port's and the JAX package's initializers each pass the same
    distribution check on a [100, 200] weight."""
    for p in (jp, tp):
        fn = eval("p.nn.initializer." + init, {"p": p})
        a = np.asarray(fn._init_array([100, 200], "float32"), np.float64)
        if init == "Orthogonal()":
            a = np.asarray(fn._init_array([200, 100], "float32"), np.float64)
            assert np.allclose(a.T @ a, np.eye(100), atol=1e-4)
            continue
        assert check(a), (p.__name__, init)


def test_default_initializers_by_distribution():
    """Linear: XavierUniform weight, zero bias; Embedding: XavierUniform;
    LayerNorm: ones and zeros; same bounds on both packages."""
    for p in (jp, tp):
        lin = p.nn.Linear(300, 100)
        w = lin.weight.numpy()
        bound = np.sqrt(6 / 400)
        assert np.abs(w).max() <= bound + 1e-6
        assert abs(w.std() - bound / np.sqrt(3)) < 0.005
        assert (lin.bias.numpy() == 0).all()
        ln = p.nn.LayerNorm(7)
        assert (ln.weight.numpy() == 1).all() and (ln.bias.numpy() == 0).all()
        emb = p.nn.Embedding(500, 300).weight.numpy()
        assert np.abs(emb).max() <= np.sqrt(6 / 800) + 1e-6


def test_initializer_same_seed_same_values():
    tp.seed(11)
    a = tp.nn.Linear(8, 4).weight.numpy()
    tp.seed(11)
    b = tp.nn.Linear(8, 4).weight.numpy()
    np.testing.assert_array_equal(a, b)
    lin = tp.nn.Linear(3, 3, weight_attr=tp.ParamAttr(
        initializer=tp.nn.initializer.Constant(0.5)))
    assert (lin.weight.numpy() == 0.5).all()
