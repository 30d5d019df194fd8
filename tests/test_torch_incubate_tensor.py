"""The incubate surface on ``paddle.Tensor`` s in both packages.

The cases of the reference's ``tests/test_incubate_functional.py`` and
``tests/test_incubate_fused.py``, and one call of every other public name
of ``incubate.nn.functional``, made from ``paddle.to_tensor`` of the same
seeded numpy inputs in ``paddle_tpu`` and ``paddle_tpu_torch`` (on the CPU
place): every output is a ``Tensor`` (a tuple of them where the op returns
several, None kept), of the reference's shape, and equal to the
reference's within 1e-5 (f32 on both sides: only sum orders differ; the
fp8 ops 2e-3 of the largest output, e4m3 codes whose scales round
differently). The seven ``Fused*`` layers are ``nn.Layer`` s with the
reference's parameter names, carrying its weights through
``convert.load_fused_from_jax``, forward and backward. The op names reach
amp's lists: a custom white list entry under ``auto_cast`` casts the op's
inputs in both packages.
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu.incubate.nn as JN
import paddle_tpu.incubate.nn.functional as JF
import paddle_tpu_torch as tp
import paddle_tpu_torch.incubate.nn as TN
import paddle_tpu_torch.incubate.nn.functional as TF
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.convert import load_fused_from_jax
from test_torch_threads import one_intra_op_thread  # noqa: F401

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    from paddle_tpu.distributed import fleet

    fleet._reset_for_tests()
    prev = (getattr(tdevice._state, "device", None),
            getattr(tdevice._state, "place", None))
    tp.set_device("cpu")
    yield
    tdevice._state.device, tdevice._state.place = prev


def _tensors(p, a):
    """numpy arrays (in lists too) as ``p.to_tensor``; the rest as it is."""
    if isinstance(a, np.ndarray):
        return p.to_tensor(a)
    if isinstance(a, list):
        return [_tensors(p, x) for x in a]
    return a


def _leaves(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def both(name, *args, atol=ATOL, **kw):
    """``name`` of both modules on Tensors of the same numpy arrays: the
    port's outputs are Tensors equal to the reference's. Returns the
    port's output and the reference's."""
    want = getattr(JF, name)(*(_tensors(jp, a) for a in args),
                             **{k: _tensors(jp, v) for k, v in kw.items()})
    got = getattr(TF, name)(*(_tensors(tp, a) for a in args),
                            **{k: _tensors(tp, v) for k, v in kw.items()})
    assert type(got) is type(want) or not isinstance(want, tuple), name
    for g, w in zip(_leaves(got), _leaves(want), strict=True):
        if w is None:
            assert g is None
            continue
        assert isinstance(g, tp.Tensor), (name, type(g))
        assert g.shape == list(w.shape), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w.numpy()),
                                   atol=atol, rtol=atol, err_msg=name)
    return got, want


def _rs(seed):
    return np.random.RandomState(seed)


def _f32(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


# ------------------------------------- tests/test_incubate_functional.py
def test_fused_mha_matches_unfused():
    rng = _rs(0)
    b, s, e, h = 2, 8, 32, 4
    got, _ = both("fused_multi_head_attention", _f32(rng, b, s, e),
                  _f32(rng, 3, h, e // h, e, scale=0.1),
                  _f32(rng, e, e, scale=0.1), pre_layer_norm=True,
                  dropout_rate=0.0, attn_dropout_rate=0.0, training=False)
    assert got.shape == [b, s, e]


def test_fused_feedforward_residual_ln():
    rng = _rs(1)
    x = _f32(rng, 2, 4, 16)
    both("fused_feedforward", x, _f32(rng, 16, 32, scale=0.1),
         _f32(rng, 32, 16, scale=0.1), pre_layer_norm=True,
         dropout1_rate=0.0, dropout2_rate=0.0)
    res = _f32(rng, 2, 4, 16)
    got, _ = both("fused_bias_dropout_residual_layer_norm", x, res,
                  dropout_rate=0.0)
    ref = x + res
    ref = (ref - ref.mean(-1, keepdims=True)) / np.sqrt(
        ref.var(-1, keepdims=True) + 1e-5)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("topk,norm", [(1, True), (2, True), (2, False)])
def test_fused_moe(topk, norm):
    rng = _rs(2)
    e = 2 if topk == 1 else 4
    both("fused_moe", _f32(rng, 1, 6, 8), _f32(rng, 8, e),
         _f32(rng, e, 8, 16, scale=0.3), None,
         _f32(rng, e, 16, 8, scale=0.3), None, moe_topk=topk,
         norm_topk_prob=norm)


def test_varlen_attention_masks_padding():
    rng = _rs(3)
    q = _f32(rng, 1, 2, 6, 8)
    sl = np.array([4], np.int32)
    out, _ = both("variable_length_memory_efficient_attention", q, q, q, sl,
                  sl)
    q2 = q.copy()
    q2[:, :, 4:] = 99.0
    out2, _ = both("variable_length_memory_efficient_attention", q2, q2, q2,
                   sl, sl)
    np.testing.assert_allclose(out.numpy()[:, :, :4], out2.numpy()[:, :, :4],
                               atol=2e-5)


def test_masked_multihead_attention_decode_step():
    rng = _rs(4)
    b, h, d, max_len = 2, 2, 8, 4
    (out, cache), _ = both("masked_multihead_attention",
                           _f32(rng, b, 3 * h * d),
                           cache_kv=np.zeros((2, b, h, max_len, d),
                                             np.float32))
    assert out.shape == [b, h * d]
    nc = cache.numpy()
    assert np.abs(nc[0][:, :, 0]).sum() > 0
    assert np.abs(nc[0][:, :, 1:]).sum() == 0


@pytest.mark.parametrize("mask", [False, True], ids=["kernel", "src_mask"])
def test_masked_mha_per_batch_lengths(mask):
    rng = _rs(5)
    b, h, d, max_len = 2, 1, 4, 6
    cache = np.zeros((2, b, h, max_len, d), np.float32)
    cache[:, 0, :, :3] = rng.randn(2, h, 3, d)
    cache[:, 1, :, :5] = rng.randn(2, h, 5, d)
    kw = dict(cache_kv=cache, sequence_lengths=np.array([3, 5], np.int32))
    if mask:
        kw["src_mask"] = _f32(rng, b, 1, 1, max_len)
    (_, nc), _ = both("masked_multihead_attention", _f32(rng, b, 3 * h * d),
                      **kw)
    nc = nc.numpy()
    assert np.abs(nc[0][0, :, 3]).sum() > 0
    assert np.abs(nc[0][1, :, 5]).sum() > 0
    assert np.abs(nc[0][0, :, 4:]).sum() == 0


def test_fused_mha_dropout_active_in_training():
    rng = _rs(6)
    x = tp.to_tensor(_f32(rng, 1, 4, 16))
    qkvw = tp.to_tensor(_f32(rng, 3, 2, 8, 16, scale=0.1))
    lw = tp.to_tensor(_f32(rng, 16, 16, scale=0.1))
    tp.seed(0)
    a = TF.fused_multi_head_attention(x, qkvw, lw, dropout_rate=0.5,
                                      attn_dropout_rate=0.0, training=True)
    b = TF.fused_multi_head_attention(x, qkvw, lw, dropout_rate=0.0,
                                      attn_dropout_rate=0.0, training=True)
    assert isinstance(a, tp.Tensor)
    assert not np.allclose(a.numpy(), b.numpy())


@pytest.mark.parametrize("name", ["fp8_gemm", "fp8_linear"])
def test_fp8_ops_on_tensors(name):
    rng = _rs(7)
    x, w = _f32(rng, 8, 32), _f32(rng, 32, 16)
    want = np.asarray(getattr(JF, name)(jp.to_tensor(x),
                                        jp.to_tensor(w)).numpy())
    got = getattr(TF, name)(tp.to_tensor(x), tp.to_tensor(w))
    assert isinstance(got, tp.Tensor)
    assert np.abs(got.numpy() - want).max() <= 2e-3 * np.abs(want).max()


# --------------------------------------------- every other public name
@pytest.mark.parametrize("case", ["plain", "residual", "bias"])
def test_fused_norms(case):
    rng = _rs(8)
    x, r, b = _f32(rng, 3, 5, 16, scale=2.0), _f32(rng, 3, 5, 16), \
        _f32(rng, 16)
    w, nb = 1 + _f32(rng, 16, scale=0.2), _f32(rng, 16)
    kw = {"plain": {}, "residual": dict(residual=r),
          "bias": dict(bias=b, residual=r, norm_bias=nb)}[case]
    got, _ = both("fused_rms_norm", x, w, **kw)
    assert isinstance(got, tuple) == ("residual" in kw)
    both("fused_layer_norm", x, w, **kw)


def test_rope_swiglu_bias_act_and_gemms():
    rng = _rs(9)
    q, k = _f32(rng, 2, 6, 3, 16), _f32(rng, 2, 6, 3, 16)
    got, _ = both("fused_rotary_position_embedding", q, k)
    assert got[2] is None
    x, y, b = _f32(rng, 4, 16), _f32(rng, 4, 16), _f32(rng, 16)
    both("swiglu", x)
    both("swiglu", x, y)
    for act in ("gelu", "swiglu", "relu"):
        both("fused_bias_act", x, b, act_method=act)
    w = _f32(rng, 16, 8)
    both("fused_linear", x, w, _f32(rng, 8))
    both("fused_linear", x, np.ascontiguousarray(w.T), None, True)
    both("fused_matmul_bias", x, w, _f32(rng, 8))
    both("fused_linear_activation", x, w, _f32(rng, 8), activation="relu")
    both("fused_dropout_add", x, y, 0.5, training=False)


def test_fused_linear_cross_entropy():
    rng = _rs(10)
    both("fused_linear_cross_entropy", _f32(rng, 2, 5, 16),
         _f32(rng, 40, 16, scale=0.3),
         rng.randint(0, 40, (2, 5)).astype(np.int64), chunk_size=4)


def test_fused_multi_transformer_on_weight_lists():
    rng = _rs(11)
    e, h, f, n = 16, 2, 32, 2

    def ws(*shape, scale=0.1):
        return [_f32(rng, *shape, scale=scale) for _ in range(n)]

    both("fused_multi_transformer", _f32(rng, 2, 4, e),
         [1 + _f32(rng, e, scale=0.1) for _ in range(n)], ws(e),
         ws(3, h, e // h, e), ws(3, h, e // h), ws(e, e), ws(e),
         [1 + _f32(rng, e, scale=0.1) for _ in range(n)], ws(e), ws(e, f),
         ws(f), ws(f, e), ws(e))


def test_paged_and_block_attention():
    rng = _rs(12)
    q = _f32(rng, 2, 4, 64)
    kp, vp = _f32(rng, 2, 6, 16, 64), _f32(rng, 2, 6, 16, 64)
    tables = np.array([[4, 1, 5], [0, 3, 2]], np.int32)
    lens = np.array([37, 20], np.int32)
    both("paged_attention", q, kp, vp, tables, lens)
    both("blha_get_max_len", np.array([3, 0], np.int32),
         np.array([5, 9], np.int32), 2)
    # a prefill, then a decode step over the page-major caches
    hq, hkv, d, page = 4, 2, 64, 16
    btab = rng.permutation(8)[:4].reshape(2, 2).astype(np.int32)
    caches = {p: [p.to_tensor(np.zeros((8, hkv, page, d), np.float32))
                  for _ in range(2)] for p in (jp, tp)}
    for this, dec in ((np.array([5, 9]), np.zeros(2, np.int64)),
                      (np.array([1, 1]), np.array([5, 9]))):
        qkv = _f32(rng, int(this.sum()), (hq + 2 * hkv) * d)
        enc = np.where(dec == 0, this, 0)
        outs = {}
        for p, mod in ((jp, JF), (tp, TF)):
            kc, vc = caches[p]
            meta = [p.to_tensor(a[:, None].astype(np.int32))
                    for a in (enc, dec, this)]
            qt = p.to_tensor(qkv)
            out, qkv_out, kc2, vc2 = mod.block_multihead_attention(
                qt, kc, vc, *meta, None, None, None, None,
                p.to_tensor(btab), block_size=page)
            caches[p] = [kc2, vc2]
            outs[p] = (out, kc2, vc2)
            if p is tp:
                assert qkv_out is qt
                assert all(isinstance(t, tp.Tensor) for t in (out, kc2, vc2))
        for g, w in zip(outs[tp], outs[jp]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w.numpy()),
                                       atol=ATOL, rtol=ATOL)


def test_op_names_reach_amp_lists():
    """``fused_linear`` under a custom white list runs in bf16 in both
    packages: the op is dispatched under the reference's name."""
    rng = _rs(13)
    x, w = _f32(rng, 4, 16), _f32(rng, 16, 8)
    for p, mod in ((jp, JF), (tp, TF)):
        with p.amp.auto_cast(custom_white_list={"fused_linear"},
                             dtype="bfloat16"):
            out = mod.fused_linear(p.to_tensor(x), p.to_tensor(w))
        assert str(out.dtype).endswith("bfloat16"), (p.__name__, out.dtype)


# ---------------------------------------- tests/test_incubate_fused.py
def _carry(jm, tm, seed):
    rng = np.random.default_rng(seed)
    sd = {k: (0.3 * rng.standard_normal(tuple(v.shape)) + (
        1.0 if "ln_scale" in k else 0.0)).astype(np.float32)
        for k, v in jm.state_dict().items()}
    jm.set_state_dict({k: jp.to_tensor(a) for k, a in sd.items()})
    load_fused_from_jax(sd, tm)


def test_fused_mha_and_ffn_train():
    """``FusedTransformerEncoderLayer(32, 4, 64)`` at dropout 0 on the
    reference's weights: output and every parameter's gradient."""
    jm = JN.FusedTransformerEncoderLayer(32, 4, 64, dropout_rate=0.0)
    tm = TN.FusedTransformerEncoderLayer(32, 4, 64, dropout_rate=0.0)
    assert isinstance(tm, tp.nn.Layer)
    assert [n for n, _ in tm.named_parameters()] == [
        n for n, _ in jm.named_parameters()]
    _carry(jm, tm, 14)
    x = _f32(_rs(15), 2, 8, 32)
    outs = []
    for p, m in ((jp, jm), (tp, tm)):
        out = m(p.to_tensor(x))
        (out ** 2).mean().backward()
        outs.append(out)
    assert isinstance(outs[1], tp.Tensor) and outs[1].shape == [2, 8, 32]
    np.testing.assert_allclose(outs[1].numpy(), np.asarray(outs[0].numpy()),
                               atol=ATOL, rtol=ATOL)
    assert tm.fused_attn.qkv_weight.grad is not None
    jgrads = {n: q.grad for n, q in jm.named_parameters()}
    for n, q in tm.named_parameters():
        if jgrads[n] is None:
            assert q.grad is None, n
        else:
            np.testing.assert_allclose(q.grad.numpy(),
                                       np.asarray(jgrads[n].numpy()),
                                       atol=1e-6, rtol=1e-4, err_msg=n)


def test_fused_multi_transformer_layer():
    jm = JN.FusedMultiTransformer(16, 2, 32, num_layers=2)
    tm = TN.FusedMultiTransformer(16, 2, 32, num_layers=2)
    _carry(jm, tm, 16)
    x = _f32(_rs(17), 1, 4, 16)
    out = tm(tp.to_tensor(x))
    assert isinstance(out, tp.Tensor) and out.shape == [1, 4, 16]
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jm(jp.to_tensor(x)).numpy()),
                               atol=ATOL, rtol=ATOL)


def test_param_attrs_reach_the_parameters():
    """The ``*_attr`` arguments go through ``create_parameter``: an
    initializer, a name and a learning rate."""
    init = tp.nn.initializer.Constant(0.25)
    lin = TN.FusedLinear(8, 4, weight_attr=tp.ParamAttr(
        name="w0", initializer=init, learning_rate=0.5))
    assert lin.weight.name == "w0"
    assert (lin.weight.numpy() == 0.25).all()
    assert lin.weight.optimize_attr["learning_rate"] == 0.5
    mha = TN.FusedMultiHeadAttention(8, 2, qkv_weight_attr=tp.ParamAttr(
        initializer=init), ln_scale_attr=tp.ParamAttr(
        initializer=tp.nn.initializer.Constant(2.0)))
    assert (mha.qkv_weight.numpy() == 0.25).all()
    assert (mha.ln_scale.numpy() == 2.0).all()
    enc = TN.FusedTransformerEncoderLayer(8, 2, 16, weight_attr=tp.ParamAttr(
        initializer=init))
    assert (enc.ffn.linear2_weight.numpy() == 0.25).all()
    assert (enc.fused_attn.linear_weight.numpy() == 0.25).all()
