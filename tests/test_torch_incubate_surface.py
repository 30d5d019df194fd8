"""The rest of the incubate surface against the JAX package on the CPU:
every op of ``incubate.nn.functional`` (through its torch-level
``<name>_arrays`` bodies; ``tests/test_torch_incubate_tensor.py`` holds the
public names on ``Tensor`` s), the seven ``Fused*`` layers (``nn.Layer`` s
on ``Tensor`` s, on the CPU place) and ``incubate``'s top level.

Inputs and weights are made with numpy from a seed and fed to both
packages in f32; the layers' parameters cross by name
(``convert.load_fused_from_jax``). The port's kernels run their
plain versions here (the non-causal flash op, ``paged_attention``); the
JAX side runs its XLA routes and its Pallas paged kernel in interpret
mode. Dropout draws differ by design (a ``torch.Generator`` against the
JAX key chain), so parity is held at rate 0 or ``training=False``, and
dropout itself by its keep rate and scaling.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate as JI
import paddle_tpu.incubate.nn as JN
import paddle_tpu.incubate.nn.functional as JF
import paddle_tpu_torch as tp
import paddle_tpu_torch.incubate as TI
import paddle_tpu_torch.incubate.nn as TN
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.convert import load_fused_from_jax
from paddle_tpu_torch.incubate.nn import functional as TF
from paddle_tpu_torch.optimizer import SGD
from test_torch_threads import one_intra_op_thread  # noqa: F401

#: f32 on both sides; only sum orders differ
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _no_mesh():
    from paddle_tpu.distributed import fleet

    fleet._reset_for_tests()


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _j(a):
    return None if a is None else paddle.to_tensor(a)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x.numpy())


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


def test_the_module_has_the_reference_names():
    """The 22 public names of the JAX module, the 7 layers and the top
    level, ``graph_*``/``segment_*`` included."""
    want = {n for n in dir(JF) if not n.startswith("_")
            and callable(getattr(JF, n)) and n not in ("annotations",)}
    want -= {"apply_op", "fp8"}
    assert want == set(TF.__all__)
    assert len(TF.__all__) == 22
    layers = {"FusedLinear", "FusedDropoutAdd",
              "FusedBiasDropoutResidualLayerNorm", "FusedMultiHeadAttention",
              "FusedFeedForward", "FusedTransformerEncoderLayer",
              "FusedMultiTransformer"}
    assert layers <= set(dir(JN)) and layers == set(TN.layer.__all__)
    top = {"softmax_mask_fuse", "softmax_mask_fuse_upper_triangle",
           "identity_loss", "LookAhead", "ModelAverage", "autotune",
           "inference", "graph_send_recv", "graph_khop_sampler",
           "graph_sample_neighbors", "graph_reindex", "segment_sum",
           "segment_mean", "segment_max", "segment_min"}
    assert top <= set(dir(JI)) and top == set(TI.__all__)


# ------------------------------------------------------------ norms, rope
@pytest.mark.parametrize("case", ["plain", "residual", "bias", "no-affine",
                                  "axis1"])
def test_fused_layer_norm_matches_jax(case):
    rng = _rng(1)
    x = _f32(rng, 3, 5, 16, scale=2.0)
    r, b = _f32(rng, 3, 5, 16), _f32(rng, 16)
    w, nb = 1 + _f32(rng, 16, scale=0.2), _f32(rng, 16)
    kw = {"plain": dict(norm_bias=nb), "residual": dict(residual=r),
          "bias": dict(bias=b, residual=r, norm_bias=nb),
          "no-affine": {}, "axis1": dict(begin_norm_axis=1)}[case]
    if case == "no-affine":
        w = None
    if case == "axis1":
        w = 1 + _f32(rng, 5, 16, scale=0.2)
    want = JF.fused_layer_norm(_j(x), _j(w), **{k: _j(v) if isinstance(
        v, np.ndarray) else v for k, v in kw.items()})
    got = TF.fused_layer_norm_arrays(_t(x), _t(w), **{k: _t(v) if isinstance(
        v, np.ndarray) else v for k, v in kw.items()})
    if "residual" in kw:
        _close(got[1], want[1], 0)
        got, want = got[0], want[0]
    _close(got, want)


@pytest.mark.parametrize("neox", [True, False], ids=["neox", "pairs"])
@pytest.mark.parametrize("table", ["base", "sin-cos"])
def test_fused_rotary_position_embedding_matches_jax(neox, table):
    rng = _rng(2)
    q, k, v = (_f32(rng, 2, 6, 3, 16) for _ in range(3))
    kw = dict(use_neox_rotary_style=neox)
    if table == "sin-cos":
        ang = rng.uniform(0, 6, (6, 8)).astype(np.float32)
        kw.update(sin=np.sin(ang), cos=np.cos(ang))
    else:
        kw.update(rotary_emb_base=500.0)
    want = JF.fused_rotary_position_embedding(_j(q), _j(k), None, **{
        n: _j(a) if isinstance(a, np.ndarray) else a for n, a in kw.items()})
    got = TF.fused_rotary_position_embedding_arrays(_t(q), _t(k), None, **{
        n: _t(a) if isinstance(a, np.ndarray) else a for n, a in kw.items()})
    assert got[2] is None and want[2] is None
    for g, w in zip(got[:2], want[:2]):
        _close(g, w)
    got_v = TF.fused_rotary_position_embedding_arrays(_t(q), v=_t(v), **{
        n: _t(a) if isinstance(a, np.ndarray) else a for n, a in kw.items()})
    _close(got_v[2], JF.fused_rotary_position_embedding(_j(q), v=_j(v), **{
        n: _j(a) if isinstance(a, np.ndarray) else a
        for n, a in kw.items()})[2])
    with pytest.raises(NotImplementedError, match="position_ids"):
        TF.fused_rotary_position_embedding_arrays(_t(q), position_ids=_t(q))


# ------------------------------------------------------ activations, GEMMs
@pytest.mark.parametrize("act", ["gelu", "geglu", "swiglu", "relu"])
def test_fused_bias_act_matches_jax_with_the_tanh_gelu(act):
    rng = _rng(3)
    x, b = _f32(rng, 4, 16, scale=2.0), _f32(rng, 16)
    _close(TF.fused_bias_act_arrays(_t(x), _t(b), act_method=act),
           JF.fused_bias_act(_j(x), _j(b), act_method=act))
    if act == "gelu":
        tanh = TF.fused_bias_act_arrays(_t(x), act_method=act)
        exact = torch.nn.functional.gelu(_t(x))
        assert not torch.allclose(tanh, exact, atol=1e-4, rtol=0)


@pytest.mark.parametrize("tw", [False, True])
def test_fused_linear_and_matmul_bias_match_jax(tw):
    rng = _rng(4)
    x, b = _f32(rng, 2, 3, 8), _f32(rng, 6)
    w = _f32(rng, 6, 8) if tw else _f32(rng, 8, 6)
    _close(TF.fused_linear_arrays(_t(x), _t(w), _t(b), tw),
           JF.fused_linear(_j(x), _j(w), _j(b), tw))
    xt = np.ascontiguousarray(np.swapaxes(x, -1, -2)) if tw else x
    _close(TF.fused_matmul_bias_arrays(_t(xt), _t(w), _t(b), tw, tw),
           JF.fused_matmul_bias(_j(xt), _j(w), _j(b), tw, tw))
    for act in ("gelu", "relu", "none"):
        _close(TF.fused_linear_activation_arrays(_t(x), _t(w), _t(b), False, tw,
                                          act),
               JF.fused_linear_activation(_j(x), _j(w), _j(b), False, tw,
                                          act))


def test_dropout_ops_keep_their_rate_and_scale():
    """Not training (or rate 0): the JAX package's values. Training: each
    element kept with probability 1 - p (from the generator), scaled by
    1 / (1 - p), the same draw for the same generator state."""
    rng = _rng(5)
    x, y, r = _f32(rng, 4, 16), _f32(rng, 4, 16), _f32(rng, 4, 16)
    b, s, lb = _f32(rng, 16), 1 + _f32(rng, 16, scale=0.2), _f32(rng, 16)
    _close(TF.fused_dropout_add_arrays(_t(x), _t(y), 0.5, training=False),
           JF.fused_dropout_add(_j(x), _j(y), 0.5, training=False))
    _close(TF.fused_bias_dropout_residual_layer_norm_arrays(
               _t(x), _t(r), _t(b), _t(s), _t(lb), dropout_rate=0.0),
           JF.fused_bias_dropout_residual_layer_norm(
               _j(x), _j(r), _j(b), _j(s), _j(lb), dropout_rate=0.0))
    big = torch.ones(200_000)
    gen = torch.Generator().manual_seed(0)
    out = TF.fused_dropout_add_arrays(big, torch.zeros_like(big), 0.3,
                               generator=gen)
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.005
    torch.testing.assert_close(out[kept], torch.full_like(out[kept],
                                                          1 / 0.7))
    again = TF.fused_dropout_add_arrays(big, torch.zeros_like(big), 0.3,
                                 generator=torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    down = TF.fused_dropout_add_arrays(big, torch.zeros_like(big), 0.3,
                                mode="downscale_in_infer", generator=gen)
    assert set(down.unique().tolist()) == {0.0, 1.0}


def test_blha_get_max_len_matches_jax():
    enc, dec = np.array([[3], [0], [7]], np.int32), np.array([[1], [9], [2]],
                                                             np.int32)
    got = TF.blha_get_max_len_arrays(_t(enc), _t(dec), 3)
    want = JF.blha_get_max_len(_j(enc), _j(dec), 3)
    assert [int(g) for g in got] == [int(_np(w)) for w in want] == [7, 9]


# ------------------------------------------------------------ the LM head
@pytest.mark.parametrize("transpose_y", [True, False], ids=["VH", "HV"])
def test_fused_linear_cross_entropy_matches_jax(transpose_y):
    """Loss, ``dx`` and ``dw`` with ignored rows and a chunk that does not
    divide the rows; the int8 head off on both sides (the CPU's
    default)."""
    rng = _rng(6)
    x = _f32(rng, 3, 7, 16)
    w = _f32(rng, 40, 16, scale=0.3)
    if not transpose_y:
        w = np.ascontiguousarray(w.T)
    labels = rng.integers(0, 40, (3, 7))
    labels[0, :4] = -100
    jx, jw = paddle.to_tensor(x), paddle.to_tensor(w)
    jx.stop_gradient = False
    jw.stop_gradient = False
    jl = JF.fused_linear_cross_entropy(jx, jw, paddle.to_tensor(labels),
                                       transpose_y=transpose_y, chunk_size=8)
    jl.backward()
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    tl = TF.fused_linear_cross_entropy_arrays(tx, tw, _t(labels),
                                       transpose_y=transpose_y, chunk_size=8)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(_np(jl)), rtol=1e-6)
    _close(tx.grad, jx.grad, 1e-6)
    _close(tw.grad, jw.grad, 1e-6)


# --------------------------------------------- fused transformer functions
E, H = 32, 4


def _mha_weights(rng, layout):
    qkv = (_f32(rng, E, 3 * E, scale=0.2) if layout == "E3E"
           else _f32(rng, 3, H, E // H, E, scale=0.2))
    qb = _f32(rng, 3 * E) if layout == "E3E" else _f32(rng, 3, H, E // H)
    return dict(qkv_weight=qkv, qkv_bias=qb,
                linear_weight=_f32(rng, E, E, scale=0.2),
                linear_bias=_f32(rng, E),
                pre_ln_scale=1 + _f32(rng, E, scale=0.1),
                pre_ln_bias=_f32(rng, E), ln_scale=1 + _f32(rng, E, scale=0.1),
                ln_bias=_f32(rng, E))


def _masks(rng, kind, s=6):
    if kind == "none":
        return None
    keep = rng.random((2, 1, s, s)) < 0.7
    keep |= np.eye(s, dtype=bool)[None, None]
    return keep if kind == "bool" else np.where(keep, 0.0, -1e4).astype(
        np.float32)


@pytest.mark.parametrize("layout,pre,mask", [
    ("3HDE", True, "none"), ("E3E", False, "none"), ("3HDE", False, "bool"),
    ("E3E", True, "additive")])
def test_fused_multi_head_attention_matches_jax(layout, pre, mask):
    """Both qkv layouts, pre- and post-LayerNorm; without a mask the
    non-causal flash op (forward and backward), with one the plain
    attention; dropout off (``training=False``)."""
    rng = _rng(7)
    x = _f32(rng, 2, 6, E)
    wts = _mha_weights(rng, layout)
    m = _masks(rng, mask)
    kw = dict(pre_layer_norm=pre, training=False,
              transpose_qkv_wb=layout == "E3E",
              num_heads=H if layout == "E3E" else None)
    jx = paddle.to_tensor(x)
    jx.stop_gradient = False
    want = JF.fused_multi_head_attention(
        jx, attn_mask=_j(m), **{k: _j(v) for k, v in wts.items()}, **kw)
    tx = _t(x).requires_grad_()
    got = TF.fused_multi_head_attention_arrays(
        tx, attn_mask=_t(m), **{k: _t(v) for k, v in wts.items()}, **kw)
    _close(got, want)
    if mask == "none":
        want.square().mean().backward()
        got.square().mean().backward()
        _close(tx.grad, jx.grad, 1e-6)


def test_fused_multi_head_attention_defaults_take_the_plain_route(
        monkeypatch):
    """``training=True`` with the default rates drops attention (the plain
    route); ``training=False`` takes the flash op; ``cache_kv`` raises."""
    import paddle_tpu_torch.incubate.nn.functional as mod

    calls = []
    monkeypatch.setattr(mod, "flash_attention",
                        lambda *a, **k: calls.append(k) or mod.
                        _sdpa_plain(*a[:3]))
    rng = _rng(8)
    x = _t(_f32(rng, 2, 6, E))
    wts = {k: _t(v) for k, v in _mha_weights(rng, "3HDE").items()}
    TF.fused_multi_head_attention_arrays(x, **wts,
                                  generator=torch.Generator().manual_seed(0))
    assert calls == []
    TF.fused_multi_head_attention_arrays(x, **wts, training=False)
    assert calls == [{"causal": False}]
    with pytest.raises(NotImplementedError, match="cache_kv"):
        TF.fused_multi_head_attention_arrays(x, **wts, cache_kv=x)


@pytest.mark.parametrize("pre", [True, False], ids=["pre-ln", "post-ln"])
@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_fused_feedforward_matches_jax(act, pre):
    rng = _rng(9)
    x = _f32(rng, 2, 5, E)
    w = dict(linear1_weight=_f32(rng, E, 48, scale=0.3),
             linear2_weight=_f32(rng, 48, E, scale=0.3),
             linear1_bias=_f32(rng, 48), linear2_bias=_f32(rng, E),
             ln1_scale=1 + _f32(rng, E, scale=0.1), ln1_bias=_f32(rng, E),
             ln2_scale=1 + _f32(rng, E, scale=0.1), ln2_bias=_f32(rng, E))
    kw = dict(activation=act, pre_layer_norm=pre, training=False)
    _close(TF.fused_feedforward_arrays(_t(x), **{k: _t(v) for k, v in w.items()},
                                **kw),
           JF.fused_feedforward(_j(x), **{k: _j(v) for k, v in w.items()},
                                **kw))


@pytest.mark.parametrize("mask", ["none", "bool"])
def test_fused_multi_transformer_matches_jax(mask):
    """Two layers, pre-LayerNorm, the tanh gelu, ``[3, H, D, E]`` qkv."""
    rng = _rng(10)
    x = _f32(rng, 2, 6, E)
    L = 2
    lists = {}
    for name, shape in (("ln_scales", (E,)), ("ln_biases", (E,)),
                        ("qkv_weights", (3, H, E // H, E)),
                        ("qkv_biases", (3, H, E // H)),
                        ("linear_weights", (E, E)), ("linear_biases", (E,)),
                        ("ffn_ln_scales", (E,)), ("ffn_ln_biases", (E,)),
                        ("ffn1_weights", (E, 64)), ("ffn1_biases", (64,)),
                        ("ffn2_weights", (64, E)), ("ffn2_biases", (E,))):
        lists[name] = [_f32(rng, *shape, scale=0.2) + (
            1.0 if "scales" in name else 0.0) for _ in range(L)]
    m = _masks(rng, mask)
    got = TF.fused_multi_transformer_arrays(
        _t(x), attn_mask=_t(m), **{k: [_t(a) for a in v]
                                   for k, v in lists.items()})
    want = JF.fused_multi_transformer(
        _j(x), attn_mask=_j(m), **{k: [_j(a) for a in v]
                                   for k, v in lists.items()})
    _close(got, want)
    with pytest.raises(NotImplementedError, match="time_step"):
        TF.fused_multi_transformer_arrays(_t(x), time_step=1,
                                   **{k: [_t(a) for a in v]
                                      for k, v in lists.items()})


@pytest.mark.parametrize("norm", [True, False], ids=["norm", "no-norm"])
@pytest.mark.parametrize("topk", [1, 2])
def test_fused_moe_matches_jax(topk, norm):
    rng = _rng(11)
    x = _f32(rng, 2, 5, 16)
    e, hid = 4, 24
    w = [_f32(rng, 16, e), _f32(rng, e, 16, hid, scale=0.3),
         _f32(rng, e, hid), _f32(rng, e, hid, 16, scale=0.3),
         _f32(rng, e, 16)]
    _close(TF.fused_moe_arrays(*map(_t, [x] + w), moe_topk=topk,
                        norm_topk_prob=norm),
           JF.fused_moe(*map(_j, [x] + w), moe_topk=topk,
                        norm_topk_prob=norm))
    with pytest.raises(NotImplementedError, match="group_moe"):
        TF.fused_moe_arrays(*map(_t, [x] + w), group_moe=True)


@pytest.mark.parametrize("causal", [False, True])
def test_variable_length_attention_matches_jax(causal):
    rng = _rng(12)
    q, k, v = (_f32(rng, 3, 2, 6, 16) for _ in range(3))
    kvl = np.array([6, 3, 1], np.int32)
    m = _f32(rng, 3, 1, 6, 6, scale=0.5)
    kw = dict(causal=causal, pre_cache_length=1 if causal else 0)
    _close(TF.variable_length_memory_efficient_attention_arrays(
               _t(q), _t(k), _t(v), _t(kvl), _t(kvl), _t(m), **kw),
           JF.variable_length_memory_efficient_attention(
               _j(q), _j(k), _j(v), _j(kvl), _j(kvl), _j(m), **kw))


# ------------------------------------------------------------ paged KV
def test_paged_attention_matches_the_jax_kernel():
    rng = _rng(13)
    q = _f32(rng, 2, 4, 64)
    kp, vp = _f32(rng, 2, 6, 16, 64), _f32(rng, 2, 6, 16, 64)
    tables = np.array([[4, 1, 5], [0, 3, 2]], np.int32)
    lens = np.array([37, 20], np.int32)
    _close(TF.paged_attention_arrays(*map(_t, (q, kp, vp, tables, lens))),
           JF.paged_attention(*map(_j, (q, kp, vp, tables, lens))))


BLHA_HQ, BLHA_HKV, BLHA_D, BLHA_PAGE = 4, 2, 64, 16


def _blha_setup(rng, b=3):
    """Zeroed ``[12, Hkv, page, D]`` caches, 2 scattered pages a slot and a
    rope table ``[2, B, 32, 1, D/2]`` (cos, then sin)."""
    kc = np.zeros((12, BLHA_HKV, BLHA_PAGE, BLHA_D), np.float32)
    tables = rng.permutation(12)[:2 * b].reshape(b, 2).astype(np.int32)
    ang = rng.uniform(0, 3, (b, 32, 1, BLHA_D // 2)).astype(np.float32)
    return kc, tables, np.stack([np.cos(ang), np.sin(ang)])


def _blha_args(qkv, this, dec, tables):
    enc = np.where(dec == 0, this, 0)
    return [qkv, None, None] + [a[:, None].astype(np.int32)
                                for a in (enc, dec, this)] + [
        None, None, None, None, tables]


def _blha_port(tk, tv, args, **kw):
    return TF.block_multihead_attention_arrays(
        *[tk if j == 1 else tv if j == 2 else _t(a)
          for j, a in enumerate(args)],
        **{k: _t(a) if isinstance(a, np.ndarray) else a
           for k, a in kw.items()})


def test_block_multihead_attention_matches_jax():
    """A prefill of 5 and 9 tokens, then a decode step (the paged kernel)
    with slot 0 finished, over scattered pages with GQA
    4/2 and ``rope_emb`` (neox halves; the interleaved pairs are
    ``_apply_rotary``'s, held by the rope test): both outputs and both
    caches after each call equal the JAX package's; the port's caches are
    the tensors given, written in place."""
    rng = _rng(14)
    kc, tables, rope = _blha_setup(rng, b=2)
    width = (BLHA_HQ + 2 * BLHA_HKV) * BLHA_D
    tk, tv = _t(kc.copy()), _t(kc.copy())
    jk, jv = _j(kc), _j(kc)
    kw = dict(rope_emb=rope, block_size=BLHA_PAGE, use_neox_style=True)
    for this, dec in ((np.array([5, 9]), np.zeros(2, np.int64)),
                      (np.array([0, 1]), np.array([5, 9]))):
        qkv = _f32(rng, int(this.sum()), width)
        args = _blha_args(qkv, this, dec, tables)
        tout, _, tk2, tv2 = _blha_port(tk, tv, args, **kw)
        jout, _, jk, jv = JF.block_multihead_attention(
            *[jk if j == 1 else jv if j == 2 else _j(a)
              for j, a in enumerate(args)],
            **{k: _j(a) if isinstance(a, np.ndarray) else a
               for k, a in kw.items()})
        assert tk2 is tk and tv2 is tv
        assert tout.shape == (int(this.sum()), BLHA_HQ * BLHA_D)
        _close(tout, jout)
        _close(tk, jk, 1e-6)
        _close(tv, jv, 1e-6)
    with pytest.raises(NotImplementedError, match="quantization"):
        TF.block_multihead_attention_arrays(
            _t(qkv), tk, tv, *[_t(a) for a in args[3:]],
            cache_k_quant_scales=torch.ones(2))


def test_block_multihead_attention_tgt_mask_decode_is_dense_attention():
    """A decode step under ``tgt_mask`` (the plain dense gather) equals
    attention over each live slot's first ``len + 1`` cached rows with the
    mask added, as the reference's tests hold it (dense causal
    attention), after a prefill; a finished slot gives no row."""
    rng = _rng(15)
    kc, tables, rope = _blha_setup(rng)
    d, width = BLHA_D, (BLHA_HQ + 2 * BLHA_HKV) * BLHA_D
    tk, tv = _t(kc.copy()), _t(kc.copy())
    lens = np.array([5, 9, 3])
    _blha_port(tk, tv, _blha_args(_f32(rng, 17, width), lens,
                                  np.zeros(3, np.int64), tables))
    this = np.array([1, 0, 1])
    qkv = _f32(rng, 2, width)
    tm = _f32(rng, 3, 1, 1, 2 * BLHA_PAGE, scale=0.5)
    out, _, _, _ = _blha_port(tk, tv, _blha_args(qkv, this, lens, tables),
                              rope_emb=rope, tgt_mask=tm,
                              use_neox_style=True)
    rows = _t(qkv).reshape(2, -1, d)
    for row, slot in enumerate((0, 2)):
        pos = torch.tensor([lens[slot]])
        rot = [TF._apply_rotary(x, _t(rope[1])[slot, pos],
                                _t(rope[0])[slot, pos], True)
               for x in (rows[row:row + 1, :BLHA_HQ],
                         rows[row:row + 1, BLHA_HQ:BLHA_HQ + BLHA_HKV])]
        q, k_new = rot[0][0], rot[1][0]
        pages = torch.from_numpy(tables[slot]).long()
        k = tk[pages].transpose(0, 1).reshape(BLHA_HKV, -1, d)
        v = tv[pages].transpose(0, 1).reshape(BLHA_HKV, -1, d)
        n = lens[slot] + 1
        torch.testing.assert_close(k[:, n - 1], k_new, atol=0, rtol=0)
        k, v = (t[:, :n].repeat_interleave(BLHA_HQ // BLHA_HKV, 0)
                for t in (k, v))
        logits = torch.einsum("hd,hnd->hn", q / d ** 0.5, k) + _t(
            tm[slot, 0, 0, :n])
        want = torch.einsum("hn,hnd->hd", torch.softmax(logits, -1), v)
        _close(out[row], want.reshape(-1))


# ------------------------------------------------------------ the layers
def _carry(jm, tm, seed):
    """Seeded numpy parameters into the JAX layer, then by name into the
    port's."""
    rng = _rng(seed)
    sd = {k: (0.3 * rng.standard_normal(tuple(v.shape)) + (
        1.0 if "ln_scale" in k else 0.0)).astype(np.float32)
        for k, v in jm.state_dict().items()}
    jm.set_state_dict({k: paddle.to_tensor(a) for k, a in sd.items()})
    load_fused_from_jax(sd, tm)


@pytest.fixture
def _cpu_place():
    prev = (getattr(tdevice._state, "device", None),
            getattr(tdevice._state, "place", None))
    tp.set_device("cpu")
    yield
    tdevice._state.device, tdevice._state.place = prev


def _tt(a):
    return None if a is None else tp.to_tensor(a)


LAYERS = {
    "FusedLinear": (lambda m: m.FusedLinear(E, 24), ((2, 3, E),)),
    "FusedLinear-T": (lambda m: m.FusedLinear(E, 24, transpose_weight=True),
                      ((2, 3, E),)),
    "FusedDropoutAdd": (lambda m: m.FusedDropoutAdd(0.5),
                        ((2, 3, E), (2, 3, E))),
    "FusedBiasDropoutResidualLayerNorm": (
        lambda m: m.FusedBiasDropoutResidualLayerNorm(E, 0.5),
        ((2, 3, E), (2, 3, E))),
    "FusedMultiHeadAttention": (
        lambda m: m.FusedMultiHeadAttention(E, H, normalize_before=True),
        ((2, 6, E),)),
    "FusedFeedForward-gelu": (
        lambda m: m.FusedFeedForward(E, 48, activation="gelu"),
        ((2, 6, E),)),
    "FusedTransformerEncoderLayer": (
        lambda m: m.FusedTransformerEncoderLayer(E, H, 48,
                                                 activation="gelu"),
        ((2, 6, E),)),
    "FusedMultiTransformer": (
        lambda m: m.FusedMultiTransformer(E, H, 48, num_layers=2),
        ((2, 6, E),)),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_fused_layers_match_jax(name, _cpu_place):
    """Each layer in eval mode (no dropout) on parameters carried by name,
    ``[in, out]`` on both sides; the layers' gelu is the exact erf form."""
    make, shapes = LAYERS[name]
    jm, tm = make(JN), make(TN)
    jm.eval()
    tm.eval()
    if list(tm.state_dict()):
        _carry(jm, tm, seed=15)
    for k, v in tm.state_dict().items():
        assert tuple(v.shape) == tuple(jm.state_dict()[k].shape), k
    rng = _rng(16)
    xs = [_f32(rng, *s) for s in shapes]
    _close(tm(*map(_tt, xs)), jm(*map(_j, xs)))


@pytest.mark.parametrize("mask", [False, True], ids=["flash", "masked"])
def test_fused_encoder_layer_trains_like_jax(mask, _cpu_place):
    """A ``FusedTransformerEncoderLayer`` in training at dropout 0: output
    and every parameter's gradient against the JAX layer (the non-causal
    flash op's backward without a mask, the plain attention's with one)."""
    jm = JN.FusedTransformerEncoderLayer(E, H, 48, dropout_rate=0.0,
                                         activation="gelu")
    tm = TN.FusedTransformerEncoderLayer(E, H, 48, dropout_rate=0.0,
                                         activation="gelu")
    _carry(jm, tm, seed=17)
    rng = _rng(18)
    x = _f32(rng, 2, 6, E)
    m = _masks(rng, "bool") if mask else None
    want = jm(_j(x), src_mask=_j(m))
    got = tm(_tt(x), src_mask=_tt(m))
    _close(got, want)
    want.square().mean().backward()
    got.square().mean().backward()
    jgrads = {n: p.grad for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        if jgrads[n] is None:            # pre-LayerNorm unused post-LN
            assert p.grad is None, n
        else:
            _close(p.grad, jgrads[n], 1e-6)


def test_layers_refuse_what_they_ignore(_cpu_place):
    with pytest.raises(NotImplementedError, match="need_weights"):
        TN.FusedMultiHeadAttention(E, H, need_weights=True)
    with pytest.raises(NotImplementedError, match="ring_id"):
        TN.FusedFeedForward(E, 48, ring_id=0)
    with pytest.raises(NotImplementedError, match="cache"):
        TN.FusedMultiHeadAttention(E, H)(tp.ones([1, 2, E]), cache=1)
    lin = TN.FusedLinear(E, 8, bias_attr=False)
    assert lin.bias is None and lin(tp.ones([1, E])).shape == [1, 8]


# ------------------------------------------------------------ top level
def test_top_level_ops_match_jax():
    rng = _rng(19)
    x, m = _f32(rng, 2, 3, 5, 5), _f32(rng, 2, 1, 5, 5)
    _close(TI.softmax_mask_fuse(_t(x), _t(m)),
           JI.softmax_mask_fuse(_j(x), _j(m)))
    _close(TI.softmax_mask_fuse_upper_triangle(_t(x)),
           JI.softmax_mask_fuse_upper_triangle(_j(x)))
    for red in ("none", "sum", "mean", 0, 1, 2):
        _close(TI.identity_loss(_t(x), red), JI.identity_loss(_j(x), red))
    assert TI.autotune() is None
    with pytest.raises(NotImplementedError):
        TI.inference()


def test_lookahead_and_model_average_match_jax():
    """Six SGD steps of a linear model under ``LookAhead(alpha=0.5, k=2)``,
    ``ModelAverage`` over the same steps: parameters after every step,
    the averaged parameters inside ``apply()`` and the live ones after."""
    rng = _rng(20)
    x, y = _f32(rng, 8, 4), _f32(rng, 8, 3)
    w0, b0 = _f32(rng, 4, 3), _f32(rng, 3)
    jlin = paddle.nn.Linear(4, 3)
    jlin.set_state_dict({"weight": paddle.to_tensor(w0),
                         "bias": paddle.to_tensor(b0)})
    jopt = JI.LookAhead(paddle.optimizer.SGD(
        learning_rate=0.1, parameters=jlin.parameters()), alpha=0.5, k=2)
    javg = JI.ModelAverage(parameters=jlin.parameters())
    tw = torch.nn.Parameter(_t(w0.copy()))
    tb = torch.nn.Parameter(_t(b0.copy()))
    topt = TI.LookAhead(SGD([tw, tb], lr=0.1), alpha=0.5, k=2)
    tavg = TI.ModelAverage(parameters=[tw, tb])
    for _ in range(6):
        jl = (jlin(_j(x)) - _j(y)).square().mean()
        jl.backward()
        jopt.step()
        jopt.clear_grad()
        javg.step()
        tl = (_t(x) @ tw + tb - _t(y)).square().mean()
        tl.backward()
        topt.step()
        topt.clear_grad()
        tavg.step()
        np.testing.assert_allclose(tl.item(), float(_np(jl)), rtol=1e-6)
        _close(tw, jlin.weight, 1e-6)
        _close(tb, jlin.bias, 1e-6)
    live = tw.detach().clone()
    with tavg.apply(), javg.apply():
        _close(tw, jlin.weight, 1e-6)
        assert not torch.equal(tw, live)
    assert torch.equal(tw, live)
    _close(tw, jlin.weight, 1e-6)
