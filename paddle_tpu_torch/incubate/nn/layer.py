"""The incubate fused layers as ``nn.Layer`` s on the port's ``Tensor``.

Counterpart of ``paddle_tpu/incubate/nn/layer.py:15-201``: the same
classes, constructor arguments, parameter names and shapes (weights
``[in, out]``, as ``create_parameter`` makes them, so a JAX layer's
parameters cross by name without a transpose:
``convert.load_fused_from_jax``), and the same forward, written on
the Paddle surface as the reference writes it:

- LayerNorm is ``nn.functional.layer_norm`` over the last axis and the
  activations are paddle's by name (``gelu`` is the exact erf form),
  where the functional ops of ``incubate.nn.functional`` use the tanh
  gelu and an f32 LayerNorm, as the JAX package's do;
- ``FusedMultiHeadAttention`` attends through
  ``nn.functional.scaled_dot_product_attention``: the non-causal flash
  kernels without ``attn_mask`` and without active attention dropout
  (``training`` with ``attn_dropout_rate > 0``), the plain attention
  otherwise;
- dropout is ``nn.functional.dropout`` (the device's default generator).

Parameters are made by ``create_parameter`` on the current place: weights
XavierUniform, biases 0, LayerNorm scales 1, unless a ``*_attr`` says
otherwise. Every ``*_attr`` is passed to ``create_parameter`` (its
initializer, name, ``learning_rate``, ``regularizer``, ``trainable``),
where the reference reads only ``FusedLinear``'s and ignores the others;
``FusedTransformerEncoderLayer`` hands its ``weight_attr`` to every weight
of its two sublayers and its ``bias_attr`` to every bias. ``bias_attr=False``
leaves ``FusedLinear``'s bias out. The arguments the reference accepts and
ignores (``nranks``/``ring_id``, ``kdim``/``vdim``, ``need_weights``,
``cache``) raise ``NotImplementedError`` when set.
"""
from __future__ import annotations

from ...nn import functional as F
from ...nn.initializer import Constant
from ...nn.layer.container import LayerList
from ...nn.layer.layers import Layer
from . import functional as FF
from .functional import _refuse

__all__ = ["FusedBiasDropoutResidualLayerNorm", "FusedDropoutAdd",
           "FusedFeedForward", "FusedLinear", "FusedMultiHeadAttention",
           "FusedMultiTransformer", "FusedTransformerEncoderLayer"]

_ONE = Constant(1.0)


class FusedLinear(Layer):
    """``x @ weight + bias``, weight ``[in, out]`` (``[out, in]`` with
    ``transpose_weight``); ``bias_attr=False`` leaves the bias out."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, transpose_weight=False, name=None):
        super().__init__()
        self.transpose_weight = transpose_weight
        shape = ([out_features, in_features] if transpose_weight
                 else [in_features, out_features])
        self.weight = self.create_parameter(shape, attr=weight_attr)
        self.bias = (None if bias_attr is False else
                     self.create_parameter([out_features], attr=bias_attr,
                                           is_bias=True))

    def forward(self, x):
        return FF.fused_linear(x, self.weight, self.bias,
                               self.transpose_weight)


class FusedDropoutAdd(Layer):
    """``dropout(x) + y``."""

    def __init__(self, p=0.5, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.mode = mode

    def forward(self, x, y):
        return FF.fused_dropout_add(x, y, self.p, self.training, self.mode)


class FusedBiasDropoutResidualLayerNorm(Layer):
    """``layer_norm(dropout(x + linear_bias) + residual)``."""

    def __init__(self, embed_dim, dropout_rate=0.5, weight_attr=None,
                 bias_attr=None, epsilon=1e-5, name=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.epsilon = epsilon
        self.linear_bias = self.create_parameter([embed_dim], attr=bias_attr,
                                                 is_bias=True)
        self.ln_scale = self.create_parameter(
            [embed_dim], attr=weight_attr, default_initializer=_ONE)
        self.ln_bias = self.create_parameter([embed_dim], attr=bias_attr,
                                             is_bias=True)

    def forward(self, x, residual):
        h = F.dropout(x + self.linear_bias, self.dropout_rate,
                      training=self.training)
        return F.layer_norm(h + residual, [h.shape[-1]], self.ln_scale,
                            self.ln_bias, self.epsilon)


class FusedMultiHeadAttention(Layer):
    """Self-attention block: optional pre-LayerNorm, ``qkv_weight [E, 3E]``
    and ``qkv_bias [3E]``, non-causal attention over ``num_heads`` heads,
    ``linear_weight [E, E]`` and ``linear_bias``, dropout, the residual,
    the post-LayerNorm without ``normalize_before``."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5,
                 nranks=1, ring_id=-1, name=None):
        super().__init__()
        _refuse("FusedMultiHeadAttention", kdim=(kdim, None),
                vdim=(vdim, None), need_weights=(need_weights, False),
                nranks=(nranks, 1), ring_id=(ring_id, -1))
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self.normalize_before = normalize_before
        self.epsilon = epsilon
        self.qkv_weight = self.create_parameter([embed_dim, 3 * embed_dim],
                                                attr=qkv_weight_attr)
        self.qkv_bias = self.create_parameter(
            [3 * embed_dim], attr=qkv_bias_attr, is_bias=True)
        self.linear_weight = self.create_parameter(
            [embed_dim, embed_dim], attr=linear_weight_attr)
        self.linear_bias = self.create_parameter(
            [embed_dim], attr=linear_bias_attr, is_bias=True)
        self.pre_ln_scale = self.create_parameter(
            [embed_dim], attr=pre_ln_scale_attr, default_initializer=_ONE)
        self.pre_ln_bias = self.create_parameter(
            [embed_dim], attr=pre_ln_bias_attr, is_bias=True)
        self.ln_scale = self.create_parameter(
            [embed_dim], attr=ln_scale_attr, default_initializer=_ONE)
        self.ln_bias = self.create_parameter([embed_dim], attr=ln_bias_attr,
                                             is_bias=True)

    def forward(self, query, attn_mask=None, cache=None):
        _refuse("FusedMultiHeadAttention.forward", cache=(cache, None))
        x = query
        if self.normalize_before:
            x = F.layer_norm(x, [self.embed_dim], self.pre_ln_scale,
                             self.pre_ln_bias, self.epsilon)
        b, s, _ = x.shape
        hd = self.embed_dim // self.num_heads
        qkv = x.matmul(self.qkv_weight) + self.qkv_bias
        q, k, v = (t.reshape([b, s, self.num_heads, hd])
                   for t in qkv.split(3, axis=-1))
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.attn_dropout_rate,
            is_causal=False, training=self.training)
        out = out.reshape([b, s, self.embed_dim])
        out = out.matmul(self.linear_weight) + self.linear_bias
        out = query + F.dropout(out, self.dropout_rate,
                                training=self.training)
        if not self.normalize_before:
            out = F.layer_norm(out, [self.embed_dim], self.ln_scale,
                               self.ln_bias, self.epsilon)
        return out


class FusedFeedForward(Layer):
    """FFN block: optional pre-LayerNorm, ``act(x @ linear1_weight +
    linear1_bias)`` (paddle's activation by name), dropout,
    ``linear2_weight``/``linear2_bias``, dropout, the residual, the
    post-LayerNorm without ``normalize_before`` (one ``ln_scale``/``ln_bias``
    either way, made from the ``ln1_*`` attrs)."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None,
                 ln2_bias_attr=None, nranks=1, ring_id=-1, name=None):
        super().__init__()
        _refuse("FusedFeedForward", nranks=(nranks, 1), ring_id=(ring_id, -1))
        self.d_model = d_model
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = (dropout_rate if act_dropout_rate is None
                                 else act_dropout_rate)
        self.activation = activation
        self.normalize_before = normalize_before
        self.epsilon = epsilon
        self.linear1_weight = self.create_parameter(
            [d_model, dim_feedforward], attr=linear1_weight_attr)
        self.linear1_bias = self.create_parameter(
            [dim_feedforward], attr=linear1_bias_attr, is_bias=True)
        self.linear2_weight = self.create_parameter(
            [dim_feedforward, d_model], attr=linear2_weight_attr)
        self.linear2_bias = self.create_parameter(
            [d_model], attr=linear2_bias_attr, is_bias=True)
        self.ln_scale = self.create_parameter(
            [d_model], attr=ln1_scale_attr, default_initializer=_ONE)
        self.ln_bias = self.create_parameter([d_model], attr=ln1_bias_attr,
                                             is_bias=True)

    def forward(self, src, cache=None):
        _refuse("FusedFeedForward.forward", cache=(cache, None))
        x = src
        if self.normalize_before:
            x = F.layer_norm(x, [self.d_model], self.ln_scale, self.ln_bias,
                             self.epsilon)
        act = getattr(F, self.activation)
        h = act(x.matmul(self.linear1_weight) + self.linear1_bias)
        h = F.dropout(h, self.act_dropout_rate, training=self.training)
        h = h.matmul(self.linear2_weight) + self.linear2_bias
        h = F.dropout(h, self.dropout_rate, training=self.training)
        out = src + h
        if not self.normalize_before:
            out = F.layer_norm(out, [self.d_model], self.ln_scale,
                               self.ln_bias, self.epsilon)
        return out


class FusedTransformerEncoderLayer(Layer):
    """``FusedMultiHeadAttention`` (``fused_attn``) then
    ``FusedFeedForward`` (``ffn``)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=(dropout_rate if attn_dropout_rate is None
                               else attn_dropout_rate),
            normalize_before=normalize_before, qkv_weight_attr=weight_attr,
            qkv_bias_attr=bias_attr, linear_weight_attr=weight_attr,
            linear_bias_attr=bias_attr)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before,
            linear1_weight_attr=weight_attr, linear1_bias_attr=bias_attr,
            linear2_weight_attr=weight_attr, linear2_bias_attr=bias_attr)

    def forward(self, src, src_mask=None, cache=None):
        _refuse("FusedTransformerEncoderLayer.forward", cache=(cache, None))
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))


class FusedMultiTransformer(Layer):
    """``num_layers`` ``FusedTransformerEncoderLayer`` s (``layers``), the
    context (prefill) form; ``caches`` raise."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu", normalize_before=True,
                 num_layers=1, nranks=1, ring_id=-1, name=None):
        super().__init__()
        _refuse("FusedMultiTransformer", nranks=(nranks, 1),
                ring_id=(ring_id, -1))
        self.layers = LayerList([
            FusedTransformerEncoderLayer(
                embed_dim, num_heads, dim_feedforward, dropout_rate,
                activation, normalize_before=normalize_before)
            for _ in range(num_layers)])

    def forward(self, src, attn_mask=None, caches=None):
        _refuse("FusedMultiTransformer.forward", caches=(caches, None))
        x = src
        for layer in self.layers:
            x = layer(x, src_mask=attn_mask)
        return x
