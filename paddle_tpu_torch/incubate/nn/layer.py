"""The incubate fused layers as ``torch.nn.Module`` s.

Counterpart of ``paddle_tpu/incubate/nn/layer.py``: the same classes,
constructor arguments, parameter names and shapes (weights ``[in, out]``,
as ``create_parameter`` makes them, so a JAX layer's parameters cross
without a transpose: ``convert.fused_state_dict_from_jax``), and the same
forward math:

- LayerNorm is ``F.layer_norm`` over the last axis and the activations are
  paddle's (``getattr(F, activation)``: ``gelu`` is the exact erf form),
  where the functional ops of ``incubate.nn.functional`` use the tanh
  gelu and an f32 LayerNorm, as the JAX package's do;
- ``FusedMultiHeadAttention`` attends through the non-causal flash op (the
  forward kernel, and the fused backward or the split pair in training)
  unless ``attn_mask`` is given or attention dropout is active
  (``training`` with ``attn_dropout_rate > 0``), which take the plain
  attention, as paddle's ``scaled_dot_product_attention`` routes.

Weights start XavierUniform, biases at 0 and LayerNorm scales at 1 (the
reference's ``create_parameter`` defaults), on ``device`` (default CUDA,
raising where there is none) in ``dtype`` (default float32). Dropout draws
from ``generator`` (the device's default generator when None). The
``*_attr`` arguments, ``nranks``/``ring_id``, ``kdim``/``vdim``,
``need_weights`` and ``cache``, which the reference accepts and ignores,
raise ``NotImplementedError`` when set.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...device import resolve_device
from . import functional as FF
from .functional import _attention, _dropout, _refuse

__all__ = ["FusedBiasDropoutResidualLayerNorm", "FusedDropoutAdd",
           "FusedFeedForward", "FusedLinear", "FusedMultiHeadAttention",
           "FusedMultiTransformer", "FusedTransformerEncoderLayer"]


class _FusedLayer(nn.Module):
    """Parameter creation as the reference's ``create_parameter``."""

    def __init__(self, device=None, dtype=None, generator=None):
        super().__init__()
        self._device = resolve_device(device)
        self._dtype = dtype or torch.float32
        self.generator = generator

    def _param(self, name, shape, fill=None):
        t = torch.empty(shape, device=self._device, dtype=self._dtype)
        with torch.no_grad():
            if fill is None:
                nn.init.xavier_uniform_(t)
            else:
                t.fill_(fill)
        setattr(self, name, nn.Parameter(t))

    def _drop(self, x, p):
        return _dropout(x, p, self.training, "upscale_in_train",
                        self.generator)


def _ln(x, scale, bias, eps):
    return F.layer_norm(x, scale.shape, scale, bias, eps)


class FusedLinear(_FusedLayer):
    """``x @ weight + bias``, weight ``[in, out]`` (``[out, in]`` with
    ``transpose_weight``); ``bias_attr=False`` leaves the bias out."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, transpose_weight=False, name=None,
                 device=None, dtype=None):
        super().__init__(device, dtype)
        _refuse("FusedLinear", weight_attr=(weight_attr, None),
                bias_attr=(None if bias_attr is False else bias_attr, None))
        self.transpose_weight = transpose_weight
        self._param("weight", [out_features, in_features] if transpose_weight
                    else [in_features, out_features])
        if bias_attr is False:
            self.bias = None
        else:
            self._param("bias", [out_features], 0.0)

    def forward(self, x):
        return FF.fused_linear(x, self.weight, self.bias,
                               self.transpose_weight)


class FusedDropoutAdd(_FusedLayer):
    """``dropout(x) + y``."""

    def __init__(self, p=0.5, mode="upscale_in_train", name=None,
                 device=None, generator=None):
        super().__init__(device, None, generator)
        self.p = p
        self.mode = mode

    def forward(self, x, y):
        return FF.fused_dropout_add(x, y, self.p, self.training, self.mode,
                                    generator=self.generator)


class FusedBiasDropoutResidualLayerNorm(_FusedLayer):
    """``layer_norm(dropout(x + linear_bias) + residual)``."""

    def __init__(self, embed_dim, dropout_rate=0.5, weight_attr=None,
                 bias_attr=None, epsilon=1e-5, name=None, device=None,
                 dtype=None, generator=None):
        super().__init__(device, dtype, generator)
        _refuse("FusedBiasDropoutResidualLayerNorm",
                weight_attr=(weight_attr, None), bias_attr=(bias_attr, None))
        self.dropout_rate = dropout_rate
        self.epsilon = epsilon
        self._param("linear_bias", [embed_dim], 0.0)
        self._param("ln_scale", [embed_dim], 1.0)
        self._param("ln_bias", [embed_dim], 0.0)

    def forward(self, x, residual):
        h = self._drop(x + self.linear_bias, self.dropout_rate)
        return _ln(h + residual, self.ln_scale, self.ln_bias, self.epsilon)


class FusedMultiHeadAttention(_FusedLayer):
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
                 nranks=1, ring_id=-1, name=None, device=None, dtype=None,
                 generator=None):
        super().__init__(device, dtype, generator)
        _refuse("FusedMultiHeadAttention", kdim=(kdim, None),
                vdim=(vdim, None), need_weights=(need_weights, False),
                qkv_weight_attr=(qkv_weight_attr, None),
                qkv_bias_attr=(qkv_bias_attr, None),
                linear_weight_attr=(linear_weight_attr, None),
                linear_bias_attr=(linear_bias_attr, None),
                pre_ln_scale_attr=(pre_ln_scale_attr, None),
                pre_ln_bias_attr=(pre_ln_bias_attr, None),
                ln_scale_attr=(ln_scale_attr, None),
                ln_bias_attr=(ln_bias_attr, None), nranks=(nranks, 1),
                ring_id=(ring_id, -1))
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self.normalize_before = normalize_before
        self.epsilon = epsilon
        self._param("qkv_weight", [embed_dim, 3 * embed_dim])
        self._param("qkv_bias", [3 * embed_dim], 0.0)
        self._param("linear_weight", [embed_dim, embed_dim])
        self._param("linear_bias", [embed_dim], 0.0)
        self._param("pre_ln_scale", [embed_dim], 1.0)
        self._param("pre_ln_bias", [embed_dim], 0.0)
        self._param("ln_scale", [embed_dim], 1.0)
        self._param("ln_bias", [embed_dim], 0.0)

    def forward(self, query, attn_mask=None, cache=None):
        _refuse("FusedMultiHeadAttention.forward", cache=(cache, None))
        x = query
        if self.normalize_before:
            x = _ln(x, self.pre_ln_scale, self.pre_ln_bias, self.epsilon)
        b, s, _ = x.shape
        hd = self.embed_dim // self.num_heads
        qkv = x @ self.qkv_weight + self.qkv_bias
        q, k, v = (t.reshape(b, s, self.num_heads, hd)
                   for t in qkv.chunk(3, dim=-1))
        out = _attention(q, k, v, attn_mask, self.attn_dropout_rate,
                         self.training, self.generator)
        out = out.reshape(b, s, self.embed_dim) @ self.linear_weight
        out = query + self._drop(out + self.linear_bias, self.dropout_rate)
        if not self.normalize_before:
            out = _ln(out, self.ln_scale, self.ln_bias, self.epsilon)
        return out


class FusedFeedForward(_FusedLayer):
    """FFN block: optional pre-LayerNorm, ``act(x @ linear1_weight +
    linear1_bias)`` (paddle's activation by name), dropout,
    ``linear2_weight``/``linear2_bias``, dropout, the residual, the
    post-LayerNorm without ``normalize_before`` (one ``ln_scale``/``ln_bias``
    either way)."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None,
                 ln2_bias_attr=None, nranks=1, ring_id=-1, name=None,
                 device=None, dtype=None, generator=None):
        super().__init__(device, dtype, generator)
        _refuse("FusedFeedForward",
                linear1_weight_attr=(linear1_weight_attr, None),
                linear1_bias_attr=(linear1_bias_attr, None),
                linear2_weight_attr=(linear2_weight_attr, None),
                linear2_bias_attr=(linear2_bias_attr, None),
                ln1_scale_attr=(ln1_scale_attr, None),
                ln1_bias_attr=(ln1_bias_attr, None),
                ln2_scale_attr=(ln2_scale_attr, None),
                ln2_bias_attr=(ln2_bias_attr, None), nranks=(nranks, 1),
                ring_id=(ring_id, -1))
        self.d_model = d_model
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = (dropout_rate if act_dropout_rate is None
                                 else act_dropout_rate)
        self.activation = activation
        self.normalize_before = normalize_before
        self.epsilon = epsilon
        self._param("linear1_weight", [d_model, dim_feedforward])
        self._param("linear1_bias", [dim_feedforward], 0.0)
        self._param("linear2_weight", [dim_feedforward, d_model])
        self._param("linear2_bias", [d_model], 0.0)
        self._param("ln_scale", [d_model], 1.0)
        self._param("ln_bias", [d_model], 0.0)

    def forward(self, src, cache=None):
        _refuse("FusedFeedForward.forward", cache=(cache, None))
        x = src
        if self.normalize_before:
            x = _ln(x, self.ln_scale, self.ln_bias, self.epsilon)
        act = getattr(F, self.activation)
        h = act(x @ self.linear1_weight + self.linear1_bias)
        h = self._drop(h, self.act_dropout_rate)
        h = self._drop(h @ self.linear2_weight + self.linear2_bias,
                       self.dropout_rate)
        out = src + h
        if not self.normalize_before:
            out = _ln(out, self.ln_scale, self.ln_bias, self.epsilon)
        return out


class FusedTransformerEncoderLayer(nn.Module):
    """``FusedMultiHeadAttention`` (``fused_attn``) then
    ``FusedFeedForward`` (``ffn``)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False,
                 weight_attr=None, bias_attr=None, device=None, dtype=None,
                 generator=None):
        super().__init__()
        _refuse("FusedTransformerEncoderLayer",
                weight_attr=(weight_attr, None), bias_attr=(bias_attr, None))
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=(dropout_rate if attn_dropout_rate is None
                               else attn_dropout_rate),
            normalize_before=normalize_before, **kw)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before, **kw)

    def forward(self, src, src_mask=None, cache=None):
        _refuse("FusedTransformerEncoderLayer.forward", cache=(cache, None))
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))


class FusedMultiTransformer(nn.Module):
    """``num_layers`` ``FusedTransformerEncoderLayer`` s (``layers``), the
    context (prefill) form; ``caches`` raise."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu", normalize_before=True,
                 num_layers=1, nranks=1, ring_id=-1, name=None, device=None,
                 dtype=None, generator=None):
        super().__init__()
        _refuse("FusedMultiTransformer", nranks=(nranks, 1),
                ring_id=(ring_id, -1))
        self.layers = nn.ModuleList([
            FusedTransformerEncoderLayer(
                embed_dim, num_heads, dim_feedforward, dropout_rate,
                activation, normalize_before=normalize_before,
                device=device, dtype=dtype, generator=generator)
            for _ in range(num_layers)])

    def forward(self, src, attn_mask=None, caches=None):
        _refuse("FusedMultiTransformer.forward", caches=(caches, None))
        x = src
        for layer in self.layers:
            x = layer(x, src_mask=attn_mask)
        return x
