"""Transformer layers (counterpart of ``paddle_tpu/nn/layer/transformer.py``)."""
from __future__ import annotations

import collections

from .. import functional as F
from .common import Linear, Dropout
from .norm import LayerNorm
from .container import LayerList
from .layers import Layer


def _convert_attn_mask(attn_mask, dtype):
    if attn_mask is None:
        return None
    if attn_mask.dtype == "bool":
        import paddle_tpu_torch as paddle

        zero = paddle.zeros_like(attn_mask.astype(dtype))
        neg = paddle.full_like(attn_mask.astype(dtype), -1e9)
        return paddle.where(attn_mask, zero, neg)
    return attn_mask


class MultiHeadAttention(Layer):
    """parity: nn/layer/transformer.py MultiHeadAttention.

    Input layout [batch, seq, embed]; internally [B, S, H, D] feeding
    scaled_dot_product_attention (the flash kernels on the card).
    """

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None, vdim=None, need_weights=False, weight_attr=None, bias_attr=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(kdim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def _split_heads(self, x):
        b, s, _ = x.shape
        return x.reshape([b, s, self.num_heads, self.head_dim])

    def forward(self, query, key=None, value=None, attn_mask=None, cache=None):
        key = query if key is None else key
        value = query if value is None else value
        q = self._split_heads(self.q_proj(query))
        if isinstance(cache, MultiHeadAttention.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value))
            if isinstance(cache, MultiHeadAttention.Cache):
                import paddle_tpu_torch as paddle

                k = paddle.concat([cache.k, k], axis=1)
                v = paddle.concat([cache.v, v], axis=1)
                cache = MultiHeadAttention.Cache(k, v)

        mask = _convert_attn_mask(attn_mask, q.dtype)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, dropout_p=self.dropout, training=self.training
        )
        b, s = out.shape[0], out.shape[1]
        out = out.reshape([b, s, self.embed_dim])
        out = self.out_proj(out)
        if cache is not None and not isinstance(cache, MultiHeadAttention.StaticCache):
            return out, cache
        return out

    def gen_cache(self, key, value=None, type=Cache):
        import paddle_tpu_torch as paddle

        if type == MultiHeadAttention.StaticCache:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value if value is not None else key))
            return MultiHeadAttention.StaticCache(k, v)
        b = key.shape[0]
        k = paddle.zeros([b, 0, self.num_heads, self.head_dim], key.dtype)
        return MultiHeadAttention.Cache(k, k)


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1, activation="relu", attn_dropout=None, act_dropout=None, normalize_before=False, weight_attr=None, bias_attr=None, layer_norm_eps=1e-5):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout, weight_attr=weight_attr, bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr, bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr, bias_attr)
        self.norm1 = LayerNorm(d_model, layer_norm_eps)
        self.norm2 = LayerNorm(d_model, layer_norm_eps)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        import copy

        self.layers = LayerList(
            [encoder_layer] + [copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)]
        )
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, new_cache = mod(output, src_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1, activation="relu", attn_dropout=None, act_dropout=None, normalize_before=False, weight_attr=None, bias_attr=None, layer_norm_eps=1e-5):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout, weight_attr=weight_attr, bias_attr=bias_attr)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout, weight_attr=weight_attr, bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr, bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr, bias_attr)
        self.norm1 = LayerNorm(d_model, layer_norm_eps)
        self.norm2 = LayerNorm(d_model, layer_norm_eps)
        self.norm3 = LayerNorm(d_model, layer_norm_eps)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None, cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
            incremental_cache = None
        else:
            tgt, incremental_cache = self.self_attn(tgt, tgt, tgt, tgt_mask, cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
            static_cache = None
        else:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask, cache[1])
            static_cache = cache[1]
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incremental_cache, static_cache))

    def gen_cache(self, memory):
        incremental = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(memory, memory, MultiHeadAttention.StaticCache)
        return incremental, static


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        import copy

        self.layers = LayerList(
            [decoder_layer] + [copy.deepcopy(decoder_layer) for _ in range(num_layers - 1)]
        )
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None, cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, new_cache = mod(output, memory, tgt_mask, memory_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        cache = [layer.gen_cache(memory) for layer in self.layers]
        if do_zip:
            cache = list(zip(*cache))
        return cache


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6, num_decoder_layers=6, dim_feedforward=2048, dropout=0.1, activation="relu", attn_dropout=None, act_dropout=None, normalize_before=False, weight_attr=None, bias_attr=None, custom_encoder=None, custom_decoder=None):
        super().__init__()
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(d_model, nhead, dim_feedforward, dropout, activation, attn_dropout, act_dropout, normalize_before, weight_attr, bias_attr)
            norm = LayerNorm(d_model) if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers, norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(d_model, nhead, dim_feedforward, dropout, activation, attn_dropout, act_dropout, normalize_before, weight_attr, bias_attr)
            norm = LayerNorm(d_model) if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers, norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None, memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length):
        import paddle_tpu_torch as paddle

        return paddle.tril(paddle.ones([length, length], "float32")).log()
