"""Decoder-only transformer family (GPT / LLaMA style) in PyTorch.

Counterpart of ``paddle_tpu/models/gpt.py``: the config, the pure
functions every consumer shares (rope, rms norm, plain attention) and the
module tree with the JAX package's state-dict names
(``model.layers.{i}.attn.q_proj.weight`` ...). Layers run as a Python loop
over modules; the JAX package's scan over stacked layers has no
counterpart here.

Projection weights are ``torch.nn.Linear`` weights, ``[out, in]``; the JAX
package keeps ``[in, out]`` and ``convert.py`` owns the transpose.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.kernels.rms_norm import rms_norm

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, num_kv_heads=None, intermediate_size=None,
                 max_seq_len=2048, norm_type="rmsnorm", act="swiglu",
                 rope=True, dropout=0.0, tie_embeddings=True,
                 dtype="float32"):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.intermediate_size = intermediate_size or (
            int(8 * hidden_size / 3 / 128 + 1) * 128 if act == "swiglu"
            else 4 * hidden_size)
        self.max_seq_len = max_seq_len
        self.norm_type = norm_type
        self.act = act
        self.rope = rope
        self.dropout = dropout
        self.tie_embeddings = tie_embeddings
        self.dtype = dtype


def _rope_at_positions(x, pos, base=10000.0):
    """Neox-style (half-split) rope on [B, T, H, D] at absolute positions:
    ``pos`` [B] holds each row's start offset. Frequencies in f32."""
    d = x.shape[-1]
    t = x.shape[1]
    p = (pos.to(x.device)[:, None]
         + torch.arange(t, device=x.device)[None, :]).float()
    inv = base ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                 device=x.device) / d)
    freqs = p[..., None] * inv                       # [B, T, d/2]
    return _rope_rotate(x, torch.sin(freqs)[:, :, None, :],
                        torch.cos(freqs)[:, :, None, :])


def _rope_rotate(x, sin, cos):
    """Apply the half-split rotation given broadcast-ready sin/cos."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _rms_pure(x, w, eps=1e-6):
    """RMS norm of the last axis, through the rms_norm kernel (its plain
    version on the CPU). The kernel applies the weight in f32 and rounds
    once; the JAX package's plain path rounds to x's type before the
    weight. They agree in f32 and differ by one rounding in bf16."""
    return rms_norm(x, w, eps)


def _attention_plain(q, k, v, mask):
    """q [B, T, Hq, D], k/v [B, S, Hkv, D], mask broadcastable to
    [B, Hq, T, S] (True = attend) -> [B, T, Hq, D]. Matmul, masked f32
    softmax, matmul, as the JAX package's einsums; kv head h serves q
    heads h*rep .. h*rep+rep-1 (``jnp.repeat`` = ``repeat_interleave``)."""
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bthd,bshd->bhts", (q * scale).float(), k.float())
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, -1)
    return torch.einsum("bhts,bshd->bthd", probs, v.float()).to(q.dtype)


def _check_supported(config):
    if (config.norm_type != "rmsnorm" or config.act != "swiglu"
            or not config.rope):
        raise NotImplementedError(
            "paddle_tpu_torch ports the rmsnorm + swiglu + rope family; "
            f"got norm_type={config.norm_type!r} act={config.act!r} "
            f"rope={config.rope!r}")
    if config.dropout:
        raise NotImplementedError("dropout waits for the training slice")


def _linear(i, o, device, dtype):
    return nn.Linear(i, o, bias=False, device=device, dtype=dtype)


class RMSNorm(nn.Module):
    def __init__(self, hidden_size, eps=1e-6, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype))

    def forward(self, x):
        return _rms_pure(x, self.weight, self.eps)


class Attention(nn.Module):
    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_heads
        self.num_kv_heads = config.num_kv_heads
        self.head_dim = h // config.num_heads
        self.q_proj = _linear(h, self.num_heads * self.head_dim, device, dtype)
        self.k_proj = _linear(h, self.num_kv_heads * self.head_dim, device,
                              dtype)
        self.v_proj = _linear(h, self.num_kv_heads * self.head_dim, device,
                              dtype)
        self.o_proj = _linear(self.num_heads * self.head_dim, h, device, dtype)

    def forward(self, x):
        b, s, _ = x.shape
        q = self.q_proj(x).reshape(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        pos = torch.zeros(b, dtype=torch.long, device=x.device)
        q, k = _rope_at_positions(q, pos), _rope_at_positions(k, pos)
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        out = _attention_plain(q, k, v, causal)
        return self.o_proj(out.reshape(b, s, -1))


class MLP(nn.Module):
    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        self.gate_proj = _linear(h, m, device, dtype)
        self.up_proj = _linear(h, m, device, dtype)
        self.down_proj = _linear(m, h, device, dtype)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class DecoderLayer(nn.Module):
    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        self.input_norm = RMSNorm(config.hidden_size, device=device,
                                  dtype=dtype)
        self.attn = Attention(config, device, dtype)
        self.post_attn_norm = RMSNorm(config.hidden_size, device=device,
                                      dtype=dtype)
        self.mlp = MLP(config, device, dtype)

    def forward(self, x):
        h = x + self.attn(self.input_norm(x))
        return h + self.mlp(self.post_attn_norm(h))


class GPTModel(nn.Module):
    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        self.config = config
        self.embed_tokens = nn.Embedding(config.vocab_size, config.hidden_size,
                                         device=device, dtype=dtype)
        self.layers = nn.ModuleList(
            [DecoderLayer(config, device, dtype)
             for _ in range(config.num_layers)])
        self.final_norm = RMSNorm(config.hidden_size, device=device,
                                  dtype=dtype)

    def forward(self, input_ids):
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            x = layer(x)
        return self.final_norm(x)


class GPTForCausalLM(nn.Module):
    """Decoder LM. ``device`` defaults to CUDA (raising where there is
    none); ``dtype`` defaults to ``config.dtype``."""

    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        _check_supported(config)
        device = resolve_device(device)
        dtype = dtype or _DTYPES[config.dtype]
        self.config = config
        self.model = GPTModel(config, device, dtype)
        self.lm_head = (None if config.tie_embeddings else
                        _linear(config.hidden_size, config.vocab_size, device,
                                dtype))

    @property
    def device(self):
        return self.model.embed_tokens.weight.device

    @torch.no_grad()
    def init_weights(self, generator, std=0.02):
        """Random weights from ``generator``: every matrix ~ N(0, std^2),
        norm gains 1."""
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, std, generator=generator)
        return self

    def forward(self, input_ids):
        hidden = self.model(input_ids)
        head = (self.model.embed_tokens.weight if self.lm_head is None
                else self.lm_head.weight)
        return F.linear(hidden, head)
