"""LLaMA model family with dense-cache generation.

Counterpart of ``paddle_tpu/models/llama.py``: the architecture is the GPT
family core (rmsnorm + swiglu + rope + GQA) with LLaMA naming and presets,
plus a greedy/sampling ``generate`` loop over a dense KV cache, which the
serving tests use as their reference; ``generate(int8_weights=True)``
decodes with int8-resident projections, as the serving engine can.
``LlamaForCausalLMPipe`` is the stacked training model (config 5).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..quant import int8_linear, int8_weights_enabled, quantize_linear_int8
from .gpt import (GPTConfig, GPTForCausalLM, GPTForCausalLMPipe, GPTModel,
                  _attention_plain, _rms_pure, _rope_at_positions)

#: the projections ``generate(int8_weights=True)`` quantizes
_PROJECTIONS = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")


class LlamaConfig(GPTConfig):
    def __init__(self, **kw):
        kw.setdefault("norm_type", "rmsnorm")
        kw.setdefault("act", "swiglu")
        kw.setdefault("rope", True)
        kw.setdefault("tie_embeddings", False)
        super().__init__(**kw)


def llama_preset(size="7b", **overrides):
    presets = {
        "tiny": dict(hidden_size=256, num_layers=4, num_heads=4,
                     vocab_size=1024, max_seq_len=512),
        "7b": dict(hidden_size=4096, num_layers=32, num_heads=32,
                   vocab_size=32000, max_seq_len=4096),
        "13b": dict(hidden_size=5120, num_layers=40, num_heads=40,
                    vocab_size=32000, max_seq_len=4096),
        "70b": dict(hidden_size=8192, num_layers=80, num_heads=64,
                    num_kv_heads=8, vocab_size=32000, max_seq_len=4096,
                    intermediate_size=28672),
    }
    cfg = dict(presets[size])
    cfg.update(overrides)
    return LlamaConfig(**cfg)


class LlamaModel(GPTModel):
    """The per-layer LLaMA core (``models/llama.py:53``): ``GPTModel``."""


class LlamaForCausalLM(GPTForCausalLM):
    """LLaMA decoder LM with generation."""

    def __init__(self, config=None, device=None, dtype=None, **kw):
        if config is None:
            config = LlamaConfig(**kw)
        super().__init__(config, device=device, dtype=dtype)

    def _decode_params(self):
        """Per-layer weight dicts (references, no copies)."""
        return [
            dict(ln1=l.input_norm.weight, wq=l.attn.q_proj.weight,
                 wk=l.attn.k_proj.weight, wv=l.attn.v_proj.weight,
                 wo=l.attn.o_proj.weight, ln2=l.post_attn_norm.weight,
                 wg=l.mlp.gate_proj.weight, wu=l.mlp.up_proj.weight,
                 wd=l.mlp.down_proj.weight)
            for l in self.model.layers
        ]

    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens=32, temperature=0.0,
                 top_k=0, seed=0, int8_weights=False):
        """Greedy (temperature=0) or sampled decode with a dense KV cache.

        input_ids: [B, S] ints (tensor, array or nested list). Returns a
        long tensor [B, S + max_new_tokens] on the model's device. The
        cache [B, max_len, Hkv, D] is updated in place. The first new token
        is always the argmax, as in the JAX package.

        ``int8_weights=True`` (behind the probe of
        ``quant.int8_weights_enabled``) quantizes the 7 projection slabs
        once per call, per output column, and runs every projection as the
        int8 x int8 -> int32 GEMM, as the serving engine's int8 mode."""
        cfg = self.config
        dev = self.device
        ids = torch.as_tensor(np.asarray(input_ids), device=dev).long()
        b, s0 = ids.shape
        max_len = s0 + max_new_tokens
        hd = cfg.hidden_size // cfg.num_heads
        embed = self.model.embed_tokens.weight
        head = embed if self.lm_head is None else self.lm_head.weight
        params = self._decode_params()
        if int8_weights_enabled(int8_weights):
            params = [{n: (quantize_linear_int8(w) if n in _PROJECTIONS
                           else w) for n, w in lp.items()} for lp in params]

        def mm(x, w):
            # an exact [out, in] slab, or int8 (codes [out, in], scales)
            return int8_linear(x, w) if isinstance(w, tuple) \
                else F.linear(x, w)

        kcache = [torch.zeros(b, max_len, cfg.num_kv_heads, hd,
                              dtype=embed.dtype, device=dev)
                  for _ in params]
        vcache = [torch.zeros_like(c) for c in kcache]
        key_pos = torch.arange(max_len, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

        def forward_step(tok, pos):
            t = tok.shape[1]
            x = embed[tok]
            posv = torch.full((b,), pos, dtype=torch.long, device=dev)
            qpos = pos + torch.arange(t, device=dev)
            mask = key_pos[None, :] <= qpos[:, None]   # causal, written rows
            for li, lp in enumerate(params):
                h = _rms_pure(x, lp["ln1"])
                hkv = cfg.num_kv_heads
                q = mm(h, lp["wq"]).reshape(b, t, cfg.num_heads, hd)
                k = mm(h, lp["wk"]).reshape(b, t, hkv, hd)
                v = mm(h, lp["wv"]).reshape(b, t, hkv, hd)
                q = _rope_at_positions(q, posv)
                k = _rope_at_positions(k, posv)
                kcache[li][:, pos:pos + t] = k
                vcache[li][:, pos:pos + t] = v
                o = _attention_plain(q, kcache[li], vcache[li], mask)
                x = x + mm(o.reshape(b, t, -1), lp["wo"])
                h2 = _rms_pure(x, lp["ln2"])
                x = x + mm(F.silu(mm(h2, lp["wg"])) * mm(h2, lp["wu"]),
                           lp["wd"])
            x = _rms_pure(x, self.model.final_norm.weight)
            return F.linear(x[:, -1], head).float()

        logits = forward_step(ids, 0)
        nxt = logits.argmax(-1)
        out = [ids, nxt[:, None]]
        pos = s0
        for _ in range(max_new_tokens - 1):
            logits = forward_step(nxt[:, None], pos)
            if temperature > 0.0:
                lg = logits / temperature
                if top_k > 0:
                    kth = torch.sort(lg, -1).values[:, -top_k][:, None]
                    lg = lg.masked_fill(lg < kth, -math.inf)
                nxt = torch.multinomial(torch.softmax(lg, -1), 1,
                                        generator=gen)[:, 0]
            else:
                nxt = logits.argmax(-1)
            out.append(nxt[:, None])
            pos += 1
        return torch.cat(out, dim=1)


class LlamaForCausalLMPipe(GPTForCausalLMPipe):
    """Config 5's model class (``models/llama.py:236``): the stacked
    decoder under LLaMA's name. It keeps the Pipe's tie rule, so a
    ``llama_preset`` config (untied) raises unless ``tie_embeddings=True``
    is passed."""
