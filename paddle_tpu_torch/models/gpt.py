"""Decoder-only transformer family (GPT / LLaMA style) in PyTorch.

Counterpart of ``paddle_tpu/models/gpt.py``: the config, the pure
functions every consumer shares (rope, rms norm, plain attention), and
two module trees:

- ``GPTForCausalLM`` (serving): per-layer modules with the JAX package's
  state-dict names (``model.layers.{i}.attn.q_proj.weight`` ...) and
  ``torch.nn.Linear`` weights ``[out, in]``; ``convert.py`` owns the
  transpose from the JAX package's ``[in, out]``.
- ``GPTForCausalLMPipe`` (training): the flagship ``StackedDecoder`` with
  the JAX package's stacked ``[L, in, out]`` weights, the block
  ``_block_pure`` on its single-device path (rms norm and flash attention
  kernels, ``swiglu_down`` where the JAX package's route takes it),
  recompute per block (full, or selective by the reference's anchor
  names), the tied head and the chunked-CE loss. Layers run as a Python
  loop; the JAX package's scan has no counterpart here.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import resolve_device
from ..memory.remat import anchor, parse_save_names, split_quant_entries
from ..nn.functional.fused_cross_entropy import chunked_lm_loss_arrays
from ..nn.norm import RMSNorm as PlainRMSNorm
from ..ops.kernels.flash_attention import flash_attention
from ..ops.kernels.rms_norm import rms_norm
from ..ops.kernels.swiglu_down import swiglu_down, swiglu_down_supported

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, num_kv_heads=None, intermediate_size=None,
                 max_seq_len=2048, norm_type="rmsnorm", act="swiglu",
                 rope=True, dropout=0.0, tie_embeddings=True,
                 dtype="float32", recompute=False, recompute_policy="full",
                 head_chunk=None):
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
        # recompute: rerun each block in backward (torch.utils.checkpoint)
        # under recompute_policy "full", "dots", "attn", "attn_ffn" or
        # "names:<anchors>" (_resolve_remat)
        self.recompute = recompute
        self.recompute_policy = recompute_policy
        # vocab chunk of the chunked CE head (None = 8192)
        self.head_chunk = head_chunk


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
        raise NotImplementedError("dropout is not supported (the JAX "
                                  "StackedDecoder refuses it too)")


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


# ---------------------------------------------------------------------------
# Training path: the JAX package's flagship GPTForCausalLMPipe on one device
# ---------------------------------------------------------------------------
def compute_loss(hidden, weight, labels, *, config=None, transpose_y=True,
                 ignore_index=-100, mode="chunked"):
    """LM-head matmul + CE (``paddle_tpu/models/gpt.py:93``).

    - ``chunked`` (the default): the chunked-CE head, whose f32
      ``[tokens, vocab]`` logits never exist whole;
    - ``dense``: full logits and ``F.cross_entropy``, the parity oracle.

    The vocab-sharded and int8 heads are not ported yet (ROADMAP A.4).
    """
    if mode == "chunked":
        return chunked_lm_loss_arrays(
            hidden, weight, labels, transpose_y=transpose_y,
            vocab_chunk=getattr(config, "head_chunk", None),
            ignore_index=ignore_index)
    if mode == "dense":
        logits = hidden @ (weight.t() if transpose_y else weight)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                               labels.reshape(-1).long(),
                               ignore_index=ignore_index)
    raise ValueError(f"compute_loss mode {mode!r}: expected chunked or dense")


def _rope_pure(x, base=10000.0):
    """Neox-style rope on [B, S, H, D] at positions 0..S-1."""
    pos = torch.zeros(x.shape[0], dtype=torch.long, device=x.device)
    return _rope_at_positions(x, pos, base)


def _block_pure(p, x, num_heads, save=frozenset()):
    """One decoder block on tensors, ``p = (ln1, wq, wk, wv, wo, ln2, wg,
    wu, wd)`` with weights ``[in, out]`` (``models/gpt.py:663-809`` on its
    single-device path): rms -> q/k/v -> rope -> flash attention -> o-proj
    + residual -> rms -> gate/up -> ``swiglu_down`` (the unfused seam where
    ``swiglu_down_supported`` refuses the shapes). The reference's
    ``_sdpa_pure`` dispatch is the flash wrapper's device route: the
    kernel on CUDA tensors, its plain version on CPU tensors.

    ``save``: the anchors the active remat policy keeps. They are the
    reference's ``checkpoint_name`` tags at the same points: ``attn_q``,
    ``attn_k``, ``attn_v`` after rope; ``resid_mid``, ``ln2_out``,
    ``ffn_gate``, ``ffn_up``; ``ffn_out`` on the unfused FFN only.
    ``attn_res``/``attn_lse`` are the flash op's outputs, which the policy
    keeps by op. ``attn_out`` is never tagged: attention here is always the
    flash op, and the reference tags it only off its Pallas path."""
    ln1, wq, wk, wv, wo, ln2, wg, wu, wd = p
    b, s, hdim = x.shape
    hd = hdim // num_heads
    h = _rms_pure(x, ln1)
    q = (h @ wq).reshape(b, s, -1, hd)
    k = (h @ wk).reshape(b, s, -1, hd)
    v = (h @ wv).reshape(b, s, -1, hd)
    q = anchor(_rope_pure(q), "attn_q", save)
    k = anchor(_rope_pure(k), "attn_k", save)
    v = anchor(v, "attn_v", save)
    o = flash_attention(q, k, v, causal=True).reshape(b, s, -1)
    x = anchor(x + o @ wo, "resid_mid", save)
    h2 = anchor(_rms_pure(x, ln2), "ln2_out", save)
    gate = anchor(h2 @ wg, "ffn_gate", save)
    up = anchor(h2 @ wu, "ffn_up", save)
    if swiglu_down_supported(gate.shape, wd.shape):
        return x + swiglu_down(gate, up, wd)
    return x + anchor(F.silu(gate) * up, "ffn_out", save) @ wd


#: the anchors of the coarse policies (``models/gpt.py:882-887``)
_POLICY_NAMES = {"attn": ("attn_out", "attn_res", "attn_lse"),
                 "attn_ffn": ("attn_out", "attn_res", "attn_lse", "ffn_out")}


def _resolve_remat(cfg):
    """The reference's policy parser (``models/gpt.py:858-888``) ->
    ``None`` for "full" (save nothing), else ``(save names, dots)``:

    - ``names:<list>``: the listed anchors (``save_only_these_names``); a
      name the path does not tag saves nothing;
    - ``attn`` / ``attn_ffn``: the names of ``_POLICY_NAMES``;
    - ``dots``: the outputs of the 2-D matmuls
      (``dots_with_no_batch_dims_saveable``).

    ``quant:`` GEMM sites and ``int8:`` saves are not ported and raise."""
    pol = cfg.recompute_policy
    if pol == "full":
        return None
    if pol == "dots":
        return frozenset(), True
    if pol in _POLICY_NAMES:
        return frozenset(_POLICY_NAMES[pol]), False
    if isinstance(pol, str) and pol.startswith("names:"):
        spec, sites = split_quant_entries(pol[len("names:"):])
        if sites:
            raise NotImplementedError(
                f"recompute_policy {pol!r}: quant: GEMM sites "
                f"{sorted(sites)} need the quantized compute path, which is "
                "not ported yet (ROADMAP A.9)")
        save, int8 = parse_save_names(spec)
        if int8:
            raise NotImplementedError(
                f"recompute_policy {pol!r}: int8: saves {sorted(int8)} "
                "(memory/int8_ckpt.py int8_checkpoint) are not ported yet "
                "(ROADMAP A.3)")
        return frozenset(save), False
    raise ValueError(f"unknown recompute_policy {pol!r}")


def _selective_policy(save, dots):
    """The ``torch.utils.checkpoint`` policy that keeps the named anchors,
    the flash op's ``(o, lse)`` when both ``attn_res`` and ``attn_lse``
    are named (one launch makes both: keeping one alone would not spare
    the forward's second launch), and under ``dots`` every ``aten.mm``;
    everything else is recomputed."""
    keep = {torch.ops.paddle_tpu_torch.remat_anchor.default}
    if {"attn_res", "attn_lse"} <= save:
        keep.add(torch.ops.paddle_tpu_torch.flash_fwd.default)
    if dots:
        keep.add(torch.ops.aten.mm.default)

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in keep
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy)


def _make_block(cfg):
    """One decoder block over (x, per-layer weights); with
    ``cfg.recompute`` each block is a non-reentrant
    ``torch.utils.checkpoint`` that reruns it in the backward, keeping
    what the selective policy names."""
    if not cfg.recompute:
        return lambda x, p: _block_pure(p, x, cfg.num_heads)
    remat = _resolve_remat(cfg)
    save, policy = frozenset(), {}
    if remat is not None:    # "full" stays a plain checkpoint
        save, dots = remat
        policy["context_fn"] = _selective_policy(save, dots)

    def block(x, *p):
        return _block_pure(p, x, cfg.num_heads, save)

    return lambda x, p: checkpoint(block, x, *p, use_reentrant=False,
                                   **policy)


#: _block_pure's parameter order, as StackedDecoder attributes
BLOCK_PARAMS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "wg", "wu", "wd")


class StackedDecoder(nn.Module):
    """Every decoder block as leading-axis-stacked parameters ``[L, ...]``
    (``models/gpt.py:1065``), in the JAX package's ``[in, out]`` layout.
    Projections start as N(0, 0.02^2), norm gains as ones. The layers run
    as a loop over ``torch.unbind`` slices, whose backward stacks the L
    per-layer gradients once. Single device: pipeline, tensor parallelism,
    ZeRO and quantized compute are not ported (ROADMAP A.9, A.10)."""

    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        _check_supported(config)
        L, h = config.num_layers, config.hidden_size
        kv = config.num_kv_heads * (h // config.num_heads)
        m = config.intermediate_size
        self.config = config
        shapes = {"ln1": (L, h), "wq": (L, h, h), "wk": (L, h, kv),
                  "wv": (L, h, kv), "wo": (L, h, h), "ln2": (L, h),
                  "wg": (L, h, m), "wu": (L, h, m), "wd": (L, m, h)}
        for name in BLOCK_PARAMS:
            t = torch.empty(shapes[name], device=device, dtype=dtype)
            with torch.no_grad():
                if name.startswith("ln"):
                    t.fill_(1.0)
                else:
                    t.normal_(0.0, 0.02)
            setattr(self, name, nn.Parameter(t))

    def apply_tp_placements(self, *args, **kwargs):
        raise NotImplementedError("tensor parallelism is not ported yet "
                                  "(ROADMAP A.10)")

    apply_pipeline_placements = apply_tp_placements

    def forward(self, x):
        block = _make_block(self.config)
        layers = zip(*(torch.unbind(getattr(self, n)) for n in BLOCK_PARAMS))
        for p in layers:
            x = block(x, p)
        return x


class GPTForCausalLMPipe(nn.Module):
    """Decoder LM with the stacked decoder core and a head tied to the
    token embedding (``models/gpt.py:1437``). ``device`` defaults to CUDA
    (raising where there is none); ``dtype`` to ``config.dtype``."""

    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        if not config.tie_embeddings:
            raise ValueError("GPTForCausalLMPipe ties the lm head to the "
                             "token embedding (tie_embeddings=False is not "
                             "supported)")
        device = resolve_device(device)
        dtype = dtype or _DTYPES[config.dtype]
        self.config = config
        self.embed_tokens = nn.Embedding(config.vocab_size,
                                         config.hidden_size, device=device,
                                         dtype=dtype)
        nn.init.xavier_uniform_(self.embed_tokens.weight)
        self.decoder = StackedDecoder(config, device, dtype)
        self.final_norm = PlainRMSNorm(config.hidden_size, device=device,
                                       dtype=dtype)

    @property
    def device(self):
        return self.embed_tokens.weight.device

    @torch.no_grad()
    def init_weights(self, generator, std=0.02):
        """Random weights from ``generator``: the embedding and every
        projection ~ N(0, std^2), norm gains 1."""
        for name, p in self.named_parameters():
            if name.endswith(("ln1", "ln2", "norm.weight")):
                p.fill_(1.0)
            else:
                p.normal_(0.0, std, generator=generator)
        return self

    def _decode_params(self):
        """Per-layer decode weights (``models/gpt.py:1497``, the serving
        contract of ``LlamaForCausalLM._decode_params``): views of the
        stacked slabs, the projections transposed to the ``[out, in]``
        layout ``F.linear`` takes. Nothing is copied, so an engine serving
        this model reads its training parameters, and an update in place
        reaches the engine's next tick."""
        d = self.decoder
        slabs = [getattr(d, n).detach() for n in BLOCK_PARAMS]
        return [{n: (w[i] if w.dim() == 2 else w[i].t())
                 for n, w in zip(BLOCK_PARAMS, slabs)}
                for i in range(self.config.num_layers)]

    def shard_lm_head(self, *args, **kwargs):
        raise NotImplementedError("the vocab-sharded head is not ported yet "
                                  "(ROADMAP A.10)")

    def _hidden(self, input_ids):
        x = self.embed_tokens(input_ids)
        return self.final_norm(self.decoder(x))

    def forward(self, input_ids):
        return self._hidden(input_ids) @ self.embed_tokens.weight.t()

    def loss(self, input_ids, labels):
        """Tied-head LM loss through the chunked-CE head: neither the f32
        logits nor their gradient exists whole."""
        return compute_loss(self._hidden(input_ids), self.embed_tokens.weight,
                            labels, config=self.config, transpose_y=True)
