"""Decoder-only transformer family (GPT / LLaMA style) in PyTorch.

Counterpart of ``paddle_tpu/models/gpt.py``: the config, the pure
functions every consumer shares (rope, rms norm, plain attention), and
two module trees:

- ``GPTForCausalLM`` (serving): per-layer modules with the JAX package's
  state-dict names (``model.layers.{i}.attn.q_proj.weight`` ...) and
  ``torch.nn.Linear`` weights ``[out, in]``; ``convert.py`` owns the
  transpose from the JAX package's ``[in, out]``. An rmsnorm + swiglu +
  rope stack runs its layers through the training model's block
  (``GPTModel._shared_block_eligible``), any other through its modules.
- ``GPTForCausalLMPipe`` (training): the flagship ``StackedDecoder`` with
  the JAX package's stacked ``[L, in, out]`` weights, the block
  ``_block_pure`` on its single-device path (rms norm and flash attention
  kernels, ``swiglu_down`` where the JAX package's route takes it),
  recompute per block (full, or selective by the reference's anchor
  names, with ``int8:`` saves), the scaled fp8/int8 GEMMs of ``quant:``
  sites with their delayed-scaling ``quant_amax`` buffer, the tied head
  and the chunked-CE loss (f32 or int8 logits). Layers run as a Python
  loop; the JAX package's scan has no counterpart here.
"""
from __future__ import annotations

import contextlib
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..amp import autocast, is_auto_cast_enabled
from ..device import resolve_device
from .. import quant as _quant
from ..memory.int8_ckpt import int8_checkpoint, quantize_rows_int8
from ..memory.remat import anchor, parse_save_names, split_quant_entries
from ..nn.functional.fused_cross_entropy import (chunked_lm_loss_arrays,
                                                 record_head_mode)
from ..nn.norm import LayerNorm
from ..nn.norm import RMSNorm as PlainRMSNorm
from ..ops.kernels.add_rms_norm import add_rms_norm
from ..ops.kernels.flash_attention import flash_attention
from ..ops.kernels.rms_norm import rms_norm
from ..ops.kernels.swiglu_down import swiglu_down, swiglu_down_supported

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, num_kv_heads=None, intermediate_size=None,
                 max_seq_len=2048, norm_type="rmsnorm", act="swiglu",
                 rope=True, dropout=0.0, tie_embeddings=True,
                 dtype="float32", recompute=False, recompute_policy="full",
                 head_chunk=None, int8_ffn=False, fused_addrms=False):
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
        # the stacked block's FFN with int8-saved gate/up (_FFNInt8; the
        # reference's PTPU_INT8_FFN) and its attn->norm seam through the
        # add_rms_norm kernel (the reference's PTPU_FUSED_ADDRMS)
        self.int8_ffn = int8_ffn
        self.fused_addrms = fused_addrms


def llama_config(size="7b", **overrides):
    """A ``GPTConfig`` of the reference's presets (``paddle_tpu/models/
    gpt.py:80``): "tiny", "125m", "350m", "1.3b" or "7b", with
    ``overrides``."""
    presets = {
        "tiny": dict(hidden_size=256, num_layers=4, num_heads=4,
                     vocab_size=1024, max_seq_len=512),
        "125m": dict(hidden_size=768, num_layers=12, num_heads=12,
                     vocab_size=50304),
        "350m": dict(hidden_size=1024, num_layers=24, num_heads=16,
                     vocab_size=50304),
        "1.3b": dict(hidden_size=2048, num_layers=24, num_heads=16,
                     vocab_size=50304),
        "7b": dict(hidden_size=4096, num_layers=32, num_heads=32,
                   vocab_size=32000),
    }
    cfg = dict(presets[size])
    cfg.update(overrides)
    return GPTConfig(**cfg)


def causal_lm_loss(model, batch):
    """``model.loss(input_ids, labels)`` of a ``(input_ids, labels)``
    batch (the reference's ``:417``)."""
    input_ids, labels = batch
    return model.loss(input_ids, labels)


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
    """The per-layer tree takes every variant the reference builds
    (rmsnorm or layernorm, swiglu or gelu, rope or learned positions);
    dropout stays refused, as the reference's StackedDecoder refuses it."""
    if config.dropout:
        raise NotImplementedError("dropout is not supported (the JAX "
                                  "StackedDecoder refuses it too)")


def _check_stacked(config):
    """The stacked decoder's refusals, with the reference's messages
    (``models/gpt.py:1076-1083``)."""
    if config.norm_type != "rmsnorm" or config.act != "swiglu":
        raise ValueError("StackedDecoder supports the rmsnorm+swiglu family")
    if not config.rope:
        raise ValueError("StackedDecoder requires rope positions "
                         "(learned embed_pos is not supported)")
    if config.dropout:
        raise ValueError("StackedDecoder does not support dropout")


def _block_only_options(config):
    """The options only the shared decoder block runs (``_block_pure``): a
    selective remat policy, the int8-saved FFN, the attn->norm seam and
    ``quant:`` GEMM sites, as the names a refusal gives them."""
    opts = []
    if config.recompute and config.recompute_policy != "full":
        opts.append(f"recompute_policy={config.recompute_policy!r}")
    opts += [f"{flag}=True" for flag in ("int8_ffn", "fused_addrms")
             if getattr(config, flag)]
    if _quant.requested_quant_sites(config):
        opts.append("quant: sites")
    return opts


class _Linear(nn.Linear):
    """``nn.Linear`` whose input and weights take ``linear``'s type under
    ``paddle.amp.auto_cast`` (the low type: a white-list op)."""

    def forward(self, x):
        return F.linear(*autocast("linear", (x, self.weight, self.bias)))


def _linear(i, o, device, dtype, bias=False):
    return _Linear(i, o, bias=bias, device=device, dtype=dtype)


class RMSNorm(nn.Module):
    def __init__(self, hidden_size, eps=1e-6, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype))

    def forward(self, x):
        return _rms_pure(*autocast("rms_norm", (x, self.weight)), self.eps)


def _norm(config, device, dtype):
    """``norm_type`` "rmsnorm" -> the rms_norm kernel's layer, anything
    else -> ``LayerNorm`` (the reference's rule, ``models/gpt.py:217``)."""
    if config.norm_type == "rmsnorm":
        return RMSNorm(config.hidden_size, device=device, dtype=dtype)
    return LayerNorm(config.hidden_size, device=device, dtype=dtype)


def _masked_attention(q, k, v, mask):
    """Causal attention under a user mask, as the reference's ``_xla_sdpa``
    (``nn/functional/flash_attention.py:20-44``): a bool mask keeps the
    True entries, any other mask is added to the scores; f32 softmax,
    probabilities rounded to q's type. q [B, T, Hq, D], k/v [B, S, Hkv,
    D], mask broadcastable to [B, Hq, T, S]."""
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bthd,bshd->bhts", q * scale, k)
    t, s = logits.shape[-2:]
    causal = torch.ones(t, s, dtype=torch.bool, device=q.device).tril(s - t)
    logits = logits.masked_fill(~causal, -math.inf)
    mask = torch.as_tensor(mask, device=q.device)
    if mask.dtype == torch.bool:
        logits = logits.masked_fill(~mask, -math.inf)
    else:
        logits = logits + mask.to(logits.dtype)
    probs = torch.softmax(logits.float(), -1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


class Attention(nn.Module):
    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_heads
        self.num_kv_heads = config.num_kv_heads
        self.head_dim = h // config.num_heads
        self.rope = config.rope
        self.q_proj = _linear(h, self.num_heads * self.head_dim, device, dtype)
        self.k_proj = _linear(h, self.num_kv_heads * self.head_dim, device,
                              dtype)
        self.v_proj = _linear(h, self.num_kv_heads * self.head_dim, device,
                              dtype)
        self.o_proj = _linear(self.num_heads * self.head_dim, h, device, dtype)

    def forward(self, x, attn_mask=None):
        """Causal self-attention. Without a mask it is the flash op (the
        kernels on CUDA tensors, their plain versions on CPU tensors; kv
        heads shared in the kernel), as the reference's ``sdpa_arrays``
        takes its Pallas kernel; with one, :func:`_masked_attention`."""
        b, s, _ = x.shape
        q = self.q_proj(x).reshape(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        if self.rope:
            q, k = _rope_pure(q), _rope_pure(k)
        q, k, v = autocast("sdpa", (q, k, v))
        if attn_mask is None:
            out = flash_attention(q, k, v, causal=True)
        else:
            out = _masked_attention(q, k, v, attn_mask)
        return self.o_proj(out.reshape(b, s, -1))


class MLP(nn.Module):
    """``swiglu``: gate/up/down without biases; anything else: ``fc1`` and
    ``fc2`` with biases (paddle's ``nn.Linear`` default) around the exact
    erf gelu (``F.gelu(approximate=False)`` in the reference)."""

    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        self.swiglu = config.act == "swiglu"
        if self.swiglu:
            self.gate_proj = _linear(h, m, device, dtype)
            self.up_proj = _linear(h, m, device, dtype)
            self.down_proj = _linear(m, h, device, dtype)
        else:
            self.fc1 = _linear(h, m, device, dtype, bias=True)
            self.fc2 = _linear(m, h, device, dtype, bias=True)

    def forward(self, x):
        if self.swiglu:
            return self.down_proj(F.silu(self.gate_proj(x))
                                  * self.up_proj(x))
        return self.fc2(F.gelu(self.fc1(x)))


class DecoderLayer(nn.Module):
    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        self.input_norm = _norm(config, device, dtype)
        self.attn = Attention(config, device, dtype)
        self.post_attn_norm = _norm(config, device, dtype)
        self.mlp = MLP(config, device, dtype)

    def forward(self, x, attn_mask=None):
        h = x + self.attn(self.input_norm(x), attn_mask)
        return h + self.mlp(self.post_attn_norm(h))


def _layer_rng(layers):
    """``context_fn`` for a layer's checkpoint that replays the noise the
    layer drew: the generators of its gates (``SwitchGate.generator``)
    are put back where the forward found them for the recompute, and left
    where the forward left them after it. None when no layer draws."""
    gens = [m.generator for m in layers.modules()
            if isinstance(getattr(m, "generator", None), torch.Generator)]
    if not gens:
        return None

    def context_fn():
        start = []

        @contextlib.contextmanager
        def forward():
            start[:] = [g.get_state() for g in gens]
            yield

        @contextlib.contextmanager
        def recompute():
            now = [g.get_state() for g in gens]
            for g, st in zip(gens, start):
                g.set_state(st)
            try:
                yield
            finally:
                for g, st in zip(gens, now):
                    g.set_state(st)

        return forward(), recompute()

    return context_fn


class _SharedBlockRunner:
    """The layer loop over ``_make_block`` that ``StackedDecoder`` and an
    eligible per-layer ``GPTModel`` share, with the delayed-scaling state
    of ``quant:`` sites.

    A config whose policy requests ``quant:`` sites gets the buffer
    ``quant_amax`` ``[L, 7, 2, H]`` (``models/gpt.py:1103-1111``): the
    delayed-scaling state, saved and restored with the state dict. A
    forward reads a copy of it and commits the new histories after the
    forward, or leaves them to a ``TrainStep`` that holds the commit
    (``_amax_held``) and writes them with the optimizer's update, under
    the guard's keep-select."""

    def _init_quant(self, config, device):
        if _quant.requested_quant_sites(config):
            self.register_buffer("quant_amax", _quant.init_amax_state(
                config.num_layers, device=device))
        self._amax_held = False
        self._amax_pending = None
        self._quant_plans = {}

    def _quant_plan(self, x):
        """The engagement for this input's shapes and device, resolved (and
        noted) once for each, as the reference resolves it once a
        trace."""
        cfg = self.config
        gate_shape = (*x.shape[:-1], cfg.intermediate_size)
        wd_shape = (cfg.intermediate_size, cfg.hidden_size)
        key = (gate_shape, x.device.type)
        if key not in self._quant_plans:
            self._quant_plans[key] = _resolve_quant(cfg, gate_shape,
                                                    wd_shape, x.device)
        return self._quant_plans[key]

    def _run_blocks(self, x, layers):
        """``x`` through one block per entry of ``layers`` (each a tuple
        of weights in ``BLOCK_PARAMS`` order, ``[in, out]``)."""
        sites, dtype = ((frozenset(), None) if "quant_amax" not in
                        self._buffers else self._quant_plan(x))
        block = _make_block(self.config, sites, dtype)
        if not sites:
            for p in layers:
                x = block(x, p)
            return x
        amax = self.quant_amax.detach().clone()
        rows = []
        for p, amax_l in zip(layers, amax):
            x, new_l = block(x, (*p, amax_l))
            rows.append(new_l)
        new = torch.stack(rows)
        if self._amax_held:
            self._amax_pending = new
        else:
            with torch.no_grad():
                self.quant_amax.copy_(new)
        return x


class GPTModel(_SharedBlockRunner, nn.Module):
    """Embedding (+ learned positions where ``rope=False``), the layers,
    the final norm (``models/gpt.py:231-372``).

    A stack the shared block can run (:meth:`_shared_block_eligible`)
    runs every layer through ``_make_block`` on the layer's own weights,
    seen through transposed views (``[out, in]`` -> ``[in, out]``), so
    the gradients land on the ``nn.Linear`` parameters and nothing is
    stacked: the reference's ``_run_stacked``. There it takes every
    ``recompute_policy``, ``int8_ffn``, ``fused_addrms`` and ``quant:``
    sites (with the ``quant_amax`` buffer ``[L, 7, 2, H]`` and
    ``StackedDecoder``'s commit rule), and launches ``swiglu_down`` and
    the norm kernels as the Pipe's block does.

    Any other stack (LayerNorm, gelu, learned positions, a layer that is
    not a ``DecoderLayer``, or a call with ``attn_mask``) runs the module
    loop: with ``config.recompute`` each layer is a non-reentrant
    ``torch.utils.checkpoint`` (the reference's ``fleet.utils.recompute``
    over each layer). The reference's loop ignores the block-only
    options; here a model or call that asks for one of them raises
    ``ValueError`` naming the condition that failed.
    ``layer_cls(config, device, dtype)`` builds each layer."""

    def __init__(self, config, device=None, dtype=None,
                 layer_cls=DecoderLayer):
        super().__init__()
        self.config = config
        self.embed_tokens = nn.Embedding(config.vocab_size, config.hidden_size,
                                         device=device, dtype=dtype)
        if not config.rope:
            self.embed_pos = nn.Embedding(config.max_seq_len,
                                          config.hidden_size, device=device,
                                          dtype=dtype)
        self.layers = nn.ModuleList(
            [layer_cls(config, device, dtype)
             for _ in range(config.num_layers)])
        self.final_norm = _norm(config, device, dtype)
        self._refuse_block_only(None)
        self._init_quant(config, self.embed_tokens.weight.device)

    def _shared_block_refusal(self, attn_mask):
        """None when the stack can run through the shared block, else the
        condition that failed (the reference's ``_shared_block_eligible``,
        ``models/gpt.py:271-301``). Under ``paddle.amp.auto_cast`` the
        module loop runs, so that each op takes its list's type. Not
        checked yet: the reference's per-layer placement and pp-mesh
        conditions (A.10 adds them back with the placements)."""
        cfg = self.config
        if attn_mask is not None:
            return "attn_mask is given"
        if cfg.dropout:
            return f"dropout={cfg.dropout}"
        if not cfg.rope:
            return "rope=False (learned positions)"
        if cfg.norm_type != "rmsnorm":
            return f"norm_type={cfg.norm_type!r} (the block is rmsnorm)"
        if cfg.act != "swiglu":
            return f"act={cfg.act!r} (the block is swiglu)"
        if is_auto_cast_enabled():
            return "auto_cast is enabled"
        for layer in self.layers:
            if type(layer) is not DecoderLayer:
                return (f"a layer is a {type(layer).__name__}, not a plain "
                        "DecoderLayer")
        return None

    def _shared_block_eligible(self, attn_mask):
        return self._shared_block_refusal(attn_mask) is None

    def _refuse_block_only(self, attn_mask):
        """Raise where the module loop would ignore a block-only option."""
        opts = _block_only_options(self.config)
        why = self._shared_block_refusal(attn_mask) if opts else None
        if why is not None:
            raise ValueError(f"{', '.join(opts)}: only the shared decoder "
                             f"block runs this, and this stack cannot take "
                             f"it: {why}")

    def _block_params(self):
        """Each layer's weights in ``BLOCK_PARAMS`` order, the projections
        as ``[in, out]`` views of their ``[out, in]`` parameters."""
        def weight(layer, attr, suffix):
            w = layer.get_parameter(suffix)
            return w.t() if attr in _LINEAR_ATTRS else w

        return [tuple(weight(layer, attr, suffix)
                      for attr, suffix in BLOCK_PARAM_FIELDS)
                for layer in self.layers]

    def forward(self, input_ids, attn_mask=None):
        x = self.embed_tokens(input_ids)
        if not self.config.rope:
            x = x + self.embed_pos(torch.arange(input_ids.shape[1],
                                                device=x.device))
        if self._shared_block_eligible(attn_mask):
            return self.final_norm(self._run_blocks(x, self._block_params()))
        self._refuse_block_only(attn_mask)
        if self.config.recompute:
            ctx = _layer_rng(self.layers)
            kw = {} if ctx is None else {"context_fn": ctx}
            for layer in self.layers:
                x = checkpoint(layer, x, attn_mask, use_reentrant=False,
                               **kw)
        else:
            for layer in self.layers:
                x = layer(x, attn_mask)
        return self.final_norm(x)


class GPTForCausalLM(nn.Module):
    """Decoder LM. ``device`` defaults to CUDA (raising where there is
    none); ``dtype`` defaults to ``config.dtype``."""

    def __init__(self, config, device=None, dtype=None,
                 layer_cls=DecoderLayer):
        super().__init__()
        _check_supported(config)
        device = resolve_device(device)
        dtype = dtype or _DTYPES[config.dtype]
        self.config = config
        self.model = GPTModel(config, device, dtype, layer_cls)
        self.lm_head = (None if config.tie_embeddings else
                        _linear(config.hidden_size, config.vocab_size, device,
                                dtype))

    @property
    def device(self):
        return self.model.embed_tokens.weight.device

    @torch.no_grad()
    def init_weights(self, generator, std=0.02):
        """Random weights from ``generator``: every matrix and embedding
        ~ N(0, std^2), norm gains 1, biases 0."""
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            elif name.endswith((".bias", ".b1", ".b2")):
                p.zero_()
            else:
                p.normal_(0.0, std, generator=generator)
        return self

    def _head(self):
        return (self.model.embed_tokens.weight if self.lm_head is None
                else self.lm_head.weight)

    def forward(self, input_ids, attn_mask=None):
        # the reference's head is a "matmul" (tied) or a "linear"; both
        # white-list ops
        return F.linear(*autocast("linear", (self.model(input_ids, attn_mask),
                                             self._head())))

    def loss(self, input_ids, labels, int8=None):
        """LM loss through the chunked-CE head (``models/gpt.py:405-415``):
        the tied head reads the embedding, the untied one ``lm_head``
        (``[V, H]`` here, where the reference's is ``[H, V]``). ``int8``
        as for ``GPTForCausalLMPipe.loss``."""
        return compute_loss(self.model(input_ids), self._head(), labels,
                            config=self.config, transpose_y=True, int8=int8)


# ---------------------------------------------------------------------------
# Training path: the JAX package's flagship GPTForCausalLMPipe on one device
# ---------------------------------------------------------------------------
def compute_loss(hidden, weight, labels, *, config=None, transpose_y=True,
                 ignore_index=-100, mode="chunked", int8=None):
    """LM-head matmul + CE (``paddle_tpu/models/gpt.py:93``).

    - ``chunked`` (the default): the chunked-CE head, whose f32
      ``[tokens, vocab]`` logits never exist whole; ``int8`` (None: the
      parity-gated default of ``int8_head_enabled``, on for a card, off
      on the CPU) computes its logits in int8 (the reference's
      ``PTPU_INT8_HEAD``);
    - ``dense``: full logits and ``F.cross_entropy``, the parity oracle.

    The vocab-sharded head is not ported yet (ROADMAP A.10).
    """
    if mode == "chunked":
        return chunked_lm_loss_arrays(
            hidden, weight, labels, transpose_y=transpose_y,
            vocab_chunk=getattr(config, "head_chunk", None),
            ignore_index=ignore_index, int8=int8)
    if mode == "dense":
        vocab = weight.shape[0] if transpose_y else weight.shape[-1]
        record_head_mode("dense", False, labels.numel(), vocab)
        logits = hidden @ (weight.t() if transpose_y else weight)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                               labels.reshape(-1).long(),
                               ignore_index=ignore_index)
    raise ValueError(f"compute_loss mode {mode!r}: expected chunked or dense")


def _rope_pure(x, base=10000.0):
    """Neox-style rope on [B, S, H, D] at positions 0..S-1."""
    pos = torch.zeros(x.shape[0], dtype=torch.long, device=x.device)
    return _rope_at_positions(x, pos, base)


class _FFNInt8(torch.autograd.Function):
    """``(silu(h2 @ wg) * (h2 @ wu)) @ wd`` whose backward reads gate and up
    from int8 row codes (``memory.quantize_rows_int8``) instead of running
    the two matmuls again: the reference's ``_ffn_i8`` custom_vjp
    (``models/gpt.py:521-580``). The forward is exact; the backward follows
    ``_ffn_i8_bwd`` step for step (dequantize in f32, silu and its
    derivative in f32, the products rounded to h2's type)."""

    @staticmethod
    def forward(ctx, h2, wg, wu, wd):
        gate = h2 @ wg
        up = h2 @ wu
        qg, sg = quantize_rows_int8(gate)
        qu, su = quantize_rows_int8(up)
        ctx.save_for_backward(h2, wg, wu, wd, qg, sg, qu, su)
        return (F.silu(gate) * up) @ wd

    @staticmethod
    def backward(ctx, g):
        h2, wg, wu, wd, qg, sg, qu, su = ctx.saved_tensors
        gate = qg.float() * sg
        up = qu.float() * su
        sig = torch.sigmoid(gate)
        silu = gate * sig
        dsilu = sig * (1.0 + gate * (1.0 - sig))
        ffn = (silu * up).to(h2.dtype)
        dffn = g @ wd.t()
        m, h = wd.shape
        dwd = (ffn.reshape(-1, m).t() @ g.reshape(-1, h)).to(wd.dtype)
        gf = dffn.float()
        dgate = (gf * up * dsilu).to(h2.dtype)
        dup = (gf * silu).to(h2.dtype)
        dh2 = dgate @ wg.t() + dup @ wu.t()
        h2r = h2.reshape(-1, h2.shape[-1]).t()
        dwg = (h2r @ dgate.reshape(-1, m)).to(wg.dtype)
        dwu = (h2r @ dup.reshape(-1, m)).to(wu.dtype)
        return dh2, dwg, dwu, dwd


def ffn_i8(h2, wg, wu, wd):
    """The swiglu FFN with int8-saved gate/up (:class:`_FFNInt8`)."""
    return _FFNInt8.apply(h2, wg, wu, wd)


def _block_pure(p, x, num_heads, save=frozenset(), int8_names=frozenset(),
                quant=None, fused_addrms=False, int8_ffn=False):
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
    flash op, and the reference tags it only off its Pallas path.
    ``int8_names``: the anchors saved as blockwise int8 through
    ``int8_checkpoint`` instead (``int8:<name>`` entries).

    ``quant``: a ``quant.GemmQuantCtx`` holding the layer's amax slice;
    its engaged sites run the scaled GEMM and it collects their new
    histories.

    ``fused_addrms``: the attn->norm seam, ``add_rms_norm`` in place of the
    residual add and the second rms (``config.fused_addrms``).
    ``int8_ffn``: the whole FFN as :func:`ffn_i8`, ahead of
    ``swiglu_down`` (``config.int8_ffn``; the reference's block takes it
    first, ``:781-790``)."""

    def _save(t, name):
        if name in int8_names:
            return int8_checkpoint(t, name)
        return anchor(t, name, save)

    def _mm(a, w, site):
        return quant.gemm(a, w, site) if quant is not None else a @ w

    ln1, wq, wk, wv, wo, ln2, wg, wu, wd = p
    b, s, hdim = x.shape
    hd = hdim // num_heads
    h = _rms_pure(x, ln1)
    q = _mm(h, wq, "wq").reshape(b, s, -1, hd)
    k = _mm(h, wk, "wk").reshape(b, s, -1, hd)
    v = _mm(h, wv, "wv").reshape(b, s, -1, hd)
    q = _save(_rope_pure(q), "attn_q")
    k = _save(_rope_pure(k), "attn_k")
    v = _save(v, "attn_v")
    o = flash_attention(q, k, v, causal=True).reshape(b, s, -1)
    if fused_addrms:
        # the attn->norm seam: residual add and rms in one kernel; no
        # resid_mid or ln2_out anchor on this path (``:764-773``)
        x, h2 = add_rms_norm(_mm(o, wo, "wo"), x, ln2)
    else:
        x = _save(x + _mm(o, wo, "wo"), "resid_mid")
        h2 = _save(_rms_pure(x, ln2), "ln2_out")
    if int8_ffn:
        return x + ffn_i8(h2, wg, wu, wd)
    gate = _save(_mm(h2, wg, "wg"), "ffn_gate")
    up = _save(_mm(h2, wu, "wu"), "ffn_up")
    if swiglu_down_supported(gate.shape, wd.shape):
        return x + swiglu_down(gate, up, wd)
    return x + _mm(_save(F.silu(gate) * up, "ffn_out"), wd, "wd")


#: the anchors of the coarse policies (``models/gpt.py:882-887``)
_POLICY_NAMES = {"attn": ("attn_out", "attn_res", "attn_lse"),
                 "attn_ffn": ("attn_out", "attn_res", "attn_lse", "ffn_out")}


def _resolve_remat(cfg):
    """The reference's policy parser (``models/gpt.py:858-888``) ->
    ``None`` for "full" (save nothing), else ``(save names, dots, int8
    anchors)``:

    - ``names:<list>``: the listed anchors (``save_only_these_names``); a
      name the path does not tag saves nothing. An ``int8:<name>`` entry
      saves that anchor's blockwise int8 codes and scales
      (``int8_checkpoint``); ``quant:`` entries are GEMM sites
      (:func:`_resolve_quant`) and are taken out first;
    - ``attn`` / ``attn_ffn``: the names of ``_POLICY_NAMES``;
    - ``dots``: the outputs of the 2-D matmuls
      (``dots_with_no_batch_dims_saveable``)."""
    pol = cfg.recompute_policy
    if pol == "full":
        return None
    if pol == "dots":
        return frozenset(), True, frozenset()
    if pol in _POLICY_NAMES:
        return frozenset(_POLICY_NAMES[pol]), False, frozenset()
    if isinstance(pol, str) and pol.startswith("names:"):
        spec, _ = split_quant_entries(pol[len("names:"):])
        save, int8 = parse_save_names(spec)
        return frozenset(save), False, int8
    raise ValueError(f"unknown recompute_policy {pol!r}")


def _resolve_quant(cfg, gate_shape, wd_shape, device, path="train"):
    """The scaled-GEMM engagement of one forward (``models/gpt.py:
    891-946``) -> ``(engaged sites, narrow dtype)``, each resolution noted
    as a ``quant_gemm`` plan verdict:

    - nothing requested: nothing engages and nothing is noted;
    - a gate that fails on ``device`` declines every site
      (``quant_parity_gate``);
    - where ``swiglu_down_supported`` takes the FFN, the kernel owns
      ``wd``, which stays wide (``fused_kernel_owns_gemm``); gate and up
      feed it narrow. Under ``int8_ffn`` the int8-saved FFN owns all
      three of its GEMMs instead.

    The engaged sites' forward FLOPs per token are noted for
    ``quant_gemm_flops_total``."""
    sites = _quant.requested_quant_sites(cfg)
    if not sites:
        return frozenset(), None
    dtype = _quant.quant_dtype(None, device)
    if not _quant.quant_compute_enabled(True, device, dtype=dtype):
        _quant.note_plan_engagement("quant_gemm", "quant_parity_gate")
        _quant.note_gemm_mode(path, frozenset(), None)
        return frozenset(), None
    if cfg.int8_ffn:
        owned = sites & {"wg", "wu", "wd"}
        if owned:
            _quant.note_plan_engagement("quant_gemm",
                                        "fused_kernel_owns_gemm")
            sites = sites - owned
    elif "wd" in sites and swiglu_down_supported(gate_shape, wd_shape):
        _quant.note_plan_engagement("quant_gemm", "fused_kernel_owns_gemm")
        sites = sites - {"wd"}
    if not sites:
        return frozenset(), None
    _quant.note_plan_engagement("quant_gemm", "engaged")
    h = cfg.hidden_size
    kv = cfg.num_kv_heads * (h // cfg.num_heads)
    m = cfg.intermediate_size
    dims = {"wq": h * h, "wk": h * kv, "wv": h * kv, "wo": h * h,
            "wg": h * m, "wu": h * m, "wd": m * h}
    flops_per_token = 2 * sum(dims[s] for s in sites) * cfg.num_layers
    _quant.note_gemm_mode(path, sites, dtype, flops_per_token)
    return frozenset(sites), dtype


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


def _make_block(cfg, quant_sites=frozenset(), quant_dtype=None):
    """One decoder block over (x, per-layer weights); with
    ``cfg.recompute`` each block is a non-reentrant
    ``torch.utils.checkpoint`` that reruns it in the backward, keeping
    what the selective policy names.

    With ``quant_sites`` the block takes the layer's amax slice as a last
    operand and returns ``(x, new amax slice)``. The slice is an input of
    the checkpoint, so the recompute reads the histories the forward read
    (the caller passes a copy nothing writes before the backward ends);
    the recompute's own new histories are discarded, so they shift once a
    step."""
    save, int8_names, policy = frozenset(), frozenset(), {}
    if cfg.recompute:
        remat = _resolve_remat(cfg)
        if remat is not None:    # "full" stays a plain checkpoint
            save, dots, int8_names = remat
            policy["context_fn"] = _selective_policy(save, dots)

    def block(x, *p):
        qctx = None
        if quant_sites:
            *p, amax_l = p
            qctx = _quant.GemmQuantCtx(quant_sites, amax_l, quant_dtype)
        out = _block_pure(p, x, cfg.num_heads, save, int8_names, qctx,
                          cfg.fused_addrms, cfg.int8_ffn)
        return out if qctx is None else (out, qctx.collect())

    if not cfg.recompute:
        return lambda x, p: block(x, *p)
    return lambda x, p: checkpoint(block, x, *p, use_reentrant=False,
                                   **policy)


#: _block_pure's parameter order as (StackedDecoder attribute, per-layer
#: state-dict suffix): also the layout contract of the converters below
BLOCK_PARAM_FIELDS = (
    ("ln1", "input_norm.weight"),
    ("wq", "attn.q_proj.weight"),
    ("wk", "attn.k_proj.weight"),
    ("wv", "attn.v_proj.weight"),
    ("wo", "attn.o_proj.weight"),
    ("ln2", "post_attn_norm.weight"),
    ("wg", "mlp.gate_proj.weight"),
    ("wu", "mlp.up_proj.weight"),
    ("wd", "mlp.down_proj.weight"),
)
#: _block_pure's parameter order, as StackedDecoder attributes
BLOCK_PARAMS = tuple(attr for attr, _ in BLOCK_PARAM_FIELDS)


class StackedDecoder(_SharedBlockRunner, nn.Module):
    """Every decoder block as leading-axis-stacked parameters ``[L, ...]``
    (``models/gpt.py:1065``), in the JAX package's ``[in, out]`` layout.
    Projections start as N(0, 0.02^2), norm gains as ones. The layers run
    as a loop over ``torch.unbind`` slices, whose backward stacks the L
    per-layer gradients once. Single device: pipeline, tensor parallelism
    and ZeRO are not ported (ROADMAP A.10). ``quant:`` sites add the
    ``quant_amax`` buffer (:class:`_SharedBlockRunner`)."""

    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        _check_stacked(config)
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
        self._init_quant(config, self.wq.device)

    def apply_tp_placements(self, *args, **kwargs):
        raise NotImplementedError("tensor parallelism is not ported yet "
                                  "(ROADMAP A.10)")

    apply_pipeline_placements = apply_tp_placements

    def forward(self, x):
        return self._run_blocks(x, zip(*(torch.unbind(getattr(self, n))
                                         for n in BLOCK_PARAMS)))


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

    def loss(self, input_ids, labels, int8=None):
        """Tied-head LM loss through the chunked-CE head: neither the f32
        logits nor their gradient exists whole. ``int8`` pins the head's
        logits to int8 (True) or f32 (False); None leaves it to
        ``int8_head_enabled`` (the int8 head on a card whose gate passes,
        f32 on the CPU)."""
        return compute_loss(self._hidden(input_ids), self.embed_tokens.weight,
                            labels, config=self.config, transpose_y=True,
                            int8=int8)


# ---------------------------------------------------------------------------
# Stacked <-> per-layer checkpoint layouts (``models/gpt.py:1564-1770``)
# ---------------------------------------------------------------------------
_SUFFIX_TO_ATTR = {suffix: attr for attr, suffix in BLOCK_PARAM_FIELDS}
_ATTR_TO_SUFFIX = dict(BLOCK_PARAM_FIELDS)
#: the projections: ``[in, out]`` per layer in the stacked tree, ``[out,
#: in]`` (``torch.nn.Linear``) in the per-layer tree
_LINEAR_ATTRS = frozenset({"wq", "wk", "wv", "wo", "wg", "wu", "wd"})
#: a factored second moment's row and column statistics: transposing the
#: weight swaps them
_FACTORED_SWAP = {".vr": ".vc", ".vc": ".vr"}
#: blockwise-int8 moment slots (``AdamW(moment_dtype="int8")``)
_INT8_SLOTS = frozenset({".moment1_q", ".moment1_s", ".moment2_q",
                         ".moment2_s"})
#: top-level keys: stacked-side name -> per-layer name (the delayed-scaling
#: histories are ``[L, 7, 2, H]`` in both trees)
_TOP_KEY_MAP = {"embed_tokens.weight": "model.embed_tokens.weight",
                "final_norm.weight": "model.final_norm.weight",
                "decoder.quant_amax": "model.quant_amax"}


def _split_opt_key(key):
    """("opt." or "", the parameter name with its slot suffix)."""
    return ("opt.", key[4:]) if key.startswith("opt.") else ("", key)


def _match_layer_key(rest):
    """"model.layers.3.attn.q_proj.weight[.slot]" -> (3, "wq", ".slot" or
    ""), else None."""
    prefix = "model.layers."
    if not rest.startswith(prefix):
        return None
    idx, _, tail = rest[len(prefix):].partition(".")
    if not idx.isdigit():
        return None
    for suffix, attr in _SUFFIX_TO_ATTR.items():
        if tail == suffix:
            return int(idx), attr, ""
        if tail.startswith(suffix + "."):
            return int(idx), attr, tail[len(suffix):]
    return None


def _match_stacked_key(rest):
    """"decoder.wq[.slot]" -> ("wq", ".slot" or ""), else None."""
    if not rest.startswith("decoder."):
        return None
    attr, _, slot = rest[len("decoder."):].partition(".")
    if attr not in _ATTR_TO_SUFFIX:
        return None
    return attr, ("." + slot if slot else "")


def _rename_top(rest, mapping):
    for src, dst in mapping.items():
        if rest == src:
            return dst
        if rest.startswith(src + "."):
            return dst + rest[len(src):]
    return rest


def decoder_state_layout(state):
    """"stacked", "per_layer" or None for a LM state dict's keys."""
    for key in state:
        _, rest = _split_opt_key(key)
        if _match_stacked_key(rest) is not None:
            return "stacked"
        if _match_layer_key(rest) is not None:
            return "per_layer"
    return None


def _refuse_int8(key, slot):
    if slot in _INT8_SLOTS:
        raise ValueError(
            f"{key}: blockwise-int8 moment slots do not convert exactly "
            "(their quant-block grid spans the stacked axis); restore them "
            "under the layout that wrote them")


def convert_decoder_state_dict(state, target):
    """Convert a LM state dict of tensors (parameters and optimizer
    entries ``opt.<param>.<slot>``) to ``target``, "stacked" (the Pipe's
    ``decoder.<attr>`` ``[L, in, out]``) or "per_layer" (``model.layers.
    {i}...`` ``[out, in]``), as the reference's converter
    (``models/gpt.py:1653-1740``) with the port's layouts:

    - projections are stacked or sliced along the layer axis and
      transposed; their parameter-shaped slots with them;
    - a factored second moment's ``vr`` and ``vc`` swap, since the
      transpose swaps rows and columns;
    - other slots follow the reference: sliced where their leading axis
      is the layer count, replicated otherwise; 0-d slots (the beta
      powers) replicate when unstacked and must agree bitwise across the
      layers when stacked;
    - blockwise-int8 moment slots raise ``ValueError`` (the reference's
      reason);
    - other keys pass through (a strict restore reports them).

    The values are the inputs' bytes, rearranged: nothing is rounded."""
    if target not in ("stacked", "per_layer"):
        raise ValueError(f"target={target!r}: expected stacked|per_layer")
    out = {}
    if target == "stacked":
        pending = {}            # (pre, attr, slot) -> {layer: tensor}
        for key, v in state.items():
            pre, rest = _split_opt_key(key)
            m = _match_layer_key(rest)
            if m is None:
                out[pre + _rename_top(
                    rest, {b: a for a, b in _TOP_KEY_MAP.items()})] = v
                continue
            i, attr, slot = m
            _refuse_int8(key, slot)
            if attr in _LINEAR_ATTRS:
                if slot in _FACTORED_SWAP:
                    slot = _FACTORED_SWAP[slot]
                elif v.dim() == 2:
                    v = v.t()
            pending.setdefault((pre, attr, slot), {})[i] = v
        for (pre, attr, slot), by_layer in pending.items():
            L = max(by_layer) + 1
            missing = [i for i in range(L) if i not in by_layer]
            if missing:
                raise ValueError(
                    f"per-layer state is missing layers {missing} of "
                    f"{attr}{slot} (found {sorted(by_layer)})")
            arrs = [by_layer[i] for i in range(L)]
            if arrs[0].dim() == 0:
                ref = arrs[0].reshape(1).view(torch.uint8)
                for i, a in enumerate(arrs[1:], 1):
                    if not torch.equal(a.reshape(1).view(torch.uint8), ref):
                        raise ValueError(
                            f"scalar slot {attr}{slot} differs between "
                            f"layers 0 and {i}: cannot collapse into one "
                            "stacked entry")
                out[pre + "decoder." + attr + slot] = arrs[0]
            else:
                out[pre + "decoder." + attr + slot] = torch.stack(arrs)
        return out

    num_layers = None
    for key, v in state.items():
        m = _match_stacked_key(_split_opt_key(key)[1])
        if m is not None and m[1] == "":
            num_layers = int(v.shape[0])
            break
    for key, v in state.items():
        pre, rest = _split_opt_key(key)
        m = _match_stacked_key(rest)
        if m is None:
            out[pre + _rename_top(rest, _TOP_KEY_MAP)] = v
            continue
        if num_layers is None:
            raise ValueError("cannot infer num_layers: no stacked decoder "
                             "parameter entry in the state dict")
        attr, slot = m
        _refuse_int8(key, slot)
        linear = attr in _LINEAR_ATTRS
        new_slot = _FACTORED_SWAP.get(slot, slot) if linear else slot
        for i in range(num_layers):
            per = (v[i] if v.dim() >= 1 and v.shape[0] == num_layers
                   else v)
            if linear and per.dim() == 2:
                per = per.t().contiguous()
            out[f"{pre}model.layers.{i}.{_ATTR_TO_SUFFIX[attr]}{new_slot}"] \
                = per
    return out


def restore_decoder_any_layout(manager, model, optimizer=None, step=None,
                               strict=True):
    """``CheckpointManager.restore_training_state`` that also takes a
    checkpoint written under the other decoder layout
    (``models/gpt.py:1743-1770``): a metadata-only peek at the saved keys
    sends a same-layout checkpoint down the native restore (with the
    caller's ``strict``); another layout's is read whole
    (``manager.read_state``), converted, and copied into the live model
    and optimizer. ``strict`` raises ``MissingKeysError`` for target keys
    the converted state lacks. Returns the step restored."""
    from ..distributed.checkpoint import (MissingKeysError,
                                          training_state_target)

    want = decoder_state_layout(model.state_dict())
    have = decoder_state_layout(manager.saved_keys(step=step))
    if want is None or have is None or have == want:
        try:
            return manager.restore_training_state(model, optimizer,
                                                  step=step, strict=strict)
        except MissingKeysError:
            if want is None:
                raise
            # a mixed-layout root: the native walk fell back onto a step
            # of the other layout, converted below
    state, s = manager.read_state(step=step)
    target = training_state_target(model, optimizer)
    want = decoder_state_layout(target) or "per_layer"
    conv = convert_decoder_state_dict(state, want)
    missing = [k for k in target if k not in conv]
    if missing and strict:
        raise MissingKeysError(missing, manager.step_dir(s))
    with torch.no_grad():
        for k, t in target.items():
            if k not in conv:
                continue
            if tuple(conv[k].shape) != tuple(t.shape):
                raise ValueError(
                    f"{k}: converted shape {tuple(conv[k].shape)} != model "
                    f"shape {tuple(t.shape)}")
            t.copy_(conv[k])
    return s


# ---------------------------------------------------------------------------
# MoE decoder (``models/gpt.py:1773-1845``)
# ---------------------------------------------------------------------------
class MoEDecoderLayer(nn.Module):
    """A decoder block whose MLP is a mixture of ``StackedExperts`` of
    width ``config.intermediate_size``."""

    def __init__(self, config, device=None, dtype=None, num_experts=8,
                 top_k=2, gate="gshard", capacity_factor=2.0):
        super().__init__()
        from ..incubate.distributed.models.moe import MoELayer, StackedExperts

        self.input_norm = _norm(config, device, dtype)
        self.attn = Attention(config, device, dtype)
        self.post_attn_norm = _norm(config, device, dtype)
        self.moe = MoELayer(
            config.hidden_size,
            StackedExperts(num_experts, config.hidden_size,
                           config.intermediate_size, device=device,
                           dtype=dtype),
            gate={"type": gate, "top_k": top_k},
            capacity_factor=capacity_factor)

    def forward(self, x, attn_mask=None):
        h = x + self.attn(self.input_norm(x), attn_mask)
        return h + self.moe(self.post_attn_norm(h))


class GPTForCausalLMMoE(GPTForCausalLM):
    """Decoder LM with MoE FFNs; ``loss`` adds ``aux_loss_weight`` times
    the summed gates' aux losses. The head is tied."""

    def __init__(self, config, num_experts=8, top_k=2, gate="gshard",
                 aux_loss_weight=0.01, capacity_factor=2.0, device=None,
                 dtype=None):
        if not config.tie_embeddings:
            raise ValueError("GPTForCausalLMMoE ties the lm head to the "
                             "token embedding")
        if gate == "switch" and top_k != 1:
            raise ValueError("switch gate is top-1: pass top_k=1")
        super().__init__(config, device, dtype, layer_cls=functools.partial(
            MoEDecoderLayer, num_experts=num_experts, top_k=top_k,
            gate=gate, capacity_factor=capacity_factor))
        self.aux_loss_weight = aux_loss_weight

    @property
    def layers(self):
        return self.model.layers

    def aux_loss(self):
        """The sum of the layers' ``l_aux`` from the last forward (None
        under the naive gate)."""
        total = None
        for layer in self.model.layers:
            la = layer.moe.l_aux
            if la is not None:
                total = la if total is None else total + la
        return total

    def loss(self, input_ids, labels):
        """Dense logits and cross entropy, as the reference
        (``:1828-1836``): f32 log-softmax, a label of -100 adds 0 and
        still counts in the mean (the reference's ``cross_entropy`` masks
        only a non-negative ``ignore_index``)."""
        logits = self(input_ids).reshape(-1, self.config.vocab_size)
        nll = F.cross_entropy(logits.float(), labels.reshape(-1).long(),
                              reduction="none")
        lm = nll.mean()
        aux = self.aux_loss()
        if aux is not None:
            lm = lm + self.aux_loss_weight * aux
        return lm

    def apply_expert_placements(self, *args, **kwargs):
        raise NotImplementedError("expert parallelism is not ported yet "
                                  "(ROADMAP A.10)")
