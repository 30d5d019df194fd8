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
  names, with ``int8:`` saves), the scaled fp8/int8 GEMMs of ``quant:``
  sites with their delayed-scaling ``quant_amax`` buffer, the tied head
  and the chunked-CE loss (f32 or int8 logits). Layers run as a Python
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
from .. import quant as _quant
from ..memory.int8_ckpt import int8_checkpoint
from ..memory.remat import anchor, parse_save_names, split_quant_entries
from ..nn.functional.fused_cross_entropy import (chunked_lm_loss_arrays,
                                                 record_head_mode)
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


def _block_pure(p, x, num_heads, save=frozenset(), int8_names=frozenset(),
                quant=None):
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
    histories."""

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
    x = _save(x + _mm(o, wo, "wo"), "resid_mid")
    h2 = _save(_rms_pure(x, ln2), "ln2_out")
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
      feed it narrow.

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
    if "wd" in sites and swiglu_down_supported(gate_shape, wd_shape):
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
        out = _block_pure(p, x, cfg.num_heads, save, int8_names, qctx)
        return out if qctx is None else (out, qctx.collect())

    if not cfg.recompute:
        return lambda x, p: block(x, *p)
    return lambda x, p: checkpoint(block, x, *p, use_reentrant=False,
                                   **policy)


#: _block_pure's parameter order, as StackedDecoder attributes
BLOCK_PARAMS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "wg", "wu", "wd")


class StackedDecoder(nn.Module):
    """Every decoder block as leading-axis-stacked parameters ``[L, ...]``
    (``models/gpt.py:1065``), in the JAX package's ``[in, out]`` layout.
    Projections start as N(0, 0.02^2), norm gains as ones. The layers run
    as a loop over ``torch.unbind`` slices, whose backward stacks the L
    per-layer gradients once. Single device: pipeline, tensor parallelism
    and ZeRO are not ported (ROADMAP A.10).

    A config whose policy requests ``quant:`` sites gets the buffer
    ``quant_amax`` ``[L, 7, 2, H]`` (``models/gpt.py:1103-1111``): the
    delayed-scaling state, saved and restored with the state dict. A
    forward reads a copy of it and commits the new histories after the
    forward, or leaves them to a ``TrainStep`` that holds the commit
    (``_amax_held``) and writes them with the optimizer's update, under
    the guard's keep-select."""

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
        if _quant.requested_quant_sites(config):
            self.register_buffer("quant_amax", _quant.init_amax_state(
                L, device=self.wq.device))
        self._amax_held = False
        self._amax_pending = None
        self._quant_plans = {}

    def apply_tp_placements(self, *args, **kwargs):
        raise NotImplementedError("tensor parallelism is not ported yet "
                                  "(ROADMAP A.10)")

    apply_pipeline_placements = apply_tp_placements

    def _quant_plan(self, x):
        """The engagement for this input's shapes and device, resolved (and
        noted) once for each, as the reference resolves it once a
        trace."""
        cfg = self.config
        gate_shape = (*x.shape[:-1], cfg.intermediate_size)
        wd_shape = tuple(self.wd.shape[1:])
        key = (gate_shape, x.device.type)
        if key not in self._quant_plans:
            self._quant_plans[key] = _resolve_quant(cfg, gate_shape,
                                                    wd_shape, x.device)
        return self._quant_plans[key]

    def forward(self, x):
        layers = zip(*(torch.unbind(getattr(self, n)) for n in BLOCK_PARAMS))
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
