"""The incubate fused ops.

Counterpart of ``paddle_tpu/incubate/nn/functional/__init__.py``, all 22 of
its public names: the ops PaddlePaddle users build inference decoders and
fused transformer layers from. Each public name takes and returns the
port's ``Tensor`` s: it runs its body, kept under ``<name>_arrays`` for
callers that hold torch tensors, through ``core.dispatch.apply_op`` under
the reference's op name (``fused_rope``, ``varlen_attention``,
``fused_bias_dropout_residual_ln``, ``blha_decode``/``blha_prefill``, the
others their own), so ``op_dispatch_total`` and amp's lists see them as
the reference's. Ops that return several values return tuples of
``Tensor`` s. ``swiglu`` is ``nn.functional.swiglu`` and
``fused_multi_transformer`` composes the public attention and FFN ops, as
in the reference. The JAX package leaves all but the attention cores and
the norms to XLA; here they are plain PyTorch.

Routes. The JAX package gates its kernels on "running on the TPU"; here a
CUDA tensor takes the hand-written kernel and everything else the JAX
package's plain route:

- ``fused_rms_norm`` over the last axis without ``norm_bias`` runs the
  CUDA ``add_rms_norm`` (with ``residual``) or ``rms_norm`` (without) on
  the card. The reference's ``rows % 8 == 0`` condition is a TPU tiling
  limit and is dropped.
- ``masked_multihead_attention`` runs the CUDA ``decode_attention`` kernel
  (its plain version on the CPU) unless ``src_mask`` is given: the kernel
  takes no mask, so a mask takes the plain route on every device.
- ``fp8_gemm`` and ``fp8_linear`` (``paddle_tpu/incubate/nn/functional/
  fp8.py:26-54``) are ``quant.inline_scaled_gemm(dtype="fp8")``: e4m3
  operands with per-tensor absmax scales (``torch._scaled_mm`` on the card,
  the plain route on the CPU) and the wide backward.
- ``fused_multi_head_attention`` (and so ``fused_multi_transformer``) runs
  the non-causal flash op (``ops.kernels.flash_attention``: the forward
  kernel and, in training, the fused backward or the split pair) unless an
  ``attn_mask`` is given or attention dropout is active: those take the
  plain attention of the JAX package's ``_xla_sdpa`` on every device.
- ``paged_attention`` and the decode steps of ``block_multihead_attention``
  run the ``paged_attention`` kernel. The latter's cache is page-major
  ``[MaxBlockNum, H, BlockSize, D]``; the kernel reads it in place through
  a transposed view (head and page strides as launch arguments), with no
  copy. Prefill and mixed batches, and a decode step under ``tgt_mask``,
  take the JAX package's plain f32 attention.
- ``fused_linear_cross_entropy`` runs the port's chunked CE head
  (``nn.functional.fused_cross_entropy``) on each chunk of rows, under the
  same int8-head gate as the Pipe's head.
- ``fused_moe`` is the MoE layer's dense GShard dispatch
  (``incubate.distributed.models.moe``) at the full token count as the
  capacity.

Activation functions follow the JAX package: its functional ops use
``jax.nn.gelu``, whose default is the tanh approximation
(``fused_bias_act``, ``fused_linear_activation``, ``fused_feedforward``,
``fused_moe``, so ``fused_multi_transformer``), where the ``Fused*``
layers (``incubate.nn.layer``) use paddle's exact erf gelu.

Dropout draws from a ``torch.Generator`` (the ``generator`` keyword; the
device's default generator when it is None) where the JAX package draws
from its global key chain; at rate 0 or ``training=False`` nothing is
drawn and the ops are deterministic. Arguments the JAX package accepts and
ignores raise ``NotImplementedError`` here, as for the decode ops above.
"""
from __future__ import annotations

import functools
import inspect
import math

import numpy as np
import torch
import torch.nn.functional as F

from ....core.dispatch import apply_op, unwrap
from ....nn.functional.activation import swiglu as _swiglu
from ....ops.kernels.add_rms_norm import add_rms_norm
from ....ops.kernels.decode_attention import decode_attention
from ....ops.kernels.decode_attention import \
    paged_attention as _paged_attention_kernel
from ....ops.kernels.flash_attention import flash_attention
from ....ops.kernels.rms_norm import rms_norm
from ....quant.gemm import inline_scaled_gemm
from ...distributed.models.moe import _dense_dispatch_combine
from ....nn.functional.fused_cross_entropy import (_ChunkedCE,
                                                   int8_head_enabled,
                                                   record_head_mode,
                                                   resolve_vocab_chunk)

__all__ = ["blha_get_max_len", "block_multihead_attention", "fp8_gemm",
           "fp8_linear", "fused_bias_act",
           "fused_bias_dropout_residual_layer_norm", "fused_dropout_add",
           "fused_feedforward", "fused_layer_norm", "fused_linear",
           "fused_linear_activation", "fused_linear_cross_entropy",
           "fused_matmul_bias", "fused_moe", "fused_multi_head_attention",
           "fused_multi_transformer", "fused_rms_norm",
           "fused_rotary_position_embedding", "masked_multihead_attention",
           "paged_attention", "swiglu",
           "variable_length_memory_efficient_attention"]


def _refuse(op, **given):
    """Raise for the arguments the JAX package accepts and ignores: each
    ``name=(value, default)`` whose value is not its default."""
    bad = []
    for k, (v, d) in given.items():
        if (v is not None) if d is None else (v != d):
            bad.append(k)
    if bad:
        raise NotImplementedError(f"{op}: {', '.join(bad)} not ported")


def _gelu_tanh(a):
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(a, approximate="tanh")


def _dropout(x, p, training=True, mode="upscale_in_train", generator=None):
    """Paddle's dropout (``paddle_tpu/nn/functional/common.py:37-59``): each
    element kept with probability ``1 - p`` (drawn from ``generator``, the
    device's default when None), scaled by ``1 / (1 - p)`` under
    ``upscale_in_train``; the input itself when not training or at p 0."""
    if not training or p == 0:
        return x
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    kept = x / keep if mode == "upscale_in_train" else x
    return torch.where(mask, kept, torch.zeros((), dtype=x.dtype,
                                               device=x.device)).to(x.dtype)


def _layer_norm_f32(a, scale, bias, eps):
    """The fused ops' LayerNorm over the last axis: mean and variance in
    f32, normalised and rounded to ``a``'s type, then the affine."""
    af = a.float()
    mean = af.mean(-1, keepdim=True)
    var = af.var(-1, keepdim=True, correction=0)
    out = ((a - mean) * torch.rsqrt(var + eps)).to(a.dtype)
    if scale is not None:
        out = out * scale
    if bias is not None:
        out = out + bias
    return out


def fused_rms_norm_arrays(x, norm_weight, norm_bias=None, epsilon=1e-6,
                          begin_norm_axis=-1, bias=None, residual=None,
                          quant_scale=-1):
    """RMS norm over the axes from ``begin_norm_axis`` on, with an optional
    pre-norm ``bias`` and residual add. With ``residual`` returns
    ``(out, residual_out)``, ``residual_out = x (+ bias) + residual`` being
    the updated residual stream; without it, ``out``. Quantized output
    (``quant_scale > 0``) is not ported and raises."""
    if quant_scale is not None and quant_scale > 0:
        raise NotImplementedError(
            "fused_rms_norm: quantized output (quant_scale > 0) is not "
            "ported")
    a = x if bias is None else x + bias
    ax = begin_norm_axis % a.ndim
    fast = ax == a.ndim - 1 and norm_bias is None and a.is_cuda
    if residual is not None:
        if fast:
            y, out = add_rms_norm(a, residual, norm_weight, epsilon)
            return out, y
        a = a + residual
    if fast:
        return rms_norm(a, norm_weight, epsilon)
    axes = tuple(range(ax, a.ndim))
    af = a.float()
    var = af.square().mean(axes, keepdim=True)
    out = (af * torch.rsqrt(var + epsilon)).to(a.dtype) * norm_weight
    if norm_bias is not None:
        out = out + norm_bias
    return (out, a) if residual is not None else out


def fp8_gemm_arrays(x, y, transpose_x=False, transpose_y=False, name=None):
    """``x @ y`` on the fp8 path: x [..., M, K] (2-D or more), y [K, N];
    the transpose flags are ``paddle.matmul``'s."""
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    return inline_scaled_gemm(x, y, dtype="fp8")


def fp8_linear_arrays(x, weight, bias=None, name=None):
    """``x @ weight (+ bias)`` on the fp8 path, weight ``[in, out]``."""
    out = inline_scaled_gemm(x, weight, dtype="fp8")
    return out if bias is None else out + bias


def swiglu_arrays(x, y=None, name=None):
    """``silu(x) * y``; with ``y`` None, x's last axis is split in halves."""
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return F.silu(x) * y


def masked_multihead_attention_arrays(x, cache_kv=None, bias=None,
                                      src_mask=None, sequence_lengths=None,
                                      rotary_tensor=None,
                                      beam_cache_offset=None,
                                      qkv_out_scale=None, out_shift=None,
                                      out_smooth=None, seq_len=1,
                                      rotary_emb_dims=0,
                                      use_neox_rotary_style=False,
                                      compute_dtype="default", out_scale=-1,
                                      quant_round_type=1,
                                      quant_max_bound=127.0,
                                      quant_min_bound=-127.0, name=None):
    """One-token decode attention over a dense ``cache_kv [2, B, H, MaxLen,
    D]``: ``x [B, 3 * H * D]`` packs q, k and v (plus ``bias``). Row b's k
    and v are written IN PLACE at position ``cur[b] = sequence_lengths[b]``
    (0 without lengths), then q attends to rows ``0..cur[b]``. Returns
    ``(out [B, H * D], cache_kv)``.

    Without ``src_mask`` the attention is ``decode_attention`` with lengths
    ``cur + 1`` and q cast to the cache type: the CUDA kernel on the card,
    its plain version on the CPU. With ``src_mask`` it is the JAX package's
    plain route on every device, since the kernel takes no mask, and the
    output is f32 as the JAX package's is, whatever the cache's type.

    ``rotary_tensor``, ``beam_cache_offset`` and the quantization
    arguments, which the JAX package silently ignores, raise
    ``NotImplementedError``: apply rope to q and k before packing them."""
    given = dict(rotary_tensor=rotary_tensor,
                 beam_cache_offset=beam_cache_offset,
                 qkv_out_scale=qkv_out_scale, out_shift=out_shift,
                 out_smooth=out_smooth)
    bad = [k for k, v in given.items() if v is not None]
    if out_scale is not None and out_scale > 0:
        bad.append("out_scale")
    if bad:
        raise NotImplementedError(
            f"masked_multihead_attention: {', '.join(bad)} not ported")
    if cache_kv is None:
        raise ValueError("masked_multihead_attention needs cache_kv "
                         "[2, B, H, MaxLen, D]")
    b = x.shape[0]
    _, _, h, max_len, d = cache_kv.shape
    qkv = x.reshape(b, 3, h, d)
    if bias is not None:
        qkv = qkv + bias.reshape(1, 3, h, d)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    dev = cache_kv.device
    if sequence_lengths is not None:
        cur = sequence_lengths.reshape(-1).to(dev, torch.long)
    else:
        cur = torch.zeros(b, dtype=torch.long, device=dev)
    bidx = torch.arange(b, device=dev)
    kc, vc = cache_kv[0], cache_kv[1]
    kc[bidx, :, cur] = k.to(kc.dtype)
    vc[bidx, :, cur] = v.to(vc.dtype)
    if src_mask is None:
        out = decode_attention(q.to(kc.dtype).contiguous(), kc, vc,
                               (cur + 1).to(torch.int32))
        return out.reshape(b, h * d), cache_kv
    # the JAX package's scale is a strongly typed f32 array, so q * scale,
    # the logits, the probabilities and the output are f32 whatever the
    # cache's type; a 0-d f32 tensor would not promote a bf16 q here
    scale = 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32,
                                          device=dev))
    logits = torch.einsum("bhd,bhtd->bht", q.float() * scale, kc.float())
    valid = (torch.arange(max_len, device=dev)[None, None, :]
             <= cur[:, None, None])
    logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    logits = logits + src_mask.reshape(b, 1, -1)[:, :, :max_len]
    probs = torch.softmax(logits, -1)
    out = torch.einsum("bht,bhtd->bhd", probs, vc.float())
    return out.reshape(b, h * d), cache_kv


# ---------------------------------------------------------------------------
# norms, rope, activations, GEMMs (plain PyTorch; XLA's in the JAX package)
def fused_layer_norm_arrays(x, norm_weight, norm_bias=None, epsilon=1e-5,
                            begin_norm_axis=-1, bias=None, residual=None,
                            quant_scale=-1):
    """LayerNorm over the axes from ``begin_norm_axis`` on (mean and
    variance in f32), after an optional ``bias`` and residual add; with
    ``residual`` returns ``(out, residual_out)`` (:58-77)."""
    _refuse("fused_layer_norm", quant_scale=(quant_scale, -1))
    a = x if bias is None else x + bias
    if residual is not None:
        a = a + residual
    ax = begin_norm_axis % a.ndim
    axes = tuple(range(ax, a.ndim))
    af = a.float()
    mean = af.mean(axes, keepdim=True)
    var = af.var(axes, keepdim=True, correction=0)
    out = ((af - mean) * torch.rsqrt(var + epsilon)).to(a.dtype)
    if norm_weight is not None:
        out = out * norm_weight
    if norm_bias is not None:
        out = out + norm_bias
    return (out, a) if residual is not None else out


def _apply_rotary(x, sin, cos, neox):
    """Rope on ``x [..., D]`` with ``sin``/``cos`` broadcastable to
    ``[..., D/2]`` (:80-92): neox rotates the two halves, otherwise
    interleaved pairs; the result in x's type."""
    d = x.shape[-1]
    if neox:
        x1, x2 = x[..., : d // 2], x[..., d // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                         -1).to(x.dtype)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.stack([o1, o2], -1).reshape(x.shape).to(x.dtype)


def _rotary_sin_cos(pos, d, theta):
    """The rope table's rows at integer positions ``pos`` -> (sin, cos),
    ``[..., D/2]`` f32 (:95-99)."""
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                  device=pos.device) / d)
    freqs = pos.float()[..., None] * inv
    return torch.sin(freqs), torch.cos(freqs)


def fused_rotary_position_embedding_arrays(q, k=None, v=None, sin=None,
                                           cos=None, position_ids=None,
                                           use_neox_rotary_style=True,
                                           time_major=False,
                                           rotary_emb_base=10000.0):
    """Rope on each given tensor of ``q``, ``k``, ``v`` ``[B, S, H, D]``
    (:102-128): at positions 0..S-1 from ``rotary_emb_base``, or from the
    caller's ``sin``/``cos`` (read as ``[rows, -1]`` over their last two
    axes, the first D/2 columns). Returns ``(q, k, v)`` with None where
    none was given. ``position_ids`` and ``time_major``, which the JAX
    package ignores, raise."""
    _refuse("fused_rotary_position_embedding",
            position_ids=(position_ids, None), time_major=(time_major, False))

    def one(x):
        d = x.shape[-1]
        if sin is None:
            pos = torch.arange(x.shape[1], dtype=torch.float32,
                               device=x.device)
            sin_l, cos_l = _rotary_sin_cos(pos, d, rotary_emb_base)
        else:
            sin_l = sin.reshape(sin.shape[-2], -1)[:, : d // 2]
            cos_l = cos.reshape(cos.shape[-2], -1)[:, : d // 2]
        return _apply_rotary(x, sin_l[None, :, None, :],
                             cos_l[None, :, None, :], use_neox_rotary_style)

    return tuple(None if t is None else one(t) for t in (q, k, v))


def fused_bias_act_arrays(x, bias=None, dequant_scales=None, shift=None,
                          smooth=None, act_method="gelu"):
    """``act(x + bias)`` (:137-148): ``gelu`` and ``geglu`` the tanh gelu of
    the whole input, ``swiglu`` ``silu(first half) * second half``, any
    other method relu. The quantization arguments raise."""
    _refuse("fused_bias_act", dequant_scales=(dequant_scales, None),
            shift=(shift, None), smooth=(smooth, None))
    a = x if bias is None else x + bias
    if act_method in ("gelu", "geglu"):
        return _gelu_tanh(a)
    if act_method == "swiglu":
        a1, a2 = a.chunk(2, dim=-1)
        return F.silu(a1) * a2
    return F.relu(a)


def fused_linear_arrays(x, weight, bias=None, transpose_weight=False,
                        name=None):
    """``x @ weight (+ bias)``, weight ``[in, out]`` (``[out, in]`` with
    ``transpose_weight``) (:151-160)."""
    out = x @ (weight.t() if transpose_weight else weight)
    return out if bias is None else out + bias


def fused_matmul_bias_arrays(x, y, bias=None, transpose_x=False,
                             transpose_y=False, name=None):
    """``x @ y (+ bias)``, each operand's last two axes swapped where its
    flag asks (:296-308)."""
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    out = x @ y
    return out if bias is None else out + bias


_ACTIVATIONS = {"gelu": _gelu_tanh, "relu": F.relu, "none": lambda a: a,
                "": lambda a: a}


def fused_linear_activation_arrays(x, y, bias=None, trans_x=False,
                                   trans_y=False, activation="gelu",
                                   name=None):
    """``act(fused_matmul_bias(...))`` with ``gelu`` (tanh), ``relu`` or
    ``none`` (:311-316)."""
    return _ACTIVATIONS[activation](
        fused_matmul_bias_arrays(x, y, bias, trans_x, trans_y))


def fused_dropout_add_arrays(x, y, p=0.5, training=True,
                             mode="upscale_in_train", name=None,
                             generator=None):
    """``dropout(x) + y`` (:290-293)."""
    return _dropout(x, p, training, mode, generator) + y


def fused_bias_dropout_residual_layer_norm_arrays(x, residual, bias=None,
                                                  ln_scale=None, ln_bias=None,
                                                  dropout_rate=0.5,
                                                  ln_epsilon=1e-5,
                                                  training=True,
                                                  mode="upscale_in_train",
                                                  name=None, generator=None):
    """``layer_norm(dropout(x + bias) + residual)`` (:493-520), the dropout
    upscaled whatever ``mode`` says, as the JAX package's."""
    h = x if bias is None else x + bias
    h = _dropout(h, dropout_rate, training, "upscale_in_train", generator)
    return _layer_norm_f32(h + residual, ln_scale, ln_bias, ln_epsilon)


def blha_get_max_len_arrays(seq_lens_encoder, seq_lens_decoder, batch_size):
    """``(max(seq_lens_encoder), max(seq_lens_decoder))`` (:644-649)."""
    return seq_lens_encoder.max(), seq_lens_decoder.max()


# ---------------------------------------------------------------------------
# the LM head's loss
def fused_linear_cross_entropy_arrays(x, weight, labels, transpose_y=True,
                                      chunk_size=512, ignore_index=-100,
                                      name=None):
    """Mean cross entropy of ``x @ weight^T`` (``transpose_y``, weight
    ``[V, H]``; else ``[H, V]``) against ``labels`` over the rows whose
    label is not ``ignore_index``, without the ``[N, V]`` logits
    (:224-287).

    The flattened rows are padded with ignored rows to a multiple of
    ``chunk_size`` (the JAX package's ``PTPU_CE_CHUNK``, a keyword here)
    and each chunk of rows runs the port's chunked CE head, whose logits
    are ``[chunk_size, 8192]`` blocks in f32, or in int8 where
    ``int8_head_enabled`` (the gate the Pipe's head takes) says so. Each
    chunk's backward recomputes its logits."""
    h = x.reshape(-1, x.shape[-1])
    y = labels.reshape(-1).long()
    n = h.shape[0]
    c = min(max(1, int(chunk_size)), n)
    pad = (-n) % c
    if pad:
        h = torch.cat([h, h.new_zeros(pad, h.shape[1])])
        y = torch.cat([y, y.new_full((pad,), ignore_index)])
    w2 = weight if transpose_y else weight.t()
    int8 = int8_head_enabled(h.device)
    chunk = resolve_vocab_chunk(w2.shape[0])
    record_head_mode("chunked", int8, y.numel(), chunk)
    valid = y != ignore_index
    mask = valid.float()
    yv = torch.where(valid, y, torch.zeros_like(y))
    total = sum(_ChunkedCE.apply(h[i:i + c], w2, yv[i:i + c],
                                 mask[i:i + c], chunk, bool(int8))
                for i in range(0, h.shape[0], c))
    return total / mask.sum().clamp_min(1.0)


# ---------------------------------------------------------------------------
# fused transformer layers: attention on the non-causal flash op
def _sdpa_plain(q, k, v, mask=None, dropout_p=0.0, generator=None):
    """Non-causal attention under a mask or attention dropout, as the JAX
    package's ``_xla_sdpa`` (``nn/functional/flash_attention.py:20-44``):
    ``[B, S, H, D]``; a bool mask keeps its True entries, any other is
    added to the scores; f32 softmax, probabilities rounded to q's type,
    then dropped (kept with ``1 - dropout_p``, upscaled)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    logits = torch.einsum("bhsd,bhtd->bhst", qh * scale, kh)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, -math.inf)
        else:
            logits = logits + mask
    probs = torch.softmax(logits.float(), -1).to(q.dtype)
    probs = _dropout(probs, dropout_p, True, "upscale_in_train", generator)
    return torch.einsum("bhst,bhtd->bhsd", probs, vh).transpose(1, 2)


def _attention(q, k, v, mask, dropout_p, training, generator):
    """The attention core of the fused layers: the flash op (non-causal)
    unless a mask is given or attention dropout is active."""
    if mask is None and (dropout_p == 0.0 or not training):
        return flash_attention(q, k, v, causal=False)
    return _sdpa_plain(q, k, v, mask, dropout_p if training else 0.0,
                       generator)


def fused_multi_head_attention_arrays(x, qkv_weight, linear_weight,
                                      pre_layer_norm=False, pre_ln_scale=None,
                                      pre_ln_bias=None, ln_scale=None,
                                      ln_bias=None, pre_ln_epsilon=1e-5,
                                      qkv_bias=None, linear_bias=None,
                                      cache_kv=None, attn_mask=None,
                                      dropout_rate=0.5, attn_dropout_rate=0.5,
                                      ln_epsilon=1e-5, training=True,
                                      mode="upscale_in_train", ring_id=-1,
                                      add_residual=True, num_heads=None,
                                      transpose_qkv_wb=False, name=None,
                                      generator=None):
    """Fused self-attention block on ``x [B, S, E]`` (:319-404): optional
    pre-LayerNorm, the qkv projection (``qkv_weight [3, H, D, E]`` with
    ``qkv_bias [3, H, D]``, or ``[E, 3E]`` and ``[3E]`` under
    ``transpose_qkv_wb`` with ``num_heads``), non-causal attention, the
    output projection ``linear_weight [H*D, E]``, dropout, the residual and
    the post-LayerNorm without ``pre_layer_norm``.

    The attention is the non-causal flash op, unless ``attn_mask`` is given
    or attention dropout is active (``training`` and ``attn_dropout_rate >
    0``: the defaults): then the plain attention. ``cache_kv`` raises, as
    the JAX package's does; ``mode`` and ``ring_id``, which it ignores,
    raise."""
    if cache_kv is not None:
        raise NotImplementedError(
            "fused_multi_head_attention cache_kv: use the kv-cache decode "
            "path (models/llama.py generate) or masked_multihead_attention")
    _refuse("fused_multi_head_attention", mode=(mode, "upscale_in_train"),
            ring_id=(ring_id, -1))
    b, s, e = x.shape
    h = x
    if pre_layer_norm:
        h = _layer_norm_f32(x, pre_ln_scale, pre_ln_bias, pre_ln_epsilon)
    if transpose_qkv_wb:
        nh = num_heads
        qkv = h @ qkv_weight
        if qkv_bias is not None:
            qkv = qkv + qkv_bias
        q, k, v = qkv.chunk(3, dim=-1)
        hd = e // nh
    else:
        _, nh, hd, _ = qkv_weight.shape
        qkv = torch.einsum("bse,nhde->bsnhd", h, qkv_weight)
        if qkv_bias is not None:
            qkv = qkv + qkv_bias[None, None]
        q, k, v = qkv.unbind(2)
    q, k, v = (t.reshape(b, s, nh, hd) for t in (q, k, v))
    out = _attention(q, k, v, attn_mask, attn_dropout_rate, training,
                     generator).reshape(b, s, nh * hd)
    out = out @ linear_weight
    if linear_bias is not None:
        out = out + linear_bias
    out = _dropout(out, dropout_rate, training, "upscale_in_train",
                   generator)
    if add_residual:
        out = x + out
    if not pre_layer_norm:
        out = _layer_norm_f32(out, ln_scale, ln_bias, ln_epsilon)
    return out


def fused_feedforward_arrays(x, linear1_weight, linear2_weight,
                             linear1_bias=None, linear2_bias=None,
                             ln1_scale=None, ln1_bias=None, ln2_scale=None,
                             ln2_bias=None, dropout1_rate=0.5,
                             dropout2_rate=0.5, activation="relu",
                             ln1_epsilon=1e-5, ln2_epsilon=1e-5,
                             pre_layer_norm=False, training=True,
                             mode="upscale_in_train", ring_id=-1, name=None,
                             generator=None):
    """Fused FFN block (:407-451): optional pre-LayerNorm (``ln1_*``),
    ``act(x @ w1 + b1)`` with ``relu`` or the tanh ``gelu``, dropout, ``@ w2
    + b2``, dropout, the residual, the post-LayerNorm (``ln2_*``) without
    ``pre_layer_norm``."""
    _refuse("fused_feedforward", mode=(mode, "upscale_in_train"),
            ring_id=(ring_id, -1))
    act = {"relu": F.relu, "gelu": _gelu_tanh}[activation]
    h = x
    if pre_layer_norm:
        h = _layer_norm_f32(h, ln1_scale, ln1_bias, ln1_epsilon)
    h = h @ linear1_weight
    h = act(h if linear1_bias is None else h + linear1_bias)
    h = _dropout(h, dropout1_rate, training, "upscale_in_train", generator)
    h = h @ linear2_weight
    if linear2_bias is not None:
        h = h + linear2_bias
    h = _dropout(h, dropout2_rate, training, "upscale_in_train", generator)
    out = x + h
    if not pre_layer_norm:
        out = _layer_norm_f32(out, ln2_scale, ln2_bias, ln2_epsilon)
    return out


def _multi_transformer(mha, ffn, x, ln_scales, ln_biases, qkv_weights,
                       qkv_biases, linear_weights, linear_biases,
                       ffn_ln_scales, ffn_ln_biases, ffn1_weights,
                       ffn1_biases, ffn2_weights, ffn2_biases,
                       pre_layer_norm=True, epsilon=1e-05, cache_kvs=None,
                       pre_caches=None, seq_lens=None, rotary_embs=None,
                       time_step=None, attn_mask=None, dropout_rate=0.0,
                       activation="gelu", training=False, mode=None,
                       trans_qkvw=True, ring_id=-1, name=None,
                       generator=None):
    """Stacked fused layers, context (prefill) form (:454-490): per layer
    ``mha`` (:func:`fused_multi_head_attention`, ``qkv_weights[i]`` ``[3,
    H, D, E]``) then ``ffn`` (:func:`fused_feedforward`), each with its
    default epsilon, the post-LayerNorms without affine. ``cache_kvs``,
    ``pre_caches`` and ``time_step`` raise, as the JAX package's do; the
    arguments it ignores (``epsilon``, ``seq_lens``, ``rotary_embs``,
    ``mode``, ``trans_qkvw=False``, ``ring_id``) raise."""
    if cache_kvs is not None or time_step is not None \
            or pre_caches is not None:
        raise NotImplementedError(
            "fused_multi_transformer incremental decode (cache_kvs/"
            "time_step): use models/llama.py generate() — the fixed-shape "
            "kv-cache decode path")
    _refuse("fused_multi_transformer", epsilon=(epsilon, 1e-05),
            seq_lens=(seq_lens, None), rotary_embs=(rotary_embs, None),
            mode=(mode, None), trans_qkvw=(trans_qkvw, True),
            ring_id=(ring_id, -1))
    out = x
    for i in range(len(qkv_weights)):
        out = mha(
            out, qkv_weights[i], linear_weights[i],
            pre_layer_norm=pre_layer_norm,
            pre_ln_scale=ln_scales[i] if ln_scales else None,
            pre_ln_bias=ln_biases[i] if ln_biases else None,
            qkv_bias=qkv_biases[i] if qkv_biases else None,
            linear_bias=linear_biases[i] if linear_biases else None,
            attn_mask=attn_mask, dropout_rate=dropout_rate,
            attn_dropout_rate=dropout_rate, training=training,
            generator=generator)
        out = ffn(
            out, ffn1_weights[i], ffn2_weights[i],
            linear1_bias=ffn1_biases[i] if ffn1_biases else None,
            linear2_bias=ffn2_biases[i] if ffn2_biases else None,
            ln1_scale=ffn_ln_scales[i] if ffn_ln_scales else None,
            ln1_bias=ffn_ln_biases[i] if ffn_ln_biases else None,
            pre_layer_norm=pre_layer_norm, activation=activation,
            dropout1_rate=dropout_rate, dropout2_rate=dropout_rate,
            training=training, generator=generator)
    return out


def fused_moe_arrays(x, gate_weight, expert_weights1, expert_biases1,
                     expert_weights2, expert_biases2, moe_topk=2,
                     norm_topk_prob=True, group_moe=False, name=None):
    """MoE FFN (:523-560): top-k of ``x @ gate_weight``, the GShard dense
    dispatch at the full token count as the capacity (nothing dropped),
    stacked expert FFNs ``[E, M, H]`` / ``[E, H, M]`` around the tanh gelu,
    the combine in f32. Without ``norm_topk_prob`` each token's weights are
    rescaled to the full softmax's mass of its chosen experts.
    ``group_moe`` raises, as the JAX package's does."""
    if group_moe:
        raise NotImplementedError("fused_moe group_moe")
    shape = x.shape
    flat = x.reshape(-1, shape[-1])
    logits = flat @ gate_weight
    val, idx = torch.topk(logits, moe_topk, dim=-1)
    ei, comb, _ = _dense_dispatch_combine(flat, idx, val, logits.shape[-1],
                                          flat.shape[0])
    if not norm_topk_prob:
        sel = torch.softmax(logits, -1).gather(-1, idx).sum(-1)
        comb = comb * sel[:, None, None]
    h = torch.einsum("ecm,emh->ech", ei, expert_weights1)
    if expert_biases1 is not None:
        h = h + expert_biases1[:, None]
    h = _gelu_tanh(h)
    y = torch.einsum("ech,ehm->ecm", h, expert_weights2)
    if expert_biases2 is not None:
        y = y + expert_biases2[:, None]
    out = torch.einsum("nec,ecm->nm", comb.float(), y.float()).to(x.dtype)
    return out.reshape(shape)


def variable_length_memory_efficient_attention_arrays(query, key, value,
                                                      seq_lens, kv_seq_lens,
                                                      mask=None, scale=None,
                                                      causal=False,
                                                      pre_cache_length=0,
                                                      name=None):
    """Attention over padded batches ``[B, H, S, D]`` (:563-588): key rows
    at or past ``kv_seq_lens[b]`` masked (and, with ``causal``, keys past
    the query's position plus ``pre_cache_length``), an additive ``mask``;
    softmax in the inputs' type. ``seq_lens`` is not read, as in the JAX
    package: rows past a sequence's length hold what they compute."""
    b, h, s, d = query.shape
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bhsd,bhtd->bhst", query * sc, key)
    kpos = torch.arange(key.shape[2], device=query.device)[None, None,
                                                           None, :]
    valid = kpos < kv_seq_lens.reshape(-1).to(query.device)[:, None, None,
                                                            None]
    if causal:
        qpos = torch.arange(s, device=query.device)[None, None, :, None]
        valid = valid & (kpos <= qpos + pre_cache_length)
    if mask is not None:
        logits = logits + mask
    logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    return torch.einsum("bhst,bhtd->bhsd", torch.softmax(logits, -1), value)


# ---------------------------------------------------------------------------
# paged-KV attention
def paged_attention_arrays(q, k_pages, v_pages, block_tables, lengths,
                           scale=None):
    """Paged-KV decode attention (:652-662): q ``[B, Hq, D]``, pages
    ``[Hkv, NumPages, PageSize, D]`` (or a view with those sizes), tables
    ``[B, PagesPerSeq]``, lengths ``[B]`` counting the current row. The
    ``paged_attention`` kernel on CUDA tensors, its plain version on the
    CPU."""
    return _paged_attention_kernel(q, k_pages, v_pages,
                                   block_tables.to(torch.int32),
                                   lengths.reshape(-1).to(torch.int32),
                                   scale=scale)


def _host_ints(t):
    return np.asarray(t.detach().reshape(-1).cpu().numpy()).astype(np.int64)


def _blha_lengths(seq_lens_encoder, seq_lens_decoder, seq_lens_this_time):
    """The three length vectors on the host, and whether the step is a
    decode step (every live slot one token, no encoder tokens)."""
    enc, dec = _host_ints(seq_lens_encoder), _host_ints(seq_lens_decoder)
    this = _host_ints(seq_lens_this_time)
    live = this > 0
    return enc, dec, this, bool((this[live] == 1).all() and (enc == 0).all())


def block_multihead_attention_arrays(qkv, key_cache, value_cache,
                                     seq_lens_encoder, seq_lens_decoder,
                                     seq_lens_this_time, padding_offsets,
                                     cum_offsets, cu_seqlens_q, cu_seqlens_k,
                                     block_tables, pre_key_cache=None,
                                     pre_value_cache=None,
                                     cache_k_quant_scales=None,
                                     cache_v_quant_scales=None,
                                     cache_k_dequant_scales=None,
                                     cache_v_dequant_scales=None,
                                     qkv_out_scale=None, qkv_bias=None,
                                     out_shift=None, out_smooth=None,
                                     max_enc_len_this_time=None,
                                     max_dec_len_this_time=None, rope_emb=None,
                                     mask=None, tgt_mask=None, max_seq_len=-1,
                                     block_size=64, use_neox_style=False,
                                     rope_theta=10000.0, _lengths=None):
    """Paged-KV attention over PaddlePaddle's block cache (:665-842).

    ``qkv [T, (Hq + 2 Hkv) * D]`` holds the step's tokens, sequence by
    sequence (``seq_lens_this_time[b]`` rows each, 0 for a finished
    slot); ``key_cache``/``value_cache`` are ``[MaxBlockNum, Hkv,
    BlockSize, D]``, found through ``block_tables [B, BlocksPerSeq]``;
    ``seq_lens_decoder[b]`` counts the tokens already cached. Rope, where
    ``rope_emb [2, B, max_seq, 1, D/2]`` (cos rows, then sin) is given,
    comes from that table, else none is applied; ``use_neox_style`` picks
    the halves or interleaved pairs. Each token's k and v are written into
    its page in place.

    - Decode (every live slot one token, every ``seq_lens_encoder`` 0):
      the live slots' q attend through the ``paged_attention`` kernel,
      which reads the page-major cache in place (a transposed view: no
      copy); under ``tgt_mask`` the plain dense gather instead.
    - Prefill or mixed: per sequence, causal f32 attention over its
      gathered pages, plus ``mask[b, 0]`` where given.

    The int8 cache and output quantization arguments raise, as the JAX
    package's do; ``pre_key_cache``/``pre_value_cache``, which it ignores,
    raise. The offsets, cumulative lengths, maxima, ``max_seq_len`` and
    ``block_size`` are derived metadata the JAX package does not read
    either (the cache's shape gives the block size). Returns ``(out [T,
    Hq * D], qkv, key_cache, value_cache)``, the caches the tensors given,
    updated. ``_lengths`` is :func:`_blha_lengths` of the three length
    vectors where the caller has read them already."""
    if any(t is not None for t in (cache_k_quant_scales,
                                   cache_v_quant_scales,
                                   cache_k_dequant_scales,
                                   cache_v_dequant_scales, qkv_out_scale,
                                   out_shift, out_smooth)):
        raise NotImplementedError(
            "block_multihead_attention: int8 KV-cache / output quantization "
            "is not implemented")
    _refuse("block_multihead_attention",
            pre_key_cache=(pre_key_cache, None),
            pre_value_cache=(pre_value_cache, None))
    kc, vc = key_cache, value_cache
    dev = kc.device
    nblocks, h, bsz, d = kc.shape
    hq = qkv.shape[-1] // d - 2 * h
    rows = qkv if qkv_bias is None else qkv + qkv_bias.reshape(1, -1)
    tables = block_tables.to(dev, torch.int32)
    enc, dec, this, decode = _lengths or _blha_lengths(
        seq_lens_encoder, seq_lens_decoder, seq_lens_this_time)
    b = this.shape[0]

    def split(r):
        flat = r.reshape(r.shape[0], hq + 2 * h, d)
        return flat[:, :hq], flat[:, hq:hq + h], flat[:, hq + h:]

    def rope_at(x, pos, seq):
        if rope_emb is None:
            return x
        n = pos.shape[0]
        cos_t = rope_emb[0, seq, pos].reshape(n, 1, -1)
        sin_t = rope_emb[1, seq, pos].reshape(n, 1, -1)
        return _apply_rotary(x, sin_t, cos_t, use_neox_style)

    if decode:
        active = np.nonzero(this > 0)[0]
        ba = len(active)
        act = torch.as_tensor(active, device=dev)
        cur = torch.as_tensor(dec[active], device=dev)
        tab = tables[act]
        q, k, v = split(rows)
        q, k = rope_at(q, cur, act), rope_at(k, cur, act)
        pages = tab[torch.arange(ba, device=dev), cur // bsz].long()
        offs = cur % bsz
        kc[pages, :, offs] = k.to(kc.dtype)
        vc[pages, :, offs] = v.to(vc.dtype)
        if tgt_mask is None:
            out = paged_attention_arrays(q.contiguous(), kc.transpose(0, 1),
                                  vc.transpose(0, 1), tab, cur + 1)
        else:
            kd = kc[tab.long()].transpose(1, 2).reshape(ba, h, -1, d)
            vd = vc[tab.long()].transpose(1, 2).reshape(ba, h, -1, d)
            s = kd.shape[2]
            kd = kd.repeat_interleave(hq // h, 1).float()
            vd = vd.repeat_interleave(hq // h, 1).float()
            logits = torch.einsum("bhd,bhtd->bht", q.float() / d ** 0.5, kd)
            valid = (torch.arange(s, device=dev)[None, None, :]
                     <= cur[:, None, None])
            logits = torch.where(valid, logits,
                                 torch.full_like(logits, -1e30))
            logits = logits + tgt_mask.reshape(b, 1, -1)[act, :, :s]
            out = torch.einsum("bht,bhtd->bhd", torch.softmax(logits, -1),
                               vd)
        return out.reshape(ba, hq * d).to(qkv.dtype), qkv, kc, vc
    cu = np.concatenate([[0], np.cumsum(this)])
    outs = []
    for i in range(b):
        t = int(this[i])
        if t == 0:
            continue
        q, k, v = split(rows[int(cu[i]): int(cu[i]) + t])
        start = int(dec[i])
        pos = torch.arange(start, start + t, device=dev)
        q, k = rope_at(q, pos, i), rope_at(k, pos, i)
        kc[tables[i, pos // bsz].long(), :, pos % bsz] = k.to(kc.dtype)
        vc[tables[i, pos // bsz].long(), :, pos % bsz] = v.to(vc.dtype)
        total = start + t
        npg = -(-total // bsz)
        seq_pages = tables[i, :npg].long()
        kseq = kc[seq_pages].transpose(0, 1).reshape(h, -1, d)[:, :total]
        vseq = vc[seq_pages].transpose(0, 1).reshape(h, -1, d)[:, :total]
        if hq != h:
            kseq = kseq.repeat_interleave(hq // h, 0)
            vseq = vseq.repeat_interleave(hq // h, 0)
        logits = torch.einsum("thd,hxd->htx", q.float() / d ** 0.5,
                              kseq.float())
        causal = (torch.arange(total, device=dev)[None, None, :]
                  <= pos[None, :, None])
        logits = torch.where(causal, logits, torch.full_like(logits, -1e30))
        if mask is not None:
            logits = logits + mask[i, 0][start:start + t, :total][None]
        o = torch.einsum("htx,hxd->thd", torch.softmax(logits, -1),
                         vseq.float())
        outs.append(o.reshape(t, hq * d).to(qkv.dtype))
    return torch.cat(outs), qkv, kc, vc


fused_multi_transformer_arrays = functools.partial(
    _multi_transformer, fused_multi_head_attention_arrays,
    fused_feedforward_arrays)


# ---------------------------------------------------------------------------
# the public names, on Tensors
def _on_tensors(body, op_name):
    """The public op over ``body``: ``apply_op`` unwraps its Tensors (in
    lists and tuples too), runs ``body`` on the torch tensors and wraps
    what it returns (tuples of Tensors, None kept), under the reference's
    op name (``op_dispatch_total``, amp's lists)."""
    def op(*args, **kwargs):
        return apply_op(body, *args, _op_name=op_name, **kwargs)

    op.__name__ = op.__qualname__ = body.__name__.removesuffix("_arrays")
    op.__doc__ = body.__doc__
    op.__signature__ = inspect.signature(body)
    op.__wrapped__ = body
    return op


fused_rms_norm = _on_tensors(fused_rms_norm_arrays, "fused_rms_norm")
fused_layer_norm = _on_tensors(fused_layer_norm_arrays, "fused_layer_norm")
fused_rotary_position_embedding = _on_tensors(
    fused_rotary_position_embedding_arrays, "fused_rope")
fused_bias_act = _on_tensors(fused_bias_act_arrays, "fused_bias_act")
fused_linear = _on_tensors(fused_linear_arrays, "fused_linear")
fused_matmul_bias = _on_tensors(fused_matmul_bias_arrays, "fused_matmul_bias")
fused_linear_activation = _on_tensors(fused_linear_activation_arrays,
                                      "fused_linear_activation")
fused_linear_cross_entropy = _on_tensors(fused_linear_cross_entropy_arrays,
                                         "fused_linear_cross_entropy")
fused_dropout_add = _on_tensors(fused_dropout_add_arrays, "fused_dropout_add")
fused_bias_dropout_residual_layer_norm = _on_tensors(
    fused_bias_dropout_residual_layer_norm_arrays,
    "fused_bias_dropout_residual_ln")
fused_multi_head_attention = _on_tensors(fused_multi_head_attention_arrays,
                                         "fused_multi_head_attention")
fused_feedforward = _on_tensors(fused_feedforward_arrays, "fused_feedforward")
fused_moe = _on_tensors(fused_moe_arrays, "fused_moe")
variable_length_memory_efficient_attention = _on_tensors(
    variable_length_memory_efficient_attention_arrays, "varlen_attention")
masked_multihead_attention = _on_tensors(masked_multihead_attention_arrays,
                                         "masked_multihead_attention")
blha_get_max_len = _on_tensors(blha_get_max_len_arrays, "blha_get_max_len")
paged_attention = _on_tensors(paged_attention_arrays, "paged_attention")
fp8_gemm = _on_tensors(fp8_gemm_arrays, "fp8_gemm")
fp8_linear = _on_tensors(fp8_linear_arrays, "fp8_linear")


def swiglu(x, y=None, name=None):
    """``silu(x) * y``; with ``y`` None, x's last axis is split in halves:
    ``nn.functional.swiglu``, as the reference's (:131-134)."""
    return _swiglu(x, y)


def fused_multi_transformer(x, *args, **kwargs):
    """Stacked fused layers on Tensors: the public
    :func:`fused_multi_head_attention` and :func:`fused_feedforward` per
    layer, as the reference composes them (:454-490)."""
    return _multi_transformer(fused_multi_head_attention, fused_feedforward,
                              x, *args, **kwargs)


def block_multihead_attention(qkv, key_cache, value_cache, seq_lens_encoder,
                              seq_lens_decoder, seq_lens_this_time, *args,
                              **kwargs):
    """:func:`block_multihead_attention_arrays` on Tensors under the
    reference's op name of its route (``blha_decode`` or
    ``blha_prefill``), the length vectors read once. Returns ``(out, qkv,
    key_cache, value_cache)``: ``qkv`` the Tensor given, the caches
    Tensors over the tensors updated in place."""
    lengths = _blha_lengths(*(unwrap(t) for t in (
        seq_lens_encoder, seq_lens_decoder, seq_lens_this_time)))
    out, _, kc, vc = apply_op(
        block_multihead_attention_arrays, qkv, key_cache, value_cache,
        seq_lens_encoder, seq_lens_decoder, seq_lens_this_time, *args,
        _lengths=lengths, **kwargs,
        _op_name="blha_decode" if lengths[3] else "blha_prefill")
    return out, qkv, kc, vc


from . import fp8  # noqa: E402,F401
