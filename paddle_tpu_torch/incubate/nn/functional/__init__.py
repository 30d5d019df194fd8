"""The incubate fused decode ops on torch tensors.

Counterpart of ``paddle_tpu/incubate/nn/functional/__init__.py``
(``fused_rms_norm`` :16-55, ``swiglu`` :131, ``masked_multihead_attention``
:591-641): the ops PaddlePaddle users build inference decoders from. They
take and return torch tensors (the port has no ``Tensor`` class).

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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ....ops.kernels.add_rms_norm import add_rms_norm
from ....ops.kernels.decode_attention import decode_attention
from ....ops.kernels.rms_norm import rms_norm
from ....quant.gemm import inline_scaled_gemm

__all__ = ["fp8_gemm", "fp8_linear", "fused_rms_norm",
           "masked_multihead_attention", "swiglu"]


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6,
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


def fp8_gemm(x, y, transpose_x=False, transpose_y=False, name=None):
    """``x @ y`` on the fp8 path: x [..., M, K] (2-D or more), y [K, N];
    the transpose flags are ``paddle.matmul``'s."""
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    return inline_scaled_gemm(x, y, dtype="fp8")


def fp8_linear(x, weight, bias=None, name=None):
    """``x @ weight (+ bias)`` on the fp8 path, weight ``[in, out]``."""
    out = inline_scaled_gemm(x, weight, dtype="fp8")
    return out if bias is None else out + bias


def swiglu(x, y=None, name=None):
    """``silu(x) * y``; with ``y`` None, x's last axis is split in halves."""
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return F.silu(x) * y


def masked_multihead_attention(x, cache_kv=None, bias=None, src_mask=None,
                               sequence_lengths=None, rotary_tensor=None,
                               beam_cache_offset=None, qkv_out_scale=None,
                               out_shift=None, out_smooth=None, seq_len=1,
                               rotary_emb_dims=0, use_neox_rotary_style=False,
                               compute_dtype="default", out_scale=-1,
                               quant_round_type=1, quant_max_bound=127.0,
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
