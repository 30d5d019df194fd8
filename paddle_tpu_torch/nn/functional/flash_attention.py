"""Attention functionals (counterpart of
``paddle_tpu/nn/functional/flash_attention.py``). Layout ``[batch, seq,
heads, head_dim]``.

:func:`sdpa_arrays` is the one dispatch point to the flash kernels, as the
reference's is to its Pallas kernel: ``ops.kernels.flash_attention
.flash_attention`` takes CUDA tensors to the forward kernel (row 4 of
``PERF.md``'s table) and its backward to the fused or split kernels (rows
7, 5 and 6) by ``bwd_route``, and CPU tensors to their plain versions.
GQA reaches the kernel unrepeated. There is no ``try``/``except`` around
it: the reference's gives way to XLA's attention when its kernel raises,
and here a CUDA tensor on this route reaches the kernel or the call
raises. The reference's head sharding over a mesh
(``_constrain_heads_over_mp``) has no counterpart: the surface runs on one
card.

A mask or an active dropout takes :func:`plain_sdpa`, the counterpart of
``_xla_sdpa``: softmax in f32 over ``q k^T * scale``, a bool mask keeps
``True``, a float mask adds.
"""
from __future__ import annotations

import contextlib
import math

import torch

from ...core.dispatch import apply_op
from ...ops.kernels import flash_attention as _fa


def plain_sdpa(q, k, v, mask=None, causal=False, dropout=0.0, scale=None):
    """Attention in plain torch ops; kv heads are repeated to q's."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, 2)
        v = v.repeat_interleave(rep, 2)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    logits = torch.matmul(qh * scale, kh.transpose(-2, -1))
    if causal:
        s, t = logits.shape[-2], logits.shape[-1]
        keep = torch.ones((s, t), dtype=torch.bool,
                          device=q.device).tril(t - s)
        logits = logits.masked_fill(~keep, float("-inf"))
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, float("-inf"))
        else:
            logits = logits + mask
    probs = torch.softmax(logits.float(), -1).to(q.dtype)
    if dropout > 0.0:
        keep = torch.empty(probs.shape, device=probs.device).bernoulli_(
            1.0 - dropout).bool()
        probs = torch.where(keep, probs / (1.0 - dropout),
                            torch.zeros_like(probs))
    return torch.matmul(probs, vh).transpose(1, 2)


def sdpa_arrays(q, k, v, causal=True, scale=None):
    """Torch-level attention through the flash kernels (their plain
    versions on CPU tensors)."""
    return _fa.flash_attention(q, k, v, causal=causal, scale=scale)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True, name=None):
    def _fa_op(q, k, v):
        if dropout == 0.0 or not training:
            return sdpa_arrays(q, k, v, causal=causal)
        return plain_sdpa(q, k, v, causal=causal, dropout=dropout)

    out = apply_op(_fa_op, query, key, value, _op_name="flash_attention")
    return out, None


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """The kernels without a mask and without active dropout, else
    :func:`plain_sdpa`."""
    def _sdpa(q, k, v, m):
        if m is None and (dropout_p == 0.0 or not training):
            return sdpa_arrays(q, k, v, causal=is_causal)
        return plain_sdpa(q, k, v, mask=m, causal=is_causal,
                          dropout=dropout_p if training else 0.0)

    return apply_op(_sdpa, query, key, value, attn_mask, _op_name="sdpa")


def flashmask_attention(query, key, value, startend_row_indices=None,
                        dropout=0.0, causal=False, window_size=None,
                        return_softmax_lse=False, return_seed_offset=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """Sparse-mask attention: ``startend_row_indices`` ``[B, H, S, 1]``
    masks key ``j`` for the query rows from its start index on; built as
    a dense mask for :func:`plain_sdpa`. Without it, :func:`flash_attention`.
    """
    if startend_row_indices is None:
        return flash_attention(query, key, value, dropout, causal,
                               training=training)[0]

    def _fm(q, k, v, sri):
        s = q.shape[1]
        st = sri[..., 0]                                  # [B, H, S_k]
        i_idx = torch.arange(s, device=q.device)[None, None, :, None]
        allowed = i_idx < st[:, :, None, :]
        if causal:
            j_idx = torch.arange(s, device=q.device)[None, None, None, :]
            allowed = allowed & (j_idx <= i_idx)
        return plain_sdpa(q, k, v, mask=allowed)

    out = apply_op(_fm, query, key, value, startend_row_indices,
                   _op_name="flashmask_attention")
    if return_softmax_lse or return_seed_offset:
        return (out, None, None)[:1 + int(return_softmax_lse)
                                 + int(return_seed_offset)]
    return out


def sdp_kernel(*a, **k):
    """Source compatibility: the route is chosen per call."""
    return contextlib.nullcontext()


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale, dropout=0.0,
                        causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """Varlen attention over packed sequences ``[total, heads, head_dim]``
    with cumulative offsets ``cu_seqlens_*`` ``[batch + 1]``: one dense
    attention under a segment mask, as the reference computes it."""
    def _varlen(q, k, v, cq, ck):
        tq, tk = q.shape[0], k.shape[0]
        ar_q = torch.arange(tq, device=q.device)
        ar_k = torch.arange(tk, device=q.device)
        seg_q = torch.searchsorted(cq, ar_q, right=True) - 1
        seg_k = torch.searchsorted(ck, ar_k, right=True) - 1
        logits = torch.einsum("qhd,khd->hqk", q.float() * scale, k.float())
        mask = seg_q[:, None] == seg_k[None, :]
        if causal:
            pos_q = ar_q - cq[seg_q]
            pos_k = ar_k - ck[seg_k]
            mask = mask & (pos_k[None, :] <= pos_q[:, None])
        logits = logits.masked_fill(~mask[None], -1e30)
        probs = torch.softmax(logits, -1)
        if dropout > 0.0 and training:
            keep = torch.empty(probs.shape, device=probs.device).bernoulli_(
                1.0 - dropout)
            probs = probs * keep / (1.0 - dropout)
        return torch.einsum("hqk,khd->qhd", probs, v.float()).to(q.dtype)

    out = apply_op(_varlen, query, key, value, cu_seqlens_q, cu_seqlens_k,
                   _op_name="flash_attn_unpadded")
    return out, None


__all__ = ["flash_attention", "flash_attn_unpadded", "flashmask_attention",
           "scaled_dot_product_attention", "sdp_kernel"]
