"""Chunked cross-entropy LM head.

Counterpart of the unsharded path of
``paddle_tpu/nn/functional/fused_cross_entropy.py`` (``_scan_stats`` :178,
``_scan_grads`` :212, ``_chunked_ce_fn`` :263, ``resolve_vocab_chunk`` :244,
``chunked_lm_loss_arrays`` :394): the loss of ``h @ w^T`` against the
labels, computed blockwise over vocab chunks so that neither the f32
``[tokens, vocab]`` logits nor their gradient ever exists whole.

- The forward is an online log-sum-exp over ``[tokens, chunk]`` logit
  blocks (running max, rescaled sum, and the label's logit).
- The backward recomputes each chunk's logits and contracts
  ``softmax - onehot`` into ``dh`` and that chunk's ``dw`` rows.
- Logits and both contractions are in f32 (the JAX package's
  ``preferred_element_type=float32``); bf16 operands are exact in f32.
- Labels equal to ``ignore_index`` are masked out of the sum and the mean.
- The last chunk is narrower where the chunk does not divide the vocab.
  The JAX package pads it with zero rows whose logits it masks to -inf;
  both give the same numbers.

The int8 head and the vocab-sharded head are not ported yet.
"""
from __future__ import annotations

import torch

from ... import telemetry as _telemetry

DEFAULT_VOCAB_CHUNK = 8192


_HEAD_MODE = _telemetry.gauge(
    "loss_head_mode",
    "active LM-head loss path: 1 on the (mode, int8) series that produced "
    "the run's loss (mode: dense|chunked|sharded; int8: on|off)",
    labelnames=("mode", "int8"))
_HEAD_CHUNK_BYTES = _telemetry.gauge(
    "loss_head_chunk_bytes",
    "fp32 bytes of ONE [tokens, chunk] logits block resident per CE scan "
    "step (the chunked head's peak logits footprint; dense = the full "
    "[tokens, vocab] tensor)")

_LAST_HEAD_MODE = [None]


def record_head_mode(mode, int8, tokens, chunk):
    """Set the loss-head telemetry gauges (the reference's :71-80). Only
    one (mode, int8) series reads 1 at a time: the previously active series
    is zeroed, so a run that switches paths names the path of its last
    loss."""
    active = (mode, "on" if int8 else "off")
    prev = _LAST_HEAD_MODE[0]
    if prev is not None and prev != active:
        _HEAD_MODE.set(0, labels=prev)
    _HEAD_MODE.set(1, labels=active)
    _LAST_HEAD_MODE[0] = active
    _HEAD_CHUNK_BYTES.set(int(tokens) * int(chunk) * 4)


def resolve_vocab_chunk(vocab, vocab_chunk=None):
    """Effective chunk: the explicit argument, else 8192; clamped to
    [1, vocab]."""
    c = vocab_chunk or DEFAULT_VOCAB_CHUNK
    return max(1, min(int(c), int(vocab)))


class _ChunkedCE(torch.autograd.Function):
    """Masked sum of per-token CE over vocab chunks: h [N, H], w2 [V, H],
    y [N] int64 (in range), mask [N] f32."""

    @staticmethod
    def forward(ctx, h, w2, y, mask, chunk):
        hf = h.float()
        n = h.shape[0]
        m = torch.full((n,), float("-inf"), device=h.device)
        s = torch.zeros(n, device=h.device)
        gold = torch.zeros(n, device=h.device)
        for c0 in range(0, w2.shape[0], chunk):
            wc = w2[c0:c0 + chunk]
            logits = hf @ wc.float().t()
            m_new = torch.maximum(m, logits.amax(-1))
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(-1)
            yl = y - c0
            hit = (yl >= 0) & (yl < wc.shape[0])
            g = logits.gather(1, yl.clamp(0, wc.shape[0] - 1)[:, None])[:, 0]
            gold = gold + torch.where(hit, g, torch.zeros_like(g))
            m = m_new
        lse = m + torch.log(s)
        ctx.save_for_backward(h, w2, y, mask, lse)
        ctx.chunk = chunk
        return ((lse - gold) * mask).sum()

    @staticmethod
    def backward(ctx, grad):
        h, w2, y, mask, lse = ctx.saved_tensors
        coeff = (grad * mask).float()
        hf = h.float()
        dh = torch.zeros_like(hf)
        dw = torch.empty_like(w2)
        for c0 in range(0, w2.shape[0], ctx.chunk):
            wcf = w2[c0:c0 + ctx.chunk].float()
            p = torch.exp(hf @ wcf.t() - lse[:, None])
            cols = torch.arange(c0, c0 + wcf.shape[0], device=h.device)
            q = (p - (cols[None, :] == y[:, None]).float()) * coeff[:, None]
            dh += q @ wcf
            dw[c0:c0 + ctx.chunk] = (q.t() @ hf).to(w2.dtype)
        return dh.to(h.dtype), dw, None, None, None


def chunked_lm_loss_arrays(h, w, y, *, transpose_y=True, vocab_chunk=None,
                           ignore_index=-100):
    """Mean chunked CE. h [..., H]; w [V, H] (``transpose_y``) or [H, V];
    y [...] integer labels; tokens labelled ``ignore_index`` count for
    nothing."""
    w2 = w if transpose_y else w.t()
    hf = h.reshape(-1, h.shape[-1])
    yf = y.reshape(-1).long()
    valid = yf != ignore_index
    mask = valid.float()
    chunk = resolve_vocab_chunk(w2.shape[0], vocab_chunk)
    record_head_mode("chunked", False, yf.numel(), chunk)
    total = _ChunkedCE.apply(hf, w2, torch.where(valid, yf, 0), mask, chunk)
    return total / mask.sum().clamp_min(1.0)
