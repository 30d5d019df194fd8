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

The int8 head (the reference's ``:91-241``): with ``int8`` the logits are
``int8(h) @ int8(w_chunk)^T`` in int32, rescaled by the per-token row
scales of h and the per-vocab-row scales of the chunk. The chunk is
quantized inside the loop, so no whole int8 copy of the weight exists.
The backward takes the softmax of the same int8 logits and contracts it
against the real operands (straight through). The product is
``torch._int_mm`` (cuBLAS on the card, exact int32 sums on either
device), the counterpart of the reference's XLA einsum.
:func:`int8_head_enabled` makes it the default on a card whose parity
gate passes (the reference's non-CPU default); the CPU's default stays
f32. The vocab-sharded head is not ported yet.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch
from torch.utils._python_dispatch import _disable_current_modes

from ... import telemetry as _telemetry
from ...core.dispatch import apply_op
from ...device import resolve_device
from ...memory import quantize_rows_int8
from ...quant.gemm import _int_mm

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


# ---------------------------------------------------------------------------
# the int8 head's parity gate

#: the gate's loss tolerance (the reference's PTPU_INT8_HEAD_GATE_TOL)
DEFAULT_INT8_HEAD_TOL = 0.02

_GATE_CACHE = {}


def int8_head_gate(tol=None, device=None):
    """Run (once per tolerance and device type) the int8 head's parity
    probe on ``device`` (default CUDA): chunked CE loss and gradients on a
    fixed probe batch, f32 against int8. It passes when the loss moves by
    less than ``tol`` (relative) and both gradients' mean absolute errors
    stay below ``5 * tol`` of their mean magnitude. A crashed probe warns
    and fails."""
    tol = DEFAULT_INT8_HEAD_TOL if tol is None else float(tol)
    dev = resolve_device(device)
    key = (tol, dev.type)
    if key in _GATE_CACHE:
        return _GATE_CACHE[key]
    rng = np.random.default_rng(0)
    h0 = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32)
                          * 0.5)
    w0 = torch.from_numpy(rng.standard_normal((256, 64)).astype(np.float32)
                          * 0.5)
    y = torch.from_numpy(rng.integers(0, 256, (64,))).to(dev)

    def loss_grads(int8):
        h = h0.to(dev).requires_grad_()
        w = w0.to(dev).requires_grad_()
        loss = chunked_lm_loss_arrays(h, w, y, vocab_chunk=64, int8=int8)
        gh, gw = torch.autograd.grad(loss, (h, w))
        return loss.item(), gh.cpu().numpy(), gw.cpu().numpy()

    try:
        # real tensors even inside a tracing mode (the fake-tensor trace
        # of TrainStep.memory_stats)
        with _disable_current_modes():
            lf, ghf, gwf = loss_grads(False)
            l8, gh8, gw8 = loss_grads(True)
        ok = abs(l8 - lf) / max(abs(lf), 1e-9) < tol
        for g8, gf in ((gh8, ghf), (gw8, gwf)):
            denom = np.abs(gf).mean() + 1e-9
            ok = ok and (np.abs(g8 - gf).mean() / denom < 5 * tol)
    except Exception as e:  # noqa: BLE001 - a crashed probe means off
        warnings.warn(f"int8_head_gate probe crashed ({type(e).__name__}: "
                      f"{e}); the int8 LM head stays off", RuntimeWarning)
        ok = False
    _GATE_CACHE[key] = bool(ok)
    return _GATE_CACHE[key]


def int8_head_enabled(device=None):
    """Whether the head's default on ``device`` is int8: on a card, when
    the parity gate passes; on the CPU, never (there is no int8 rate to
    win there, only quantization noise)."""
    dev = resolve_device(device)
    return dev.type != "cpu" and int8_head_gate(device=dev)


#: per-row absmax int8 of the head's operands (``_quantize_rows``, :134)
_quantize_rows = quantize_rows_int8


def _chunk_logits(hf, wc, qh, sh):
    """One ``[N, c]`` f32 logits block: f32, or (``qh`` given) int8 with the
    chunk's rows quantized here."""
    if qh is None:
        return hf @ wc.float().t()
    qw, sw = _quantize_rows(wc)
    return _int_mm(qh, qw).float() * sh * sw.t()


def resolve_vocab_chunk(vocab, vocab_chunk=None):
    """Effective chunk: the explicit argument, else 8192; clamped to
    [1, vocab]."""
    c = vocab_chunk or DEFAULT_VOCAB_CHUNK
    return max(1, min(int(c), int(vocab)))


class _ChunkedCE(torch.autograd.Function):
    """Masked sum of per-token CE over vocab chunks: h [N, H], w2 [V, H],
    y [N] int64 (in range), mask [N] f32; int8 logits with ``int8``."""

    @staticmethod
    def forward(ctx, h, w2, y, mask, chunk, int8):
        hf = h.float()
        qh, sh = _quantize_rows(h) if int8 else (None, None)
        n = h.shape[0]
        m = torch.full((n,), float("-inf"), device=h.device)
        s = torch.zeros(n, device=h.device)
        gold = torch.zeros(n, device=h.device)
        for c0 in range(0, w2.shape[0], chunk):
            wc = w2[c0:c0 + chunk]
            logits = _chunk_logits(hf, wc, qh, sh)
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
        ctx.int8 = int8
        return ((lse - gold) * mask).sum()

    @staticmethod
    def backward(ctx, grad):
        h, w2, y, mask, lse = ctx.saved_tensors
        coeff = (grad * mask).float()
        hf = h.float()
        qh, sh = _quantize_rows(h) if ctx.int8 else (None, None)
        dh = torch.zeros_like(hf)
        dw = torch.empty_like(w2)
        for c0 in range(0, w2.shape[0], ctx.chunk):
            wc = w2[c0:c0 + ctx.chunk]
            wcf = wc.float()
            # straight through: the contractions take the real operands
            p = torch.exp(_chunk_logits(hf, wc, qh, sh) - lse[:, None])
            cols = torch.arange(c0, c0 + wcf.shape[0], device=h.device)
            q = (p - (cols[None, :] == y[:, None]).float()) * coeff[:, None]
            dh += q @ wcf
            dw[c0:c0 + ctx.chunk] = (q.t() @ hf).to(w2.dtype)
        return dh.to(h.dtype), dw, None, None, None, None


def chunked_lm_loss_arrays(h, w, y, *, transpose_y=True, vocab_chunk=None,
                           ignore_index=-100, int8=None):
    """Mean chunked CE. h [..., H]; w [V, H] (``transpose_y``) or [H, V];
    y [...] integer labels; tokens labelled ``ignore_index`` count for
    nothing. ``int8`` True or False pins the logits' type; None takes
    :func:`int8_head_enabled` for h's device."""
    if int8 is None:
        int8 = int8_head_enabled(h.device)
    w2 = w if transpose_y else w.t()
    hf = h.reshape(-1, h.shape[-1])
    yf = y.reshape(-1).long()
    valid = yf != ignore_index
    mask = valid.float()
    chunk = resolve_vocab_chunk(w2.shape[0], vocab_chunk)
    record_head_mode("chunked", int8, yf.numel(), chunk)
    total = _ChunkedCE.apply(hf, w2, torch.where(valid, yf, 0), mask, chunk,
                             bool(int8))
    return total / mask.sum().clamp_min(1.0)


def chunked_ce_sum(h, w2, y, mask, *, vocab_chunk=None, int8=False):
    """Masked sum of the chunked CE (the reference's ``:291``): h [N, H]
    (or [..., H]); w2 [V, H], vocab-major; y [N] integer labels in range;
    mask [N] f32. Divide by the mask's sum outside for the mean."""
    hf = h if h.dim() == 2 else h.reshape(-1, h.shape[-1])
    chunk = resolve_vocab_chunk(w2.shape[0], vocab_chunk)
    return _ChunkedCE.apply(hf, w2, y.reshape(-1).long(), mask, chunk,
                            bool(int8))


def fused_chunked_cross_entropy(x, weight, labels, transpose_y=True,
                                vocab_chunk=None, ignore_index=-100,
                                int8=None, mesh=None, tp_axis=None,
                                name=None):
    """The fused chunked CE LM head on Tensors (the reference's ``:428``):
    :func:`chunked_lm_loss_arrays` of ``x``, ``weight`` and ``labels``.
    ``int8=None`` takes :func:`int8_head_enabled` for ``x``'s device. The
    vocab-sharded variant (``mesh``, ``tp_axis``) waits for the port's
    multi-GPU path and raises."""
    if mesh is not None or tp_axis is not None:
        raise NotImplementedError(
            "fused_chunked_cross_entropy: the vocab-sharded head (mesh, "
            "tp_axis) is not ported yet (ROADMAP A.10, multi-GPU)")

    def run(h, w, y):
        return chunked_lm_loss_arrays(
            h, w, y, transpose_y=transpose_y, vocab_chunk=vocab_chunk,
            ignore_index=ignore_index, int8=int8)

    return apply_op(run, x, weight, labels,
                    _op_name="fused_chunked_cross_entropy")
