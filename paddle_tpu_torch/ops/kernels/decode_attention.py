"""Paged one-token decode attention: CUDA kernel and plain version.

Replaces the Pallas TPU kernel ``_paged_kernel`` behind ``paged_attention``
(``paddle_tpu/ops/pallas/decode_attention.py:139``, ``pallas_call`` at
``:336``). The kernel is ``csrc/paged_attention.cu``: one thread block per
(sequence, kv head) walks the sequence's own pages with an online softmax
in f32, so it reads each live KV row once and is bound by those bytes over
the card's memory rate (see the source for its design).

Layouts (those of the JAX package):
  q [B, Hq, D]; pages [Hkv, NumPages, PageSize, D];
  block_tables [B, PagesPerSeq] int32; lengths [B] int32 (valid kv rows,
  counting the current token's freshly written row).
q head ``h * rep + r`` reads kv head ``h`` (``rep = Hq // Hkv``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import LAUNCHES, check_launch, load, ptr, stream_handle, use_kernel

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _launcher():
    fn = load("paged_attention").paged_attention_launch
    if fn.argtypes is None:          # declare the C signature once
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def paged_attention_plain(q, k_pages, v_pages, block_tables, lengths, *,
                          scale=None):
    """The kernel's function in plain PyTorch: gather the sequence's pages
    (table entries clamped), mask positions >= length, softmax in f32 with
    p rounded to V's type before p.V, and 0 where no position is valid."""
    b, hq, d = q.shape
    hkv, num_pages, page, _ = k_pages.shape
    rep = hq // hkv
    pps = block_tables.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    idx = block_tables.long().clamp(0, num_pages - 1)
    k = k_pages[:, idx].reshape(hkv, b, pps * page, d).transpose(0, 1)
    v = v_pages[:, idx].reshape(hkv, b, pps * page, d).transpose(0, 1)
    qg = q.reshape(b, hkv, rep, d).float()
    s = torch.einsum("bhrd,bhsd->bhrs", qg, k.float()) * scale
    valid = (torch.arange(pps * page, device=q.device)[None, :]
             < lengths.long()[:, None])[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhrs,bhsd->bhrd", p.to(v.dtype).float(), v.float())
    o = acc / torch.where(l == 0.0, torch.ones_like(l), l)
    return o.reshape(b, hq, d).to(q.dtype)


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                    scale=None):
    """Paged-KV decode attention. CUDA tensors launch the kernel; CPU
    tensors run :func:`paged_attention_plain`."""
    if not use_kernel(q, k_pages, v_pages, block_tables, lengths):
        return paged_attention_plain(q, k_pages, v_pages, block_tables,
                                     lengths, scale=scale)
    b, hq, d = q.shape
    hkv, num_pages, page, dk = k_pages.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("paged_attention: q, k_pages and v_pages must share "
                        "one dtype")
    if d not in (64, 128) or dk != d or v_pages.shape != k_pages.shape:
        raise ValueError(f"paged_attention: head_dim must be 64 or 128 and "
                         f"match the pages, got q {tuple(q.shape)} pages "
                         f"{tuple(k_pages.shape)}")
    if hq % hkv or not 1 <= hq // hkv <= 8:
        raise ValueError(f"paged_attention: Hq/Hkv must be an integer in "
                         f"1..8, got {hq}/{hkv}")
    if (block_tables.dtype != torch.int32 or lengths.dtype != torch.int32
            or block_tables.dim() != 2 or block_tables.shape[0] != b
            or lengths.shape != (b,)):
        raise ValueError("paged_attention: block_tables [B, PagesPerSeq] "
                         "and lengths [B] must be int32")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    rc = _launcher()(
        ptr(q), ptr(k_pages), ptr(v_pages), ptr(block_tables), ptr(lengths),
        ptr(out), b, hkv, hq // hkv, d, num_pages, page,
        block_tables.shape[1], float(scale), _DTYPES[q.dtype],
        stream_handle(q))
    check_launch(rc, "paged_attention")
    LAUNCHES["paged_attention"] += 1
    return out
