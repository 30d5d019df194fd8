"""One-token decode attention: CUDA kernels and their plain versions.

Each kernel computes, per (sequence, kv head), an online softmax in f32
over the sequence's live KV rows, so it reads each live row once and is
bound by those bytes over the card's memory rate (see the sources).

- ``paged_attention`` (``csrc/paged_attention.cu``) replaces the Pallas
  kernel ``_paged_kernel`` (``paddle_tpu/ops/pallas/decode_attention.py:139``,
  ``pallas_call`` at ``:336``): exact pages, p rounded to V's type.
- ``decode_attention`` (``csrc/decode_attention.cu``) replaces
  ``_decode_kernel`` (``:42``, ``pallas_call`` at ``:105``): a dense cache,
  p rounded to V's type.
- ``paged_attention_int8`` (``csrc/paged_attention_int8.cu``) replaces
  ``_paged_int8_kernel`` (``:180``, ``pallas_call`` at ``:267``): int8
  codes and one f32 scale per row, dequantized in f32 inside the kernel; q
  is cast to f32 and p stays f32.

The three kernels share ``csrc/decode_split.cuh``: a cluster of
``split_count(rows the call allows)`` CTAs splits each sequence's live
rows, each warp streams its rows through its own ``cp.async`` ring, and
the CTAs merge their partial softmaxes in a fixed order, so a call is one
launch and repeats bit for bit. The int8 route turns codes into f32 by
byte permutes and applies each row's scale once, to its score and to its
p, rather than to each of its D values.

Layouts (those of the JAX package):
  q [B, Hq, D]; pages [Hkv, NumPages, PageSize, D] (int8 scales
  [Hkv, NumPages, PageSize, 1] f32); block_tables [B, PagesPerSeq] int32;
  dense cache [B, Hkv, S, D]; lengths [B] int32 (valid kv rows, counting
  the current token's freshly written row).
q head ``h * rep + r`` reads kv head ``h`` (``rep = Hq // Hkv``). Each
kernel takes D in ``EXACT_HEAD_DIMS`` and any rep, and raises on other
shapes.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import LAUNCHES, check_launch, load, ptr, stream_handle, use_kernel

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: C launcher -> (pointer arguments, int arguments) before (scale, dtype,
#: stream)
_SIGNATURES = {"paged_attention": (6, 8), "paged_attention_int8": (8, 8),
               "decode_attention": (5, 6)}
#: head widths of the decode kernels: GPT-2 and Falcon-7B 64, Phi-2 80,
#: Phi-3-mini and GPT-NeoX-20B 96, LLaMA 128, Gemma and GPT-J 256
EXACT_HEAD_DIMS = (64, 80, 96, 128, 256)
#: the decode kernels' split: one CTA of a sequence's cluster per
#: SPLIT_ROWS rows the call allows, at most SPLIT_MAX (the portable cluster)
SPLIT_ROWS, SPLIT_MAX = 256, 8


def split_count(max_rows):
    """CTAs per (sequence, kv head, q-row group) for a call whose longest
    sequence may hold ``max_rows`` rows (``PagesPerSeq * PageSize``, or S).
    Each CTA takes a 1/n share of its sequence's live rows: whole pages on
    the paged route, multiples of 16 rows on the dense one. Chosen from
    shapes only: reading ``lengths`` would wait for the card."""
    return max(1, min(SPLIT_MAX, -(-max_rows // SPLIT_ROWS)))


def _launcher(name):
    fn = getattr(load(name), f"{name}_launch")
    if fn.argtypes is None:          # declare the C signature once
        n_ptr, n_int = _SIGNATURES[name]
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _attend_plain(q, k, v, lengths, scale, p_dtype):
    """q [B, Hq, D]; k, v [B, Hkv, S, D]: masked softmax in f32 over the
    first ``lengths[b]`` rows, p rounded to ``p_dtype`` (None: kept f32)
    before p.V, 0 where no row is valid; the result in q's type."""
    b, hq, d = q.shape
    hkv, s_len = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    s = torch.einsum("bhrd,bhsd->bhrs", qg, k.float()) * scale
    valid = (torch.arange(s_len, device=q.device)[None, :]
             < lengths.long()[:, None])[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(-1, keepdim=True)
    if p_dtype is not None:
        p = p.to(p_dtype).float()
    acc = torch.einsum("bhrs,bhsd->bhrd", p, v.float())
    o = acc / torch.where(l == 0.0, torch.ones_like(l), l)
    return o.reshape(b, hq, d).to(q.dtype)


def _gather_pages(pages, block_tables):
    """[Hkv, P, page, X] pages by table (entries clamped) -> [B, Hkv,
    PagesPerSeq * page, X]."""
    hkv, num_pages, page, x = pages.shape
    b, pps = block_tables.shape
    idx = block_tables.long().clamp(0, num_pages - 1)
    return pages[:, idx].reshape(hkv, b, pps * page, x).transpose(0, 1)


def _scale(scale, d):
    return scale if scale is not None else 1.0 / math.sqrt(d)


def paged_attention_plain(q, k_pages, v_pages, block_tables, lengths, *,
                          scale=None):
    """The exact paged kernel's function in plain PyTorch: gather the
    sequence's pages (table entries clamped), mask positions >= length,
    softmax in f32 with p rounded to V's type before p.V, and 0 where no
    position is valid."""
    k = _gather_pages(k_pages, block_tables)
    v = _gather_pages(v_pages, block_tables)
    return _attend_plain(q, k, v, lengths, _scale(scale, q.shape[-1]),
                         v.dtype)


def paged_attention_int8_plain(q, k_codes, k_scales, v_codes, v_scales,
                               block_tables, lengths, *, scale=None):
    """The int8 paged kernel's function in plain PyTorch: gather, then
    dequantize ``codes * scales`` in f32 (never rounded to the model
    type), q in f32, p kept in f32, the result in q's type."""
    k = (_gather_pages(k_codes, block_tables).float()
         * _gather_pages(k_scales, block_tables))
    v = (_gather_pages(v_codes, block_tables).float()
         * _gather_pages(v_scales, block_tables))
    return _attend_plain(q, k, v, lengths, _scale(scale, q.shape[-1]), None)


def decode_attention_plain(q, k_cache, v_cache, lengths, *, scale=None):
    """The dense decode kernel's function in plain PyTorch: rows >= length
    masked, f32 softmax, p rounded to V's type before p.V, 0 where no row
    is valid."""
    return _attend_plain(q, k_cache, v_cache, lengths,
                         _scale(scale, q.shape[-1]), v_cache.dtype)


def _check_common(name, q, hkv, d_kv, lengths, tensors):
    """What every decode kernel takes: q f32/bf16 [B, Hq, D], D in
    ``EXACT_HEAD_DIMS`` matching the cache, rep = Hq/Hkv an integer >= 1,
    lengths [B] int32, every operand contiguous."""
    b, hq, d = q.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16 q, got {q.dtype}")
    if d not in EXACT_HEAD_DIMS or d_kv != d:
        raise ValueError(f"{name}: head_dim must be one of "
                         f"{EXACT_HEAD_DIMS} and match the cache, got q "
                         f"{tuple(q.shape)} and cache head_dim {d_kv}")
    if hq % hkv or hq < hkv:
        raise ValueError(f"{name}: Hq/Hkv must be an integer, got "
                         f"{hq}/{hkv}")
    if lengths.dtype != torch.int32 or lengths.shape != (b,):
        raise ValueError(f"{name}: lengths must be int32 [B]")
    for arg, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _check_aligned(name, tensors):
    for arg, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned (the "
                             "kernel reads it in 16-byte loads)")


def _check_tables(name, block_tables, b):
    if (block_tables.dtype != torch.int32 or block_tables.dim() != 2
            or block_tables.shape[0] != b):
        raise ValueError(f"{name}: block_tables must be int32 "
                         "[B, PagesPerSeq]")


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                    scale=None):
    """Paged-KV decode attention. CUDA tensors launch the kernel; CPU
    tensors run :func:`paged_attention_plain`."""
    if not use_kernel(q, k_pages, v_pages, block_tables, lengths):
        return paged_attention_plain(q, k_pages, v_pages, block_tables,
                                     lengths, scale=scale)
    b, hq, d = q.shape
    hkv, num_pages, page, dk = k_pages.shape
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("paged_attention: q, k_pages and v_pages must share "
                        "one dtype")
    if v_pages.shape != k_pages.shape:
        raise ValueError("paged_attention: k_pages and v_pages differ in "
                         "shape")
    _check_common("paged_attention", q, hkv, dk, lengths,
                  {"q": q, "k_pages": k_pages, "v_pages": v_pages,
                   "block_tables": block_tables})
    _check_tables("paged_attention", block_tables, b)
    _check_aligned("paged_attention", {"k_pages": k_pages,
                                       "v_pages": v_pages})
    pps = block_tables.shape[1]
    out = torch.empty_like(q)
    rc = _launcher("paged_attention")(
        ptr(q), ptr(k_pages), ptr(v_pages), ptr(block_tables), ptr(lengths),
        ptr(out), b, hkv, hq // hkv, d, num_pages, page, pps,
        split_count(pps * page), float(_scale(scale, d)), _DTYPES[q.dtype],
        stream_handle(q))
    check_launch(rc, "paged_attention")
    LAUNCHES["paged_attention"] += 1
    return out


def paged_attention_int8(q, k_codes, k_scales, v_codes, v_scales,
                         block_tables, lengths, *, scale=None):
    """Paged-KV decode attention over int8 pages (codes int8
    [Hkv, P, page, D], scales f32 [Hkv, P, page, 1]). CUDA tensors launch
    the kernel; CPU tensors run :func:`paged_attention_int8_plain`."""
    args = (q, k_codes, k_scales, v_codes, v_scales, block_tables, lengths)
    if not use_kernel(*args):
        return paged_attention_int8_plain(*args, scale=scale)
    b, hq, d = q.shape
    hkv, num_pages, page, dk = k_codes.shape
    if k_codes.dtype != torch.int8 or v_codes.dtype != torch.int8:
        raise TypeError("paged_attention_int8: codes must be int8")
    if k_scales.dtype != torch.float32 or v_scales.dtype != torch.float32:
        raise TypeError("paged_attention_int8: scales must be float32")
    if (v_codes.shape != k_codes.shape
            or k_scales.shape != (hkv, num_pages, page, 1)
            or v_scales.shape != k_scales.shape):
        raise ValueError("paged_attention_int8: codes [Hkv, P, page, D] and "
                         "scales [Hkv, P, page, 1] must agree")
    _check_common("paged_attention_int8", q, hkv, dk, lengths,
                  {"q": q, "k_codes": k_codes, "k_scales": k_scales,
                   "v_codes": v_codes, "v_scales": v_scales,
                   "block_tables": block_tables})
    _check_tables("paged_attention_int8", block_tables, b)
    _check_aligned("paged_attention_int8", {"k_codes": k_codes,
                                            "v_codes": v_codes})
    pps = block_tables.shape[1]
    out = torch.empty_like(q)
    rc = _launcher("paged_attention_int8")(
        ptr(q), ptr(k_codes), ptr(k_scales), ptr(v_codes), ptr(v_scales),
        ptr(block_tables), ptr(lengths), ptr(out), b, hkv, hq // hkv, d,
        num_pages, page, pps, split_count(pps * page),
        float(_scale(scale, d)), _DTYPES[q.dtype], stream_handle(q))
    check_launch(rc, "paged_attention_int8")
    LAUNCHES["paged_attention_int8"] += 1
    return out


def decode_attention(q, k_cache, v_cache, lengths, *, scale=None):
    """Decode attention over a dense cache [B, Hkv, S, D]. CUDA tensors
    launch the kernel; CPU tensors run :func:`decode_attention_plain`."""
    if not use_kernel(q, k_cache, v_cache, lengths):
        return decode_attention_plain(q, k_cache, v_cache, lengths,
                                      scale=scale)
    b, hq, d = q.shape
    bk, hkv, seq, dk = k_cache.shape
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError("decode_attention: q and the caches must share one "
                        "dtype")
    if bk != b or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention: caches must be [B, Hkv, S, D] "
                         f"with q's B, got {tuple(k_cache.shape)} and "
                         f"{tuple(v_cache.shape)} for q {tuple(q.shape)}")
    _check_common("decode_attention", q, hkv, dk, lengths,
                  {"q": q, "k_cache": k_cache, "v_cache": v_cache})
    _check_aligned("decode_attention", {"k_cache": k_cache,
                                        "v_cache": v_cache})
    out = torch.empty_like(q)
    rc = _launcher("decode_attention")(
        ptr(q), ptr(k_cache), ptr(v_cache), ptr(lengths), ptr(out), b, hkv,
        hq // hkv, d, seq, split_count(seq), float(_scale(scale, d)),
        _DTYPES[q.dtype], stream_handle(q))
    check_launch(rc, "decode_attention")
    LAUNCHES["decode_attention"] += 1
    return out
