"""Flash attention, forward and fused backward: CUDA kernels and plain
versions.

Replaces two Pallas TPU kernels of ``paddle_tpu/ops/pallas/
flash_attention.py``: the forward ``_fwd_kernel`` (:113, ``pallas_call``
at :248) and the fused single-pass backward ``_bwd_fused_kernel`` (:373,
``pallas_call`` at :581). Both are ``csrc/flash_attention.cu``; see the
source for what bounds them and how they are laid out. The autograd
Function takes the place of the ``custom_vjp`` at :618-644: it saves
``(q, k, v, o, lse)`` and its backward computes ``delta = rowsum(do * o)``
in plain PyTorch, as ``_bwd_impl`` (:487) does.

Semantics kept from the JAX package:

- kernel layout ``[B*H, S, D]``; the public :func:`flash_attention` takes
  ``[B, S, H, D]`` (``to_bh``/``from_bh``);
- GQA: q head ``bh`` reads kv head ``bh // rep`` (``_kv_index`` :166);
- causal masking aligns the queries to the end of the keys: row ``i`` sees
  key ``j`` when ``j <= i + (Sk - Sq)`` (:104-108, :200);
- masked scores are ``NEG_INF = -1e30`` in the max and contribute ``p = 0``;
  a row that sees no key gets ``o = 0`` and ``lse = -1e30`` (the
  ``l == 0`` guards, :157-161);
- ``p`` is rounded to v's type before ``p @ v`` (:141); in the backward,
  ``p`` to do's type before dV (:415) and ``ds`` to q's type before dK and
  dQ (:422, :428);
- ``lse`` is plain ``[B*H, Sq]`` f32 (the TPU's 8-sublane padding is a
  Mosaic artefact and is not ported).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import LAUNCHES, check_launch, load, ptr, stream_handle, use_kernel

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def to_bh(x):
    """[B, S, H, D] -> the kernel layout [B*H, S, D]."""
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d)


def from_bh(x, b):
    """[B*H, S, D] -> [B, S, H, D]."""
    bh, s, d = x.shape
    return x.reshape(b, bh // b, s, d).transpose(1, 2)


def _launcher(name, n_ptrs):
    fn = getattr(load("flash_attention"), name)
    if fn.argtypes is None:          # declare the C signature once
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _mask(sq, sk, causal, device):
    """[Sq, Sk] bool, True where the query row sees the key."""
    if not causal:
        return torch.ones(sq, sk, dtype=torch.bool, device=device)
    rows = torch.arange(sq, device=device)[:, None]
    cols = torch.arange(sk, device=device)[None, :]
    return cols <= rows + (sk - sq)


def _expand_kv(x, rep):
    return x.repeat_interleave(rep, dim=0) if rep > 1 else x


def flash_attention_fwd_plain(q, k, v, causal=False, scale=None):
    """The forward kernel's function in plain PyTorch: a materialised
    masked softmax in f32 with the same roundings. q [BHq, Sq, D],
    k/v [BHkv, Sk, D] -> (o [BHq, Sq, D] in q's type, lse [BHq, Sq] f32)."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    rep = q.shape[0] // k.shape[0]
    kf = _expand_kv(k, rep).float()
    vv = _expand_kv(v, rep)
    mask = _mask(q.shape[1], k.shape[1], causal, q.device)
    s = torch.where(mask, (q.float() @ kf.transpose(1, 2)) * scale,
                    torch.full((), NEG_INF, device=q.device))
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros((), device=q.device))
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = (p.to(v.dtype).float() @ vv.float()) / l_safe
    return o.to(q.dtype), (m + torch.log(l_safe))[..., 0]


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal=False, scale=None):
    """The textbook attention backward from (q, k, v, o, lse, do), with
    the fused kernel's roundings: (dq, dk, dv) in the operands' types."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    bhk, sk, _ = k.shape
    rep = q.shape[0] // bhk
    delta = (do.float() * o.float()).sum(-1)
    kf = _expand_kv(k, rep).float()
    vf = _expand_kv(v, rep).float()
    mask = _mask(q.shape[1], sk, causal, q.device)
    s = (q.float() @ kf.transpose(1, 2)) * scale
    p = torch.where(mask, torch.exp(s - lse[..., None]),
                    torch.zeros((), device=q.device))
    dv = p.to(do.dtype).float().transpose(1, 2) @ do.float()
    dp = do.float() @ vf.transpose(1, 2)
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    dk = scale * (ds.transpose(1, 2) @ q.float())
    dq = scale * (ds @ kf)
    dk = dk.reshape(bhk, rep, sk, d).sum(1)
    dv = dv.reshape(bhk, rep, sk, d).sum(1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(name, tensors, q, k):
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {q.dtype}")
    for t in tensors:
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: operands must share q's dtype, got "
                            f"{t.dtype} and {q.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be contiguous and "
                             f"16-byte aligned")
    bhq, sq, d = q.shape
    bhk, sk, dk = k.shape
    if d not in (64, 128) or dk != d:
        raise ValueError(f"{name}: head_dim must be 64 or 128 on both "
                         f"sides, got q {tuple(q.shape)} k {tuple(k.shape)}")
    if bhq % bhk or bhq > 65535:
        raise ValueError(f"{name}: q rows B*Hq ({bhq}) must be a multiple "
                         f"of the kv rows B*Hkv ({bhk}) and at most 65535")
    return bhq, sq, bhk, sk, d


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """Flash attention forward on the kernel layout: q [B*Hq, Sq, D],
    k/v [B*Hkv, Sk, D] -> (o, lse [B*Hq, Sq] f32). CUDA tensors launch the
    kernel; CPU tensors run :func:`flash_attention_fwd_plain`."""
    if not use_kernel(q, k, v):
        return flash_attention_fwd_plain(q, k, v, causal, scale)
    bhq, sq, bhk, sk, d = _check("flash_attention_fwd", (k, v), q, k)
    if v.shape != k.shape:
        raise ValueError("flash_attention_fwd: k and v must share a shape")
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    o = torch.empty_like(q)
    lse = torch.empty(bhq, sq, dtype=torch.float32, device=q.device)
    rc = _launcher("flash_attention_fwd_launch", 5)(
        ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse), bhq, bhq // bhk, sq, sk, d,
        float(scale), int(bool(causal)), _DTYPES[q.dtype], stream_handle(q))
    check_launch(rc, "flash_attention_fwd")
    LAUNCHES["flash_attention_fwd"] += 1
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, causal=False, scale=None):
    """Fused flash attention backward on the kernel layout -> (dq, dk, dv).
    ``delta = rowsum(do * o)`` is plain PyTorch on both routes. CUDA
    tensors launch the kernel (dq through a zeroed f32 workspace, then
    cast); CPU tensors run :func:`flash_attention_bwd_plain`."""
    if not use_kernel(q, k, v, o, lse, do):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale)
    bhq, sq, bhk, sk, d = _check("flash_attention_bwd", (k, v, o, do), q, k)
    if v.shape != k.shape or o.shape != q.shape or do.shape != q.shape:
        raise ValueError("flash_attention_bwd: k/v and q/o/do must share "
                         "their shapes")
    if lse.dtype != torch.float32 or lse.shape != (bhq, sq) \
            or not lse.is_contiguous():
        raise ValueError("flash_attention_bwd: lse must be [B*Hq, Sq] f32")
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    delta = (do.float() * o.float()).sum(-1)
    dq_acc = torch.zeros(bhq, sq, d, dtype=torch.float32, device=q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    rc = _launcher("flash_attention_bwd_launch", 9)(
        ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), ptr(dq_acc),
        ptr(dk), ptr(dv), bhk, bhq // bhk, sq, sk, d, float(scale),
        int(bool(causal)), _DTYPES[q.dtype], stream_handle(q))
    check_launch(rc, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq_acc.to(q.dtype), dk, dv


class _Flash(torch.autograd.Function):
    """Differentiable flash attention on the kernel layout (the JAX
    package's ``_flash`` custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, scale=None):
    """[B, S, H, D] flash attention, differentiable. GQA reads the shared
    kv heads in the kernel; kv is never repeated to q-head width."""
    b, sq, hq, d = q.shape
    hk = k.shape[2]
    if hq % hk:
        raise ValueError(f"q heads ({hq}) must be a multiple of kv heads "
                         f"({hk})")
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    o = _Flash.apply(to_bh(q).contiguous(), to_bh(k).contiguous(),
                     to_bh(v).contiguous(), bool(causal), scale)
    return from_bh(o, b)
