"""Flash attention, forward and backward: CUDA kernels and plain versions.

Replaces four Pallas TPU kernels of ``paddle_tpu/ops/pallas/
flash_attention.py``:

- the forward ``_fwd_kernel`` (:113, ``pallas_call`` at :248) and the fused
  single-pass backward ``_bwd_fused_kernel`` (:373, ``pallas_call`` at
  :581), both in ``csrc/flash_attention.cu``;
- the split backward's dq pass ``_bwd_dq_kernel`` (:283, ``pallas_call``
  at :515) and its dk/dv pass ``_bwd_dkv_kernel`` (:324, ``pallas_call``
  at :539), both in ``csrc/flash_attention_split.cu``.

See the sources for what bounds them and how they are laid out. In bf16
and in float16 (one template over the operand type, launched under the
``<name>_f16`` counts) all four are FA3-style kernels: TMA loads into a ring completing on
mbarriers, ``wgmma`` with ``P`` (and ``dS``) kept in registers as the A
operand of the second product, and a producer warpgroup beside two
consumer warpgroups (``csrc/sm90.cuh`` holds the shared building blocks).
The fused backward adds each dq tile into its f32 workspace by one TMA
bulk reduce-add, so the order of the adds, and the last bits of dq, vary
from run to run; the split pair repeats bit for bit.
:func:`flash_attention_bwd` routes the backward as ``_bwd_impl`` (:472)
does: the fused kernel while its dq scratch fits in 8 MiB, the split pair
above (:498-502, without the ``PTPU_FA_FUSED_BWD`` knob). It computes
``delta = rowsum(do * o)`` once, in plain PyTorch, for whichever kernels
it takes (:487).

The differentiable forward is the custom op ``paddle_tpu_torch::flash_fwd``
(the JAX package's ``_flash`` custom_vjp, :618-644): an op of the
dispatcher, so that a selective-remat policy can keep its outputs ``(o,
lse)`` (the reference's ``attn_res``/``attn_lse`` residuals) and the
backward does not launch the forward again.

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
  ``p`` to do's type before dV (:348, :415) and ``ds`` to q's type before
  dK and dQ (:308, :356, :422, :428); the dq pass keeps ``p`` in f32;
- ``lse`` is plain ``[B*H, Sq]`` f32 (the TPU's 8-sublane padding is a
  Mosaic artefact and is not ported);
- head widths: the kernels take every ``d <= 256``, as the reference takes
  its Pallas kernel for every ``d <= 256`` (``paddle_tpu/nn/functional/
  flash_attention.py:47-57``). They run on a padded width of 64, 128, 192
  or 256 columns whose extra columns TMA fills with zeros, which is exact.
  TMA takes rows of whole 16-byte vectors, so the wrappers pad q, k, v and
  do of any other width with zero columns (to a multiple of 8 in bf16 and f16, 4 in
  f32) and slice the results back; the scale stays ``1/sqrt(d)`` of the
  real ``d``. Above 256 the reference takes XLA's plain attention, and
  :func:`flash_attention` takes the plain version by the same rule
  (:func:`fwd_route`).
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import (LAUNCHES, check_launch, define_op, launch_key, load, ptr,
               stream_handle, use_kernel)

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the fused backward's dq scratch limit (``_bwd_impl`` :499-501)
FUSED_DQ_SCRATCH_BYTES = 8 << 20
#: the widest head the kernels take (``_use_pallas``'s ``d <= 256``)
MAX_KERNEL_HEAD_DIM = 256


def to_bh(x):
    """[B, S, H, D] -> the kernel layout [B*H, S, D]."""
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d)


def from_bh(x, b):
    """[B*H, S, D] -> [B, S, H, D]."""
    bh, s, d = x.shape
    return x.reshape(b, bh // b, s, d).transpose(1, 2)


def bwd_route(rep, sq, d):
    """``"fused"`` while the fused backward's f32 dq scratch
    ``rep * sq * d * 4`` bytes fits in 8 MiB, else ``"split"``: the
    reference's rule, so the same shapes take the same algorithm."""
    return "split" if rep * sq * d * 4 > FUSED_DQ_SCRATCH_BYTES else "fused"


def fwd_route(d):
    """``"kernel"`` for head widths up to :data:`MAX_KERNEL_HEAD_DIM`, else
    ``"plain"``: the reference's rule, which leaves wider heads to XLA."""
    return "kernel" if d <= MAX_KERNEL_HEAD_DIM else "plain"


def _pad_width(*tensors):
    """The tensors with zero columns appended up to the next width whose
    rows are whole 16-byte vectors (TMA's row-stride rule), as they are when
    the width already is one."""
    d = tensors[0].shape[-1]
    align = 16 // tensors[0].element_size()
    width = -(-d // align) * align
    if width == d:
        return tensors
    return tuple(F.pad(t, (0, width - d)).contiguous() for t in tensors)


def _unpad(t, d):
    return t if t.shape[-1] == d else t[..., :d].contiguous()


def _launcher(lib, name, n_ptrs):
    fn = getattr(load(lib), name)
    if fn.argtypes is None:          # declare the C signature once
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


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
    scale = _scale(q, scale)
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


def _delta(o, do):
    """``rowsum(do * o)`` in f32 (``_bwd_impl`` :487)."""
    return (do.float() * o.float()).sum(-1)


def _p_ds(q, k, v, do, lse, delta, causal, scale):
    """The backward's ``P = exp(S * scale - lse)`` (0 where masked) and
    ``dS = P (dO V^T - delta)``, both f32, for q/do [..., Sq, D] against
    k/v [..., Sk, D] at q's heads. In place where it can be, so that one
    head at Sq = Sk = 32768 holds two [S, S] f32 matrices at a time."""
    s = q.float() @ k.float().transpose(-1, -2)
    p = s.mul_(scale).sub_(lse[..., None]).exp_()
    p.masked_fill_(~_mask(q.shape[-2], k.shape[-2], causal, q.device), 0.0)
    ds = (do.float() @ v.float().transpose(-1, -2)).sub_(delta[..., None])
    return p, ds.mul_(p)


def flash_attention_bwd_fused_plain(q, k, v, do, lse, delta, causal=False,
                                    scale=None):
    """The fused backward kernel's function in plain PyTorch, every head
    at once: (dq, dk, dv) in the operands' types."""
    scale = _scale(q, scale)
    bhk, sk, d = k.shape
    rep = q.shape[0] // bhk
    kf = _expand_kv(k, rep).float()
    p, ds = _p_ds(q, kf, _expand_kv(v, rep), do, lse, delta, causal, scale)
    dv = p.to(do.dtype).float().transpose(1, 2) @ do.float()
    ds = ds.to(q.dtype).float()
    dk = scale * (ds.transpose(1, 2) @ q.float())
    dq = scale * (ds @ kf)
    dk = dk.reshape(bhk, rep, sk, d).sum(1)
    dv = dv.reshape(bhk, rep, sk, d).sum(1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal=False, scale=None):
    """The textbook attention backward from (q, k, v, o, lse, do), with
    the kernels' roundings: (dq, dk, dv) in the operands' types."""
    return flash_attention_bwd_fused_plain(q, k, v, do, lse, _delta(o, do),
                                           causal, scale)


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal=False,
                                 scale=None):
    """The split dq kernel's function in plain PyTorch, one q head at a
    time: ``dq = scale * dS K`` with dS rounded to k's type -> dq in q's
    type."""
    scale = _scale(q, scale)
    rep = q.shape[0] // k.shape[0]
    dq = torch.empty_like(q)
    for i in range(q.shape[0]):
        kh = k[i // rep]
        _, ds = _p_ds(q[i], kh, v[i // rep], do[i], lse[i], delta[i], causal,
                      scale)
        dq[i] = (scale * (ds.to(k.dtype).float() @ kh.float())).to(q.dtype)
    return dq


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal=False,
                                  scale=None):
    """The split dk/dv kernel's function in plain PyTorch, one kv head at
    a time, summing over its rep q heads: ``dV = P^T dO`` with P rounded to
    do's type, ``dK = scale * dS^T Q`` with dS rounded to q's type ->
    (dk, dv) in k's and v's types."""
    scale = _scale(q, scale)
    bhk, sk, d = k.shape
    rep = q.shape[0] // bhk
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for j in range(bhk):
        dk_acc = torch.zeros(sk, d, dtype=torch.float32, device=k.device)
        dv_acc = torch.zeros(sk, d, dtype=torch.float32, device=k.device)
        for i in range(j * rep, (j + 1) * rep):
            p, ds = _p_ds(q[i], k[j], v[j], do[i], lse[i], delta[i], causal,
                          scale)
            dv_acc += p.to(do.dtype).float().t() @ do[i].float()
            del p
            dk_acc += scale * (ds.to(q.dtype).float().t() @ q[i].float())
        dk[j], dv[j] = dk_acc.to(k.dtype), dv_acc.to(v.dtype)
    return dk, dv


def _check(name, tensors, q, k):
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32, bfloat16 or float16, got "
                        f"{q.dtype}")
    for t in tensors:
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: operands must share q's dtype, got "
                            f"{t.dtype} and {q.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be contiguous and "
                             f"16-byte aligned")
    bhq, sq, d = q.shape
    bhk, sk, dk = k.shape
    if not 1 <= d <= MAX_KERNEL_HEAD_DIM or dk != d:
        raise ValueError(f"{name}: head_dim must be at most "
                         f"{MAX_KERNEL_HEAD_DIM} and equal on both sides, "
                         f"got q {tuple(q.shape)} k {tuple(k.shape)}")
    if bhq % bhk or bhq > 65535:
        raise ValueError(f"{name}: q rows B*Hq ({bhq}) must be a multiple "
                         f"of the kv rows B*Hkv ({bhk}) and at most 65535")
    return bhq, sq, bhk, sk, d


def _check_bwd(name, q, k, v, do, lse, delta):
    bhq, sq, bhk, sk, d = _check(name, (k, v, do), q, k)
    if v.shape != k.shape or do.shape != q.shape:
        raise ValueError(f"{name}: k/v and q/do must share their shapes")
    for t, what in ((lse, "lse"), (delta, "delta")):
        if t.dtype != torch.float32 or t.shape != (bhq, sq) \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be [B*Hq, Sq] f32")
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
    scale = _scale(q, scale)
    if scale < 0 and q.dtype != torch.float32:
        # the bf16 and f16 kernels take the row max before scaling:
        # (-q) k^T * -scale is the same product, exactly
        q, scale = -q, -scale
    q, k, v = _pad_width(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(bhq, sq, dtype=torch.float32, device=q.device)
    rc = _launcher("flash_attention", "flash_attention_fwd_launch", 5)(
        ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse), bhq, bhq // bhk, sq, sk,
        q.shape[-1], float(scale), int(bool(causal)), _DTYPES[q.dtype],
        stream_handle(q))
    check_launch(rc, "flash_attention_fwd")
    LAUNCHES[launch_key("flash_attention_fwd", q)] += 1
    return _unpad(o, d), lse


def flash_attention_bwd_fused(q, k, v, do, lse, delta, causal=False,
                              scale=None):
    """The fused backward kernel on the kernel layout -> (dq, dk, dv).
    CUDA tensors launch it (dq through a zeroed f32 workspace, then cast);
    CPU tensors run :func:`flash_attention_bwd_fused_plain`."""
    if not use_kernel(q, k, v, do, lse, delta):
        return flash_attention_bwd_fused_plain(q, k, v, do, lse, delta,
                                               causal, scale)
    bhq, sq, bhk, sk, d = _check_bwd("flash_attention_bwd", q, k, v, do, lse,
                                     delta)
    scale = _scale(q, scale)
    q, k, v, do = _pad_width(q, k, v, do)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    rc = _launcher("flash_attention", "flash_attention_bwd_launch", 9)(
        ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), ptr(dq_acc),
        ptr(dk), ptr(dv), bhk, bhq // bhk, sq, sk, q.shape[-1], float(scale),
        int(bool(causal)), _DTYPES[q.dtype], stream_handle(q))
    check_launch(rc, "flash_attention_bwd")
    LAUNCHES[launch_key("flash_attention_bwd", q)] += 1
    return (_unpad(dq_acc, d).to(q.dtype), _unpad(dk, d), _unpad(dv, d))


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=False,
                           scale=None):
    """The split backward's dq kernel on the kernel layout -> dq. CUDA
    tensors launch it; CPU tensors run :func:`flash_attention_bwd_dq_plain`."""
    if not use_kernel(q, k, v, do, lse, delta):
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal,
                                            scale)
    bhq, sq, bhk, sk, d = _check_bwd("flash_attention_bwd_dq", q, k, v, do,
                                     lse, delta)
    scale = _scale(q, scale)
    q, k, v, do = _pad_width(q, k, v, do)
    dq = torch.empty_like(q)
    rc = _launcher("flash_attention_split", "flash_attention_bwd_dq_launch",
                   7)(
        ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), ptr(dq), bhq,
        bhq // bhk, sq, sk, q.shape[-1], float(scale), int(bool(causal)),
        _DTYPES[q.dtype], stream_handle(q))
    check_launch(rc, "flash_attention_bwd_dq")
    LAUNCHES[launch_key("flash_attention_bwd_dq", q)] += 1
    return _unpad(dq, d)


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=False,
                            scale=None):
    """The split backward's dk/dv kernel on the kernel layout -> (dk, dv).
    CUDA tensors launch it; CPU tensors run
    :func:`flash_attention_bwd_dkv_plain`."""
    if not use_kernel(q, k, v, do, lse, delta):
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal,
                                             scale)
    bhq, sq, bhk, sk, d = _check_bwd("flash_attention_bwd_dkv", q, k, v, do,
                                     lse, delta)
    scale = _scale(q, scale)
    q, k, v, do = _pad_width(q, k, v, do)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    rc = _launcher("flash_attention_split", "flash_attention_bwd_dkv_launch",
                   8)(
        ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), ptr(dk),
        ptr(dv), bhk, bhq // bhk, sq, sk, q.shape[-1], float(scale),
        int(bool(causal)), _DTYPES[q.dtype], stream_handle(q))
    check_launch(rc, "flash_attention_bwd_dkv")
    LAUNCHES[launch_key("flash_attention_bwd_dkv", q)] += 1
    return _unpad(dk, d), _unpad(dv, d)


_BWD_ARGS = ("Tensor q, Tensor k, Tensor v, Tensor do, Tensor lse, "
             "Tensor delta, bool causal, float scale")


def _bwd_fused_fake(q, k, v, do, lse, delta, causal, scale):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _bwd_dq_fake(q, k, v, do, lse, delta, causal, scale):
    return torch.empty_like(q)


def _bwd_dkv_fake(q, k, v, do, lse, delta, causal, scale):
    return torch.empty_like(k), torch.empty_like(v)


# The backward's three routes as dispatcher ops, like the forward's: a
# fake-tensor trace of a training step (``TrainStep.memory_stats``) and
# ``torch.export`` see each as one node, with its outputs' shapes and
# types from the fake. No autograd kernel: the forward op's backward calls
# them with grad off.
flash_bwd_fused_op = define_op(
    f"flash_bwd_fused({_BWD_ARGS}) -> (Tensor, Tensor, Tensor)",
    flash_attention_bwd_fused, _bwd_fused_fake)
flash_bwd_dq_op = define_op(f"flash_bwd_dq({_BWD_ARGS}) -> Tensor",
                            flash_attention_bwd_dq, _bwd_dq_fake)
flash_bwd_dkv_op = define_op(
    f"flash_bwd_dkv({_BWD_ARGS}) -> (Tensor, Tensor)",
    flash_attention_bwd_dkv, _bwd_dkv_fake)


def flash_attention_bwd(q, k, v, o, lse, do, causal=False, scale=None):
    """Flash attention backward on the kernel layout -> (dq, dk, dv):
    ``delta = rowsum(do * o)`` once, then the fused kernel or the split
    pair, as :func:`bwd_route` picks (the plain versions of that choice on
    CPU tensors), each through its dispatcher op."""
    delta = _delta(o, do)
    scale = _scale(q, scale)
    causal = bool(causal)
    if bwd_route(q.shape[0] // k.shape[0], q.shape[1], q.shape[2]) == "fused":
        return flash_bwd_fused_op(q, k, v, do, lse, delta, causal, scale)
    dq = flash_bwd_dq_op(q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_bwd_dkv_op(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


@torch.library.custom_op(
    "paddle_tpu_torch::flash_fwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, bool causal, float scale) "
           "-> (Tensor, Tensor)")
def flash_fwd_op(q, k, v, causal, scale):
    """Differentiable flash attention forward on the kernel layout ->
    (o, lse). Its backward is :func:`flash_attention_bwd`."""
    return flash_attention_fwd(q, k, v, causal, scale)


@flash_fwd_op.register_fake
def _(q, k, v, causal, scale):
    return (torch.empty_like(q),
            q.new_empty(q.shape[:2], dtype=torch.float32))


def _flash_setup(ctx, inputs, output):
    q, k, v, causal, scale = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.causal, ctx.scale = causal, scale


def _flash_backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                     ctx.causal, ctx.scale)
    return dq, dk, dv, None, None


flash_fwd_op.register_autograd(_flash_backward, setup_context=_flash_setup)


def flash_attention(q, k, v, causal=False, scale=None):
    """[B, S, H, D] flash attention, differentiable. GQA reads the shared
    kv heads in the kernel; kv is never repeated to q-head width. Heads
    wider than :data:`MAX_KERNEL_HEAD_DIM` take the plain version, through
    autograd, on any device (:func:`fwd_route`)."""
    b, sq, hq, d = q.shape
    hk = k.shape[2]
    if hq % hk:
        raise ValueError(f"q heads ({hq}) must be a multiple of kv heads "
                         f"({hk})")
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    args = (to_bh(q).contiguous(), to_bh(k).contiguous(),
            to_bh(v).contiguous(), bool(causal), scale)
    if fwd_route(d) == "plain":
        o, _ = flash_attention_fwd_plain(*args)
    else:
        o, _ = flash_fwd_op(*args)
    return from_bh(o, b)
