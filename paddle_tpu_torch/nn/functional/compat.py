"""The long tail of ``nn.functional`` (counterpart of
``paddle_tpu/nn/functional/compat.py``): each op is a torch function
through ``apply_op`` computing what the reference's computes.

- ``flash_attn_qkvpacked`` unpacks ``qkv [B, S, 3, H, D]`` and calls
  :func:`flash_attention`, so a CUDA tensor reaches the flash kernels.
  ``flash_attn_varlen_qkvpacked`` treats ``qkv`` as that same padded
  batch, as the reference does; a varlen call whose ``cu_seqlens_q`` or
  ``cu_seqlens_k`` are not the padded batch's boundaries ``[0, S, 2S,
  ...]`` raises ``NotImplementedError`` (the reference ignores them);
- ``sparse_attention`` is the reference's dense attention under the mask
  the CSR pattern spells;
- the in-place activations (``hardtanh_``, ``leaky_relu_``,
  ``thresholded_relu_``) compute out of place and rebind (a ``Parameter``
  is written into), the port's in-place rule;
- the random ops (``feature_alpha_dropout``) draw from torch's generator.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ... import dtypes as _dt
from ...core.dispatch import apply_op
from ...core.tensor import Tensor

__all__ = [
    "pairwise_distance", "sequence_mask", "feature_alpha_dropout",
    "lp_pool1d", "max_unpool1d", "max_unpool2d", "max_unpool3d",
    "fractional_max_pool2d", "fractional_max_pool3d", "dice_loss",
    "hsigmoid_loss", "npair_loss", "margin_cross_entropy", "rnnt_loss",
    "gather_tree", "temporal_shift", "class_center_sample",
    "sparse_attention", "triplet_margin_with_distance_loss",
    "multi_margin_loss", "adaptive_log_softmax_with_loss",
    "flash_attn_qkvpacked", "flash_attn_varlen_qkvpacked", "hardtanh_",
    "leaky_relu_", "thresholded_relu_",
]


def _reduce(losses, reduction):
    if reduction == "mean":
        return losses.mean()
    if reduction == "sum":
        return losses.sum()
    return losses


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    return apply_op(
        lambda a, b: torch.pow(
            torch.sum(torch.pow(torch.abs(a - b) + epsilon, p), -1,
                      keepdim=keepdim), 1.0 / p),
        x, y, _op_name="pairwise_distance")


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """Row masks from lengths; without ``maxlen`` its width is the longest
    length (one host read)."""
    if maxlen is None:
        lens = x._data if isinstance(x, Tensor) else torch.as_tensor(x)
        maxlen = int(lens.max())
    tdt = _dt.to_torch(dtype)

    def _sm(lens):
        return (torch.arange(maxlen, device=lens.device)[None, :]
                < lens[..., None]).to(tdt)

    return apply_op(_sm, x, _op_name="sequence_mask")


def feature_alpha_dropout(x, p=0.5, training=True, name=None):
    if not training or p == 0.0:
        return x
    neg = -1.6732632423543772 * 1.0507009873554805

    def _fad(a):
        shape = (a.shape[0], a.shape[1]) + (1,) * (a.dim() - 2)
        keep = torch.rand(shape, device=a.device) < 1 - p
        scale = (p + p * (1 - p) * neg ** 2) ** -0.5
        shift = -scale * p * neg
        return scale * torch.where(keep, a, torch.full_like(a, neg)) + shift

    return apply_op(_fad, x, _op_name="feature_alpha_dropout")


def lp_pool1d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCL", name=None):
    stride = stride or kernel_size

    def _lp(a):
        k, s = int(kernel_size), int(stride)
        if padding:
            a = torch.nn.functional.pad(a, (padding, padding))
        n = (a.shape[-1] - k) // s + 1
        idx = (torch.arange(n, device=a.device)[:, None] * s
               + torch.arange(k, device=a.device)[None, :])
        windows = a[..., idx]                            # [N, C, n, k]
        return torch.pow(torch.sum(torch.pow(torch.abs(windows), norm_type),
                                   -1), 1.0 / norm_type)

    return apply_op(_lp, x, _op_name="lp_pool1d")


def _unpool(a, idx, out_spatial):
    """Scatter ``a [N, C, ...]`` into zeros of ``out_spatial`` at the flat
    positions ``idx``."""
    n, c = a.shape[:2]
    size = math.prod(out_spatial)
    flat = a.new_zeros(n, c, size)
    flat = flat.scatter(-1, idx.reshape(n, c, -1).long(), a.reshape(n, c, -1))
    return flat.reshape(n, c, *out_spatial)


def _tuple(v, n):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    stride = stride or kernel_size

    def _mu(a, idx):
        out_l = (output_size[-1] if output_size
                 else (a.shape[-1] - 1) * stride + kernel_size)
        return _unpool(a, idx, (out_l,))

    return apply_op(_mu, x, indices, _op_name="max_unpool1d")


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    ks = _tuple(kernel_size, 2)
    st = _tuple(stride, 2) if stride else ks

    def _mu(a, idx):
        if output_size:
            out = tuple(output_size[-2:])
        else:
            out = tuple((a.shape[2 + i] - 1) * st[i] + ks[i]
                        for i in range(2))
        return _unpool(a, idx, out)

    return apply_op(_mu, x, indices, _op_name="max_unpool2d")


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    ks = _tuple(kernel_size, 3)
    st = _tuple(stride, 3) if stride else ks

    def _mu(a, idx):
        if output_size:
            out = tuple(output_size[-3:])
        else:
            out = tuple((a.shape[2 + i] - 1) * st[i] + ks[i]
                        for i in range(3))
        return _unpool(a, idx, out)

    return apply_op(_mu, x, indices, _op_name="max_unpool3d")


def _frac_windows(size, out, device):
    """Deterministic fractional windows: ``out`` starts spaced size/out
    apart, each ``ceil(size/out)`` wide, clipped to the edge."""
    start = torch.floor(torch.arange(out, device=device) * (size / out)).long()
    k = max(1, math.ceil(size / out))
    return torch.clamp(start[:, None] + torch.arange(k, device=device)[None],
                       max=size - 1)


def fractional_max_pool2d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    oh, ow = _tuple(output_size, 2)

    def _fmp(a):
        rows = _frac_windows(a.shape[2], oh, a.device)
        cols = _frac_windows(a.shape[3], ow, a.device)
        win = a[:, :, rows][:, :, :, :, cols]            # [N,C,oh,kh,ow,kw]
        return win.amax(dim=(3, 5))

    out = apply_op(_fmp, x, _op_name="fractional_max_pool2d")
    return (out, None) if return_mask else out


def fractional_max_pool3d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    od, oh, ow = _tuple(output_size, 3)

    def _fmp(a):
        di = _frac_windows(a.shape[2], od, a.device)
        hi = _frac_windows(a.shape[3], oh, a.device)
        wi = _frac_windows(a.shape[4], ow, a.device)
        win = a[:, :, di][:, :, :, :, hi][:, :, :, :, :, :, wi]
        return win.amax(dim=(3, 5, 7))

    out = apply_op(_fmp, x, _op_name="fractional_max_pool3d")
    return (out, None) if return_mask else out


def dice_loss(input, label, epsilon=1e-5, name=None):
    def _dl(p, y):
        y1 = torch.nn.functional.one_hot(y[..., 0].long(),
                                         p.shape[-1]).to(p.dtype)
        axes = tuple(range(1, p.dim()))
        inter = torch.sum(p * y1, dim=axes)
        union = torch.sum(p, dim=axes) + torch.sum(y1, dim=axes)
        return torch.mean(1 - (2 * inter + epsilon) / (union + epsilon))

    return apply_op(_dl, input, label, _op_name="dice_loss")


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid over the default complete binary tree."""
    def _hs(x, y, w, b):
        code_len = int(math.ceil(math.log2(max(2, num_classes))))
        cur = y.reshape(-1).long() + num_classes        # leaf position
        total = 0.0
        for _ in range(code_len):
            parent = cur // 2
            bit = (cur % 2).to(x.dtype)                  # 1 = right child
            logit = torch.sum(w[torch.clamp(parent - 1, 0, w.shape[0] - 1)]
                              * x, -1)
            if b is not None:
                logit = logit + b.reshape(-1)[
                    torch.clamp(parent - 1, 0, b.numel() - 1)]
            total = total + (torch.clamp(logit, min=0) - logit * bit
                             + torch.log1p(torch.exp(-torch.abs(logit))))
            cur = parent
        return torch.mean(total)

    return apply_op(_hs, input, label, weight, bias, _op_name="hsigmoid_loss")


def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    def _np(a, p, y):
        sim = a @ p.t()
        eq = (y[:, None] == y[None, :]).to(a.dtype)
        tgt = eq / torch.sum(eq, -1, keepdim=True)
        xent = torch.mean(torch.sum(-tgt * torch.log_softmax(sim, -1), -1))
        reg = l2_reg * (torch.mean(torch.sum(a * a, -1))
                        + torch.mean(torch.sum(p * p, -1))) * 0.25
        return xent + reg

    return apply_op(_np, anchor, positive, labels, _op_name="npair_loss")


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean", name=None):
    """ArcFace-style margin softmax."""
    def _mce(lg, y):
        onehot = torch.nn.functional.one_hot(y.reshape(-1).long(),
                                             lg.shape[-1]).to(lg.dtype)
        theta = torch.arccos(torch.clamp(lg, -1 + 1e-7, 1 - 1e-7))
        tgt = torch.cos(margin1 * theta + margin2) - margin3
        adj = scale * torch.where(onehot > 0, tgt, lg)
        loss = _reduce(-torch.sum(onehot * torch.log_softmax(adj, -1), -1),
                       reduction)
        if return_softmax:
            return loss, torch.softmax(adj, -1)
        return loss

    return apply_op(_mce, logits, label, _op_name="margin_cross_entropy")


def rnnt_loss(input, label, input_lengths, label_lengths, blank=0,
              fastemit_lambda=0.001, reduction="mean", name=None):
    """RNN-T loss by the alpha lattice in log space; ``input`` [B, T, U+1,
    V] logits (normalised here)."""
    def _rnnt(lp, y, tl, ul):
        lp = torch.log_softmax(lp, -1)
        b, t_max, u_max, _ = lp.shape
        blank_lp = lp[..., blank]                                # [B,T,U+1]
        lab_lp = torch.gather(
            lp[:, :, :-1, :], -1,
            y.long()[:, None, :, None].expand(b, t_max, u_max - 1, 1)
        )[..., 0]                                                # [B,T,U]
        row = [lp.new_zeros(b)]
        for u in range(1, u_max):                                # t = 0
            row.append(row[-1] + lab_lp[:, 0, u - 1])
        alphas = [torch.stack(row, 1)]
        for t in range(1, t_max):
            prev = alphas[-1]
            row = [prev[:, 0] + blank_lp[:, t - 1, 0]]
            for u in range(1, u_max):
                row.append(torch.logaddexp(
                    prev[:, u] + blank_lp[:, t - 1, u],
                    row[-1] + lab_lp[:, t, u - 1]))
            alphas.append(torch.stack(row, 1))
        alphas = torch.stack(alphas, 0)                          # [T,B,U+1]
        ti = torch.clamp(tl.long() - 1, 0, t_max - 1)
        ui = torch.clamp(ul.long(), 0, u_max - 1)
        bidx = torch.arange(b, device=lp.device)
        final = alphas[ti, bidx, ui] + blank_lp[bidx, ti, ui]
        return _reduce(-final, reduction)

    return apply_op(_rnnt, input, label, input_lengths, label_lengths,
                    _op_name="rnnt_loss")


def gather_tree(ids, parents, name=None):
    """Back-traces beams: ``ids``/``parents`` [T, B, beam] -> tokens."""
    def _gt(ids_a, par_a):
        beam = torch.arange(ids_a.shape[-1], dtype=ids_a.dtype,
                            device=ids_a.device)
        beam_idx = beam[None, :].expand(ids_a.shape[1:])
        toks = [None] * ids_a.shape[0]
        for t in reversed(range(ids_a.shape[0])):
            toks[t] = torch.gather(ids_a[t], -1, beam_idx.long())
            beam_idx = torch.gather(par_a[t], -1,
                                    beam_idx.long()).to(beam_idx.dtype)
        return torch.stack(toks, 0)

    return apply_op(_gt, ids, parents, _op_name="gather_tree")


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    def _ts(a):
        nt, c, h, w = a.shape
        a = a.reshape(nt // seg_num, seg_num, c, h, w)
        fold = int(c * shift_ratio)
        left = torch.cat([a[:, 1:, :fold],
                          torch.zeros_like(a[:, :1, :fold])], 1)
        right = torch.cat([torch.zeros_like(a[:, :1, fold:2 * fold]),
                           a[:, :-1, fold:2 * fold]], 1)
        return torch.cat([left, right, a[:, :, 2 * fold:]],
                         2).reshape(nt, c, h, w)

    return apply_op(_ts, x, _op_name="temporal_shift")


def class_center_sample(label, num_classes, num_samples, group=None):
    """The label's classes, topped up with others from a fixed-seed draw
    (on the host), and the labels remapped onto them."""
    lab = np.asarray(label.numpy() if hasattr(label, "numpy") else label)
    dev = label._data.device if isinstance(label, Tensor) else None
    pos = np.unique(lab)
    if len(pos) >= num_samples:
        sampled = pos[:num_samples]
    else:
        rest = np.setdiff1d(np.arange(num_classes), pos)
        extra = np.random.RandomState(0).choice(
            rest, num_samples - len(pos), replace=False)
        sampled = np.concatenate([pos, extra])
    sampled = np.sort(sampled)
    remap = {c: i for i, c in enumerate(sampled)}
    new_lab = np.asarray([remap.get(int(v), -1) for v in lab.reshape(-1)])
    return (Tensor._wrap(torch.as_tensor(new_lab.reshape(lab.shape),
                                         device=dev)),
            Tensor._wrap(torch.as_tensor(sampled, device=dev)))


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Dense attention over [B, H, S, D] under the CSR pattern's mask: key
    j is seen by query row r when ``columns[offset[r]:offset[r+1]]`` holds
    j (entries past ``offset[S]`` mark nothing); masked scores are
    -1e30."""
    def _sa(q, k, v, offs, cols):
        b, h, s, d = q.shape
        logits = torch.einsum("bhsd,bhtd->bhst", q / math.sqrt(d), k)
        nnz = cols.shape[-1]
        entry = torch.arange(nnz, device=q.device).expand(b, h, nnz)
        row_of = torch.searchsorted(offs.contiguous(), entry.contiguous(),
                                    right=True) - 1
        # entries past the last row's end (padding) mark nothing, as the
        # reference's scatter drops out-of-range rows
        valid = row_of < s
        hits = torch.zeros(b, h, s * s, dtype=torch.int32, device=q.device)
        hits.scatter_add_(-1, torch.where(valid, row_of * s + cols.long(), 0),
                          valid.to(torch.int32))
        logits = torch.where(hits.reshape(b, h, s, s) > 0, logits,
                             torch.full_like(logits, -1e30))
        return torch.einsum("bhst,bhtd->bhsd", torch.softmax(logits, -1), v)

    return apply_op(_sa, query, key, value, sparse_csr_offset,
                    sparse_csr_columns, _op_name="sparse_attention")


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    dist = distance_function or (lambda a, b: pairwise_distance(a, b))
    dp = dist(input, positive)
    dn = dist(input, negative)
    if swap:
        dn = apply_op(torch.minimum, dn, dist(positive, negative),
                      _op_name="min")
    return apply_op(
        lambda a, b: _reduce(torch.clamp(a - b + margin, min=0.0),
                             reduction),
        dp, dn, _op_name="triplet_margin_distance")


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    def _mm(x, y):
        yi = y.reshape(-1).long()
        correct = torch.gather(x, -1, yi[:, None])
        m = torch.pow(torch.clamp(margin - correct + x, min=0.0), p)
        m = m.scatter(-1, yi[:, None], 0.0)
        return _reduce(torch.sum(m, -1) / x.shape[-1], reduction)

    return apply_op(_mm, input, label, _op_name="multi_margin_loss")


def adaptive_log_softmax_with_loss(input, label, head_weight, tail_weights,
                                   cutoffs, head_bias=None, name=None):
    """Adaptive softmax: the shortlist in the head, each cluster's
    log-probabilities behind its gate in the head."""
    def _als(x, y, hw, *rest):
        n_clusters = (len(cutoffs) - 1 if isinstance(cutoffs, (list, tuple))
                      else 0)
        head_logits = x @ hw
        if head_bias is not None:
            head_logits = head_logits + rest[-1]
        head_lsm = torch.log_softmax(head_logits, -1)
        yi = y.reshape(-1).long()
        shortlist = cutoffs[0]
        out = torch.where(
            yi < shortlist,
            torch.gather(head_lsm, -1,
                         torch.clamp(yi, 0, shortlist - 1)[:, None])[:, 0],
            torch.zeros((), dtype=x.dtype, device=x.device))
        for ci in range(n_clusters):
            lo, hi = cutoffs[ci], cutoffs[ci + 1]
            clust = torch.log_softmax(x @ rest[ci], -1)
            rel = torch.clamp(yi - lo, 0, hi - lo - 1)
            clust_lp = torch.gather(clust, -1, rel[:, None])[:, 0]
            out = torch.where((yi >= lo) & (yi < hi),
                              head_lsm[:, shortlist + ci] + clust_lp, out)
        return out, -torch.mean(out)

    rest = list(tail_weights) + ([head_bias] if head_bias is not None else [])
    return apply_op(_als, input, label, head_weight, *rest,
                    _op_name="adaptive_log_softmax")


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False,
                         return_softmax=False, fixed_seed_offset=None,
                         rng_name="", training=True, name=None):
    """``qkv [B, S, 3, H, D]`` through :func:`flash_attention`."""
    from .flash_attention import flash_attention

    return flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                           dropout=dropout, causal=causal,
                           return_softmax=return_softmax, training=training)


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k,
                                max_seqlen_q, max_seqlen_k, scale=None,
                                dropout=0.0, causal=False,
                                return_softmax=False, varlen_padded=True,
                                training=True, name=None):
    """:func:`flash_attn_qkvpacked` of the padded batch ``qkv [B, S, 3, H,
    D]``; boundaries other than the batch's own raise (one host read), and
    so do a ``scale`` and a ``max_seqlen_*`` other than S, which the
    reference ignores."""
    b, s = qkv.shape[0], qkv.shape[1]
    if scale is not None:
        raise NotImplementedError(
            f"flash_attn_varlen_qkvpacked(scale={scale}): the reference "
            f"ignores the argument and scales by 1/sqrt(head_dim)")
    padded = torch.arange(b + 1) * s
    for name_, cu in (("cu_seqlens_q", cu_seqlens_q),
                      ("cu_seqlens_k", cu_seqlens_k)):
        got = (cu._data if isinstance(cu, Tensor)
               else torch.as_tensor(np.asarray(cu))).cpu().long()
        if not torch.equal(got.reshape(-1), padded):
            raise NotImplementedError(
                f"flash_attn_varlen_qkvpacked: {name_} {got.tolist()} packs "
                f"sequences of other lengths; the reference ignores the "
                f"boundaries and attends over the padded [B, S] batch, "
                f"whose boundaries are {padded.tolist()}")
    for name_, m in (("max_seqlen_q", max_seqlen_q),
                     ("max_seqlen_k", max_seqlen_k)):
        if int(m) != s:
            raise NotImplementedError(
                f"flash_attn_varlen_qkvpacked: {name_}={m}; the reference "
                f"ignores it and attends over the padded length {s}")
    return flash_attn_qkvpacked(qkv, dropout=dropout, causal=causal,
                                return_softmax=return_softmax,
                                training=training)


# in-place activations: out of place, then rebound (``Tensor``'s rule)
def hardtanh_(x, min=-1.0, max=1.0, name=None):
    return x._assign_result_(apply_op(
        lambda a: torch.clamp(a, min, max), x, _op_name="hardtanh_"))


def leaky_relu_(x, negative_slope=0.01, name=None):
    return x._assign_result_(apply_op(
        lambda a: torch.where(a >= 0, a, negative_slope * a), x,
        _op_name="leaky_relu_"))


def thresholded_relu_(x, threshold=1.0, value=0.0, name=None):
    return x._assign_result_(apply_op(
        lambda a: torch.where(a > threshold, a,
                              torch.full_like(a, value)), x,
        _op_name="thresholded_relu_"))
