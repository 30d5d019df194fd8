"""Loss functionals (counterpart of ``paddle_tpu/nn/functional/loss.py``),
with the reference's semantics: ``cross_entropy`` applies ``ignore_index``
only when it is >= 0 (a label out of ``[0, C)`` otherwise contributes
0), ``smooth_l1_loss`` is Paddle's Huber form."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ...core.dispatch import apply_op
from ...core.tensor import Tensor


def _reduce(out, reduction):
    if reduction == "mean":
        return torch.mean(out)
    if reduction == "sum":
        return torch.sum(out)
    return out


def _pick(lp, lab, axis):
    """``lp`` at the integer labels along ``axis``; 0 where a label is out
    of range (the reference's one-hot of it is all zeros)."""
    n = lp.shape[axis]
    valid = (lab >= 0) & (lab < n)
    idx = torch.where(valid, lab, torch.zeros_like(lab)).long()
    picked = torch.gather(lp, axis, idx.unsqueeze(axis)).squeeze(axis)
    return torch.where(valid, picked, torch.zeros_like(picked)), valid


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    def _ce(logits, lab, w):
        ax = axis % logits.dim()
        lp = (torch.log_softmax(logits, ax) if use_softmax
              else torch.log(torch.clamp_min(logits, 1e-30)))
        n_classes = logits.shape[ax]
        if soft_label:
            soft = lab.to(lp.dtype)
            if label_smoothing > 0.0:
                soft = soft * (1 - label_smoothing) + \
                    label_smoothing / n_classes
            loss = -torch.sum(soft * lp, ax)
        else:
            lab_int = lab.squeeze(ax) if lab.dim() == lp.dim() else lab
            picked, _ = _pick(lp, lab_int, ax)
            loss = -picked
            if label_smoothing > 0.0:
                loss = (1 - label_smoothing) * loss - \
                    label_smoothing / n_classes * torch.sum(lp, ax)
            if w is not None:
                loss = loss * torch.take(
                    w, torch.clamp(lab_int, 0, n_classes - 1).long())
            if ignore_index >= 0:
                mask = lab_int != ignore_index
                loss = torch.where(mask, loss, torch.zeros_like(loss))
                if reduction == "mean":
                    denom = torch.clamp_min(mask.to(loss.dtype).sum(), 1.0)
                    return torch.sum(loss) / denom
        return _reduce(loss, reduction)

    return apply_op(_ce, input, label, weight, _op_name="cross_entropy")


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    from .activation import softmax as _softmax

    loss = loss.unsqueeze(axis) if loss.ndim < logits.ndim else loss
    if return_softmax:
        return loss, _softmax(logits, axis=axis)
    return loss


def mse_loss(input, label, reduction="mean", name=None):
    return apply_op(lambda a, b: _reduce(torch.square(a - b), reduction),
                    input, label, _op_name="mse_loss")


def l1_loss(input, label, reduction="mean", name=None):
    return apply_op(lambda a, b: _reduce(torch.abs(a - b), reduction),
                    input, label, _op_name="l1_loss")


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    """``0.5 d^2`` below ``delta``, ``delta (d - 0.5 delta)`` above."""
    return apply_op(lambda a, b: _reduce(F.huber_loss(
        a, b, reduction="none", delta=delta), reduction), input, label,
        _op_name="smooth_l1_loss")


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    def _nll(lp, lab, w):
        n_classes = lp.shape[1]
        lab_c = torch.clamp(lab, 0, n_classes - 1).long()
        picked = -torch.gather(lp, 1, lab_c.unsqueeze(1)).squeeze(1)
        wt = torch.ones_like(picked) if w is None else torch.take(w, lab_c)
        mask = (lab != ignore_index).to(picked.dtype)
        picked = picked * wt * mask
        if reduction == "mean":
            return torch.sum(picked) / torch.clamp_min(torch.sum(wt * mask),
                                                       1e-12)
        return _reduce(picked, reduction)

    return apply_op(_nll, input, label, weight, _op_name="nll_loss")


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    def _bce(p, y, w):
        p = torch.clamp(p, 1e-12, 1.0 - 1e-12)
        loss = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
        if w is not None:
            loss = loss * w
        return _reduce(loss, reduction)

    return apply_op(_bce, input, label, weight,
                    _op_name="binary_cross_entropy")


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    return apply_op(lambda z, y, w, pw: F.binary_cross_entropy_with_logits(
        z, y, w, reduction=reduction, pos_weight=pw), logit, label, weight,
        pos_weight, _op_name="bce_with_logits")


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    def _kl(lp, t):
        if log_target:
            loss = torch.exp(t) * (t - lp)
        else:
            loss = torch.where(t > 0, t * (torch.log(torch.clamp_min(
                t, 1e-30)) - lp), torch.zeros_like(lp))
        if reduction == "batchmean":
            return torch.sum(loss) / lp.shape[0]
        return _reduce(loss, reduction)

    return apply_op(_kl, input, label, _op_name="kl_div")


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return apply_op(lambda a, b, y: _reduce(
        torch.clamp_min(-y * (a - b) + margin, 0.0), reduction),
        input, other, label, _op_name="margin_ranking_loss")


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    return apply_op(lambda a, y: _reduce(torch.where(
        y == 1.0, a, torch.clamp_min(margin - a, 0.0)), reduction),
        input, label, _op_name="hinge_embedding_loss")


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    def _cel(a, b, y):
        cos = torch.sum(a * b, -1) / torch.clamp_min(
            torch.linalg.vector_norm(a, dim=-1)
            * torch.linalg.vector_norm(b, dim=-1), 1e-12)
        loss = torch.where(y == 1, 1 - cos, torch.clamp_min(cos - margin,
                                                            0.0))
        return _reduce(loss, reduction)

    return apply_op(_cel, input1, input2, label,
                    _op_name="cosine_embedding_loss")


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    def _tml(a, pos, neg):
        dp = torch.linalg.vector_norm(a - pos + epsilon, p, -1)
        dn = torch.linalg.vector_norm(a - neg + epsilon, p, -1)
        if swap:
            dn = torch.minimum(dn, torch.linalg.vector_norm(
                pos - neg + epsilon, p, -1))
        return _reduce(torch.clamp_min(dp - dn + margin, 0.0), reduction)

    return apply_op(_tml, input, positive, negative,
                    _op_name="triplet_margin_loss")


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    def _focal(z, y, nz):
        p = torch.sigmoid(z)
        ce = F.binary_cross_entropy_with_logits(z, y, reduction="none")
        p_t = p * y + (1 - p) * (1 - y)
        a_t = alpha * y + (1 - alpha) * (1 - y)
        loss = a_t * ((1 - p_t) ** gamma) * ce
        if nz is not None:
            loss = loss / nz
        return _reduce(loss, reduction)

    return apply_op(_focal, logit, label, normalizer,
                    _op_name="sigmoid_focal_loss")


def square_error_cost(input, label):
    return apply_op(lambda a, b: torch.square(a - b), input, label,
                    _op_name="square_error_cost")


def log_loss(input, label, epsilon=1e-4, name=None):
    return apply_op(lambda p, y: -y * torch.log(p + epsilon)
                    - (1 - y) * torch.log(1 - p + epsilon), input, label,
                    _op_name="log_loss")


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC over ``[T, B, C]`` logits (log-softmax applied here); ``mean``
    divides each loss by its label length, then averages."""
    return apply_op(lambda lp, lab, il, ll: F.ctc_loss(
        torch.log_softmax(lp.float(), -1), lab, il, ll, blank=blank,
        reduction=reduction).to(lp.dtype), log_probs, labels, input_lengths,
        label_lengths, _op_name="ctc_loss")


def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8,
                     reduction="mean", name=None):
    def _pnll(a, y):
        if log_input:
            loss = torch.exp(a) - y * a
        else:
            loss = a - y * torch.log(a + epsilon)
        if full:
            stirling = (y * torch.log(y + epsilon) - y
                        + 0.5 * torch.log(2 * math.pi * (y + epsilon)))
            loss = loss + torch.where(y > 1, stirling,
                                      torch.zeros_like(stirling))
        return _reduce(loss, reduction)

    return apply_op(_pnll, input, label, _op_name="poisson_nll_loss")


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    def _gnll(mu, y, var):
        var = torch.clamp_min(var, epsilon)
        loss = 0.5 * (torch.log(var) + torch.square(y - mu) / var)
        if full:
            loss = loss + 0.5 * math.log(2 * math.pi)
        return _reduce(loss, reduction)

    return apply_op(_gnll, input, label, variance,
                    _op_name="gaussian_nll_loss")


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean", name=None):
    def _ml(z, y, w):
        loss = -(y * F.logsigmoid(z) + (1 - y) * F.logsigmoid(-z))
        if w is not None:
            loss = loss * w
        return _reduce(torch.mean(loss, -1), reduction)

    return apply_op(_ml, input, label, weight,
                    _op_name="multi_label_soft_margin_loss")


def soft_margin_loss(input, label, reduction="mean", name=None):
    return apply_op(lambda z, y: _reduce(torch.log1p(torch.exp(-y * z)),
                                         reduction), input, label,
                    _op_name="soft_margin_loss")


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None, name=None):
    """Levenshtein distance between token sequences, on the host (a metric
    over int sequences, not differentiable). Returns (distances [B, 1]
    float32, sequence_num [1] int64)."""
    def _np(t):
        return np.asarray(t.numpy() if hasattr(t, "numpy") else t)

    a, b = _np(input), _np(label)
    a_len = (_np(input_length).reshape(-1) if input_length is not None
             else np.full((a.shape[0],), a.shape[1], np.int64))
    b_len = (_np(label_length).reshape(-1) if label_length is not None
             else np.full((b.shape[0],), b.shape[1], np.int64))
    ignored = set(ignored_tokens or ())

    def _dist(x, y):
        x = [t for t in x if t not in ignored]
        y = [t for t in y if t not in ignored]
        prev = list(range(len(y) + 1))
        for i, xi in enumerate(x, 1):
            cur = [i] + [0] * len(y)
            for j, yj in enumerate(y, 1):
                cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                             prev[j - 1] + (xi != yj))
            prev = cur
        return prev[-1], len(y)

    out = np.zeros((a.shape[0], 1), np.float32)
    for r in range(a.shape[0]):
        d, ly = _dist(a[r, :a_len[r]].tolist(), b[r, :b_len[r]].tolist())
        out[r, 0] = d / max(ly, 1) if normalized else d
    dev = input._data.device if isinstance(input, Tensor) else "cpu"
    return (Tensor._wrap(torch.from_numpy(out).to(dev)),
            Tensor._wrap(torch.tensor([a.shape[0]], dtype=torch.int64,
                                      device=dev)))


__all__ = [n for n, v in list(globals().items())
           if not n.startswith("_") and callable(v)
           and getattr(v, "__module__", None) == __name__]
