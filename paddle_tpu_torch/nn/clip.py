"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py`` and of the
clip branch of the reference's compiled step tail,
``paddle_tpu/jit/__init__.py:688-704``).

The three clip kinds act in place on a list of gradients. The global norm
is one f32 sum of squares over every gradient; ``TrainStep`` computes it
once and shares it between its health bundle and ``ClipGradByGlobalNorm``.
``ClipGradByNorm`` scales each tensor by ``min(c / max(n, c), 1)`` on its
own f32 norm ``n``; ``ClipGradByValue`` clamps each element.

The functional helpers take a module or an iterable of parameters:
``global_grad_norm`` (never mutates), ``clip_grad_norm_`` (a nonfinite
norm never scales; ``error_if_nonfinite`` raises instead) and
``clip_grad_value_``.
"""
from __future__ import annotations

import math

import torch


def global_grad_sumsq(grads):
    """Sum of squares of every gradient, in f32 (a 0-d tensor)."""
    grads = [g for g in grads if g is not None]
    if not grads:
        return torch.zeros((), dtype=torch.float32)
    return torch.stack([g.float().square().sum() for g in grads]).sum()


class ClipGradByGlobalNorm:
    """Scale every gradient by ``clip_norm / max(global_norm, clip_norm)``,
    in f32, rounding back to the gradient's type. In place."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    @torch.no_grad()
    def scale_(self, grads, global_norm):
        clip = torch.tensor(self.clip_norm, dtype=torch.float32,
                            device=global_norm.device)
        scale = clip / torch.maximum(global_norm, clip)
        for g in grads:
            g.copy_((g.float() * scale).to(g.dtype))

    @torch.no_grad()
    def __call__(self, grads):
        grads = [g for g in grads if g is not None]
        if grads:
            self.scale_(grads, global_grad_sumsq(grads).sqrt())
        return grads


class ClipGradByNorm:
    """Scale each gradient by ``min(c / max(||g||, c), 1)``, its own f32
    L2 norm against ``clip_norm``. In place."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    @torch.no_grad()
    def __call__(self, grads):
        grads = [g for g in grads if g is not None]
        for g in grads:
            n = torch.linalg.vector_norm(g.float())
            c = torch.tensor(self.clip_norm, dtype=torch.float32,
                             device=g.device)
            scale = torch.clamp_max(c / torch.maximum(n, c), 1.0)
            g.copy_((g.float() * scale).to(g.dtype))
        return grads


class ClipGradByValue:
    """Clamp every gradient element to ``[min, max]`` (``min`` defaults to
    ``-max``). In place."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = -self.max if min is None else float(min)

    @torch.no_grad()
    def __call__(self, grads):
        grads = [g for g in grads if g is not None]
        for g in grads:
            g.clamp_(self.min, self.max)
        return grads


def _with_grads(parameters):
    if isinstance(parameters, torch.nn.Module):
        parameters = parameters.parameters()
    return [p for p in parameters if p.grad is not None]


@torch.no_grad()
def global_grad_norm(parameters, norm_type=2.0):
    """The total gradient norm over ``parameters`` (a module or an
    iterable), in f32, without touching any gradient."""
    params = _with_grads(parameters)
    if not params:
        return torch.zeros(())
    if norm_type == float("inf"):
        return torch.stack([p.grad.float().abs().max() for p in params]).max()
    total = torch.stack([(p.grad.float().abs() ** norm_type).sum()
                         for p in params]).sum()
    return total ** (1.0 / norm_type)


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the gradients so their total norm is at most ``max_norm``;
    returns the norm before scaling. A nonfinite norm never reaches the
    scale (``max_norm / inf`` would zero every gradient, ``/ nan`` poison
    them): the gradients stay as they are, or with ``error_if_nonfinite``
    it raises. One host read of the norm."""
    params = _with_grads(parameters)
    if not params:
        return torch.zeros(())
    total = global_grad_norm(params, norm_type)
    total_f = float(total.item())
    if not math.isfinite(total_f):
        if error_if_nonfinite:
            raise RuntimeError(
                f"the total norm of order {norm_type} for the gradients "
                f"is non-finite ({total_f}), so it cannot be clipped. "
                "Pass error_if_nonfinite=False to return the norm "
                "without clipping (grads left untouched)")
        return total
    clip_coef = float(max_norm) / (total_f + 1e-6)
    if clip_coef < 1.0:
        for p in params:
            p.grad.mul_(clip_coef)
    return total


@torch.no_grad()
def clip_grad_value_(parameters, clip_value):
    """Clamp every gradient element to ``[-clip_value, clip_value]``."""
    for p in _with_grads(parameters):
        p.grad.clamp_(-clip_value, clip_value)
