"""Global-norm gradient clipping (counterpart of
``paddle_tpu/nn/clip.py:51`` and of ``jit._functional_clip_global_norm``).

The norm is one f32 sum of squares over every gradient; ``TrainStep``
computes it once and shares it between its health bundle and the clip.
"""
from __future__ import annotations

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
