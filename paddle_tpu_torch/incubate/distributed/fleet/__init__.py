"""paddle.incubate.distributed.fleet's recompute wrappers (counterpart
of ``paddle_tpu/incubate/distributed/fleet/__init__.py:7,29``) at degree
1: each segment is a non-reentrant ``torch.utils.checkpoint`` over the
Paddle Tensors' payloads, so its activations are recomputed in the
backward. Model parallelism waits for the multi-GPU slice (ROADMAP)."""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ....core.tensor import Tensor

__all__ = ["recompute_sequential", "recompute_hybrid"]


def _recompute(function, *args, **kwargs):
    kwargs.pop("use_reentrant", None)
    preserve = kwargs.pop("preserve_rng_state", True)
    is_t = [isinstance(a, Tensor) for a in args]

    def run(*raw):
        it = iter(raw)
        call = [Tensor._wrap(next(it)) if t else a
                for a, t in zip(args, is_t)]
        out = function(*call, **kwargs)
        return out._data if isinstance(out, Tensor) else out

    raw = [a._data for a, t in zip(args, is_t) if t]
    out = checkpoint(run, *raw, use_reentrant=False,
                     preserve_rng_state=preserve)
    return Tensor._wrap(out) if isinstance(out, torch.Tensor) else out


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Run ``functions`` (a Sequential or a list of layers) over ``args``
    in ``ctx["segments"]`` recomputed segments; returns the output."""
    segments = int((ctx or {}).get("segments", 1))
    layers = list(functions)
    if segments <= 1:
        chunks = [layers]
    else:
        k = max(1, len(layers) // segments)
        chunks = [layers[i:i + k] for i in range(0, len(layers), k)]
    out = args[0] if len(args) == 1 else args
    for chunk in chunks:
        def seg(h, _chunk=chunk):
            for lay in _chunk:
                h = lay(h)
            return h

        out = _recompute(seg, out, **kwargs)
    return out


def recompute_hybrid(ctx, function, *args, **kwargs):
    """``function(*args)`` recomputed in the backward (degree 1: no
    model-parallel RNG to track)."""
    return _recompute(function, *args, **kwargs)
