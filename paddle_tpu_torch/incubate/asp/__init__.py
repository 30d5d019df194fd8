"""ASP: n:m structured sparsity (counterpart of
``paddle_tpu/incubate/asp/__init__.py``; Paddle's incubate/asp/asp.py and
the mask and check algorithms of incubate/asp/utils.py).

``prune_model`` computes an n:m mask for every ``nn.Linear`` weight (and
every layer type given to ``add_supported_layer``) that is not excluded:
``mask_1d`` keeps the n largest |w| of every m consecutive values along the
last axis; ``mask_2d_greedy`` and ``mask_2d_best`` keep n a row and n a
column in every m × m block (a weight whose sides m does not divide takes
``mask_1d``). ``decorate`` wraps the optimizer's ``step`` so the masks are
applied again after each update; it is idempotent.

The mask algorithms run in torch on the weight's device (no host copy of
a weight on the card): the reference's selections, with the pattern
scores summed in float64 and the ties of the sorts broken by position,
as numpy's sorts of so few values break them. ``get_mask_1d``,
``get_mask_2d_greedy`` and ``get_mask_2d_best`` are the reference's
numpy-in, numpy-out names over them.

Pruning and the step hook write into the ``torch.nn.Parameter`` each
Paddle ``Parameter`` holds, in place, so an optimizer keeps updating the
tensors the model reads; the mask lives on the Parameter (``_asp_mask``).
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from ...core.tensor import Tensor

_EXCLUDED = set()      # sublayer or parameter names excluded from pruning


# ---------------------------------------------------------------------------
# mask generation (utils.py get_mask_1d, get_mask_2d_greedy,
# get_mask_2d_best), on the weight's device
# ---------------------------------------------------------------------------
def _blocks_2d(w, m):
    rows, cols = w.shape
    return w.reshape(rows // m, m, cols // m, m).transpose(0, 2, 1, 3)


def _valid_2d_patterns(n, m):
    """All m x m 0/1 matrices with every row and column summing to n."""
    patterns = []
    rows = [np.array(p) for p in itertools.combinations(range(m), n)]
    for choice in itertools.product(rows, repeat=m):
        mat = np.zeros((m, m), np.float32)
        for i, cols in enumerate(choice):
            mat[i, cols] = 1.0
        if (mat.sum(0) == n).all():
            patterns.append(mat)
    return np.stack(patterns)  # [P, m, m]


_PATTERN_CACHE = {}


def _patterns(n, m):
    if (n, m) not in _PATTERN_CACHE:
        _PATTERN_CACHE[(n, m)] = _valid_2d_patterns(n, m)
    return _PATTERN_CACHE[(n, m)]


def _descending(a):
    """Indices sorting the last axis by value, largest first, ties by
    position."""
    return torch.argsort(-a, dim=-1, stable=True)


def _mask_1d(w, n=2, m=4):
    """Keep the n largest-|w| of every m consecutive along the last dim."""
    if w.numel() % m:
        return torch.ones_like(w)
    flat = w.reshape(-1, m)
    idx = _descending(flat.abs())[:, :n]
    return torch.zeros_like(flat).scatter_(1, idx, 1.0).reshape(w.shape)


def _blocks_2d_torch(w, m):
    rows, cols = w.shape
    return w.reshape(rows // m, m, cols // m, m).permute(0, 2, 1, 3)


def _unblocks_2d_torch(b, shape):
    return b.permute(0, 2, 1, 3).reshape(shape)


def _best_patterns(flat, n, m):
    """The best pattern of each row of ``flat`` [B, m*m] (|w| a block),
    scored in float64: [B, m*m] 0/1."""
    pats = torch.from_numpy(_patterns(n, m).reshape(-1, m * m)).to(
        flat.device)
    best = (flat.double() @ pats.double().t()).argmax(1)
    return pats[best]


def _mask_2d_greedy(w, n=2, m=4):
    """n:m in both directions of every m x m block, greedy by magnitude,
    over all blocks at once; a block the greedy pass leaves short of n·m
    kept values takes the best full pattern."""
    if w.dim() != 2 or w.shape[0] % m or w.shape[1] % m:
        return _mask_1d(w, n, m)
    blocks = _blocks_2d_torch(w.abs().float(), m)
    R, C = blocks.shape[:2]
    flat = blocks.reshape(-1, m * m)
    B = flat.shape[0]
    order = _descending(flat)
    rows_of, cols_of = order // m, order % m
    row_cnt = torch.zeros(B, m, dtype=torch.int32, device=w.device)
    col_cnt = torch.zeros_like(row_cnt)
    mask = torch.zeros(B, m * m, device=w.device)
    one = torch.ones(B, 1, dtype=torch.int32, device=w.device)
    for step in range(m * m):
        i, j = rows_of[:, step:step + 1], cols_of[:, step:step + 1]
        ok = ((row_cnt.gather(1, i) < n) & (col_cnt.gather(1, j) < n))
        mask.scatter_add_(1, order[:, step:step + 1], ok.float())
        row_cnt.scatter_add_(1, i, one * ok)
        col_cnt.scatter_add_(1, j, one * ok)
    deficient = mask.sum(1) < n * m
    mask[deficient] = _best_patterns(flat[deficient], n, m)
    out = mask.reshape(R, C, m, m)
    return _unblocks_2d_torch(out, w.shape).to(w.dtype)


def _mask_2d_best(w, n=2, m=4):
    """The best n:m-in-both-dims pattern of every m x m block, searched
    over all valid patterns (90 at 2:4)."""
    if w.dim() != 2 or w.shape[0] % m or w.shape[1] % m:
        return _mask_1d(w, n, m)
    blocks = _blocks_2d_torch(w.abs().float(), m)
    R, C = blocks.shape[:2]
    out = _best_patterns(blocks.reshape(-1, m * m), n, m)
    return _unblocks_2d_torch(out.reshape(R, C, m, m), w.shape).to(w.dtype)


_MASK_ALGOS = {"mask_1d": _mask_1d, "mask_2d_greedy": _mask_2d_greedy,
               "mask_2d_best": _mask_2d_best}


def _numpy_mask(algo):
    def get_mask(w: np.ndarray, n=2, m=4) -> np.ndarray:
        return _MASK_ALGOS[algo](torch.from_numpy(np.asarray(w)), n,
                                 m).numpy()

    get_mask.__name__ = get_mask.__qualname__ = "get_" + algo
    get_mask.__doc__ = (f"The {algo} mask of a numpy weight, as a numpy "
                        "array of its type.")
    return get_mask


get_mask_1d = _numpy_mask("mask_1d")
get_mask_2d_greedy = _numpy_mask("mask_2d_greedy")
get_mask_2d_best = _numpy_mask("mask_2d_best")


# ---------------------------------------------------------------------------
# checking (utils.py check_mask_1d / check_mask_2d / check_sparsity)
# ---------------------------------------------------------------------------
def _host(t):
    if isinstance(t, Tensor):
        return np.asarray(t.numpy())
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def check_mask_1d(mat, n=2, m=4) -> bool:
    arr = _host(mat)
    if arr.size % m:
        return False
    return bool((np.count_nonzero(arr.reshape(-1, m), axis=1) <= n).all())


def check_mask_2d(mat, n=2, m=4) -> bool:
    arr = _host(mat)
    if arr.ndim != 2 or arr.shape[0] % m or arr.shape[1] % m:
        return False
    blocks = _blocks_2d(arr != 0, m)
    return bool(
        (blocks.sum(-1) <= n).all() and (blocks.sum(-2) <= n).all())


def check_sparsity(tensor, n=2, m=4, func_name="check_mask_1d") -> bool:
    fn = check_mask_2d if "2d" in str(func_name) else check_mask_1d
    return fn(tensor, n, m)


def calculate_density(tensor) -> float:
    arr = _host(tensor)
    return float((arr != 0).sum() / arr.size)


# ---------------------------------------------------------------------------
# prune + training guarantee (asp.py prune_model / decorate)
# ---------------------------------------------------------------------------
_EXTRA_SUPPORTED = {}


def add_supported_layer(layer, pruning_func=None):
    """Register an extra layer TYPE (or type name) whose ``weight``
    ``prune_model`` prunes; ``pruning_func(weight, n, m) -> mask`` (numpy
    in, numpy out, as in the reference) overrides the mask algorithm for
    that layer (asp.py add_supported_layer)."""
    key = layer if isinstance(layer, type) else str(layer)
    _EXTRA_SUPPORTED[key] = pruning_func


def _mask_of(p, algo, custom, n, m):
    """The mask of Parameter ``p`` as a tensor of its type on its device."""
    w = p._data.detach()
    if custom is not None:
        mask = np.asarray(custom(np.asarray(p.numpy()), n, m))
        return torch.from_numpy(mask).to(w.device, w.dtype)
    return _MASK_ALGOS[algo](w, n, m)


def prune_model(model, n=2, m=4, mask_algo="mask_1d", with_mask=True):
    """Apply n:m masks to every trainable Linear weight (minus excluded),
    in place; returns ``{sublayer name: mask}`` (masks as numpy, as the
    reference's)."""
    from ... import nn

    if mask_algo not in _MASK_ALGOS:
        raise KeyError(mask_algo)
    extra_types = tuple(t for t in _EXTRA_SUPPORTED if isinstance(t, type))
    extra_names = {t for t in _EXTRA_SUPPORTED if isinstance(t, str)}
    pruned = {}
    for name, layer in model.named_sublayers():
        supported = (isinstance(layer, nn.Linear)
                     or isinstance(layer, extra_types)
                     or type(layer).__name__ in extra_names)
        if not supported or not hasattr(layer, "weight"):
            continue
        custom = None
        for key, fn in _EXTRA_SUPPORTED.items():
            if fn is not None and (
                    (isinstance(key, type) and isinstance(layer, key))
                    or type(layer).__name__ == key):
                custom = fn
                break
        p = layer.weight
        pname = getattr(p, "name", name + ".weight")
        if name in _EXCLUDED or pname in _EXCLUDED:
            continue
        mask = _mask_of(p, mask_algo, custom, n, m)
        with torch.no_grad():
            p._data.mul_(mask)
        if with_mask:
            p._asp_mask = mask
        pruned[name] = mask.float().cpu().numpy()
    return pruned


def decorate(optimizer):
    """Wrap ``optimizer.step`` to apply the masks again after each update
    (parity: asp.py decorate -> OptimizerWithSparsityGuarantee), in place
    on the parameters the optimizer holds. Idempotent."""
    if getattr(optimizer, "_asp_decorated", False):
        return optimizer
    orig_step = optimizer.step

    def masked_params():
        paddle_of = getattr(optimizer, "_paddle_params", {})
        for group in optimizer.param_groups:
            for t in group["params"]:
                mask = getattr(paddle_of.get(id(t)), "_asp_mask", None)
                if mask is not None:
                    yield t, mask

    def step(*args, **kwargs):
        out = orig_step(*args, **kwargs)
        with torch.no_grad():
            for t, mask in masked_params():
                t.mul_(mask)
        return out

    optimizer.step = step
    optimizer._asp_decorated = True
    return optimizer


def reset_excluded_layers(model=None):
    _EXCLUDED.clear()


def set_excluded_layers(model=None, param_names=()):
    """Exclude layers (by sublayer name or parameter name) from pruning
    (asp.py set_excluded_layers)."""
    _EXCLUDED.update(param_names)
