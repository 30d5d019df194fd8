"""Random ops (counterpart of ``paddle_tpu/ops/random.py``).

Each op draws from the default generator of the device it makes its
tensor on (``framework``'s docstring); an explicit nonzero ``seed``
argument draws from a fresh generator seeded with it, as the reference
keys its op with ``PRNGKey(seed)``. The streams are torch's: the same seed
gives other numbers than the reference.
"""
from __future__ import annotations

import torch

from .. import dtypes as _dt
from .. import framework
from ..core.dispatch import apply_op
from ..core.tensor import Tensor
from ..device import _current_device
from .creation import _shape_list


def _default_float():
    return framework.get_default_dtype().torch_dtype


def _dtype(dtype):
    return _dt.to_torch(dtype) if dtype is not None else _default_float()


def _seeded(seed, device):
    if not seed:
        return None
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def rand(shape, dtype=None, name=None):
    return Tensor._wrap(torch.rand(_shape_list(shape), dtype=_dtype(dtype),
                                   device=_current_device()))


def randn(shape, dtype=None, name=None):
    return Tensor._wrap(torch.randn(_shape_list(shape), dtype=_dtype(dtype),
                                    device=_current_device()))


def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    dev = _current_device()
    t = torch.empty(_shape_list(shape), dtype=_dtype(dtype), device=dev)
    return Tensor._wrap(t.uniform_(min, max, generator=_seeded(seed, dev)))


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        def _normal(m, s):
            m = torch.as_tensor(m, dtype=_default_float(),
                                device=_current_device())
            s = torch.as_tensor(s, dtype=_default_float(), device=m.device)
            shp = torch.broadcast_shapes(m.shape, s.shape)
            return m + s * torch.randn(shp, dtype=m.dtype, device=m.device)

        return apply_op(_normal, mean, std, _op_name="normal")
    shp = _shape_list(shape) if shape is not None else []
    return Tensor._wrap(mean + std * torch.randn(
        shp, dtype=_default_float(), device=_current_device()))


def gaussian(shape, mean=0.0, std=1.0, seed=0, dtype=None, name=None):
    dev = _current_device()
    t = torch.empty(_shape_list(shape), dtype=_dtype(dtype), device=dev)
    return Tensor._wrap(t.normal_(mean, std, generator=_seeded(seed, dev)))


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    return Tensor._wrap(torch.randint(
        int(low), int(high), _shape_list(shape), dtype=_dt.to_torch(dtype),
        device=_current_device()))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    if high is None:
        low, high = 0, low
    d = _dt.to_torch(dtype) if dtype is not None else x._data.dtype
    return Tensor._wrap(torch.randint(int(low), int(high), tuple(x.shape),
                                      device=x._data.device).to(d))


def randperm(n, dtype="int64", name=None):
    return Tensor._wrap(torch.randperm(int(n), device=_current_device()
                                       ).to(_dt.to_torch(dtype)))


def bernoulli(x, name=None):
    return apply_op(torch.bernoulli, x, _op_name="bernoulli")


def bernoulli_(x, p=0.5, name=None):
    out = Tensor._wrap(torch.empty_like(x._data).bernoulli_(p))
    return x._assign_result_(out)


def binomial(count, prob, name=None):
    return apply_op(
        lambda n, p: torch.binomial(n.float(), p.float()).to(torch.int64),
        count, prob, _op_name="binomial")


def poisson(x, name=None):
    return apply_op(torch.poisson, x, _op_name="poisson")


def multinomial(x, num_samples=1, replacement=False, name=None):
    return apply_op(lambda p: torch.multinomial(p, num_samples, replacement),
                    x, _op_name="multinomial")


def exponential_(x, lam=1.0, name=None):
    out = Tensor._wrap(torch.empty_like(x._data).exponential_(lam))
    return x._assign_result_(out)


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    a = x._data
    out = torch.empty_like(a).uniform_(min, max,
                                       generator=_seeded(seed, a.device))
    return x._assign_result_(Tensor._wrap(out))


def normal_(x, mean=0.0, std=1.0, name=None):
    out = Tensor._wrap(torch.empty_like(x._data).normal_(mean, std))
    return x._assign_result_(out)


def rand_like(x, dtype=None, name=None):
    d = _dt.to_torch(dtype) if dtype is not None else x._data.dtype
    return Tensor._wrap(torch.rand_like(x._data, dtype=d))


def randn_like(x, dtype=None, name=None):
    d = _dt.to_torch(dtype) if dtype is not None else x._data.dtype
    return Tensor._wrap(torch.randn_like(x._data, dtype=d))


def shuffle(x, axis=0, name=None):
    def _shuffle(a):
        perm = torch.randperm(a.shape[axis], device=a.device)
        return a.index_select(axis, perm)

    return apply_op(_shuffle, x, _op_name="shuffle")


__all__ = [
    "rand", "randn", "standard_normal", "uniform", "normal", "gaussian",
    "randint", "randint_like", "randperm", "bernoulli", "bernoulli_",
    "binomial", "poisson", "multinomial", "exponential_", "uniform_",
    "normal_", "rand_like", "randn_like", "shuffle",
]
