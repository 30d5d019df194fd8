"""Global framework state: grad mode, default dtype, random generators.

Counterpart of ``paddle_tpu/framework.py``. Grad mode is torch's own
(``paddle.no_grad`` is ``torch.no_grad`` under Paddle's names), so the
surface's ops and the port's torch-level code see one switch. The default
dtype is the surface's own: it decides what ``to_tensor`` of Python floats
and the creation ops make, and leaves torch's default alone.

Randomness: the reference chains jax PRNG keys; here every random op of
the surface, the initializers and dropout draw from the default generator
of the device they make their tensor on (``torch.default_generator``, or
the card's ``torch.cuda.default_generators[i]``). ``seed(s)`` seeds them
all (``torch.manual_seed``), so one seed gives the same values twice. The
streams are torch's, not jax's: the same seed gives other numbers than the
reference, and tests hold random ops by distribution.
"""
from __future__ import annotations

import functools
import threading

import torch

from . import dtypes as _dtype_mod


class _GlobalState(threading.local):
    def __init__(self):
        self.default_dtype = _dtype_mod.float32


_state = _GlobalState()


# -- grad mode ---------------------------------------------------------------
def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def set_grad_enabled(mode: bool):
    """Context manager AND direct setter (``paddle.set_grad_enabled``)."""
    return torch.set_grad_enabled(bool(mode))


class no_grad:
    """``paddle.no_grad``: a context manager or a decorator."""

    _mode = False

    def __enter__(self):
        self._prev = torch.is_grad_enabled()
        torch.set_grad_enabled(self._mode)
        return self

    def __exit__(self, *exc):
        torch.set_grad_enabled(self._prev)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*a, **k):
            with type(self)():
                return fn(*a, **k)

        return wrapper


class enable_grad(no_grad):
    _mode = True


# -- default dtype -----------------------------------------------------------
def set_default_dtype(d):
    d = _dtype_mod.convert_dtype(d)
    if not d.is_floating_point:
        raise TypeError(f"default dtype must be floating point, got {d}")
    _state.default_dtype = d


def get_default_dtype():
    return _state.default_dtype


# -- random ------------------------------------------------------------------
class Generator:
    """``paddle.Generator`` over a ``torch.Generator``: ``manual_seed``,
    ``seed``, ``initial_seed``, ``get_state``, ``set_state``. With no
    ``generator`` it makes its own on ``device`` (the CPU by default)."""

    def __init__(self, seed=None, device="cpu", generator=None):
        self._gen = (generator if generator is not None
                     else torch.Generator(device=device))
        if seed is not None:
            self.manual_seed(seed)

    def manual_seed(self, seed: int):
        self._gen.manual_seed(int(seed))
        return self

    def seed(self):
        self._gen.seed()
        return self

    @property
    def initial_seed(self):
        return self._gen.initial_seed()

    def get_state(self):
        return self._gen.get_state()

    def set_state(self, state):
        self._gen.set_state(state)

    @property
    def torch_generator(self):
        return self._gen


def default_generator() -> Generator:
    """The default generator of the current device, which the random ops
    draw from."""
    from .device import _current_device

    dev = _current_device()
    if dev.type == "cuda":
        # the card's generators exist once CUDA is initialized, which no
        # op may have done yet
        torch.cuda.init()
        idx = dev.index if dev.index is not None else torch.cuda.current_device()
        return Generator(generator=torch.cuda.default_generators[idx])
    return Generator(generator=torch.default_generator)


def seed(s: int):
    """``paddle.seed``: seeds the CPU's and every card's default
    generator."""
    torch.manual_seed(int(s))
    return default_generator()


def get_rng_state():
    return [default_generator().get_state()]


def set_rng_state(state):
    default_generator().set_state(state[0])


# -- mode flags ----------------------------------------------------------------
def in_dynamic_mode() -> bool:
    return True


def in_dynamic_or_pir_mode() -> bool:
    return True


def in_pir_mode() -> bool:
    return False
