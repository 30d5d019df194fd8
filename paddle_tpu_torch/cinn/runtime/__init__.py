"""cinn.runtime: a module of compiled functions over ``cinn.compiler``."""
from ..compiler import compile as _compile

__all__ = ["CinnLowerLevelIrJit", "Module"]


class Module:
    """Compiled functions by name (the cinn runtime ``Module``)."""

    def __init__(self):
        self._fns = {}

    def add(self, name, fn):
        self._fns[name] = _compile(fn)
        return self._fns[name]

    def get_function(self, name):
        return self._fns[name]


def CinnLowerLevelIrJit(fn=None, **kwargs):
    return _compile(fn)
