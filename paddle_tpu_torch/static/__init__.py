"""paddle.static, so far ``InputSpec`` alone (counterpart of
``paddle_tpu/static/__init__.py:341-357``). The static-graph surface
(``Program``, ``Executor``, ``static.nn``) is still to port (ROADMAP,
A.13 (e)).

``InputSpec`` describes one input of ``jit.to_static`` and ``jit.save``:
a dim of ``None`` or ``-1`` is dynamic, and becomes a ``torch.export.Dim``
in a program that ``jit.save`` writes."""
from __future__ import annotations

__all__ = ["InputSpec"]


class InputSpec:
    def __init__(self, shape=None, dtype="float32", name=None,
                 stop_gradient=True):
        self.shape = list(shape) if shape is not None else None
        self.dtype = dtype
        self.name = name
        self.stop_gradient = stop_gradient

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(tensor.shape, tensor.dtype.name, name or tensor.name)

    @classmethod
    def from_numpy(cls, ndarray, name=None):
        return cls(list(ndarray.shape), str(ndarray.dtype), name)

    def dynamic_axes(self):
        """The axes declared ``None`` or ``-1``."""
        return tuple(i for i, d in enumerate(self.shape or ())
                     if d is None or (isinstance(d, int) and d < 0))

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")
