"""cinn.compiler: ``compile(fn)`` is ``torch.compile`` with the port's
graph-keeping backend."""
import builtins

import torch

__all__ = ["compile"]


def _backend(gm, example_inputs):
    """Keep dynamo's FX graph and run it as captured (the ``to_static``
    backend); each capture is reported to the compile watchdog."""
    from ... import telemetry

    telemetry.record_compile(
        "cinn.compile", tuple(tuple(getattr(t, "shape", ()))
                              for t in example_inputs),
        None, "to_static_capture")
    return gm.forward


def compile(fn=None, *, static_argnums=None, **kwargs):
    """``fn`` compiled (``static_argnums`` is jax's; dynamo guards on
    every Python argument anyway). A string of CINN source raises."""
    if isinstance(fn, builtins.str):
        raise NotImplementedError(
            "compiling CINN IR source text is reference-internal; pass a "
            "python callable (compiled by torch.compile)")
    if fn is None:
        return lambda f: compile(f, static_argnums=static_argnums)
    return torch.compile(fn, backend=_backend, dynamic=False)
