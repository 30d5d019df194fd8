"""``paddle.incubate.autograd`` (counterpart of
``paddle_tpu/incubate/autograd/__init__.py``; Paddle's primapi): the
functional transforms are ``paddle.autograd``'s, and ``enable_prim``/
``disable_prim`` record the flag. torch's autograd composes every op's
gradient from its own formulas whatever the flag says, as JAX's
primitives do for the reference."""
from ...autograd import grad  # noqa: F401
from ...autograd.functional import Hessian, Jacobian, jvp, vjp  # noqa: F401

__all__ = ["vjp", "jvp", "Jacobian", "Hessian", "enable_prim",
           "disable_prim", "forward_grad", "grad"]

_PRIM = {"enabled": True}


def enable_prim():
    _PRIM["enabled"] = True


def disable_prim():
    _PRIM["enabled"] = False


def forward_grad(outputs, inputs, grad_inputs=None):
    """Forward-mode gradient of recorded static programs (primapi
    .forward_grad), which the port has not: a callable raises
    ``TypeError``, computed outputs ``NotImplementedError``, as the
    reference's do; ``jvp(func, xs, v)`` is the eager form."""
    if callable(outputs):
        raise TypeError("forward_grad takes computed outputs; use "
                        "paddle.incubate.autograd.jvp for callables")
    raise NotImplementedError(
        "forward_grad over recorded static programs is not supported; "
        "call paddle.incubate.autograd.jvp(fn, xs, v)")
