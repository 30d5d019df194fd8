"""paddle.incubate.optimizer.functional (counterpart of
``paddle_tpu/incubate/optimizer/functional/__init__.py:31-40``):
``minimize_bfgs`` and ``minimize_lbfgs``.

The reference runs ``jax.scipy.optimize.minimize(method="BFGS")`` for
both. Here both run ``torch.optim.LBFGS`` with the strong-Wolfe line
search, a full history for ``minimize_bfgs`` (``max_iters`` pairs: BFGS's
inverse-Hessian update in L-BFGS form) and ``history_size`` for
``minimize_lbfgs``. Each returns the reference's tuple
``(is_converge, num_func_calls, position, objective_value,
objective_gradient)``; it has converged when the search stopped before
``max_iters`` (a gradient or change tolerance met), as the reference's
``success`` says.
"""
from __future__ import annotations

import torch

from ...core.tensor import Tensor

__all__ = ["minimize_bfgs", "minimize_lbfgs"]


def _minimize(objective_func, initial_position, history, max_iters,
              tolerance_grad, tolerance_change, dtype):
    x0 = (initial_position._data if isinstance(initial_position, Tensor)
          else torch.as_tensor(initial_position))
    x = x0.detach().to(getattr(torch, str(dtype))).clone().requires_grad_()
    calls = [0]

    def f():
        calls[0] += 1
        out = objective_func(Tensor._wrap(x))
        return (out._data if isinstance(out, Tensor) else out).reshape(())

    opt = torch.optim.LBFGS([x], lr=1.0, max_iter=max_iters,
                            tolerance_grad=tolerance_grad,
                            tolerance_change=tolerance_change,
                            history_size=history,
                            line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad()
        loss = f()
        loss.backward()
        return loss

    opt.step(closure)
    n_iter = opt.state[x]["n_iter"]
    x.grad = None
    with torch.enable_grad():
        value = f()
        (grad,) = torch.autograd.grad(value, x)
    converged = n_iter < max_iters or bool(grad.abs().max()
                                           <= tolerance_grad)
    return (converged, calls[0], Tensor._wrap(x.detach()),
            Tensor._wrap(value.detach()), Tensor._wrap(grad))


def minimize_bfgs(objective_func, initial_position, max_iters=50,
                  tolerance_grad=1e-7, tolerance_change=1e-9,
                  initial_inverse_hessian_estimate=None,
                  line_search_fn="strong_wolfe", max_line_search_iters=50,
                  initial_step_length=1.0, dtype="float32", name=None):
    return _minimize(objective_func, initial_position, max(max_iters, 1),
                     max_iters, tolerance_grad, tolerance_change, dtype)


def minimize_lbfgs(objective_func, initial_position, history_size=100,
                   max_iters=50, tolerance_grad=1e-7, tolerance_change=1e-9,
                   initial_inverse_hessian_estimate=None,
                   line_search_fn="strong_wolfe", max_line_search_iters=50,
                   initial_step_length=1.0, dtype="float32", name=None):
    return _minimize(objective_func, initial_position, history_size,
                     max_iters, tolerance_grad, tolerance_change, dtype)
