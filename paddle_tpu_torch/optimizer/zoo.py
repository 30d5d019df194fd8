"""The rest of the optimizer zoo (counterpart of
``paddle_tpu/optimizer/__init__.py:15-563``): SGD, Momentum, Adagrad,
Adamax, RMSProp, Adadelta, Lamb, NAdam, RAdam, ASGD, Rprop and LBFGS.

Plain PyTorch, as the reference's are plain ``jnp``: each ``_update``
computes what the reference's pure ``_update`` does, in the same order
and types, and writes every result through ``Optimizer._put`` (so a
guarded ``TrainStep`` keeps the old bytes on a discarded step). Where the
reference computes in the parameter's type (SGD, Momentum, Adagrad), a
Python scalar is first rounded to that type (``weak``), as JAX's weak
typing rounds it. Slots
keep the reference's names and types: param-typed for SGD-like
accumulators (Momentum, Adagrad), f32 for the rest.

``Lamb``'s ``exclude_from_weight_decay_fn`` is called with the
parameter's name, as AdamW's ``apply_decay_param_fun`` is, in ``step()``
and in ``TrainStep`` alike. ``LBFGS.step(closure)`` is eager only: the
closure computes the loss and its gradients.
"""
from __future__ import annotations

import torch

from .optimizer import Optimizer
from .regularizer import weak


class SGD(Optimizer):
    def __init__(self, params, lr=1e-3, weight_decay=None, grad_clip=None):
        super().__init__(params, lr, weight_decay, grad_clip)

    def _update(self, p, g, st, group, name):
        self._put(p, p - weak(group["lr"], p.dtype) * g)


class ASGD(SGD):
    pass


class Momentum(Optimizer):
    def __init__(self, params, lr=1e-3, momentum=0.9, use_nesterov=False,
                 weight_decay=None, grad_clip=None):
        super().__init__(params, lr, weight_decay, grad_clip)
        self.momentum = momentum
        self.use_nesterov = bool(use_nesterov)

    def _init_state(self, p, st):
        st["velocity"] = torch.zeros_like(p)

    def _update(self, p, g, st, group, name):
        lr, mu = weak(group["lr"], p.dtype), weak(self.momentum, p.dtype)
        v = mu * st["velocity"] + g
        if self.use_nesterov:
            new = p - lr * (g + mu * v)
        else:
            new = p - lr * v
        self._put(st["velocity"], v)
        self._put(p, new)


class Adagrad(Optimizer):
    def __init__(self, params, lr, epsilon=1e-6, weight_decay=None,
                 grad_clip=None, initial_accumulator_value=0.0):
        super().__init__(params, lr, weight_decay, grad_clip)
        self.epsilon = epsilon
        self.initial_accumulator_value = initial_accumulator_value

    def _init_state(self, p, st):
        st["moment"] = torch.full_like(p, self.initial_accumulator_value)

    def _update(self, p, g, st, group, name):
        m = st["moment"] + g * g
        new = p - weak(group["lr"], p.dtype) * g / (
            torch.sqrt(m) + weak(self.epsilon, p.dtype))
        self._put(st["moment"], m)
        self._put(p, new)


def _f32_zeros(p):
    return torch.zeros_like(p, dtype=torch.float32)


def _f32_scalar(p, value):
    return torch.full((), value, dtype=torch.float32, device=p.device)


class Adamax(Optimizer):
    def __init__(self, params, lr=1e-3, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 weight_decay=None, grad_clip=None):
        super().__init__(params, lr, weight_decay, grad_clip)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _init_state(self, p, st):
        st["moment"] = _f32_zeros(p)
        st["inf_norm"] = _f32_zeros(p)
        st["beta1_pow"] = _f32_scalar(p, 1.0)

    def _update(self, p, g, st, group, name):
        gf = g.float()
        m = self.beta1 * st["moment"] + (1 - self.beta1) * gf
        u = torch.maximum(self.beta2 * st["inf_norm"],
                          gf.abs() + self.epsilon)
        b1p = st["beta1_pow"] * self.beta1
        new = p.float() - (group["lr"] / (1 - b1p)) * m / u
        self._put(st["moment"], m)
        self._put(st["inf_norm"], u)
        self._put(st["beta1_pow"], b1p)
        self._put(p, new)


class RMSProp(Optimizer):
    def __init__(self, params, lr, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, weight_decay=None, grad_clip=None):
        super().__init__(params, lr, weight_decay, grad_clip)
        self.rho, self.epsilon = rho, epsilon
        self.momentum, self.centered = momentum, bool(centered)

    def _init_state(self, p, st):
        st["mean_square"] = _f32_zeros(p)
        st["momentum"] = _f32_zeros(p)
        if self.centered:
            st["mean_grad"] = _f32_zeros(p)

    def _update(self, p, g, st, group, name):
        gf = g.float()
        rho = self.rho
        ms = rho * st["mean_square"] + (1 - rho) * gf * gf
        if self.centered:
            mg = rho * st["mean_grad"] + (1 - rho) * gf
            denom = torch.sqrt(ms - mg * mg + self.epsilon)
            self._put(st["mean_grad"], mg)
        else:
            denom = torch.sqrt(ms + self.epsilon)
        mom = self.momentum * st["momentum"] + group["lr"] * gf / denom
        self._put(st["mean_square"], ms)
        self._put(st["momentum"], mom)
        self._put(p, p.float() - mom)


class Adadelta(Optimizer):
    def __init__(self, params, lr=1e-3, epsilon=1e-6, rho=0.95,
                 weight_decay=None, grad_clip=None):
        super().__init__(params, lr, weight_decay, grad_clip)
        self.epsilon, self.rho = epsilon, rho

    def _init_state(self, p, st):
        st["avg_squared_grad"] = _f32_zeros(p)
        st["avg_squared_update"] = _f32_zeros(p)

    def _update(self, p, g, st, group, name):
        gf = g.float()
        rho, eps = self.rho, self.epsilon
        asg = rho * st["avg_squared_grad"] + (1 - rho) * gf * gf
        update = (torch.sqrt(st["avg_squared_update"] + eps)
                  / torch.sqrt(asg + eps) * gf)
        asu = rho * st["avg_squared_update"] + (1 - rho) * update * update
        self._put(st["avg_squared_grad"], asg)
        self._put(st["avg_squared_update"], asu)
        self._put(p, p.float() - group["lr"] * update)


class Lamb(Optimizer):
    def __init__(self, params, lr=1e-3, lamb_weight_decay=0.01, beta1=0.9,
                 beta2=0.999, epsilon=1e-6, grad_clip=None,
                 exclude_from_weight_decay_fn=None):
        super().__init__(params, lr, None, grad_clip)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lamb_weight_decay = lamb_weight_decay
        self.exclude_from_weight_decay_fn = exclude_from_weight_decay_fn

    def _init_state(self, p, st):
        st["moment1"] = _f32_zeros(p)
        st["moment2"] = _f32_zeros(p)
        st["beta1_pow"] = _f32_scalar(p, 1.0)
        st["beta2_pow"] = _f32_scalar(p, 1.0)

    def _update(self, p, g, st, group, name):
        b1, b2 = self.beta1, self.beta2
        gf, pf = g.float(), p.float()
        m1 = b1 * st["moment1"] + (1 - b1) * gf
        m2 = b2 * st["moment2"] + (1 - b2) * gf * gf
        b1p = st["beta1_pow"] * b1
        b2p = st["beta2_pow"] * b2
        r = (m1 / (1 - b1p)) / (torch.sqrt(m2 / (1 - b2p)) + self.epsilon)
        wd = self.lamb_weight_decay
        fn = self.exclude_from_weight_decay_fn
        if fn is not None and fn(name):
            wd = 0.0
        update = r + wd * pf
        w_norm = torch.linalg.vector_norm(pf)
        u_norm = torch.linalg.vector_norm(update)
        ratio = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                            torch.ones_like(w_norm))
        self._put(st["moment1"], m1)
        self._put(st["moment2"], m2)
        self._put(st["beta1_pow"], b1p)
        self._put(st["beta2_pow"], b2p)
        self._put(p, pf - group["lr"] * ratio * update)


class NAdam(Optimizer):
    def __init__(self, params, lr=0.002, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 momentum_decay=0.004, weight_decay=None, grad_clip=None):
        super().__init__(params, lr, weight_decay, grad_clip)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.momentum_decay = momentum_decay

    def _init_state(self, p, st):
        st["moment1"] = _f32_zeros(p)
        st["moment2"] = _f32_zeros(p)
        st["mu_prod"] = _f32_scalar(p, 1.0)
        st["step"] = _f32_scalar(p, 0.0)

    def _update(self, p, g, st, group, name):
        b1, b2, psi = self.beta1, self.beta2, self.momentum_decay
        gf = g.float()
        t = st["step"] + 1
        mu_t = b1 * (1 - 0.5 * 0.96 ** (t * psi))
        mu_t1 = b1 * (1 - 0.5 * 0.96 ** ((t + 1) * psi))
        mu_prod = st["mu_prod"] * mu_t
        m1 = b1 * st["moment1"] + (1 - b1) * gf
        m2 = b2 * st["moment2"] + (1 - b2) * gf * gf
        m1h = (mu_t1 * m1 / (1 - mu_prod * mu_t1)
               + (1 - mu_t) * gf / (1 - mu_prod))
        m2h = m2 / (1 - b2 ** t)
        new = p.float() - group["lr"] * m1h / (torch.sqrt(m2h)
                                               + self.epsilon)
        self._put(st["moment1"], m1)
        self._put(st["moment2"], m2)
        self._put(st["mu_prod"], mu_prod)
        self._put(st["step"], t)
        self._put(p, new)


class RAdam(Optimizer):
    def __init__(self, params, lr=1e-3, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 weight_decay=None, grad_clip=None):
        super().__init__(params, lr, weight_decay, grad_clip)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _init_state(self, p, st):
        st["moment1"] = _f32_zeros(p)
        st["moment2"] = _f32_zeros(p)
        st["step"] = _f32_scalar(p, 0.0)

    def _update(self, p, g, st, group, name):
        b1, b2 = self.beta1, self.beta2
        gf = g.float()
        t = st["step"] + 1
        m1 = b1 * st["moment1"] + (1 - b1) * gf
        m2 = b2 * st["moment2"] + (1 - b2) * gf * gf
        m1h = m1 / (1 - b1 ** t)
        rho_inf = 2 / (1 - b2) - 1
        rho_t = rho_inf - 2 * t * b2 ** t / (1 - b2 ** t)
        m2h = torch.sqrt(m2 / (1 - b2 ** t))
        r = torch.sqrt(((rho_t - 4) * (rho_t - 2) * rho_inf)
                       / ((rho_inf - 4) * (rho_inf - 2) * rho_t))
        update = torch.where(rho_t > 5.0, r * m1h / (m2h + self.epsilon),
                             m1h)
        self._put(st["moment1"], m1)
        self._put(st["moment2"], m2)
        self._put(st["step"], t)
        self._put(p, p.float() - group["lr"] * update)


class Rprop(Optimizer):
    def __init__(self, params, lr=1e-3, learning_rate_range=(1e-5, 50),
                 etas=(0.5, 1.2), grad_clip=None):
        super().__init__(params, lr, None, grad_clip)
        self.lr_min, self.lr_max = learning_rate_range
        self.eta_neg, self.eta_pos = etas

    def _init_state(self, p, st):
        st["prev_grad"] = _f32_zeros(p)
        st["lr"] = torch.full(p.shape, float(self.get_lr()),
                              dtype=torch.float32, device=p.device)

    def _update(self, p, g, st, group, name):
        gf = g.float()
        sign = torch.sign(gf * st["prev_grad"])
        factor = torch.where(sign > 0, self.eta_pos,
                             torch.where(sign < 0, self.eta_neg, 1.0))
        new_lr = torch.clamp(st["lr"] * factor, self.lr_min, self.lr_max)
        self._put(st["prev_grad"], gf)
        self._put(st["lr"], new_lr)
        self._put(p, p.float() - new_lr * torch.sign(gf))


class LBFGS(Optimizer):
    """Limited-memory BFGS with the closure API (the reference's simplified
    two-loop recursion, one direction a ``step``)."""

    def __init__(self, params, lr=1.0, max_iter=20, history_size=100,
                 weight_decay=None, grad_clip=None):
        super().__init__(params, lr, weight_decay, grad_clip)
        self.max_iter = max_iter
        self.history_size = history_size
        self._s, self._y = [], []
        self._prev_grad = self._prev_param = None

    @staticmethod
    def _flat(tensors):
        return torch.cat([t.reshape(-1).float() for t in tensors])

    @torch.no_grad()
    def step(self, closure=None):
        if closure is None:
            raise ValueError("LBFGS.step requires a closure returning the "
                             "loss")
        with torch.enable_grad():
            loss = closure()
        params = [p for p, _ in self.params_with_grads()]
        flat_g = self._flat([p.grad for p in params])
        flat_p = self._flat(params)
        if self._prev_grad is not None:
            s = flat_p - self._prev_param
            y = flat_g - self._prev_grad
            if float(torch.dot(s, y)) > 1e-10:
                self._s.append(s)
                self._y.append(y)
                if len(self._s) > self.history_size:
                    self._s.pop(0)
                    self._y.pop(0)
        q = flat_g
        alphas = []
        for s, y in zip(reversed(self._s), reversed(self._y)):
            rho = 1.0 / torch.dot(y, s)
            alpha = rho * torch.dot(s, q)
            q = q - alpha * y
            alphas.append((alpha, rho))
        if self._y:
            y_last, s_last = self._y[-1], self._s[-1]
            q = q * (torch.dot(s_last, y_last) / torch.dot(y_last, y_last))
        for (alpha, rho), s, y in zip(reversed(alphas), self._s, self._y):
            beta = rho * torch.dot(y, q)
            q = q + (alpha - beta) * s
        direction = -q
        lr = self.get_lr()
        self._prev_grad, self._prev_param = flat_g, flat_p
        offset = 0
        for p in params:
            n = p.numel()
            upd = direction[offset:offset + n].reshape(p.shape)
            self._put(p, p.float() + lr * upd)
            offset += n
        return loss
