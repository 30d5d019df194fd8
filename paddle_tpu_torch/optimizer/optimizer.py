"""Adam and AdamW with the JAX package's semantics.

Counterpart of ``paddle_tpu/optimizer/optimizer.py`` and
``paddle_tpu/optimizer/__init__.py:94-294``, as ``torch.optim.Optimizer``
subclasses. What they keep from the JAX package:

- the moments live in the parameter's type; f32 moments and an f32 master
  weight only under ``multi_precision``;
- ``factored=True`` replaces the second moment of every parameter of two
  or more dims by f32 row and column statistics over its last two dims
  (Adafactor's rank-1 fit); 1-D parameters keep the exact second moment;
- the arithmetic is f32: ``p_new = (p.f32 - lr * update)`` rounded to the
  parameter's type; the beta powers are f32 scalars;
- AdamW decays ``p`` in f32 and rounds it to the parameter's type before
  the Adam update (:280-294); its decay applies to every parameter.

Adam's L2 ``weight_decay`` (a regularizer on the gradient) is not ported.

Unlike the JAX package, whose arrays are immutable, the update happens in
place on the parameters and the state, under ``torch.no_grad``.
``step()`` observes its wall time into ``optimizer_step_seconds``
{optimizer}, as the reference's eager step does (the host's time: the
update is queued on the card, not waited for).
"""
from __future__ import annotations

import torch

from .. import telemetry as _telemetry
from ..nn.clip import ClipGradByGlobalNorm

_OPT_STEP_SECONDS = _telemetry.histogram(
    "optimizer_step_seconds", "eager Optimizer.step wall time",
    labelnames=("optimizer",))


class Adam(torch.optim.Optimizer):
    """Adam (``paddle_tpu.optimizer.Adam``). ``step()`` clips with
    ``grad_clip`` and updates; :class:`jit.TrainStep` runs the two parts
    itself so that it computes the global norm once."""

    def __init__(self, params, lr=1e-3, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 grad_clip=None, multi_precision=False, factored=False):
        super().__init__(params, dict(lr=lr, beta1=beta1, beta2=beta2,
                                      epsilon=epsilon))
        if grad_clip is not None and not isinstance(grad_clip,
                                                    ClipGradByGlobalNorm):
            raise NotImplementedError(
                "only ClipGradByGlobalNorm is ported (ROADMAP A.6)")
        self.grad_clip = grad_clip
        self.multi_precision = bool(multi_precision)
        self.factored = bool(factored)

    def params_with_grads(self):
        return [(p, p.grad) for group in self.param_groups
                for p in group["params"] if p.grad is not None]

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        with _telemetry.timer(_OPT_STEP_SECONDS,
                              labels=(type(self).__name__,)):
            if self.grad_clip is not None:
                self.grad_clip([g for _, g in self.params_with_grads()])
            self.apply_updates()
        return loss

    @torch.no_grad()
    def apply_updates(self):
        """The update of every parameter with a gradient, in place."""
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    self._init_state(p, st)
                self._update(p, p.grad.to(p.dtype), st, group)

    def _init_state(self, p, st):
        f32 = torch.float32
        wide = self.multi_precision and p.dtype != f32
        mdt = f32 if wide else p.dtype
        st["moment1"] = torch.zeros_like(p, dtype=mdt)
        if self.factored and p.dim() >= 2:
            st["vr"] = torch.zeros(p.shape[:-1], dtype=f32, device=p.device)
            st["vc"] = torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=f32,
                                   device=p.device)
        else:
            st["moment2"] = torch.zeros_like(p, dtype=mdt)
        st["beta1_pow"] = torch.ones((), dtype=f32, device=p.device)
        st["beta2_pow"] = torch.ones((), dtype=f32, device=p.device)
        if wide:
            st["master_weight"] = p.detach().float().clone()

    def _decay(self, p, st, lr):
        """Weight decay before the update; none in Adam."""

    def _update(self, p, g, st, group):
        lr, b1, b2 = group["lr"], group["beta1"], group["beta2"]
        eps = group["epsilon"]
        self._decay(p, st, lr)
        gf = g.float()
        b1p = st["beta1_pow"] * b1
        b2p = st["beta2_pow"] * b2
        m1 = b1 * st["moment1"].float() + (1 - b1) * gf
        m1_hat = m1 / (1 - b1p)
        if "vr" in st:
            g2 = gf * gf
            vr = b2 * st["vr"] + (1 - b2) * g2.mean(-1)
            vc = b2 * st["vc"] + (1 - b2) * g2.mean(-2)
            r_mean = vr.mean(-1, keepdim=True)
            v_hat = (vr[..., :, None] * vc[..., None, :]
                     / torch.clamp_min(r_mean[..., None], 1e-30)) / (1 - b2p)
            st["vr"], st["vc"] = vr, vc
        else:
            m2 = b2 * st["moment2"].float() + (1 - b2) * gf * gf
            v_hat = m2 / (1 - b2p)
            st["moment2"].copy_(m2)
        update = m1_hat / (torch.sqrt(v_hat) + eps)
        st["moment1"].copy_(m1)
        st["beta1_pow"], st["beta2_pow"] = b1p, b2p
        master = st.get("master_weight")
        if master is not None:
            master.sub_(lr * update)
            p.copy_(master)
        else:
            p.copy_(p.float() - lr * update)


class AdamW(Adam):
    """Adam with decoupled weight decay (``paddle_tpu.optimizer.AdamW``):
    ``p <- round(p.f32 * (1 - lr * weight_decay))`` on every parameter,
    then the Adam update."""

    def __init__(self, params, lr=1e-3, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 weight_decay=0.01, grad_clip=None, multi_precision=False,
                 factored=False):
        super().__init__(params, lr, beta1, beta2, epsilon, grad_clip,
                         multi_precision, factored)
        self.weight_decay = float(weight_decay)

    def _decay(self, p, st, lr):
        if not self.weight_decay:
            return
        master = st.get("master_weight")
        if master is not None:
            master.mul_(1.0 - lr * self.weight_decay)
            p.copy_(master)
        else:
            p.copy_(p.float() * (1.0 - lr * self.weight_decay))
