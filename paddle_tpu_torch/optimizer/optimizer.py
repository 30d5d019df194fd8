"""The optimizer base, Adam and AdamW, with the JAX package's semantics.

Counterpart of ``paddle_tpu/optimizer/optimizer.py`` and
``paddle_tpu/optimizer/__init__.py:94-294``, as ``torch.optim.Optimizer``
subclasses. What they keep from the JAX package:

- ``lr`` is a float or an :class:`~.lr.LRScheduler`; every update reads
  ``get_lr()`` (the scheduler's value, written into each group's
  ``"lr"``; with a float, the group's ``"lr"``). A float
  ``weight_decay`` becomes :class:`~.regularizer.L2Decay`, a regularizer
  on the gradient;
- ``grad_clip`` is ``ClipGradByGlobalNorm``, ``ClipGradByNorm`` or
  ``ClipGradByValue``. ``step()`` clips, then regularizes, then updates,
  as the reference's eager step does; :class:`jit.TrainStep` runs the
  reference's compiled order itself (regularizer, one sum of squares,
  clip, update);
- the moments live in the parameter's type; f32 moments and an f32 master
  weight only under ``multi_precision``; ``factored=True`` replaces the
  second moment of every parameter of two or more dims by f32 row and
  column statistics (Adafactor's rank-1 fit); ``moment_dtype="int8"``
  stores the moments as blockwise absmax codes (2048 to a block: int8 for
  the first moment, uint8 for the square root of the second) with one f32
  scale a block;
- the arithmetic is f32: ``p_new = (p.f32 - lr * update)`` rounded to the
  parameter's type; the beta powers are f32 scalars;
- AdamW decays ``p`` in f32 and rounds it to the parameter's type before
  the Adam update (:280-294), on the parameters ``apply_decay_param_fun``
  accepts. It decides by the parameter's name in ``step()`` and in
  ``TrainStep`` alike: the reference's eager semantics. (The reference's
  compiled ``TrainStep`` never tells the optimizer the name, and decays
  every parameter; ROADMAP §C.)

Unlike the JAX package, whose arrays are immutable, the update happens in
place on the parameters and the state, under ``torch.no_grad``. Every
write goes through :meth:`Optimizer._put`: a copy, or, while a guarded
``TrainStep`` sets ``_keep`` (a device bool scalar), a select between
the new and the old bytes, so a discarded step changes nothing and the
host never waits on the device.

Parameter names: pass ``model.named_parameters()`` and torch keeps the
names in each group's ``"param_names"``; plain parameters are named
``param_<i>`` by their order. ``state_dict()`` has the reference's flat
layout: ``<name>_<slot>`` for every slot, ``"LR_Scheduler"`` and
``"@step"``; ``set_state_dict`` (and ``load_state_dict``, the same
method under torch's name) copies that layout into the live state, in
place, on the live tensors' device.

``step()`` observes its wall time into ``optimizer_step_seconds``
{optimizer}, as the reference's eager step does (the host's time: the
update is queued on the card, not waited for).

Two keyword sets: every optimizer takes torch's (``params``, ``lr``) and
the reference's (``parameters=``, ``learning_rate=``,
``paddle_tpu/optimizer/optimizer.py:27-33``). Paddle ``Parameter``s (of
the surface's ``nn.Layer``) are accepted anywhere parameters are: each
travels as its ``torch.nn.Parameter`` under its Paddle name, which
``apply_decay_param_fun`` then sees. ``clear_grad(set_to_zero=False)`` and
``minimize(loss)`` are the reference's (:133, :147); under a static
``program_guard``, ``minimize`` registers the loss on the program
(:133-140), and ``static.Executor.run`` trains it through ``step()``.

A Paddle ``Parameter``'s ``ParamAttr`` counts in every update, as in the
reference's eager step (:119-131): its lr is the group's times
``optimize_attr["learning_rate"]``, and its ``regularizer``, when set,
takes the place of the optimizer's (:126-131). ``step()`` and
``TrainStep`` read both per parameter (:meth:`Optimizer.lr_scale_of`,
:meth:`Optimizer.regularizer_of`).
"""
from __future__ import annotations

import functools

import torch

from .. import telemetry as _telemetry
from ..core.tensor import Tensor
from ..nn.clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .lr import LRScheduler
from .regularizer import L2Decay

_OPT_STEP_SECONDS = _telemetry.histogram(
    "optimizer_step_seconds", "eager Optimizer.step wall time",
    labelnames=("optimizer",))

_CLIPS = (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue)


def _torch_params(params, found):
    """Paddle ``Parameter``s (bare or in param-group dicts) as
    ``(name, torch.nn.Parameter)`` pairs; anything else as given. Each
    Paddle ``Parameter`` goes into ``found`` by its torch tensor's id."""
    def conv(seq):
        out = []
        for p in seq:
            if isinstance(p, Tensor):
                found[id(p._data)] = p
                p = (p.name, p._data)
            out.append(p)
        return out

    params = list(params)
    if params and isinstance(params[0], dict):
        return [dict(g, params=conv(g["params"])) for g in params]
    return conv(params)


def _paddle_keywords(init):
    """``__init__`` taking the reference's ``parameters=`` and
    ``learning_rate=`` beside torch's ``params`` and ``lr``."""
    @functools.wraps(init)
    def __init__(self, *args, parameters=None, learning_rate=None,
                 name=None, **kwargs):
        if parameters is not None:
            args = (parameters,) + args
        found = {}
        if args:
            args = (_torch_params(args[0], found),) + args[1:]
        if learning_rate is not None:
            kwargs["lr"] = learning_rate
        init(self, *args, **kwargs)
        if found:      # a subclass's __init__ wraps its base's: keep these
            self._paddle_params = found

    return __init__


class Optimizer(torch.optim.Optimizer):
    """The base: lr and its scheduler, regularizer, clip, the in-place
    (or kept) writes, ``state_dict`` and ``slot_nbytes``. A subclass
    defines ``_init_state(p, st)`` and ``_update(p, g, st, group, name)``.
    """

    #: id of a torch parameter -> the Paddle ``Parameter`` it came from
    _paddle_params: dict = {}

    def __init__(self, params, lr=1e-3, weight_decay=None, grad_clip=None,
                 **defaults):
        sched = lr if isinstance(lr, LRScheduler) else None
        super().__init__(params, dict(
            defaults, lr=sched() if sched is not None else float(lr)))
        if grad_clip is not None and not isinstance(grad_clip, _CLIPS):
            raise TypeError(f"grad_clip {grad_clip!r} is none of "
                            "ClipGradByGlobalNorm, ClipGradByNorm, "
                            "ClipGradByValue")
        self.grad_clip = grad_clip
        self._lr_scheduler = sched
        self.regularization = (L2Decay(weight_decay)
                               if isinstance(weight_decay, float)
                               else weight_decay)
        self._step_count = 0
        self._keep = None

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        if "__init__" in cls.__dict__:
            cls.__init__ = _paddle_keywords(cls.__dict__["__init__"])

    # -- the reference's eager surface ---------------------------------------
    def clear_grad(self, set_to_zero=False):
        self.zero_grad(set_to_none=not set_to_zero)

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward()``, ``step()``, ``clear_grad()``; under
        ``static.program_guard``, registers ``(self, loss)`` on the
        program instead, whose ``Executor.run`` then trains."""
        from ..static import _active_program

        prog = _active_program()
        if prog is not None:
            prog._minimize = (self, loss)
            return None, None
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    # -- lr ------------------------------------------------------------------
    def get_lr(self):
        if self._lr_scheduler is not None:
            return self._lr_scheduler()
        return float(self.param_groups[0]["lr"])

    def set_lr(self, value):
        if self._lr_scheduler is not None:
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        for group in self.param_groups:
            group["lr"] = float(value)

    def set_lr_scheduler(self, scheduler):
        self._lr_scheduler = scheduler

    # -- parameters ----------------------------------------------------------
    def named_params(self):
        """``(name, parameter)`` in group order."""
        i = 0
        for group in self.param_groups:
            names = group.get("param_names")
            for j, p in enumerate(group["params"]):
                yield (names[j] if names else f"param_{i}"), p
                i += 1

    def params_with_grads(self):
        return [(p, p.grad) for group in self.param_groups
                for p in group["params"] if p.grad is not None]

    def lr_scale_of(self, p):
        """``p``'s ``ParamAttr(learning_rate=)``: 1.0 for a parameter that
        came as a torch tensor."""
        pp = self._paddle_params.get(id(p))
        return 1.0 if pp is None else pp.optimize_attr.get("learning_rate",
                                                          1.0)

    def regularizer_of(self, p):
        """The regularizer of ``p``'s gradient: its ``ParamAttr``'s when
        set, else the optimizer's (None: none)."""
        pp = self._paddle_params.get(id(p))
        reg = None if pp is None else pp.regularizer
        return self.regularization if reg is None else reg

    def state_of(self, p):
        """``p``'s slots, made on first use."""
        st = self.state[p]
        if not st:
            self._init_state(p, st)
        return st

    # -- the update ----------------------------------------------------------
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
            self.apply_updates(regularize=True)
        return loss

    @torch.no_grad()
    def apply_updates(self, regularize=False):
        """The update of every parameter with a gradient, in place, at
        ``get_lr()`` times its :meth:`lr_scale_of`; with ``regularize``,
        on its gradient regularized by :meth:`regularizer_of`."""
        if self._lr_scheduler is not None:
            lr = self._lr_scheduler()
            for group in self.param_groups:
                group["lr"] = lr
        names = dict((id(p), n) for n, p in self.named_params())
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                reg = self.regularizer_of(p) if regularize else None
                if reg is not None:
                    g = reg(p, g)
                scale = self.lr_scale_of(p)
                grp = group if scale == 1.0 else dict(
                    group, lr=group["lr"] * scale)
                self._update(p, g.to(p.dtype), self.state_of(p), grp,
                             names[id(p)])
        self._step_count += 1

    def _put(self, dst, new):
        """``dst <- new`` in place; under a guarded step, the select
        ``where(keep, new, dst)`` into ``dst`` (no host sync)."""
        if self._keep is None:
            dst.copy_(new)
        else:
            torch.where(self._keep, new.to(dst.dtype), dst, out=dst)

    def _init_state(self, p, st):
        """Fill ``st`` with ``p``'s initial slots (none here)."""

    def _update(self, p, g, st, group, name):
        raise NotImplementedError

    # -- state ---------------------------------------------------------------
    def state_dict(self):
        """``{"<name>_<slot>": tensor (a copy), "LR_Scheduler": dict,
        "@step": int}``, the reference's flat layout."""
        out = {}
        for name, p in self.named_params():
            for slot, t in self.state.get(p, {}).items():
                out[f"{name}_{slot}"] = t.detach().clone()
        if self._lr_scheduler is not None:
            out["LR_Scheduler"] = self._lr_scheduler.state_dict()
        out["@step"] = self._step_count
        return out

    @torch.no_grad()
    def set_state_dict(self, state_dict):
        """Copy a :meth:`state_dict` into the live state, in place and on
        the live tensors' device; slots it lacks keep their values."""
        if ("LR_Scheduler" in state_dict
                and self._lr_scheduler is not None):
            self._lr_scheduler.set_state_dict(state_dict["LR_Scheduler"])
        self._step_count = int(state_dict.get("@step", 0))
        for name, p in self.named_params():
            st = self.state_of(p)
            for slot, t in st.items():
                v = state_dict.get(f"{name}_{slot}")
                if v is not None:
                    t.copy_(torch.as_tensor(v))

    load_state_dict = set_state_dict

    def slot_nbytes(self, named_params, shard_degree=1, shard_names=None):
        """Bytes of the slots of ``{name: tensor}`` (any tensor with the
        parameter's shape and dtype; the slots are made on the ``meta``
        device, so nothing is allocated). Factored and int8 moments are
        priced exactly. With ``shard_degree`` > 1, parameter-shaped slots
        of the names in ``shard_names`` (None: all) divide by it, rounded
        up; scalars never divide."""
        total = 0
        for name, arr in named_params.items():
            shape = tuple(arr.shape)
            st = {}
            self._init_state(torch.empty(shape, dtype=arr.dtype,
                                         device="meta"), st)
            divide = (int(shard_degree) > 1
                      and (shard_names is None or name in shard_names))
            for leaf in st.values():
                nbytes = leaf.numel() * leaf.element_size()
                if divide and tuple(leaf.shape) == shape:
                    nbytes = -(-nbytes // int(shard_degree))
                total += nbytes
        return total


Optimizer.__init__ = _paddle_keywords(Optimizer.__init__)


# ------------------------------------------------------------ int8 moments
_Q8_BLOCK = 2048


def _blocks(x, block):
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, block)


def _q8_signed(x, block=_Q8_BLOCK):
    """Blockwise absmax int8 over the flattened tensor -> (codes [nb, B],
    scales [nb]), as ``paddle_tpu.optimizer._q8_signed``."""
    xb = _blocks(x, block)
    s = torch.clamp_min(xb.abs().amax(1, keepdim=True), 1e-20) / 127.0
    q = torch.clamp(torch.round(xb / s), -127, 127).to(torch.int8)
    return q, s[:, 0]


def _q8_unsigned(x, block=_Q8_BLOCK):
    """uint8 codes of a non-negative tensor (the square root of the second
    moment), as ``paddle_tpu.optimizer._q8_unsigned``."""
    xb = _blocks(x, block)
    s = torch.clamp_min(xb.amax(1, keepdim=True), 1e-20) / 255.0
    q = torch.clamp(torch.round(xb / s), 0, 255).to(torch.uint8)
    return q, s[:, 0]


def _dq8(q, s, shape):
    flat = (q.float() * s[:, None]).reshape(-1)
    return flat[:_numel(shape)].reshape(shape)


def _numel(shape):
    n = 1
    for d in shape:
        n *= int(d)
    return n


class Adam(Optimizer):
    """Adam (``paddle_tpu.optimizer.Adam``), with ``amsgrad``,
    ``factored`` and ``moment_dtype="int8"``."""

    def __init__(self, params, lr=1e-3, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 amsgrad=False, moment_dtype=None, factored=False):
        if factored and (amsgrad or moment_dtype):
            raise ValueError("factored=True does not compose with "
                             "amsgrad/moment_dtype")
        if moment_dtype not in (None, "int8"):
            raise ValueError("moment_dtype must be None or 'int8'")
        if moment_dtype == "int8" and (amsgrad or multi_precision):
            raise ValueError("moment_dtype='int8' does not compose with "
                             "amsgrad/multi_precision")
        super().__init__(params, lr, weight_decay, grad_clip, beta1=beta1,
                         beta2=beta2, epsilon=epsilon)
        self.multi_precision = bool(multi_precision)
        self.factored = bool(factored)
        self.amsgrad = bool(amsgrad)
        self.moment_dtype = moment_dtype

    def _init_state(self, p, st):
        f32, dev = torch.float32, p.device
        if self.moment_dtype == "int8":
            nb = -(-p.numel() // _Q8_BLOCK)
            st["moment1_q"] = torch.zeros((nb, _Q8_BLOCK), dtype=torch.int8,
                                          device=dev)
            st["moment1_s"] = torch.zeros((nb,), dtype=f32, device=dev)
            st["moment2_q"] = torch.zeros((nb, _Q8_BLOCK),
                                          dtype=torch.uint8, device=dev)
            st["moment2_s"] = torch.zeros((nb,), dtype=f32, device=dev)
        else:
            wide = self.multi_precision and p.dtype != f32
            mdt = f32 if wide else p.dtype
            st["moment1"] = torch.zeros_like(p, dtype=mdt)
            if self.factored and p.dim() >= 2:
                st["vr"] = torch.zeros(p.shape[:-1], dtype=f32, device=dev)
                st["vc"] = torch.zeros(p.shape[:-2] + p.shape[-1:],
                                       dtype=f32, device=dev)
            else:
                st["moment2"] = torch.zeros_like(p, dtype=mdt)
                if self.amsgrad:
                    st["moment2_max"] = torch.zeros_like(p, dtype=mdt)
        st["beta1_pow"] = torch.ones((), dtype=f32, device=dev)
        st["beta2_pow"] = torch.ones((), dtype=f32, device=dev)
        if self.multi_precision and p.dtype != f32:
            st["master_weight"] = p.detach().float().clone()

    def _decayed(self, p, master, lr, name):
        """The f32 weight the update starts from (AdamW decays it)."""
        return master if master is not None else p.float()

    def _update(self, p, g, st, group, name):
        lr, b1, b2 = group["lr"], group["beta1"], group["beta2"]
        eps = group["epsilon"]
        master = st.get("master_weight")
        base = self._decayed(p, master, lr, name)
        put = self._put
        gf = g.float()
        b1p = st["beta1_pow"] * b1
        b2p = st["beta2_pow"] * b2
        int8 = "moment1_q" in st
        if int8:
            m1_prev = _dq8(st["moment1_q"], st["moment1_s"], p.shape)
            sq_prev = _dq8(st["moment2_q"], st["moment2_s"], p.shape)
            m2_prev = sq_prev * sq_prev
        else:
            m1_prev = st["moment1"].float()
        m1 = b1 * m1_prev + (1 - b1) * gf
        m1_hat = m1 / (1 - b1p)
        if "vr" in st:
            g2 = gf * gf
            vr = b2 * st["vr"] + (1 - b2) * g2.mean(-1)
            vc = b2 * st["vc"] + (1 - b2) * g2.mean(-2)
            r_mean = vr.mean(-1, keepdim=True)
            v_hat = (vr[..., :, None] * vc[..., None, :]
                     / torch.clamp_min(r_mean[..., None], 1e-30)) / (1 - b2p)
            put(st["vr"], vr)
            put(st["vc"], vc)
        else:
            if not int8:
                m2_prev = st["moment2"].float()
            m2 = b2 * m2_prev + (1 - b2) * gf * gf
            denom = m2
            if int8:
                q2, s2 = _q8_unsigned(torch.sqrt(m2))
                put(st["moment2_q"], q2)
                put(st["moment2_s"], s2)
            else:
                put(st["moment2"], m2)
            if "moment2_max" in st:
                denom = torch.maximum(st["moment2_max"].float(), m2)
                put(st["moment2_max"], denom)
            v_hat = denom / (1 - b2p)
        update = m1_hat / (torch.sqrt(v_hat) + eps)
        if int8:
            q1, s1 = _q8_signed(m1)
            put(st["moment1_q"], q1)
            put(st["moment1_s"], s1)
        else:
            put(st["moment1"], m1)
        put(st["beta1_pow"], b1p)
        put(st["beta2_pow"], b2p)
        new = base - lr * update
        if master is not None:
            put(master, new)
        put(p, new)


class AdamW(Adam):
    """Adam with decoupled weight decay (``paddle_tpu.optimizer.AdamW``):
    ``p <- round(p.f32 * (1 - lr * weight_decay))`` on every parameter
    whose name ``apply_decay_param_fun`` accepts (all without one), then
    the Adam update."""

    def __init__(self, params, lr=1e-3, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 weight_decay=0.01, grad_clip=None, multi_precision=False,
                 amsgrad=False, moment_dtype=None, factored=False,
                 apply_decay_param_fun=None):
        super().__init__(params, lr, beta1, beta2, epsilon, None, grad_clip,
                         multi_precision, amsgrad, moment_dtype, factored)
        self.weight_decay = float(weight_decay)
        self.apply_decay_param_fun = apply_decay_param_fun

    def _decayed(self, p, master, lr, name):
        fun = self.apply_decay_param_fun
        if not self.weight_decay or (fun is not None and not fun(name)):
            return super()._decayed(p, master, lr, name)
        keep = 1.0 - lr * self.weight_decay
        if master is not None:
            return master * keep
        return (p.float() * keep).to(p.dtype).float()
