"""Mixture of experts on one device (counterpart of
``paddle_tpu/incubate/distributed/models/moe/__init__.py:28-311``).

Routing is the reference's GShard-style dense dispatch: one-hot dispatch
and combine tensors contracted with einsums, in f32 (the input is cast to
f32 first, :140, :238-240), then the experts' FFNs. Semantics kept:

- top-k over the gate's logits; the combine weights are a softmax over
  the k selected logits, not over all experts (:126);
- a token's slot in its expert's buffer counts every token's first
  choice before any second choice (:128-133); the capacity is
  ``max(1, ceil(capacity_factor * k * N / E))`` (:178-183) and a token
  past it gets combine weight 0 (dropped);
- the load-balance aux loss of the GShard and switch gates reads the
  top-1 index only (:76-84, :106-111);
- ``StackedExperts`` uses ``jax.nn.gelu``'s default, the tanh
  approximation (:280), where the dense MLP uses the exact erf gelu;
- ``SwitchGate`` adds uniform noise in ``[-switch_eps, switch_eps)`` in
  training (:102-104), drawn from its own ``torch.Generator``
  (``generator``), which ``GPTModel``'s recompute replays.

Expert parallelism (``shard_expert_parameters``, ``ep_axis``) is not
ported yet (ROADMAP A.10).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

_EP_ITEM = "expert parallelism is not ported yet (ROADMAP A.10)"


class BaseGate(nn.Module):
    def __init__(self, num_expert, world_size=1):
        super().__init__()
        self.world_size = world_size
        self.num_expert = num_expert
        self.tot_expert = world_size * num_expert
        self.loss = None

    def set_loss(self, loss):
        self.loss = loss

    def get_loss(self, clear=True):
        loss = self.loss
        if clear:
            self.loss = None
        return loss


def balance_loss(logits, top1):
    """``E * sum(mean softmax prob * share of top-1 picks)`` over experts,
    the probabilities in f32 (:76-84)."""
    e = logits.shape[-1]
    probs = torch.softmax(logits.float(), -1).reshape(-1, e)
    picks = F.one_hot(top1.reshape(-1), e).float()
    return (probs.mean(0) * picks.mean(0)).sum() * float(e)


class NaiveGate(BaseGate):
    """Top-k over a linear gate, no aux loss (moe/gate/naive_gate.py)."""

    def __init__(self, d_model, num_expert, world_size=1, topk=2,
                 device=None, dtype=None):
        super().__init__(num_expert, world_size)
        self.gate = nn.Linear(d_model, self.tot_expert, device=device,
                              dtype=dtype)
        self.top_k = topk

    def forward(self, inp, return_all_scores=False):
        gate = self.gate(inp)
        val, idx = torch.topk(gate, k=self.top_k, dim=-1)
        if return_all_scores:
            return val, idx, gate
        return val, idx


class GShardGate(BaseGate):
    """Top-k gate with the load-balance aux loss (moe/gate/gshard_gate.py).
    ``capacity``, ``random_routing`` and ``group`` are accepted and unused,
    as in the reference."""

    def __init__(self, d_model, num_expert, world_size=1, topk=2,
                 capacity=(1.2, 2.4), random_routing=True, group=None,
                 device=None, dtype=None):
        super().__init__(num_expert, world_size)
        self.gate = nn.Linear(d_model, self.tot_expert, device=device,
                              dtype=dtype)
        self.top_k = topk
        self.capacity = capacity

    def forward(self, x):
        logits = self.gate(x)
        val, idx = torch.topk(logits, k=self.top_k, dim=-1)
        self.set_loss(balance_loss(logits, idx[..., 0]))
        return val, idx


class SwitchGate(BaseGate):
    """Top-1 switch gate with the aux loss (moe/gate/switch_gate.py). In
    training the logits get uniform noise in ``[-switch_eps, switch_eps)``
    (f32, as ``paddle.rand``), drawn from ``generator``: a
    ``torch.Generator`` on the gate's device (seeded 0 unless one is
    given)."""

    def __init__(self, d_model, num_expert, world_size=1, topk=1,
                 switch_eps=0.1, capacity=(1.2, 2.4), group=None,
                 generator=None, device=None, dtype=None):
        super().__init__(num_expert, world_size)
        if topk != 1:
            raise ValueError("switch gate is top-1")
        self.gate = nn.Linear(d_model, self.tot_expert, device=device,
                              dtype=dtype)
        self.top_k = 1
        self.switch_eps = switch_eps
        if generator is None:
            generator = torch.Generator(device=self.gate.weight.device)
            generator.manual_seed(0)
        self.generator = generator

    def forward(self, x):
        logits = self.gate(x)
        if self.training:
            noise = torch.rand(logits.shape, generator=self.generator,
                               device=logits.device, dtype=torch.float32)
            logits = logits + (noise * 2.0 - 1.0) * self.switch_eps
        val, idx = torch.topk(logits, k=1, dim=-1)
        self.set_loss(balance_loss(logits, idx[..., 0]))
        return val, idx


GATES = {"naive": NaiveGate, "gshard": GShardGate, "switch": SwitchGate}


def _dense_dispatch_combine(x, idx, val, num_expert, capacity):
    """GShard dense dispatch (:114-144). x [N, M], idx [N, k], val [N, k]
    -> (expert inputs [E, C, M] in x's type, combine [N, E, C] in x's type,
    kept [N, k] bool: the (token, choice) pairs inside the capacity)."""
    n, _ = x.shape
    k = idx.shape[-1]
    probs = torch.softmax(val.float(), -1)
    onehot = F.one_hot(idx, num_expert).float()                 # [N, k, E]
    # slots: every token's choice 0 first, then choice 1, ...
    flat = onehot.transpose(0, 1).reshape(k * n, num_expert)
    pos_flat = flat.cumsum(0) - flat
    pos = pos_flat.reshape(k, n, num_expert).transpose(0, 1)
    pos = (pos * onehot).sum(-1).long()                          # [N, k]
    keep = pos < capacity
    # jax.nn.one_hot of an index past the capacity is all zeros
    pos_oh = (F.one_hot(pos.clamp(max=capacity - 1), capacity).float()
              * keep[..., None].float())                         # [N, k, C]
    disp = torch.einsum("nke,nkc->nkec", onehot, pos_oh)
    dispatch = disp.sum(1)                                       # [N, E, C]
    combine = (disp * probs[..., None, None]).sum(1)
    expert_inputs = torch.einsum("nec,nm->ecm", dispatch, x.float())
    return expert_inputs.to(x.dtype), combine.to(x.dtype), keep


class MoELayer(nn.Module):
    """``MoELayer(d_model, experts, gate, ...)`` (moe_layer.py:261).
    ``experts``: a ``StackedExperts`` or a list of modules, each mapping
    ``[C, M] -> [C, M']``. ``gate``: a gate module or a dict ``{"type":
    "naive" | "gshard" | "switch", "top_k": k}`` (default gshard, top 2),
    built on the experts' device and dtype. After a forward, ``l_aux``
    holds the gate's aux loss (None for the naive gate) and ``dropped``
    the count of (token, choice) pairs past the capacity, as a tensor.
    ``moe_group``, ``mp_group`` and the recompute arguments are accepted
    and unused, as in the reference; ``ep_axis`` raises (A.10)."""

    def __init__(self, d_model, experts, gate=None, moe_group=None,
                 mp_group=None, recompute_interval=0, recompute_ctx=None,
                 capacity_factor=2.0, ep_axis=None):
        super().__init__()
        if ep_axis is not None:
            raise NotImplementedError(_EP_ITEM)
        self.d_model = d_model
        if isinstance(experts, (list, tuple)):
            experts = nn.ModuleList(list(experts))
        self.experts = experts
        self.num_expert = len(experts)
        self.capacity_factor = capacity_factor
        self.ep_axis = None
        if gate is None:
            gate = {"type": "gshard", "top_k": 2}
        if isinstance(gate, dict):
            p0 = next(experts.parameters())
            gate = GATES[gate.get("type", "gshard")](
                d_model, self.num_expert, topk=gate.get("top_k", 2),
                device=p0.device, dtype=p0.dtype)
        self.gate = gate
        self.l_aux = None
        self.dropped = None

    def _capacity(self, n_tokens):
        k = self.gate.top_k
        return max(1, int(math.ceil(self.capacity_factor * k * n_tokens
                                    / self.num_expert)))

    def forward(self, x):
        shape = x.shape
        flat = x.reshape(-1, shape[-1])
        cap = self._capacity(flat.shape[0])
        val, idx = self.gate(flat)
        self.l_aux = self.gate.get_loss(clear=True)
        expert_inputs, combine, keep = _dense_dispatch_combine(
            flat, idx, val, self.num_expert, cap)
        self.dropped = (~keep).sum()
        if isinstance(self.experts, StackedExperts):
            ys = self.experts(expert_inputs)                     # [E, C, M']
        else:
            ys = torch.stack([self.experts[e](expert_inputs[e])
                              for e in range(self.num_expert)])
        out = torch.einsum("nec,ecm->nm", combine.float(),
                           ys.float()).to(ys.dtype)
        return out.reshape(*shape[:-1], ys.shape[-1])


class StackedExperts(nn.Module):
    """Every expert's FFN as stacked parameters in the reference's einsum
    layout: ``w1 [E, M, H]``, ``b1 [E, 1, H]``, ``w2 [E, H, M]``, ``b2
    [E, 1, M]``; weights ~ N(0, 0.02^2), biases 0. ``act`` "gelu" is the
    tanh approximation (``jax.nn.gelu``'s default), anything else relu."""

    def __init__(self, num_expert, d_model, d_hidden, act="gelu",
                 device=None, dtype=None):
        super().__init__()
        self.num_expert = num_expert
        self.act = act

        def param(*shape, std=None):
            t = torch.zeros(shape, device=device, dtype=dtype)
            if std is not None:
                with torch.no_grad():
                    t.normal_(0.0, std)
            return nn.Parameter(t)

        self.w1 = param(num_expert, d_model, d_hidden, std=0.02)
        self.b1 = param(num_expert, 1, d_hidden)
        self.w2 = param(num_expert, d_hidden, d_model, std=0.02)
        self.b2 = param(num_expert, 1, d_model)

    def __len__(self):
        return self.num_expert

    def forward(self, expert_inputs):                # [E, C, M] -> [E, C, M]
        h = torch.bmm(expert_inputs, self.w1) + self.b1
        h = (F.gelu(h, approximate="tanh") if self.act == "gelu"
             else F.relu(h))
        return torch.bmm(h, self.w2) + self.b2

    def apply_ep_placements(self, *args, **kwargs):
        raise NotImplementedError(_EP_ITEM)


def shard_expert_parameters(moe_layer, mesh, axis="dp"):
    raise NotImplementedError(_EP_ITEM)


__all__ = ["BaseGate", "GShardGate", "MoELayer", "NaiveGate",
           "StackedExperts", "SwitchGate", "balance_loss",
           "shard_expert_parameters"]


from . import gate  # noqa: E402,F401
