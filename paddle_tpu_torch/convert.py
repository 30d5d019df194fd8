"""Carry weights between the JAX package and the port.

Per-layer models (``GPTForCausalLM`` in every variant,
``LlamaForCausalLM``, ``GPTForCausalLMMoE``): the JAX
package's ``Linear.weight`` is ``[in, out]`` (it computes ``x @ w``);
``torch.nn.Linear.weight`` is ``[out, in]``. The port keeps PyTorch's
layout, so this module owns the one transpose, both ways. Names are the
same on both sides (``model.layers.{i}.attn.q_proj.weight`` ...).

The training model (``GPTForCausalLMPipe``) keeps the JAX package's
stacked ``[L, in, out]`` layout and its names (``embed_tokens.weight``,
``decoder.{ln1,wq,wk,wv,wo,ln2,wg,wu,wd}``, ``final_norm.weight``, and
``decoder.quant_amax``, the delayed-scaling histories ``[L, 7, 2, H]``,
where the policy requests ``quant:`` sites), so its state dict, and its
optimizer slots with it (:func:`training_state_from_jax`), carry over
without a transpose.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.gpt import BLOCK_PARAMS, GPTForCausalLMPipe
from .quant import requested_quant_sites

_LINEAR = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
           "down_proj", "lm_head", "fc1", "fc2", "gate")


def _is_linear(name: str) -> bool:
    """A ``Linear`` weight: the projections, gelu's ``fc1``/``fc2``, the MoE
    gate's ``gate`` and the untied head. ``StackedExperts``' ``w1``/``w2``
    keep the reference's einsum layout ``[E, in, out]``, as the Pipe keeps
    ``[L, in, out]``."""
    return name.endswith(".weight") and name.split(".")[-2] in _LINEAR


def expected_keys(config, moe=False) -> list[str]:
    """The per-layer tree's state-dict keys, in the port's order, for
    every variant: LayerNorm biases, ``fc1``/``fc2`` with biases under
    gelu, ``embed_pos`` without rope, ``model.quant_amax`` where the policy
    requests ``quant:`` sites; with ``moe`` the layers of
    ``GPTForCausalLMMoE`` (experts, then the gate)."""
    norm = (("weight",) if config.norm_type == "rmsnorm"
            else ("weight", "bias"))
    if moe:
        ffn = ["moe.experts.w1", "moe.experts.b1", "moe.experts.w2",
               "moe.experts.b2", "moe.gate.gate.weight", "moe.gate.gate.bias"]
    elif config.act == "swiglu":
        ffn = ["mlp.gate_proj.weight", "mlp.up_proj.weight",
               "mlp.down_proj.weight"]
    else:
        ffn = ["mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight",
               "mlp.fc2.bias"]
    keys = (["model.quant_amax"] if requested_quant_sites(config) and not moe
            else [])
    keys.append("model.embed_tokens.weight")
    if not config.rope:
        keys.append("model.embed_pos.weight")
    for i in range(config.num_layers):
        p = f"model.layers.{i}."
        keys += [p + "input_norm." + n for n in norm]
        keys += [p + f"attn.{w}_proj.weight" for w in "qkvo"]
        keys += [p + "post_attn_norm." + n for n in norm]
        keys += [p + k for k in ffn]
    keys += ["model.final_norm." + n for n in norm]
    if not config.tie_embeddings:
        keys.append("lm_head.weight")
    return keys


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":       # ml_dtypes: torch has no numpy bf16
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def state_dict_from_jax(params: dict, config,
                        moe=False) -> dict[str, torch.Tensor]:
    """The JAX model's ``state_dict()``, taken as numpy arrays, -> the
    port's state dict (CPU tensors; ``load_state_dict`` moves them).
    ``moe``: the state of a ``GPTForCausalLMMoE``."""
    want = expected_keys(config, moe)
    missing = [k for k in want if k not in params]
    extra = [k for k in params if k not in want]
    if missing or extra:
        raise KeyError(f"state_dict_from_jax: missing {missing}, "
                       f"unexpected {extra}")
    out = {}
    for name in want:
        a = np.asarray(params[name])
        out[name] = _to_torch(a.T.copy() if _is_linear(name) else a)
    return out


def state_dict_to_jax(state: dict) -> dict[str, np.ndarray]:
    """Inverse of :func:`state_dict_from_jax` (float32 numpy arrays)."""
    out = {}
    for name, t in state.items():
        a = t.detach().float().cpu().numpy()
        out[name] = np.ascontiguousarray(a.T if _is_linear(name) else a)
    return out



def pipe_expected_keys(config) -> list[str]:
    amax = (["decoder.quant_amax"] if requested_quant_sites(config)
            else [])
    return (["embed_tokens.weight"]
            + [f"decoder.{n}" for n in BLOCK_PARAMS] + amax
            + ["final_norm.weight"])


def pipe_state_dict_from_jax(params: dict, config) -> dict[str, torch.Tensor]:
    """The JAX ``GPTForCausalLMPipe.state_dict()``, taken as numpy arrays,
    -> the port's ``GPTForCausalLMPipe`` state dict (CPU tensors, same
    names and layouts)."""
    want = pipe_expected_keys(config)
    missing = [k for k in want if k not in params]
    extra = [k for k in params if k not in want]
    if missing or extra:
        raise KeyError(f"pipe_state_dict_from_jax: missing {missing}, "
                       f"unexpected {extra}")
    return {name: _to_torch(np.asarray(params[name])) for name in want}


def pipe_state_dict_to_jax(state: dict) -> dict[str, np.ndarray]:
    """Inverse of :func:`pipe_state_dict_from_jax` (float32 numpy)."""
    return {name: np.ascontiguousarray(t.detach().float().cpu().numpy())
            for name, t in state.items()}


def training_state_from_jax(flat: dict, model) -> dict[str, torch.Tensor]:
    """The JAX package's ``training_state_dict(model, opt)`` of a
    ``GPTForCausalLMPipe``, taken as numpy arrays or CPU tensors (as the
    checkpoint reader gives a JAX directory's; parameters under their
    names, slots as ``opt.<name>.<slot>``), -> the port's training state
    in the same layout (CPU tensors, dtypes kept, bf16 included): what
    ``CheckpointManager.save`` writes and ``restore_training_state``
    copies into the port's model and optimizer. Only the Pipe: a serving
    model's linear weights would need the transpose."""
    if not isinstance(model, GPTForCausalLMPipe):
        raise TypeError("training_state_from_jax carries a "
                        "GPTForCausalLMPipe's state, got "
                        f"{type(model).__name__}")
    want = set(model.state_dict())
    out = {}
    for key, a in flat.items():
        name = key[4:].rsplit(".", 1)[0] if key.startswith("opt.") else key
        if name not in want:
            raise KeyError(f"training_state_from_jax: {key!r} names no "
                           "parameter of the model")
        out[key] = (a.detach().clone() if isinstance(a, torch.Tensor)
                    else _to_torch(np.asarray(a)))
    missing = sorted(want - set(out))
    if missing:
        raise KeyError(f"training_state_from_jax: missing {missing}")
    return out


def load_fused_from_jax(params: dict, layer) -> None:
    """Load a JAX ``incubate.nn`` ``Fused*`` layer's ``state_dict()``,
    taken as numpy arrays by structured name, into the port's layer of the
    same class, in place (each value in the parameter's own place and
    type). Both packages make these layers' parameters by
    ``create_parameter`` under the same names and shapes, the weights
    ``[in, out]`` (``qkv_weight [E, 3E]``, ``linear_weight [E, E]``,
    ``linear1_weight [E, F]``, ``linear2_weight [F, E]``; ``FusedLinear``'s
    ``[out, in]`` under ``transpose_weight`` on both sides), so nothing is
    transposed. A missing, unexpected or differently shaped entry
    raises."""
    want = {k: tuple(t.shape) for k, t in layer.state_dict().items()}
    missing = [k for k in want if k not in params]
    extra = [k for k in params if k not in want]
    if missing or extra:
        raise KeyError(f"load_fused_from_jax: missing {missing}, "
                       f"unexpected {extra}")
    out = {}
    for name, shape in want.items():
        a = np.asarray(params[name])
        if a.shape != shape:
            raise ValueError(f"load_fused_from_jax: {name} is {a.shape}, "
                             f"the layer's {shape}")
        out[name] = _to_torch(a)
    layer.set_state_dict(out)


def layer_state_from_numpy(state: dict, layer) -> None:
    """Load a JAX ``Layer``'s ``state_dict()`` (parameters and persistable
    buffers, such as a batch norm's ``_mean`` and ``_variance``), given as
    numpy arrays by structured name, into the port's ``Layer`` of the same
    class, in place. Paddle's layout is the same on both sides (``Linear.weight`` is
    ``[in, out]``), so nothing is transposed; bf16 arrays cross through
    float32. The names must match exactly, both ways."""
    own = layer.state_dict()
    missing = sorted(set(own) - set(state))
    unexpected = sorted(set(state) - set(own))
    if missing or unexpected:
        raise KeyError(f"state names differ: missing {missing}, "
                       f"unexpected {unexpected}")
    for name, t in own.items():
        t.set_value(_to_torch(np.asarray(state[name])))


def program_params_from_numpy(params, program) -> None:
    """Set a port ``static.Program``'s trainable parameters from the JAX
    ``Program``'s, given as numpy arrays: a list in ``trainable_params()``
    order, or a dict by parameter name. In place (each ``Parameter``'s
    ``torch.nn.Parameter``); shapes must match."""
    own = program.trainable_params()
    if isinstance(params, dict):
        by_name = {p.name: p for p in own}
        missing = sorted(set(by_name) - set(params))
        unexpected = sorted(set(params) - set(by_name))
        if missing or unexpected:
            raise KeyError(f"parameter names differ: missing {missing}, "
                           f"unexpected {unexpected}")
        pairs = [(by_name[n], params[n]) for n in by_name]
    else:
        params = list(params)
        if len(params) != len(own):
            raise ValueError(f"{len(params)} arrays for the program's "
                             f"{len(own)} trainable parameters")
        pairs = list(zip(own, params))
    for p, a in pairs:
        a = np.asarray(a)
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{p.name}: {a.shape} against the program's "
                             f"{tuple(p.shape)}")
        p.set_value(_to_torch(a))
