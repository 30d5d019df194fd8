"""Carry weights between the JAX package and the port.

Serving models (``GPTForCausalLM``, ``LlamaForCausalLM``): the JAX
package's ``Linear.weight`` is ``[in, out]`` (it computes ``x @ w``);
``torch.nn.Linear.weight`` is ``[out, in]``. The port keeps PyTorch's
layout, so this module owns the one transpose, both ways. Names are the
same on both sides (``model.layers.{i}.attn.q_proj.weight`` ...).

The training model (``GPTForCausalLMPipe``) keeps the JAX package's
stacked ``[L, in, out]`` layout and its names (``embed_tokens.weight``,
``decoder.{ln1,wq,wk,wv,wo,ln2,wg,wu,wd}``, ``final_norm.weight``), so
its state dict, and its optimizer slots with it
(:func:`training_state_from_jax`), carry over without a transpose.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.gpt import BLOCK_PARAMS, GPTForCausalLMPipe

_LINEAR = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
           "down_proj", "lm_head")


def _is_linear(name: str) -> bool:
    return name.endswith(".weight") and name.split(".")[-2] in _LINEAR


def expected_keys(config) -> list[str]:
    keys = ["model.embed_tokens.weight"]
    for i in range(config.num_layers):
        p = f"model.layers.{i}."
        keys += [p + "input_norm.weight", p + "attn.q_proj.weight",
                 p + "attn.k_proj.weight", p + "attn.v_proj.weight",
                 p + "attn.o_proj.weight", p + "post_attn_norm.weight",
                 p + "mlp.gate_proj.weight", p + "mlp.up_proj.weight",
                 p + "mlp.down_proj.weight"]
    keys.append("model.final_norm.weight")
    if not config.tie_embeddings:
        keys.append("lm_head.weight")
    return keys


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":       # ml_dtypes: torch has no numpy bf16
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def state_dict_from_jax(params: dict, config) -> dict[str, torch.Tensor]:
    """The JAX model's ``state_dict()``, taken as numpy arrays, -> the
    port's state dict (CPU tensors; ``load_state_dict`` moves them)."""
    want = expected_keys(config)
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
    return (["embed_tokens.weight"]
            + [f"decoder.{n}" for n in BLOCK_PARAMS]
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
    ``GPTForCausalLMPipe``, taken as numpy arrays (parameters under their
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
        out[key] = _to_torch(np.asarray(a))
    missing = sorted(want - set(out))
    if missing:
        raise KeyError(f"training_state_from_jax: missing {missing}")
    return out
