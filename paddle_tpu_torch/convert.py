"""Carry weights between the JAX package and the port.

Serving models (``GPTForCausalLM``, ``LlamaForCausalLM``): the JAX
package's ``Linear.weight`` is ``[in, out]`` (it computes ``x @ w``);
``torch.nn.Linear.weight`` is ``[out, in]``. The port keeps PyTorch's
layout, so this module owns the one transpose, both ways. Names are the
same on both sides (``model.layers.{i}.attn.q_proj.weight`` ...).

The training model (``GPTForCausalLMPipe``) keeps the JAX package's
stacked ``[L, in, out]`` layout and its names (``embed_tokens.weight``,
``decoder.{ln1,wq,wk,wv,wo,ln2,wg,wu,wd}``, ``final_norm.weight``), so
its state dict carries over without a transpose.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.gpt import BLOCK_PARAMS

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
