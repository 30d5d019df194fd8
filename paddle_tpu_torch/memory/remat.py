"""Selective remat: the save-name parser and the anchor op.

Counterpart of ``parse_save_names`` and ``KERNEL_ANCHORS`` in
``paddle_tpu/memory/int8_ckpt.py:142-180`` (copied, so that the port needs
nothing of the JAX package) and of ``jax.ad_checkpoint.checkpoint_name``.

``checkpoint_name`` is an identity that a JAX remat policy can name. Here a
selective ``torch.utils.checkpoint`` policy chooses by dispatcher op, so a
named anchor is the op ``paddle_tpu_torch::remat_anchor``: a copy of its
input whose output the policy keeps, and whose gradient passes through
unchanged. :func:`anchor` inserts it only where the active policy saves the
name; every other anchor costs nothing.

``int8:`` entries parse as in the reference. The int8 save points
themselves (``int8_checkpoint``) are not ported; the model raises on them.
"""
from __future__ import annotations

import torch

__all__ = ["KERNEL_ANCHORS", "anchor", "anchor_op", "parse_save_names",
           "split_quant_entries"]

#: anchors tagged inside custom kernels' vjps (flash / rms / add_rms): their
#: save points are not routeable through ``int8_checkpoint``, so an
#: ``int8:`` request for one is refused
KERNEL_ANCHORS = frozenset({"attn_res", "attn_lse", "rms_rstd", "addrms_y"})


def parse_save_names(spec):
    """Parse a comma-separated remat name list with optional ``int8:``
    prefixes (the payload of a ``names:`` recompute_policy).

    ``"attn_q,int8:resid_mid"`` -> (save_names, int8_names) with
    save_names = ("attn_q", "int8:resid_mid", "int8:resid_mid:scale") and
    int8_names = frozenset({"resid_mid"}).
    """
    save, int8 = [], set()
    for raw in str(spec).split(","):
        nm = raw.strip()
        if not nm:
            continue
        if nm.startswith("int8:"):
            base = nm[len("int8:"):]
            if not base:
                raise ValueError(f"empty int8: entry in remat names {spec!r}")
            if base in KERNEL_ANCHORS:
                raise ValueError(
                    f"int8:{base}: {base!r} is tagged inside a custom "
                    "kernel's vjp and cannot be int8-saved; use the plain "
                    f"name {base!r}")
            int8.add(base)
            save.append(f"int8:{base}")
            save.append(f"int8:{base}:scale")
        else:
            save.append(nm)
    return tuple(save), frozenset(int8)


def split_quant_entries(spec):
    """Split the ``quant:<site>`` entries (GEMM sites of the quantized
    compute path, not remat anchors) out of a ``names:`` payload ->
    (the rest, as a comma-separated string; the sites)."""
    rest, sites = [], set()
    for raw in str(spec).split(","):
        nm = raw.strip()
        if not nm:
            continue
        if nm.startswith("quant:"):
            site = nm[len("quant:"):].strip()
            if not site:
                raise ValueError(f"empty quant: entry in remat names {spec!r}")
            sites.add(site)
        else:
            rest.append(nm)
    return ",".join(rest), frozenset(sites)


@torch.library.custom_op("paddle_tpu_torch::remat_anchor", mutates_args=(),
                         schema="(Tensor x, str name) -> Tensor")
def anchor_op(x, name):
    """A named save point: a copy of ``x``."""
    return x.clone()


@anchor_op.register_fake
def _(x, name):
    return torch.empty_like(x)


anchor_op.register_autograd(lambda ctx, grad: (grad, None))


def anchor(x, name, save):
    """``x`` tagged as the anchor ``name`` when ``name`` is in ``save``
    (the active policy's names), else ``x`` itself."""
    return anchor_op(x, name) if name in save else x
