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

``int8:`` entries parse as in the reference: an ``int8:<name>`` entry
saves the anchor's blockwise int8 codes and f32 scales
(``memory.int8_checkpoint``, anchors ``int8:<name>`` and
``int8:<name>:scale``) in place of the tensor. ``quant:<site>`` entries
name GEMM sites of the quantized compute path (``quant.gemm``), not
anchors: :func:`split_quant_entries` takes them out first.
"""
from __future__ import annotations

import torch

__all__ = ["KERNEL_ANCHORS", "GEMM_SITES", "SITE_ALIASES", "anchor",
           "anchor_op", "parse_save_names", "split_quant_entries"]

#: anchors tagged inside custom kernels' vjps (flash / rms / add_rms): their
#: save points are not routeable through ``int8_checkpoint``, so an
#: ``int8:`` request for one is refused
KERNEL_ANCHORS = frozenset({"attn_res", "attn_lse", "rms_rstd", "addrms_y"})

#: the seven quantizable GEMM sites of one decoder block, in
#: ``_block_pure`` order (the amax buffer's site axis), and the ``quant:``
#: aliases that expand to them (``paddle_tpu/quant/gemm.py:51-58``)
GEMM_SITES = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")
SITE_ALIASES = {
    "attn": ("wq", "wk", "wv", "wo"),
    "ffn": ("wg", "wu", "wd"),
    "all": GEMM_SITES,
}


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
    """Split the ``quant:<site>`` entries out of a ``names:`` payload ->
    (the rest, as a comma-separated string; the sites), as
    ``paddle_tpu/quant/gemm.py:250-278``. A site is one of the block's
    GEMMs (``wq wk wv wo wg wu wd``) or an alias (``attn``, ``ffn``,
    ``all``) that expands to its sites; anything else raises a
    ``ValueError`` naming the vocabulary."""
    rest, sites = [], set()
    for raw in str(spec).split(","):
        nm = raw.strip()
        if not nm:
            continue
        if nm.startswith("quant:"):
            site = nm[len("quant:"):].strip()
            if not site:
                raise ValueError(f"empty quant: entry in remat names {spec!r}")
            if site in SITE_ALIASES:
                sites.update(SITE_ALIASES[site])
            elif site in GEMM_SITES:
                sites.add(site)
            else:
                raise ValueError(
                    f"quant:{site}: unknown GEMM site; expected one of "
                    f"{GEMM_SITES} or aliases {tuple(SITE_ALIASES)}")
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
