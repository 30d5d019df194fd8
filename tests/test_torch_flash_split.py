"""The split flash backward (dq pass, dk/dv pass) against the JAX package's,
on the CPU.

The port's split wrappers run their plain PyTorch versions here (CPU
tensors); the JAX side runs ``_bwd_impl``'s split route in interpret mode,
forced with ``PTPU_FA_FUSED_BWD=0`` (at these sizes the reference would
take its fused kernel). The same seeded numpy inputs go to both, in f32.
The CUDA kernels are held against these plain versions on the card by
tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.flash_attention import _bwd as jax_bwd
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels.flash_attention import (
    bwd_route, flash_attention_bwd, flash_attention_bwd_dkv,
    flash_attention_bwd_dq, flash_attention_fwd)
from test_torch_threads import one_intra_op_thread  # noqa: F401

#: f32 on both sides; the sums over keys (dq) and over query rows and the
#: rep q heads (dk, dv) run in other orders: tile by tile in the Pallas
#: kernels, one materialised product per head here
ATOL = 1e-4

#: (b, hq, hkv, sq, sk, d, bwd block): MHA, GQA and MQA, sq == sk and
#: sq < sk (end-aligned causal); the last two span several 256-row tiles
#: (PTPU_FA_BWD_BLOCK=256), so the causal clamps of both passes engage
SHAPES = [(1, 2, 2, 128, 128, 64, None), (1, 4, 2, 128, 128, 64, None),
          (1, 4, 1, 64, 192, 32, None), (2, 4, 2, 64, 128, 32, None),
          (1, 2, 1, 1024, 1024, 64, 256), (1, 2, 2, 512, 1024, 64, 256),
          # the kernels' other head widths (80, 96 and 40 padded on the
          # card; 256 on the 192/256-column dk/dv kernel)
          (1, 2, 2, 64, 128, 80, None), (1, 4, 2, 128, 128, 96, None),
          (1, 8, 1, 128, 128, 256, None), (1, 2, 1, 64, 64, 40, None)]
IDS = ["mha", "gqa", "mqa-sq<sk", "gqa-sq<sk", "mqa-4x4-tiles",
       "mha-sq<sk-1x4-tiles", "mha-sq<sk-d80", "gqa-d96", "mqa8-d256",
       "mqa-d40"]


def _inputs(b, hq, hkv, sq, sk, d, seed=0):
    """Kernel-layout f32 arrays: q/do [b*hq, sq, d], k/v [b*hkv, sk, d]."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b * hq, sq, d), np.float32)
    k = rng.standard_normal((b * hkv, sk, d), np.float32)
    v = rng.standard_normal((b * hkv, sk, d), np.float32)
    do = rng.standard_normal((b * hq, sq, d), np.float32)
    return q, k, v, do


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_split_plain_versions_match_the_pallas_split_kernels(monkeypatch,
                                                             shape, causal):
    b, hq, hkv, sq, sk, d, block = shape
    monkeypatch.setenv("PTPU_FA_FUSED_BWD", "0")
    if block:
        monkeypatch.setenv("PTPU_FA_BWD_BLOCK", str(block))
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(b, hq, hkv, sq, sk,
                                                        d))
    scale = 1.0 / float(np.sqrt(d))
    o, lse = flash_attention_fwd(q, k, v, causal, scale)
    want = jax_bwd(*(jnp.asarray(t.numpy()) for t in (q, k, v, o, lse, do)),
                   scale, causal, True, hq, hkv)
    delta = (do * o).sum(-1)
    kernels.reset_launch_counts()
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    assert set(kernels.launch_counts().values()) == {0}
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert got.shape == w.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0, err_msg=name)
    # the router's fused plain version computes the same function
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv),
                            flash_attention_bwd(q, k, v, o, lse, do, causal,
                                                scale)):
        np.testing.assert_allclose(got.numpy(), w.numpy(), atol=ATOL,
                                   rtol=0, err_msg=name)


def _reference_route(rep, sq, d):
    """The kernels the reference's ``_bwd`` builds for these shapes,
    traced and never run: one pallas_call is fused, two are split."""
    q = jax.ShapeDtypeStruct((rep, sq, d), jnp.float32)
    kv = jax.ShapeDtypeStruct((1, sq, d), jnp.float32)
    lse = jax.ShapeDtypeStruct((rep, sq), jnp.float32)
    jaxpr = jax.make_jaxpr(
        lambda q_, k_, v_, o_, l_, do_: jax_bwd(
            q_, k_, v_, o_, l_, do_, 1.0 / float(np.sqrt(d)), True, True,
            rep, 1))(
        q, kv, kv, q, lse, q)
    calls = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "pallas_call"]
    return {1: "fused", 2: "split"}[len(calls)]


ROUTE_CASES = [(1, 16384, 128), (1, 16512, 128), (4, 4096, 128),
               (4, 4224, 128), (4, 2048, 96), (1, 2048, 256), (8, 2048, 256),
               (1, 8192, 256)]


@pytest.mark.parametrize(
    "rep,sq,d", ROUTE_CASES,
    ids=[f"{r}-{s}" + ("" if d == 128 else f"-d{d}")
         for r, s, d in ROUTE_CASES])
def test_bwd_route_is_the_reference_rule_at_8_mib(monkeypatch, rep, sq, d):
    """Both sides of the 8 MiB dq scratch: at head_dim 128 MHA at 16384
    (exactly 8 MiB: fused) and 16512 tokens, GQA rep 4 at 4096 and 4224;
    then the other widths' training shapes (Phi-3-mini's GQA 32/8 at 96,
    Gemma's MHA and 8/1 at 256) and 8 MiB exactly at 256."""
    monkeypatch.delenv("PTPU_FA_FUSED_BWD", raising=False)
    want = "fused" if rep * sq * d * 4 <= 8 << 20 else "split"
    assert bwd_route(rep, sq, d) == want
    assert _reference_route(rep, sq, d) == want
