"""The training slice's kernels against the JAX package's, on the CPU.

The port's wrappers run their plain PyTorch versions here (CPU tensors);
the JAX side runs the Pallas kernels in interpret mode, as
tests/test_pallas_kernels.py and tests/test_scan_layers.py do. The same
seeded numpy inputs go to both, in f32. The CUDA kernels are held against
these plain versions on the card by tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.flash_attention import _bwd as jax_flash_bwd
from paddle_tpu.ops.pallas.flash_attention import _fwd as jax_flash_fwd
from paddle_tpu.ops.pallas.flash_attention import \
    flash_attention as jax_flash
from paddle_tpu.ops.pallas.rms_norm import rms_norm as jax_rms_norm
from paddle_tpu.ops.pallas.swiglu_down import swiglu_down as jax_swiglu_down
from paddle_tpu.ops.pallas.swiglu_down import \
    swiglu_down_supported as jax_swiglu_supported
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels.flash_attention import (
    bwd_route, flash_attention, flash_attention_bwd,
    flash_attention_bwd_fused, flash_attention_fwd, to_bh)
from paddle_tpu_torch.ops.kernels.rms_norm import rms_norm
from paddle_tpu_torch.ops.kernels.swiglu_down import (swiglu_down,
                                                      swiglu_down_supported)
from test_torch_threads import one_intra_op_thread  # noqa: F401

#: f32 on both sides; only the order of the sums differs (online softmax
#: over k tiles in the Pallas kernel against one materialised softmax)
ATOL = 2e-5
#: gradients: the same, over longer sums (seq and head_dim contractions)
GRAD_ATOL = 1e-4

#: (b, hq, hkv, sq, sk, d): MHA and GQA, sq == sk and sq < sk
#: (end-aligned causal), each within one Pallas block; the last two are
#: the CUDA forward's tile edges (sq and sk off a multiple of 128, D 128)
SHAPES = [(2, 4, 4, 64, 64, 64), (1, 8, 2, 128, 128, 64),
          (2, 4, 2, 64, 128, 32), (1, 4, 1, 32, 96, 64),
          (1, 8, 2, 130, 257, 64), (1, 2, 2, 257, 257, 128),
          # the kernels' other head widths: Phi-2's 80, Phi-3-mini's 96
          # (GQA), Gemma's 256 (MQA), and 40 (padded to 48 columns on
          # the card)
          (1, 2, 2, 64, 96, 80), (1, 4, 2, 65, 65, 96), (1, 2, 1, 64, 64, 256),
          (1, 2, 2, 33, 64, 40)]
IDS = ["mha", "gqa4", "gqa2-sq<sk", "mqa-sq<sk", "gqa4-ragged-sq<sk",
       "mha-ragged-d128", "mha-sq<sk-d80", "gqa2-ragged-d96", "mqa-d256",
       "mha-sq<sk-d40"]


def _qkv(b, hq, hkv, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, d), np.float32)
    k = rng.standard_normal((b, sk, hkv, d), np.float32)
    v = rng.standard_normal((b, sk, hkv, d), np.float32)
    do = rng.standard_normal((b, sq, hq, d), np.float32)
    return q, k, v, do


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_flash_fwd_plain_matches_pallas(shape, causal):
    b, hq, hkv, sq, sk, d = shape
    q, k, v, _ = _qkv(*shape)
    scale = 1.0 / np.sqrt(d)
    from paddle_tpu.ops.pallas.flash_attention import to_bh as jax_to_bh

    want_o, want_lse = jax_flash_fwd(
        jax_to_bh(jnp.asarray(q), hq), jax_to_bh(jnp.asarray(k), hkv),
        jax_to_bh(jnp.asarray(v), hkv), scale, causal, True, hq, hkv)
    o, lse = flash_attention_fwd(to_bh(_t(q)), to_bh(_t(k)), to_bh(_t(v)),
                                 causal, scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=ATOL,
                               rtol=1e-6)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_flash_autograd_matches_jax_grad_of_pallas(shape, causal):
    q, k, v, do = _qkv(*shape, seed=1)

    def jax_loss(q_, k_, v_):
        o = jax_flash(q_, k_, v_, causal=causal, interpret=True)
        return jnp.sum(o * jnp.asarray(do))

    want_o = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=causal, interpret=True)
    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    o = flash_attention(tq, tk, tv, causal=causal)
    got = torch.autograd.grad(o, (tq, tk, tv), _t(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want_o),
                               atol=ATOL, rtol=0)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_ATOL,
                                   rtol=0, err_msg=name)


def test_flash_bwd_takes_delta_from_o_and_do():
    """flash_attention_bwd on the kernel layout equals the backward of the
    differentiable op ``flash_fwd_op`` (delta = rowsum(do * o) inside)."""
    q, k, v, do = (to_bh(_t(a)) for a in _qkv(1, 4, 2, 32, 32, 64, seed=2))
    o, lse = flash_attention_fwd(q, k, v, True)
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, True)
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    from paddle_tpu_torch.ops.kernels.flash_attention import flash_fwd_op

    out, _ = flash_fwd_op(tq, tk, tv, True, 1.0 / 8.0)
    got = torch.autograd.grad(out, (tq, tk, tv), do)
    for a, b_ in zip((dq, dk, dv), got):
        torch.testing.assert_close(a, b_, atol=0, rtol=0)


def test_flash_row_that_sees_no_key_is_zero():
    """sq > sk, causal: the first sq - sk rows see no key; o = 0 and
    lse = -1e30 (the l == 0 guards)."""
    q, k, v, _ = (to_bh(_t(a)) for a in _qkv(1, 2, 2, 8, 4, 64, seed=3))
    o, lse = flash_attention_fwd(q, k, v, True)
    assert torch.all(o[:, :4] == 0) and torch.all(lse[:, :4] == -1e30)
    assert torch.all(o[:, 4:].abs().sum(-1) > 0)


#: (hq, hkv, sq, sk, d) at batch 1, kernel layout: the bf16 fused CUDA
#: kernel's tile edges (128-key tiles, 64-row q tiles over the rep q heads,
#: a [64 q x 64] dq product per consumer): 127, 129 and 257 keys, sq < sk,
#: rep 1, 4 and 8, D 64 and 128; then the widths the 192/256-column kernel
#: takes (64-key blocks, dV and dK split between its consumers) and the
#: padded 80, 96 and 40
FUSED_EDGE_SHAPES = [(1, 1, 127, 127, 128), (4, 1, 129, 129, 64),
                     (8, 1, 100, 257, 64), (4, 1, 257, 257, 128),
                     (2, 2, 64, 129, 128), (8, 2, 130, 257, 64),
                     (2, 1, 65, 129, 256), (4, 2, 63, 63, 96),
                     (1, 1, 129, 129, 80), (2, 1, 64, 100, 40)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", FUSED_EDGE_SHAPES,
                         ids=[f"{h}/{k}-q{sq}-k{sk}-d{d}"
                              for h, k, sq, sk, d in FUSED_EDGE_SHAPES])
def test_fused_bwd_plain_matches_pallas_at_kernel_tile_edges(monkeypatch,
                                                             shape, causal):
    """The fused backward's plain version (the CPU route of
    flash_attention_bwd_fused) against the reference's ``_bwd``, which
    takes its fused Pallas kernel ``_bwd_fused`` at these sizes, in
    interpret mode; f32 on both sides."""
    hq, hkv, sq, sk, d = shape
    monkeypatch.delenv("PTPU_FA_FUSED_BWD", raising=False)
    assert bwd_route(hq // hkv, sq, d) == "fused"
    rng = np.random.default_rng(sq + sk + d)
    q, do = (torch.from_numpy(rng.standard_normal((hq, sq, d), np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((hkv, sk, d), np.float32))
            for _ in range(2))
    scale = 1.0 / float(np.sqrt(d))
    o, lse = flash_attention_fwd(q, k, v, causal, scale)
    want = jax_flash_bwd(*(jnp.asarray(t.numpy())
                           for t in (q, k, v, o, lse, do)),
                         scale, causal, True, hq, hkv)
    kernels.reset_launch_counts()
    got = flash_attention_bwd_fused(q, k, v, do, lse, (do * o).sum(-1),
                                    causal, scale)
    assert set(kernels.launch_counts().values()) == {0}
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == w.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=GRAD_ATOL,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("lead,m,h", [
    ((2, 64), 256, 128), ((128,), 384, 256),
    # the CUDA kernel's tile edges: rows off 128, h off 256, config 4's M
    ((200,), 5504, 128), ((8, 25), 256, 384)])
def test_swiglu_down_matches_pallas_with_grads(lead, m, h):
    rng = np.random.default_rng(4)
    g = rng.standard_normal(lead + (m,), np.float32)
    u = rng.standard_normal(lead + (m,), np.float32)
    wd = (0.05 * rng.standard_normal((m, h))).astype(np.float32)
    cot = rng.standard_normal(lead + (h,), np.float32)
    assert swiglu_down_supported(g.shape, wd.shape)
    assert jax_swiglu_supported(g.shape, wd.shape)

    def jax_loss(g_, u_, w_):
        return jnp.sum(jax_swiglu_down(g_, u_, w_, interpret=True)
                       * jnp.asarray(cot))

    want_out = jax_swiglu_down(jnp.asarray(g), jnp.asarray(u),
                               jnp.asarray(wd), interpret=True)
    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(g), jnp.asarray(u), jnp.asarray(wd))
    tg, tu, tw = _t(g, True), _t(u, True), _t(wd, True)
    out = swiglu_down(tg, tu, tw)
    got = torch.autograd.grad(out, (tg, tu, tw), _t(cot))
    # f32, sums over M (forward) and rows (dwd) in another order
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=1e-5, rtol=0)
    for name, a, w in zip(("dgate", "dup", "dwd"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("shape,wd_shape,taken", [
    ((2, 64, 256), (256, 128), True), ((3, 5, 256), (256, 128), False),
    ((2, 64, 200), (200, 128), False), ((2, 64, 256), (256, 96), False),
    ((6144, 5504), (5504, 2048), True), ((200, 5504), (5504, 128), True),
    ((6144 + 37, 5504), (5504, 2048), False)])
def test_swiglu_down_route_matches_the_reference(shape, wd_shape, taken):
    assert swiglu_down_supported(shape, wd_shape) is taken
    assert jax_swiglu_supported(shape, wd_shape) is taken


def test_rms_norm_grad_matches_pallas():
    rng = np.random.default_rng(5)
    x = 2 * rng.standard_normal((4, 8, 96), np.float32)
    w = 1 + 0.2 * rng.standard_normal((96,), np.float32)
    cot = rng.standard_normal((4, 8, 96), np.float32)

    def jax_loss(x_, w_):
        return jnp.sum(jax_rms_norm(x_, w_, interpret=True)
                       * jnp.asarray(cot))

    want = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x, True), _t(w, True)
    got = torch.autograd.grad(rms_norm(tx, tw), (tx, tw), _t(cot))
    # f32: the closed form on both sides, dw summed over 32 rows
    for name, a, b in zip(("dx", "dw"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def test_heads_above_256_take_plain_attention_as_the_reference(monkeypatch):
    """Head width 320: the reference leaves it to XLA's plain attention
    (``_use_pallas``: ``d <= 256``); flash_attention takes the plain
    version by the same rule, never the flash op, with the same values and
    gradients as the reference's ``_xla_sdpa``."""
    from paddle_tpu.nn.functional.flash_attention import _xla_sdpa
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    assert fa.fwd_route(256) == "kernel" and fa.fwd_route(320) == "plain"

    def refuse(*a, **k):
        raise AssertionError("the flash op ran at head width 320")

    monkeypatch.setattr(fa, "flash_fwd_op", refuse)
    q, k, v, do = _qkv(1, 2, 2, 24, 24, 320, seed=4)

    def jax_loss(q_, k_, v_):
        return jnp.sum(_xla_sdpa(q_, k_, v_, causal=True) * jnp.asarray(do))

    want_o = _xla_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=True)
    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    o = fa.flash_attention(tq, tk, tv, causal=True)
    got = torch.autograd.grad(o, (tq, tk, tv), _t(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want_o),
                               atol=ATOL, rtol=0)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_ATOL,
                                   rtol=0, err_msg=name)


def test_cpu_route_of_the_training_kernels_counts_no_launch():
    kernels.reset_launch_counts()
    q, k, v, do = (to_bh(_t(a)) for a in _qkv(1, 2, 2, 16, 16, 64))
    o, lse = flash_attention_fwd(q, k, v, True)
    flash_attention_bwd(q, k, v, o, lse, do, True)
    swiglu_down(torch.ones(8, 128), torch.ones(8, 128), torch.ones(128, 128))
    assert set(kernels.launch_counts().values()) == {0}
