"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; the JAX
side runs the Pallas kernel in interpret mode, as tests/test_decode_attention
.py does. The same numpy inputs go to both. The CUDA kernels are held
against these plain versions on the card by tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.memory import quantize_rows_int8 as jax_quantize_rows
from paddle_tpu.models.gpt import _rms_pure as jax_rms_pure
from paddle_tpu.ops.pallas.add_rms_norm import \
    add_rms_norm as jax_add_rms_norm
from paddle_tpu.ops.pallas.decode_attention import \
    decode_attention as jax_decode_attention
from paddle_tpu.ops.pallas.decode_attention import \
    paged_attention as jax_paged_attention
from paddle_tpu.ops.pallas.decode_attention import \
    paged_attention_int8 as jax_paged_attention_int8
from paddle_tpu.ops.pallas.rms_norm import rms_norm as jax_rms_norm
from paddle_tpu_torch.memory import quantize_rows_int8
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels.add_rms_norm import (add_rms_norm,
                                                       add_rms_norm_fwd)
from paddle_tpu_torch.ops.kernels.decode_attention import (
    decode_attention, paged_attention, paged_attention_int8,
    paged_attention_int8_plain, paged_attention_plain)
from paddle_tpu_torch.ops.kernels.flash_attention import (
    flash_attention_bwd, flash_attention_bwd_dkv, flash_attention_bwd_dq,
    flash_attention_fwd)
from paddle_tpu_torch.ops.kernels.rms_norm import rms_norm, rms_norm_fwd
from paddle_tpu_torch.ops.kernels.swiglu_down import swiglu_down_fwd

#: f32 on both sides; only the summation order differs
ATOL_F32 = 1e-5


def _paged_inputs(b, hq, hkv, d, page, pps, lengths, seed=0):
    rng = np.random.default_rng(seed)
    num_pages = b * pps + 2
    q = rng.standard_normal((b, hq, d), np.float32)
    kp = rng.standard_normal((hkv, num_pages, page, d), np.float32)
    vp = rng.standard_normal((hkv, num_pages, page, d), np.float32)
    perm = rng.permutation(num_pages)
    tables = np.zeros((b, pps), np.int32)
    used = 0
    for i, n in enumerate(lengths):
        own = -(-n // page)
        tables[i, :own] = perm[used:used + own]
        used += own
        # poisoned entries past the length: out of range and foreign pages
        tables[i, own:] = rng.integers(-7, num_pages + 7, pps - own)
    return q, kp, vp, tables, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("lengths", [[1, 1, 1], [1, 19, 40], [48, 48, 48]],
                         ids=["one", "ragged", "full"])
def test_paged_attention_plain_matches_pallas(hq, hkv, lengths):
    b, d, page, pps = 3, 64, 16, 3
    q, kp, vp, tables, lens = _paged_inputs(b, hq, hkv, d, page, pps,
                                            lengths)
    want = np.asarray(jax_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lens), interpret=True))
    got = paged_attention(*(torch.from_numpy(a) for a in
                            (q, kp, vp, tables, lens)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_F32, rtol=0)


@pytest.mark.parametrize("dtype,atol", [("float32", ATOL_F32),
                                        ("bfloat16", 2 ** -6)])
@pytest.mark.parametrize("d", [80, 96, 256])
def test_paged_attention_plain_matches_pallas_wide_heads_rep_16(dtype, atol,
                                                                d):
    """Head widths of Phi-2 (80), Phi-3-mini (96) and Gemma (256) under
    16 q heads per kv head, which the card's kernel takes too. bf16: p is
    rounded against a running max per page in Pallas, the global max
    here."""
    b, hq, hkv, page, pps = 3, 16, 1, 16, 3
    q, kp, vp, tables, lens = _paged_inputs(b, hq, hkv, d, page, pps,
                                            [0, 17, 48], seed=d)
    jt, tt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jax_paged_attention(
        *(jnp.asarray(a, jt) for a in (q, kp, vp)), jnp.asarray(tables),
        jnp.asarray(lens), interpret=True).astype(jnp.float32))
    got = paged_attention(*(torch.from_numpy(a).to(tt) for a in (q, kp, vp)),
                          *(torch.from_numpy(a) for a in (tables, lens)))
    assert got.dtype == tt
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)
    assert np.all(got[0].float().numpy() == 0.0)


def test_paged_attention_gqa_head_order():
    """q head h*rep + r reads kv head h: zero every kv head but one and
    only its rep q heads see non-zero values."""
    b, hq, hkv, d, page, pps = 1, 8, 2, 64, 16, 2
    q, kp, vp, tables, lens = _paged_inputs(b, hq, hkv, d, page, pps, [20])
    vp[0] = 0.0
    got = paged_attention(*(torch.from_numpy(a) for a in
                            (q, kp, vp, tables, lens))).numpy()
    rep = hq // hkv
    assert np.all(got[0, :rep] == 0.0)
    assert np.all(np.abs(got[0, rep:]).sum(-1) > 0)


def test_paged_attention_zero_length_is_zero():
    q, kp, vp, tables, lens = _paged_inputs(2, 4, 4, 64, 16, 2, [0, 5])
    got = paged_attention_plain(*(torch.from_numpy(a) for a in
                                  (q, kp, vp, tables, lens))).numpy()
    assert np.all(got[0] == 0.0) and np.all(np.isfinite(got))


def test_cpu_route_never_counts_launches():
    kernels.reset_launch_counts()
    q, kp, vp, tables, lens = _paged_inputs(1, 4, 4, 64, 16, 1, [3])
    paged_attention(*(torch.from_numpy(a) for a in (q, kp, vp, tables,
                                                    lens)))
    rms_norm(torch.ones(2, 8), torch.ones(8))
    x = torch.randn(2, 16, 64)
    o, lse = flash_attention_fwd(x, x, x, True)
    flash_attention_bwd(x, x, x, o, lse, x, True)
    delta = torch.zeros(2, 16)
    flash_attention_bwd_dq(x, x, x, x, lse, delta, True)
    flash_attention_bwd_dkv(x, x, x, x, lse, delta, True)
    swiglu_down_fwd(torch.ones(4, 128), torch.ones(4, 128),
                    torch.ones(128, 128))
    (kc, ks), (vc, vs) = (quantize_rows_int8(torch.from_numpy(a))
                          for a in (kp, vp))
    paged_attention_int8(torch.from_numpy(q), kc, ks, vc, vs,
                         *(torch.from_numpy(a) for a in (tables, lens)))
    cache = torch.ones(1, 4, 8, 64)
    decode_attention(torch.ones(1, 4, 64), cache, cache,
                     torch.tensor([3], dtype=torch.int32))
    add_rms_norm(torch.ones(2, 8), torch.ones(2, 8), torch.ones(8))
    counts = kernels.launch_counts()
    assert set(counts) == {"paged_attention", "rms_norm",
                           "flash_attention_fwd", "flash_attention_bwd",
                           "swiglu_down", "paged_attention_int8",
                           "decode_attention", "add_rms_norm",
                           "flash_attention_bwd_dq",
                           "flash_attention_bwd_dkv"}
    assert all(n == 0 for n in counts.values()), counts


def test_other_devices_raise():
    x = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or all on cpu"):
        rms_norm_fwd(x, torch.empty(8, device="meta"))
    with pytest.raises(ValueError, match="cuda or all on cpu"):
        rms_norm_fwd(torch.ones(2, 8), torch.empty(8, device="meta"))


@pytest.mark.parametrize("shape", [(8, 64), (2, 5, 96)])
def test_rms_norm_plain_matches_pallas_and_rms_pure(shape):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape, np.float32) * 3
    w = 1 + 0.2 * rng.standard_normal(shape[-1:], np.float32)
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    kernel = np.asarray(jax_rms_norm(jnp.asarray(x), jnp.asarray(w),
                                     interpret=True))
    pure = np.asarray(jax_rms_pure(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(got, kernel, atol=ATOL_F32, rtol=0)
    np.testing.assert_allclose(got, pure, atol=ATOL_F32, rtol=0)
    _, rstd = rms_norm_fwd(torch.from_numpy(x.reshape(-1, shape[-1])),
                           torch.from_numpy(w))
    want = 1 / np.sqrt((x.reshape(-1, shape[-1]) ** 2).mean(-1) + 1e-6)
    np.testing.assert_allclose(rstd.numpy(), want, rtol=1e-5)


def test_rms_norm_bf16_rounds_once_like_the_pallas_kernel():
    """bf16: the weight is applied in f32 and the result rounded once, as
    the Pallas kernel does; within one bf16 rounding of it."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 128), np.float32)
    w = 1 + 0.2 * rng.standard_normal((128,), np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    wb = jnp.asarray(w, jnp.bfloat16)
    kernel = np.asarray(jax_rms_norm(xb, wb, interpret=True)
                        .astype(jnp.float32))
    got = rms_norm(torch.from_numpy(x).bfloat16(),
                   torch.from_numpy(w).bfloat16()).float().numpy()
    np.testing.assert_allclose(got, kernel, rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("x_dtype,w_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"),
    ("bfloat16", "float32"), ("bfloat16", "bfloat16")])
def test_rms_norm_plain_matches_pallas_mixed_types_ragged_width(x_dtype,
                                                                 w_dtype):
    """x and the weight each f32 or bf16, at H = 100 (not a multiple of
    the CUDA kernel's 16-byte vectors: its ragged tail). The output takes
    x's type; f32: the summation order only, bf16: one rounding."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 100), np.float32) * 2
    w = 1 + 0.2 * rng.standard_normal((100,), np.float32)
    jx, jw = (jnp.asarray(a, getattr(jnp, t))
              for a, t in ((x, x_dtype), (w, w_dtype)))
    want = np.asarray(jax_rms_norm(jx, jw, interpret=True)
                      .astype(jnp.float32))
    tx, tw = (torch.from_numpy(a).to(getattr(torch, t))
              for a, t in ((x, x_dtype), (w, w_dtype)))
    o, rstd = rms_norm_fwd(tx, tw)
    assert o.dtype == tx.dtype and rstd.dtype == torch.float32
    if x_dtype == "float32":
        np.testing.assert_allclose(o.numpy(), want, atol=ATOL_F32, rtol=0)
    else:
        np.testing.assert_allclose(o.float().numpy(), want, rtol=2 ** -7,
                                   atol=0)
    xf = tx.float().numpy()
    np.testing.assert_allclose(rstd.numpy(),
                               1 / np.sqrt((xf ** 2).mean(-1) + 1e-6),
                               rtol=1e-5)


def _int8_pages(kp, vp):
    """Both sides quantize with their own ``quantize_rows_int8`` (bitwise
    equal, tests/test_torch_int8_kv.py); the JAX codes feed both."""
    (kc, ks), (vc, vs) = (jax_quantize_rows(jnp.asarray(a)) for a in (kp, vp))
    return [np.array(a) for a in (kc, ks, vc, vs)]


#: f32 q: only the summation order differs. bf16 q: both sides cast q to
#: f32 and compute in f32; the bf16 output rounding (2^-8 relative) bounds
#: the difference
@pytest.mark.parametrize("dtype,atol", [("float32", ATOL_F32),
                                        ("bfloat16", 2 ** -7)])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("lengths", [[1, 1, 1], [1, 19, 40], [48, 48, 48]],
                         ids=["one", "ragged", "full"])
def test_paged_attention_int8_plain_matches_pallas(dtype, atol, hq, hkv,
                                                   lengths):
    """Garbage table entries past each length (out of range and foreign
    pages) are never read on either side."""
    b, d, page, pps = 3, 64, 16, 3
    q, kp, vp, tables, lens = _paged_inputs(b, hq, hkv, d, page, pps,
                                            lengths)
    kc, ks, vc, vs = _int8_pages(kp, vp)
    want = np.asarray(jax_paged_attention_int8(
        jnp.asarray(q, dtype), *(jnp.asarray(a) for a in (kc, ks, vc, vs)),
        jnp.asarray(tables), jnp.asarray(lens), interpret=True)
        .astype(jnp.float32))
    tq = torch.from_numpy(q).to(getattr(torch, dtype))
    got = paged_attention_int8(tq, *(torch.from_numpy(a) for a in
                                     (kc, ks, vc, vs, tables, lens)))
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)


@pytest.mark.parametrize("dtype,atol", [("float32", ATOL_F32),
                                        ("bfloat16", 2 ** -6)])
@pytest.mark.parametrize("d", [80, 96, 256])
def test_paged_attention_int8_plain_matches_pallas_wide_heads_rep_16(dtype,
                                                                     atol,
                                                                     d):
    """Head widths of Phi-2 (80), Phi-3-mini (96) and Gemma (256) under
    16 q heads per kv head over int8 pages, which the card's kernel takes
    too. f32 q: the summation order only. bf16 q: both sides compute in
    f32 and round the output to bf16 once (the tolerance of the exact
    kernel's wide-head test)."""
    b, hq, hkv, page, pps = 3, 16, 1, 16, 3
    q, kp, vp, tables, lens = _paged_inputs(b, hq, hkv, d, page, pps,
                                            [0, 17, 48], seed=d)
    kc, ks, vc, vs = _int8_pages(kp, vp)
    want = np.asarray(jax_paged_attention_int8(
        jnp.asarray(q, dtype), *(jnp.asarray(a) for a in (kc, ks, vc, vs)),
        jnp.asarray(tables), jnp.asarray(lens), interpret=True)
        .astype(jnp.float32))
    tq = torch.from_numpy(q).to(getattr(torch, dtype))
    got = paged_attention_int8(tq, *(torch.from_numpy(a) for a in
                                     (kc, ks, vc, vs, tables, lens)))
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)
    assert np.all(got[0].float().numpy() == 0.0)


def test_paged_attention_int8_equals_dequantize_then_exact():
    """f32: the int8 kernel's function is gather, dequantize, then the
    exact paged attention (p rounding to f32 is the identity)."""
    q, kp, vp, tables, lens = _paged_inputs(2, 8, 2, 64, 16, 3, [5, 40])
    kc, ks, vc, vs = (torch.from_numpy(a) for a in _int8_pages(kp, vp))
    args = [torch.from_numpy(a) for a in (q, tables, lens)]
    got = paged_attention_int8_plain(args[0], kc, ks, vc, vs, *args[1:])
    want = paged_attention_plain(args[0], kc.float() * ks, vc.float() * vs,
                                 *args[1:])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype,atol", [("float32", ATOL_F32),
                                        ("bfloat16", 2 ** -6)])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)], ids=["mha", "gqa"])
def test_decode_attention_plain_matches_pallas(dtype, atol, hq, hkv):
    """Dense cache [B, Hkv, S, D] with lengths from 0 to S. bf16: p is
    rounded to bf16 on both sides, against maxima that differ (a running
    max per block in Pallas, the global max here)."""
    rng = np.random.default_rng(3)
    b, s, d = 4, 64, 64
    q = rng.standard_normal((b, hq, d), np.float32)
    kc = rng.standard_normal((b, hkv, s, d), np.float32)
    vc = rng.standard_normal((b, hkv, s, d), np.float32)
    lens = np.asarray([0, 1, 33, 64], np.int32)
    jt = getattr(jnp, dtype)
    want = np.asarray(jax_decode_attention(
        *(jnp.asarray(a, jt) for a in (q, kc, vc)), jnp.asarray(lens),
        block_k=16, interpret=True).astype(jnp.float32))
    tt = getattr(torch, dtype)
    got = decode_attention(*(torch.from_numpy(a).to(tt) for a in (q, kc, vc)),
                           torch.from_numpy(lens))
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)
    assert np.all(got[0].float().numpy() == 0.0)


@pytest.mark.parametrize("dtype,atol", [("float32", ATOL_F32),
                                        ("bfloat16", 2 ** -6)])
@pytest.mark.parametrize("d", [80, 96, 256])
def test_decode_attention_plain_matches_pallas_wide_heads_rep_16(dtype, atol,
                                                                 d):
    """The dense cache at the head widths of Phi-2, Phi-3-mini and Gemma
    under 16 q heads per kv head, lengths from 0 to S."""
    rng = np.random.default_rng(d)
    b, hq, hkv, s = 3, 16, 1, 48
    q = rng.standard_normal((b, hq, d), np.float32)
    kc = rng.standard_normal((b, hkv, s, d), np.float32)
    vc = rng.standard_normal((b, hkv, s, d), np.float32)
    lens = np.asarray([0, 17, 48], np.int32)
    jt, tt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jax_decode_attention(
        *(jnp.asarray(a, jt) for a in (q, kc, vc)), jnp.asarray(lens),
        block_k=16, interpret=True).astype(jnp.float32))
    got = decode_attention(*(torch.from_numpy(a).to(tt) for a in (q, kc, vc)),
                           torch.from_numpy(lens))
    assert got.dtype == tt
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)
    assert np.all(got[0].float().numpy() == 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_add_rms_norm_plain_matches_pallas(dtype):
    """y is x + r rounded to the model type and the norm reads the rounded
    y; the weight is applied in f32 and rounded once. y is bitwise equal;
    o and rstd agree to the f32 summation order (bf16: one rounding)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((16, 96), np.float32) * 2
    r = rng.standard_normal((16, 96), np.float32)
    w = 1 + 0.2 * rng.standard_normal((96,), np.float32)
    jt, tt = getattr(jnp, dtype), getattr(torch, dtype)
    jy, jo = jax_add_rms_norm(*(jnp.asarray(a, jt) for a in (x, r, w)),
                              interpret=True)
    y, o, rstd = add_rms_norm_fwd(*(torch.from_numpy(a).to(tt)
                                    for a in (x, r, w)))
    np.testing.assert_array_equal(y.float().numpy(),
                                  np.asarray(jy.astype(jnp.float32)))
    tol = ATOL_F32 if dtype == "float32" else 2 ** -7 * 4
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(jo.astype(jnp.float32)),
                               atol=tol, rtol=0)
    yf = y.float().numpy()
    np.testing.assert_allclose(
        rstd.numpy(), 1 / np.sqrt((yf ** 2).mean(-1) + 1e-6), rtol=1e-5)


#: x, residual and weight types: f32 and bf16 in every mix
ADD_RMS_TYPES = [(x, r, w) for x in ("float32", "bfloat16")
                 for r in ("float32", "bfloat16")
                 for w in ("float32", "bfloat16")]


@pytest.mark.parametrize("x_dtype,r_dtype,w_dtype", ADD_RMS_TYPES)
def test_add_rms_norm_plain_matches_pallas_mixed_types_ragged_width(
        x_dtype, r_dtype, w_dtype):
    """x, r and the weight each f32 or bf16, at H = 100 (not a multiple of
    the CUDA kernel's 16-byte vectors: its ragged tail). y and o take x's
    type; y is bitwise equal; o: the summation order only (f32 x), one
    rounding (bf16 x)."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((6, 100), np.float32) * 2
    r = rng.standard_normal((6, 100), np.float32)
    w = 1 + 0.2 * rng.standard_normal((100,), np.float32)
    args = ((x, x_dtype), (r, r_dtype), (w, w_dtype))
    jy, jo = jax_add_rms_norm(*(jnp.asarray(a, getattr(jnp, t))
                                for a, t in args), interpret=True)
    tx, tr, tw = (torch.from_numpy(a).to(getattr(torch, t)) for a, t in args)
    y, o, rstd = add_rms_norm_fwd(tx, tr, tw)
    assert y.dtype == o.dtype == tx.dtype and rstd.dtype == torch.float32
    np.testing.assert_array_equal(y.float().numpy(),
                                  np.asarray(jy.astype(jnp.float32)))
    want = np.asarray(jo.astype(jnp.float32))
    if x_dtype == "float32":
        np.testing.assert_allclose(o.numpy(), want, atol=ATOL_F32, rtol=0)
    else:
        np.testing.assert_allclose(o.float().numpy(), want, rtol=2 ** -7,
                                   atol=0)
    yf = y.float().numpy()
    np.testing.assert_allclose(rstd.numpy(),
                               1 / np.sqrt((yf ** 2).mean(-1) + 1e-6),
                               rtol=1e-5)


def test_add_rms_norm_grads_match_the_pallas_vjp():
    """f32: the closed-form backward against jax.vjp of the Pallas
    add_rms_norm (interpret mode), with cotangents for both y and o; x
    and r get one shared cotangent."""
    rng = np.random.default_rng(6)
    x, r, gy, go = (rng.standard_normal((2, 5, 64), np.float32)
                    for _ in range(4))
    w = 1 + 0.2 * rng.standard_normal((64,), np.float32)
    (jy, jo), vjp = jax.vjp(
        lambda a, b, c: jax_add_rms_norm(a, b, c, interpret=True),
        *(jnp.asarray(a) for a in (x, r, w)))
    jdx, jdr, jdw = vjp((jnp.asarray(gy), jnp.asarray(go)))
    tx, tr, tw = (torch.from_numpy(a).requires_grad_() for a in (x, r, w))
    y, o = add_rms_norm(tx, tr, tw)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                               atol=ATOL_F32, rtol=0)
    torch.autograd.backward((y, o), (torch.from_numpy(gy),
                                     torch.from_numpy(go)))
    for got, want in ((tx.grad, jdx), (tr.grad, jdr), (tw.grad, jdw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(tx.grad.numpy(), tr.grad.numpy())
