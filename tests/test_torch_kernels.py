"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; the JAX
side runs the Pallas kernel in interpret mode, as tests/test_decode_attention
.py does. The same numpy inputs go to both. The CUDA and Triton kernels are
held against these plain versions on the card by tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models.gpt import _rms_pure as jax_rms_pure
from paddle_tpu.ops.pallas.decode_attention import \
    paged_attention as jax_paged_attention
from paddle_tpu.ops.pallas.rms_norm import rms_norm as jax_rms_norm
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels.decode_attention import (
    paged_attention, paged_attention_plain)
from paddle_tpu_torch.ops.kernels.flash_attention import (
    flash_attention_bwd, flash_attention_fwd)
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
    swiglu_down_fwd(torch.ones(4, 128), torch.ones(4, 128),
                    torch.ones(128, 128))
    counts = kernels.launch_counts()
    assert set(counts) == {"paged_attention", "rms_norm",
                           "flash_attention_fwd", "flash_attention_bwd",
                           "swiglu_down"}
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
