"""float16 in the six kernels that took it last: each plain version (the
route a CPU tensor takes) against the JAX package's Pallas kernel in
interpret mode, both in float16 on the same numpy inputs.

Tolerances, from float16's own rounding (2^-11 of a value):
- the norms round once from f32 on both sides, in the same order: at
  most one float16 ulp apart (``rtol=2^-10``, an ulp against the smaller
  of two neighbours); y = x + r is bit for bit;
- ``swiglu_down``: silu(g) * u is rounded to float16 on both sides, the
  product summed in f32 in another order, the output rounded once: 1e-3
  of the largest output (3.1e-4 measured);
- the exact decode kernels: p is rounded to float16 against a running
  maximum per block in Pallas and the global maximum here: 2^-9 absolute
  on N(0, 1) inputs (4.9e-4 measured);
- the int8 kernel keeps p in f32 on both sides: one float16 ulp of an
  output below 2 (2^-10 absolute; 7.6e-6 measured).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.memory import quantize_rows_int8 as jax_quantize_rows
from paddle_tpu.ops.pallas.add_rms_norm import \
    add_rms_norm as jax_add_rms_norm
from paddle_tpu.ops.pallas.decode_attention import \
    decode_attention as jax_decode_attention
from paddle_tpu.ops.pallas.decode_attention import \
    paged_attention as jax_paged_attention
from paddle_tpu.ops.pallas.decode_attention import \
    paged_attention_int8 as jax_paged_attention_int8
from paddle_tpu.ops.pallas.rms_norm import rms_norm as jax_rms_norm
from paddle_tpu.ops.pallas.swiglu_down import swiglu_down as jax_swiglu_down
from paddle_tpu_torch.memory import quantize_rows_int8
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels.add_rms_norm import add_rms_norm_fwd
from paddle_tpu_torch.ops.kernels.decode_attention import (
    decode_attention, paged_attention, paged_attention_int8)
from paddle_tpu_torch.ops.kernels.rms_norm import rms_norm_fwd
from paddle_tpu_torch.ops.kernels.swiglu_down import swiglu_down_fwd
from test_torch_kernels import _paged_inputs
from test_torch_threads import one_intra_op_thread  # noqa: F401

F16_ULP = 2.0 ** -10
DECODE_ATOL = 2.0 ** -9
SWIGLU_RTOL = 1e-3


def _j(a, dtype="float16"):
    return jnp.asarray(a, getattr(jnp, dtype))


def _t(a, dtype="float16"):
    return torch.from_numpy(np.asarray(a)).to(getattr(torch, dtype))


def _np(x):
    return np.asarray(x.astype(jnp.float32)) if isinstance(
        x, jnp.ndarray) else x.float().numpy()


def _norm_inputs(seed, h=100):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((16, h)) * 2).astype(np.float32)
    r = rng.standard_normal((16, h)).astype(np.float32)
    w = (1 + 0.2 * rng.standard_normal(h)).astype(np.float32)
    return x, r, w


#: the weight types of a float16 model and of amp O2's f32 norms, and a
#: bf16 weight, which the CUDA wrapper widens to f32 (exact)
@pytest.mark.parametrize("w_dtype", ["float16", "float32", "bfloat16"])
@pytest.mark.parametrize("h", [100, 256])
def test_rms_norm_f16_matches_pallas(w_dtype, h):
    x, _, w = _norm_inputs(1, h)
    want = jax_rms_norm(_j(x), _j(w, w_dtype), interpret=True)
    o, rstd = rms_norm_fwd(_t(x), _t(w, w_dtype))
    assert o.dtype == torch.float16 and rstd.dtype == torch.float32
    np.testing.assert_allclose(_np(o), _np(want), rtol=F16_ULP, atol=0)


@pytest.mark.parametrize("r_dtype,w_dtype", [
    ("float16", "float16"), ("float16", "float32"), ("float32", "float16"),
    ("float32", "float32"), ("bfloat16", "float16"), ("float16",
                                                      "bfloat16")])
def test_add_rms_norm_f16_matches_pallas(r_dtype, w_dtype):
    x, r, w = _norm_inputs(2)
    jy, jo = jax_add_rms_norm(_j(x), _j(r, r_dtype), _j(w, w_dtype),
                              interpret=True)
    y, o, _ = add_rms_norm_fwd(_t(x), _t(r, r_dtype), _t(w, w_dtype))
    assert y.dtype == o.dtype == torch.float16
    np.testing.assert_array_equal(_np(y), _np(jy))
    np.testing.assert_allclose(_np(o), _np(jo), rtol=F16_ULP, atol=0)


@pytest.mark.parametrize("rows,m,h", [(256, 512, 256), (200, 384, 128)])
def test_swiglu_down_f16_matches_pallas(rows, m, h):
    rng = np.random.default_rng(3)
    g, u = (rng.standard_normal((rows, m)).astype(np.float32)
            for _ in range(2))
    wd = (0.05 * rng.standard_normal((m, h))).astype(np.float32)
    want = _np(jax_swiglu_down(_j(g), _j(u), _j(wd), interpret=True))
    got = swiglu_down_fwd(_t(g), _t(u), _t(wd))
    assert got.dtype == torch.float16
    assert np.abs(_np(got) - want).max() <= SWIGLU_RTOL * np.abs(want).max()


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("d", [64, 128])
def test_decode_attention_f16_matches_pallas(hq, hkv, d):
    rng = np.random.default_rng(4)
    b, s = 4, 64
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    kc, vc = (rng.standard_normal((b, hkv, s, d)).astype(np.float32)
              for _ in range(2))
    lens = np.asarray([0, 1, 33, 64], np.int32)
    want = _np(jax_decode_attention(_j(q), _j(kc), _j(vc), jnp.asarray(lens),
                                    block_k=16, interpret=True))
    got = decode_attention(_t(q), _t(kc), _t(vc), torch.from_numpy(lens))
    assert got.dtype == torch.float16
    np.testing.assert_allclose(_np(got), want, atol=DECODE_ATOL, rtol=0)
    assert np.all(_np(got)[0] == 0.0)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("d", [64, 128])
def test_paged_attention_f16_matches_pallas(hq, hkv, d):
    q, kp, vp, tables, lens = _paged_inputs(3, hq, hkv, d, 16, 3,
                                            [1, 19, 40], seed=d)
    want = _np(jax_paged_attention(_j(q), _j(kp), _j(vp),
                                   jnp.asarray(tables), jnp.asarray(lens),
                                   interpret=True))
    got = paged_attention(_t(q), _t(kp), _t(vp), torch.from_numpy(tables),
                          torch.from_numpy(lens))
    assert got.dtype == torch.float16
    np.testing.assert_allclose(_np(got), want, atol=DECODE_ATOL, rtol=0)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)], ids=["mha", "gqa"])
def test_paged_attention_int8_f16_q_matches_pallas(hq, hkv):
    """float16 q and output over int8 codes and f32 row scales, made by
    each package's quantizer from the same pages (the codes are equal)."""
    q, kp, vp, tables, lens = _paged_inputs(3, hq, hkv, 128, 16, 3,
                                            [1, 19, 40], seed=5)
    (jkc, jks), (jvc, jvs) = (jax_quantize_rows(jnp.asarray(a))
                              for a in (kp, vp))
    (kc, ks), (vc, vs) = (quantize_rows_int8(torch.from_numpy(a))
                          for a in (kp, vp))
    np.testing.assert_array_equal(kc.numpy(), np.asarray(jkc))
    want = _np(jax_paged_attention_int8(
        _j(q), jkc, jks, jvc, jvs, jnp.asarray(tables), jnp.asarray(lens),
        interpret=True))
    got = paged_attention_int8(_t(q), kc, ks, vc, vs,
                               torch.from_numpy(tables),
                               torch.from_numpy(lens))
    assert got.dtype == torch.float16
    np.testing.assert_allclose(_np(got), want, atol=F16_ULP, rtol=0)


def test_f16_plain_routes_count_no_launch():
    """On CPU tensors every float16 call takes the plain version: no
    count moves, under any key."""
    kernels.reset_launch_counts()
    x, r, w = _norm_inputs(6)
    rms_norm_fwd(_t(x), _t(w))
    add_rms_norm_fwd(_t(x), _t(r), _t(w, "bfloat16"))
    assert not any(kernels.launch_counts().values())
