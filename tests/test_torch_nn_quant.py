"""The port's ``paddle.nn.quant`` against the JAX package on the CPU.

Both packages take the same seeded numpy weights and inputs.

- ``weight_quantize``: the int8 codes equal the reference's bit for bit
  and the scales too (both divide by the scale in f32), for
  ``weight_only_int8``, ``weight_only_int4`` and ``llm.int8`` at
  ``group_size`` -1, 64 and 128; ``weight_dequantize`` equal to 1e-6.
- ``weight_only_linear``: within f32 rounding (1e-5) of the reference, and
  within 0.03 of ``x @ w`` relative to its largest value (the bound of the
  reference's own test, ``tests/test_r5_surface.py:28``); f32 and bf16
  inputs (a bf16 output, as the reference's).
- ``llm_int8_linear`` with an outlier column: the int32 sums of the inlier
  product equal the plain int32 ``matmul`` bit for bit. On the CPU
  ``quant.gemm._int_mm`` takes ``torch._int_mm``'s CPU kernel, which this
  torch has (the test asserts it is dispatched); the output is within f32
  rounding of the reference's.
- ``apply_per_channel_scale`` and ``Stub``; the arguments the reference
  never reads.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.nn import quant as jq
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.nn import quant as tq
from test_torch_threads import one_intra_op_thread  # noqa: F401

TOL = 1e-5
ALGOS = ["weight_only_int8", "weight_only_int4", "llm.int8"]


@pytest.fixture(autouse=True)
def _cpu():
    prev = (getattr(tdevice._state, "device", None),
            getattr(tdevice._state, "place", None))
    tp.set_device("cpu")
    yield
    tdevice._state.device, tdevice._state.place = prev


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np(t):
    return np.asarray(t.numpy())


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("group_size", [-1, 64, 128])
def test_weight_quantize_codes_bit_for_bit(algo, group_size):
    w = _x(256, 48, seed=1) * 0.05
    w[3, 5] = 0.7          # a channel with an outlier
    jqw, js = jq.weight_quantize(jp.to_tensor(w), algo=algo,
                                 group_size=group_size)
    tqw, ts = tq.weight_quantize(tp.to_tensor(w), algo=algo,
                                 group_size=group_size)
    assert tqw.dtype == tp.int8 and tqw.shape == [48, 256]
    want_s = [48] if group_size == -1 else [48, 256 // group_size]
    assert ts.shape == want_s and ts.dtype == tp.float32
    np.testing.assert_array_equal(_np(tqw), _np(jqw))
    np.testing.assert_array_equal(_np(ts).view(np.uint32),
                                  _np(js).view(np.uint32))
    qmax = 7 if algo == "weight_only_int4" else 127
    assert np.abs(_np(tqw)).max() == qmax
    for out_dtype in ("float32", "float16"):
        got = tq.weight_dequantize(tqw, ts, algo=algo, out_dtype=out_dtype,
                                   group_size=group_size)
        want = jq.weight_dequantize(jqw, js, algo=algo, out_dtype=out_dtype,
                                    group_size=group_size)
        assert got.shape == [256, 48] and str(got.dtype).endswith(out_dtype)
        np.testing.assert_allclose(_np(got).astype(np.float32),
                                   _np(want).astype(np.float32), atol=1e-6,
                                   rtol=1e-6)


def test_weight_quantize_of_bf16_and_errors():
    w = _x(128, 16, seed=2)
    wb = tp.to_tensor(w).astype("bfloat16")
    q, s = tq.weight_quantize(wb)
    jqw, js = jq.weight_quantize(jp.to_tensor(w).astype("bfloat16"))
    np.testing.assert_array_equal(_np(q), _np(jqw))
    np.testing.assert_array_equal(_np(s), _np(js))
    with pytest.raises(ValueError, match="group_size"):
        tq.weight_quantize(tp.to_tensor(w), group_size=32)
    with pytest.raises(NotImplementedError):
        tq.weight_quantize(tp.to_tensor(w), algo="w4a8")


@pytest.mark.parametrize("group_size", [-1, 64])
@pytest.mark.parametrize("weight_dtype,algo", [
    ("int8", "weight_only_int8"), ("int4", "weight_only_int4")])
def test_weight_only_linear_like_jax(group_size, weight_dtype, algo):
    w, x, b = _x(128, 32, seed=3), _x(4, 6, 128, seed=4), _x(32, seed=5)
    jqw, js = jq.weight_quantize(jp.to_tensor(w), algo=algo,
                                 group_size=group_size)
    tqw, ts = tq.weight_quantize(tp.to_tensor(w), algo=algo,
                                 group_size=group_size)
    want = jq.weight_only_linear(jp.to_tensor(x), jqw, jp.to_tensor(b), js,
                                 weight_dtype=weight_dtype,
                                 group_size=group_size)
    got = tq.weight_only_linear(tp.to_tensor(x), tqw, tp.to_tensor(b), ts,
                                weight_dtype=weight_dtype, arch=90,
                                group_size=group_size)
    assert got.shape == [4, 6, 32]
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL, rtol=TOL)
    if weight_dtype == "int8":
        ref = x @ w + b
        assert np.abs(_np(got) - ref).max() / np.abs(ref).max() < 0.03
    xb = tp.to_tensor(x).astype("bfloat16")
    yb = tq.weight_only_linear(xb, tqw, weight_scale=ts,
                               group_size=group_size)
    wantb = jq.weight_only_linear(jp.to_tensor(x).astype("bfloat16"), jqw,
                                  weight_scale=js, group_size=group_size)
    assert yb.dtype == tp.bfloat16
    np.testing.assert_array_equal(_np(yb), _np(wantb))


def test_weight_only_linear_holds_weight_dtype_to_paddle():
    """The reference accepts any ``weight_dtype`` and never reads it
    (recorded as a reference fault); the port takes Paddle's two."""
    w, x = _x(64, 16, seed=6), _x(2, 64, seed=7)
    q, s = tq.weight_quantize(tp.to_tensor(w))
    with pytest.raises(ValueError, match="weight_dtype"):
        tq.weight_only_linear(tp.to_tensor(x), q, weight_scale=s,
                              weight_dtype="float8")
    jqw, js = jq.weight_quantize(jp.to_tensor(w))
    jq.weight_only_linear(jp.to_tensor(x), jqw, weight_scale=js,
                          weight_dtype="float8")


@pytest.mark.parametrize("rows", [3, 40])
def test_llm_int8_linear_int32_sums_and_output_like_jax(rows):
    w = _x(96, 40, seed=8) * 0.1
    x = _x(rows, 96, seed=9)
    x[:, 7] *= 40.0                       # an outlier column
    x[:, 50] *= 20.0
    jqw, js = jq.weight_quantize(jp.to_tensor(w), algo="llm.int8")
    tqw, ts = tq.weight_quantize(tp.to_tensor(w), algo="llm.int8")
    b = _x(40, seed=10)
    want = jq.llm_int8_linear(jp.to_tensor(x), jqw, jp.to_tensor(b), js,
                              threshold=6.0)
    with _Ops() as ops:
        got = tq.llm_int8_linear(tp.to_tensor(x), tqw, tp.to_tensor(b), ts,
                                 threshold=6.0)
    assert "aten._int_mm" in ops.ops      # torch's CPU int8 kernel
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=TOL)
    a_q, a_s, q_in, outlier, _ = tq.llm_int8_parts(
        torch.from_numpy(x), tqw._data, ts._data, 6.0)
    assert outlier.nonzero().flatten().tolist() == [7, 50]
    from paddle_tpu_torch.quant.gemm import _int_mm

    np.testing.assert_array_equal(
        _int_mm(a_q, q_in).numpy(),
        (a_q.int() @ q_in.int().t()).numpy())
    ref = x @ w + b
    assert np.abs(_np(got) - ref).max() / np.abs(ref).max() < 0.03
    g_q, g_s = tq.weight_quantize(tp.to_tensor(_x(128, 40, seed=13)),
                                  algo="llm.int8", group_size=64)
    with pytest.raises(ValueError, match="per-channel"):
        tq.llm_int8_linear(tp.to_tensor(_x(rows, 128)), g_q,
                           weight_scale=g_s)


def test_per_channel_scale_and_stub_like_jax():
    x, s = _x(3, 8, seed=11), np.abs(_x(8, seed=12)) + 0.5
    np.testing.assert_allclose(
        _np(tq.apply_per_channel_scale(tp.to_tensor(x), tp.to_tensor(s))),
        _np(jq.apply_per_channel_scale(jp.to_tensor(x), jp.to_tensor(s))),
        rtol=1e-6)
    xb = tp.to_tensor(x).astype("bfloat16")
    assert tq.apply_per_channel_scale(xb, tp.to_tensor(s)).dtype == \
        tp.bfloat16
    stub = tq.Stub()
    t = tp.to_tensor(x)
    assert stub(t) is t and isinstance(stub, tp.nn.Layer)
