"""``F.scaled_dot_product_attention``, ``F.flash_attention`` and
``nn.MultiHeadAttention`` of the port against the JAX package: with and
without a mask, causal and not, GQA, and the ``Cache``/``StaticCache``
decode of ``MultiHeadAttention``.

On the CPU the port's unmasked route runs the flash kernel's plain
version (``ops.kernels.flash_attention``), and the JAX side runs its
``_xla_sdpa``, as on its own CPU. Outputs and the gradients of q, k and v
agree to 2e-5 (float32).
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.convert import layer_state_from_numpy
from paddle_tpu_torch.ops import kernels
from test_torch_threads import one_intra_op_thread  # noqa: F401

TOL = 2e-5


@pytest.fixture(autouse=True)
def _cpu():
    prev = (getattr(tdevice._state, "device", None),
            getattr(tdevice._state, "place", None))
    tp.set_device("cpu")
    yield
    tdevice._state.device, tdevice._state.place = prev


def _qkv(b=2, s=6, h=4, hk=4, d=8, sk=None, seed=0):
    rng = np.random.RandomState(seed)
    sk = s if sk is None else sk
    return (rng.randn(b, s, h, d).astype(np.float32),
            rng.randn(b, sk, hk, d).astype(np.float32),
            rng.randn(b, sk, hk, d).astype(np.float32))


def _attend(p, fn, arrays, mask=None):
    ts = [p.to_tensor(a, stop_gradient=False) for a in arrays]
    m = None if mask is None else p.to_tensor(mask)
    out = fn(p, *ts, m)
    (out * out).sum().backward()
    return [out.numpy()] + [t.grad.numpy() for t in ts]


def _same(fn, arrays, mask=None):
    a = _attend(jp, fn, arrays, mask)
    b = _attend(tp, fn, arrays, mask)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y, x, atol=TOL, rtol=TOL)


def _sdpa(causal):
    return lambda p, q, k, v, m: p.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=m, is_causal=causal)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [dict(), dict(hk=2), dict(hk=1, s=5),
                                   dict(s=4, sk=7)],
                         ids=["mha", "gqa", "mqa", "cross"])
def test_sdpa_unmasked_like_jax(causal, shape):
    _same(_sdpa(causal), _qkv(**shape))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["additive", "bool", "bert"])
def test_sdpa_masked_like_jax(causal, kind):
    b, s = 2, 6
    keep = np.ones((b, 1, s, s), bool)
    keep[0, :, :, 4:] = False
    if kind == "additive":
        mask = np.where(keep, 0.0, -1e9).astype(np.float32)
    elif kind == "bool":
        mask = keep
    else:
        mask = ((np.array([[1, 1, 1, 1, 0, 0], [1] * 6], np.float32) - 1.0)
                * 1e9).reshape(b, 1, 1, s)
    _same(_sdpa(causal), _qkv(b=b, s=s), mask)


def test_sdpa_routes():
    """No mask: the flash kernel's route (its plain version here, counted
    nowhere); a mask: the plain attention. A mask of all ones gives the
    unmasked output."""
    q, k, v = (tp.to_tensor(a) for a in _qkv())
    kernels.reset_launch_counts()
    free = tp.nn.functional.scaled_dot_product_attention(q, k, v)
    ones = tp.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=tp.zeros([2, 1, 1, 6]))
    np.testing.assert_allclose(ones.numpy(), free.numpy(), atol=1e-6)
    assert sum(kernels.launch_counts().values()) == 0


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_like_jax(causal):
    def fa(p, q, k, v, m):
        out, soft = p.nn.functional.flash_attention(q, k, v, causal=causal)
        assert soft is None
        return out

    _same(fa, _qkv(hk=2))


def test_flash_attention_dropout_eval_and_train():
    q, k, v = (tp.to_tensor(a) for a in _qkv())
    base = tp.nn.functional.flash_attention(q, k, v)[0].numpy()
    ev = tp.nn.functional.flash_attention(q, k, v, dropout=0.5,
                                          training=False)[0].numpy()
    np.testing.assert_array_equal(ev, base)
    tp.seed(3)
    tr = tp.nn.functional.flash_attention(q, k, v, dropout=0.5)[0].numpy()
    assert np.abs(tr - base).max() > 1e-3
    tp.seed(3)
    np.testing.assert_array_equal(
        tp.nn.functional.flash_attention(q, k, v, dropout=0.5)[0].numpy(), tr)


def test_flashmask_and_unpadded_like_jax():
    """flashmask's outputs and gradients; the varlen forward's outputs."""
    b, s, h, d = 1, 6, 2, 8
    q, k, v = _qkv(b=b, s=s, h=h, hk=h, d=d)
    sri = np.full((b, h, s, 1), s, np.int32)
    sri[..., 2, 0] = 4

    def fm(p, q_, k_, v_, m):
        return p.nn.functional.flashmask_attention(
            q_, k_, v_, p.to_tensor(sri), causal=True)

    _same(fm, (q, k, v))
    cu = np.array([0, 2, 6], np.int32)
    outs = []
    for p in (jp, tp):
        q_, k_, v_ = (p.to_tensor(a.reshape(s, h, d)) for a in (q, k, v))
        out, _ = p.nn.functional.flash_attn_unpadded(
            q_, k_, v_, p.to_tensor(cu), p.to_tensor(cu), 4, 4, 0.3,
            causal=True)
        outs.append(out.numpy())
    np.testing.assert_allclose(outs[1], outs[0], atol=TOL, rtol=TOL)


def _mha_pair(embed=16, heads=4, **kw):
    jl = jp.nn.MultiHeadAttention(embed, heads, **kw)
    tl = tp.nn.MultiHeadAttention(embed, heads, **kw)
    layer_state_from_numpy({n: t.numpy() for n, t in jl.state_dict().items()},
                           tl)
    jl.eval()
    tl.eval()
    return jl, tl


def test_multihead_attention_mask_like_jax():
    jl, tl = _mha_pair()
    x = np.random.RandomState(1).randn(2, 5, 16).astype(np.float32)
    keep = np.tril(np.ones((5, 5), bool))[None, None]
    for mask in (None, keep, np.where(keep, 0.0, -1e4).astype(np.float32)):
        outs = []
        for p, layer in ((jp, jl), (tp, tl)):
            xt = p.to_tensor(x, stop_gradient=False)
            m = None if mask is None else p.to_tensor(mask)
            out = layer(xt, attn_mask=m)
            out.sum().backward()
            outs.append([out.numpy(), xt.grad.numpy()]
                        + [q.grad.numpy() for q in layer.parameters()])
            layer.clear_gradients()
        for a, b in zip(*outs):
            np.testing.assert_allclose(b, a, atol=TOL, rtol=TOL)


def test_multihead_attention_cache_like_jax():
    """Incremental decode with ``Cache`` (one token a step) and a
    ``StaticCache`` over a memory, step by step."""
    jl, tl = _mha_pair()
    rng = np.random.RandomState(2)
    steps = rng.randn(3, 2, 1, 16).astype(np.float32)
    memory = rng.randn(2, 4, 16).astype(np.float32)
    res = []
    for p, layer in ((jp, jl), (tp, tl)):
        cache = layer.gen_cache(p.to_tensor(steps[0]))
        outs = []
        for x in steps:
            out, cache = layer(p.to_tensor(x), cache=cache)
            outs.append(out.numpy())
        assert cache.k.shape == [2, 3, 4, 4]
        mem = p.to_tensor(memory)
        static = layer.gen_cache(mem, mem,
                                 type=p.nn.MultiHeadAttention.StaticCache)
        outs.append(layer(p.to_tensor(steps[0]), mem, mem,
                          cache=static).numpy())
        res.append(outs)
    for a, b in zip(*res):
        np.testing.assert_allclose(b, a, atol=TOL, rtol=TOL)
