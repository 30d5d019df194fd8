"""The int8 activation saves and the int8 quantizers against the JAX
package, on the CPU.

The same seeded numpy inputs go through ``paddle_tpu.memory.int8_ckpt``
and ``paddle_tpu_torch.memory``: the blockwise and row quantizers bit for
bit, ``int8_saved_nbytes``, and ``int8_checkpoint``'s round trip and
straight-through gradient; then ``int8:`` saves in the port's selective
policy keep the int8 pair and rebuild the tensor from it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.memory import int8_ckpt as J
from paddle_tpu_torch import memory as T
from paddle_tpu_torch.memory import int8 as T_rows
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLMPipe
from test_torch_threads import one_intra_op_thread  # noqa: F401


def _jax_bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,block", [((3, 100), 256), ((4, 512), 256),
                                         ((7, 33), 64), ((5,), 8)],
                         ids=["padded", "exact", "block64", "tiny"])
def test_blockwise_quantizer_is_bitwise_the_reference(dtype, shape, block):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 9.0, shape)
         ).astype(np.float32)
    x.reshape(-1)[:block // 2] = 0.0          # an all-zero half block
    jx = _jax_bf16(x) if dtype == "bfloat16" else jnp.asarray(x)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = J.quantize_blockwise_int8(jx, block)
    tq, ts = T.quantize_blockwise_int8(tx, block)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jback = J.dequantize_blockwise_int8(jq, js, shape, jx.dtype)
    tback = T.dequantize_blockwise_int8(tq, ts, shape, tx.dtype)
    np.testing.assert_array_equal(tback.float().numpy(),
                                  np.asarray(jback.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_quantizer_is_bitwise_the_reference(dtype):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((4, 6, 32))
         * rng.uniform(0.001, 50.0, (4, 6, 1))).astype(np.float32)
    x[1, 2] = 0.0
    jx = _jax_bf16(x) if dtype == "bfloat16" else jnp.asarray(x)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = J.quantize_rows_int8(jx)
    tq, ts = T.quantize_rows_int8(tx)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(T.dequantize_rows_int8(tq, ts).numpy(),
                                  np.asarray(J.dequantize_rows_int8(jq, js)))
    # the KV cache's module re-exports the same functions
    assert T_rows.quantize_rows_int8 is T.quantize_rows_int8
    assert T_rows.SCALE_EPS == T.SCALE_EPS == J.SCALE_EPS


@pytest.mark.parametrize("numel,block", [(1, 256), (256, 256), (257, 256),
                                         (33_816_576, 256), (100, 64)])
def test_saved_nbytes_is_the_reference(numel, block):
    assert T.int8_saved_nbytes(numel, block) == J.int8_saved_nbytes(numel,
                                                                    block)
    assert T.INT8_BLOCK == J.INT8_BLOCK == 256


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_checkpoint_round_trip_and_straight_through_grad(dtype):
    """The forward is the reference's round trip bit for bit; the
    gradient passes through unchanged (round would zero it)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 70)).astype(np.float32) * 4
    g = rng.standard_normal((3, 5, 70)).astype(np.float32)
    jx = _jax_bf16(x) if dtype == "bfloat16" else jnp.asarray(x)
    jg = _jax_bf16(g) if dtype == "bfloat16" else jnp.asarray(g)
    jy, vjp = jax.vjp(lambda a: J.int8_checkpoint(a, "resid_mid"), jx)
    (jdx,) = vjp(jg)
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    ty = T.int8_checkpoint(tx, "resid_mid")
    (tdx,) = torch.autograd.grad(ty, tx, torch.from_numpy(g).to(tx.dtype))
    assert ty.dtype == tx.dtype and ty.shape == tx.shape
    np.testing.assert_array_equal(ty.detach().float().numpy(),
                                  np.asarray(jy.astype(jnp.float32)))
    np.testing.assert_array_equal(tdx.float().numpy(),
                                  np.asarray(jdx.astype(jnp.float32)))
    assert not torch.equal(ty.detach(), tx.detach())      # it IS quantized


def _saved_int8(policy, recompute=True):
    """The int8 tensors the selective policy keeps for one loss's
    backward, by shape, and the loss."""
    from torch.utils import checkpoint as ckpt

    cfg = GPTConfig(vocab_size=64, hidden_size=64, num_layers=1,
                    num_heads=2, max_seq_len=32, recompute=recompute,
                    recompute_policy=policy)
    model = GPTForCausalLMPipe(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(0), std=0.05)
    kept = []
    real = ckpt._CachingTorchDispatchMode.__torch_dispatch__

    def spy(self, func, types, args=(), kwargs=None):
        out = real(self, func, types, args, kwargs)
        if (func is torch.ops.paddle_tpu_torch.remat_anchor.default
                and out.dtype == torch.int8):
            kept.append(tuple(out.shape))
        return out

    ids = torch.arange(32).reshape(1, 32) % 64
    ckpt._CachingTorchDispatchMode.__torch_dispatch__ = spy
    try:
        loss = model.loss(ids, ids)
    finally:
        ckpt._CachingTorchDispatchMode.__torch_dispatch__ = real
    loss.backward()
    return kept, loss.item()


def test_int8_saves_keep_the_int8_pair_in_place_of_the_anchor():
    """``int8:ffn_gate,int8:ffn_up`` keeps int8 codes of gate and up
    (blockwise, [tokens * intermediate / 256, 256]) through the anchor the
    policy saves; the plain names keep none."""
    m = GPTConfig(hidden_size=64).intermediate_size
    kept, _ = _saved_int8("names:attn_q,int8:ffn_gate,int8:ffn_up")
    assert kept == [(32 * m // 256, 256)] * 2
    assert _saved_int8("names:attn_q,ffn_gate,ffn_up")[0] == []
