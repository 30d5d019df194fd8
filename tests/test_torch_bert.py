"""``BertForPretraining`` of the port against the JAX model, at depth 2 and
hidden 64, on the same weights (``convert.layer_state_from_numpy``).

- Forward and backward, unmasked (the flash route) and under an
  ``attention_mask`` (the plain route): MLM and NSP logits to 2e-5, the
  MLM + NSP loss to 1e-5 relative, and every parameter's gradient to 1e-4
  of that leaf's gradient norm (max abs difference), plus 1e-7 absolute:
  the key projections' biases have an exact gradient of 0 (a row's
  softmax ignores a shift common to its logits), which both packages
  compute as rounding noise near 1e-9.
- Six steps of ``jit.TrainStep`` with ``AdamW(learning_rate=1e-3)``, as
  ``tests/test_models.py:47-72`` runs them, on the same weights and batch:
  each loss within 1e-4 relative of the JAX package's.
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import BertForPretraining as JBert
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.convert import layer_state_from_numpy
from paddle_tpu_torch.models import BertConfig, BertForPretraining
from test_torch_threads import one_intra_op_thread  # noqa: F401

CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           intermediate_size=128, max_seq_len=32, dropout=0.0)


@pytest.fixture(autouse=True)
def _cpu():
    prev = (getattr(tdevice._state, "device", None),
            getattr(tdevice._state, "place", None))
    tp.set_device("cpu")
    yield
    tdevice._state.device, tdevice._state.place = prev


def _models():
    jm = JBert(JBertConfig(**CFG))
    tm = BertForPretraining(BertConfig(**CFG))
    layer_state_from_numpy(
        {n: t.numpy() for n, t in jm.state_dict().items()}, tm)
    return jm, tm


def _batch():
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 128, (4, 16)).astype(np.int32)
    labels = rng.randint(0, 128, (4, 16)).astype(np.int64)
    labels[:, ::2] = -100  # only masked positions contribute
    nsp = rng.randint(0, 2, (4,)).astype(np.int64)
    types = rng.randint(0, 2, (4, 16)).astype(np.int64)
    attn = np.ones((4, 16), np.int64)
    attn[1, 11:] = 0
    attn[3, 6:] = 0
    return ids, labels, nsp, types, attn


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_loss_logits_and_grads_like_jax(masked):
    jm, tm = _models()
    ids, labels, nsp, types, attn = _batch()
    res = []
    for p, m in ((jp, jm), (tp, tm)):
        mask = p.to_tensor(attn) if masked else None
        mlm, nsp_logits = m(p.to_tensor(ids), p.to_tensor(types), mask)
        loss = m.loss(p.to_tensor(ids), p.to_tensor(labels),
                      p.to_tensor(nsp), p.to_tensor(types), mask)
        loss.backward()
        res.append((mlm.numpy(), nsp_logits.numpy(), float(loss),
                    {n: q.grad.numpy() for n, q in m.named_parameters()}))
    (jmlm, jnsp, jloss, jg), (tmlm, tnsp, tloss, tg) = res
    np.testing.assert_allclose(tmlm, jmlm, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(tnsp, jnsp, atol=2e-5, rtol=2e-5)
    assert abs(tloss - jloss) <= 1e-5 * abs(jloss), (tloss, jloss)
    assert list(tg) == list(jg)
    for name, g in jg.items():
        bound = 1e-4 * np.linalg.norm(g) + 1e-7
        assert np.abs(tg[name] - g).max() <= bound, name


def test_mask_keeps_padding_out():
    """The padded tokens of a masked row do not reach its kept positions
    (``tests/test_models.py::test_bert_attention_mask``)."""
    _, tm = _models()
    tm.eval()
    ids, _, _, _, attn = _batch()
    seq, _ = tm.bert(tp.to_tensor(ids), attention_mask=tp.to_tensor(attn))
    ids2 = ids.copy()
    ids2[1, 11:] = 0
    seq2, _ = tm.bert(tp.to_tensor(ids2), attention_mask=tp.to_tensor(attn))
    np.testing.assert_allclose(seq.numpy()[1, :11], seq2.numpy()[1, :11],
                               atol=1e-5)


def test_train_step_like_jax():
    jm, tm = _models()
    ids, labels, nsp, _, _ = _batch()
    losses = []
    for p, m in ((jp, jm), (tp, tm)):
        opt = p.optimizer.AdamW(learning_rate=1e-3,
                                parameters=m.parameters())

        def train_fn(i, y, n, m=m):
            return m.loss(i, y, n)

        step = p.jit.TrainStep(m, train_fn, opt)
        batch = (p.to_tensor(ids), p.to_tensor(labels), p.to_tensor(nsp))
        losses.append([float(step(*batch)) for _ in range(6)])
    jl, tl = map(np.asarray, losses)
    assert np.isfinite(tl).all() and tl[-1] < tl[0], tl
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def test_eager_optimizer_loop_learns():
    """``loss.backward()``, ``opt.step()``, ``opt.clear_grad()`` on the
    port's own: the loss of one repeated batch falls."""
    _, tm = _models()
    opt = tp.optimizer.AdamW(learning_rate=1e-3, parameters=tm.parameters())
    ids, labels, nsp, _, _ = _batch()
    batch = (tp.to_tensor(ids), tp.to_tensor(labels), tp.to_tensor(nsp))
    losses = []
    for _ in range(3):
        loss = tm.loss(*batch)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
        assert all(q.grad is None for q in tm.parameters())
    assert losses[-1] < losses[0], losses
    loss = tm.loss(*batch)
    opt.minimize(loss)
    assert float(tm.loss(*batch)) < losses[-1]
