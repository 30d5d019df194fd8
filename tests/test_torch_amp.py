"""``paddle_tpu_torch.amp`` against the JAX package's ``amp`` on the CPU.

- Cast by list: each white- and black-list op of both surfaces gives, under
  ``auto_cast``, the JAX package's output dtype (f32 inputs for the white
  list, bf16 inputs for the black list, so that each cast shows); a custom
  list is taken back out on exit.
- ``decorate`` at O2: a tiny BERT's parameter dtypes equal the JAX
  package's (the norms stay f32).
- ``GradScaler``: scale, unscale, step and update over a run with an inf
  injected through the input: the same scales, skipped steps, weights and
  ``state_dict`` as the JAX scaler.
- ``fp8_autocast`` routes ``nn.Linear`` through the fp8 GEMM
  (``tests/test_incubate_functional.py:222-240`` on the port).
- BASELINE config 3 at the reference test's size
  (``tests/test_baseline_configs.py:54-94``: vocab 256, hidden 64, 2
  layers, 16 x 16, bf16 O2, AdamW ``multi_precision``): 10 ``TrainStep``s
  of the port against the JAX package's on the same weights and batch.
- The per-layer GPT: the shared block refuses under ``auto_cast``
  (``tests/test_scan_layers.py:157-160``), and its module loop's loss
  under ``auto_cast()`` follows the JAX model's (the reference cannot
  take this model's backward under autocast; the port's gradients are
  held finite and in the parameters' type).
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jp
from paddle_tpu.core.tensor import Tensor as JTensor
import paddle_tpu_torch as tp
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import BertForPretraining as JBert
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.convert import layer_state_from_numpy, \
    state_dict_from_jax
from paddle_tpu_torch.models import BertConfig, BertForPretraining
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM

import torch_numpy_init
from test_torch_threads import one_intra_op_thread  # noqa: F401

#: config 3 in bf16 O2 over 10 steps, the port against the JAX package:
#: each loss within this of the JAX loss, relative (measured 4.1e-4 at
#: most: bf16 products rounded after sums taken in other orders, carried
#: through AdamW's steps)
CONFIG3_LOSS_RTOL = 2e-3
#: the per-layer GPT under auto_cast() bf16 O1: the loss relative
#: (measured 1.6e-5: bf16 activations rounded after sums in other orders)
GPT_LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _numpy_jax_init(monkeypatch):
    torch_numpy_init.install(monkeypatch, std=0.05)


@pytest.fixture(autouse=True)
def _cpu():
    prev = (getattr(tdevice._state, "device", None),
            getattr(tdevice._state, "place", None))
    tp.set_device("cpu")
    yield
    tdevice._state.device, tdevice._state.place = prev


_R = np.random.RandomState(0)
X, Y = _R.randn(2, 3, 4).astype(np.float32), _R.randn(2, 4, 5).astype(
    np.float32)
M, VEC = _R.randn(3, 4).astype(np.float32), _R.randn(4).astype(np.float32)
POS = np.abs(M) + 0.5
LAB = np.array([1, 2, 0], np.int64)
Q = _R.randn(1, 4, 2, 8).astype(np.float32)
IMG = {1: _R.randn(1, 2, 8), 2: _R.randn(1, 2, 6, 6),
       3: _R.randn(1, 2, 4, 4, 4)}
W = {1: _R.randn(3, 2, 3), 2: _R.randn(3, 2, 3, 3), 3: _R.randn(3, 2, 3, 3, 3)}
WT = {n: _R.randn(2, 3, *([3] * n)) for n in (1, 2, 3)}


def _t(p, a, dtype="float32"):
    return p.to_tensor(np.asarray(a, np.float32)).astype(dtype)


def _conv(n, transpose=False):
    def f(p):
        fn = getattr(p.nn.functional,
                     f"conv{n}d_transpose" if transpose else f"conv{n}d")
        return fn(_t(p, IMG[n]), _t(p, (WT if transpose else W)[n]))
    return f


#: white list: f32 inputs, the low type out
WHITE = {
    "matmul": lambda p: p.matmul(_t(p, X), _t(p, Y)),
    "mm": lambda p: p.mm(_t(p, M), _t(p, M.T)),
    "bmm": lambda p: p.bmm(_t(p, X), _t(p, Y)),
    "mv": lambda p: p.mv(_t(p, M), _t(p, VEC)),
    "linear": lambda p: p.nn.functional.linear(_t(p, M), _t(p, M.T)),
    "einsum": lambda p: p.einsum("ij,kj->ik", _t(p, M), _t(p, M)),
    "flash_attention": lambda p: p.nn.functional.flash_attention(
        _t(p, Q), _t(p, Q), _t(p, Q))[0],
    "sdpa": lambda p: p.nn.functional.scaled_dot_product_attention(
        _t(p, Q), _t(p, Q), _t(p, Q)),
    **{f"conv{n}d": _conv(n) for n in (1, 2, 3)},
    **{f"conv{n}d_transpose": _conv(n, True) for n in (1, 2, 3)},
}


def _bf(a):
    return lambda p: _t(p, a, "bfloat16")


#: black list: bf16 inputs, f32 out
BLACK = {
    "exp": lambda p: p.exp(_bf(M)(p)),
    "log": lambda p: p.log(_bf(POS)(p)),
    "log2": lambda p: p.log2(_bf(POS)(p)),
    "log10": lambda p: p.log10(_bf(POS)(p)),
    "mean": lambda p: p.mean(_bf(M)(p)),
    "sum": lambda p: p.sum(_bf(M)(p)),
    "softmax": lambda p: p.nn.functional.softmax(_bf(M)(p)),
    "log_softmax": lambda p: p.nn.functional.log_softmax(_bf(M)(p)),
    "cross_entropy": lambda p: p.nn.functional.cross_entropy(
        _bf(M)(p), p.to_tensor(LAB)),
    "softmax_with_cross_entropy":
        lambda p: p.nn.functional.softmax_with_cross_entropy(
            _bf(M)(p), p.to_tensor(LAB[:, None])),
    "layer_norm": lambda p: p.nn.functional.layer_norm(_bf(M)(p), 4),
    "rms_norm": lambda p: p.nn.functional.rms_norm(
        _bf(M)(p), _bf(np.ones(4))(p)),
    "norm": lambda p: p.norm(_bf(M)(p)),
    "cumsum": lambda p: p.cumsum(_bf(M)(p), 0),
    "logsumexp": lambda p: p.logsumexp(_bf(M)(p)),
    "erf": lambda p: p.erf(_bf(M)(p)),
    "erfinv": lambda p: p.erfinv(_bf(M * 0.1)(p)),
    # the reference dispatches paddle.pow as "power" (its jnp function's
    # name), which no list holds: the input's type out
    "pow": lambda p: p.pow(_bf(POS)(p), 2.0),
}


def _dtype(t):
    return str(t.dtype).split(".")[-1]


def test_lists_equal_the_reference():
    assert tp.amp.WHITE_LIST == jp.amp.WHITE_LIST
    assert tp.amp.BLACK_LIST == jp.amp.BLACK_LIST
    assert set(WHITE) == tp.amp.WHITE_LIST
    assert set(BLACK) == tp.amp.BLACK_LIST


@pytest.mark.parametrize("name", sorted(WHITE) + sorted(BLACK))
def test_cast_by_list_like_jax(name):
    fn = {**WHITE, **BLACK}[name]
    got = {}
    with jp.amp.auto_cast():
        # the reference's output type by tracing alone (no compile)
        got["paddle_tpu"] = str(jax.eval_shape(lambda: fn(jp)._data).dtype)
    with tp.amp.auto_cast():
        got["paddle_tpu_torch"] = _dtype(fn(tp))
    assert got["paddle_tpu_torch"] == got["paddle_tpu"], got
    if name in WHITE:
        assert got["paddle_tpu_torch"] == "bfloat16"
    with tp.amp.auto_cast(dtype="float16"):
        half = _dtype(fn(tp))
    assert half == ("float16" if name in WHITE else got["paddle_tpu"])


def test_autocast_off_and_custom_lists_restore():
    x = _t(tp, M)
    assert _dtype(tp.matmul(x, x.T)) == "float32"      # autocast off
    with tp.amp.auto_cast(custom_white_list={"tanh"},
                          custom_black_list={"matmul"}):
        assert _dtype(tp.tanh(x)) == "bfloat16"
        # a name on both lists: the white list wins, as in the reference
        assert _dtype(tp.matmul(x, x.T)) == "bfloat16"
        assert tp.amp.is_auto_cast_enabled()
    assert "tanh" not in tp.amp.WHITE_LIST
    assert "matmul" in tp.amp.WHITE_LIST and "matmul" not in \
        tp.amp.BLACK_LIST
    assert not tp.amp.is_auto_cast_enabled()
    with tp.amp.auto_cast(enable=False):
        assert _dtype(tp.matmul(x, x.T)) == "float32"
    # float64 and integers pass unchanged
    with tp.amp.auto_cast():
        assert _dtype(tp.matmul(_t(tp, M, "float64"),
                                _t(tp, M.T, "float64"))) == "float64"
    assert tp.amp.is_bfloat16_supported() and tp.amp.is_float16_supported()


BERT = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_seq_len=32, dropout=0.0)


def _berts():
    jp.seed(1)
    jm = JBert(JBertConfig(**BERT))
    tm = BertForPretraining(BertConfig(**BERT))
    layer_state_from_numpy({n: t.numpy() for n, t in jm.state_dict().items()},
                           tm)
    return jm, tm


def test_decorate_o2_dtypes_like_jax():
    jm, tm = _berts()
    params = [tm._data for tm in tm.parameters()]
    jp.amp.decorate(jm, level="O2")
    out = tp.amp.decorate(tm, level="O2")
    assert out is tm
    jd = {n: _dtype(p) for n, p in jm.named_parameters()}
    td = {n: _dtype(p) for n, p in tm.named_parameters()}
    assert td == jd
    assert {n for n, d in td.items() if d == "float32"} == {
        n for n in td if "norm" in n}
    # the same torch.nn.Parameter objects, now in bf16
    assert all(a is b._data for a, b in zip(params, tm.parameters()))
    # O1 changes nothing
    tm2 = BertForPretraining(BertConfig(**BERT))
    tp.amp.decorate(tm2, level="O1")
    assert {_dtype(p) for p in tm2.parameters()} == {"float32"}


def _scaler_run(p):
    p.seed(3)
    lin = p.nn.Linear(4, 3)
    lin.weight.set_value(np.arange(12, dtype=np.float32).reshape(4, 3) / 10)
    lin.bias.set_value(np.zeros(3, np.float32))
    opt = p.optimizer.SGD(learning_rate=0.1, parameters=lin.parameters())
    scaler = p.amp.GradScaler(init_loss_scaling=1024.0, incr_every_n_steps=2)
    rng = np.random.RandomState(4)
    trace = []
    for i in range(6):
        x = rng.randn(2, 4).astype(np.float32)
        if i in (2, 3):
            x[0, 1] = np.inf                 # an inf injected: a skip
        loss = (lin(p.to_tensor(x)) ** 2).mean()
        scaler.scale(loss).backward()
        scaler.step(opt)
        opt.clear_grad()
        trace.append((scaler.get_init_loss_scaling(), bool(scaler._found_inf),
                      lin.weight.numpy().copy()))
    return trace, scaler.state_dict()


def test_grad_scaler_like_jax():
    jt, js = _scaler_run(jp)
    tt, ts = _scaler_run(tp)
    assert ts == js
    assert [t[:2] for t in tt] == [t[:2] for t in jt]
    assert [t[1] for t in tt] == [False, False, True, True, False, False]
    assert [t[0] for t in tt] == [1024.0, 2048.0, 1024.0, 512.0, 512.0,
                                  1024.0]
    for (_, _, a), (_, _, b) in zip(tt, jt):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    # a skipped step leaves the weights as they were
    np.testing.assert_array_equal(tt[2][2], tt[1][2])
    np.testing.assert_array_equal(tt[3][2], tt[1][2])
    s = tp.amp.GradScaler()
    s.load_state_dict({"scale": 8.0})
    assert s.get_init_loss_scaling() == 8.0 and s.is_enable()
    off = tp.amp.GradScaler(enable=False)
    loss = tp.to_tensor(2.0)
    assert off.scale(loss) is loss


def test_found_inf_counter_and_check_numerics():
    from paddle_tpu_torch.amp import _found_inf_counter

    tp.telemetry.enable()
    try:
        before = _found_inf_counter().value()
        w = tp.create_parameter([2], "float32")
        opt = tp.optimizer.SGD(learning_rate=0.1, parameters=[w])
        (w * tp.to_tensor([np.inf, 1.0])).sum().backward()
        s = tp.amp.GradScaler()
        s.step(opt)
        assert _found_inf_counter().value() == before + 1
        assert s.get_init_loss_scaling() == 2.0 ** 15
    finally:
        tp.telemetry.disable()
    assert tp.amp.debugging.check_numerics(tp.to_tensor([1.0])) == (0, 0)
    with pytest.raises(RuntimeError, match="1 nan"):
        tp.amp.debugging.check_numerics(tp.to_tensor([np.nan, 1.0]))


def test_fp8_autocast_routes_linear():
    rng = np.random.default_rng(3)
    tp.seed(7)
    lin = tp.nn.Linear(32, 8)
    x = tp.to_tensor(rng.standard_normal((4, 32)).astype(np.float32))
    ref = lin(x).numpy()
    with tp.amp.fp8_autocast():
        assert tp.amp.is_fp8_enabled()
        got = lin(x).numpy()
    assert not np.array_equal(got, ref)            # quantisation visible
    np.testing.assert_allclose(got, ref, atol=0.35, rtol=0.2)
    np.testing.assert_array_equal(lin(x).numpy(), ref)   # state restored


def _config3_losses(p, model, steps=10):
    opt = p.optimizer.AdamW(learning_rate=5e-3, multi_precision=True,
                            parameters=model.parameters())
    step = p.jit.TrainStep(model, lambda i, y: model.loss(i, y), opt)
    rng = np.random.RandomState(2)
    ids = p.to_tensor(rng.randint(0, 256, (16, 16)).astype(np.int64))
    labels = rng.randint(0, 256, (16, 16)).astype(np.int64)
    labels[:, ::2] = -100
    lab = p.to_tensor(labels)
    out = []
    for _ in range(steps):
        with p.amp.auto_cast(enable=True, dtype="bfloat16", level="O2"):
            out.append(float(step(ids, lab)))
    return out


def test_config3_bf16_o2_ten_steps_like_jax():
    jm, tm = _berts()
    jp.amp.decorate(jm, level="O2")
    tp.amp.decorate(tm, level="O2")
    jl = _config3_losses(jp, jm)
    tl = _config3_losses(tp, tm)
    assert np.isfinite(tl).all() and tl[-1] < tl[0], tl
    rel = np.abs(np.array(tl) - jl) / np.abs(jl)
    assert rel.max() <= CONFIG3_LOSS_RTOL, (rel, tl, jl)
    w = tm.bert.embeddings.word_embeddings.weight
    assert w._data.dtype == torch.bfloat16


GPT = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=4,
           num_kv_heads=2, intermediate_size=128, max_seq_len=16,
           dropout=0.0)


def test_per_layer_gpt_under_auto_cast_like_jax():
    jp.seed(2)
    jm = JGPT(JGPTConfig(**GPT))
    with jp.amp.auto_cast():
        assert not jm.model._shared_block_eligible(None)
    assert jm.model._shared_block_eligible(None)
    sd = {k: v.numpy() for k, v in jm.state_dict().items()}
    cfg = GPTConfig(**GPT)
    tm = GPTForCausalLM(cfg, device="cpu")
    tm.load_state_dict(state_dict_from_jax(sd, cfg))
    assert tm.model._shared_block_refusal(None) is None
    with tp.amp.auto_cast():
        assert tm.model._shared_block_refusal(None) == "auto_cast is enabled"
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 64, (2, 12))
    labels = rng.integers(0, 64, (2, 12))
    # the forward only: the reference's eager tape cannot take this
    # model's backward under auto_cast (a bf16 cotangent reaches an f32
    # output's VJP and JAX raises)
    def jax_loss(state, i, y):
        # the reference's loss under one jit (its eager ops each compile)
        with jm._swap_state(state), jp.no_grad(), jp.amp.auto_cast():
            return jm.loss(JTensor(i), JTensor(y))._data

    jl = float(jax.jit(jax_loss)(
        {n: p._data for n, p in jm.named_parameters()},
        ids.astype(np.int32), labels))
    with tp.amp.auto_cast():
        tl = tm.loss(torch.as_tensor(ids), torch.as_tensor(labels))
        logits = tm(torch.as_tensor(ids))
    # the head is a white-list op, the loss's f32 (the reference's types)
    assert logits.dtype == torch.bfloat16 and tl.dtype == torch.float32
    assert abs(float(tl) - jl) <= GPT_LOSS_RTOL * abs(jl), (float(tl), jl)
    tl.backward()
    for name, p in tm.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all(), name
