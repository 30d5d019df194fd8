"""The namespaces that work on a program, against the JAX package's:
``cost_model``, ``cinn``, ``tensorrt`` and ``api_tracer``.

- ``CostModel.profile_measure``: the flops of a matmul equal XLA's cost
  analysis in the JAX package (2·n³); the flash op is counted by its
  registered formula (4·B·H·S²·d, non-causal; B·H·S(S+1)/2 pairs causal);
  a 2-layer BERT forward's flops equal the analytic count within 1%; the
  bytes are each non-view op's operands and results; ``time`` is the
  roofline over the named card's peaks, None on the CPU.
- ``cinn.compiler.compile`` and ``cinn.runtime.Module`` give the eager
  values (dynamo with the port's graph-keeping backend).
- ``tensorrt.convert`` of a ``jit.save`` artifact: FP32 copies it, BF16
  halves the floating weights' bytes, and each is served by a
  ``Predictor`` within the reference's bound of its own conversion
  (2e-2), as the JAX package's conversion of the same weights is.
- ``api_tracer`` counts decorated calls once started, into
  ``api_calls_total{api}`` too.
- Each reference refusal raises the same exception type.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice
from test_torch_threads import one_intra_op_thread  # noqa: F401

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def _cpu():
    prev = (getattr(tdevice._state, "device", None),
            getattr(tdevice._state, "place", None))
    tp.set_device("cpu")
    yield
    tdevice._state.device, tdevice._state.place = prev


def test_matmul_cost_like_jax():
    import jax.numpy as jnp

    a = np.random.RandomState(0).randn(64, 64).astype(np.float32)
    want = jp.cost_model.CostModel().profile_measure(lambda x: x @ x,
                                                     jnp.asarray(a))
    cm = tp.cost_model.CostModel()
    got = cm.profile_measure(lambda x: x @ x, torch.from_numpy(a))
    assert got["flops"] == want["flops"] == 2 * 64 ** 3
    assert got["bytes accessed"] == 3 * 64 * 64 * 4
    assert got["time"] is None                    # the CPU has no peaks
    card = cm.profile_measure(lambda x: x @ x, torch.from_numpy(a),
                              device=H100)
    assert card["time"] == max(2 * 64 ** 3 / 67e12, 3 * 64 * 64 * 4 / 3.35e12)
    bf = cm.profile_measure(lambda x: x @ x, torch.from_numpy(a).bfloat16(),
                            device=H100)
    assert bf["time"] == max(2 * 64 ** 3 / 989e12, 3 * 64 * 64 * 2 / 3.35e12)
    with pytest.raises(KeyError):
        cm.profile_measure(lambda x: x @ x, torch.from_numpy(a),
                           device="NVIDIA A100")


@pytest.mark.parametrize("causal", [False, True])
def test_flash_op_counted_by_its_formula(causal):
    from paddle_tpu_torch.ops.kernels.flash_attention import flash_attention

    b, s, h, d = 2, 16, 3, 8
    q, k, v = (torch.randn(b, s, h, d, generator=torch.Generator()
                           .manual_seed(i)) for i in range(3))
    got = tp.cost_model.CostModel().profile_measure(
        lambda q, k, v: flash_attention(q, k, v, causal=causal), q, k, v,
        device=H100)
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    assert got["flops"] == 4 * d * pairs
    assert got["bytes accessed"] > 4 * b * s * h * d * 4


def test_bert_forward_flops_analytic():
    from paddle_tpu_torch.models import BertConfig, BertForPretraining

    cfg = BertConfig(vocab_size=512, hidden_size=64, num_layers=2,
                     num_heads=4, intermediate_size=256, max_seq_len=64,
                     dropout=0.0)
    tp.seed(0)
    model = BertForPretraining(cfg)
    model.eval()
    bsz, s, hdim = 2, 64, 64
    ids = tp.to_tensor(np.random.RandomState(0).randint(0, 512, (bsz, s)))
    got = tp.cost_model.CostModel().profile_measure(model, ids)
    tokens = bsz * s
    macs = tokens * (cfg.num_layers * (4 * hdim * hdim + 2 * hdim
                                       * cfg.intermediate_size)
                     + hdim * hdim + hdim * cfg.vocab_size)
    attn = cfg.num_layers * 4 * bsz * cfg.num_heads * s * s * (
        hdim // cfg.num_heads)
    want = 2 * macs + attn
    assert abs(got["flops"] - want) <= 0.01 * want, (got["flops"], want)


def test_cost_model_refusals_like_jax():
    for p in (jp, tp):
        cm = p.cost_model.CostModel()
        with pytest.raises(TypeError):
            cm.profile_measure(42)
        with pytest.raises(NotImplementedError):
            cm.get_static_op_time("matmul")
        with pytest.raises(NotImplementedError):
            p.cinn.compiler.compile("void f() {}")
        from importlib import import_module
        xgb = import_module(p.__name__ + ".cinn.auto_schedule.cost_model")
        with pytest.raises(NotImplementedError):
            xgb.XgbCostModel().train([], [])
        assert xgb.CostModelType.XGB == "xgb"


def test_cinn_compile_equals_eager():
    import jax.numpy as jnp

    def f(x, y):
        return torch.tanh(x @ y) * 2.0 + y.sum()

    a = np.random.RandomState(1).randn(8, 8).astype(np.float32)
    x, y = torch.from_numpy(a), torch.from_numpy(a.T.copy())
    got = tp.cinn.compiler.compile(f)(x, y)
    np.testing.assert_allclose(got.numpy(), f(x, y).numpy(), rtol=1e-6)
    want = jp.cinn.compiler.compile(
        lambda x, y: jnp.tanh(x @ y) * 2.0 + y.sum())(a, a.T)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    mod = tp.cinn.runtime.Module()
    mod.add("f", f)
    np.testing.assert_allclose(mod.get_function("f")(x, y).numpy(),
                               got.numpy())
    jit = tp.cinn.runtime.CinnLowerLevelIrJit(f)
    np.testing.assert_allclose(jit(x, y).numpy(), got.numpy())
    deco = tp.cinn.compiler.compile()(f)
    np.testing.assert_allclose(deco(x, y).numpy(), got.numpy())


def _save_linear(p, prefix, weight, bias):
    lin = p.nn.Linear(6, 4)
    if p is tp:
        lin.weight.set_value(weight)
        lin.bias.set_value(bias)
    else:
        lin.weight._data = p.to_tensor(weight)._data
        lin.bias._data = p.to_tensor(bias)._data
    p.jit.save(lin, prefix, input_spec=[p.static.InputSpec([None, 6],
                                                           "float32")])


@pytest.mark.parametrize("mode", ["FP32", "BF16", "FP16"])
def test_tensorrt_convert_like_jax(tmp_path, mode):
    rng = np.random.RandomState(2)
    weight = rng.randn(6, 4).astype(np.float32)
    bias = rng.randn(4).astype(np.float32)
    x = rng.randn(3, 6).astype(np.float32)
    exact = x @ weight + bias
    outs = {}
    for p in (jp, tp):
        prefix = str(tmp_path / p.__name__ / "lin")
        _save_linear(p, prefix, weight, bias)
        cfg = p.tensorrt.TensorRTConfig(
            inputs=[p.tensorrt.Input([1, 6], [3, 6], [8, 6])],
            precision_mode=getattr(p.tensorrt.PrecisionMode, mode),
            save_model_dir=str(tmp_path / p.__name__ / "trt"))
        out = p.tensorrt.convert(prefix, cfg)
        cfg_i = p.inference.Config(out + ".pdmodel", out + ".pdiparams")
        if p is tp:
            cfg_i.disable_gpu()
            with np.load(prefix + ".pdiparams") as a, \
                    np.load(out + ".pdiparams") as b:
                full = sum(a[f"w{i}"].size for i in range(2))
                half = sum(b[f"w{i}"].size for i in range(2))
            assert half * (2 if mode != "FP32" else 1) == full
        pred = p.inference.create_predictor(cfg_i)
        h = pred.get_input_handle(pred.get_input_names()[0])
        h.copy_from_cpu(x)
        pred.run()
        outs[p] = pred.get_output_handle(
            pred.get_output_names()[0]).copy_to_cpu()
    tol = 0.0 if mode == "FP32" else 2e-2
    np.testing.assert_allclose(outs[tp], exact, rtol=tol + 1e-6,
                               atol=tol * np.abs(exact).max() + 1e-5)
    np.testing.assert_allclose(outs[tp], outs[jp], rtol=tol + 1e-5,
                               atol=tol * np.abs(exact).max() + 1e-5)


def test_api_tracer_like_jax(tmp_path):
    from paddle_tpu_torch import telemetry

    counts = {}
    for p in (jp, tp):
        path = str(tmp_path / f"{p.__name__}.json")
        calls = p.api_tracer.start_api_tracer(path)

        @p.api_tracer.api_tracer
        def traced(a):
            return a + 1

        assert [traced(i) for i in range(3)] == [1, 2, 3]
        # the table is the process's: another test's ``traced`` may be in it
        counts[p] = calls[f"{traced.__module__}.{traced.__qualname__}"]
    assert counts[tp] == counts[jp] == 3
    was = telemetry.get_registry().enabled
    telemetry.enable()
    try:
        @tp.api_tracer.api_tracer
        def seen():
            return 0

        seen()
        snap = json.dumps(telemetry.snapshot())
        assert "api_calls_total" in snap and "seen" in snap
    finally:
        if not was:
            telemetry.disable()
