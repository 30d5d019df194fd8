"""The port's ``jit.save``/``jit.load`` artifact and the inference
``Predictor`` against the JAX package (the cases of
``tests/test_inference.py``).

The artifact holds no pickled class and loads in a fresh process that
never sees the model's class (nor jax); a bad feed shape is refused; a
dynamic batch serves every batch size; a multi-output structure comes
back whole; ``convert_to_mixed_precision`` halves the floating weights'
bytes. For one small Layer the two packages write ``.pdiparams`` with the
same names, dtypes, shapes and bytes and ``.pdmeta.json`` with the same
``params``, ``inputs``, ``input_names`` and ``outputs``; a depth-2
``GPTForCausalLMPipe`` saved and served by a CPU ``Predictor`` gives the
JAX Pipe's logits within 1e-4 on the same weights. Every Predictor here
asks for the CPU (``Config.disable_gpu()``); the card's runs are in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``'s ``deploy``.
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import inference
from paddle_tpu_torch.convert import layer_state_from_numpy
from paddle_tpu_torch.static import InputSpec
from test_torch_threads import one_intra_op_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _cpu():
    prev = (getattr(tdevice._state, "device", None),
            getattr(tdevice._state, "place", None))
    tp.set_device("cpu")
    yield
    tdevice._state.device, tdevice._state.place = prev


def _tiny(p):
    class TinyNet(p.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = p.nn.Linear(4, 8)
            self.fc2 = p.nn.Linear(8, 2)

        def forward(self, x):
            return self.fc2(p.tanh(self.fc1(x)))

    m = TinyNet()
    m.eval()
    return m


def _cpu_predictor(prefix, params=None):
    cfg = inference.Config(prefix, params)
    cfg.disable_gpu()
    assert not cfg.use_gpu()
    return inference.create_predictor(cfg)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_save_produces_class_free_artifact(tmp_path):
    model = _tiny(tp)
    x = tp.to_tensor(_x(3, 4))
    ref = model(x).numpy()
    prefix = str(tmp_path / "tiny")
    tp.jit.save(model, prefix)          # the spec of the call above
    for ext in (".pdmodel", ".pdiparams", ".pdmeta.json"):
        blob = open(prefix + ext, "rb").read()
        assert not blob.startswith(b"\x80"), f"{ext} is a pickle stream"
        with pytest.raises(Exception):
            pickle.loads(blob)
    loaded = tp.jit.load(prefix)
    np.testing.assert_allclose(loaded(x).numpy(), ref, atol=1e-6)
    sd = loaded.state_dict()
    assert "fc1.weight" in sd and tuple(sd["fc1.weight"].shape) == (4, 8)


def test_save_needs_a_spec_or_a_call(tmp_path):
    with pytest.raises(ValueError, match="input_spec"):
        tp.jit.save(_tiny(tp), str(tmp_path / "never_called"))


def test_load_in_fresh_process_without_model_class(tmp_path):
    model = _tiny(tp)
    x = _x(3, 4, seed=1)
    ref = model(tp.to_tensor(x)).numpy()
    prefix = str(tmp_path / "tiny")
    tp.jit.save(model, prefix)
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "ref.npy", ref)
    script = textwrap.dedent(f"""
        import sys
        import numpy as np
        import paddle_tpu_torch as paddle
        from paddle_tpu_torch.inference import Config, create_predictor

        paddle.set_device("cpu")
        x = np.load({str(tmp_path / 'x.npy')!r})
        ref = np.load({str(tmp_path / 'ref.npy')!r})
        layer = paddle.jit.load({prefix!r})
        np.testing.assert_allclose(layer(x).numpy(), ref, atol=1e-6)
        cfg = Config({prefix!r} + ".pdmodel")
        cfg.disable_gpu()
        pred = create_predictor(cfg)
        names = pred.get_input_names()
        assert len(names) == 1, names
        pred.get_input_handle(names[0]).copy_from_cpu(x)
        pred.run()
        got = pred.get_output_handle(
            pred.get_output_names()[0]).copy_to_cpu()
        np.testing.assert_allclose(got, ref, atol=1e-6)
        assert "jax" not in sys.modules and "paddle_tpu" not in sys.modules
        print("FRESH_PROCESS_OK")
    """)
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": str(tmp_path), "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(ROOT),
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "FRESH_PROCESS_OK" in proc.stdout


def test_predictor_rejects_bad_feed_shape(tmp_path):
    model = _tiny(tp)
    model(tp.randn([3, 4]))
    prefix = str(tmp_path / "tiny")
    tp.jit.save(model, prefix)
    pred = _cpu_predictor(prefix)
    h = pred.get_input_handle(pred.get_input_names()[0])
    with pytest.raises(ValueError, match="expected shape"):
        h.copy_from_cpu(np.zeros((5, 4), np.float32))
    with pytest.raises(RuntimeError, match="missing feeds"):
        pred.run()


def test_dynamic_batch_dim(tmp_path):
    model = _tiny(tp)
    prefix = str(tmp_path / "dyn")
    tp.jit.save(model, prefix, input_spec=[InputSpec([None, 4], "float32")])
    assert json.load(open(prefix + ".pdmeta.json"))["inputs"][0][
        "shape"] == [-1, 4]
    loaded = tp.jit.load(prefix)
    for b in (1, 3, 7):
        x = tp.to_tensor(_x(b, 4, seed=b))
        np.testing.assert_allclose(loaded(x).numpy(), model(x).numpy(),
                                   atol=1e-6)
    pred = _cpu_predictor(prefix)
    for b in (2, 5):
        outs = pred.run([np.zeros((b, 4), np.float32)])
        assert tuple(outs[0].shape) == (b, 2)


def _two_head(p):
    class TwoHead(p.nn.Layer):
        def __init__(self):
            super().__init__()
            self.a = p.nn.Linear(4, 3)
            self.b = p.nn.Linear(4, 2)

        def forward(self, x):
            return self.a(x), {"logits": self.b(x)}

    m = TwoHead()
    m.eval()
    return m


def test_save_with_input_spec_and_multi_output(tmp_path):
    model = _two_head(tp)
    prefix = str(tmp_path / "twohead")
    tp.jit.save(model, prefix,
                input_spec=[InputSpec([3, 4], "float32", name="feat")])
    loaded = tp.jit.load(prefix)
    x = tp.to_tensor(_x(3, 4, seed=2))
    ref_a, ref_d = model(x)
    out_a, out_d = loaded(x)
    np.testing.assert_allclose(out_a.numpy(), ref_a.numpy(), atol=1e-6)
    np.testing.assert_allclose(out_d["logits"].numpy(),
                               ref_d["logits"].numpy(), atol=1e-6)
    pred = _cpu_predictor(prefix)
    assert pred.get_input_names() == ["feat"]
    assert pred.get_output_names() == ["fetch_0", "fetch_1"]
    assert len(pred.run([x.numpy()])) == 2


def _float_bytes(prefix):
    with np.load(prefix + ".pdiparams", allow_pickle=False) as z:
        n = sum(1 for k in z.files if k.endswith("_dtype"))
        return sum(z[f"w{i}"].size for i in range(n)
                   if str(z[f"w{i}_dtype"]).startswith(("float", "bfloat")))


def test_inference_surface_and_mixed_precision(tmp_path):
    assert inference.get_num_bytes_of_data_type(
        inference.DataType.FLOAT32) == 4
    assert inference.get_num_bytes_of_data_type(6) == 2      # BFLOAT16
    assert "paddle_tpu" in inference.get_version()
    model = tp.nn.Sequential(tp.nn.Linear(8, 16), tp.nn.ReLU(),
                             tp.nn.Linear(16, 4))
    prefix = str(tmp_path / "m")
    tp.jit.save(model, prefix, input_spec=[InputSpec([2, 8], "float32")])
    mixed = str(tmp_path / "m_bf16")
    inference.convert_to_mixed_precision(
        prefix + ".pdmodel", prefix + ".pdiparams", mixed + ".pdmodel",
        mixed + ".pdiparams")
    assert 2 * _float_bytes(mixed) == _float_bytes(prefix)
    assert os.path.getsize(mixed + ".pdiparams") < os.path.getsize(
        prefix + ".pdiparams")
    x = np.random.default_rng(0).standard_normal((2, 8)).astype(np.float32)
    p32 = _cpu_predictor(prefix + ".pdmodel", prefix + ".pdiparams")
    p16 = _cpu_predictor(mixed + ".pdmodel", mixed + ".pdiparams")

    def run(p):
        p.get_input_handle(p.get_input_names()[0]).copy_from_cpu(x)
        p.run()
        return p.get_output_handle(p.get_output_names()[0]).copy_to_cpu()

    np.testing.assert_allclose(run(p16), run(p32), rtol=2e-2, atol=2e-2)
    assert p16._weights[0].dtype == torch.bfloat16
    cfg = inference.Config(prefix + ".pdmodel", prefix + ".pdiparams")
    cfg.disable_gpu()
    pool = inference.PredictorPool(cfg, 2)
    assert pool.retrieve(1)._exported is pool.retrieve(0)._exported
    assert pool.retrieve(1)._weights is pool.retrieve(0)._weights
    np.testing.assert_allclose(run(pool.retrieve(1)), run(p32), rtol=1e-6)


def test_mixed_precision_casts_each_weight_at_its_first_use(tmp_path):
    """Each bf16 weight is cast back just before its first user, so its
    f32 copy is not alive while the layers before it run: between a cast
    and its first user stand only other casts, and the last layer's casts
    come after the first layer's op."""
    from paddle_tpu_torch.jit.artifact import read_artifact

    model = tp.nn.Sequential(tp.nn.Linear(8, 16), tp.nn.ReLU(),
                             tp.nn.Linear(16, 16), tp.nn.ReLU(),
                             tp.nn.Linear(16, 4))
    prefix = str(tmp_path / "m")
    tp.jit.save(model, prefix, input_spec=[InputSpec([2, 8], "float32")])
    mixed = str(tmp_path / "m_bf16")
    inference.convert_to_mixed_precision(
        prefix + ".pdmodel", prefix + ".pdiparams", mixed + ".pdmodel",
        mixed + ".pdiparams")
    ep, weights, _ = read_artifact(mixed)
    assert all(w.dtype == torch.bfloat16 for w in weights)
    nodes = list(ep.graph.nodes)
    casts = [n for n in nodes
             if n.target is torch.ops.aten._to_copy.default
             and n.args[0].op == "placeholder"]
    assert len(casts) == len(weights) == 6
    for cast in casts:
        first = min(cast.users, key=nodes.index)
        between = nodes[nodes.index(cast) + 1:nodes.index(first)]
        assert all(n in casts for n in between), (cast, between)
    first_op = next(n for n in nodes if n.op == "call_function"
                    and n not in casts)
    assert nodes.index(casts[-1]) > nodes.index(first_op)


@pytest.mark.parametrize("kw,err", [
    (dict(black_list={"matmul"}), NotImplementedError),
    (dict(keep_io_types=False), NotImplementedError),
    (dict(mixed_precision="int8"), ValueError),
    (dict(mixed_model_file="m_bf16.bin"), ValueError),
])
def test_mixed_precision_refusals_like_jax(tmp_path, kw, err):
    """The reference's refusals, each raising the same type in both
    packages."""
    for p, spec in ((jp, jp.static.InputSpec), (tp, InputSpec)):
        model = p.nn.Linear(4, 2)
        prefix = str(tmp_path / f"{p.__name__}_m")
        p.jit.save(model, prefix, input_spec=[spec([2, 4], "float32")])
        args = dict(model_file=prefix + ".pdmodel",
                    params_file=prefix + ".pdiparams",
                    mixed_model_file=prefix + "_bf16.pdmodel",
                    mixed_params_file=prefix + "_bf16.pdiparams")
        args.update(kw)
        with pytest.raises(err):
            p.inference.convert_to_mixed_precision(**args)


def test_config_and_predictor_defaults():
    cfg = inference.Config("some/dir/model.pdmodel")
    assert cfg.use_gpu() is True                  # the card by default
    assert cfg.prog_file() == "some/dir/model.pdmodel"
    assert cfg.params_file() == "some/dir/model.pdiparams"
    cfg.disable_gpu()
    assert cfg.use_gpu() is False and cfg.device().type == "cpu"
    if not torch.cuda.is_available():
        cfg.enable_use_gpu()
        with pytest.raises(RuntimeError, match="CUDA"):
            cfg.device()
    with pytest.raises(ValueError, match="no model path"):
        inference.Predictor(inference.Config())


def test_pdiparams_and_meta_match_jax(tmp_path):
    """One small Layer on the same weights: the same ``.pdiparams`` names,
    dtypes, shapes and bytes and the same ``.pdmeta.json`` fields as the
    JAX package's artifact, dynamic batch and multi-output included."""
    jl, tl = _two_head(jp), _two_head(tp)
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    layer_state_from_numpy(state, tl)
    files = {}
    for p, spec, m in ((jp, jp.static.InputSpec, jl),
                       (tp, InputSpec, tl)):
        prefix = str(tmp_path / p.__name__)
        p.jit.save(m, prefix, input_spec=[spec([None, 4], "float32",
                                               name="feat")])
        with np.load(prefix + ".pdiparams", allow_pickle=False) as z:
            files[p.__name__] = (
                {k: z[k].tobytes() if k[1:].isdigit() else str(z[k])
                 for k in z.files},
                json.load(open(prefix + ".pdmeta.json")))
    (jz, jmeta), (tz, tmeta) = files["paddle_tpu"], files["paddle_tpu_torch"]
    assert jz == tz
    for key in ("version", "params", "inputs", "input_names", "outputs"):
        assert tmeta[key] == jmeta[key], key


def _pipe_pair(seed=8):
    from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
    from paddle_tpu.models.gpt import GPTForCausalLMPipe as JaxPipe
    from paddle_tpu_torch.convert import pipe_state_dict_from_jax
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLMPipe

    kw = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
              max_seq_len=128, dropout=0.0)
    rng = np.random.default_rng(seed)
    jm = JaxPipe(JaxGPTConfig(**kw))
    sd = {}
    for k, v in jm.state_dict().items():
        shape = tuple(v.shape)
        sd[k] = ((1 + 0.1 * rng.standard_normal(shape)) if k.endswith(
            ("ln1", "ln2", "norm.weight"))
            else 0.05 * rng.standard_normal(shape)).astype(np.float32)
    jm.set_state_dict({k: jp.to_tensor(a) for k, a in sd.items()})
    cfg = GPTConfig(**kw)
    tm = GPTForCausalLMPipe(cfg, device="cpu")
    tm.load_state_dict(pipe_state_dict_from_jax(sd, cfg))
    return jm, tm


def test_depth2_pipe_predictor_matches_jax_pipe(tmp_path):
    jm, tm = _pipe_pair()
    ids = np.random.default_rng(9).integers(0, 512, (2, 128))
    want = np.asarray(jm(jp.to_tensor(ids.astype(np.int32))).numpy())
    prefix = str(tmp_path / "pipe")
    tp.jit.save(tm, prefix, input_spec=[InputSpec([None, 128], "int64",
                                                  name="input_ids")])
    pred = _cpu_predictor(prefix)
    got = pred.run([ids])[0]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    # the program holds the port's custom ops, not their plain bodies
    code = pred._exported.code
    assert "paddle_tpu_torch.rms_norm" in code
    assert "paddle_tpu_torch.swiglu_down" in code
    assert "paddle_tpu_torch.flash_fwd" in code
    one = pred.run([ids[:1]])[0]
    np.testing.assert_allclose(one.numpy(), want[:1], atol=1e-4, rtol=1e-4)


def test_hapi_predict_and_translated_layer_agree(tmp_path):
    """``Model.save(training=False)`` over declared inputs: the
    TranslatedLayer and a Predictor equal ``Model.predict_batch``."""
    net = _tiny(tp)
    model = tp.Model(net, inputs=[InputSpec([None, 4], "float32")])
    prefix = str(tmp_path / "hapi")
    model.save(prefix, training=False)
    x = _x(5, 4, seed=3)
    want = model.predict_batch([tp.to_tensor(x)]).numpy()
    np.testing.assert_allclose(tp.jit.load(prefix)(x).numpy(), want,
                               atol=1e-6)
    np.testing.assert_allclose(_cpu_predictor(prefix).run([x])[0].numpy(),
                               want, atol=1e-6)
