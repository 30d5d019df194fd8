"""The surface's small rest (A.13 (f)) against the JAX package: the
top-level functions (``set_printoptions``, ``disable_signal_handler``,
``get_cuda_rng_state``/``set_cuda_rng_state``, ``LazyGuard``, ``batch``,
``get_flags``/``set_flags``), the in-place ``addmm_``, ``ldexp_`` and
``masked_scatter_``, ``nn.utils``, ``device.cuda``, ``utils.unique_name``,
``version``, ``sysconfig``, ``incubate.optimizer.functional``,
``incubate.distributed.fleet``'s recompute wrappers and ``flops`` (held
against hand-counted layers: the reference's raises). A ``dir()`` test
holds the port's top level against ``dir(paddle_tpu)`` minus a named
list.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.convert import layer_state_from_numpy
from test_torch_threads import one_intra_op_thread  # noqa: F401

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    prev = (getattr(tdevice._state, "device", None),
            getattr(tdevice._state, "place", None))
    tp.set_device("cpu")
    yield
    tdevice._state.device, tdevice._state.place = prev


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


#: public names of ``paddle_tpu`` the port's top level does not have, each
#: with its reason
NOT_ON_THE_PORT = {
    # the JAX package's own imports and helpers its star imports leak
    "jax": "import", "jnp": "import", "builtins_sum": "helper",
    "digamma_fn": "helper", "exponent_bias": "helper",
    "inner_alias": "helper",
    # queued in ROADMAP §A
    "DataParallel": "A.10",
    # left out on purpose (no network; no ONNX export)
    "hub": "download", "onnx": "needs paddle2onnx",
}


def test_top_level_names_against_jax():
    theirs = {n for n in dir(jp) if not n.startswith("_")}
    ours = {n for n in dir(tp) if not n.startswith("_")}
    assert theirs - ours == set(NOT_ON_THE_PORT)


_IMPORT = "the JAX package's own import"
#: per module, public names of the JAX package's module the port's lacks,
#: each with its reason
NOT_IN_THE_PORTS_MODULE = {
    "device": {"jax": _IMPORT, "os": _IMPORT,
               "jax_device_for": "JAX-only: maps a Place to a jax.Device"},
    "incubate.optimizer": {},
    "nn.clip": {"jnp": _IMPORT},
    "nn.functional": {
        "Tensor": _IMPORT, "annotations": _IMPORT, "apply_op": _IMPORT,
        "framework": _IMPORT, "jax": _IMPORT, "jnp": _IMPORT,
        "math": _IMPORT, "np": _IMPORT,
        "sharded_lm_loss_arrays": "A.10 (the vocab-sharded head)"},
    "nn.functional.fused_cross_entropy": {
        "functools": _IMPORT, "jax": _IMPORT, "jnp": _IMPORT, "os": _IMPORT,
        "sharded_lm_loss_arrays": "A.10 (the vocab-sharded head)"},
    "models.gpt": {"FF": _IMPORT, "jax": _IMPORT, "os": _IMPORT,
                   "paddle": _IMPORT,
                   "scan_layers_enabled": "JAX-only: jax.lax.scan switch"},
    "testing": {},
    "incubate.distributed.models.moe": {
        "Tensor": _IMPORT, "apply_op": _IMPORT, "jax": _IMPORT,
        "jnp": _IMPORT, "paddle": _IMPORT},
    "incubate.distributed.models.moe.gate": {},
    "incubate.nn.functional": {"jax": _IMPORT, "jnp": _IMPORT},
    "incubate.nn.functional.fp8": {"annotations": _IMPORT,
                                   "apply_op": _IMPORT, "jnp": _IMPORT},
    "nn": {},
    "incubate": {},
    "nn.quant": {"jnp": _IMPORT},
    "quantization": {"jax": _IMPORT, "jnp": _IMPORT},
    "quantization.observers": {},
    "quantization.quanters": {},
    "incubate.asp": {"jnp": _IMPORT},
    "incubate.autograd": {},
}


@pytest.mark.parametrize("module", sorted(NOT_IN_THE_PORTS_MODULE))
def test_module_names_against_jax(module):
    import importlib

    theirs = importlib.import_module("paddle_tpu." + module)
    ours = importlib.import_module("paddle_tpu_torch." + module)
    missing = ({n for n in dir(theirs) if not n.startswith("_")}
               - {n for n in dir(ours) if not n.startswith("_")})
    assert missing == set(NOT_IN_THE_PORTS_MODULE[module])


def test_set_printoptions_and_small_functions():
    try:
        tp.set_printoptions(precision=3, sci_mode=False)
        assert torch._tensor_str.PRINT_OPTS.precision == 3
        assert np.get_printoptions()["precision"] == 3
    finally:
        tp.set_printoptions(precision=8, sci_mode=None)
        torch.set_printoptions(profile="default")
        np.set_printoptions(precision=8, suppress=False)
    assert tp.disable_signal_handler() is None
    assert tp.is_grad_enabled_() is True
    with tp.LazyGuard() as g:
        layer = tp.nn.Linear(2, 3)
    assert isinstance(g, tp.LazyGuard) and layer.weight.shape == [2, 3]
    assert tp.pstring == jp.pstring and tp.raw == jp.raw
    assert tp.__version__ == tp.version.full_version


def test_cuda_rng_state_round_trip():
    state = tp.get_cuda_rng_state()
    a = tp.randn([4]).numpy()
    tp.set_cuda_rng_state(state)
    np.testing.assert_array_equal(tp.randn([4]).numpy(), a)


@pytest.mark.parametrize("drop_last", [False, True])
def test_batch_like_jax(drop_last):
    def reader():
        yield from range(7)

    want = list(jp.batch(reader, 3, drop_last)())
    assert list(tp.batch(reader, 3, drop_last)()) == want


def test_inplace_rest_like_jax():
    a, b, c = _x(3, 4), _x(3, 5, seed=1), _x(5, 4, seed=2)
    e = np.array([[1, 0, -1, 2]] * 3, np.float32)
    mask = _x(3, 4, seed=3) > 0
    vals = _x(12, seed=4)
    for p in (jp, tp):
        x = p.to_tensor(a)
        y = x.addmm_(p.to_tensor(b), p.to_tensor(c), beta=0.5, alpha=2.0)
        assert y is x
        z = p.to_tensor(a)
        z.ldexp_(p.to_tensor(e))
        w = p.to_tensor(a)
        w.masked_scatter_(p.to_tensor(mask), p.to_tensor(vals))
        if p is jp:
            want = [np.asarray(t.numpy()) for t in (x, z, w)]
        else:
            for t, ref in zip((x, z, w), want):
                np.testing.assert_allclose(t.numpy(), ref, atol=TOL,
                                           rtol=TOL)
    assert tp.addmm_ and tp.ldexp_ and tp.masked_scatter_


# -- nn.utils -------------------------------------------------------------
def _carried_linear(seed=0):
    jl, tl = jp.nn.Linear(6, 5), tp.nn.Linear(6, 5)
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    rng = np.random.RandomState(seed)
    state = {k: (v + 0.3 * rng.randn(*v.shape)).astype(np.float32)
             for k, v in state.items()}
    jl.set_state_dict(state)
    layer_state_from_numpy(state, tl)
    return jl, tl


@pytest.mark.parametrize("dim", [0, 1])
def test_weight_norm_like_jax_and_trains_g_and_v(dim):
    jl, tl = _carried_linear()
    jp.nn.utils.weight_norm(jl, dim=dim)
    tp.nn.utils.weight_norm(tl, dim=dim)
    x = _x(4, 6, seed=5)
    np.testing.assert_allclose(tl(tp.to_tensor(x)).numpy(),
                               np.asarray(jl(jp.to_tensor(x)).numpy()),
                               atol=TOL, rtol=TOL)
    for n in ("weight_g", "weight_v"):
        np.testing.assert_allclose(
            getattr(tl, n).numpy(), np.asarray(getattr(jl, n).numpy()),
            atol=TOL, rtol=TOL)
    (tl(tp.to_tensor(x)) ** 2).sum().backward()
    assert tl.weight_g.grad is not None and tl.weight_v.grad is not None
    tp.nn.utils.remove_weight_norm(tl)
    jp.nn.utils.remove_weight_norm(jl)
    np.testing.assert_allclose(tl.weight.numpy(),
                               np.asarray(jl.weight.numpy()), atol=TOL)
    assert "weight_g" not in dict(tl.named_parameters())


def test_spectral_norm_like_jax():
    jl, tl = _carried_linear(seed=1)
    jp.nn.utils.spectral_norm(jl, n_power_iterations=2)
    tp.nn.utils.spectral_norm(tl, n_power_iterations=2)
    x = _x(4, 6, seed=6)
    for _ in range(3):                 # u and v refine at every call
        np.testing.assert_allclose(
            tl(tp.to_tensor(x)).numpy(),
            np.asarray(jl(jp.to_tensor(x)).numpy()), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tl.weight_u.numpy(),
                               np.asarray(jl.weight_u.numpy()), atol=TOL)
    (tl(tp.to_tensor(x)) ** 2).sum().backward()
    assert tl.weight_orig.grad is not None


def test_spectral_norm_layer_normalizes():
    """``tests/test_nn_compat.py:120`` on the port."""
    w = tp.randn([8, 4]) * 3.0
    out = tp.nn.SpectralNorm([8, 4], power_iters=20)(w)
    s = np.linalg.svd(out.numpy(), compute_uv=False)
    np.testing.assert_allclose(s[0], 1.0, atol=1e-2)


def test_parameters_vector_and_clip_value_like_jax():
    jl, tl = _carried_linear(seed=2)
    jv = jp.nn.utils.parameters_to_vector(jl.parameters())
    tv = tp.nn.utils.parameters_to_vector(tl.parameters())
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv.numpy()))
    new = np.arange(tv.shape[0], dtype=np.float32)
    jp.nn.utils.vector_to_parameters(jp.to_tensor(new), jl.parameters())
    tp.nn.utils.vector_to_parameters(tp.to_tensor(new), tl.parameters())
    for (n, a), b in zip(tl.named_parameters(), jl.parameters()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b.numpy()),
                                      err_msg=n)
    (tl(tp.to_tensor(_x(3, 6))) ** 2).sum().backward()
    before = tp.nn.utils.clip_grad_norm_(tl.parameters(), 1e9)
    assert float(before) > 0.5
    tp.nn.utils.clip_grad_value_(tl.parameters(), 0.5)
    assert max(float(p.grad.abs().max()) for p in tl.parameters()) <= 0.5


# -- device.cuda, unique_name, version, sysconfig, flags --------------------
def test_device_cuda_answers_for_torch_cuda():
    import paddle_tpu.device.cuda as jcuda

    cuda = tp.device.cuda
    assert cuda.device_count() == torch.cuda.device_count()
    assert isinstance(cuda.memory_allocated(), int)
    assert isinstance(cuda.max_memory_reserved(), int)
    cuda.empty_cache()
    assert set(jcuda.__all__) == set(cuda.__all__)


def test_unique_name_like_jax():
    from paddle_tpu.utils import unique_name as ju

    tu = tp.utils.unique_name
    with ju.guard(), tu.guard():
        want = [ju.generate("fc"), ju.generate("fc"), ju.generate("conv")]
        assert [tu.generate("fc"), tu.generate("fc"),
                tu.generate("conv")] == want
    tu.switch()
    assert tu.generate("x") == "x_0"


def test_version_and_sysconfig():
    from pathlib import Path

    for field in ("full_version", "major", "minor", "patch", "rc",
                  "istaged", "commit", "with_mkl"):
        assert hasattr(tp.version, field) and hasattr(jp.version, field)
    assert tp.version.cuda() == (str(torch.version.cuda)
                                 if torch.version.cuda else "False")
    assert list(Path(tp.sysconfig.get_include()).glob("*.cu"))
    assert tp.sysconfig.get_lib().endswith("kernels")


def test_flags_round_trip():
    assert tp.get_flags(["FLAGS_check_nan_inf"]) == {
        "FLAGS_check_nan_inf": False}
    tp.set_flags({"FLAGS_new_flag_for_test": 3})
    assert tp.get_flags("new_flag_for_test") == {"new_flag_for_test": 3}


# -- incubate.optimizer.functional and incubate.distributed.fleet ---------
def _quadratic(p):
    a = np.diag(np.array([1.0, 4.0, 9.0], np.float32))
    b = np.array([1.0, -2.0, 3.0], np.float32)
    ta, tb = p.to_tensor(a), p.to_tensor(b)

    def f(x):
        return 0.5 * (x * p.matmul(ta, x)).sum() - (tb * x).sum()

    return f, np.linalg.solve(a, b)


@pytest.mark.parametrize("name", ["minimize_bfgs", "minimize_lbfgs"])
def test_quasi_newton_like_jax(name):
    res = {}
    for p in (jp, tp):
        from importlib import import_module

        mod = import_module(f"{p.__name__}.incubate.optimizer.functional")
        f, sol = _quadratic(p)
        res[p.__name__] = getattr(mod, name)(
            f, p.to_tensor(np.zeros(3, np.float32)), max_iters=50)
    j, t = res["paddle_tpu"], res["paddle_tpu_torch"]
    assert t[0] is True and t[1] > 0
    np.testing.assert_allclose(t[2].numpy(), sol, atol=1e-4)
    np.testing.assert_allclose(t[2].numpy(), np.asarray(j[2].numpy()),
                               atol=1e-4)
    np.testing.assert_allclose(float(t[3]), float(j[3].numpy()), atol=1e-5)
    assert float(t[4].abs().max()) < 1e-3


@pytest.mark.parametrize("segments", [1, 2])
def test_recompute_sequential_equals_the_plain_run(segments):
    from paddle_tpu_torch.incubate.distributed.fleet import (
        recompute_hybrid, recompute_sequential)

    tp.seed(3)
    layers = tp.nn.Sequential(tp.nn.Linear(8, 8), tp.nn.Tanh(),
                              tp.nn.Linear(8, 8), tp.nn.Tanh())
    x = tp.to_tensor(_x(4, 8, seed=7), stop_gradient=False)
    grads = []
    for run in (lambda: layers(x),
                lambda: recompute_sequential({"segments": segments},
                                             layers, x),
                lambda: recompute_hybrid({}, layers, x)):
        out = run()
        (out ** 2).sum().backward()
        grads.append([out.numpy()] + [p.grad.numpy().copy()
                                      for p in layers.parameters()]
                     + [x.grad.numpy().copy()])
        for p in layers.parameters():
            p.clear_grad()
        x.clear_grad()
    for got in grads[1:]:
        for a, b in zip(got, grads[0]):
            np.testing.assert_allclose(a, b, atol=1e-6)


def test_recompute_sequential_forward_like_jax():
    from paddle_tpu.incubate.distributed.fleet import \
        recompute_sequential as jrs
    from paddle_tpu_torch.incubate.distributed.fleet import \
        recompute_sequential as trs

    jl, tl = _carried_linear(seed=3)
    x = _x(2, 6, seed=8)
    np.testing.assert_allclose(
        trs({"segments": 1}, [tl], tp.to_tensor(x)).numpy(),
        np.asarray(jrs({"segments": 1}, [jl], jp.to_tensor(x)).numpy()),
        atol=TOL)


# -- flops ----------------------------------------------------------------
def test_flops_against_hand_counted_layers(capsys):
    net = tp.nn.Sequential(
        tp.nn.Conv2D(3, 8, 3, padding=1), tp.nn.BatchNorm2D(8),
        tp.nn.ReLU(), tp.nn.AvgPool2D(2), tp.nn.Flatten(),
        tp.nn.Linear(8 * 4 * 4, 10))
    conv = (8 * 8 * 8) * (3 * 3 * 3 + 1)      # numel(y) * (Cin k k + bias)
    bn = 2 * (8 * 8 * 8)                      # 2 * numel(x)
    pool = 8 * 4 * 4                          # numel(y)
    linear = 128 * 10                         # in_features * numel(y)
    assert tp.flops(net, [1, 3, 8, 8], print_detail=True) == (
        conv + bn + pool + linear)
    assert "Total Flops" in capsys.readouterr().out
    assert tp.flops(net, [2, 3, 8, 8]) == 2 * (conv + bn + pool + linear)
    custom = {tp.nn.ReLU: lambda m, x, y: int(np.prod(y.shape))}
    assert tp.flops(net, [1, 3, 8, 8], custom_ops=custom) == (
        conv + bn + pool + linear + 8 * 8 * 8)
    assert net.training


def test_reference_flops_raises():
    """The reference's ``flops`` imports a module it lacks (ROADMAP §C)."""
    with pytest.raises(ModuleNotFoundError):
        jp.flops(jp.nn.Linear(2, 2), [1, 2])


# -- the names A.13 (g) added ---------------------------------------------
def test_device_queries_answer_for_the_card():
    """The reference's TPU answers None and True; the port's answers are
    torch's (a deliberate difference)."""
    assert tp.device.get_cudnn_version() == torch.backends.cudnn.version()
    assert jp.device.get_cudnn_version() is None
    assert (tp.device.is_compiled_with_distribute()
            == torch.distributed.is_available())
    for name in ("is_compiled_with_ipu", "is_compiled_with_cinn",
                 "is_compiled_with_custom_device",
                 "get_all_custom_device_type",
                 "get_available_custom_device"):
        assert getattr(tp.device, name)() == getattr(jp.device, name)()
    assert isinstance(tp.device.IPUPlace(), tp.device.IPUPlace)


def test_lbfgs_clip_base_and_submodules():
    from paddle_tpu_torch.incubate.distributed.models.moe import gate
    from paddle_tpu_torch.incubate.nn.functional import fp8

    assert tp.incubate.optimizer.LBFGS is tp.optimizer.LBFGS
    clips = (tp.nn.ClipGradByGlobalNorm(1.0), tp.nn.ClipGradByNorm(1.0),
             tp.nn.ClipGradByValue(1.0))
    assert all(isinstance(c, tp.nn.clip.ClipGradBase) for c in clips)

    class Halve(tp.nn.clip.ClipGradBase):
        def _dygraph_clip(self, params_grads):
            return [(p, g * 0.5) for p, g in params_grads]

    assert Halve()([(1, 4.0)]) == [(1, 2.0)]
    with pytest.raises(NotImplementedError):
        tp.nn.clip.ClipGradBase()([])
    assert gate.GShardGate is tp.incubate.distributed.models.moe.GShardGate
    assert fp8.fp8_gemm is tp.incubate.nn.functional.fp8_gemm


@pytest.mark.parametrize("size", ["tiny", "7b"])
def test_llama_config_like_jax(size):
    from paddle_tpu.models.gpt import llama_config as jcfg
    from paddle_tpu_torch.models.gpt import llama_config

    want = jcfg(size, max_seq_len=256)
    got = llama_config(size, max_seq_len=256)
    for k in ("hidden_size", "num_layers", "num_heads", "num_kv_heads",
              "vocab_size", "max_seq_len", "intermediate_size"):
        assert getattr(got, k) == getattr(want, k), k


def test_causal_lm_loss_is_the_models_loss():
    """``causal_lm_loss`` on a tiny Pipe with the JAX Pipe's seeded
    weights: the port's model's own loss, and the JAX package's
    ``causal_lm_loss`` on the same batch within f32 rounding."""
    from paddle_tpu.distributed import fleet
    from paddle_tpu.models.gpt import GPTConfig as JCfg
    from paddle_tpu.models.gpt import GPTForCausalLMPipe as JPipe
    from paddle_tpu.models.gpt import causal_lm_loss as jloss
    from paddle_tpu_torch.convert import pipe_state_dict_from_jax
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLMPipe,
                                             causal_lm_loss)

    fleet._reset_for_tests()
    cfg_kw = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
                  max_seq_len=16, dropout=0.0)
    jm = JPipe(JCfg(**cfg_kw))
    rng = np.random.default_rng(0)
    sd = {k: ((1.0 if k.endswith(("norm.weight", "ln1", "ln2")) else 0.0)
              + 0.2 * rng.standard_normal(tuple(v.shape))).astype(np.float32)
          for k, v in jm.state_dict().items()}
    jm.set_state_dict({k: jp.to_tensor(a) for k, a in sd.items()})
    cfg = GPTConfig(**cfg_kw)
    model = GPTForCausalLMPipe(cfg, device="cpu")
    model.load_state_dict(pipe_state_dict_from_jax(sd, cfg))
    ids, labels = (rng.integers(0, 64, (2, 8)) for _ in range(2))
    labels[1, :3] = -100
    got = causal_lm_loss(model, (torch.from_numpy(ids),
                                 torch.from_numpy(labels)))
    assert torch.equal(got, model.loss(torch.from_numpy(ids),
                                       torch.from_numpy(labels)))
    want = float(jloss(jm, (jp.to_tensor(ids.astype(np.int32)),
                            jp.to_tensor(labels))))
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


@pytest.mark.parametrize("transpose_y", [True, False])
def test_fused_chunked_cross_entropy_like_jax(transpose_y):
    from paddle_tpu.nn.functional import fused_cross_entropy as jfce
    from paddle_tpu_torch.nn.functional import fused_cross_entropy as tfce

    h, w = _x(2, 6, 16), _x(40, 16, seed=1) * 0.3
    w = w if transpose_y else np.ascontiguousarray(w.T)
    y = np.random.RandomState(2).randint(0, 40, (2, 6)).astype(np.int64)
    y[0, 1] = -100
    jh, th = jp.to_tensor(h, stop_gradient=False), tp.to_tensor(
        h, stop_gradient=False)
    jw, tw = jp.to_tensor(w, stop_gradient=False), tp.to_tensor(
        w, stop_gradient=False)
    kw = dict(transpose_y=transpose_y, vocab_chunk=16, int8=False)
    jl = jfce.fused_chunked_cross_entropy(jh, jw, jp.to_tensor(y), **kw)
    tl = tp.nn.functional.fused_chunked_cross_entropy(
        th, tw, tp.to_tensor(y), **kw)
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL)
    jl.backward()
    tl.backward()
    for a, b in ((th, jh), (tw, jw)):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b.grad.numpy()),
                                   atol=TOL, rtol=TOL)
    # int8=None resolves for x's device: f32 on the CPU
    np.testing.assert_allclose(float(tfce.fused_chunked_cross_entropy(
        th, tw, tp.to_tensor(y), transpose_y=transpose_y)), float(tl),
        rtol=TOL)
    with pytest.raises(NotImplementedError, match="A.10"):
        tfce.fused_chunked_cross_entropy(th, tw, tp.to_tensor(y),
                                         tp_axis="mp")


def test_chunked_ce_sum_like_jax():
    from paddle_tpu.nn.functional.fused_cross_entropy import (
        chunked_ce_sum as jsum)
    from paddle_tpu_torch.nn.functional.fused_cross_entropy import (
        chunked_ce_sum)

    h, w = _x(10, 16), _x(40, 16, seed=1) * 0.3
    y = np.random.RandomState(3).randint(0, 40, (10,)).astype(np.int32)
    mask = (np.arange(10) % 3 != 0).astype(np.float32)
    import jax.numpy as jnp

    want = float(jsum(jnp.asarray(h), jnp.asarray(w), jnp.asarray(y),
                      jnp.asarray(mask), vocab_chunk=16))
    got = float(chunked_ce_sum(torch.from_numpy(h), torch.from_numpy(w),
                               torch.from_numpy(y), torch.from_numpy(mask),
                               vocab_chunk=16))
    np.testing.assert_allclose(got, want, rtol=TOL)
