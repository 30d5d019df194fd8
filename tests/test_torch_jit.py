"""The port's ``jit.functional_call``, ``jit.to_static`` and
``FLAGS_check_nan_inf`` against the JAX package.

``functional_call`` and ``to_static`` outputs equal the JAX package's at
1e-5 on a small Paddle-surface Layer carried across by
``convert.layer_state_from_numpy``; the guard cases of
``tests/test_to_static_guards.py`` hold on the port (retrace on a shape,
dtype or train/eval change, value guards, a graph break that warns once
and equals eager, bucketed lengths sharing programs with the JAX
package's program counts); ``tests/test_check_nan_inf.py``'s contract
holds eagerly and through ``TrainStep``, where a refused step changes no
byte of a parameter or slot.
"""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.static import InputSpec as JaxInputSpec
from paddle_tpu.utils.flags import set_flags as jax_set_flags
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.convert import layer_state_from_numpy
from paddle_tpu_torch.static import InputSpec
from paddle_tpu_torch.utils.flags import set_flags
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


def _mlp(p):
    class MLP(p.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = p.nn.Linear(8, 16)
            self.norm = p.nn.LayerNorm(16)
            self.fc2 = p.nn.Linear(16, 4)

        def forward(self, x):
            return self.fc2(p.tanh(self.norm(self.fc1(x))))

    return MLP()


def _carried_pair():
    jl, tl = _mlp(jp), _mlp(tp)
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    assert list(state) == list(tl.state_dict())
    layer_state_from_numpy(state, tl)
    return jl, tl, state


# -- functional_call and to_static against the JAX package ------------------
def test_functional_call_matches_jax():
    jl, tl, state = _carried_pair()
    rng = np.random.RandomState(1)
    other = {k: (v + 0.1 * rng.randn(*v.shape)).astype(np.float32)
             for k, v in state.items()}
    x = _x(3, 8)
    jout, jmut = jp.jit.functional_call(
        jl, {k: jp.to_tensor(v)._data for k, v in other.items()},
        jp.to_tensor(x)._data)
    tout, tmut = tp.jit.functional_call(
        tl, {k: torch.from_numpy(v) for k, v in other.items()},
        torch.from_numpy(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=TOL,
                               rtol=TOL)
    assert sorted(tmut) == sorted(jmut)
    # the Layer's own payloads are back after the call
    for k, v in tl.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), state[k])


def test_to_static_matches_jax_and_eager():
    jl, tl, _ = _carried_pair()
    js, ts = jp.jit.to_static(jl), tp.jit.to_static(tl)
    for seed, b in ((2, 3), (3, 5)):
        x = _x(b, 8, seed=seed)
        want = np.asarray(js(jp.to_tensor(x)).numpy())
        got = ts(tp.to_tensor(x))
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
        np.testing.assert_array_equal(got.numpy(),
                                      tl(tp.to_tensor(x)).numpy())
    assert len(ts._static._compiled) == len(js._static._compiled) == 2
    assert ts._segment_stats["segments"] == 1


def test_to_static_function_and_decorator():
    calls = []

    @tp.jit.to_static
    def f(x, y):
        calls.append(1)
        return tp.matmul(x, y) + 1.0

    a, b = _x(4, 3), _x(3, 2, seed=1)
    out = f(tp.to_tensor(a), tp.to_tensor(b))
    np.testing.assert_allclose(out.numpy(), a @ b + 1.0, atol=TOL)
    assert isinstance(f, tp.jit.StaticFunction) and len(f._compiled) == 1


def test_to_static_trains_through_the_program():
    """Autograd is torch's: a to_static Layer trains as its eager self."""
    jl, tl, state = _carried_pair()
    ts = tp.jit.to_static(tl)
    twin = _mlp(tp)
    layer_state_from_numpy(state, twin)
    x = tp.to_tensor(_x(6, 8, seed=4))
    for m in (ts, twin):
        (m(x) ** 2).sum().backward()
    for (n, p), q in zip(tl.named_parameters(), twin.parameters()):
        np.testing.assert_allclose(p.grad.numpy(), q.grad.numpy(),
                                   atol=1e-6, err_msg=n)


# -- the guard cases of tests/test_to_static_guards.py ----------------------
class _Counted:
    """The backend's captures of one StaticFunction (each is a trace)."""

    def __init__(self, static):
        self.n = 0
        real = static._backend

        def backend(gm, example_inputs):
            self.n += 1
            return real(gm, example_inputs)

        static._backend = backend


def test_shape_and_dtype_change_retrace():
    class Net(tp.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = tp.nn.Linear(4, 2)

        def forward(self, x):
            return self.fc(x)

    model = tp.jit.to_static(Net())
    model.eval()
    traces = _Counted(model._static)
    a, b = tp.randn([2, 4]), tp.randn([5, 4])
    model(a)
    first = traces.n
    model(a)
    assert traces.n == first, "same signature must not retrace"
    out = model(b)
    assert traces.n > first and tuple(out.shape) == (5, 2)
    n = traces.n
    model(b)
    assert traces.n == n
    assert len(model._static._compiled) == 2
    # a dtype change retraces too (the port's Linear takes one dtype, so
    # a function carries it)
    fn = tp.jit.to_static(lambda x: x * 2.0)
    ftraces = _Counted(fn)
    fn(a)
    out64 = fn(a.astype("float64"))
    assert out64.dtype == tp.float64 and ftraces.n == 2
    assert len(fn._compiled) == 2


def test_train_eval_mode_guard():
    model = tp.jit.to_static(tp.nn.Sequential(tp.nn.Linear(4, 4),
                                              tp.nn.Dropout(0.5)))
    x = tp.randn([3, 4])
    model.train()
    model(x)
    model.eval()
    out1, out2 = model(x), model(x)
    np.testing.assert_array_equal(out1.numpy(), out2.numpy())
    assert len(model._static._compiled) == 2


def test_layer_attribute_and_closure_value_guards():
    class Gated(tp.nn.Layer):
        def __init__(self):
            super().__init__()
            self.lin = tp.nn.Linear(4, 4)
            self.use_double = False

        def forward(self, x):
            h = self.lin(x)
            if self.use_double:
                h = h * 2.0
            return h

    m = Gated()
    st = tp.jit.to_static(m)
    x = tp.to_tensor(np.ones((2, 4), np.float32))
    base = st(x).numpy()
    m.use_double = True
    np.testing.assert_allclose(st(x).numpy(), base * 2.0, rtol=1e-6)
    m.use_double = False
    np.testing.assert_allclose(st(x).numpy(), base, rtol=1e-6)
    assert len(st._static._compiled) == 2

    scale = 2.0

    def fn(x):
        return x * scale

    sf = tp.jit.to_static(fn)
    y = tp.to_tensor(np.ones((2,), np.float32))
    np.testing.assert_allclose(sf(y).numpy(), 2.0)
    scale = 5.0
    np.testing.assert_allclose(sf(y).numpy(), 5.0)


def _branchy(p):
    class Branchy(p.nn.Layer):
        def __init__(self):
            super().__init__()
            self.pre = p.nn.LayerList([p.nn.Linear(16, 16) for _ in range(4)])
            self.post = p.nn.LayerList([p.nn.Linear(16, 16)
                                        for _ in range(4)])

        def forward(self, x):
            for lay in self.pre:
                x = p.nn.functional.relu(lay(x))
            if float(x.mean()) > 0:          # a host branch on data
                x = x * 2.0
            for lay in self.post:
                x = p.nn.functional.relu(lay(x))
            return x

    return Branchy()


def test_graph_break_warns_once_and_equals_eager():
    layer = _branchy(tp)
    model = tp.jit.to_static(layer)
    rng = np.random.RandomState(2)
    xs = [tp.to_tensor(rng.randn(2, 16).astype(np.float32) + s)
          for s in (3.0, -3.0, 3.0)]
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        outs = [model(x) for x in xs]
    breaks = [m for m in w if "graph break" in str(m.message)]
    assert len(breaks) == 1, [str(m.message) for m in w]
    for x, out in zip(xs, outs):
        np.testing.assert_array_equal(out.numpy(), layer(x).numpy())
    stats = model._segment_stats
    assert stats["segments"] >= 2 and stats["ops"] >= 1, stats


def test_graph_break_layer_still_trains():
    layer = _branchy(tp)
    model = tp.jit.to_static(layer)
    opt = tp.optimizer.SGD(learning_rate=5e-3,
                           parameters=model.parameters())
    x = tp.to_tensor(np.random.RandomState(3).randn(4, 16)
                     .astype(np.float32))
    losses = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(8):
            loss = (model(x) ** 2).sum()
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("lengths,want", [((5, 6, 7), 1), ((5, 6, 7, 9), 2)])
def test_bucketed_lengths_share_programs_like_jax(lengths, want):
    """Power-of-two buckets: the same program counts as the JAX
    package's, the padded rows zero."""
    counts = []
    for p, spec in ((jp, JaxInputSpec), (tp, InputSpec)):
        fn = p.jit.to_static(lambda x: x * 2.0,
                             input_spec=[spec([None, 4], "float32")],
                             bucket_dynamic_shapes=True)
        for n in lengths:
            out = fn(p.to_tensor(np.ones((n, 4), np.float32)))
            assert out.shape[0] == (8 if n <= 8 else 16)
            np.testing.assert_allclose(np.asarray(out.numpy())[:n], 2.0)
            np.testing.assert_allclose(np.asarray(out.numpy())[n:], 0.0)
        counts.append(len(fn._compiled))
    assert counts == [want, want]


def test_without_buckets_each_shape_retraces_like_jax():
    counts = []
    for p, spec in ((jp, JaxInputSpec), (tp, InputSpec)):
        fn = p.jit.to_static(lambda x: x + 1.0,
                             input_spec=[spec([None, 4], "float32")])
        for n in (5, 6, 7):
            fn(p.to_tensor(np.ones((n, 4), np.float32)))
        counts.append(len(fn._compiled))
    assert counts == [3, 3]


def test_bucketing_named_kwargs_and_refusal():
    class Net(tp.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = tp.nn.Linear(4, 4)

        def forward(self, x, mask=None):
            out = self.fc(x)
            return out * mask if mask is not None else out

    model = tp.jit.to_static(
        Net(), input_spec=[InputSpec([None, 4], "float32", name="x"),
                           InputSpec([None, 4], "float32", name="mask")],
        bucket_dynamic_shapes=True)
    rng = np.random.RandomState(0)
    for n in (5, 7, 8, 6):
        model(tp.to_tensor(rng.randn(n, 4).astype(np.float32)),
              mask=tp.to_tensor(np.ones((n, 4), np.float32)))
    assert len(model._static._compiled) == 1
    with pytest.raises(ValueError, match="NAMED InputSpec"):
        model(tp.to_tensor(rng.randn(4, 4).astype(np.float32)),
              other=tp.to_tensor(np.ones((4, 4), np.float32)))


def test_program_cache_is_capped():
    st = tp.jit.to_static(lambda x: x * 3.0)
    for n in range(1, 36):
        st(tp.to_tensor(np.ones((n,), np.float32)))
    assert len(st._compiled) == st._compiled_cap == 32


def test_enable_to_static_and_not_to_static():
    st = tp.jit.to_static(lambda x: x + 1.0)
    traces = _Counted(st)
    tp.jit.enable_to_static(False)
    try:
        np.testing.assert_allclose(st(tp.ones([2])).numpy(), 2.0)
        assert traces.n == 0 and not st._compiled
    finally:
        tp.jit.enable_to_static(True)
    helper = tp.jit.not_to_static(lambda x: x * 2.0)
    sf = tp.jit.to_static(lambda x: helper(x) + 1.0)
    np.testing.assert_allclose(sf(tp.ones([2])).numpy(), 3.0)


def test_capture_reports_to_the_recompile_watchdog():
    from paddle_tpu_torch import telemetry

    telemetry.enable()
    try:
        before = telemetry.snapshot()
        st = tp.jit.to_static(lambda x: x - 1.0)
        st(tp.ones([3]))
        after = telemetry.snapshot()
    finally:
        telemetry.disable()
    assert after != before


def test_only_the_outermost_call_records_its_spec_as_jax():
    """As the reference's ``Layer.__call__``: the outermost call records
    its inputs' spec, a sublayer called inside it records none, and a
    forward that raised leaves the next outermost call recording."""
    for p in (jp, tp):
        m = _mlp(p)
        m(p.to_tensor(_x(2, 8)))
        assert m._last_call_spec == (((2, 8), "float32"),)
        assert not hasattr(m.fc1, "_last_call_spec")
        with pytest.raises(Exception):
            m(p.to_tensor(_x(2, 5)))          # fc1 refuses 5 features
        m(p.to_tensor(_x(3, 8)))
        assert m._last_call_spec == (((3, 8), "float32"),)
        assert not hasattr(m.norm, "_last_call_spec")


# -- FLAGS_check_nan_inf (tests/test_check_nan_inf.py's contract) -----------
@pytest.fixture
def nan_checks():
    tp.set_flags({"FLAGS_check_nan_inf": True})
    yield
    tp.set_flags({"FLAGS_check_nan_inf": False})


def test_flags_registry_matches_jax():
    for name in ("check_nan_inf", "benchmark", "use_pallas_kernels"):
        assert (tp.get_flags(f"FLAGS_{name}")
                == jp.get_flags(f"FLAGS_{name}"))
    set_flags({"FLAGS_benchmark": True})
    jax_set_flags({"FLAGS_benchmark": True})
    try:
        assert tp.get_flags("benchmark") == jp.get_flags("benchmark") == {
            "benchmark": True}
    finally:
        set_flags({"FLAGS_benchmark": False})
        jax_set_flags({"FLAGS_benchmark": False})


@pytest.mark.parametrize("op,arg", [("divide", 0.0), ("log", -1.0)])
def test_eager_bad_op_raises_with_its_name(nan_checks, op, arg):
    x = tp.to_tensor(np.full((4,), arg, np.float32))
    with pytest.raises(FloatingPointError, match=op):
        tp.divide(x, x) if op == "divide" else tp.log(x)


def test_eager_finite_ops_pass(nan_checks):
    x = tp.to_tensor(np.ones((4,), np.float32))
    assert np.isfinite(tp.exp(tp.add(x, x)).numpy()).all()


def test_flag_off_gives_nan_silently():
    x = tp.to_tensor(np.zeros((4,), np.float32))
    assert np.isnan(tp.divide(x, x).numpy()).all()


def _nan_step():
    model = tp.nn.Linear(4, 4)
    opt = tp.optimizer.Adam(learning_rate=0.1,
                            parameters=model.parameters())

    def train_fn(x, y):
        return tp.log(model(x).sum() - y.sum())   # log of a negative

    return model, opt, tp.jit.TrainStep(model, train_fn, opt)


def test_train_step_raises_and_changes_no_byte(nan_checks):
    model, opt, step = _nan_step()
    for p in model.parameters():
        p.set_value(tp.to_tensor(np.full(p.shape, 2.0, np.float32)))
    x = tp.to_tensor(np.ones((2, 4), np.float32))
    step(x, tp.to_tensor(np.zeros((2, 4), np.float32)))   # finite: slots
    params = [p.numpy().copy() for p in model.parameters()]
    slots = {k: v.clone() for k, v in opt.state_dict().items()
             if isinstance(v, torch.Tensor)}
    steps = opt._step_count
    with pytest.raises(FloatingPointError, match="aten.log"):
        step(x, tp.to_tensor(np.full((2, 4), 1e3, np.float32)))
    for a, p in zip(params, model.parameters()):
        np.testing.assert_array_equal(p.numpy(), a)
    for k, v in opt.state_dict().items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, slots[k]), k
    assert opt._step_count == steps


def test_train_step_first_step_refused_leaves_no_slots(nan_checks):
    model, opt, step = _nan_step()
    for p in model.parameters():
        p.set_value(tp.to_tensor(np.zeros(p.shape, np.float32)))
    x = tp.to_tensor(np.ones((2, 4), np.float32))
    with pytest.raises(FloatingPointError):
        step(x, tp.to_tensor(np.full((2, 4), 10.0, np.float32)))
    assert not any(opt.state.get(p._data) for p in model.parameters())
    assert all((p.numpy() == 0).all() for p in model.parameters())


def test_train_step_passes_when_finite_and_matches_jax(nan_checks):
    """A finite checked step equals the JAX package's checkified one."""
    jax_set_flags({"FLAGS_check_nan_inf": True})
    try:
        losses = []
        for p in (jp, tp):
            model = p.nn.Linear(4, 4)
            for q in model.parameters():
                q.set_value(p.to_tensor(np.full(q.shape, 2.0, np.float32)))
            opt = p.optimizer.SGD(learning_rate=0.1,
                                  parameters=model.parameters())
            step = p.jit.TrainStep(
                model, lambda x, y, m=model, p=p: p.log(m(x).sum() - y.sum()),
                opt)
            losses.append(float(step(
                p.to_tensor(np.ones((2, 4), np.float32)),
                p.to_tensor(np.zeros((2, 4), np.float32))).numpy()))
    finally:
        jax_set_flags({"FLAGS_check_nan_inf": False})
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)
