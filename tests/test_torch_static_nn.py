"""``paddle_tpu_torch.static.nn`` against the JAX package's: every layer
builder, sequence op and control-flow op is built under ``program_guard``
in both packages, the JAX program's parameters are drawn from numpy and
carried into the port's (``convert.program_params_from_numpy``, the
programs' parameter order), and both ``Executor``s replay on the same
numpy feeds: outputs within 1e-5 (1e-4 for the convolutions, whose sums
run in another order), f32.

Control flow is also held where the port parts from the reference on
purpose: a branch that reads a feed replays with the fed value (the
reference's ``lax.cond`` reads the Tensors a branch closes over as they
stood at build), against numpy; and the IR of a program with ``cond`` and
``while_loop`` holds them as higher-order ops that a serialized program
keeps.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu import static as jstatic
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.convert import program_params_from_numpy
from paddle_tpu_torch.ir import graph_targets
from test_torch_threads import one_intra_op_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _cpu():
    prev = (getattr(tdevice._state, "device", None),
            getattr(tdevice._state, "place", None))
    tp.set_device("cpu")
    yield
    tdevice._state.device, tdevice._state.place = prev


def _x(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _ints(*shape, high=10, seed=0):
    return np.random.RandomState(seed).randint(0, high, shape).astype(
        np.int64)


def _both(build, feeds, runs=None, tol=1e-5, seed=0):
    """``build(p, nn, vars) -> Tensor or list`` under ``program_guard`` in
    both packages; the JAX parameters drawn from numpy and carried over;
    each feed of ``runs`` (default ``[feeds]``) replayed in both. Returns
    the port's outputs, checked against the JAX package's."""
    runs = runs or [feeds]
    got = {}
    for p, st in ((jp, jstatic), (tp, tstatic)):
        main = st.Program()
        with st.program_guard(main, st.Program()):
            vs = {n: st.data(n, list(a.shape), str(a.dtype))
                  for n, a in feeds.items()}
            out = build(p, st.nn, vs)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        params = main.trainable_params()
        if p is jp:
            rng = np.random.RandomState(seed)
            arrays = [(0.5 * rng.randn(*q.shape)).astype(np.float32)
                      for q in params]
            for q, a in zip(params, arrays):
                q._data = jnp.asarray(a)
            exe = jstatic.Executor()
        else:
            assert [tuple(q.shape) for q in params] == [a.shape
                                                        for a in arrays]
            program_params_from_numpy(arrays, main)
            exe = tstatic.Executor(tp.CPUPlace())
        got[p] = [exe.run(main, feed=f, fetch_list=outs) for f in runs]
    for jr, tr in zip(got[jp], got[tp]):
        for j, t in zip(jr, tr):
            assert t.shape == np.asarray(j).shape
            np.testing.assert_allclose(t, np.asarray(j), rtol=tol, atol=tol)
    return got[tp]


CASES = {
    "fc": (lambda p, nn, v: [nn.fc(v["x"], 6, activation="relu"),
                             nn.fc(v["x"], 4, num_flatten_dims=2,
                                   bias_attr=False)],
           {"x": _x(4, 3, 5)}, 1e-5),
    "embedding": (lambda p, nn, v: nn.embedding(v["ids"], [10, 8]),
                  {"ids": _ints(4, 6)}, 1e-6),
    "sparse_embedding": (lambda p, nn, v: nn.sparse_embedding(v["ids"],
                                                              [10, 8]),
                         {"ids": _ints(4, 6)}, 1e-6),
    "batch_norm": (lambda p, nn, v: [nn.batch_norm(v["x"], act="relu"),
                                     nn.batch_norm(v["x"], is_test=True)],
                   {"x": _x(4, 3, 5, 5)}, 1e-5),
    "layer_norm": (lambda p, nn, v: [nn.layer_norm(v["x"]),
                                     nn.layer_norm(v["x"], scale=False,
                                                   shift=False,
                                                   begin_norm_axis=2)],
                   {"x": _x(4, 6, 8)}, 1e-5),
    "group_norm": (lambda p, nn, v: nn.group_norm(v["x"], 2),
                   {"x": _x(2, 4, 3, 3)}, 1e-5),
    "instance_norm": (lambda p, nn, v: nn.instance_norm(v["x"]),
                      {"x": _x(2, 3, 4, 4)}, 1e-5),
    "data_norm": (lambda p, nn, v: nn.data_norm(v["x"], act="relu"),
                  {"x": _x(6, 4)}, 1e-5),
    "conv2d": (lambda p, nn, v: nn.conv2d(v["x"], 4, 3, padding=1,
                                          act="relu"),
               {"x": _x(2, 3, 8, 8)}, 1e-4),
    "conv2d_groups": (lambda p, nn, v: nn.conv2d(v["x"], 4, [3, 1],
                                                 stride=2, groups=2),
                      {"x": _x(2, 4, 8, 8)}, 1e-4),
    "conv3d": (lambda p, nn, v: nn.conv3d(v["x"], 3, 3),
               {"x": _x(1, 2, 5, 5, 5)}, 1e-4),
    "conv2d_transpose": (lambda p, nn, v: nn.conv2d_transpose(
        v["x"], 3, filter_size=3, stride=2), {"x": _x(2, 4, 5, 5)}, 1e-4),
    "conv3d_transpose": (lambda p, nn, v: nn.conv3d_transpose(
        v["x"], 2, filter_size=2), {"x": _x(1, 2, 4, 4, 4)}, 1e-4),
    "deform_conv2d": (lambda p, nn, v: nn.deform_conv2d(
        v["x"], v["offset"], v["mask"], 3, 3, padding=1),
        {"x": _x(1, 2, 6, 6), "offset": _x(1, 18, 6, 6, seed=1, scale=0.5),
         "mask": np.abs(_x(1, 9, 6, 6, seed=2))}, 1e-4),
    "bilinear_tensor_product": (lambda p, nn, v: nn.bilinear_tensor_product(
        v["x"], v["y"], 6, act="tanh"),
        {"x": _x(4, 3), "y": _x(4, 5, seed=1)}, 1e-5),
    "prelu": (lambda p, nn, v: [nn.prelu(v["x"], mode)
                                for mode in ("all", "channel")],
              {"x": _x(2, 3, 4, 4)}, 1e-6),
    "spectral_norm": (lambda p, nn, v: [nn.spectral_norm(v["w"]),
                                        nn.spectral_norm(v["w"], dim=1,
                                                         power_iters=3)],
                      {"w": _x(4, 6)}, 1e-5),
    "nce": (lambda p, nn, v: nn.nce(v["h"], v["y"], 12, num_neg_samples=0),
            {"h": _x(5, 8), "y": _ints(5, 1, high=12)}, 1e-5),
    "row_conv": (lambda p, nn, v: nn.row_conv(v["x"], 2, act="relu"),
                 {"x": _x(2, 7, 4)}, 1e-5),
    "sequence_ops": (lambda p, nn, v: [
        nn.sequence_softmax(v["x"]), nn.sequence_first_step(v["x"]),
        nn.sequence_last_step(v["x"])] + [
        nn.sequence_pool(v["x"], t) for t in
        ("sum", "average", "max", "sqrt", "first", "last")],
        {"x": _x(2, 5, 3)}, 1e-5),
    "sequence_expand": (lambda p, nn, v: nn.sequence_expand(v["x"], v["y"]),
                        {"x": _x(2, 2, 3), "y": _x(2, 6, 3)}, 1e-6),
    "sequence_conv": (lambda p, nn, v: nn.sequence_conv(v["x"], 5, act="tanh"),
                      {"x": _x(2, 7, 4)}, 1e-5),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_builder_like_jax(name):
    build, feeds, tol = CASES[name]
    _both(build, feeds, tol=tol)


def test_nce_negatives_sampled_per_run():
    main = tstatic.Program()
    with tstatic.program_guard(main):
        h = tstatic.data("h", [5, 8])
        y = tstatic.data("y", [5, 1], "int64")
        loss = tstatic.nn.nce(h, y, 12, num_neg_samples=4)
    exe = tstatic.Executor(tp.CPUPlace())
    feed = {"h": _x(5, 8), "y": _ints(5, 1, high=12)}
    a, b = (exe.run(main, feed=feed, fetch_list=[loss])[0] for _ in "ab")
    assert a.shape == (5, 1) and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)       # seeded: the same negatives


def test_prelu_element_mode():
    """A slope an element (the reference's builder raises: its weight
    reaches ``F.prelu`` as channels; ROADMAP §C)."""
    x = tp.to_tensor(_x(2, 3, 4, 4))
    out = tstatic.nn.prelu(x, "element")
    a = x.numpy()
    np.testing.assert_allclose(out.numpy(), np.where(a > 0, a, 0.25 * a))
    with pytest.raises(TypeError):
        jstatic.nn.prelu(jp.to_tensor(a), "element")


def test_unknown_sequence_pool_raises_like_jax():
    for p, st in ((jp, jstatic), (tp, tstatic)):
        with pytest.raises(ValueError):
            st.nn.sequence_pool(p.to_tensor(_x(2, 3, 4)), "median")


# -- control flow ----------------------------------------------------------
def _w(st, shape=(3,)):
    return st.create_parameter(list(shape), "float32")


def _flow(p, nn, v):
    st = jstatic if p is jp else tstatic
    w = _w(st)
    out = nn.cond(v["p"], lambda: w * 2.0, lambda: w - 1.0)
    sw = nn.switch_case(v["i"], [lambda: w + 1.0, lambda: w + 2.0,
                                 lambda: w + 3.0])
    sd = nn.switch_case(v["i"], {1: lambda: w * 3.0, 4: lambda: w * 4.0},
                        default=lambda: w * 5.0)
    sn = nn.switch_case(v["i"], {1: lambda: w * 3.0, 4: lambda: w * 4.0})
    return [out, sw, sd, sn]


def test_control_flow_like_jax():
    """``cond`` and ``switch_case`` (a list, a dict with and without a
    default) in a program, each predicate fed. ``case`` and
    ``while_loop`` are held in a program against numpy: the reference's
    ``case`` reads its predicates as they stood at build (they are no
    inputs of its record), and its ``while_loop`` records the body's ops
    on tracers while it builds, so its replay raises
    ``UnexpectedTracerError`` (ROADMAP §C)."""
    feeds = [{"p": np.array([pv]), "i": np.array(iv, np.int64)}
             for pv, iv in ((True, 0), (False, 1), (False, 4), (True, 7))]
    _both(_flow, feeds[0], runs=feeds)
    main = tstatic.Program()
    with tstatic.program_guard(main):
        p = tstatic.data("p", [1], "bool")
        q = tstatic.data("q", [1], "bool")
        w = _w(tstatic)
        w.set_value(np.ones(3, np.float32))
        cs = tstatic.nn.case([(p, lambda: w * 10.0), (q, lambda: w + 5.0)],
                             default=lambda: w * 0.0)
    exe = tstatic.Executor(tp.CPUPlace())
    for pv, qv, want in ((True, True, 10.0), (False, True, 6.0),
                         (False, False, 0.0), (True, False, 10.0)):
        (got,) = exe.run(main, feed={"p": np.array([pv]),
                                     "q": np.array([qv])}, fetch_list=[cs])
        np.testing.assert_allclose(got, want)
    main = tstatic.Program()
    with tstatic.program_guard(main):
        n = tstatic.data("n", [1], "int64")
        w = _w(tstatic)
        w.set_value(np.arange(3, dtype=np.float32))
        i, acc = tstatic.nn.while_loop(
            lambda i, a: i < 3, lambda i, a: [i + 1, a * 1.5 + w], [n, w])
    exe = tstatic.Executor(tp.CPUPlace())
    for start in (0, 2, 5):
        got_i, got = exe.run(main, feed={"n": np.array([start])},
                             fetch_list=[i, acc])
        want = np.arange(3, dtype=np.float32)
        for _ in range(max(3 - start, 0)):
            want = want * 1.5 + np.arange(3, dtype=np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert int(got_i[0]) == max(start, 3)


def test_control_flow_eager_like_jax():
    x = _x(3)
    for pv in (True, False):
        for iv in (0, 2, 9):
            got = {}
            for p, st in ((jp, jstatic), (tp, tstatic)):
                t = p.to_tensor(x)
                pred = p.to_tensor(np.array([pv]))
                idx = p.to_tensor(np.array(iv))
                outs = [
                    st.nn.cond(pred, lambda: t * 2.0, lambda: t - 1.0),
                    st.nn.case([(pred, lambda: t * 10.0)],
                               default=lambda: t + 1.0),
                    st.nn.switch_case(idx, [lambda: t + 1.0,
                                            lambda: t + 2.0]),
                    st.nn.switch_case(idx, {2: lambda: t * 3.0},
                                      default=lambda: t * 5.0),
                    st.nn.while_loop(lambda i, a: i < 4,
                                     lambda i, a: [i + 1, a * 1.5],
                                     [p.to_tensor(np.array([iv % 4])), t])[1],
                ]
                got[p] = [np.asarray(o.numpy()) for o in outs]
            for a, b in zip(got[jp], got[tp]):
                np.testing.assert_allclose(b, a, rtol=1e-6)


def test_branch_reads_the_fed_value_and_survives_the_ir(tmp_path):
    """A branch over a feed replays with the fed value; the IR holds
    ``cond`` and ``while_loop`` as higher-order ops, and the serialized
    program takes either branch."""
    main = tstatic.Program()
    with tstatic.program_guard(main):
        x = tstatic.data("x", [2, 3])
        pred = tstatic.data("p", [1], "bool")
        out = tstatic.nn.cond(pred, lambda: x * 2.0, lambda: x - 1.0)
        _, acc = tstatic.nn.while_loop(
            lambda i, a: i < 3, lambda i, a: [i + 1, a + x],
            [tp.zeros([1], "int64"), x])
    exe = tstatic.Executor(tp.CPUPlace())
    a = _x(2, 3)
    for pv in (True, False):
        feed = {"x": a, "p": np.array([pv])}
        o, s = exe.run(main, feed=feed, fetch_list=[out, acc])
        np.testing.assert_allclose(o, a * 2.0 if pv else a - 1.0, rtol=1e-6)
        np.testing.assert_allclose(s, 4 * a, rtol=1e-6)
    ir = main.ir_module([out, acc])
    feed = {"x": a, "p": np.array([True])}
    targets = graph_targets(ir.graph(feed))
    assert "cond" in targets and "while_loop" in targets, targets
    path = str(tmp_path / "flow.pt2")
    ir.serialize(path, feed)
    call = tstatic.IrProgram.deserialize(path)
    for pv in (True, False):
        o, s = call(np.array([pv]), a)            # feeds in name order
        np.testing.assert_allclose(o.numpy(), a * 2.0 if pv else a - 1.0,
                                   rtol=1e-6)
        np.testing.assert_allclose(s.numpy(), 4 * a, rtol=1e-6)


def test_static_pylayer_like_jax():
    a = _x(4)
    got = {}
    for p, st in ((jp, jstatic), (tp, tstatic)):
        x = p.to_tensor(a)
        x.stop_gradient = False
        y = st.nn.static_pylayer(lambda t: t * 2.0, [x],
                                 backward_fn=lambda g: g * 3.0)
        y.sum().backward()
        plain = st.nn.static_pylayer(lambda t: t + 1.0, [x])
        got[p] = (np.asarray(y.numpy()), np.asarray(x.grad.numpy()),
                  np.asarray(plain.numpy()))
    for j, t in zip(got[jp], got[tp]):
        np.testing.assert_allclose(t, j, rtol=1e-6)
    np.testing.assert_allclose(got[tp][1], 3.0)
    assert tstatic.nn.py_func is tstatic.py_func
    # in a program the layer's forward replays
    _both(lambda p, nn, v: nn.static_pylayer(
        lambda t: t * 2.0 + 1.0, [v["x"]], backward_fn=lambda g: g),
        {"x": a})
