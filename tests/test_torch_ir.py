"""``paddle_tpu_torch.ir`` (pattern rewriting over FX graphs) and
``static.IrProgram`` against the JAX package's (over jaxprs): the
counterparts of ``tests/test_ir_rewrite.py`` and of
``tests/test_static.py::TestIrProgram``. Each function runs rewritten in
both packages on the same numpy input and the values agree (1e-6, or
bit for bit where a cast is kept); the graph loses the ops the pattern
folds, as the jaxpr does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu import ir as jir
from paddle_tpu import static as jstatic
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import ir as tir
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.ir import graph_targets
from test_torch_threads import one_intra_op_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _cpu():
    prev = (getattr(tdevice._state, "device", None),
            getattr(tdevice._state, "place", None))
    tp.set_device("cpu")
    yield
    tdevice._state.device, tdevice._state.place = prev


def _prims(closed):
    return [e.primitive.name for e in closed.jaxpr.eqns]


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_transpose_pair_eliminated():
    x = _x(3, 4)
    jrw = jir.PatternRewriter([jir.TransposePairPattern()])
    trw = tir.PatternRewriter([tir.TransposePairPattern()])

    def jf(a):
        return jnp.transpose(jnp.transpose(a, (1, 0)), (1, 0)) * 2.0

    def tf(a):
        return a.permute(1, 0).transpose(0, 1) * 2.0

    got = trw.rewrite(tf)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jrw.rewrite(jf)(x)))
    np.testing.assert_allclose(got.numpy(), tf(torch.from_numpy(x)).numpy())
    assert "transpose" not in _prims(jrw.jaxpr_of(jf, x))
    targets = graph_targets(trw.graph_of(tf, torch.from_numpy(x)))
    assert not set(targets) & {"permute", "transpose", "t"}, targets

    # a pair that does not cancel becomes one permute
    def three(a):
        return a.permute(1, 2, 0).permute(1, 2, 0)

    y = torch.from_numpy(_x(2, 3, 4))
    gm = trw.graph_of(three, y)
    assert graph_targets(gm) == ["permute"]
    np.testing.assert_array_equal(trw.rewrite(three)(y).numpy(),
                                  three(y).numpy())


def test_cast_chain_collapsed_but_lossy_kept():
    jrw = jir.PatternRewriter([jir.CastChainPattern()])
    trw = tir.PatternRewriter([tir.CastChainPattern()])
    x = np.asarray([1.2345678], np.float32)

    def jwiden(a):  # f32 -> f64 -> f32: lossless mid, collapsed
        return a.astype(jnp.float64).astype(jnp.float32) + 1.0

    def twiden(a):
        return a.to(torch.float64).to(torch.float32) + 1.0

    t = torch.from_numpy(x)
    casts = [n for n in graph_targets(trw.graph_of(twiden, t))
             if n in ("_to_copy", "convert_element_type")]
    assert len(casts) <= 1
    assert _prims(jrw.jaxpr_of(jwiden, x)).count("convert_element_type") <= 1
    np.testing.assert_allclose(trw.rewrite(twiden)(t).numpy(),
                               np.asarray(jrw.rewrite(jwiden)(x)))

    def jlossy(a):  # f32 -> bf16 -> f32 keeps the rounding
        return a.astype(jnp.bfloat16).astype(jnp.float32)

    def tlossy(a):
        return a.to(torch.bfloat16).to(torch.float32)

    assert graph_targets(trw.graph_of(tlossy, t)) == ["_to_copy",
                                                      "_to_copy"]
    np.testing.assert_array_equal(trw.rewrite(tlossy)(t).numpy(),
                                  np.asarray(jrw.rewrite(jlossy)(x)))
    np.testing.assert_array_equal(trw.rewrite(tlossy)(t).numpy(),
                                  tlossy(t).numpy())


def test_dead_code_eliminated():
    x = np.ones((4, 4), np.float32)

    def jf(a):
        unused = jnp.sin(a) @ jnp.cos(a).T   # never used
        return a * 3.0

    def tf(a):
        unused = torch.sin(a) @ torch.cos(a).T   # noqa: F841
        return a * 3.0

    trw = tir.PatternRewriter([])
    assert graph_targets(trw.graph_of(tf, torch.from_numpy(x))) == ["mul"]
    prims = _prims(jir.PatternRewriter([]).jaxpr_of(jf, x))
    assert "sin" not in prims and "dot_general" not in prims
    np.testing.assert_allclose(trw.rewrite(tf)(torch.from_numpy(x)).numpy(),
                               np.asarray(jf(x)))


def test_dead_code_keeps_host_calls():
    """A ``py_func`` whose output nothing reads stays (the reference pins
    an eqn with effects)."""
    main = tstatic.Program()
    seen = []
    with tstatic.program_guard(main):
        x = tstatic.data("x", [2])
        tstatic.py_func(lambda v: seen.append(1) or v, x, tp.zeros([2]))
        y = x * 2.0
    ir = main.ir_module([y]).apply()
    assert "host_call" in graph_targets(ir.graph({"x": np.ones(2)}))
    seen.clear()
    np.testing.assert_allclose(ir.run({"x": np.ones(2, np.float32)})[0],
                               [2.0, 2.0])
    assert seen == [1]


def test_rewritten_fn_is_traceable_and_differentiable():
    x = _x(3, 3, seed=1)
    jg = jir.PatternRewriter([jir.TransposePairPattern()]).rewrite(
        lambda a: jnp.sum(jnp.transpose(jnp.transpose(a)) ** 2))
    tg = tir.PatternRewriter([tir.TransposePairPattern()]).rewrite(
        lambda a: (a.t().t() ** 2).sum())
    want = np.asarray(jax.jit(jax.grad(jg))(x))
    got = torch.func.grad(tg)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), 2 * x, atol=1e-6)
    t = torch.from_numpy(x).requires_grad_()
    tg(t).backward()
    np.testing.assert_allclose(t.grad.numpy(), 2 * x, atol=1e-6)
    from torch.fx.experimental.proxy_tensor import make_fx
    assert "permute" not in graph_targets(make_fx(tg)(torch.from_numpy(x)))


def test_custom_user_pattern():
    class JExpLog(jir.ChainPattern):
        prims = ("log", "exp")

        def rewrite_chain(self, eqns, x):
            return x

    class TExpLog(tir.ChainPattern):
        prims = ("log", "exp")

        def rewrite_chain(self, nodes, x):
            return x

    x = np.asarray([2.0, 3.0], np.float32)
    jrw, trw = jir.PatternRewriter([JExpLog()]), tir.PatternRewriter(
        [TExpLog()])

    def tf(a):
        return torch.exp(torch.log(a)) + 1.0

    targets = graph_targets(trw.graph_of(tf, torch.from_numpy(x)))
    assert "log" not in targets and "exp" not in targets, targets
    np.testing.assert_allclose(
        trw.rewrite(tf)(torch.from_numpy(x)).numpy(),
        np.asarray(jrw.rewrite(lambda a: jnp.exp(jnp.log(a)) + 1.0)(x)))


def test_composes_with_while_loop():
    """Nodes that hold subgraphs (torch's ``while_loop``, the counterpart
    of ``lax.scan``) pass through untouched."""
    from torch._higher_order_ops.while_loop import while_loop

    def jf(a):
        def step(c, _):
            return c * 1.5, None
        out, _ = jax.lax.scan(step, a, None, length=3)
        return jnp.transpose(jnp.transpose(out))

    def tf(a):
        _, out = while_loop(lambda i, c: i < 3,
                            lambda i, c: (i + 1, c * 1.5),
                            (torch.zeros((), dtype=torch.int64), a))
        return out.t().t()

    x = np.ones((2, 2), np.float32)
    trw = tir.PatternRewriter([tir.TransposePairPattern()])
    np.testing.assert_allclose(trw.rewrite(tf)(torch.from_numpy(x)).numpy(),
                               np.asarray(jir.PatternRewriter(
                                   [jir.TransposePairPattern()])
                                   .rewrite(jf)(x)))
    targets = graph_targets(trw.graph_of(tf, torch.from_numpy(x)))
    assert "while_loop" in targets and "t" not in targets, targets


def test_integer_cast_chains_never_collapsed():
    trw = tir.PatternRewriter([tir.CastChainPattern()])
    jrw = jir.PatternRewriter([jir.CastChainPattern()])

    def twrap(a):  # int64 -> int32 (wraps) -> int64
        return a.to(torch.int32).to(torch.int64)

    x = torch.tensor([2 ** 40], dtype=torch.int64)
    np.testing.assert_array_equal(trw.rewrite(twrap)(x).numpy(),
                                  twrap(x).numpy())
    with jax.enable_x64(True):
        want = np.asarray(jrw.rewrite(
            lambda a: a.astype(jnp.int32).astype(jnp.int64))(
                jnp.asarray([2 ** 40], jnp.int64)))
    np.testing.assert_array_equal(trw.rewrite(twrap)(x).numpy(), want)

    def ttrunc(a):  # float -> int (truncates) -> float
        return a.to(torch.int32).to(torch.float32)

    f = torch.tensor([3.7])
    np.testing.assert_array_equal(trw.rewrite(ttrunc)(f).numpy(), [3.0])
    np.testing.assert_array_equal(
        trw.rewrite(ttrunc)(f).numpy(),
        np.asarray(jrw.rewrite(lambda a: a.astype(jnp.int32).astype(
            jnp.float32))(np.asarray([3.7], np.float32))))

    def thalf(a):  # f16 -> bf16 -> f32: bf16 does not hold every f16
        return a.to(torch.bfloat16).to(torch.float32)

    h = torch.tensor([1.0009765625], dtype=torch.float16)
    assert trw.rewrite(thalf)(h).item() == thalf(h).item() == 1.0


def test_add_zero():
    x = _x(2, 3)
    trw = tir.PatternRewriter([tir.AddZeroPattern()])

    def tf(a):
        return (a + 0) * 2.0 + (a.to(torch.int32) + 0).float()

    assert graph_targets(trw.graph_of(tf, torch.from_numpy(x))).count(
        "add") == 1
    np.testing.assert_array_equal(trw.rewrite(tf)(torch.from_numpy(x)),
                                  tf(torch.from_numpy(x)))
    jf = jir.PatternRewriter([jir.AddZeroPattern()]).rewrite(
        lambda a: (a + 0.0) * 2.0)
    np.testing.assert_allclose(trw.rewrite(tf)(torch.from_numpy(x)).numpy()
                               - np.trunc(x), np.asarray(jf(x)), atol=1e-6)


class TestIrProgram:
    """The static Program's IR form: the FX graph (the reference's jaxpr),
    ``paddle.ir`` passes, ``serialize`` (``torch.export``; the
    reference's StableHLO) and ``deserialize``."""

    def _program(self, p, st):
        main, startup = st.Program(), st.Program()
        with st.program_guard(main, startup):
            x = st.data("x", [4, 3], "float32")
            # transpose pair: the rewrite pass must eliminate it
            y = p.transpose(p.transpose(x, [1, 0]), [1, 0])
            z = p.exp(y) * 2.0
        return main, z

    def test_graph_inspection(self):
        feed = {"x": np.ones((4, 3), np.float32)}
        jmain, jz = self._program(jp, jstatic)
        prims = _prims(jmain.ir_module([jz]).jaxpr(feed))
        tmain, tz = self._program(tp, tstatic)
        targets = graph_targets(tmain.ir_module([tz]).graph(feed))
        assert "exp" in targets and "permute" in targets, targets
        assert "exp" in prims and "transpose" in prims

    def test_pass_application_changes_ir_and_keeps_values(self):
        feed = {"x": _x(4, 3)}
        got = {}
        for p, st, pat in ((jp, jstatic, jir.TransposePairPattern()),
                           (tp, tstatic, tir.TransposePairPattern())):
            main, z = self._program(p, st)
            ir = main.ir_module([z])
            before = ir.run(feed)[0]
            ir.apply(pat)
            after = ir.run(feed)[0]
            np.testing.assert_allclose(before, after, rtol=1e-6)
            got[p] = after
            if p is tp:
                targets = graph_targets(ir.graph(feed))
                assert "permute" not in targets and "exp" in targets
            else:
                assert "transpose" not in _prims(ir.jaxpr(feed))
        np.testing.assert_allclose(got[tp], got[jp], rtol=1e-6)

    def test_serialize_roundtrip(self, tmp_path):
        feed = {"x": _x(4, 3, seed=1)}
        main, z = self._program(tp, tstatic)
        ir = main.ir_module([z]).apply(tir.TransposePairPattern())
        want = ir.run(feed)[0]
        path = str(tmp_path / "prog.pt2")
        ir.serialize(path, feed)
        call = tstatic.IrProgram.deserialize(path)
        got = call(feed["x"])[0]
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        jmain, jz = self._program(jp, jstatic)
        jir_prog = jmain.ir_module([jz])
        jpath = str(tmp_path / "prog.stablehlo")
        jir_prog.serialize(jpath, feed)
        jgot = jstatic.IrProgram.deserialize(jpath)(feed["x"])[0]
        np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-6)
