"""``paddle_tpu_torch.static`` against the JAX package's ``static``: the
counterparts of ``tests/test_static.py`` (its IR tests are in
``tests/test_torch_ir.py``), each run in both packages on the same numpy
feeds and weights, f32.

- Programs, the Executor's eval and train branches and the default
  program: values within 1e-6 (elementwise ops) and losses within 1e-5
  relative; the port's ``Executor`` runs with ``CPUPlace`` (its default
  is the card, which raises here).
- A 2-layer, hidden-32 ``BertForPretraining`` built under
  ``program_guard`` with AdamW: three ``Executor.run`` losses within 1e-5
  relative of the JAX package's, and its inference model's MLM logits
  within 1e-5.
- The inference model with dynamic batches (the shared ``_dyn0`` dim),
  ``py_func`` with and without a backward, the persistables' bytes, the
  resume from an optimizer's ``state_dict``.
- The rest of the surface: ``gradients``/``append_backward``,
  ``ExponentialMovingAverage``, ``create_parameter``/``create_global_var``,
  ``Print``, the metrics, the IPU stubs and ``enable_static`` (each
  raising the reference's exception type), the program state. Where the
  port parts from the reference on purpose (an in-place op's rebind
  replays; ``apply_decay_param_fun`` is honoured), it is held to the
  port's eager step or to numpy.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu import nn as jnn
from paddle_tpu import static as jstatic
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.convert import (layer_state_from_numpy,
                                      program_params_from_numpy)
from test_torch_threads import one_intra_op_thread  # noqa: F401

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    prev = (getattr(tdevice._state, "device", None),
            getattr(tdevice._state, "place", None))
    tp.set_device("cpu")
    yield
    tdevice._state.device, tdevice._state.place = prev


def _exe(p):
    return (jstatic.Executor() if p is jp
            else tstatic.Executor(tp.CPUPlace()))


def _set(p, t, arr):
    """Write ``arr`` into a Tensor of either package."""
    if p is jp:
        t._data = jp.to_tensor(arr)._data
    else:
        t.set_value(arr)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_static_forward_program():
    arrs = [_x(3, 4), _x(3, 4, seed=1)]
    got = {}
    for p, st in ((jp, jstatic), (tp, tstatic)):
        main = st.Program()
        with st.program_guard(main):
            x = st.data("x", [None, 4])
            y = p.tanh(x) * 2.0 + 1.0
        exe = _exe(p)
        got[p] = [exe.run(main, feed={"x": a}, fetch_list=[y])[0]
                  for a in arrs]
        assert main.op_names() == ["tanh", "mul", "add"] or p is jp
    for a, j, t in zip(arrs, got[jp], got[tp]):
        np.testing.assert_allclose(t, np.tanh(a) * 2.0 + 1.0, atol=1e-6)
        np.testing.assert_allclose(t, j, atol=1e-6)


def _regression(p, st, nn, opt_factory, seed=0):
    main, startup = st.Program(), st.Program()
    with st.program_guard(main, startup):
        x = st.data("x", [8, 4])
        label = st.data("label", [8, 1])
        net = nn.Sequential(nn.Linear(4, 16), nn.ReLU(), nn.Linear(16, 1))
        loss = ((net(x) - label) ** 2).mean()
        opt = opt_factory(p, net.parameters())
        opt.minimize(loss)
    return main, startup, loss, net, opt


def _feed():
    xs = _x(8, 4, seed=1)
    return {"x": xs, "label": (xs.sum(1, keepdims=True) * 0.5)
            .astype(np.float32)}


def _same_weights(jnet, tnet):
    layer_state_from_numpy({k: np.asarray(v.numpy())
                            for k, v in jnet.state_dict().items()}, tnet)


def _sgd(p, ps):
    return p.optimizer.SGD(learning_rate=0.1, parameters=ps)


def _adam(p, ps):
    return p.optimizer.Adam(learning_rate=0.05, parameters=ps)


def test_static_layer_and_minimize():
    jmain, jstart, jloss, jnet, _ = _regression(jp, jstatic, jnn, _sgd)
    tmain, tstart, tloss, tnet, _ = _regression(tp, tstatic, tnn, _sgd)
    _same_weights(jnet, tnet)
    feed, losses = _feed(), {}
    for p, main, start, loss in ((jp, jmain, jstart, jloss),
                                 (tp, tmain, tstart, tloss)):
        exe = _exe(p)
        assert exe.run(start) == []
        losses[p] = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
                     for _ in range(15)]
    assert losses[tp][-1] < losses[tp][0] * 0.5, losses[tp]
    np.testing.assert_allclose(losses[tp], losses[jp], rtol=TOL, atol=1e-7)
    assert len(tmain.trainable_params()) == len(jmain.trainable_params()) == 4


def test_static_clone_for_test_drops_optimizer():
    feed = {"x": np.ones((2, 4), np.float32)}
    got = {}
    for p, st, nn in ((jp, jstatic, jnn), (tp, tstatic, tnn)):
        main = st.Program()
        with st.program_guard(main):
            x = st.data("x", [2, 4])
            lin = nn.Linear(4, 2)
            out = lin(x)
            opt = p.optimizer.SGD(learning_rate=0.1,
                                  parameters=lin.parameters())
            opt.minimize((out ** 2).mean())
        if p is jp:
            state = {k: np.asarray(v.numpy())
                     for k, v in lin.state_dict().items()}
        else:
            layer_state_from_numpy(state, lin)
        test_prog = main.clone(for_test=True)
        assert test_prog._minimize is None and main._minimize is not None
        (got[p],) = _exe(p).run(test_prog, feed=feed, fetch_list=[out])
        # an eval run changes no weight
        np.testing.assert_array_equal(lin.weight.numpy(), state["weight"])
    assert got[tp].shape == (2, 2)
    np.testing.assert_allclose(got[tp], got[jp], atol=1e-6)


def test_default_program_guard():
    for p, st in ((jp, jstatic), (tp, tstatic)):
        before = len(st.default_main_program().records)
        _ = p.tanh(p.ones([2]))
        assert len(st.default_main_program().records) == before
    main = tstatic.Program()
    with tstatic.program_guard(main):
        tp.tanh(tp.ones([2]))
        inner = tstatic.Program()
        with tstatic.program_guard(inner):
            tp.exp(tp.ones([2]))
        tp.sin(tp.ones([2]))
    assert main.op_names() == ["tanh", "sin"] and inner.op_names() == ["exp"]


def _dyn_program(p, st):
    main = st.Program()
    with st.program_guard(main, st.Program()):
        x = st.data("x", [-1, 4], "float32")
        w = st.create_parameter([4, 2], "float32")
        _set(p, w, np.arange(8, dtype=np.float32).reshape(4, 2))
        z = p.matmul(x, w)
    return main, x, z


def test_save_inference_model_dynamic_batch(tmp_path):
    """Declared -1 dims export as a ``torch.export.Dim``: the loaded
    predictor serves any batch, as the JAX package's does."""
    for p, st in ((jp, jstatic), (tp, tstatic)):
        main, x, z = _dyn_program(p, st)
        prefix = str(tmp_path / ("j" if p is jp else "t"))
        st.save_inference_model(prefix, [x], [z], program=main)
        exe = None if p is jp else _exe(tp)
        pred, feeds, fetches = st.load_inference_model(prefix, exe)
        assert feeds == ["x"] and len(fetches) == 1
        for b in (1, 3, 7):
            a = _x(b, 4, seed=b)
            h = pred.get_input_handle(feeds[0])
            h.copy_from_cpu(a)
            pred.run()
            out = pred.get_output_handle(fetches[0]).copy_to_cpu()
            assert out.shape == (b, 2)
            np.testing.assert_allclose(
                out, a @ np.arange(8, dtype=np.float32).reshape(4, 2),
                rtol=1e-5, atol=1e-5)


def test_py_func_backward_and_deserialize_persistables():
    grads = {}
    for p in (jp, tp):
        x = p.to_tensor(np.array([2.0, 3.0], np.float32))
        x.stop_gradient = False
        y = (jstatic if p is jp else tstatic).py_func(
            lambda v: v * v, x, p.zeros([2]),
            backward_func=lambda v, g: 2.0 * v * g)
        y.sum().backward()
        grads[p] = np.asarray(x.grad.numpy())
    np.testing.assert_allclose(grads[tp], [4.0, 6.0])
    np.testing.assert_allclose(grads[tp], grads[jp])
    for p, st in ((jp, jstatic), (tp, tstatic)):
        main = st.Program()
        with st.program_guard(main, st.Program()):
            xi = st.data("xi", [2, 4], "float32")
            w = st.create_parameter([4, 2], "float32", name="fc_w")
            z = p.matmul(xi, w)
        want = np.arange(8, dtype=np.float32).reshape(4, 2)
        _set(p, w, want)
        blob = st.serialize_persistables([xi], [z], program=main)
        _set(p, w, np.zeros((4, 2), np.float32))
        state = st.deserialize_persistables(main, blob)
        assert list(state) == ["fc_w"]
        np.testing.assert_allclose(np.asarray(state["fc_w"]), want)
        # restoring persistables takes effect on the program
        np.testing.assert_allclose(np.asarray(w.numpy()), want)


def test_serialize_persistables_after_training_holds_the_trained_weights():
    """``serialize_program``, a training run, then ``serialize_persistables``
    gives the weights after the run. The JAX package memoizes the export
    under a key that training leaves unchanged and returns the weights
    from before the run (ROADMAP §C, faults of the reference), so the
    port alone is held here, against its own parameters."""
    main = tstatic.Program()
    with tstatic.program_guard(main, tstatic.Program()):
        x = tstatic.data("x", [2, 4], "float32")
        net = tnn.Linear(4, 2)
        z = net(x)
        loss = (z * z).mean()
        tp.optimizer.SGD(learning_rate=0.1,
                         parameters=net.parameters()).minimize(loss)
    before = [np.asarray(q.numpy()).copy() for q in net.parameters()]
    tstatic.serialize_program([x], [z], program=main)
    _exe(tp).run(main, feed={"x": _x(2, 4, seed=3)}, fetch_list=[loss])
    trained = [np.asarray(q.numpy()).copy() for q in net.parameters()]
    blob = tstatic.serialize_persistables([x], [z], program=main)
    state = tstatic.deserialize_persistables(main, blob)
    assert len(state) == 2
    for got, want, old in zip(state.values(), trained, before):
        assert not np.allclose(want, old)
        np.testing.assert_array_equal(np.asarray(got), want)


def test_py_func_without_backward_stops_gradients():
    """Without a ``backward_func`` the host op's outputs stop gradients:
    ``d(y * x)/dx = y``. The JAX package's forward gives the same values;
    its backward through the op raises (``pure_callback`` has no JVP;
    ROADMAP §C, faults of the reference)."""
    got = {}
    for p in (jp, tp):
        x = p.to_tensor(np.array([2.0, 3.0], np.float32))
        x.stop_gradient = False
        y = (jstatic if p is jp else tstatic).py_func(
            lambda v: v + 1.0, x, p.zeros([2]))
        got[p] = np.asarray(y.numpy())
        z = (y * x).sum()
        if p is jp:
            with pytest.raises(ValueError):
                z.backward()
        else:
            z.backward()
            np.testing.assert_allclose(x.grad.numpy(), got[tp])
    np.testing.assert_allclose(got[tp], [3.0, 4.0])
    np.testing.assert_allclose(got[tp], got[jp])


def test_save_inference_model_multi_dynamic_inputs_and_executor_run(
        tmp_path):
    """Two feeds with a dynamic batch share one ``_dyn0`` dim, so the
    exported add needs no guard between them; the loaded model runs
    through ``Executor.run(loaded, ...)``."""
    for p, st in ((jp, jstatic), (tp, tstatic)):
        main = st.Program()
        with st.program_guard(main, st.Program()):
            a = st.data("a", [-1, 4], "float32")
            b = st.data("b", [-1, 4], "float32")
            z = p.add(a, b)
        prefix = str(tmp_path / ("j" if p is jp else "t"))
        st.save_inference_model(prefix, [a, b], [z], program=main)
        exe = _exe(p)
        loaded, feeds, fetches = st.load_inference_model(
            prefix, None if p is jp else exe)
        for batch in (2, 5):
            outs = exe.run(loaded, feed={
                feeds[0]: np.full((batch, 4), 2.0, np.float32),
                feeds[1]: np.full((batch, 4), 3.0, np.float32)},
                fetch_list=fetches)
            np.testing.assert_allclose(outs[0], 5.0)
            assert outs[0].shape == (batch, 4)


def test_static_executor_resumes_from_restored_slots():
    """The port's static Executor keeps the optimizer's slots in the
    optimizer: a fresh optimizer restored from ``state_dict()`` resumes
    the program where it stopped, as the JAX package's does through its
    ``_slots`` seam; the losses equal the JAX package's straight run."""
    feed = _feed()

    def run(p, st, nn, main, loss, n):
        exe = _exe(p)
        return [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
                for _ in range(n)]

    jmain, _, jloss, jnet, _ = _regression(jp, jstatic, jnn, _adam)
    straight_j = run(jp, jstatic, jnn, jmain, jloss, 8)
    tmain, _, tloss, tnet, topt = _regression(tp, tstatic, tnn, _adam)
    tmain2, _, tloss2, tnet2, topt2 = _regression(tp, tstatic, tnn, _adam)
    jmain0, _, _, jnet0, _ = _regression(jp, jstatic, jnn, _adam)
    _same_weights(jnet, tnet)
    _same_weights(jnet, tnet2)
    # jnet has trained: take the start weights from a fresh JAX build
    jstart = {k: np.asarray(v.numpy()) for k, v in jnet0.state_dict().items()}
    layer_state_from_numpy(jstart, tnet)
    layer_state_from_numpy(jstart, tnet2)
    straight_j = None
    jm, _, jl, jn, _ = _regression(jp, jstatic, jnn, _adam)
    jn.set_state_dict({k: jp.to_tensor(v) for k, v in jstart.items()})
    straight_j = run(jp, jstatic, jnn, jm, jl, 8)
    straight_t = run(tp, tstatic, tnn, tmain, tloss, 8)
    first = run(tp, tstatic, tnn, tmain2, tloss2, 4)
    sd = topt2.state_dict()
    opt3 = _adam(tp, tnet2.parameters())
    opt3.set_state_dict(sd)
    tmain2._minimize = (opt3, tmain2._minimize[1])
    resumed = first + run(tp, tstatic, tnn, tmain2, tloss2, 4)
    np.testing.assert_allclose(resumed, straight_t, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(straight_t, straight_j, rtol=TOL, atol=1e-7)


# -- BERT through program_guard, minimize and Executor.run -----------------
BERT = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_seq_len=32, dropout=0.0)
B, S = 4, 16


def _bert_feed():
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 128, (B, S))
    labels = rng.randint(0, 128, (B, S))
    labels[:, ::2] = -100
    return {"ids": ids, "labels": labels.astype(np.int64),
            "nsp": rng.randint(0, 2, (B,)).astype(np.int64)}


def _bert_program(p, st):
    from paddle_tpu.models.bert import BertConfig as JC
    from paddle_tpu.models.bert import BertForPretraining as JB
    from paddle_tpu_torch.models import BertConfig as TC
    from paddle_tpu_torch.models import BertForPretraining as TB

    cfg, model = (JC, JB) if p is jp else (TC, TB)
    main = st.Program()
    with st.program_guard(main, st.Program()):
        m = model(cfg(**BERT))
        ids = st.data("ids", [B, S], "int32" if p is jp else "int64")
        loss = m.loss(ids, st.data("labels", [B, S], "int64"),
                      st.data("nsp", [B], "int64"))
        mlm, _ = m(ids)
        opt = p.optimizer.AdamW(learning_rate=1e-3,
                                parameters=m.parameters())
        opt.minimize(loss)
    return main, m, ids, loss, mlm


def test_bert_program_trains_like_jax(tmp_path):
    jmain, jm, jids, jloss, jmlm = _bert_program(jp, jstatic)
    tmain, tm, tids, tloss, tmlm = _bert_program(tp, tstatic)
    assert len(tmain.records) == len(jmain.records)
    # the same weights, carried by the programs' parameter order
    program_params_from_numpy(
        [np.asarray(q.numpy()) for q in jmain.trainable_params()], tmain)
    for a, b in zip(jmain.trainable_params(), tmain.trainable_params()):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a.numpy()))
    feed = _bert_feed()
    jfeed = dict(feed, ids=feed["ids"].astype(np.int32))
    jexe, texe = _exe(jp), _exe(tp)
    losses = [(float(jexe.run(jmain, feed=jfeed, fetch_list=[jloss])[0]),
               float(texe.run(tmain, feed=feed, fetch_list=[tloss])[0]))
              for _ in range(3)]
    for j, t in losses:
        assert abs(t - j) <= TOL * abs(j), losses
    assert losses[2][1] < losses[0][1]
    # the trained eval program's logits, and its inference model's
    jeval, teval = jmain.clone(for_test=True), tmain.clone(for_test=True)
    (jl,) = jexe.run(jeval, feed=jfeed, fetch_list=[jmlm])
    (tl,) = texe.run(teval, feed=feed, fetch_list=[tmlm])
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    prefix = str(tmp_path / "bert")
    tstatic.save_inference_model(prefix, [tids], [tmlm], program=teval)
    pred, feeds, fetches = tstatic.load_inference_model(prefix, texe)
    (pl,) = texe.run(pred, feed={"ids": feed["ids"]}, fetch_list=fetches)
    np.testing.assert_allclose(pl, jl, rtol=TOL, atol=TOL)


def test_program_params_from_numpy_by_name_and_checks():
    main, x, z = _dyn_program(tp, tstatic)
    (w,) = main.trainable_params()
    program_params_from_numpy({w.name: np.ones((4, 2), np.float32)}, main)
    np.testing.assert_array_equal(w.numpy(), np.ones((4, 2)))
    with pytest.raises(KeyError):
        program_params_from_numpy({"nope": np.ones((4, 2))}, main)
    with pytest.raises(ValueError):
        program_params_from_numpy([np.ones((2, 4))], main)
    with pytest.raises(ValueError):
        program_params_from_numpy([], main)


# -- the rest of the surface ------------------------------------------------
def test_gradients_and_append_backward_like_jax():
    a = _x(3, 4)
    got = {}
    for p, st in ((jp, jstatic), (tp, tstatic)):
        main = st.Program()
        with st.program_guard(main):
            w = st.create_parameter([4, 2], "float32", name="w")
            _set(p, w, _x(4, 2, seed=3))
            x = p.to_tensor(a)
            x.stop_gradient = False
            loss = (p.matmul(x, w) ** 2).sum()
        (gx,) = st.gradients([loss], [x])
        pairs = st.append_backward(loss, parameter_list=[w])
        got[p] = (np.asarray(gx.numpy()), np.asarray(pairs[0][1].numpy()))
        assert pairs[0][0] is w
    for j, t in zip(got[jp], got[tp]):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)


def test_exponential_moving_average_like_jax():
    vals = [_x(3, seed=i) for i in range(4)]
    got = {}
    for p, st in ((jp, jstatic), (tp, tstatic)):
        w = st.create_parameter([3], "float32")
        ema = st.ExponentialMovingAverage(decay=0.9, thres_steps=1)
        for v in vals:
            _set(p, w, v)
            ema.update([w])
        with ema.apply():
            inside = np.asarray(w.numpy()).copy()
        got[p] = (inside, np.asarray(w.numpy()))
        with pytest.raises(ValueError):    # no parameters anywhere
            st.ExponentialMovingAverage().update()
    np.testing.assert_allclose(got[tp][0], got[jp][0], rtol=1e-6)
    np.testing.assert_allclose(got[tp][1], vals[-1])


def test_create_parameter_global_var_and_program_state(tmp_path):
    for p, st in ((jp, jstatic), (tp, tstatic)):
        w = st.create_parameter([2, 3], "float32", name="w0")
        assert w.trainable and w.name == "w0"
        np.testing.assert_array_equal(np.asarray(w.numpy()), 0.0)
        g = st.create_global_var([2], 1.5, "float32", name="g")
        np.testing.assert_array_equal(np.asarray(g.numpy()), [1.5, 1.5])
    main, x, z = _dyn_program(tp, tstatic)
    prefix = str(tmp_path / "m")
    tstatic.save_inference_model(prefix, [x], [z], program=main)
    state = tstatic.load_program_state(prefix)
    (name,) = state
    np.testing.assert_array_equal(
        state[name], np.arange(8, dtype=np.float32).reshape(4, 2))
    tstatic.set_program_state(main, {name: np.ones((4, 2), np.float32)})
    np.testing.assert_array_equal(main.trainable_params()[0].numpy(), 1.0)
    blob = tstatic.serialize_program([x], [z], program=main)
    tstatic.save_to_file(str(tmp_path / "prog"), blob)
    ep = tstatic.deserialize_program(
        tstatic.load_from_file(str(tmp_path / "prog")))
    assert isinstance(ep, torch.export.ExportedProgram)
    assert tstatic.normalize_program(main, [x], [z]) is main


def test_print_prints_in_every_replay(capsys):
    main = tstatic.Program()
    with tstatic.program_guard(main):
        x = tstatic.data("x", [2])
        y = tstatic.Print(x * 2.0, message="twice") + 1.0
    capsys.readouterr()
    (out,) = _exe(tp).run(main, feed={"x": np.array([1.0, 2.0], np.float32)},
                          fetch_list=[y])
    np.testing.assert_allclose(out, [3.0, 5.0])
    assert "twice: " in capsys.readouterr().out


def test_metrics_like_jax():
    probs = np.abs(_x(8, 3))
    probs /= probs.sum(1, keepdims=True)
    label = np.array([0, 1, 2, 0, 1, 2, 0, 1], np.int64)[:, None]
    binary = np.stack([1 - probs[:, 0], probs[:, 0]], 1)
    blabel = (label == 0).astype(np.int64)
    got = {}
    for p, st in ((jp, jstatic), (tp, tstatic)):
        acc = st.accuracy(p.to_tensor(probs), p.to_tensor(label), k=2)
        auc = st.auc(p.to_tensor(binary), p.to_tensor(blabel))
        a, b = st.ctr_metric_bundle(p.to_tensor(binary), p.to_tensor(blabel))
        got[p] = [float(np.asarray(t.numpy())) for t in (acc, auc, a, b)]
    np.testing.assert_allclose(got[tp], got[jp], rtol=1e-6)


def test_refusals_raise_the_reference_exceptions():
    for p, st in ((jp, jstatic), (tp, tstatic)):
        with pytest.raises(NotImplementedError):
            p.enable_static()
        assert p.disable_static() is None
        with pytest.raises(NotImplementedError):
            st.IpuStrategy()
        with pytest.raises(NotImplementedError):
            st.IpuCompiledProgram()
        with st.ipu_shard_guard():
            pass
        assert st.set_ipu_shard(len) is len
        with st.name_scope("a"), st.device_guard("cpu"), \
                st.scope_guard(st.global_scope()):
            pass
        cp = st.CompiledProgram(st.Program(), st.BuildStrategy())
        assert cp.num_blocks == 1


def test_executor_defaults_to_the_card():
    if torch.cuda.is_available():
        assert tstatic.Executor()._device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            tstatic.Executor()
    assert isinstance(tstatic.cpu_places()[0], tp.CPUPlace)


def test_inplace_rebind_replays_and_decay_fun_is_honoured():
    """Two deliberate differences from the reference: an in-place op in a
    program replays as the rebind it was (the reference reads the
    handle's build-time value), and the train branch is the port's eager
    step, so AdamW's ``apply_decay_param_fun`` holds (the reference's
    ``functional_update`` decays every parameter)."""
    main = tstatic.Program()
    with tstatic.program_guard(main):
        x = tstatic.data("x", [3])
        y = x * 1.0
        y.add_(tp.ones([3]))
        z = y * 2.0
    (out,) = _exe(tp).run(main, feed={"x": np.arange(3, dtype=np.float32)},
                          fetch_list=[z])
    np.testing.assert_allclose(out, (np.arange(3) + 1.0) * 2.0)

    weights = set()

    def adamw(p, ps):
        return p.optimizer.AdamW(
            learning_rate=0.05, weight_decay=0.5, parameters=ps,
            apply_decay_param_fun=lambda n: n in weights)

    feed = _feed()
    tmain, _, tloss, tnet, _ = _regression(tp, tstatic, tnn, adamw)
    eager = tnn.Sequential(tnn.Linear(4, 16), tnn.ReLU(), tnn.Linear(16, 1))
    eager.set_state_dict(tnet.state_dict())
    weights.update(m.weight.name for net in (tnet, eager)
                   for m in (net[0], net[2]))
    opt = adamw(tp, eager.parameters())
    for _ in range(3):
        _exe(tp).run(tmain, feed=feed, fetch_list=[tloss])
        loss = ((eager(tp.to_tensor(feed["x"])) - tp.to_tensor(
            feed["label"])) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
    for a, b in zip(tnet.parameters(), eager.parameters()):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
