"""The port's ``geometric`` (message passing, segment reductions, the
samplers) and ``incubate``'s graph names against the JAX package on the
CPU.

Both packages take the same seeded float32 numpy features and int64 edge
lists; outputs and the gradients of ``sum(out ** 2)`` agree within 1e-5
(sums of a handful of messages). Inputs are continuous random values, so
no max or min ties (torch splits a tied max's gradient evenly).

Reference fault shown here: under ``max`` and ``min`` the reference
leaves -inf / +inf on a node that gets no message; the port gives 0, as
Paddle documents, and equals the reference on every node that gets one.
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu.geometric as jg
import paddle_tpu_torch as tp
import paddle_tpu_torch.geometric as tg
from paddle_tpu_torch import device as tdevice
from test_torch_threads import one_intra_op_thread  # noqa: F401

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    prev = (getattr(tdevice._state, "device", None),
            getattr(tdevice._state, "place", None))
    tp.set_device("cpu")
    yield
    tdevice._state.device, tdevice._state.place = prev


def _graph(seed=0, n=7, e=16, f=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, f).astype(np.float32)
    src = rng.randint(0, n, e).astype(np.int64)
    dst = rng.randint(0, n - 2, e).astype(np.int64)   # nodes n-2, n-1 get none
    y = rng.randn(e, f).astype(np.float32)
    return x, y, src, dst


def _np(t):
    return np.asarray(t.numpy(), np.float64)


def _run(p, fn, arrays, grad=(0,)):
    ts = [p.to_tensor(a) for a in arrays]
    for i in grad:
        ts[i].stop_gradient = False
    out = fn(p, *ts)
    (out ** 2).sum().backward()
    return [_np(out)] + [_np(ts[i].grad) for i in grad]


@pytest.mark.parametrize("reduce_op", ["sum", "mean", "max", "min"])
def test_send_u_recv_like_jax(reduce_op):
    x, _, src, dst = _graph()
    has = np.isin(np.arange(len(x)), dst)
    fn = (lambda p, a, s, d: p.geometric.send_u_recv(a, s, d, reduce_op))
    got = _run(tp, fn, (x, src, dst))
    if reduce_op in ("sum", "mean"):
        want = _run(jp, fn, (x, src, dst))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)
        return
    want = _np(fn(jp, *[jp.to_tensor(a) for a in (x, src, dst)]))
    np.testing.assert_allclose(got[0][has], want[has], atol=TOL)
    # the reference leaves +-inf where no message arrives; the port 0
    assert np.isinf(want[~has]).all()
    assert (got[0][~has] == 0).all()


def test_send_u_recv_out_size_and_grads_of_max_on_live_nodes():
    x, _, src, dst = _graph(1)
    keep = np.isin(dst, [0, 1, 2])
    s, d = src[keep], dst[keep]
    fn = (lambda p, a, s_, d_: p.geometric.send_u_recv(
        a, s_, d_, "max", out_size=3))
    got = _run(tp, fn, (x, s, d))
    want = _run(jp, fn, (x, s, d))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=TOL)
    assert got[0].shape == (3, x.shape[1])


@pytest.mark.parametrize("message_op,reduce_op", [
    ("add", "sum"), ("mul", "sum"), ("add", "mean"), ("mul", "mean"),
    ("add", "max")])
def test_send_ue_recv_like_jax(message_op, reduce_op):
    x, y, src, dst = _graph(2)
    has = np.isin(np.arange(len(x)), dst)
    fn = (lambda p, a, e, s, d: p.geometric.send_ue_recv(
        a, e, s, d, message_op, reduce_op))
    got = _run(tp, fn, (x, y, src, dst), grad=(0, 1))
    ref = _np(fn(jp, *[jp.to_tensor(a) for a in (x, y, src, dst)]))
    np.testing.assert_allclose(got[0][has], ref[has], atol=TOL, rtol=TOL)
    if reduce_op != "max":
        want = _run(jp, fn, (x, y, src, dst), grad=(0, 1))
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)
    else:
        assert (got[0][~has] == 0).all() and np.isinf(ref[~has]).all()


@pytest.mark.parametrize("message_op", ["add", "sub", "mul", "div"])
def test_send_uv_like_jax(message_op):
    x, _, src, dst = _graph(3)
    y = np.abs(x) + 0.5
    fn = (lambda p, a, b, s, d: p.geometric.send_uv(a, b, s, d, message_op))
    got = _run(tp, fn, (x, y, src, dst), grad=(0, 1))
    want = _run(jp, fn, (x, y, src, dst), grad=(0, 1))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", ["segment_sum", "segment_mean",
                                  "segment_max", "segment_min"])
def test_segments_like_jax(name):
    rng = np.random.RandomState(4)
    data = rng.randn(9, 4).astype(np.float32)
    ids = np.array([0, 0, 1, 1, 1, 2, 3, 3, 3], np.int64)
    fn = (lambda p, d, i: getattr(p.geometric, name)(d, i))
    got = _run(tp, fn, (data, ids))
    want = _run(jp, fn, (data, ids))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)
    got_inc = getattr(tp.incubate, name)(tp.to_tensor(data),
                                         tp.to_tensor(ids))
    np.testing.assert_allclose(_np(got_inc), got[0], atol=0)


def test_reference_segment_example():
    x = tp.to_tensor(np.arange(8, dtype=np.float32).reshape(4, 2))
    src = tp.to_tensor(np.array([0, 1, 2, 0], np.int32))
    dst = tp.to_tensor(np.array([1, 2, 1, 3], np.int32))
    out = tg.send_u_recv(x, src, dst, reduce_op="sum")
    ref = np.zeros((4, 2), np.float32)
    ref[1] = x.numpy()[0] + x.numpy()[2]
    ref[2] = x.numpy()[1]
    ref[3] = x.numpy()[0]
    np.testing.assert_allclose(out.numpy(), ref)
    sm = tg.segment_mean(x, tp.to_tensor(np.array([0, 0, 1, 1], np.int32)))
    np.testing.assert_allclose(sm.numpy(), np.stack(
        [x.numpy()[:2].mean(0), x.numpy()[2:].mean(0)]))


def test_incubate_graph_names_like_jax():
    x, _, src, dst = _graph(5)
    for pool in ("sum", "mean", "max"):
        got = tp.incubate.graph_send_recv(tp.to_tensor(x), tp.to_tensor(src),
                                          tp.to_tensor(dst), pool)
        want = tg.send_u_recv(tp.to_tensor(x), tp.to_tensor(src),
                              tp.to_tensor(dst), pool)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    for name, args in (("graph_khop_sampler", (None, None, None, [2])),
                       ("graph_sample_neighbors", (None, None, None)),
                       ("graph_reindex", (None, None, None))):
        for p in (jp, tp):
            with pytest.raises(NotImplementedError):
                getattr(p.incubate, name)(*args)


def test_reindex_graph_like_jax():
    x = np.array([0, 1, 2], np.int64)
    nb = np.array([8, 9, 0, 4, 7, 6, 7], np.int64)
    count = np.array([2, 3, 2], np.int32)
    got = tg.reindex_graph(tp.to_tensor(x), tp.to_tensor(nb),
                           tp.to_tensor(count))
    want = jg.reindex_graph(jp.to_tensor(x), jp.to_tensor(nb),
                            jp.to_tensor(count))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b.numpy()))
    nbs = [nb, np.array([3, 1, 5, 2], np.int64)]
    cts = [count, np.array([1, 2, 1], np.int32)]
    got = tg.reindex_heter_graph(tp.to_tensor(x), [tp.to_tensor(a)
                                                   for a in nbs], cts)
    want = jg.reindex_heter_graph(jp.to_tensor(x), [jp.to_tensor(a)
                                                    for a in nbs], cts)
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b.numpy()))
    np.testing.assert_array_equal(got[1].numpy(),
                                  np.asarray(want[1].numpy()))


def test_sampling():
    # CSC graph: node 0 has neighbours [1, 2], node 1 has [0]
    row = tp.to_tensor(np.array([1, 2, 0], np.int64))
    colptr = tp.to_tensor(np.array([0, 2, 3], np.int64))
    nb, cnt = tg.sample_neighbors(row, colptr, tp.to_tensor(np.array([0])))
    assert list(cnt.numpy()) == [2]
    assert sorted(nb.numpy().tolist()) == [1, 2]
    # a larger graph: counts, membership, no repeats, the generator's seed
    rng = np.random.RandomState(6)
    n = 20
    rows = [np.sort(rng.choice(n, rng.randint(3, 9), replace=False))
            for _ in range(n)]
    cp = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    row = np.concatenate(rows)
    w = rng.uniform(0.1, 1.0, len(row)).astype(np.float32)
    nodes = np.array([0, 3, 7, 19], np.int64)
    draws = []
    for weighted in (False, True):
        for seed in (1, 1, 2):
            g = tp.Generator(seed).torch_generator
            args = (tp.to_tensor(row), tp.to_tensor(cp))
            nb, cnt = (tg.weighted_sample_neighbors(
                *args, tp.to_tensor(w), tp.to_tensor(nodes), 3, generator=g)
                if weighted else tg.sample_neighbors(
                    *args, tp.to_tensor(nodes), 3, generator=g))
            cnt = cnt.numpy()
            assert (cnt == 3).all()
            parts = np.split(nb.numpy(), np.cumsum(cnt)[:-1])
            for node, part in zip(nodes, parts):
                assert len(set(part.tolist())) == 3
                assert set(part.tolist()) <= set(rows[node].tolist())
            draws.append(nb.numpy().tolist())
    assert draws[0] == draws[1] and draws[3] == draws[4]
    ref_nb, ref_cnt = jg.sample_neighbors(jp.to_tensor(row), jp.to_tensor(cp),
                                          jp.to_tensor(nodes), 3)
    np.testing.assert_array_equal(np.asarray(ref_cnt.numpy()), cnt)


def _gcn(p, x, src, dst, norm, w1, w2):
    h = p.geometric.send_ue_recv(x, norm, src, dst, "mul", "sum")
    h = p.nn.functional.relu(p.matmul(h, w1))
    h = p.geometric.send_ue_recv(h, norm, src, dst, "mul", "sum")
    return p.matmul(h, w2)


def test_two_layer_gcn_loss_and_gradients_like_jax():
    rng = np.random.RandomState(7)
    n, f, hdim, c = 12, 5, 8, 3
    src = rng.randint(0, n, 30)
    dst = rng.randint(0, n, 30)
    src, dst = (np.concatenate([src, dst, np.arange(n)]),
                np.concatenate([dst, src, np.arange(n)]))
    deg = np.bincount(dst, minlength=n).astype(np.float32)
    norm = (1.0 / np.sqrt(deg[src] * deg[dst]))[:, None].astype(np.float32)
    x = rng.randn(n, f).astype(np.float32)
    w1 = (rng.randn(f, hdim) * 0.3).astype(np.float32)
    w2 = (rng.randn(hdim, c) * 0.3).astype(np.float32)
    labels = rng.randint(0, c, n)
    res = {}
    for p in (jp, tp):
        ws = [p.to_tensor(a) for a in (w1, w2)]
        for t in ws:
            t.stop_gradient = False
        logits = _gcn(p, p.to_tensor(x), p.to_tensor(src), p.to_tensor(dst),
                      p.to_tensor(norm), *ws)
        loss = p.nn.functional.cross_entropy(logits, p.to_tensor(labels))
        loss.backward()
        res[p] = [_np(loss)] + [_np(t.grad) for t in ws]
    for a, b in zip(res[tp], res[jp]):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)
