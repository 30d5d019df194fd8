"""The port's ``sparse`` and ``sparse.nn`` against the JAX package on the
CPU: the COO tensor and its ops, the SDDMM, the segment softmax, the
O(nnz) attention, the rulebook convs and max pool, and the layers.

Both packages take the same seeded float32 numpy indices, values and
weights. Values and gradients agree within 1e-5 where one library's sum
order is the other's, and 1e-4 through a conv or an attention (sums run
in another order). The device rulebook equals the reference's numpy
rulebook pair for pair. The O(nnz) contracts are held with a dispatch
mode that records every op's output: none is larger than the gathered
``[nnz, K]`` operands (or an input's own reshape), and none has a dense
volume's shape.

Reference faults shown here: the reference's ``SubmConv3D`` layer is not
submanifold (it densifies and returns every site the dense conv touches);
the port's is, and equals the reference's functional ``subm_conv3d``.
The reference's ``MaxPool3D`` takes its max over the densified window,
inactive zeros included; the cases feed positive values (as after a
ReLU), where the two agree.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as jp
import paddle_tpu.sparse as jsp
import paddle_tpu.sparse.nn.functional as JF
import paddle_tpu_torch as tp
import paddle_tpu_torch.sparse as tsp
import paddle_tpu_torch.sparse.nn.functional as TF
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.convert import layer_state_from_numpy
from test_torch_threads import one_intra_op_thread  # noqa: F401

TOL = 1e-5
CONV_TOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu():
    prev = (getattr(tdevice._state, "device", None),
            getattr(tdevice._state, "place", None))
    tp.set_device("cpu")
    yield
    tdevice._state.device, tdevice._state.place = prev


def _sites(rng, dims, nnz):
    """``nnz`` distinct coordinates in ``dims``, sorted, as [len(dims), nnz]."""
    coords = set()
    while len(coords) < nnz:
        coords.add(tuple(int(rng.integers(0, s)) for s in dims))
    return np.asarray(sorted(coords)).T


def _np(t):
    return np.asarray(t.numpy(), np.float64)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a) if hasattr(a, "numpy") else a,
                               _np(b) if hasattr(b, "numpy") else b,
                               atol=tol, rtol=tol)


def _dense_of_coo(t):
    d = np.zeros(t.shape, np.float64)
    np.add.at(d, tuple(np.asarray(t.indices().numpy())),
              np.asarray(t.values().numpy()))
    return d


class _Largest(TorchDispatchMode):
    """Records each op's output shapes."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in (out if isinstance(out, (list, tuple)) else (out,)):
            if isinstance(o, torch.Tensor):
                self.shapes.append(tuple(o.shape))
        return out

    @property
    def biggest(self):
        return max(int(np.prod(s)) for s in self.shapes)


# -- the COO tensor and its ops -----------------------------------------------
def test_matmul_stays_sparse_and_grads_like_jax():
    ind = np.array([[0, 1, 2], [1, 0, 2]])
    vals = np.array([1.0, 2.0, 3.0], np.float32)
    dense = (np.random.RandomState(0).randn(3, 4)).astype(np.float32)
    res = {}
    for p, sp in ((jp, jsp), (tp, tsp)):
        v = p.to_tensor(vals)
        v.stop_gradient = False
        d = p.to_tensor(dense)
        d.stop_gradient = False
        out = sp.matmul(sp.sparse_coo_tensor(ind, v, [3, 3]), d)
        (out ** 2).sum().backward()
        res[p] = (_np(out), _np(v.grad), _np(d.grad))
    for a, b in zip(res[tp], res[jp]):
        _close(a, b)
    with _Largest() as rec:
        x = tsp.sparse_coo_tensor(ind, vals, [3, 3])
        tsp.matmul(x, tp.to_tensor(dense))
    assert (3, 3) not in rec.shapes


def test_batched_matmul_mv_and_addmm_like_jax():
    rng = np.random.default_rng(1)
    idx = _sites(rng, (2, 5, 6), 9)
    vals = rng.standard_normal(9).astype(np.float32)
    y = rng.standard_normal((6, 3)).astype(np.float32)
    vec = rng.standard_normal(6).astype(np.float32)
    idx2 = _sites(rng, (5, 6), 7)
    vals2 = rng.standard_normal(7).astype(np.float32)
    inp = rng.standard_normal((5, 3)).astype(np.float32)
    outs = {}
    for p, sp in ((jp, jsp), (tp, tsp)):
        x = sp.sparse_coo_tensor(idx, vals, (2, 5, 6))
        x2 = sp.sparse_coo_tensor(idx2, vals2, (5, 6))
        outs[p] = [sp.matmul(x, p.to_tensor(y)), sp.mv(x2, p.to_tensor(vec)),
                   sp.addmm(p.to_tensor(inp), x2, p.to_tensor(y), beta=0.5,
                            alpha=2.0)]
    for a, b in zip(outs[tp], outs[jp]):
        _close(a, b)


@pytest.mark.parametrize("name", [
    "sin", "tan", "asin", "atan", "sinh", "tanh", "asinh", "atanh", "sqrt",
    "square", "abs", "expm1", "log1p", "neg", "deg2rad", "rad2deg", "relu"])
def test_valuewise_ops_like_jax(name):
    ind = np.array([[0, 1, 2], [1, 0, 2]])
    vals = np.array([0.25, -0.5, 0.75], np.float32)
    if name in ("sqrt",):
        vals = np.abs(vals)
    got = getattr(tsp, name)(tsp.sparse_coo_tensor(ind, vals, [3, 3]))
    want = getattr(jsp, name)(jsp.sparse_coo_tensor(ind, vals, [3, 3]))
    assert got.is_sparse_coo()
    np.testing.assert_array_equal(got.indices().numpy(),
                                  np.asarray(want.indices().numpy()))
    _close(got.values(), want.values())


def test_pow_cast_isnan_and_extras_like_jax():
    ind = np.array([[0, 1], [1, 0]])
    outs = {}
    for sp in (jsp, tsp):
        x = sp.sparse_coo_tensor(ind, [2.0, 8.0], [2, 2])
        t = sp.transpose(x, [1, 0])
        outs[sp] = [sp.pow(x, 3).values(), sp.cast(x, value_dtype="float64")
                    .values(), t.to_dense(), sp.sum(x),
                    sp.nn.functional.relu(sp.sparse_coo_tensor(
                        ind, [-1.0, 3.0], [2, 2])).values(),
                    sp.isnan(x).values().astype("float32")]
        assert sp.is_same_shape(x, t)
    for a, b in zip(outs[tsp], outs[jsp]):
        _close(a, b)
    d = tsp.transpose(tsp.sparse_coo_tensor(ind, [2.0, 8.0], [2, 2]),
                      [1, 0]).to_dense().numpy()
    assert d[0, 1] == 8.0 and d[1, 0] == 2.0
    assert float(tsp.sum(tsp.sparse_coo_tensor(ind, [2.0, 8.0], [2, 2]))
                 .numpy()) == 10.0


def test_csr_and_elementwise_pairs_like_jax():
    crows, cols = np.array([0, 2, 3, 5]), np.array([0, 2, 1, 0, 2])
    vals = np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
    other = np.random.RandomState(2).randn(3, 3).astype(np.float32) + 3.0
    outs = {}
    for p, sp in ((jp, jsp), (tp, tsp)):
        x = sp.sparse_csr_tensor(crows, cols, vals, [3, 3])
        o = p.to_tensor(other)
        outs[p] = [x.to_dense(), sp.add(x, o), sp.subtract(x, o).to_dense(),
                   sp.multiply(x, o).to_dense(), sp.divide(x, o).to_dense(),
                   sp.mask_as(o, x).values()]
    for a, b in zip(outs[tp], outs[jp]):
        _close(a, b)


def test_coalesce_reshape_slice_on_the_indices_like_jax():
    """The port works on the indices; each result's dense view equals the
    reference's (no stored value here sums to 0, which the reference
    would drop)."""
    rng = np.random.default_rng(3)
    idx = np.concatenate([_sites(rng, (4, 6), 10), np.array([[1, 2], [3, 5]])],
                         axis=1)                         # two duplicates
    idx = np.concatenate([idx, idx[:, :2]], axis=1)
    vals = rng.uniform(0.5, 2.0, idx.shape[1]).astype(np.float32)
    res = {}
    for sp in (jsp, tsp):
        x = sp.sparse_coo_tensor(idx, vals, (4, 6))
        c = sp.coalesce(x)
        res[sp] = (c, sp.reshape(c, [3, 8]), sp.reshape(c, [2, -1, 4]),
                   sp.slice(c, [0, 1], [1, 2], [3, 6]),
                   sp.slice(c, [1], [-4], [100]))
    for a, b in zip(res[tsp], res[jsp]):
        assert a.shape == b.shape
        np.testing.assert_allclose(_dense_of_coo(a), _dense_of_coo(b),
                                   atol=TOL)
    c = res[tsp][0]
    want_idx = np.asarray(res[jsp][0].indices().numpy())
    np.testing.assert_array_equal(c.indices().numpy(), want_idx)
    with _Largest() as rec:
        tsp.reshape(c, [3, 8])
        tsp.slice(c, [0, 1], [1, 2], [3, 6])
    assert (4, 6) not in rec.shapes and (3, 8) not in rec.shapes


def test_masked_matmul_matches_jax_2d_and_batched():
    rng = np.random.default_rng(0)
    for shape, xs, ys in [((8, 9), (8, 5), (5, 9)),
                          ((3, 6, 7), (3, 6, 4), (3, 4, 7))]:
        idx = _sites(rng, shape, 10)
        x = rng.standard_normal(xs).astype(np.float32)
        y = rng.standard_normal(ys).astype(np.float32)
        got = tsp.masked_matmul(tp.to_tensor(x), tp.to_tensor(y),
                                tsp.sparse_coo_tensor(idx, np.ones(10),
                                                      shape))
        want = jsp.masked_matmul(jp.to_tensor(x), jp.to_tensor(y),
                                 jsp.sparse_coo_tensor(idx, np.ones(10),
                                                       shape))
        _close(got.values(), want.values())
        np.testing.assert_allclose(_np(got.values()),
                                   np.matmul(x, y)[tuple(idx)], atol=TOL)


def test_masked_matmul_is_onnz():
    rng = np.random.default_rng(1)
    M = N = 256
    K, nnz = 16, 12
    idx = _sites(rng, (M, N), nnz)
    x = tp.to_tensor(rng.standard_normal((M, K)).astype(np.float32))
    y = tp.to_tensor(rng.standard_normal((K, N)).astype(np.float32))
    mask = tsp.sparse_coo_tensor(idx, np.ones(nnz), (M, N))
    with _Largest() as rec:
        tsp.masked_matmul(x, y, mask)
    assert rec.biggest <= max(nnz * K, M * K, K * N), rec.biggest
    assert rec.biggest < M * N / 10
    assert (M, N) not in rec.shapes


# -- segment softmax and attention --------------------------------------------
def test_sparse_softmax_and_grads_like_jax():
    rng = np.random.default_rng(2)
    idx = _sites(rng, (5, 7), 11)
    vals = rng.standard_normal(11).astype(np.float32)
    res = {}
    for p, sp in ((jp, jsp), (tp, tsp)):
        v = p.to_tensor(vals)
        v.stop_gradient = False
        out = sp.nn.functional.softmax(sp.sparse_coo_tensor(idx, v, (5, 7)))
        (out.values() ** 2).sum().backward()
        res[p] = (_np(out.values()), _np(v.grad))
    for a, b in zip(res[tp], res[jp]):
        _close(a, b)
    want = np.zeros_like(vals)
    for r in np.unique(idx[0]):
        sel = idx[0] == r
        e = np.exp(vals[sel] - vals[sel].max())
        want[sel] = e / e.sum()
    np.testing.assert_allclose(res[tp][0], want, atol=1e-6)


def _attention_case(rng, B, H, S, D, density):
    q, k, v = (rng.standard_normal((B, H, S, D)).astype(np.float32)
               for _ in range(3))
    dense_mask = rng.random((B * H, S, S)) < density
    dense_mask |= np.eye(S, dtype=bool)[None]
    return q, k, v, dense_mask, np.stack(np.nonzero(dense_mask))


def test_sparse_attention_matches_jax_and_dense_with_grads():
    rng = np.random.default_rng(3)
    B, H, S, D = 2, 2, 6, 4
    q, k, v, dense_mask, idx = _attention_case(rng, B, H, S, D, 0.4)
    kp = np.where(rng.random((B, S)) < 0.2, -1e4, 0.0).astype(np.float32)
    am = (0.1 * rng.standard_normal((S, S))).astype(np.float32)
    res = {}
    for p, sp in ((jp, jsp), (tp, tsp)):
        ts = [p.to_tensor(a) for a in (q, k, v)]
        for t in ts:
            t.stop_gradient = False
        mask = sp.sparse_coo_tensor(idx, np.ones(idx.shape[1], np.float32),
                                    (B * H, S, S))
        out = sp.nn.functional.attention(*ts, mask, p.to_tensor(kp),
                                         p.to_tensor(am))
        (out ** 2).sum().backward()
        res[p] = [_np(out)] + [_np(t.grad) for t in ts]
    for a, b in zip(res[tp], res[jp]):
        _close(a, b, CONV_TOL)
    scores = np.einsum("bhsd,bhtd->bhst", q, k) / np.sqrt(D)
    scores = scores + kp[:, None, None, :] + am
    scores = scores.reshape(B * H, S, S)
    scores[~dense_mask] = -np.inf
    pr = np.exp(scores - scores.max(-1, keepdims=True))
    pr /= pr.sum(-1, keepdims=True)
    ref = np.einsum("gst,gtd->gsd", pr, v.reshape(B * H, S, D))
    np.testing.assert_allclose(res[tp][0], ref.reshape(B, H, S, D),
                               atol=1e-5, rtol=1e-4)


def test_sparse_attention_is_onnz_and_never_makes_the_scores():
    rng = np.random.default_rng(4)
    B, H, S, D = 1, 2, 64, 4
    q, k, v, _, idx = _attention_case(rng, B, H, S, D, 0.05)
    nnz = idx.shape[1]
    ts = [tp.to_tensor(a, stop_gradient=False) for a in (q, k, v)]
    mask = tsp.sparse_coo_tensor(idx, np.ones(nnz, np.float32), (B * H, S, S))
    with _Largest() as rec:
        out = TF.attention(*ts, mask)
        (out ** 2).sum().backward()
    assert rec.biggest <= max(nnz * D, B * H * S * D), rec.biggest
    assert not any(list(s).count(S) >= 2 for s in rec.shapes), rec.shapes


def test_sparse_attention_fully_masked_row_is_finite():
    rng = np.random.default_rng(7)
    q, k, v = (tp.to_tensor(rng.standard_normal((1, 1, 2, 4)).astype(
        np.float32)) for _ in range(3))
    idx = np.asarray([[0, 0, 1], [0, 1, 1]]).T
    mask = tsp.sparse_coo_tensor(idx, np.ones(2, np.float32), (1, 2, 2))
    kp = tp.to_tensor(np.asarray([[0.0, -np.inf]], np.float32))
    out = TF.attention(q, k, v, mask, key_padding_mask=kp)
    assert np.isfinite(out.numpy()).all()


# -- the rulebook -------------------------------------------------------------
RULEBOOK_CASES = [
    # spatial, ksize, stride, padding, dilation, subm, batch, nnz
    ((6, 5, 4), (3, 3, 3), (1, 1, 1), (1, 1, 1), (1, 1, 1), True, 2, 17),
    ((6, 5, 4), (3, 3, 3), (1, 1, 1), (2, 2, 2), (2, 2, 2), True, 1, 15),
    ((7, 6, 5), (3, 3, 3), (2, 2, 2), (1, 1, 1), (1, 1, 1), False, 2, 20),
    ((7, 6, 5), (3, 1, 1), (2, 1, 1), (0, 0, 0), (1, 1, 1), False, 1, 12),
    ((9, 8), (3, 3), (2, 2), (1, 1), (1, 1), False, 1, 11),
    ((9, 8), (3, 3), (1, 1), (1, 1), (1, 1), True, 3, 14),
]


@pytest.mark.parametrize("case", RULEBOOK_CASES,
                         ids=lambda c: f"{'subm' if c[5] else 'full'}"
                         f"{len(c[0])}d_s{c[2][0]}_k{c[1][0]}")
def test_device_rulebook_equals_the_reference_pair_for_pair(case):
    spatial, ks, st, pd, dl, subm, batch, nnz = case
    idx = _sites(np.random.default_rng(5), (batch,) + spatial, nnz)
    want_out, want_rb, want_dims = JF._build_rulebook(
        idx, list(spatial), list(ks), list(st), list(pd), list(dl), subm,
        batch_size=batch)
    got_out, got_rb, got_dims = TF._build_rulebook(
        torch.as_tensor(idx), list(spatial), list(ks), list(st), list(pd),
        list(dl), subm, batch_size=batch)
    assert list(got_dims) == list(want_dims)
    np.testing.assert_array_equal(got_out.numpy(), np.asarray(want_out))
    assert len(got_rb) == len(want_rb) == int(np.prod(ks))
    for (gi, go), (wi, wo) in zip(got_rb, want_rb):
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(go.numpy(), np.asarray(wo))
    assert sum(len(np.asarray(w)) for w, _ in want_rb) > 0


def _conv_inputs(rng, shape, nnz, ks, cin, cout):
    idx = _sites(rng, shape[:-1], nnz)
    vals = rng.standard_normal((nnz, cin)).astype(np.float32)
    w = (rng.standard_normal(tuple(ks) + (cin, cout)) * 0.3).astype(
        np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    return idx, vals, w, b


def _conv_both(fname, idx, vals, w, b, shape, **kw):
    res = {}
    for p, F_, sp in ((jp, JF, jsp), (tp, TF, tsp)):
        v = p.to_tensor(vals)
        wt = p.to_tensor(w)
        for t in (v, wt):
            t.stop_gradient = False
        out = getattr(F_, fname)(sp.sparse_coo_tensor(idx, v, shape), wt,
                                 p.to_tensor(b), **kw)
        (out.values() ** 2).sum().backward()
        res[p] = (out, _np(v.grad), _np(wt.grad))
    return res


@pytest.mark.parametrize("fname,shape,kw", [
    ("subm_conv3d", (2, 6, 5, 4, 3), dict(padding=1)),
    ("conv3d", (2, 6, 5, 4, 3), dict(stride=2, padding=1)),
    ("conv2d", (1, 9, 8, 2), dict(stride=2, padding=1)),
    ("subm_conv2d", (2, 9, 8, 2), dict(padding=1)),
])
def test_rulebook_convs_and_grads_like_jax(fname, shape, kw):
    nd = len(shape) - 2
    idx, vals, w, b = _conv_inputs(np.random.default_rng(6), shape, 17,
                                   (3,) * nd, shape[-1], 4)
    res = _conv_both(fname, idx, vals, w, b, shape, **kw)
    got, want = res[tp][0], res[jp][0]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.indices().numpy(),
                                  np.asarray(want.indices().numpy()))
    _close(got.values(), want.values(), CONV_TOL)
    for a, c in zip(res[tp][1:], res[jp][1:]):
        _close(a, c, CONV_TOL)
    if fname.startswith("subm"):
        np.testing.assert_array_equal(got.indices().numpy(), idx)


def test_rulebook_coalesces_duplicates_and_keeps_batch_dim_like_jax():
    rng = np.random.default_rng(4)
    idx = np.asarray([[0, 0, 0], [1, 1, 2], [1, 1, 0], [1, 1, 1]])
    vals = rng.standard_normal((3, 2)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, 2, 3)) * 0.3).astype(np.float32)
    b = np.zeros(3, np.float32)
    res = _conv_both("subm_conv3d", idx, vals, w, b, (2, 4, 4, 4, 2),
                     padding=1)
    got, want = res[tp][0], res[jp][0]
    assert got.shape[0] == 2
    np.testing.assert_array_equal(got.indices().numpy(),
                                  np.asarray(want.indices().numpy()))
    _close(got.values(), want.values(), CONV_TOL)
    _close(res[tp][1], res[jp][1], CONV_TOL)


def test_subm_stride_raises():
    idx, vals, w, _ = _conv_inputs(np.random.default_rng(5), (1, 5, 5, 5, 2),
                                   5, (3, 3, 3), 2, 2)
    x = tsp.sparse_coo_tensor(idx, vals, (1, 5, 5, 5, 2))
    with pytest.raises(ValueError, match="submanifold"):
        TF.subm_conv3d(x, tp.to_tensor(w), stride=2, padding=1)


def test_rulebook_conv_memory_scales_with_nnz_not_volume():
    rng = np.random.default_rng(2)
    nnz, cin, cout = 40, 4, 8
    idx = _sites(rng, (1, 64, 64, 64), nnz)
    x = tsp.sparse_coo_tensor(idx, rng.standard_normal((nnz, cin)).astype(
        np.float32), (1, 64, 64, 64, cin))
    w = tp.to_tensor(rng.standard_normal((3, 3, 3, cin, cout)).astype(
        np.float32), stop_gradient=False)
    with _Largest() as rec:
        out = TF.subm_conv3d(x, w, padding=1)
        (out.values() ** 2).sum().backward()
    volume = 64 ** 3 * cout
    assert rec.biggest <= nnz * max(cin, cout) * 27, rec.biggest
    assert rec.biggest < volume / 100


def test_max_pool3d_over_the_rulebook_like_jax():
    rng = np.random.default_rng(8)
    shape = (2, 6, 6, 5, 3)
    idx = _sites(rng, shape[:-1], 25)
    vals = rng.uniform(0.1, 2.0, (25, 3)).astype(np.float32)
    got = TF.max_pool3d(tsp.sparse_coo_tensor(idx, vals, shape), 3, 2, 1)
    want = JF.max_pool3d(jsp.sparse_coo_tensor(idx, vals, shape), 3, 2, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(_dense_of_coo(got), _dense_of_coo(want),
                               atol=TOL)
    v = tp.to_tensor(vals, stop_gradient=False)
    TF.max_pool3d(tsp.sparse_coo_tensor(idx, v, shape), 3, 2, 1
                  ).values().sum().backward()
    g = v.grad.numpy()
    # each output's gradient of 1 goes to its window's max (no ties here)
    assert (g == np.round(g)).all() and g.sum() == got.values().numpy().size


# -- the layers ---------------------------------------------------------------
def _weights_of(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def test_subm_conv3d_layer_is_submanifold():
    """The reference's layer densifies: on 3 sites of a 5^3 grid it
    returns every site the dense conv touches. The port's keeps the 3
    sites and equals the reference's functional ``subm_conv3d``."""
    idx = np.array([[0, 0, 0], [1, 2, 3], [1, 2, 3], [1, 2, 3]])
    vals = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    shape = (1, 5, 5, 5, 4)
    ref = jsp.nn.SubmConv3D(4, 16, 3, padding=1)
    ours = tsp.nn.SubmConv3D(4, 16, 3, padding=1)
    layer_state_from_numpy(_weights_of(ref), ours)
    got = ours(tsp.sparse_coo_tensor(idx, vals, shape))
    assert got.nnz() == 3
    np.testing.assert_array_equal(got.indices().numpy(), idx)
    want = JF.subm_conv3d(jsp.sparse_coo_tensor(idx, vals, shape),
                          ref.weight, ref.bias, padding=1)
    _close(got.values(), want.values(), CONV_TOL)
    dense_layer = ref(jsp.sparse_coo_tensor(idx, vals, shape))
    assert dense_layer.nnz() > 3 * 16


def test_conv_layers_batchnorm_and_pool_like_jax():
    rng = np.random.default_rng(9)
    shape = (2, 7, 6, 5, 4)
    idx = _sites(rng, shape[:-1], 30)
    vals = rng.standard_normal((30, 4)).astype(np.float32)
    jnet = [jsp.nn.SubmConv3D(4, 8, 3, padding=1), jsp.nn.BatchNorm(8),
            jsp.nn.ReLU(), jsp.nn.Conv3D(8, 8, 3, stride=2, padding=1),
            jsp.nn.LeakyReLU(0.1), jsp.nn.ReLU6()]
    tnet = [tsp.nn.SubmConv3D(4, 8, 3, padding=1), tsp.nn.BatchNorm(8),
            tsp.nn.ReLU(), tsp.nn.Conv3D(8, 8, 3, stride=2, padding=1),
            tsp.nn.LeakyReLU(0.1), tsp.nn.ReLU6()]
    for j, t in zip(jnet, tnet):
        layer_state_from_numpy(_weights_of(j), t)
    xj = jsp.sparse_coo_tensor(idx, vals, shape)
    xt = tsp.sparse_coo_tensor(idx, vals, shape)
    # the reference's SubmConv3D layer densifies; its functional is the
    # submanifold conv the port's layer computes
    xj = JF.subm_conv3d(xj, jnet[0].weight, jnet[0].bias, padding=1)
    xt = tnet[0](xt)
    _close(xt.values(), xj.values(), CONV_TOL)
    for j, t in zip(jnet[1:], tnet[1:]):
        xj, xt = j(xj), t(xt)
        np.testing.assert_allclose(_dense_of_coo(xt), _dense_of_coo(xj),
                                   atol=CONV_TOL, rtol=CONV_TOL)
    _close(tnet[1].inner._mean, jnet[1].inner._mean, CONV_TOL)
    _close(tnet[1].inner._variance, jnet[1].inner._variance, CONV_TOL)
    pos = rng.uniform(0.1, 1.0, (30, 4)).astype(np.float32)
    got = tsp.nn.MaxPool3D(2)(tsp.sparse_coo_tensor(idx, pos, shape))
    want = jsp.nn.MaxPool3D(2)(jsp.sparse_coo_tensor(idx, pos, shape))
    np.testing.assert_allclose(_dense_of_coo(got), _dense_of_coo(want),
                               atol=TOL)
    sm = tsp.nn.Softmax()(tsp.sparse_coo_tensor(idx[:2], vals[:, 0],
                                                shape[:2]))
    sj = jsp.nn.Softmax()(jsp.sparse_coo_tensor(idx[:2], vals[:, 0],
                                                shape[:2]))
    _close(sm.values(), sj.values())


def test_conv2d_layers_hold_the_weight_as_the_3d_layers():
    rng = np.random.default_rng(10)
    shape = (1, 9, 8, 3)
    idx = _sites(rng, shape[:-1], 12)
    vals = rng.standard_normal((12, 3)).astype(np.float32)
    for cls, fn, kw in ((tsp.nn.Conv2D, JF.conv2d, dict(stride=2,
                                                        padding=1)),
                        (tsp.nn.SubmConv2D, JF.subm_conv2d,
                         dict(padding=1))):
        layer = cls(3, 5, 3, **kw)
        assert layer.weight.shape == [3, 3, 3, 5]
        got = layer(tsp.sparse_coo_tensor(idx, vals, shape))
        want = fn(jsp.sparse_coo_tensor(idx, vals, shape),
                  jp.to_tensor(layer.weight.numpy()),
                  jp.to_tensor(layer.bias.numpy()), **kw)
        np.testing.assert_array_equal(got.indices().numpy(),
                                      np.asarray(want.indices().numpy()))
        _close(got.values(), want.values(), CONV_TOL)


def test_pca_lowrank_of_a_sparse_tensor():
    rng = np.random.default_rng(11)
    a = (rng.standard_normal((12, 3)) @ rng.standard_normal((3, 8))).astype(
        np.float32)
    idx = np.stack(np.nonzero(a))
    u, s, v = tsp.pca_lowrank(tsp.sparse_coo_tensor(idx, a[tuple(idx)],
                                                    a.shape), q=4)
    centred = a - a.mean(0, keepdims=True)
    np.testing.assert_allclose(
        u.numpy() @ np.diag(s.numpy()) @ v.numpy().T, centred, atol=1e-4)


def test_layers_never_densify():
    """A ``Layer`` call records its inputs' shapes: on a COO input it reads
    the tensor's shape, not its dense view."""
    rng = np.random.default_rng(12)
    shape = (1, 64, 64, 64, 4)
    idx = _sites(rng, shape[:-1], 50)
    x = tsp.sparse_coo_tensor(idx, rng.standard_normal((50, 4)).astype(
        np.float32), shape)
    net = tp.nn.Sequential(tsp.nn.SubmConv3D(4, 8, 3, padding=1),
                           tsp.nn.BatchNorm(8), tsp.nn.ReLU(),
                           tsp.nn.Conv3D(8, 8, 3, stride=2, padding=1),
                           tsp.nn.MaxPool3D(2))
    with _Largest() as rec:
        out = net(x)
        out.values().sum().backward()
    assert rec.biggest < 64 ** 3, rec.biggest
    assert x._dense_cache is None and out._dense_cache is None
