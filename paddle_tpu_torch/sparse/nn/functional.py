"""``paddle.sparse.nn.functional`` (counterpart of
``paddle_tpu/sparse/nn/functional.py``): value-wise activations, the
segment softmax, O(nnz) attention, and the rulebook convolutions and max
pooling.

Everything here runs on the indices' own device. The reference builds its
row keys and its rulebook in numpy on the host; the port builds both from
the index tensor with ``torch.unique``, ``torch.searchsorted`` and the
same row-major linearisation, all kernel offsets at once, so that the
only host reads are the sizes that shape a result (the number of output
sites, and one vector of per-offset pair counts). An offset with no pair
is skipped without a launch.

A conv is, per kernel offset, a gather of the input rows, one
``[n, Cin] @ [Cin, Cout]`` product and an ``index_add`` into the output
rows; peak memory is O(nnz * C), never O(volume). Segment maxima are
``scatter_reduce(..., "amax", include_self=False)``: where inputs tie,
torch splits a max's gradient evenly between them.
"""
from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as F

from ...core.dispatch import apply_op
from .. import SparseCooTensor, _linear, _unravel, to_sparse_coo_auto

__all__ = ["relu", "relu6", "leaky_relu", "softmax", "attention", "conv2d",
           "conv3d", "subm_conv2d", "subm_conv3d", "subm_conv2d_igemm",
           "subm_conv3d_igemm", "max_pool3d"]


def _valuewise(name, tfn):
    def op(x, *args, **kwargs):
        if isinstance(x, SparseCooTensor):
            vals = apply_op(tfn, x.values(), _op_name=name)
            return SparseCooTensor(x.indices(), vals, tuple(x.shape))
        return apply_op(tfn, x, _op_name=name)

    op.__name__ = name
    return op


relu = _valuewise("relu", torch.relu)
relu6 = _valuewise("relu6", lambda a: a.clamp(0, 6))


def leaky_relu(x, negative_slope=0.01):
    return _valuewise("leaky_relu",
                      lambda a: torch.where(a >= 0, a, negative_slope * a))(x)


def _row_keys(indices, shape):
    """Linearised leading-dims row id of each stored element, and the row
    count (the reference's ``:36-45``, on the device)."""
    lead = [int(s) for s in shape[:-1]]
    return _linear(indices[:len(lead)], lead), math.prod(lead)


def _segment_max(vals, rows, nrows):
    return vals.new_zeros((nrows,) + tuple(vals.shape[1:])).scatter_reduce(
        0, rows.view((-1,) + (1,) * (vals.dim() - 1)).expand_as(vals), vals,
        "amax", include_self=False)


def _segment_sum(vals, rows, nrows):
    return vals.new_zeros((nrows,) + tuple(vals.shape[1:])).index_add(
        0, rows, vals)


def softmax(x, axis=-1):
    """Softmax over the stored values of each row of the last axis: a
    segment max and a segment sum by row key, O(nnz). The max only shifts
    the exponent, so it is taken without a gradient."""
    if isinstance(x, SparseCooTensor):
        if axis not in (-1, len(x.shape) - 1):
            raise ValueError("sparse softmax supports the last axis only "
                             "(reference kernel contract)")
        rows, nrows = _row_keys(x.indices()._data, x.shape)

        def _sm(vals):
            m = _segment_max(vals.detach(), rows, nrows)
            e = torch.exp(vals - m[rows])
            return e / _segment_sum(e, rows, nrows)[rows]

        vals = apply_op(_sm, x.values(), _op_name="sparse_softmax")
        return SparseCooTensor(x.indices(), vals, tuple(x.shape))
    return apply_op(lambda a: torch.softmax(a, dim=axis), x,
                    _op_name="softmax")


def attention(query, key, value, sparse_mask, key_padding_mask=None,
              attn_mask=None, name=None):
    """Attention at ``sparse_mask``'s pairs only: q.k at each stored
    (g, i, j) (the SDDMM), a segment softmax over each query row's stored
    scores, then a segment sum of p * v[j] into row (g, i). q, k, v are
    ``[B, H, S, D]``, ``sparse_mask`` a ``[B*H, S, S]`` COO tensor;
    ``key_padding_mask`` ``[B, S]`` and ``attn_mask`` ``[S, S]`` are
    additive. The ``[S, S]`` scores are never made. A row whose stored
    scores are all -inf gives 0."""
    if not isinstance(sparse_mask, SparseCooTensor):
        raise ValueError("sparse_mask must be a SparseCooTensor")
    ind = sparse_mask.indices()

    def _attn(q, k, v, idx, kp, am):
        B, H, S, D = q.shape
        qf = q.reshape(B * H, S, D)
        kf = k.reshape(B * H, S, D)
        vf = v.reshape(B * H, S, D)
        g, i, j = idx[0], idx[1], idx[2]
        rows = g * S + i
        scores = torch.einsum("nd,nd->n", qf[g, i], kf[g, j]) / math.sqrt(D)
        if kp is not None:
            scores = scores + kp[g // H, j]
        if am is not None:
            scores = scores + am[i, j]
        # the row max clamped, so a row of -inf scores gives weights of 0
        # and not exp(-inf - -inf) = NaN
        m = _segment_max(scores.detach(), rows, B * H * S).clamp_min(-1e30)
        e = torch.exp(scores - m[rows])
        s = _segment_sum(e, rows, B * H * S)
        p = e / s[rows].clamp_min(1e-30)
        out = _segment_sum(p[:, None] * vf[g, j], rows, B * H * S)
        return out.reshape(B, H, S, D)

    return apply_op(_attn, query, key, value, ind, key_padding_mask,
                    attn_mask, _op_name="sparse_attention")


# -- the rulebook -----------------------------------------------------------
def _build_rulebook(indices, spatial, ksize, stride, padding, dilation,
                    subm, batch_size=1):
    """The gather/scatter pairs of a sparse conv, per kernel offset
    (the reference's ``:120-213``, on ``indices``' device).

    ``indices`` [1+nd, nnz] int64 (batch, then the spatial coordinates),
    free of duplicates. Returns ``(out_indices [1+nd, n_out], rulebook,
    out_dims)``; ``rulebook[k]`` is ``(in_rows, out_rows)``, both in the
    reference's order, for offset ``k`` of ``itertools.product`` over
    ``ksize``."""
    nd = len(ksize)
    dev = indices.device
    coords = indices.T.to(torch.int64)                     # [nnz, 1+nd]
    n = coords.shape[0]
    dims = [int(batch_size)] + [int(s) for s in spatial]
    offsets = torch.tensor(list(itertools.product(*[range(k) for k in ksize])),
                           dtype=torch.int64, device=dev).reshape(-1, nd)
    dil = torch.tensor(dilation, dtype=torch.int64, device=dev)
    sp = torch.tensor(spatial, dtype=torch.int64, device=dev)

    if subm:
        if n == 0:
            empty = indices.new_zeros((0,))
            return indices, [(empty, empty)] * len(offsets), dims
        center = torch.tensor([(k - 1) // 2 for k in ksize], device=dev)
        delta = (offsets - center) * dil                       # [K, nd]
        cand = coords[None, :, 1:] + delta[:, None, :]          # [K, n, nd]
        valid = ((cand >= 0) & (cand < sp)).all(-1)
        key = torch.cat([coords[None, :, :1].expand(len(offsets), -1, -1),
                         torch.where(valid[..., None], cand, 0)], -1)
        lin = _linear(key.reshape(-1, 1 + nd).T, dims).view(len(offsets), n)
        in_sorted, order = torch.sort(_linear(indices, dims))
        pos = torch.searchsorted(in_sorted, lin).clamp_max(n - 1)
        hit = valid & (in_sorted[pos] == lin)
        k_of, out_row = torch.nonzero(hit, as_tuple=True)
        counts = torch.bincount(k_of, minlength=len(offsets)).tolist()
        in_rows = order[pos[k_of, out_row]]
        return (indices, list(zip(in_rows.split(counts),
                                  out_row.split(counts))), dims)

    out_spatial = [
        (spatial[d] + 2 * padding[d] - dilation[d] * (ksize[d] - 1) - 1)
        // stride[d] + 1 for d in range(nd)]
    st = torch.tensor(stride, dtype=torch.int64, device=dev)
    osp = torch.tensor(out_spatial, dtype=torch.int64, device=dev)
    pad = torch.tensor(padding, dtype=torch.int64, device=dev)
    # input q meets output p = (q + pad - off * dil) / stride
    num = coords[None, :, 1:] + (pad - offsets * dil)[:, None, :]
    p = torch.div(num, st, rounding_mode="floor")
    ok = ((num % st == 0) & (p >= 0) & (p < osp)).all(-1)     # [K, n]
    k_of, in_row = torch.nonzero(ok, as_tuple=True)
    counts = torch.bincount(k_of, minlength=len(offsets)).tolist()
    out_coord = torch.cat([coords[in_row, :1], p[k_of, in_row]], 1)
    out_dims = [dims[0]] + out_spatial
    uniq, inverse = torch.unique(_linear(out_coord.T, out_dims),
                                 return_inverse=True)
    out_idx = _unravel(uniq, out_dims)
    return (out_idx, list(zip(in_row.split(counts), inverse.split(counts))),
            out_dims)


def _rulebook_conv_values(values, w_flat, bias, rulebook, n_out):
    """values [nnz, Cin], w_flat [K, Cin, Cout]: per offset a gather, one
    product and an ``index_add``. Peak memory O(nnz * C)."""
    out = values.new_zeros((n_out, w_flat.shape[-1]))
    for k, (ii, oi) in enumerate(rulebook):
        if ii.numel() == 0:
            continue
        out.index_add_(0, oi, values.index_select(0, ii) @ w_flat[k])
    if bias is not None:
        out = out + bias
    return out


def _coalesced_sites(x, nd):
    """x's site indices without duplicates (the first occurrence of each,
    in sorted order), and a function that sums duplicate sites' values
    onto them; ``None`` for that function when there are none."""
    ind = x.indices()._data
    spatial = [int(s) for s in x.shape[1:1 + nd]]
    dims = [int(x.shape[0])] + spatial
    uniq, inv = torch.unique(_linear(ind[:1 + nd], dims), return_inverse=True)
    if uniq.numel() == ind.shape[1]:
        return ind[:1 + nd], None
    return _unravel(uniq, dims), (
        lambda v: v.new_zeros((uniq.numel(),) + tuple(v.shape[1:])
                              ).index_add(0, inv, v))


def _tuple(v, nd):
    return (v,) * nd if isinstance(v, int) else tuple(v)


def _conv_nd_rulebook(x, weight, bias, stride, padding, dilation, subm, nd):
    if subm and any(s != 1 for s in stride):
        raise ValueError(
            "submanifold conv preserves the input sparsity pattern; "
            f"stride={tuple(stride)} is not representable (use the "
            "non-subm conv for strided downsampling)")
    sites, merge = _coalesced_sites(x, nd)
    spatial = [int(s) for s in x.shape[1:1 + nd]]
    out_idx, rulebook, out_dims = _build_rulebook(
        sites, spatial, [int(weight.shape[d]) for d in range(nd)],
        list(stride), list(padding), list(dilation), subm,
        batch_size=int(x.shape[0]))
    n_out = out_idx.shape[1]
    cout = int(weight.shape[-1])

    def _compute(vals, w, b):
        if merge is not None:
            vals = merge(vals)
        w_flat = w.reshape((-1,) + tuple(w.shape[-2:]))       # [K, Cin, Cout]
        return _rulebook_conv_values(vals, w_flat, b, rulebook, n_out)

    out_vals = apply_op(_compute, x.values(), weight, bias,
                        _op_name=f"subm_conv{nd}d" if subm
                        else f"sparse_conv{nd}d")
    return SparseCooTensor(out_idx, out_vals, tuple(out_dims) + (cout,))


def _conv_nd(x, weight, bias, stride, padding, dilation, groups, subm, nd):
    """A COO input with ``groups == 1`` takes the rulebook conv; a dense
    input or a grouped conv takes the dense conv, and comes back as COO
    (the reference's ``:231-293``)."""
    stride, padding, dilation = (_tuple(v, nd)
                                 for v in (stride, padding, dilation))
    if isinstance(x, SparseCooTensor) and groups == 1:
        return _conv_nd_rulebook(x, weight, bias, stride, padding,
                                 dilation, subm, nd)
    dense = x.to_dense() if isinstance(x, SparseCooTensor) else x
    conv = F.conv3d if nd == 3 else F.conv2d

    def _c(a, w, b):
        # channels last in and out; w [*k, Cin/groups, Cout]
        perm = (0, nd + 1) + tuple(range(1, nd + 1))
        wt = w.permute((nd + 1, nd) + tuple(range(nd)))
        out = conv(a.permute(perm), wt, None, stride, padding, dilation,
                   groups)
        out = out.permute((0,) + tuple(range(2, nd + 2)) + (1,))
        return out if b is None else out + b

    out = apply_op(_c, dense, weight, bias, _op_name=f"sparse_conv{nd}d")
    if subm and isinstance(x, SparseCooTensor):
        # zero wherever the input had no active site (any channel)
        out = apply_op(lambda o, a: o * (a != 0).any(-1, keepdim=True).to(
            o.dtype), out, dense, _op_name="subm_mask")
    return to_sparse_coo_auto(out)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NDHWC", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups,
                    subm=False, nd=3)


def subm_conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1,
                groups=1, data_format="NDHWC", key=None, name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups,
                    subm=True, nd=3)


def subm_conv3d_igemm(x, weight, bias=None, stride=1, padding=0, dilation=1,
                      groups=1, data_format="NDHWC", key=None, name=None):
    return subm_conv3d(x, weight, bias, stride, padding, dilation, groups)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NHWC", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups,
                    subm=False, nd=2)


def subm_conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1,
                groups=1, data_format="NHWC", key=None, name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups,
                    subm=True, nd=2)


def subm_conv2d_igemm(x, weight, bias=None, stride=1, padding=0, dilation=1,
                      groups=1, data_format="NHWC", key=None, name=None):
    return subm_conv2d(x, weight, bias, stride, padding, dilation, groups)


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NDHWC", name=None):
    """The max over each output site's active inputs, over the rulebook of
    a conv with the pool's window (all pairs in one ``scatter_reduce``).
    An output site exists where its window holds an active input; the
    reference densifies, so its max also sees the inactive sites' zeros
    (the two agree where the values are positive, as after a ReLU)."""
    ks = _tuple(kernel_size, 3)
    st = ks if stride is None else _tuple(stride, 3)
    pd = _tuple(padding, 3)
    if not isinstance(x, SparseCooTensor):
        def _mp(a):
            out = F.max_pool3d(a.permute(0, 4, 1, 2, 3), ks, st, pd)
            return out.permute(0, 2, 3, 4, 1)

        return to_sparse_coo_auto(apply_op(_mp, x,
                                           _op_name="sparse_max_pool3d"))
    sites, merge = _coalesced_sites(x, 3)
    out_idx, rulebook, out_dims = _build_rulebook(
        sites, [int(s) for s in x.shape[1:4]], list(ks), list(st), list(pd),
        [1, 1, 1], subm=False, batch_size=int(x.shape[0]))
    ii = torch.cat([p[0] for p in rulebook])
    oi = torch.cat([p[1] for p in rulebook])
    n_out = out_idx.shape[1]

    def _pool(vals):
        if merge is not None:
            vals = merge(vals)
        g = vals.index_select(0, ii)
        return g.new_zeros((n_out,) + tuple(g.shape[1:])).scatter_reduce(
            0, oi[:, None].expand_as(g), g, "amax", include_self=False)

    out = apply_op(_pool, x.values(), _op_name="sparse_max_pool3d")
    return SparseCooTensor(out_idx, out, tuple(out_dims) + (x.shape[-1],))
