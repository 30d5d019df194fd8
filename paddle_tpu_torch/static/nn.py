"""paddle.static.nn: static-graph layer builders and control flow
(counterpart of ``paddle_tpu/static/nn.py``).

The builders make Parameters (``static.create_parameter``: zeros unless
an initializer is given; the norms' scales ones, ``prelu``'s 0.25) and run
the same functionals the dygraph layers use, so under ``program_guard``
every call records into the program.

Control flow (``cond``, ``case``, ``switch_case``, ``while_loop``): outside
a program, a Python branch or loop on a host read. Under
``program_guard`` each branch (a loop's condition and body) is recorded
into a sub-program of its own, and the op is one record that replays the
branch its predicate picks, reading the branch's inputs from the replay
(the reference's ``lax.cond`` reads the Tensors a branch closes over as
they stood at build). A replay on real tensors picks with a host read; a
replay traced under fake tensors (``make_fx``, ``torch.export``) becomes
``torch.cond`` (nested for more than two branches) and torch's
``while_loop``, higher-order ops that hold each branch as a subgraph, so
the IR and a saved program keep the choice.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dispatch import apply_op, unwrap, wrap
from ..core.tensor import RECORDER, Tensor
from . import (Program, _Record, _sub, _value, create_parameter, py_func,
               replay)

__all__ = [
    "fc", "batch_norm", "bilinear_tensor_product", "embedding", "case",
    "cond", "static_pylayer", "conv2d", "conv2d_transpose", "conv3d",
    "conv3d_transpose", "data_norm", "deform_conv2d", "group_norm",
    "instance_norm", "layer_norm", "nce", "prelu", "py_func", "row_conv",
    "spectral_norm", "switch_case", "while_loop", "sparse_embedding",
    "sequence_conv", "sequence_softmax", "sequence_pool",
    "sequence_first_step", "sequence_last_step", "sequence_expand",
]


def _param(shape, dtype="float32", fill=None):
    p = create_parameter(shape, dtype)
    if fill is not None:
        p.set_value(torch.full([int(s) for s in shape], float(fill)))
    return p


def _act(out, act):
    if not act:
        return out
    import paddle_tpu_torch.nn.functional as F

    return getattr(F, act)(out)


# -- layer builders ---------------------------------------------------------
def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None):
    """Flatten the trailing dims, affine, optional activation."""
    import paddle_tpu_torch.nn.functional as F

    in_dim = int(np.prod(x.shape[num_flatten_dims:]))
    w = _param([in_dim, size], x.dtype.name)
    b = None if bias_attr is False else _param([size])
    flat = x.reshape(list(x.shape[:num_flatten_dims]) + [in_dim])
    return _act(F.linear(flat, w, b), activation)


def embedding(input, size, is_sparse=False, padding_idx=None,
              param_attr=None, dtype="float32"):
    import paddle_tpu_torch.nn.functional as F

    w = _param(list(size), dtype)
    return F.embedding(input, w, padding_idx=padding_idx, sparse=is_sparse)


def sparse_embedding(input, size, padding_idx=None, param_attr=None,
                     dtype="float32", **kwargs):
    """The parameter-server table is not ported (ROADMAP A.10): the dense
    embedding, the reference's path outside PS mode."""
    return embedding(input, size, padding_idx=padding_idx, dtype=dtype)


def batch_norm(input, act=None, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               is_test=False, **kwargs):
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.nn.functional as F

    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale, bias = _param([c], fill=1.0), _param([c])
    mean, var = paddle.zeros([c]), paddle.ones([c])
    out = F.batch_norm(input, mean, var, weight=scale, bias=bias,
                       training=not is_test, momentum=momentum,
                       epsilon=epsilon, data_format=data_layout)
    return _act(out, act)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None):
    import paddle_tpu_torch.nn.functional as F

    shape = list(input.shape[begin_norm_axis:])
    w = _param(shape, fill=1.0) if scale else None
    b = _param(shape) if shift else None
    return _act(F.layer_norm(input, shape, weight=w, bias=b,
                             epsilon=epsilon), act)


def group_norm(input, groups, epsilon=1e-5, param_attr=None,
               bias_attr=None, act=None, data_layout="NCHW"):
    import paddle_tpu_torch.nn.functional as F

    c = input.shape[1]
    w, b = _param([c], fill=1.0), _param([c])
    return _act(F.group_norm(input, groups, epsilon=epsilon, weight=w,
                             bias=b), act)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None):
    import paddle_tpu_torch.nn.functional as F

    c = input.shape[1]
    w, b = _param([c], fill=1.0), _param([c])
    return F.instance_norm(input, weight=w, bias=b, eps=epsilon)


def data_norm(input, act=None, epsilon=1e-5, param_attr=None, **kwargs):
    """Normalization by the batch's statistics (CTR models)."""
    mean = input.mean(axis=0, keepdim=True)
    std = ((input - mean) ** 2).mean(axis=0, keepdim=True)
    return _act((input - mean) / (std + epsilon).sqrt(), act)


def _conv(input, num_filters, filter_size, stride, padding, dilation,
          groups, nd, transpose=False):
    import paddle_tpu_torch.nn.functional as F

    c_in = input.shape[1]
    ks = ([filter_size] * nd if isinstance(filter_size, int)
          else list(filter_size))
    if transpose:
        w = _param([c_in, num_filters // (groups or 1)] + ks)
        fn = F.conv2d_transpose if nd == 2 else F.conv3d_transpose
    else:
        w = _param([num_filters, c_in // (groups or 1)] + ks)
        fn = F.conv2d if nd == 2 else F.conv3d
    return fn(input, w, bias=None, stride=stride, padding=padding,
              dilation=dilation, groups=groups or 1)


def conv2d(input, num_filters, filter_size, stride=1, padding=0,
           dilation=1, groups=None, param_attr=None, bias_attr=None,
           act=None, **kwargs):
    return _act(_conv(input, num_filters, filter_size, stride, padding,
                      dilation, groups, nd=2), act)


def conv3d(input, num_filters, filter_size, stride=1, padding=0,
           dilation=1, groups=None, **kwargs):
    return _conv(input, num_filters, filter_size, stride, padding,
                 dilation, groups, nd=3)


def conv2d_transpose(input, num_filters, output_size=None, filter_size=3,
                     stride=1, padding=0, dilation=1, groups=None, **kw):
    return _conv(input, num_filters, filter_size, stride, padding,
                 dilation, groups, nd=2, transpose=True)


def conv3d_transpose(input, num_filters, output_size=None, filter_size=3,
                     stride=1, padding=0, dilation=1, groups=None, **kw):
    return _conv(input, num_filters, filter_size, stride, padding,
                 dilation, groups, nd=3, transpose=True)


def deform_conv2d(input, offset, mask, num_filters, filter_size, stride=1,
                  padding=0, dilation=1, groups=None, deformable_groups=1,
                  **kwargs):
    from ..vision.ops import deform_conv2d as _dc

    c_in = input.shape[1]
    ks = ([filter_size] * 2 if isinstance(filter_size, int)
          else list(filter_size))
    w = _param([num_filters, c_in // (groups or 1)] + ks)
    return _dc(input, offset, w, mask=mask, stride=stride, padding=padding,
               dilation=dilation, deformable_groups=deformable_groups,
               groups=groups or 1)


def bilinear_tensor_product(x, y, size, act=None, param_attr=None,
                            bias_attr=None, name=None):
    import paddle_tpu_torch.nn.functional as F

    w = _param([size, x.shape[-1], y.shape[-1]])
    b = _param([size])
    return _act(F.bilinear(x, y, w, b), act)


def prelu(x, mode="all", param_attr=None, data_format="NCHW", name=None):
    """``mode`` "all" (one slope), "channel" (a slope a channel) or
    "element" (a slope an element of a sample; the reference hands that
    weight to ``F.prelu``, which broadcasts it as channels and raises)."""
    import paddle_tpu_torch.nn.functional as F

    if mode == "element":
        alpha = _param([1] + list(x.shape[1:]), fill=0.25)
        return apply_op(lambda a, w: torch.where(a > 0, a, w * a), x, alpha,
                        _op_name="prelu")
    alpha = _param([1 if mode == "all" else x.shape[1]], fill=0.25)
    return F.prelu(x, alpha)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """A weight over its largest singular value, by power iteration from
    a uniform start."""
    def _sn(w):
        mat = torch.movedim(w, dim, 0).reshape(w.shape[dim], -1).float()
        u = torch.ones(mat.shape[0], device=w.device) / np.sqrt(mat.shape[0])
        v = None
        for _ in range(max(power_iters, 1)):
            v = mat.T @ u
            v = v / torch.clamp_min(torch.linalg.norm(v), eps)
            u = mat @ v
            u = u / torch.clamp_min(torch.linalg.norm(u), eps)
        sigma = u @ mat @ v
        return w / sigma.to(w.dtype)

    return apply_op(_sn, weight, _op_name="spectral_norm")


def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=10, name=None,
        seed=0, **kwargs):
    """Noise-contrastive estimation loss, uniform negatives drawn once
    from ``torch.Generator().manual_seed(seed)`` at each run (the
    reference draws them from ``jax.random.PRNGKey(0)``)."""
    dim = input.shape[-1]
    w = _param([num_total_classes, dim])
    b = _param([num_total_classes])

    def _nce(h, y, wv, bv):
        n = h.shape[0]
        gen = torch.Generator().manual_seed(seed)
        neg = torch.randint(0, num_total_classes, (n, num_neg_samples),
                            generator=gen).to(h.device)
        y = y.reshape(-1)
        pos_logit = (h * wv[y]).sum(-1) + bv[y]
        neg_logit = torch.einsum("nd,nkd->nk", h, wv[neg]) + bv[neg]
        pos_loss = torch.nn.functional.softplus(-pos_logit)
        neg_loss = torch.nn.functional.softplus(neg_logit).sum(-1)
        return (pos_loss + neg_loss).reshape(n, 1)

    return apply_op(_nce, input, label, w, b, _op_name="nce")


def _pad_axis1(x, before, after):
    """``x`` zero-padded on axis 1."""
    pad = [0, 0] * (x.dim() - 2) + [before, after]
    return torch.nn.functional.pad(x, pad)


def row_conv(input, future_context_size, param_attr=None, act=None):
    """Lookahead row convolution: out[t] = sum_{i<=k} w[i] * x[t+i]."""
    d = input.shape[-1]
    w = _param([future_context_size + 1, d])

    def _rc(x, wv):
        k = wv.shape[0]
        xp = _pad_axis1(x, 0, k - 1)
        out = sum(xp[:, i:i + x.shape[1]] * wv[i] for i in range(k))
        return out.to(x.dtype)

    return _act(apply_op(_rc, input, w, _op_name="row_conv"), act)


# -- sequence ops (padded batches; the lod-free form) -----------------------
def sequence_softmax(input, axis=1, **kwargs):
    import paddle_tpu_torch.nn.functional as F

    return F.softmax(input, axis=axis)


def sequence_pool(input, pool_type="sum", **kwargs):
    pool_type = pool_type.lower()
    if pool_type == "sum":
        return input.sum(axis=1)
    if pool_type in ("average", "avg", "mean"):
        return input.mean(axis=1)
    if pool_type == "max":
        return input.max(axis=1)
    if pool_type == "sqrt":
        return input.sum(axis=1) / float(np.sqrt(input.shape[1]))
    if pool_type == "first":
        return sequence_first_step(input)
    if pool_type == "last":
        return sequence_last_step(input)
    raise ValueError(f"unknown pool_type {pool_type!r}")


def sequence_first_step(input):
    return input[:, 0]


def sequence_last_step(input):
    return input[:, -1]


def sequence_expand(x, y, ref_level=-1):
    def _se(xa, ya):
        rep = ya.shape[1] // max(xa.shape[1], 1)
        return torch.repeat_interleave(xa, rep, dim=1)

    return apply_op(_se, x, y, _op_name="sequence_expand")


def sequence_conv(input, num_filters, filter_size=3, padding=True,
                  param_attr=None, bias_attr=None, act=None, **kwargs):
    d = input.shape[-1]
    w = _param([filter_size * d, num_filters])

    def _sc(x, wv):
        k = filter_size
        half = (k - 1) // 2
        xp = _pad_axis1(x, half, k - 1 - half)
        windows = torch.cat([xp[:, i:i + x.shape[1]] for i in range(k)],
                            dim=-1)
        return windows @ wv

    return _act(apply_op(_sc, input, w, _op_name="sequence_conv"), act)


# -- control flow -----------------------------------------------------------
def _capture(fn, *args):
    """``fn(*args)`` with its ops recorded into a sub-program of their
    own: ``(records, output)``."""
    sub = Program()
    prev, RECORDER.program = RECORDER.program, sub
    try:
        out = fn(*args)
    finally:
        RECORDER.program = prev
    return sub.records, out


def _out_list(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _externals(records, outs, given=()):
    """The Tensors ``records`` read (and ``outs`` name) that no record of
    them makes and ``given`` does not hold, in first-use order."""
    made = {id(t) for t in given}
    for r in records:
        made.update(id(o) for o in r.outs)
    seen, ext = set(), []
    for t in [t for r in records for t in r.inputs()] + [
            o for o in outs if isinstance(o, Tensor)]:
        if id(t) not in made and id(t) not in seen:
            seen.add(id(t))
            ext.append(t)
    return ext


def _tracing(values):
    """Whether a replay is being traced (fake tensors or a proxy mode):
    a branch is then chosen by a higher-order op, not a host read."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.fx.experimental.proxy_tensor import get_proxy_mode

    return get_proxy_mode() is not None or any(
        isinstance(v, FakeTensor) for v in values)


def _lifted(values):
    """Inside a trace, a recorded constant (a real tensor) as a traced
    copy, so a higher-order op takes it as an operand."""
    from torch._subclasses.fake_tensor import FakeTensor

    return [v if isinstance(v, FakeTensor) else v.clone() for v in values]


def _run_branch(records, outs, ext, values, given=(), gvalues=()):
    """A branch's outputs over a local environment of its inputs."""
    env = {id(t): v for t, v in zip(ext, values)}
    env.update((id(t), v) for t, v in zip(given, gvalues))
    replay(records, env)
    return tuple(_value(env, o) for o in outs)


class _Branches(_Record):
    """``cond``/``case``/``switch_case`` in a program: ``select`` maps the
    selector inputs' values to a 0-d integer tensor, the branch to run."""

    __slots__ = ("select", "branches", "ext")

    def __init__(self, sel, select, branches, name):
        ext, seen = [], set()
        for recs, outs in branches:
            for t in _externals(recs, outs):
                if id(t) not in seen:
                    seen.add(id(t))
                    ext.append(t)
        super().__init__(None, tuple(sel), {}, [], name)
        self.select, self.branches, self.ext = select, branches, ext

    def inputs(self):
        return list(self.args) + list(self.ext)

    def run(self, env):
        sel = [_sub(t, env) for t in self.args]
        ext = [_sub(t, env) for t in self.ext]
        idx = self.select(*sel)
        fns = [lambda *v, b=b: _run_branch(b[0], b[1], self.ext, v)
               for b in self.branches]
        if _tracing(sel + ext):
            def pick(j):
                if j == len(fns) - 1:
                    return fns[j]
                return lambda *v: torch.cond(idx == j, fns[j], pick(j + 1),
                                             tuple(v))
            out = pick(0)(*_lifted(ext))
        else:
            out = fns[int(idx)](*ext)
        for t, o in zip(self.outs, out):
            env[id(t)] = o


def _commit(rec, n):
    """Run a control-flow record on the build-time values, give it ``n``
    new output Tensors and append it to the active program."""
    keys = [object() for _ in range(n)]
    rec.outs = keys
    env = {}
    rec.run(env)
    rec.outs = [Tensor._wrap(env[id(k)]) for k in keys]
    RECORDER.program.records.append(rec)
    return rec.outs


def _branching(sel, select, fns, name):
    """Record ``fns`` (each a branch) in sub-programs and one
    :class:`_Branches` into the active program; its outputs as new
    Tensors, structured as the first branch's."""
    branches = []
    for fn in fns:
        recs, out = _capture(fn)
        branches.append((recs, _out_list(out)))
        if len(branches) == 1:
            first = out
    outs = _commit(_Branches(sel, select, branches, name),
                   len(branches[0][1]))
    if not isinstance(first, (list, tuple)):
        return outs[0]
    return tuple(outs) if isinstance(first, tuple) else outs


def _b(p):
    return p.reshape(()).bool()


def cond(pred, true_fn=None, false_fn=None, name=None, return_names=None):
    """``true_fn()`` where ``pred`` holds, else ``false_fn()``."""
    if RECORDER.program is None:
        return true_fn() if bool(pred) else false_fn()
    return _branching([pred], lambda p: (~_b(p)).long(),
                      [true_fn, false_fn], "cond")


def _case_fns(pred_fn_pairs, default):
    fns = [fn for _, fn in pred_fn_pairs]
    return fns + [default if default is not None else fns[-1]]


def case(pred_fn_pairs, default=None, name=None):
    """The first pair whose predicate holds runs; else ``default`` (the
    last pair's function without one)."""
    fns = _case_fns(pred_fn_pairs, default)
    if RECORDER.program is None:
        for p, fn in pred_fn_pairs:
            if bool(p):
                return fn()
        return fns[-1]()

    def select(*ps):
        hit = torch.stack([_b(p) for p in ps] + [
            torch.ones((), dtype=torch.bool, device=ps[0].device)])
        return hit.to(torch.int32).argmax()

    return _branching([p for p, _ in pred_fn_pairs], select, fns, "case")


def _switch_plan(branch_fns, default):
    """``(functions, select(idx) -> position)`` of ``switch_case``: a
    list clips the index into range; a dict maps its keys onto their
    sorted positions and any other index to ``default`` (to the first
    key's branch without one)."""
    if isinstance(branch_fns, dict):
        keys = sorted(branch_fns)
        fns = [branch_fns[k] for k in keys]
        if default is not None:
            fns.append(default)

        def select(idx):
            idx = idx.reshape(())
            pos = sum(torch.where(idx == k, i, 0) for i, k in enumerate(keys))
            if default is not None:
                known = sum((idx == k).to(torch.int32) for k in keys)
                pos = torch.where(known > 0, pos, len(keys))
            return torch.as_tensor(pos).long()

        return fns, select
    fns = list(branch_fns)
    return fns, lambda idx: torch.clamp(idx.reshape(()).long(), 0,
                                        len(fns) - 1)


def switch_case(branch_index, branch_fns, default=None, name=None):
    fns, select = _switch_plan(branch_fns, default)
    if RECORDER.program is None:
        return fns[int(select(unwrap(branch_index)))]()
    return _branching([branch_index], select, fns, "switch_case")


class _Loop(_Record):
    """``while_loop`` in a program: the condition's and the body's
    sub-programs over loop placeholders."""

    __slots__ = ("ph", "cond_b", "body_b", "ext")

    def __init__(self, init, ph, cond_b, body_b):
        super().__init__(None, tuple(init), {}, [], "while_loop")
        self.ph, self.cond_b, self.body_b = ph, cond_b, body_b
        self.ext = _externals(cond_b[0] + body_b[0], cond_b[1] + body_b[1],
                              ph)

    def inputs(self):
        return list(self.args) + list(self.ext)

    def run(self, env):
        vals = tuple(_sub(t, env) for t in self.args)
        ext = [_sub(t, env) for t in self.ext]

        def c(*v):
            return _b(_run_branch(*self.cond_b, self.ext, ext, self.ph, v)[0])

        def body(*v):
            return _run_branch(*self.body_b, self.ext, ext, self.ph, v)

        if _tracing(list(vals) + ext):
            from torch._higher_order_ops.while_loop import \
                while_loop as _hop

            ext = _lifted(ext)
            vals = _hop(c, body, tuple(_lifted(vals)))
        else:
            while bool(c(*vals)):
                vals = body(*vals)
        for t, o in zip(self.outs, vals):
            env[id(t)] = o


def while_loop(cond, body, loop_vars, is_test=False, name=None):
    """Run ``body`` while ``cond`` holds; returns the loop variables."""
    if RECORDER.program is None:
        vals = list(loop_vars)
        while bool(cond(*vals)):
            vals = _out_list(body(*vals))
        return tuple(vals)
    ph = [Tensor._wrap(unwrap(v)) for v in loop_vars]

    def captured(fn):
        recs, out = _capture(fn, *ph)
        return recs, _out_list(out)

    rec = _Loop(loop_vars, ph, captured(cond), captured(body))
    return tuple(_commit(rec, len(ph)))


def static_pylayer(forward_fn, inputs, backward_fn=None, name=None):
    """A region with its own backward: ``forward_fn`` on the inputs,
    ``backward_fn`` on the output gradients (a ``torch.autograd
    .Function``); without ``backward_fn``, ``forward_fn`` as it is."""
    if backward_fn is None:
        return forward_fn(*inputs)
    xs = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]

    class _Layer(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *arrays):
            prev, RECORDER.program = RECORDER.program, None
            try:
                out = forward_fn(*[Tensor._wrap(a) for a in arrays])
            finally:
                RECORDER.program = prev
            return unwrap(out)

        @staticmethod
        def backward(ctx, *grads):
            prev, RECORDER.program = RECORDER.program, None
            try:
                gs = backward_fn(*wrap(list(grads)))
            finally:
                RECORDER.program = prev
            return tuple(unwrap(g) for g in _out_list(gs))

    return apply_op(_Layer.apply, *xs, _op_name="static_pylayer")
