"""paddle.ir: pattern rewriting over FX graphs (counterpart of
``paddle_tpu/ir/__init__.py``; the reference's IR is the jaxpr, the
port's the aten-level FX graph ``make_fx`` traces).

- :class:`RewritePattern` matches one node (``matches(node)`` inspects
  ``node.target`` and its arguments; :func:`op_name` gives the op's name,
  ``"permute"`` for ``aten.permute.default``) and emits its replacement
  with torch ops (``rewrite(*invals)``, the node's tensor inputs).
- :class:`ChainPattern` matches a chain of ops ``prims`` (each a name or
  a tuple of names) whose every intermediate has exactly one user, and
  emits ``rewrite_chain(nodes, *invals)`` from the first node's inputs.
- :meth:`PatternRewriter.rewrite` returns ``fn`` rewritten: it traces
  ``fn`` with ``make_fx`` under fake tensors, then re-traces an
  interpreter over the graph that emits each match's replacement and every
  other node as it is, to a fixpoint, and runs the result. A node that
  holds subgraphs (``torch.cond``, ``while_loop``) passes through with its
  subgraphs untouched. :func:`dead_code_elimination` keeps what reaches the
  outputs, and every host call (``static.py_func``, ``static.Print``).

The rewritten function is a plain function of tensors: call it, trace
it, differentiate it (its graph is aten ops, which torch's autograd
differentiates).
"""
from __future__ import annotations

import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils import _pytree as pytree

__all__ = ["RewritePattern", "ChainPattern", "PatternRewriter",
           "TransposePairPattern", "CastChainPattern", "AddZeroPattern",
           "dead_code_elimination", "op_name"]

#: ops a dead-code pass keeps though nothing reads their outputs
_EFFECTFUL = ("host_call",)


def op_name(node):
    """The name of the op a ``call_function`` node calls (``"permute"``,
    ``"_to_copy"``, ``"flash_fwd"``, ``"cond"``, ``"getitem"``); None for
    any other node."""
    if node.op != "call_function":
        return None
    t = node.target
    packet = getattr(t, "overloadpacket", None)
    if packet is not None:
        return packet.__name__
    return getattr(t, "__name__", str(t))


def _node_inputs(node):
    """The nodes among ``node``'s arguments, in order (through lists)."""
    return [a for a in pytree.tree_leaves((node.args, node.kwargs))
            if isinstance(a, torch.fx.Node)]


class RewritePattern:
    """One-node pattern. Subclass and implement ``matches(node) -> bool``
    and ``rewrite(*invals) -> outputs`` (a tensor, or a tuple matching the
    node's outputs)."""

    def matches(self, node) -> bool:  # pragma: no cover - abstract
        raise NotImplementedError

    def rewrite(self, *invals):  # pragma: no cover - abstract
        raise NotImplementedError


class ChainPattern(RewritePattern):
    """A chain of ops ``prims`` (first to last; each a name or a tuple of
    names) in which every intermediate has one user, the next link.
    Implement ``rewrite_chain(nodes, *invals)`` (the matched nodes, the
    first node's tensor inputs); ``chain_ok(nodes)`` may refuse a match."""

    prims: tuple = ()

    def matches(self, node) -> bool:
        return bool(self.prims) and _is(node, self.prims[0])

    def chain_ok(self, nodes) -> bool:
        return True

    def rewrite_chain(self, nodes, *invals):  # pragma: no cover - abstract
        raise NotImplementedError


def _is(node, want):
    name = op_name(node)
    return name in want if isinstance(want, tuple) else name == want


def _plan_chains(graph, patterns):
    """{first node: (pattern, [nodes])} of the chain matches, greedy in
    program order, no node in two."""
    matches, claimed = {}, set()
    for node in graph.nodes:
        if node in claimed:
            continue
        for pat in patterns:
            if not isinstance(pat, ChainPattern) or not pat.matches(node):
                continue
            nodes, cur = [node], node
            for want in pat.prims[1:]:
                users = list(cur.users)
                if len(users) != 1 or not _is(users[0], want) \
                        or not _node_inputs(users[0]) \
                        or _node_inputs(users[0])[0] is not cur:
                    nodes = None
                    break
                cur = users[0]
                nodes.append(cur)
            if nodes and not (set(nodes) & claimed) and pat.chain_ok(nodes):
                matches[node] = (pat, nodes)
                claimed.update(nodes)
                break
    return matches


def dead_code_elimination(graph):
    """The set of live nodes: those the outputs reach, the host calls and
    what they read, and the placeholders."""
    live = set()
    for node in reversed(list(graph.nodes)):
        if (node.op in ("output", "placeholder") or op_name(node) in
                _EFFECTFUL or any(u in live for u in node.users)):
            live.add(node)
    return live


def _trace(fn, example):
    """``make_fx`` of ``fn`` under fake tensors shaped as ``example``, with
    functorch's transforms off (the rewritten function may first be called
    under ``torch.func.grad``)."""
    with torch._C._DisableFuncTorch():
        like = [torch.empty_strided(tuple(t.shape), tuple(t.stride()),
                                    dtype=t.dtype, device=t.device)
                for t in example]
        return make_fx(fn, tracing_mode="fake",
                       _allow_non_fake_inputs=True)(*like)


class PatternRewriter:
    """Apply patterns greedily to a fixpoint (bounded), with dead-code
    elimination (``pir::PassManager`` + the greedy driver)."""

    def __init__(self, patterns, dce=True, max_iterations=8):
        self.patterns = list(patterns)
        self.dce = dce
        self.max_iterations = max_iterations

    def _rewrite_once(self, gm, example):
        graph = gm.graph
        chains = _plan_chains(graph, self.patterns)
        live = (dead_code_elimination(graph) if self.dce
                else set(graph.nodes))
        singles = {}
        for node in graph.nodes:
            if node in live and node.op == "call_function" and not any(
                    node in nodes for _, nodes in chains.values()):
                pat = next((p for p in self.patterns
                            if not isinstance(p, ChainPattern)
                            and p.matches(node)), None)
                if pat is not None:
                    singles[node] = pat
        changed = (bool(chains) or bool(singles)
                   or len(live) != len(graph.nodes))
        if not changed:
            return gm, False
        skip = {n for _, nodes in chains.values() for n in nodes}

        def interp(*flat):
            env, it = {}, iter(flat)

            def load(a):
                return pytree.tree_map_only(torch.fx.Node, env.__getitem__,
                                            a)

            for node in graph.nodes:
                if node.op == "placeholder":
                    env[node] = next(it)
                elif node.op == "output":
                    return load(node.args[0])
                elif node not in live:
                    continue
                elif node in chains:
                    pat, nodes = chains[node]
                    out = pat.rewrite_chain(
                        nodes, *[env[a] for a in _node_inputs(node)])
                    env[nodes[-1]] = out
                elif node in skip:
                    continue
                elif node in singles:
                    env[node] = singles[node].rewrite(
                        *[env[a] for a in _node_inputs(node)])
                elif node.op == "get_attr":
                    obj = gm
                    for part in node.target.split("."):
                        obj = getattr(obj, part)
                    env[node] = obj
                else:
                    env[node] = node.target(*load(node.args),
                                            **load(node.kwargs))
            raise AssertionError("graph without an output node")

        return _trace(interp, example), True

    def _rewritten_graph(self, fn, example):
        gm = _trace(fn, example)
        if not self.patterns and not self.dce:
            return gm
        for _ in range(self.max_iterations):
            gm, changed = self._rewrite_once(gm, example)
            if not changed:
                break
        return gm

    def _flat(self, fn, args, kwargs):
        """``(tensor leaves, flat_fn(*tensors) -> output leaves, holder
        of the output spec)`` of ``fn(*args, **kwargs)``."""
        flat, spec = pytree.tree_flatten((args, kwargs))
        pos = [i for i, a in enumerate(flat) if isinstance(a, torch.Tensor)]
        holder = {}

        def flat_fn(*tensors):
            full = list(flat)
            for i, t in zip(pos, tensors):
                full[i] = t
            a, k = pytree.tree_unflatten(full, spec)
            leaves, holder["spec"] = pytree.tree_flatten(fn(*a, **k))
            return leaves

        return [flat[i] for i in pos], flat_fn, holder

    def rewrite(self, fn):
        """``fn`` -> its rewritten counterpart (same signature). The
        rewritten graph is cached per input signature (structure, the
        tensors' shapes, types and devices, the other arguments);
        ``.graph(*args)`` of the result returns that ``GraphModule``."""
        cache = {}

        def graph(*args, **kwargs):
            flat, spec = pytree.tree_flatten((args, kwargs))
            sig = (spec, tuple(
                (tuple(a.shape), a.dtype, a.device.type)
                if isinstance(a, torch.Tensor) else repr(a) for a in flat))
            tensors, flat_fn, holder = self._flat(fn, args, kwargs)
            entry = cache.get(sig)
            if entry is None:
                gm = self._rewritten_graph(flat_fn, tensors)
                entry = cache[sig] = (gm, holder["spec"])
            return entry, tensors

        def wrapped(*args, **kwargs):
            (gm, out_spec), tensors = graph(*args, **kwargs)
            return pytree.tree_unflatten(list(gm(*tensors)), out_spec)

        wrapped.__name__ = getattr(fn, "__name__", "rewritten")
        wrapped.graph = lambda *a, **k: graph(*a, **k)[0][0]
        return wrapped

    def graph_of(self, fn, *example_args):
        """The rewritten ``GraphModule`` of ``fn`` over these arguments
        (the inspection surface; the reference's ``jaxpr_of``)."""
        tensors, flat_fn, _ = self._flat(fn, example_args, {})
        return self._rewritten_graph(flat_fn, tensors)


def graph_targets(gm):
    """The op names of ``gm``'s ``call_function`` nodes, in order."""
    return [op_name(n) for n in gm.graph.nodes if n.op == "call_function"]


# ---------------------------------------------------------------------------
# built-in patterns
# ---------------------------------------------------------------------------
_TRANSPOSES = ("permute", "transpose", "t")


def _perm(node, ndim):
    """The permutation a permute, transpose or t node applies."""
    name = op_name(node)
    if name == "permute":
        return [int(d) % ndim for d in node.args[1]]
    perm = list(range(ndim))
    if name == "transpose":
        a, b = int(node.args[1]) % ndim, int(node.args[2]) % ndim
        perm[a], perm[b] = perm[b], perm[a]
    elif ndim == 2:                                   # t
        perm = [1, 0]
    return perm


class TransposePairPattern(ChainPattern):
    """``permute(permute(x, p), q)`` is ``x`` when ``q`` inverts ``p``,
    else one permute (any pair of permute, transpose and t)."""

    prims = (_TRANSPOSES, _TRANSPOSES)

    def rewrite_chain(self, nodes, x):
        p0, p1 = _perm(nodes[0], x.dim()), _perm(nodes[1], x.dim())
        perm = [p0[i] for i in p1]
        if perm == list(range(x.dim())):
            return x
        return x.permute(perm)


_CASTS = ("_to_copy", "convert_element_type")


def _cast_dtype(node):
    """The dtype a pure type cast node casts to; None for any other node
    (a ``_to_copy`` that also moves device, layout or memory format)."""
    name = op_name(node)
    if name == "convert_element_type":
        return node.args[1]
    if name == "_to_copy" and set(node.kwargs) <= {"dtype"} \
            and len(node.args) == 1:
        return node.kwargs.get("dtype")
    return None


def _holds(mid, src):
    """Whether every value of ``src`` is a value of ``mid`` (floats)."""
    if mid == src:
        return True
    if not (mid.is_floating_point and src.is_floating_point):
        return False
    fm, fs = torch.finfo(mid), torch.finfo(src)
    return fm.eps <= fs.eps and fm.max >= fs.max and fm.tiny <= fs.tiny


class CastChainPattern(ChainPattern):
    """``cast(cast(x, a), b)`` -> ``cast(x, b)`` when ``a`` holds every
    value of ``x``'s type. A narrowing float (f32 -> bf16 -> f32 keeps the
    rounding) and any integer hop (wrap-around, truncation) keep both."""

    prims = (_CASTS, _CASTS)

    def chain_ok(self, nodes):
        return all(_cast_dtype(n) is not None for n in nodes)

    def rewrite_chain(self, nodes, x):
        mid, final = _cast_dtype(nodes[0]), _cast_dtype(nodes[1])
        if _holds(mid, x.dtype):
            return x.to(final)
        return x.to(mid).to(final)


class AddZeroPattern(RewritePattern):
    """``x + 0`` (a scalar zero, alpha 1, no type change) -> ``x``."""

    def matches(self, node):
        if op_name(node) != "add" or len(node.args) != 2:
            return False
        x, other = node.args
        if not isinstance(x, torch.fx.Node) or isinstance(
                other, torch.fx.Node) or isinstance(other, bool) \
                or not isinstance(other, (int, float)) or other != 0:
            return False
        if node.kwargs.get("alpha", 1) != 1:
            return False
        out, inp = node.meta.get("val"), x.meta.get("val")
        return (out is not None and inp is not None
                and out.dtype == inp.dtype and out.shape == inp.shape)

    def rewrite(self, *invals):
        return invals[0]
