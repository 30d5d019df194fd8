"""The op registry: per-op metadata the reference keeps in YAML.

Counterpart of ``paddle_tpu/ops/registry.py`` (a copy of its table, as the
port imports nothing of the JAX package). Each ``OpSpec`` holds:

- ``inplace``: the ``{"x": "out"}`` contract of an op whose
  trailing-underscore Tensor method writes its first argument (in this
  port the method rebinds, see ``core/tensor.py``); every such method of
  ``Tensor`` has one;
- ``spmd_rule``: the name of its sharding rule. It stays a string until
  ROADMAP A.10 ports ``distributed/spmd_rules.py``;
- ``backward``: whether it is differentiable;
- ``tags``: coarse groups (math, manipulation, creation...).

``apply_op`` never looks an op up here: the hot path stays one attribute
check (``core/dispatch.py``). A recorded static program reads the table
after the fact, one lookup per recorded op (``static.Program.op_specs``).
"""
from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["OpSpec", "register_op", "get_op_spec", "registered_ops"]


@dataclass(frozen=True)
class OpSpec:
    name: str
    inplace: dict = field(default_factory=dict)   # {"x": "out"} aliasing
    spmd_rule: str | None = None                  # name in spmd_rules registry
    backward: bool = True                         # differentiable on the tape
    tags: tuple = ()


_REGISTRY: dict[str, OpSpec] = {}


def register_op(name, inplace=None, spmd_rule=None, backward=True, tags=()):
    spec = OpSpec(name, dict(inplace or {}), spmd_rule, backward,
                  tuple(tags))
    _REGISTRY[name] = spec
    return spec


def get_op_spec(name) -> OpSpec | None:
    return _REGISTRY.get(name)


def registered_ops():
    return dict(_REGISTRY)


# ---------------------------------------------------------------------------
# registry population
# ---------------------------------------------------------------------------
_ELEMENTWISE_UNARY = [
    "abs", "acos", "acosh", "asin", "asinh", "atan", "atanh", "ceil", "cos",
    "cosh", "digamma", "erf", "erfinv", "exp", "expm1", "floor", "frac",
    "i0", "lgamma", "log", "log10", "log1p", "log2", "logit", "neg",
    "reciprocal", "round", "rsqrt", "sigmoid", "sin", "sinc", "sinh",
    "sqrt", "square", "tan", "tanh", "trunc", "nan_to_num", "polygamma",
    "multigammaln", "gammaln",
]
_ELEMENTWISE_BINARY = [
    "add", "subtract", "multiply", "divide", "floor_divide", "floor_mod",
    "mod", "remainder", "pow", "maximum", "minimum", "copysign", "hypot",
    "ldexp", "lerp", "gammainc", "gammaincc",
]
_LOGIC = [
    "equal", "not_equal", "greater_equal", "greater_than", "less",
    "less_equal", "less_than", "logical_and", "logical_or", "logical_not",
    "logical_xor", "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "bitwise_invert", "bitwise_left_shift", "bitwise_right_shift", "isclose",
    "allclose", "isnan", "isinf", "isfinite",
]
_RANDOM_INPLACE = [
    "bernoulli", "cauchy", "exponential", "geometric", "log_normal",
    "normal", "uniform",
]
_MANIP_INPLACE = [
    "reshape", "squeeze", "unsqueeze", "flatten", "t", "tril", "triu",
    "clip", "scale", "cast", "fill", "zero", "fill_diagonal",
    "fill_diagonal_tensor", "index_add",
    "index_fill", "index_put", "masked_fill", "masked_scatter", "scatter",
    "where", "cumsum", "cumprod", "renorm", "addmm", "gcd", "lcm",
    "detach", "copy", "grad",
]
_NONDIFF = set(_LOGIC) | {
    "bernoulli", "gcd", "lcm", "bitwise_and", "bitwise_or", "bitwise_xor",
    "bitwise_not", "argmax", "argmin", "argsort",
}

for _n in _ELEMENTWISE_UNARY:
    register_op(_n, spmd_rule="elementwise", tags=("math", "unary"))
for _n in _ELEMENTWISE_BINARY:
    register_op(_n, spmd_rule="elementwise", tags=("math", "binary"))
for _n in _LOGIC:
    register_op(_n, spmd_rule="elementwise", backward=False, tags=("logic",))
for _n in _RANDOM_INPLACE:
    register_op(_n, backward=False, tags=("random",))
for _n in _MANIP_INPLACE:
    if _n not in _REGISTRY:
        register_op(_n, tags=("manipulation",))

# structural / compute ops with dedicated spmd rules
register_op("matmul", spmd_rule="matmul", tags=("linalg",))
register_op("einsum", spmd_rule="einsum", tags=("linalg",))
register_op("embedding", spmd_rule="embedding", tags=("nn",))
register_op("c_embedding", spmd_rule="c_embedding", tags=("nn", "dist"))
register_op("softmax", spmd_rule="softmax", tags=("nn",))
register_op("log_softmax", spmd_rule="softmax", tags=("nn",))
register_op("layer_norm", spmd_rule="layer_norm", tags=("nn",))
register_op("rms_norm", spmd_rule="rms_norm", tags=("nn",))
register_op("dropout", spmd_rule="dropout", tags=("nn",))
register_op("cross_entropy_with_softmax",
            spmd_rule="cross_entropy_with_softmax", tags=("loss",))
register_op("flash_attention", spmd_rule="flash_attention", tags=("nn",))
register_op("moe_gate", spmd_rule="moe_gate", backward=True, tags=("moe",))
register_op("moe_dispatch", spmd_rule="moe_dispatch", tags=("moe",))
register_op("transpose", spmd_rule="transpose", tags=("manipulation",))
register_op("concat", spmd_rule="concat", tags=("manipulation",))
register_op("split", spmd_rule="split", tags=("manipulation",))
register_op("slice", spmd_rule="slice", tags=("manipulation",))
register_op("stack", spmd_rule="stack", tags=("manipulation",))
register_op("tile", spmd_rule="tile", tags=("manipulation",))
register_op("gather", spmd_rule="gather", tags=("indexing",))
register_op("topk", spmd_rule="topk", tags=("search",))
register_op("top_p_sampling", backward=False, tags=("search",))
register_op("argmax", spmd_rule="argmax", backward=False, tags=("search",))
register_op("sum", spmd_rule="reduction", tags=("math", "reduce"))
register_op("mean", spmd_rule="reduction", tags=("math", "reduce"))
register_op("max", spmd_rule="reduction", tags=("math", "reduce"))
register_op("min", spmd_rule="reduction", tags=("math", "reduce"))
register_op("prod", spmd_rule="reduction", tags=("math", "reduce"))

# inplace-only framework verbs without out-of-place public variants
register_op("set_value", inplace={"x": "out"}, backward=False,
            tags=("framework",))

# Every op with an `x_` Tensor-method variant carries the x->out inplace
# contract (the YAML `inplace:` field). Applied LAST so dedicated
# registrations above don't drop it. Ops registered above WITHOUT a
# trailing-underscore method are excluded — a contract on a method that
# doesn't exist would be a lie.
_NO_INPLACE_METHOD = {
    "isnan", "isinf", "isfinite", "allclose", "isclose",
    "acosh", "asinh", "atanh", "maximum", "minimum",
}
_INPLACE_VARIANTS = [
    n for n in (_ELEMENTWISE_UNARY + _ELEMENTWISE_BINARY + _LOGIC
                + _RANDOM_INPLACE + _MANIP_INPLACE)
    if n not in _NO_INPLACE_METHOD
]
for _n in _INPLACE_VARIANTS:
    _spec = _REGISTRY.get(_n)
    if _spec is not None:
        _REGISTRY[_n] = OpSpec(_spec.name, {"x": "out"}, _spec.spmd_rule,
                               _spec.backward, _spec.tags)

# non-differentiable ops that the grouped loops registered backward=True
for _n in _NONDIFF:
    _spec = _REGISTRY.get(_n)
    if _spec is not None and _spec.backward:
        _REGISTRY[_n] = OpSpec(_spec.name, _spec.inplace, _spec.spmd_rule,
                               False, _spec.tags)

# ---------------------------------------------------------------------------
# every op of the op battery carries a spec (PaddlePaddle's ops.yaml is
# the single source of truth for its ops; here the registry is the
# contract layer of sharding rules and in-place semantics)
# ---------------------------------------------------------------------------
_CREATION = [
    "arange", "eye", "full", "full_like", "linspace", "logspace",
    "meshgrid", "ones", "ones_like", "zeros", "zeros_like", "vander",
    "tril_indices", "triu_indices", "empty", "empty_like", "one_hot",
]
_LINALG = [
    "bmm", "cholesky", "cholesky_solve", "det", "eigvalsh",
    "householder_product", "inv", "lstsq", "lu", "matrix_power",
    "matrix_rank", "multi_dot", "pinv", "qr", "slogdet", "solve",
    "svdvals", "svd", "eig", "eigh", "triangular_solve", "dot", "inner",
    "outer", "mv", "kron", "cross", "tensordot", "trace", "norm", "cdist",
    "pdist", "dist", "cov", "corrcoef", "matrix_transpose", "cond",
]
_MANIP = [
    "as_strided", "atleast_1d", "atleast_2d", "atleast_3d",
    "broadcast_to", "chunk", "column_stack", "crop", "diag", "diag_embed",
    "diagflat", "diagonal", "dsplit", "dstack", "expand", "expand_as",
    "flip", "hsplit", "hstack", "moveaxis", "pad", "repeat_interleave",
    "roll", "rot90", "row_stack", "swapaxes", "unbind", "unflatten",
    "unfold", "unstack", "vsplit", "vstack", "view", "view_as",
]
_INDEXING = [
    "gather_nd", "index_select", "masked_select", "put_along_axis",
    "scatter_nd_add", "take", "take_along_axis", "index_sample",
    "getitem", "setitem",
]
_SEARCH_SORT = [
    "argmin", "argsort", "bucketize", "searchsorted", "sort", "unique",
    "histogram", "bincount", "kthvalue", "mode", "median", "nanmedian",
    "quantile", "nanquantile", "cummax", "cummin", "count_nonzero",
    "nonzero",
]
_MATH_MISC = [
    "conj", "diff", "frexp", "i0e", "i1", "i1e", "logcumsumexp",
    "signbit", "trapezoid", "numel", "real", "imag", "angle", "logsumexp",
    "nansum", "nanmean", "amax", "amin", "all", "any", "std", "var",
]
_FFT = ["fft", "ifft", "rfft", "irfft", "fft2", "ifft2", "fftn", "ifftn",
        "hfft", "ihfft", "fftshift", "ifftshift"]
_NN_FUNCTIONAL = [
    "conv1d", "conv2d", "conv3d", "conv1d_transpose", "conv2d_transpose",
    "conv3d_transpose", "avg_pool1d", "avg_pool2d", "avg_pool3d",
    "max_pool1d", "max_pool2d", "max_pool3d", "adaptive_avg_pool2d",
    "adaptive_max_pool2d", "affine_grid", "alpha_dropout", "batch_norm",
    "channel_shuffle", "cosine_similarity", "fold", "glu", "grid_sample",
    "group_norm", "gumbel_softmax", "instance_norm", "interpolate",
    "label_smooth", "linear", "local_response_norm", "normalize",
    "pixel_shuffle", "pixel_unshuffle", "prelu", "rrelu", "upsample",
    "zeropad2d", "relu", "gelu", "silu", "swish", "mish", "elu", "selu",
    "celu", "hardtanh", "hardshrink", "hardsigmoid", "hardswish",
    "leaky_relu", "log_sigmoid", "relu6", "softplus", "softshrink",
    "softsign", "tanhshrink", "thresholded_relu",
]
_LOSSES = [
    "cross_entropy", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "cosine_embedding_loss",
    "hinge_embedding_loss", "kl_div", "l1_loss",
    "margin_ranking_loss", "mse_loss", "multi_label_soft_margin_loss",
    "nll_loss", "pairwise_distance", "poisson_nll_loss", "smooth_l1_loss",
    "soft_margin_loss", "square_error_cost", "triplet_margin_loss",
    "ctc_loss", "sigmoid_focal_loss",
]

_INT_OUTPUT = {
    "argmin", "argsort", "bucketize", "searchsorted", "unique",
    "histogram", "bincount", "numel", "signbit", "count_nonzero",
    "nonzero", "tril_indices", "triu_indices", "one_hot",
    "arange", "eye",
}

for _n in _CREATION:
    register_op(_n, backward=False, tags=("creation",))
for _n in _LINALG:
    if _n not in _REGISTRY:
        register_op(_n, tags=("linalg",))
for _n in _MANIP:
    if _n not in _REGISTRY:
        register_op(_n, tags=("manipulation",))
for _n in _INDEXING:
    if _n not in _REGISTRY:
        tags = ("indexing", "framework") if _n in ("getitem", "setitem") \
            else ("indexing",)
        register_op(_n, tags=tags)
for _n in _SEARCH_SORT:
    register_op(_n, backward=_n not in _INT_OUTPUT, tags=("search",))
for _n in _MATH_MISC:
    if _n not in _REGISTRY:
        register_op(_n, spmd_rule=None,
                    backward=_n not in _INT_OUTPUT, tags=("math",))
for _n in _FFT:
    register_op(_n, tags=("fft",))
for _n in _NN_FUNCTIONAL:
    if _n not in _REGISTRY:
        register_op(_n, tags=("nn",))
for _n in _LOSSES:
    if _n not in _REGISTRY:
        register_op(_n, tags=("loss",))

# reductions registered above keep the reduction rule; these reduce too
for _n in ("logsumexp", "nansum", "nanmean", "amax", "amin", "all", "any",
           "std", "var", "median", "nanmedian", "quantile", "nanquantile",
           "count_nonzero"):
    _spec = _REGISTRY[_n]
    _REGISTRY[_n] = OpSpec(_spec.name, _spec.inplace, "reduction",
                           _spec.backward, _spec.tags)

# the explicit SPMD rules onto their registry entries (PaddlePaddle's
# `spmd_rule:` yaml key)
_SPMD_WIRING = {
    "bmm": "bmm", "sort": "sort", "argsort": "argsort",
    "cummax": "cummax", "cummin": "cummin",
    "logcumsumexp": "logcumsumexp", "kthvalue": "kthvalue",
    "index_select": "index_select",
    "take_along_axis": "take_along_axis",
    "put_along_axis": "put_along_axis", "one_hot": "one_hot",
    "flip": "flip", "roll": "roll", "pad": "pad", "tril": "tril",
    "scale": "scale", "clip": "clip", "group_norm": "group_norm",
    "conv1d": "conv", "conv2d": "conv", "conv3d": "conv",
    "conv1d_transpose": "conv_transpose",
    "conv2d_transpose": "conv_transpose",
    "conv3d_transpose": "conv_transpose",
    "avg_pool1d": "pool", "avg_pool2d": "pool", "avg_pool3d": "pool",
    "max_pool1d": "pool", "max_pool2d": "pool", "max_pool3d": "pool",
    "adaptive_avg_pool2d": "pool", "adaptive_max_pool2d": "pool",
    "cholesky": "batched_linalg", "inv": "batched_linalg",
    "det": "batched_linalg", "slogdet": "batched_linalg",
    "solve": "batched_linalg", "triangular_solve": "batched_linalg",
    "cholesky_solve": "batched_linalg", "lu": "batched_linalg",
    "qr": "batched_linalg", "svd": "batched_linalg",
    "svdvals": "batched_linalg", "eigh": "batched_linalg",
    "eigvalsh": "batched_linalg", "matrix_power": "batched_linalg",
    "pinv": "batched_linalg", "matrix_rank": "batched_linalg",
}
for _n, _r in _SPMD_WIRING.items():
    _spec = _REGISTRY.get(_n)
    if _spec is not None and _spec.spmd_rule is None:
        _REGISTRY[_n] = OpSpec(_spec.name, _spec.inplace, _r,
                               _spec.backward, _spec.tags)
