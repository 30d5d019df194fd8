"""Scaled low-precision GEMMs: the training half with delayed scaling, and
int8-resident serving weights.

Counterpart of ``paddle_tpu/quant/gemm.py``. The training half
(``:1-410``, ``:486-530``) quantizes the decoder's projections
themselves, per tensor:

- **forward narrow**: each operand is divided by its scale, clipped and
  cast to ``float8_e4m3fn`` (or rounded, clipped and cast to int8); the
  product accumulates in f32 (int32 for int8) and the result is
  ``acc * (sx * sw)`` in x's type;
- **backward wide**: ``dx = g @ w^T`` and ``dw = x^T @ g`` against the
  original operands, and zero gradients for the scales, so master weights
  and gradients never see a narrow type;
- **delayed scaling**: each (site, operand) keeps a short amax history
  (``amax_hist_len``, 4); the scale is the history's maximum over the
  type's largest value, an all-zero history bootstraps from the current
  amax, and each call returns the histories shifted with the current amax
  at index 0. The model keeps them as the ``quant_amax`` buffer
  ``[L, 7, 2, H]``, step state that ``TrainStep`` commits after the
  backward (``models/gpt.py``, ``jit/train_step.py``).

Routes, by the operands' device:

- a CUDA tensor takes the library's narrow GEMMs: ``torch._scaled_mm``
  (per-tensor f32 scales on the card, ``use_fast_accum=False``: f32
  accumulation as the reference's) with K and N padded with zeros to
  multiples of 16, and ``torch._int_mm`` (int8, int32 sums) with K and N
  padded to multiples of 8 and fewer than 32 rows padded to 32. The wide
  backward is a bf16 GEMM with an f32 result (``torch.mm(...,
  out_dtype=torch.float32)``), rounded once to the parameter's type: the
  rule's function, on the tensor cores;
- a CPU tensor takes the plain route: the same quantize, the codes
  upcast to f32 (products of two e4m3 values are exact in f32) and an f32
  matmul; int8 through ``torch._int_mm``; the backward an f32 matmul of
  the upcast operands, as the reference computes it.

The reference's environment knobs become keyword arguments: ``dtype``
(``PTPU_QUANT_DTYPE``), ``hist`` (``PTPU_QUANT_AMAX_HIST``), ``tol``
(``PTPU_QUANT_GATE_TOL``); the model takes the default of each. A ``quant:`` request engages on either device
behind the parity gate (the reference keeps a CPU backend off unless
forced); the gate's probe runs on the device it is asked for.

The serving half (``:411-475``): int8 codes per output column and the
int8 x int8 -> int32 GEMM of the serving engine's int8-resident weights.
The engine's ``int8_weights=`` request decides, behind a round-trip
probe.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import _disable_current_modes

from .. import telemetry as _telemetry
from ..device import resolve_device
from ..memory import SCALE_EPS, quantize_rows_int8
from ..memory.remat import GEMM_SITES, SITE_ALIASES, split_quant_entries

__all__ = ["E4M3_MAX", "INT8_MAX", "GEMM_SITES", "SITE_ALIASES",
           "fp8_dot_supported", "quant_dtype", "dtype_max", "amax_hist_len",
           "scaled_gemm", "inline_scaled_gemm", "init_amax_state",
           "GemmQuantCtx", "split_quant_entries", "quant_sites_from_policy",
           "requested_quant_sites", "engaged_quant_sites",
           "quant_gate_report", "quant_gate", "quant_compute_enabled",
           "loss_drift_probe", "note_gemm_mode", "note_step_tokens",
           "note_plan_engagement", "last_verdicts",
           "quantize_weight_cols_int8", "int8_weight_matmul",
           "int8_weights_enabled", "quantize_linear_int8", "int8_linear"]

#: saturation bound of float8_e4m3fn (no inf: operands are clipped first)
E4M3_MAX = 448.0
INT8_MAX = 127.0

#: the history length when none is given (``PTPU_QUANT_AMAX_HIST``'s)
DEFAULT_AMAX_HIST = 4

#: the parity gate's loss tolerance (``PTPU_QUANT_GATE_TOL``'s default)
DEFAULT_GATE_TOL = 0.02


def _dev(device):
    return resolve_device(device).type


# ---------------------------------------------------------------------------
# dtype resolution

_FP8_DOT_OK = {}


def fp8_dot_supported(device=None):
    """Whether ``device`` (default CUDA) multiplies e4m3 operands: on the
    CPU the plain route always does; on a card, one of compute capability
    8.9 or above whose ``torch._scaled_mm`` gives a finite product (cached
    per device type)."""
    dev = _dev(device)
    if dev not in _FP8_DOT_OK:
        ok = True
        if dev == "cuda":
            ok = torch.cuda.get_device_capability() >= (8, 9)
            if ok:
                a = torch.ones(16, 16, device=dev)
                out = _scaled_matmul_fwd("fp8", a, a, a.new_ones(()),
                                         a.new_ones(()))
                ok = bool(torch.isfinite(out).all())
        _FP8_DOT_OK[dev] = ok
    return _FP8_DOT_OK[dev]


def quant_dtype(dtype=None, device=None):
    """The narrow GEMM type: ``"fp8"``, ``"int8"``, or ``None`` / ``"auto"``
    for e4m3 where ``device`` multiplies it and int8 elsewhere."""
    if dtype in ("fp8", "int8"):
        return dtype
    if dtype not in (None, "auto"):
        raise ValueError(f"quant dtype {dtype!r}: expected fp8, int8 or auto")
    return "fp8" if fp8_dot_supported(device) else "int8"


def dtype_max(dtype):
    return E4M3_MAX if dtype == "fp8" else INT8_MAX


# ---------------------------------------------------------------------------
# the scaled GEMM: narrow forward, wide backward

#: ``torch._int_mm`` on CUDA takes more than 16 rows; fewer are padded to
#: this many zero rows (an exact int32 sum, so no row's value changes)
_INT_MM_MIN_ROWS = 32


def _pad_to(t, rows, cols):
    """``t`` [r, c] with zero rows and columns up to [rows, cols]."""
    r, c = t.shape
    if (r, c) == (rows, cols):
        return t
    return F.pad(t, (0, cols - c, 0, rows - r))


def _up(n, m):
    return -(-n // m) * m


def _quantize(t, s, dtype, rows, cols):
    """``t`` [r, c] -> its narrow codes [rows, cols], contiguous and
    zero-padded: divide by ``s``, clip (fp8) or round and clip (int8),
    cast. ``t`` is copied first, so the in-place passes leave it alone."""
    tf = t.to(torch.float32, copy=True)
    tf.div_(s)
    if dtype == "fp8":
        tf.clamp_(-E4M3_MAX, E4M3_MAX)
        narrow = torch.float8_e4m3fn
    else:
        tf.round_().clamp_(-INT8_MAX, INT8_MAX)
        narrow = torch.int8
    return _pad_to(tf, rows, cols).to(narrow,
                                      memory_format=torch.contiguous_format)


def _int_mm(a, b_t):
    """``a @ b_t^T`` in int32: ``a`` [m, k] and ``b_t`` [n, k] int8,
    contiguous (``b_t^T`` is the column-major operand cuBLAS takes). On
    the card, fewer than 32 rows are padded to 32 and k, n to multiples of
    8 with zeros; the padding is sliced off."""
    m, n = a.shape[0], b_t.shape[0]
    if a.is_cuda:
        k = _up(a.shape[1], 8)
        a = _pad_to(a, max(m, _INT_MM_MIN_ROWS), k)
        b_t = _pad_to(b_t, _up(n, 8), k)
    return torch._int_mm(a, b_t.t())[:m, :n]


def _scaled_matmul_fwd(dtype, x, w, sx, sw):
    """The narrow forward of ``x [..., K] @ w [K, N]`` with per-tensor
    scales ``sx``, ``sw`` (0-dim f32 tensors on the operands' device)."""
    x2 = x.reshape(-1, x.shape[-1])
    (m, k), n = x2.shape, w.shape[1]
    cuda = x.is_cuda
    if dtype == "fp8" and cuda:
        kp, np_ = _up(k, 16), _up(n, 16)
        xq = _quantize(x2, sx, dtype, m, kp)
        wq_t = _quantize(w.t(), sw, dtype, np_, kp)
        out = torch._scaled_mm(xq, wq_t.t(), scale_a=sx, scale_b=sw,
                               out_dtype=x.dtype, use_fast_accum=False)
        out = out[:, :n]
    else:
        xq = _quantize(x2, sx, dtype, m, k)
        wq_t = _quantize(w.t(), sw, dtype, n, k)
        if dtype == "fp8":
            acc = xq.float() @ wq_t.float().t()
        else:
            acc = _int_mm(xq, wq_t).float()
        out = (acc * (sx * sw)).to(x.dtype)
    return out.reshape(*x.shape[:-1], n)


def _wide_mm(a, b, out_dtype):
    """``a @ b`` under the wide rule: the operands' values, exact f32
    products, an f32 sum and one rounding to ``out_dtype``."""
    if not a.is_cuda:
        return (a.float() @ b.float()).to(out_dtype)
    if a.dtype == b.dtype and a.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(a, b, out_dtype=torch.float32).to(out_dtype)
    return torch.mm(a.float(), b.float()).to(out_dtype)


class _ScaledMatmul(torch.autograd.Function):
    """``x @ w`` narrow in the forward, wide and exact in the backward
    (``paddle_tpu/quant/gemm.py:120-159``)."""

    @staticmethod
    def forward(ctx, x, w, sx, sw, dtype):
        ctx.save_for_backward(x, w)
        return _scaled_matmul_fwd(dtype, x, w, sx, sw)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dx = _wide_mm(g2, w.t(), x.dtype).reshape(x.shape)
        dw = _wide_mm(x.reshape(-1, x.shape[-1]).t(), g2, w.dtype)
        zero = g.new_zeros((), dtype=torch.float32)
        return dx, dw, zero, zero, None


def amax_hist_len(hist=None):
    """The delayed-scaling history length: ``hist``, else 4; at least 1."""
    return max(int(DEFAULT_AMAX_HIST if hist is None else hist), 1)


def scaled_gemm(x, w, hist_x, hist_w, *, dtype=None):
    """Delayed-scaling scaled GEMM (``paddle_tpu/quant/gemm.py:168-190``).

    ``hist_x`` / ``hist_w`` are ``[H]`` f32 amax histories (newest
    first). The scales come from the histories' maxima (the current amax
    where a history is all zero), over ``dtype_max``, floored at
    ``SCALE_EPS``. Returns ``(out, new_hist_x, new_hist_w)``: the
    histories shifted with the current amax at index 0, all computed on
    the device without a gradient."""
    dtype = quant_dtype(dtype, x.device)
    with torch.no_grad():
        dmax = hist_x.new_full((), dtype_max(dtype))
        ax = x.detach().abs().amax().float()
        aw = w.detach().abs().amax().float()
        hx, hw = hist_x.amax(), hist_w.amax()
        sx = torch.clamp_min(torch.where(hx > 0, hx, ax) / dmax, SCALE_EPS)
        sw = torch.clamp_min(torch.where(hw > 0, hw, aw) / dmax, SCALE_EPS)
        new_hx = torch.cat([ax[None], hist_x[:-1]])
        new_hw = torch.cat([aw[None], hist_w[:-1]])
    return _ScaledMatmul.apply(x, w, sx, sw, dtype), new_hx, new_hw


def inline_scaled_gemm(x, w, *, dtype=None):
    """One scaled GEMM with the current amax as the scale: the delayed
    rule over an empty history, for callers without state (the incubate
    ``fp8_gemm``)."""
    h = x.new_zeros((1,), dtype=torch.float32)
    return scaled_gemm(x, w, h, h, dtype=dtype)[0]


# ---------------------------------------------------------------------------
# the amax state and the per-layer context the decoder block uses


def init_amax_state(num_layers, hist=None, device=None):
    """Fresh delayed-scaling state: f32 zeros ``[L, 7 sites, 2, H]``
    (operand rows x and w); all-zero rows bootstrap from the current
    amax."""
    return torch.zeros(int(num_layers), len(GEMM_SITES), 2,
                       amax_hist_len(hist), device=resolve_device(device))


class GemmQuantCtx:
    """One decoder layer's scaled GEMMs: holds the layer's amax slice
    ``[7, 2, H]``, routes the engaged sites through :func:`scaled_gemm`
    and collects their new histories (``paddle_tpu/quant/gemm.py:
    201-247``)."""

    def __init__(self, sites, amax_layer, dtype):
        self.sites = frozenset(sites)
        self.dtype = dtype
        self._amax = amax_layer
        self._new = {}

    def gemm(self, x, w, site):
        if site not in self.sites:
            return x @ w
        i = GEMM_SITES.index(site)
        out, nhx, nhw = scaled_gemm(x, w, self._amax[i, 0],
                                    self._amax[i, 1], dtype=self.dtype)
        self._new[site] = torch.stack([nhx, nhw])
        return out

    def collect(self):
        """The layer's new ``[7, 2, H]`` state: new histories for the
        sites that ran, the old rows for the rest."""
        return torch.stack([self._new.get(s, self._amax[i])
                            for i, s in enumerate(GEMM_SITES)])


# ---------------------------------------------------------------------------
# policy parsing and engagement


def quant_sites_from_policy(policy):
    """The sites a recompute policy requests (``names:`` policies only)."""
    if isinstance(policy, str) and policy.startswith("names:"):
        return split_quant_entries(policy[len("names:"):])[1]
    return frozenset()


def requested_quant_sites(cfg):
    """The sites ``cfg.recompute_policy`` asks for. It decides whether the
    model has the amax buffer, so the parity gate does not enter."""
    return quant_sites_from_policy(getattr(cfg, "recompute_policy", None))


_GATE_CACHE = {}


def _gate_probe(tol, dtype, device):
    """A scaled GEMM's loss and gradients against the exact f32 product's
    on skewed inputs (``paddle_tpu/quant/gemm.py:297-324``)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((128, 64))
                          * rng.uniform(0.05, 3.0, (128, 64)))
                         .astype(np.float32))
    h = torch.zeros(amax_hist_len(), device=device)

    def loss_grads(quantized):
        xx = x.to(device).requires_grad_()
        ww = w.to(device).requires_grad_()
        out = (scaled_gemm(xx, ww, h, h, dtype=dtype)[0] if quantized
               else xx @ ww)
        loss = out.square().mean()
        gx, gw = torch.autograd.grad(loss, (xx, ww))
        return loss.item(), gx.cpu().numpy(), gw.cpu().numpy()

    le, gxe, gwe = loss_grads(False)
    lq, gxq, gwq = loss_grads(True)
    loss_err = abs(lq - le) / max(abs(le), 1e-9)

    def _gerr(a, b):
        return float(np.mean(np.abs(a - b)) / max(np.mean(np.abs(b)), 1e-9))

    grad_err = max(_gerr(gxq, gxe), _gerr(gwq, gwe))
    ok = bool(np.isfinite(lq)) and loss_err < tol and grad_err < 5 * tol
    return ok, loss_err, grad_err


def quant_gate_report(tol=None, dtype=None, device=None):
    """Run (or fetch) the parity probe on ``device`` (default CUDA):
    ``{"ok", "tol", "loss_rel_err", "grad_rel_err", "grad_tol", "dtype",
    "device"}``, cached by (tol, dtype, device type). A probe that
    crashes warns and reports not ok, as a drifting one does."""
    tol = DEFAULT_GATE_TOL if tol is None else float(tol)
    dev = _dev(device)
    dtype = quant_dtype(dtype, dev)
    key = (round(tol, 9), dtype, dev)
    if key not in _GATE_CACHE:
        try:
            # real tensors even inside a tracing mode (the fake-tensor
            # trace of TrainStep.memory_stats)
            with _disable_current_modes():
                ok, loss_err, grad_err = _gate_probe(tol, dtype, dev)
        except Exception as e:  # noqa: BLE001 - a crashed probe means off
            warnings.warn(
                f"quant-compute parity probe crashed ({e!r}); scaled {dtype}"
                " GEMMs stay off", RuntimeWarning, stacklevel=2)
            ok, loss_err, grad_err = False, float("inf"), float("inf")
        if not ok and np.isfinite(loss_err):
            warnings.warn(
                f"quant-compute parity probe drift (loss {loss_err:.4f} vs "
                f"tol={tol}, grad {grad_err:.4f} vs {5 * tol}) for "
                f"dtype={dtype} on {dev}; scaled GEMMs stay off",
                RuntimeWarning, stacklevel=2)
        _GATE_CACHE[key] = {"ok": ok, "tol": tol, "loss_rel_err": loss_err,
                            "grad_rel_err": grad_err, "grad_tol": 5 * tol,
                            "dtype": dtype, "device": dev}
    return _GATE_CACHE[key]


def quant_gate(tol=None, dtype=None, device=None):
    """True when the cached parity probe passed."""
    return quant_gate_report(tol, dtype, device)["ok"]


def quant_compute_enabled(requested=False, device=None, *, tol=None,
                          dtype=None):
    """A request engages on either device behind a passing gate; nothing
    engages unrequested."""
    return bool(requested) and quant_gate(tol, dtype, device)


def engaged_quant_sites(cfg, device=None, *, tol=None, dtype=None):
    """The requested sites, where the gate lets them engage."""
    sites = requested_quant_sites(cfg)
    if sites and quant_compute_enabled(True, device, tol=tol, dtype=dtype):
        return sites
    return frozenset()


def loss_drift_probe(dtype=None, steps=8, lr=0.05, device=None):
    """Fit a two-GEMM regression for ``steps`` steps of SGD with exact and
    with scaled GEMMs (delayed scaling carried across steps) and return the
    relative drift of the final loss (``paddle_tpu/quant/gemm.py:
    486-530``)."""
    dev = resolve_device(device)
    dtype = quant_dtype(dtype, dev)
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    x = t(rng.standard_normal((32, 64)))
    y = t(rng.standard_normal((32, 32)))
    w1_0 = t(rng.standard_normal((64, 64)) * 0.1)
    w2_0 = t(rng.standard_normal((64, 32)) * 0.1)
    hlen = amax_hist_len()

    def run(quantized):
        w1, w2 = w1_0.clone(), w2_0.clone()
        hist_ = torch.zeros(2, 2, hlen, device=dev)
        loss = None
        for _ in range(steps):
            w1.requires_grad_()
            w2.requires_grad_()
            if quantized:
                h1, n1x, n1w = scaled_gemm(x, w1, hist_[0, 0], hist_[0, 1],
                                           dtype=dtype)
                out, n2x, n2w = scaled_gemm(torch.relu(h1), w2, hist_[1, 0],
                                            hist_[1, 1], dtype=dtype)
                new_hist = torch.stack([torch.stack([n1x, n1w]),
                                        torch.stack([n2x, n2w])])
            else:
                out = torch.relu(x @ w1) @ w2
                new_hist = hist_
            loss = (out - y).square().mean()
            g1, g2 = torch.autograd.grad(loss, (w1, w2))
            with torch.no_grad():
                w1, w2 = w1 - lr * g1, w2 - lr * g2
            hist_ = new_hist
        return loss.item()

    le = run(False)
    lq = run(True)
    return abs(lq - le) / max(abs(le), 1e-9)


# ---------------------------------------------------------------------------
# telemetry: gemm_dtype_mode, quant_gemm_flops_total (the reference's
# :532-575) and the quant_gemm plan verdicts of
# ``paddle_tpu/distributed/collectives/compose.py:80-185``

_GEMM_MODE = _telemetry.gauge(
    "gemm_dtype_mode",
    "Narrow-GEMM dtype per decoder site (0=wide, 1=int8, 2=fp8)",
    labelnames=("site", "path"))
_QUANT_FLOPS = _telemetry.counter(
    "quant_gemm_flops_total",
    "Cumulative forward FLOPs executed through narrow scaled GEMMs",
    labelnames=("dtype",))
_PLAN_ENGAGEMENT = _telemetry.counter(
    "plan_engagement_total",
    "plan resolutions at step build, by verdict and structured reason "
    "(one tick per resolved plan)",
    labelnames=("plan", "verdict", "reason"))

_MODE_VALUE = {"int8": 1.0, "fp8": 2.0}

#: last engagement noted: (path, dtype, flops_per_token)
_LAST_MODE = [None]

#: the reasons a quant_gemm resolution can give on the port's path
PLAN_REASONS = ("engaged", "quant_parity_gate", "fused_kernel_owns_gemm")

#: newest resolution per plan: {plan: (verdict, reason)}
_LAST_VERDICTS = {}


def note_gemm_mode(path, sites, dtype, flops_per_token=0):
    """One ``gemm_dtype_mode`` series per site (0 for sites staying wide)
    and the per-token narrow-FLOP rate :func:`note_step_tokens` counts
    with."""
    mode = _MODE_VALUE.get(dtype, 0.0)
    for s in GEMM_SITES:
        _GEMM_MODE.set(mode if s in sites else 0.0, labels=(s, path))
    if sites:
        _LAST_MODE[0] = (path, dtype, float(flops_per_token))
    elif _LAST_MODE[0] is not None and _LAST_MODE[0][0] == path:
        _LAST_MODE[0] = None


def note_step_tokens(tokens):
    """Tick ``quant_gemm_flops_total`` for ``tokens`` tokens through the
    narrow GEMMs, at the rate the last engaged :func:`note_gemm_mode`
    noted."""
    info = _LAST_MODE[0]
    if info is None:
        return
    _, dtype, per_tok = info
    if per_tok > 0:
        _QUANT_FLOPS.inc(per_tok * float(tokens), labels=(dtype,))


def note_plan_engagement(plan_name, reason):
    """Record one plan resolution (``reason`` one of
    :data:`PLAN_REASONS`); the verdict is ``engaged`` for ``engaged`` and
    ``declined`` otherwise. Returns the verdict."""
    if reason not in PLAN_REASONS:
        raise ValueError(f"plan reason {reason!r} not in {PLAN_REASONS}")
    verdict = "engaged" if reason == "engaged" else "declined"
    _LAST_VERDICTS[plan_name] = (verdict, reason)
    _PLAN_ENGAGEMENT.inc(labels=(plan_name, verdict, reason))
    return verdict


def last_verdicts():
    """``{plan: (verdict, reason)}`` of the newest resolutions."""
    return dict(_LAST_VERDICTS)


# ---------------------------------------------------------------------------
# serving: int8-resident weights and the int8 x int8 -> int32 GEMM


def quantize_weight_cols_int8(w, eps=SCALE_EPS):
    """Per-output-column absmax int8 over the contraction axis (-2):
    ``s = max(absmax / 127, eps)``, ``q = clip(round(w / s), -127, 127)``,
    true f32 divisions and round-half-to-even as ``jnp.round``, so codes
    and scales equal the JAX package's bit for bit. Returns ``(codes int8
    [..., h, n], scales f32 [..., 1, n])``."""
    wf = w.float()
    amax = wf.abs().amax(-2, keepdim=True)
    s = torch.clamp_min(amax / amax.new_full((), 127.0), eps)
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return q, s


def int8_weight_matmul(x, codes, scales, xq=None):
    """``x @ W`` for W packed by :func:`quantize_weight_cols_int8`: ``x``
    [..., h] quantized per row, ``codes`` [h, n], ``scales`` [1, n]. The
    card wants ``codes`` column-major (the transpose of a contiguous
    [n, h] tensor, as the engine stores them) and takes cuBLAS's int8
    GEMM; a GEMM the card refuses raises. ``xq`` is
    ``quantize_rows_int8(x)`` where the caller has it already (one input
    feeding several projections is quantized once)."""
    xq, sx = quantize_rows_int8(x) if xq is None else xq
    a = xq.reshape(-1, xq.shape[-1])
    m = a.shape[0]
    acc = _int_mm(a, codes.t())
    out = acc.float() * sx.reshape(m, 1) * scales
    return out.reshape(*x.shape[:-1], -1).to(x.dtype)


def quantize_linear_int8(w):
    """A weight in ``F.linear``'s ``[out, in]`` layout -> ``(codes int8
    [out, in], scales f32 [1, out])``: :func:`quantize_weight_cols_int8` of
    its transpose, the codes stored contiguous, so their transpose is the
    column-major operand cuBLAS's int8 GEMM takes."""
    codes, scales = quantize_weight_cols_int8(w.t())
    return codes.t().contiguous(), scales


def int8_linear(x, packed, xq=None):
    """``F.linear(x, W)`` for W packed by :func:`quantize_linear_int8`
    (``xq`` as for :func:`int8_weight_matmul`)."""
    codes, scales = packed
    return int8_weight_matmul(x, codes.t(), scales, xq)


def _int8_weights_probe_ok():
    """Round-trip probe on skewed per-column magnitudes: the int8 weight
    GEMM must track the exact product within 5% mean relative error."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    w *= rng.uniform(0.01, 8.0, (1, 48)).astype(np.float32)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    exact = x @ w
    codes, scales = quantize_weight_cols_int8(torch.from_numpy(w))
    got = int8_weight_matmul(torch.from_numpy(x), codes, scales).numpy()
    if not np.isfinite(got).all():
        return False
    err = np.mean(np.abs(got - exact)) / max(np.mean(np.abs(exact)), 1e-9)
    return bool(err < 0.05)


#: the probe's verdict, computed once a process
_INT8_W_PROBE = [None]


def int8_weights_enabled(requested=False):
    """The int8-resident weights engage when the engine asks for them AND
    the round-trip probe passes; a failing probe warns and the weights
    stay exact."""
    if not requested:
        return False
    if _INT8_W_PROBE[0] is None:
        _INT8_W_PROBE[0] = _int8_weights_probe_ok()
    if not _INT8_W_PROBE[0]:
        warnings.warn("int8-weights round-trip probe failed: serving "
                      "weights stay exact", RuntimeWarning, stacklevel=2)
        return False
    return True
