"""The batch and remat planner (counterpart of
``paddle_tpu/memory/planner.py``).

``plan_train_step`` prices a grid of (batch, remat policy) candidates
without running them and picks the best throughput estimate whose peak
fits the card's memory budget, so a caller stops hand-picking its batch.
The reference reads XLA's buffer assignment of an AOT compile; the port
reads :meth:`TrainStep.memory_stats`, a fake-tensor trace of one step that
counts the bytes alive after each op (``jit/train_step.py`` states the
substitute and what it leaves out: the allocator's rounding and cache,
cuBLAS's workspace). Candidates are tried highest score first and the
first fit wins, so the common case traces one step; two candidates whose
traced programs are the same (``program_key_fn``) share one trace.

Decisions are cached on disk, keyed by (chip, device count, budget, grid,
``cache_extra``, ``require_fit``, ZeRO pricing), so a rerun of the same
configuration traces nothing. Deliberate differences from the reference:

- ``budget_bytes=`` and ``cache_path=`` are the keywords the reference
  also takes; its environment knobs ``PTPU_HBM_BUDGET`` and
  ``PTPU_PLAN_CACHE`` are not read (the port's switches are keywords).
  ``cache_path=""`` disables the cache.
- The budget is the keyword, else the card's total memory
  (``torch.cuda.mem_get_info``); with no card and no keyword it raises
  :class:`MemoryPlanError` rather than assume a size.
- The cache key has no scan mode (the port has no scan over layers) and
  no quant environment knobs (``quant:`` sites ride in the policy, which
  is in the grid).

Telemetry gauges set on every decision: ``hbm_peak_bytes``,
``act_saved_bytes``, ``act_int8_bytes``; the counter
``memory_plan_lowerings_total{outcome}`` counts candidate traces (fit,
over_budget, error) and the traces saved (cache_hit, memoized).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os

from .. import telemetry as _telemetry
from .int8_ckpt import INT8_BLOCK, int8_saved_nbytes
from .remat import parse_save_names

_HBM_PEAK = _telemetry.gauge(
    "hbm_peak_bytes",
    "planner-chosen train-step peak device memory (the traced step's "
    "argument + temp bytes)")
_ACT_SAVED = _telemetry.gauge(
    "act_saved_bytes",
    "estimated bytes of remat-saved activations per step under the "
    "chosen policy (all layers)")
_ACT_INT8 = _telemetry.gauge(
    "act_int8_bytes",
    "estimated bytes of int8-saved activations (+fp32 scales) within "
    "act_saved_bytes")
_PLAN_EVALS = _telemetry.counter(
    "memory_plan_lowerings_total",
    "candidate TrainStep programs traced by the planner",
    # fit | over_budget | error | cache_hit | memoized ("memoized" = a
    # trace SAVED because an earlier candidate traced the same program;
    # fit + over_budget + error = actual traces)
    labelnames=("outcome",))


class MemoryPlanError(RuntimeError):
    """No candidate fits the budget, or there is no budget to fit."""


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the batch x remat x head-chunk x depth x quant grid.
    ``score`` overrides the default throughput estimate (higher =
    preferred); ``head_chunk`` is the CE head's vocab chunk, ``depth`` a
    num_layers override for a factory that rebuilds the model, ``quant``
    the ``quant:`` site spec the factory appends to the policy."""
    batch: int
    policy: str
    score: float | None = None
    head_chunk: int | None = None
    depth: int | None = None
    quant: str | None = None


@dataclasses.dataclass
class PlanDecision:
    batch: int
    policy: str
    peak_bytes: int
    budget_bytes: int
    fits: bool
    score: float
    source: str          # "planner" | "cache" | "env-override"
    chip: str
    key: str
    act_saved_bytes: int | None = None
    act_int8_bytes: int | None = None
    opt_state_bytes: int | None = None
    candidates: list = dataclasses.field(default_factory=list)
    head_chunk: int | None = None
    depth: int | None = None
    quant: str | None = None
    #: ZeRO pricing record: {"stage", "degree", the byte pools,
    #: "hbm_savings_bytes"}; None without zero info
    zero: dict | None = None

    def as_json(self):
        """The bench JSON ``"memory"`` block, the reference's keys."""
        return dataclasses.asdict(self)


# -- budget -----------------------------------------------------------------
def chip_kind():
    """The card's name (``torch.cuda.get_device_name``), or "cpu"."""
    import torch

    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    return "cpu"


def hbm_budget_bytes(budget=None):
    """The budget in bytes: ``budget``, else the card's total memory. With
    neither, raises :class:`MemoryPlanError`."""
    import torch

    if budget is not None:
        return int(budget)
    if torch.cuda.is_available():
        return int(torch.cuda.mem_get_info(0)[1])
    raise MemoryPlanError("no memory budget: pass budget_bytes= (no CUDA "
                          "device to read one from)")


# -- throughput estimate ----------------------------------------------------
# Fraction of one decoder block's forward FLOPs the backward replay SKIPS
# when the anchor is saved (the reference's weights: they rank policies,
# they do not predict MFU).
_ANCHOR_COVERAGE = {
    "attn_res": 0.18, "attn_lse": 0.02, "attn_out": 0.20,
    "attn_q": 0.07, "attn_k": 0.055, "attn_v": 0.055,
    "resid_mid": 0.09, "ln2_out": 0.01, "rms_rstd": 0.01,
    "ffn_gate": 0.17, "ffn_up": 0.17, "ffn_out": 0.04,
}
#: int8 saves skip the same recompute but pay quant/dequant bandwidth
_INT8_DISCOUNT = 0.9
_POLICY_COVERAGE = {"none": 1.0, "full": 0.0, "dots": 0.6,
                    "attn": 0.22, "attn_ffn": 0.26}


def policy_coverage(policy):
    """~fraction of forward FLOPs the backward replay skips under
    ``policy`` (a recompute_policy string)."""
    pol = str(policy)
    if pol in _POLICY_COVERAGE:
        return _POLICY_COVERAGE[pol]
    if pol.startswith("names:"):
        _, int8_names = parse_save_names(pol[len("names:"):])
        cov = 0.0
        for raw in pol[len("names:"):].split(","):
            nm = raw.strip()
            base = nm[len("int8:"):] if nm.startswith("int8:") else nm
            w = _ANCHOR_COVERAGE.get(base, 0.0)
            cov += w * (_INT8_DISCOUNT if base in int8_names else 1.0)
        return min(cov, 0.95)
    return 0.0


def throughput_score(batch, policy, head_chunk=None):
    """MFU-shaped estimate: useful FLOPs per token are 3F (fwd+bwd), the
    replay re-runs (1 - coverage)F of them, and larger batches buy mildly
    better efficiency; a larger CE head chunk nudges the score up (a
    ranking tiebreak)."""
    cov = policy_coverage(policy)
    score = 3.0 / (4.0 - cov) * (1.0 + 0.03 * int(batch))
    if head_chunk:
        score *= 1.0 + 0.004 * math.log2(max(int(head_chunk), 1) / 1024.0)
    return score


# -- activation-byte estimate (telemetry + bench JSON) ----------------------
def estimate_stacked_activation_bytes(policy, *, num_layers, batch, seq,
                                      hidden, num_heads, num_kv_heads,
                                      intermediate, act_bytes=2,
                                      block=None):
    """(saved_bytes, int8_bytes) the stacked decoder's remat policy keeps
    across all layers, attributed to NAMES. Unknown anchors count 0;
    non-``names:`` policies return (0, 0)."""
    block = block or INT8_BLOCK
    pol = str(policy)
    if not pol.startswith("names:"):
        return 0, 0
    _, int8_names = parse_save_names(pol[len("names:"):])
    hd = hidden // num_heads
    kv = num_kv_heads * hd
    tok = batch * seq
    # elements per layer, with the dtype each anchor is saved in
    elems = {
        "attn_q": (tok * hidden, act_bytes),
        "attn_k": (tok * kv, act_bytes),
        "attn_v": (tok * kv, act_bytes),
        "attn_out": (tok * hidden, act_bytes),
        "attn_res": (tok * hidden, act_bytes),
        "attn_lse": (tok * num_heads, 4),
        "resid_mid": (tok * hidden, act_bytes),
        "ln2_out": (tok * hidden, act_bytes),
        "ffn_gate": (tok * intermediate, act_bytes),
        "ffn_up": (tok * intermediate, act_bytes),
        "ffn_out": (tok * intermediate, act_bytes),
        "rms_rstd": (tok * 2, 4),  # one rstd row-vector per rms (2/block)
    }
    saved = int8 = 0
    for raw in pol[len("names:"):].split(","):
        nm = raw.strip()
        base = nm[len("int8:"):] if nm.startswith("int8:") else nm
        if base not in elems:
            continue
        n, nbytes = elems[base]
        if base in int8_names:
            b = int8_saved_nbytes(n, block)
            int8 += b
            saved += b
        else:
            saved += n * nbytes
    return saved * num_layers, int8 * num_layers


# -- decision cache ---------------------------------------------------------
def _cache_path(path=None):
    """``path`` ("" disables), else the user's cache directory."""
    if path is not None:
        return path or None
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "paddle_tpu_torch", "memory_plan.json")


def _cache_load(path):
    try:
        with open(path) as f:
            d = json.load(f)
        return d if isinstance(d, dict) else {}
    except (OSError, ValueError):
        return {}


def _cache_store(path, key, decision):
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        d = _cache_load(path)
        d[key] = decision.as_json()
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(d, f)
        os.replace(tmp, path)
    except OSError:
        pass  # the cache is an optimization; planning already succeeded


# -- ZeRO stage pricing -----------------------------------------------------
def zero_hbm_savings(zero):
    """Per-device bytes a ZeRO stage frees versus the unsharded program:
    slot state divides by the sharding degree from stage 1, gradients
    from stage 2, parameters from stage 3. ``zero`` is a dict {"stage",
    "degree", "slot_bytes", "grad_bytes", "param_bytes"} (the unsharded
    program's byte pools)."""
    if not zero:
        return 0
    degree = int(zero.get("degree") or 1)
    stage = int(zero.get("stage") or 0)
    if degree <= 1 or stage < 1:
        return 0
    frac = 1.0 - 1.0 / degree
    saved = int(zero.get("slot_bytes") or 0) * frac
    if stage >= 2:
        saved += int(zero.get("grad_bytes") or 0) * frac
    if stage >= 3:
        saved += int(zero.get("param_bytes") or 0) * frac
    return int(saved)


# -- the planner ------------------------------------------------------------
def default_program_key(cand):
    """The candidate axes that change the traced program, conservatively:
    every grid axis."""
    return (cand.batch, cand.policy, cand.head_chunk, cand.depth, cand.quant)


def _record(cand, score, **kw):
    return dict({"batch": cand.batch, "policy": cand.policy,
                 "head_chunk": cand.head_chunk, "depth": cand.depth,
                 "quant": cand.quant, "score": score}, **kw)


def plan_train_step(step_factory, candidates, *, budget_bytes=None,
                    cache_path=None, cache_extra=(), act_bytes_fn=None,
                    opt_state_bytes=None, require_fit=True, zero=None,
                    program_key_fn=None):
    """Pick the best (batch, policy) that fits the budget.

    ``step_factory(candidate) -> (TrainStep, batch)`` builds a step and a
    batch for it (tensors, or ``meta`` tensors of the batch's shapes and
    types); the planner prices it with ``TrainStep.memory_stats`` (a
    traced step: nothing runs, nothing is allocated). Candidates are tried
    highest :func:`throughput_score` first; the first fit wins.
    ``require_fit=False`` accepts the top candidate even over budget
    (source "env-override", ``fits`` recorded).

    ``act_bytes_fn(candidate) -> (saved, int8)`` attributes saved
    activations; ``program_key_fn(candidate)`` names the axes that change
    the traced program (:func:`default_program_key`): a candidate whose
    key an earlier one traced reuses its bytes (``memoized``). ``zero``
    subtracts :func:`zero_hbm_savings` from every peak before the fit
    check and lands in ``PlanDecision.zero``.

    Decisions are cached at ``cache_path`` (default
    ``~/.cache/paddle_tpu_torch/memory_plan.json``; "" disables), keyed
    by chip, device count, budget, grid, ``cache_extra``, ``require_fit``
    and the ZeRO pricing; a hit traces nothing.
    """
    import torch

    budget = hbm_budget_bytes(budget_bytes)
    chip = chip_kind()
    ndev = torch.cuda.device_count() if torch.cuda.is_available() else 1

    def score_of(c):
        return (c.score if c.score is not None
                else throughput_score(c.batch, c.policy, c.head_chunk))

    order = sorted(candidates, key=score_of, reverse=True)
    grid = [(c.batch, c.policy, c.head_chunk, c.depth, c.quant)
            for c in order]
    savings = zero_hbm_savings(zero)
    zero_key = (tuple(sorted((k, int(v or 0)) for k, v in zero.items()))
                if zero else None)
    key = hashlib.sha1(repr(
        (chip, ndev, budget, tuple(cache_extra), grid, require_fit,
         zero_key)).encode()).hexdigest()[:16]

    cpath = _cache_path(cache_path)
    if cpath:
        hit = _cache_load(cpath).get(key)
        if hit:
            decision = PlanDecision(**dict(hit, source="cache"))
            _PLAN_EVALS.inc(labels=("cache_hit",))
            _set_gauges(decision)
            return decision

    evaluated = []
    chosen = None
    key_fn = program_key_fn or default_program_key
    traced = {}  # program key -> its memory_stats (the memoization seam)
    for cand in order:
        score = score_of(cand)
        pkey = key_fn(cand)
        memoized = pkey in traced
        if memoized:
            mem = traced[pkey]
            _PLAN_EVALS.inc(labels=("memoized",))
        else:
            step, batch = step_factory(cand)
            try:
                mem = step.memory_stats(*batch)
            except Exception as e:  # a step that cannot be traced
                _PLAN_EVALS.inc(labels=("error",))
                evaluated.append(_record(cand, score, error=str(e)[:200]))
                continue
            traced[pkey] = mem
        fits = mem["peak_bytes"] - savings <= budget
        if not memoized:
            _PLAN_EVALS.inc(labels=("fit" if fits else "over_budget",))
        evaluated.append(_record(cand, score, peak_bytes=mem["peak_bytes"],
                                 fits=fits, memoized=memoized))
        if fits or not require_fit:
            chosen = (cand, mem, score, fits)
            break
    if chosen is None:
        raise MemoryPlanError(
            f"no candidate fits the memory budget ({budget} bytes on "
            f"{chip}); evaluated: {evaluated}")

    cand, mem, score, fits = chosen
    decision = PlanDecision(
        batch=cand.batch, policy=cand.policy, head_chunk=cand.head_chunk,
        depth=cand.depth, quant=cand.quant,
        peak_bytes=int(mem["peak_bytes"]), budget_bytes=int(budget),
        fits=bool(fits), score=float(score),
        source="planner" if require_fit else "env-override",
        chip=chip, key=key, opt_state_bytes=opt_state_bytes,
        candidates=evaluated,
        zero=(dict(zero, hbm_savings_bytes=int(savings)) if zero else None))
    if act_bytes_fn is not None:
        saved, i8 = act_bytes_fn(cand)
        decision.act_saved_bytes = int(saved)
        decision.act_int8_bytes = int(i8)
    _set_gauges(decision)
    if cpath:
        _cache_store(cpath, key, decision)
    return decision


def _set_gauges(decision):
    _HBM_PEAK.set(decision.peak_bytes)
    if decision.act_saved_bytes is not None:
        _ACT_SAVED.set(decision.act_saved_bytes)
    if decision.act_int8_bytes is not None:
        _ACT_INT8.set(decision.act_int8_bytes)
