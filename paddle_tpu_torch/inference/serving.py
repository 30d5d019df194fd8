"""Continuous-batching LLM serving over paged KV caches, in PyTorch.

Counterpart of ``paddle_tpu/inference/serving.py``:

- KV lives in pages: one cache per K and V, ``[L, Hkv, num_pages + 1,
  page_size, D]``, whose per-layer slices are the layout the paged
  attention kernel reads. With ``int8_kv=True`` each cache is a pair
  ``(codes int8 [L, Hkv, P + 1, page, D], scales f32 [L, Hkv, P + 1,
  page, 1])``: every written row is quantized with one scale per head_dim
  row (``memory.quantize_rows_int8``), (D + 4) / (2 D) of the bf16 bytes.
  The last page is a non-allocable scratch page
  that padded prefill rows write to. A ``PagePool`` hands pages to
  sequences on admission and as they grow, and takes them back on
  completion.
- ``ContinuousBatchingEngine`` admits waiting requests into free slots
  (group prefill, or chunked prefill of ``prefill_chunk`` tokens per tick)
  and runs one batched decode tick for every live slot per ``step()``.
  On the card the tick is one CUDA graph, captured at the engine's first
  tick (or by ``warmup()``) and replayed every tick: the counterpart of
  the JAX package's compiled ``_decode_jit``, a fixed-shape program over
  ``max_slots`` rows and ``pages_per_seq``-wide tables. It holds the
  embedding gather, every layer's projections, rope, KV write and paged
  attention, the final norm and the head up to f32 logits; the argmax or
  the sampler runs after the replay. On the CPU the same tick runs
  eagerly. Decode attention is a hand-written CUDA kernel
  (``ops.kernels.decode_attention.paged_attention``, or
  ``paged_attention_int8`` over an int8 cache, which dequantizes in f32
  inside the kernel); every RMS norm is the CUDA row kernel. Prefill
  attention is plain PyTorch (matmul, masked f32 softmax, matmul). In int8
  mode group prefill round-trips k and v through the quantizer before both
  its attention and the cache write, and chunked prefill writes first and
  reads the prefix back dequantized to the model type, as the JAX package
  does. The card takes the kernel and the CPU its plain version; the JAX
  package's ``PTPU_INT8_KV`` and ``PTPU_PAGED_INT8_KERNEL`` knobs are not
  ported.
- Every decode-side forward (the tick, the speculative verify, the draft's
  windows) runs its rows padded to one engine-wide count, a multiple of
  ``DECODE_GEMM_ROWS``: a GEMM library may pick another algorithm, and
  another summation order, for another row count, and the speculative
  contract needs a token's logits to be the same whichever forward made
  them. The zero rows are never attended nor written.
- ``int8_weights=True`` packs the 7 projection slabs as int8 codes with one
  f32 scale per output column (``quant.quantize_weight_cols_int8``); every
  projection, in prefill, the tick and the verify, is then the int8 x int8
  -> int32 GEMM (``quant.int8_weight_matmul``). Embedding, norms and head
  stay exact.
- ``draft_model=`` turns on speculative decoding
  (``fleet.spec_decode.DraftRunner``): on a greedy tick the draft proposes
  ``spec_tokens`` tokens, one target forward verifies them all, and the
  longest draft prefix equal to the target's own greedy tokens is emitted
  with the target's next token. On the card the draft's proposal is one
  CUDA graph and the verify another, read back once. Sampled ticks fall
  back to the plain tick, and the draft catches up on its carry token.
- On pool exhaustion the youngest request is preempted. Under
  ``preempt_policy="recompute"`` its tokens fold into the resume prompt;
  under ``"swap"`` its written pages are copied to pinned host memory and
  copied back into fresh pages on re-admission.
- ``enable_prefix_cache=True`` shares full KV pages between requests whose
  prompts start with the same tokens, addressed by a hash chain over the
  pages' tokens; released pages stay cached until the pool runs short.
  ``export_prefix_pages`` and ``import_prefix_pages`` move cached pages to
  another engine.
- ``prefill_only=True`` makes the prefill half of a disaggregated pair
  (``fleet.disagg``): ``extract`` snapshots a request's pages to the host
  as a swap-out does, and the decode half's ``inject`` queues it for the
  swap-restore admission.
- ``submit(deadline_seconds=)`` and ``cancel(rid)`` tear requests out of
  the queue or their slot; ``reload_weights()`` re-reads the model's
  weights (a ``GPTForCausalLMPipe`` is served from its stacked
  parameters, without a copy). ``max_new_cap``, ``spec_paused`` and
  ``prefill_chunk_cap`` are the brownout caps an overload controller sets.

Telemetry (``paddle_tpu_torch.telemetry``): the reference's 16 serving
metrics under its names, labels and buckets, updated at the same event
sites; each request's async span tree (``request``, ``queue``,
``prefill``, with ``admitted``, ``first_token`` and ``preempt`` marks) and
the ``admission``, ``prefill_tick``, ``prefill_group``, ``decode_tick``,
``spec_draft``, ``spec_verify``, ``spec_accept`` and ``detokenize``
events. On the card the tick's spans wrap the graph replay from the host
and its read-back; nothing goes into the graph, and every gauge reads the
host's page pool and queues, never a device tensor.

Unlike the JAX package, which donates its caches to functional updates,
the KV writes here happen in place. Layers run as a Python loop (no scan).
A CUDA graph over the chunked prefill is not ported yet.
"""
from __future__ import annotations

import hashlib
import time
import warnings
from collections import deque

import numpy as np
import torch
import torch.nn.functional as F

from .. import telemetry as _telemetry
from ..device import resolve_device
from ..memory import dequantize_rows_int8, quantize_rows_int8
from ..models.gpt import _attention_plain, _rms_pure, _rope_at_positions
from ..ops.kernels import CountedGraph
from ..ops.kernels.decode_attention import (paged_attention,
                                            paged_attention_int8)
from ..quant import (GEMM_SITES, int8_linear, int8_weights_enabled,
                     note_gemm_mode, note_step_tokens, quantize_linear_int8)
from ..telemetry import trace as _trace

__all__ = ["PagePool", "ContinuousBatchingEngine", "int8_kv_enabled",
           "DECODE_GEMM_ROWS"]

_DECODE_WEIGHT_NAMES = ("ln1", "wq", "wk", "wv", "wo", "ln2", "wg", "wu",
                        "wd")

# serving metrics (names, labels and help: the reference's, docs/
# TELEMETRY.md). Gauges are refreshed once per step(); counters tick at the
# event sites.
_TELEMETRY_REG = _telemetry.get_registry()
_QUEUE_DEPTH = _telemetry.gauge(
    "serving_queue_depth", "requests waiting for admission")
_SLOTS_OCCUPIED = _telemetry.gauge(
    "serving_slots_occupied", "engine slots holding a live request")
_BATCH_OCCUPANCY = _telemetry.histogram(
    "serving_batch_occupancy", "live slots / max_slots per decode tick",
    buckets=tuple(i / 8 for i in range(1, 9)))
_KV_UTIL = _telemetry.gauge(
    "serving_kv_page_utilization", "fraction of KV pages allocated")
_ADMISSIONS = _telemetry.counter(
    "serving_admissions_total", "requests admitted into slots",
    labelnames=("kind",))
_PREEMPTIONS = _telemetry.counter(
    "serving_preemptions_total", "requests evicted under page pressure",
    labelnames=("policy",))
_STEPS = _telemetry.counter(
    "serving_steps_total", "engine decode ticks")
_REQ_LATENCY = _telemetry.histogram(
    "serving_request_latency_seconds", "submit-to-completion wall time")
_TTFT = _telemetry.histogram(
    "serving_ttft_seconds", "submit-to-first-token wall time")
_REF_UNDERFLOWS = _telemetry.counter(
    "serving_page_ref_underflows_total",
    "KV page refcount decremented below zero (double-release bug)")
_CANCELLATIONS = _telemetry.counter(
    "serving_cancellations_total",
    "requests cancelled before completion (docs/SERVING.md)",
    labelnames=("reason",))
_SPEC_TICKS = _telemetry.counter(
    "serving_spec_ticks_total",
    "decode ticks under a draft model: 'spec' ran draft+verify, "
    "'fallback' took the plain single-token path (sampled rows live)",
    labelnames=("mode",))
_SPEC_DRAFTED = _telemetry.counter(
    "serving_spec_draft_tokens_total",
    "draft tokens proposed to the verifier")
_SPEC_ACCEPTED = _telemetry.counter(
    "serving_spec_accepted_tokens_total",
    "draft tokens accepted by the target verify pass")
_INT8_KV = _telemetry.gauge(
    "serving_int8_kv_active",
    "1 when the engine stores paged KV as blockwise int8 (+fp32 "
    "per-row scales in the page table) — docs/SERVING.md")
_WEIGHT_BYTES = _telemetry.gauge(
    "serving_weight_bytes",
    "resident packed decode-weight bytes per storage dtype "
    "(docs/QUANT.md: int8-packed replicas report the reduced footprint)",
    labelnames=("dtype",))


# ---------------------------------------------------------------- int8 KV
#: relative round-trip error the int8-KV parity probe tolerates. Row-absmax
#: int8 holds about 1/254 of the row range per element; 2% is an order of
#: magnitude of headroom, so a failure means the quantizer itself drifted.
KV_QUANT_TOL = 0.02


def _int8_kv_probe_ok():
    """Round-trip the quantizer every int8 cache write runs over a skewed
    tensor with outlier rows; True when the worst error relative to each
    row's absmax is within ``KV_QUANT_TOL``."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 64)).astype(np.float32)
    x[0] *= 1e3        # large-magnitude row
    x[1] *= 1e-3       # tiny row
    x[2, 5] = 400.0    # in-row outlier (worst case for absmax grids)
    rt = dequantize_rows_int8(*quantize_rows_int8(torch.from_numpy(x)))
    absmax = np.maximum(np.abs(x).max(-1, keepdims=True), 1e-12)
    err = float(np.max(np.abs(rt.numpy() - x) / absmax))
    return err <= KV_QUANT_TOL


def int8_kv_enabled(requested=False):
    """The int8 paged-KV mode engages when the constructor asks for it
    AND the parity probe passes. A failing probe warns and the engine
    serves exact KV instead of drifted KV."""
    if not requested:
        return False
    if _int8_kv_probe_ok():
        return True
    warnings.warn(
        "int8_kv requested but the paged-KV quantization parity probe "
        "FAILED its round-trip tolerance: serving with exact "
        f"(non-quantized) KV instead (tol {KV_QUANT_TOL})")
    return False


# ------------------------------------------------------- KV cache helpers
# A cache is one stacked tensor [L, Hkv, num_pages + 1, page, D] (exact)
# or a (codes int8 [L, Hkv, P + 1, page, D], scales f32 [L, Hkv, P + 1,
# page, 1]) pair (int8). The helpers below take either, so every cache
# consumer is written once.
def _kv_map(fn, c):
    return tuple(fn(x) for x in c) if isinstance(c, tuple) else fn(c)


def _kv_map2(fn, a, b):
    if isinstance(a, tuple):
        return tuple(fn(x, y) for x, y in zip(a, b))
    return fn(a, b)


def _kv_index(c, li):
    """Per-layer view of a stacked cache."""
    return _kv_map(lambda x: x[li], c)


def _kv_write(cache_l, pages, offs, vals):
    """Scatter token rows into a PER-LAYER cache [Hkv, P, page, D], in
    place: ``pages``/``offs`` index tensors of one shape S*, ``vals``
    [Hkv, *S, D] at the model type. An int8 cache quantizes each row (one
    f32 scale per head_dim row) at the write."""
    if isinstance(cache_l, tuple):
        (q, s), (qv, sv) = cache_l, quantize_rows_int8(vals)
        q[:, pages, offs, :] = qv
        s[:, pages, offs, :] = sv
    else:
        cache_l[:, pages, offs, :] = vals.to(cache_l.dtype)


def _kv_write_layer(cache, li, pages, offs, vals):
    """``_kv_write`` against layer ``li`` of a stacked cache. ``vals`` is
    [Hkv, N, D]; the JAX package's advanced-index payload is [N, Hkv, D]
    and lands in the same cells."""
    _kv_write(_kv_index(cache, li), pages, offs, vals)


def _kv_gather_rows(cache_l, idx, dtype):
    """Pages by id from a PER-LAYER cache -> [Hkv, *idx.shape, page, D] at
    ``dtype``. An int8 cache dequantizes (codes * scales in f32, then the
    cast); an exact cache returns its storage as it is."""
    idx = idx.long()
    if isinstance(cache_l, tuple):
        q, s = cache_l
        return dequantize_rows_int8(q[:, idx], s[:, idx], dtype)
    return cache_l[:, idx]


def _kv_nbytes(c):
    """Bytes a cache holds on its device (codes and scales together)."""
    leaves = c if isinstance(c, tuple) else (c,)
    return sum(x.numel() * x.element_size() for x in leaves)


#: the 7 projection slabs ``int8_weights`` packs as int8 (the norms, the
#: embedding and the head stay exact)
_QUANT_WEIGHT_NAMES = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")

#: the decode-side forwards run their GEMMs over a multiple of this many
#: rows (at up to 64 rows the projections are bound by reading the
#: weights, so the padding costs about nothing)
DECODE_GEMM_ROWS = 64


def _wmat(x, *ws):
    """``x @ W`` for each packed projection of one input, the one place a
    projection is applied: an exact ``[out, in]`` slab through
    ``F.linear``; an int8 ``(codes [out, in], scales [1, out])`` pair
    through the int8 GEMM, never expanded back to a wide type. The int8
    ones share one quantization of x's rows (the same values each would
    compute: the JAX package's compiler merges them the same way)."""
    xq = (quantize_rows_int8(x) if any(isinstance(w, tuple) for w in ws)
          else None)
    out = [int8_linear(x, w, xq) if isinstance(w, tuple) else F.linear(x, w)
           for w in ws]
    return out[0] if len(ws) == 1 else out


@torch.no_grad()
def _pack_weights(model, int8=False, into=None):
    """Decode weight tree {"layers": [9-tuple per layer], "embed", "fnorm",
    "head"} in ``_DECODE_WEIGHT_NAMES`` order, the projections in the
    ``[out, in]`` layout ``F.linear`` takes. Counterpart of the JAX
    package's ``_pack_weights_stacked``: the Python layer loop needs no
    stacked copy, so the tree references the model's parameters (a
    ``GPTForCausalLMPipe`` gives views of its stacked slabs). The embedding
    and final norm sit on the model's ``.model`` core where it has one; a
    model without ``lm_head`` ties its head to the embedding.

    ``int8=True`` packs the ``_QUANT_WEIGHT_NAMES`` slabs as ``(codes int8
    [out, in], scales f32 [1, out])``. Given ``into`` (the tree packed
    before), codes and scales of the same shapes are written into its
    tensors, so a CUDA graph captured on them reads the new values."""
    core = model.model if hasattr(model, "model") else model
    head = getattr(model, "lm_head", None)
    layers = []
    for li, p in enumerate(model._decode_params()):
        lp = []
        for j, n in enumerate(_DECODE_WEIGHT_NAMES):
            w = p[n]
            if int8 and n in _QUANT_WEIGHT_NAMES:
                w = quantize_linear_int8(w)
                old = into["layers"][li][j] if into is not None else None
                if (isinstance(old, tuple)
                        and [x.shape for x in old] == [x.shape for x in w]):
                    for dst, src in zip(old, w):
                        dst.copy_(src)
                    w = old
            lp.append(w)
        layers.append(tuple(lp))
    return {"layers": layers,
            "embed": core.embed_tokens.weight,
            "fnorm": core.final_norm.weight,
            "head": head.weight if head is not None else None}


def _weight_leaves(weights):
    """Every tensor of a packed weight tree, in a fixed order (an int8
    projection gives its codes, then its scales)."""
    leaves = [x for lp in weights["layers"] for w in lp
              for x in (w if isinstance(w, tuple) else (w,))]
    leaves += [weights[n] for n in ("embed", "fnorm", "head")
               if weights[n] is not None]
    return leaves


def _weight_nbytes(weights):
    """Bytes of the packed decode tree by storage dtype (the JAX package's
    names: ``float32``, ``bfloat16``, ``int8``)."""
    out = {}
    for w in _weight_leaves(weights):
        key = str(w.dtype).removeprefix("torch.")
        out[key] = out.get(key, 0) + w.numel() * w.element_size()
    return out


def _capture(fn, device, name, signature):
    """Run ``fn()`` once eagerly on a side stream (PyTorch's condition for
    a capture: the pass builds the kernels and cuBLAS's state, and its
    result is this call's), then capture it into a ``CountedGraph``; the
    capture runs nothing, and reports ``name`` and ``signature`` (the
    captured row count and shapes) to the recompile watchdog. Returns the
    graph, the graph's output tensors (rewritten by every replay) and the
    eager pass's output. A capture that fails raises."""
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = fn()
    cur.wait_stream(side)
    graph = CountedGraph()
    return graph, graph.capture(fn, name, signature), out


class PagePool:
    """Free-list page allocator (the block manager)."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free = deque(range(num_pages))

    def alloc(self, n: int):
        if n > len(self._free):
            raise MemoryError(
                f"PagePool: need {n} pages, {len(self._free)} free")
        return [self._free.popleft() for _ in range(n)]

    def free(self, pages):
        self._free.extend(pages)

    @property
    def available(self):
        return len(self._free)


class _Request:
    __slots__ = ("rid", "prompt", "generated", "length", "pages",
                 "temperature", "top_k", "top_p", "on_token", "prefill_pos",
                 "seq_tokens", "admit_seq", "swapped", "submit_t",
                 "first_token_t", "deadline")

    def __init__(self, rid, prompt, temperature=0.0, top_k=0, top_p=1.0,
                 on_token=None, deadline=None):
        self.rid = rid
        self.prompt = list(prompt)
        self.generated = []
        self.length = 0          # tokens currently in the kv pages
        self.pages = []
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.on_token = on_token
        self.prefill_pos = 0     # tokens already written to kv (chunked)
        # the tokens prefill must (re)build KV for: the prompt initially;
        # after a recompute preemption, prompt + generated-so-far
        self.seq_tokens = self.prompt
        self.admit_seq = -1      # admission order (victims: youngest)
        self.swapped = None      # host KV snapshot (swap policy)
        self.submit_t = time.perf_counter()
        self.first_token_t = None
        self.deadline = deadline  # absolute perf_counter() cancel point


def _sample_rows(logits, temps, top_ks, top_ps, generator):
    """Per-row temperature / top-k / top-p sampling; temp <= 0 rows take
    the argmax. Temperature scales before the filters; a logit survives
    only if it passes both."""
    f32 = logits.float()
    greedy = f32.argmax(-1)
    scaled = f32 / temps.clamp_min(1e-6)[:, None]
    V = scaled.shape[-1]
    srt = torch.sort(scaled, -1, descending=True).values
    k_eff = torch.where(top_ks > 0, top_ks, torch.full_like(top_ks, V))
    kth = srt.gather(1, (k_eff - 1).clamp(0, V - 1)[:, None].long())
    neg = torch.full_like(srt, -torch.inf)
    topk_sorted = torch.where(srt < kth, neg, srt)
    probs_sorted = torch.softmax(topk_sorted, -1)
    csum = torch.cumsum(probs_sorted, -1)
    # nucleus: the smallest prefix with cumulative mass >= top_p (the first
    # token always stays)
    keep = (csum - probs_sorted) < top_ps[:, None]
    thr = torch.where(keep, topk_sorted,
                      torch.full_like(srt, torch.inf)).amin(-1, keepdim=True)
    masked = torch.where(scaled < torch.maximum(kth, thr),
                         torch.full_like(scaled, -torch.inf), scaled)
    sampled = torch.multinomial(torch.softmax(masked, -1), 1,
                                generator=generator)[:, 0]
    return torch.where(temps <= 0.0, greedy, sampled)


class _DecoderStack:
    """The decoder math the engine and its speculative draft share: one
    layer, a group prefill pass and a decode window over a paged cache.
    A subclass sets ``cfg``, ``hd``, ``hkv``, ``_weights``, ``kc``, ``vc``,
    ``page``, ``pages_per_seq``, ``_rows`` (the decode GEMMs' row count)
    and ``device``."""

    def _tensor(self, values, dtype):
        return torch.as_tensor(np.asarray(values), dtype=dtype,
                               device=self.device)

    def _layer_forward(self, li, lp, x, pos0, attend):
        """One decoder layer: projections + rope + ``attend(li, q, k, v)``
        (which owns the cache writes and the attention) + MLP. Shared by
        the prefill paths and the decode windows."""
        ln1, wq, wk, wv, wo, ln2, wg, wu, wd = lp
        B, S = x.shape[:2]
        q, k, v = _wmat(_rms_pure(x, ln1), wq, wk, wv)
        q = q.reshape(B, S, self.cfg.num_heads, self.hd)
        k = k.reshape(B, S, self.hkv, self.hd)
        v = v.reshape(B, S, self.hkv, self.hd)
        q, k = _rope_at_positions(q, pos0), _rope_at_positions(k, pos0)
        o = attend(li, q, k, v)                       # [B, S, Hq, D]
        x = x + _wmat(o.reshape(B, S, -1), wo)
        g, u = _wmat(_rms_pure(x, ln2), wg, wu)
        return x + _wmat(F.silu(g) * u, wd)

    def _logits(self, x):
        w = self._weights
        return F.linear(x, w["head"] if w["head"] is not None
                        else w["embed"])

    @staticmethod
    def _paged_attend(q, kc_l, vc_l, tables, lens):
        """Single-position paged attention over a PER-LAYER cache:
        q [B, Hq, D] -> [B, Hq, D]. An exact cache takes the paged
        attention kernel, an int8 cache the int8 one (codes * scales
        dequantized in f32 inside the kernel)."""
        if isinstance(kc_l, tuple):
            return paged_attention_int8(q.contiguous(), *kc_l, *vc_l,
                                        tables, lens)
        return paged_attention(q.contiguous(), kc_l, vc_l, tables, lens)

    def _group_pass(self, pages_list, tokens_list):
        """ONE padded batch over whole token prefixes: write every
        position's KV into its pages (``pages_list[i]`` holds prefix i)
        and return the last layer's hidden rows [B, S, H] and the lengths.
        Over an int8 cache k and v round-trip through the page quantizer
        before both the attention and the cache write, so group prefill,
        chunked prefill and decode read the same quantized KV
        (re-quantizing a round-tripped row gives the same codes)."""
        w = self._weights
        dev = self.device
        B = len(tokens_list)
        lens = np.asarray([len(t) for t in tokens_list])
        S = int(lens.max())
        ids_np = np.zeros((B, S), np.int64)
        for i, t in enumerate(tokens_list):
            ids_np[i, : lens[i]] = t
        x = w["embed"][self._tensor(ids_np, torch.long)]     # [B, S, H]
        pos0 = torch.zeros(B, dtype=torch.long, device=dev)
        mask = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
        int8 = isinstance(self.kc, tuple)

        # flattened valid (row, pos) pairs -> page/offset scatter targets
        rows = self._tensor(
            np.concatenate([np.full(n, i) for i, n in enumerate(lens)]),
            torch.long)
        poss_np = np.concatenate([np.arange(n) for n in lens])
        poss = self._tensor(poss_np, torch.long)
        tok_pages = self._tensor(np.concatenate(
            [np.asarray(p, np.int64)[np.arange(n) // self.page]
             for p, n in zip(pages_list, lens)]), torch.long)
        offs = self._tensor(poss_np % self.page, torch.long)

        def attend(li, q, k, v):
            if int8:
                k = dequantize_rows_int8(*quantize_rows_int8(k), k.dtype)
                v = dequantize_rows_int8(*quantize_rows_int8(v), v.dtype)
            o = _attention_plain(q, k, v, mask)
            _kv_write_layer(self.kc, li, tok_pages, offs,
                            k[rows, poss].transpose(0, 1))
            _kv_write_layer(self.vc, li, tok_pages, offs,
                            v[rows, poss].transpose(0, 1))
            return o

        for li, lp in enumerate(w["layers"]):
            x = self._layer_forward(li, lp, x, pos0, attend)
        return x, lens

    def _window_hidden(self, toks, pos0, tables):
        """The decode forward over a window: ``toks`` [B, C] at positions
        ``pos0 + i`` (``pos0`` [B]), ``tables`` [B, pages_per_seq] int32.
        Writes every window row's KV first, then attends position by
        position with the paged kernel over ``pos0 + i + 1`` rows, the
        operands a decode tick at that position would see. The window's
        rows run position-major (row ``i * B + b``) and padded with zero
        rows to ``self._rows``, so every projection, norm and head GEMM of
        a decode-side forward has the same row count; returns the
        final-normed hidden rows [rows, H]. Reads nothing back to the host,
        so the card captures it whole into a CUDA graph."""
        w = self._weights
        dev = self.device
        B, C = toks.shape
        n = B * C
        R = max(self._rows, n)
        steps = torch.arange(C, device=dev)
        pos = (pos0.long()[None, :] + steps[:, None]).reshape(-1)   # [n]
        x = w["embed"][F.pad(toks.t().reshape(-1).long(), (0, R - n))]
        x = x[:, None]                                       # [R, 1, H]
        page_idx = (pos // self.page).clamp(0, self.pages_per_seq - 1)
        page_ids = tables.long().repeat(C, 1).gather(
            1, page_idx[:, None])[:, 0]
        offs = pos % self.page
        kv_lens = (pos0.long()[None, :] + steps[:, None] + 1).to(torch.int32)

        def attend(li, q, k, v):
            kc_l, vc_l = _kv_index(self.kc, li), _kv_index(self.vc, li)
            _kv_write(kc_l, page_ids, offs, k[:n, 0].transpose(0, 1))
            _kv_write(vc_l, page_ids, offs, v[:n, 0].transpose(0, 1))
            o = [self._paged_attend(q[i * B:(i + 1) * B, 0], kc_l, vc_l,
                                    tables, kv_lens[i]) for i in range(C)]
            o = o[0] if C == 1 else torch.cat(o)             # [n, Hq, D]
            if R > n:
                o = F.pad(o, (0, 0, 0, 0, 0, R - n))
            return o[:, None]                                # [R, 1, Hq, D]

        pos_rows = F.pad(pos, (0, R - n))
        for li, lp in enumerate(w["layers"]):
            x = self._layer_forward(li, lp, x, pos_rows, attend)
        return _rms_pure(x, w["fnorm"])[:, 0]


class ContinuousBatchingEngine(_DecoderStack):
    """Paged-KV continuous batcher over a ``LlamaForCausalLM`` or a
    ``GPTForCausalLMPipe`` (any model with ``_decode_params()``).

    ``device`` defaults to CUDA and must be where the model's weights are;
    ``device="cpu"`` runs the kernels' plain versions and the eager tick.
    ``int8_kv=True`` stores the paged KV as int8 codes plus one f32 scale
    per row (``self.int8_kv`` says whether the mode engaged);
    ``int8_weights=True`` serves int8-resident projections
    (``self.int8_weights``). ``draft_model`` (on the same device) turns on
    speculative decoding of ``spec_tokens`` draft tokens a tick.
    ``preempt_policy`` is ``"recompute"`` or ``"swap"``;
    ``enable_prefix_cache`` needs chunked prefill and the recompute
    policy. ``prefill_only`` makes the prefill half of a disaggregated
    pair; ``rid_base`` starts the request ids."""

    def __init__(self, model, max_slots=4, page_size=64, num_pages=None,
                 max_seq_len=None, max_new_tokens=32, eos_token_id=None,
                 seed=0, prefill_chunk=None, preempt_policy="recompute",
                 enable_prefix_cache=False, int8_kv=False,
                 int8_weights=False, draft_model=None, spec_tokens=4,
                 prefill_only=False, rid_base=0, device=None):
        self.device = resolve_device(device)
        core = model.model if hasattr(model, "model") else model
        wdev = core.embed_tokens.weight.device
        if wdev.type != self.device.type:
            raise ValueError(f"engine device {self.device} but the model's "
                             f"weights are on {wdev}")
        if preempt_policy not in ("recompute", "swap"):
            raise ValueError(
                f"preempt_policy must be 'recompute' or 'swap', "
                f"got {preempt_policy!r}")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        # the prefix cache prefills a tail that starts mid-prompt (chunked
        # prefill) and its shared pages must never be written (a swap
        # restore scatters into pages)
        if enable_prefix_cache:
            if prefill_chunk is None:
                raise ValueError("enable_prefix_cache requires chunked "
                                 "prefill (prefill_chunk=...)")
            if preempt_policy != "recompute":
                raise ValueError("enable_prefix_cache composes only with "
                                 "preempt_policy='recompute'")
        self.spec_tokens = int(spec_tokens)
        if draft_model is not None and self.spec_tokens < 1:
            raise ValueError("spec_tokens must be >= 1 with a draft model, "
                             f"got {spec_tokens}")
        cfg = model.config
        self.cfg = cfg
        self.page = page_size
        self.max_seq = max_seq_len or cfg.max_seq_len
        self.pages_per_seq = (self.max_seq + page_size - 1) // page_size
        self.max_slots = max_slots
        self.max_new_tokens = max_new_tokens
        self.eos = eos_token_id
        num_pages = num_pages or (max_slots * self.pages_per_seq + 2)
        self.pool = PagePool(num_pages)
        self._trash_page = num_pages
        self.hd = cfg.hidden_size // cfg.num_heads
        self.hkv = cfg.num_kv_heads
        self.preempt_policy = preempt_policy
        self.prefill_chunk = prefill_chunk
        # the prefill half of a disaggregated pair admits and prefills but
        # never decodes; its finished prefills wait in their slots for
        # extract()
        self.prefill_only = bool(prefill_only)

        self._model = model
        # int8-resident projections behind the quantizer's probe
        self.int8_weights = int8_weights_enabled(int8_weights)
        self._weights = _pack_weights(model, self.int8_weights)
        self._publish_weights()
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        # int8 paged KV: codes plus one f32 scale per row, behind the
        # quantizer's parity probe
        self.int8_kv = int8_kv_enabled(int8_kv)
        dt = self._weights["embed"].dtype
        self._kv_dtype = dt
        cache_shape = (cfg.num_layers, self.hkv, num_pages + 1, page_size,
                       self.hd)

        def new_cache():
            if self.int8_kv:
                return (torch.zeros(cache_shape, dtype=torch.int8,
                                    device=self.device),
                        torch.zeros(cache_shape[:-1] + (1,),
                                    dtype=torch.float32, device=self.device))
            return torch.zeros(cache_shape, dtype=dt, device=self.device)

        # allocated once: the decode graphs hold their addresses, so every
        # write (ticks, prefill, swap-in) lands in place
        self.kc = new_cache()
        self.vc = new_cache()

        # pages each decoding slot must own before a tick: a spec tick
        # writes the carry token and K drafts past `length`, a plain tick
        # the carry token
        self._lookahead = (self.spec_tokens + 1 if draft_model is not None
                           else 1)
        rows = max_slots * self._lookahead
        self._rows = -(-rows // DECODE_GEMM_ROWS) * DECODE_GEMM_ROWS

        # the decode-side inputs [tokens | lens | tables | prev] as one
        # int32 vector; on the card a pinned staging copy and the graphs'
        # static device copy (one host-to-device copy a tick)
        n_in = max_slots * (3 + self.pages_per_seq)
        self._graph = None            # CountedGraph of the decode tick
        self._graph_ptrs = None       # weight addresses it was captured on
        self._graph_out = None        # its f32 logits [max_slots, V]
        self._verify_graph = None     # CountedGraph of the spec verify
        self._verify_out = None       # its [max_slots, 2K + 1] tokens
        if self.device.type == "cuda":
            self._stage = torch.empty(n_in, dtype=torch.int32,
                                      pin_memory=True)
            self._static = torch.empty(n_in, dtype=torch.int32,
                                       device=self.device)
        self.build_seconds = None     # set by warmup()

        self._slots: list[_Request | None] = [None] * max_slots
        self._waiting: deque[_Request] = deque()
        self._next_rid = int(rid_base)
        self._admit_counter = 0
        self.prefill_batches = 0      # admission groups (group prefill)
        self.prefill_chunk_steps = 0  # batched chunk passes
        self.prefills_completed = 0   # per request (both prefill modes)
        self.decode_ticks = 0
        self.preemptions = 0
        self.swaps_out = 0            # victims snapshotted to host
        self.swaps_in = 0             # snapshots restored to the card
        # prefix cache: chain digest -> page id; pages the cache holds;
        # page id -> live-request refcount
        self.enable_prefix_cache = bool(enable_prefix_cache)
        self._prefix_cache = {}
        self._cached_pages = set()
        self._page_ref = {}
        self.prefix_cache_hits = 0    # pages reused instead of prefilled
        self.prefix_cache_evictions = 0
        self.prefix_tokens_skipped = 0
        self.prefix_pages_exported = 0  # shipped to a drain destination
        self.prefix_pages_imported = 0  # warmed from a draining peer
        # requests admitted before a reload_weights hold stale KV and must
        # not register pages
        self._cache_admit_floor = 0
        self.cancelled = {}           # rid -> reason
        self.cancellations = 0
        # speculative decoding: draft K tokens a tick, verify them in one
        # target forward, emit the accepted prefix and the target's next
        # token
        self._draft = None
        if draft_model is not None:
            from .fleet.spec_decode import DraftRunner

            self._draft = DraftRunner(self, draft_model)
        self.spec_ticks = 0
        self.spec_draft_tokens = 0
        self.spec_accepted_tokens = 0
        # the brownout caps an overload controller sets and restores; all
        # None / False is full service
        self.max_new_cap = None       # L1: cap on tokens to generate
        self.spec_paused = False      # L2: no speculative ticks
        self.prefill_chunk_cap = None  # L3: prefill tokens per tick

    def reload_weights(self, model=None):
        """Re-read the weights from the model (after an update in place, or
        from ``model``); int8 weights are quantized again, into the same
        tensors where the shapes allow. A decode graph captured on other
        weight storage is dropped, and the next tick captures it again;
        one on the same storage reads the new values at its next replay.
        Cached prefix KV was computed under the old weights: ref-0 cached
        pages are freed now, pages in use when their readers release them,
        and requests already admitted register no pages."""
        self._weights = _pack_weights(
            self._model if model is None else model, self.int8_weights,
            into=self._weights)
        self._publish_weights()
        if (self._graph_ptrs is not None
                and self._graph_ptrs != self._weight_ptrs()):
            self._graph = self._graph_ptrs = self._graph_out = None
            self._verify_graph = self._verify_out = None
        if self.enable_prefix_cache:
            for key in list(self._prefix_cache):
                pg = self._prefix_cache.pop(key)
                self._cached_pages.discard(pg)
                if self._page_ref.get(pg, 0) == 0:
                    self._page_ref.pop(pg, None)
                    self.pool.free([pg])
            self._cache_admit_floor = self._admit_counter

    def _weight_ptrs(self):
        return tuple(w.data_ptr() for w in _weight_leaves(self._weights))

    def _publish_weights(self):
        """The resident weight bytes by dtype, and the int8 GEMM's mode
        per projection site with its FLOPs per token (path "serve")."""
        for dt, nb in self.weight_bytes.items():
            _WEIGHT_BYTES.set(float(nb), labels=(dt,))
        if self.int8_weights:
            flops = 2 * sum(w[0].numel() for lp in self._weights["layers"]
                            for w in lp if isinstance(w, tuple))
            note_gemm_mode("serve", GEMM_SITES, "int8", flops)
        else:
            note_gemm_mode("serve", frozenset(), None)

    def _note_int8_tokens(self, n):
        """``n`` tokens went through the int8 projections."""
        if self.int8_weights:
            note_step_tokens(n)

    def _graph_signature(self, *tensors):
        """A captured graph's watchdog signature: its row count and its
        operands' shapes."""
        return (self._rows, *(tuple(t.shape) for t in tensors))

    @property
    def weight_bytes(self):
        """Bytes of the served decode weights by dtype."""
        return _weight_nbytes(self._weights)

    # -- model math ---------------------------------------------------------
    def _head_tokens(self, last, reqs):
        """final-norm'd last hidden rows [B, H] -> first token per req."""
        lg = self._logits(last)
        if any(r.temperature > 0.0 for r in reqs):
            toks = _sample_rows(
                lg,
                self._tensor([r.temperature for r in reqs], torch.float32),
                self._tensor([r.top_k for r in reqs], torch.long),
                self._tensor([r.top_p for r in reqs], torch.float32),
                self._gen)
        else:
            toks = lg.float().argmax(-1)
        return [int(t) for t in toks.cpu().numpy()]

    def _prefill_group(self, reqs):
        """Run ALL newly admitted prompts as ONE padded batch: write each
        prompt's KV into its pages, return the first token per request."""
        self.prefill_batches += 1
        self.prefills_completed += len(reqs)
        B = len(reqs)
        x, lens = self._group_pass([r.pages for r in reqs],
                                   [r.seq_tokens for r in reqs])
        self._note_int8_tokens(int(lens.sum()))
        x = _rms_pure(x, self._weights["fnorm"])
        last = x[torch.arange(B, device=self.device),
                 self._tensor(lens - 1, torch.long)]          # [B, H]
        toks = self._head_tokens(last, reqs)
        for i, r in enumerate(reqs):
            r.length = int(lens[i])
            # in lockstep with length, so a swap snapshot of this request
            # is classified decode-phase (its restore reserves the growth
            # page, not the prompt)
            r.prefill_pos = int(lens[i])
        if self._draft is not None:
            # the draft's KV for these prompts (same pages)
            self._draft.prefill(reqs, [r.seq_tokens for r in reqs])
        return toks

    def _decode_step(self, tokens, lens, tables):
        """ONE batched decode forward: tokens [B] (last emitted), lens [B]
        tokens already cached, tables [B, pages_per_seq] int32 -> f32
        logits [B, V]. The kernel sees ``lens + 1`` valid rows: the current
        token's row is written first. Reads no value back to the host, so
        the card captures it whole into the tick's CUDA graph."""
        h = self._window_hidden(tokens[:, None], lens, tables)
        return self._logits(h)[:tokens.shape[0]].float()

    def _verify_step(self, cur, drafts, lens, tables):
        """The speculative verify: ONE target forward over the window
        ``[carry, d1..dK]`` at positions ``lens .. lens + K``. Every
        projection, norm and the head are row-local and run at the tick's
        row count, and position i attends with the same kernel over the
        same ``lens + i + 1`` rows a plain tick at that position would, the
        earlier window rows having just been written with the values
        sequential ticks would write: each token is the one plain greedy
        decode gives. Returns the drafts and the target's greedy token at
        every position, [B, 2K + 1] int64, one buffer for one read-back."""
        toks = torch.cat([cur.long()[:, None], drafts], 1)      # [B, C]
        B, C = toks.shape
        h = self._window_hidden(toks, lens, tables)
        t = self._logits(h)[:B * C].float().argmax(-1).view(C, B).t()
        return torch.cat([drafts, t], 1)

    def _inputs(self, tokens, lens, tables, prev=None):
        """A decode-side forward's inputs from int32 host arrays. The CPU
        wraps them; the card copies them into the graphs' static buffer
        through the pinned stage and returns its views (tokens, lens,
        tables, prev). The pinned buffer is free to refill: every tick
        ends by reading its results back, which waits for the copy."""
        if self.device.type != "cuda":
            return tuple(torch.from_numpy(a) for a in (tokens, lens, tables)
                         + (() if prev is None else (prev,)))
        n, P = self.max_slots, self.pages_per_seq
        stage = self._stage.numpy()
        stage[:n], stage[n:2 * n] = tokens, lens
        stage[2 * n:(2 + P) * n] = tables.reshape(-1)
        if prev is not None:
            stage[(2 + P) * n:] = prev
        self._static.copy_(self._stage, non_blocking=True)
        s = self._static
        return (s[:n], s[n:2 * n], s[2 * n:(2 + P) * n].view(n, P),
                s[(2 + P) * n:])

    def _tick(self, args):
        """The tick's f32 logits [max_slots, V] from ``_inputs``. The CPU
        runs ``_decode_step`` eagerly; the card replays the tick's graph,
        or with no graph yet, runs the tick eagerly and captures it. The
        returned logits are the graph's output buffer: read them before
        the next tick."""
        if self.device.type != "cuda":
            return self._decode_step(*args[:3])
        if self._graph is None:
            self._graph, self._graph_out, lg = _capture(
                lambda: self._decode_step(*args[:3]), self.device,
                "ContinuousBatchingEngine._decode_step",
                self._graph_signature(*args[:3]))
            self._graph_ptrs = self._weight_ptrs()
            return lg
        self._graph.replay()
        return self._graph_out

    def _decode_logits(self, tokens, lens, tables):
        """The tick's logits [max_slots, V] for int32 host arrays."""
        return self._tick(self._inputs(tokens, lens, tables))

    def _spec_outputs(self, prev, cur, lens, tables, live=0):
        """The device half of a spec tick for int32 host arrays: the
        draft's proposal, then the verify, read back once as the drafts
        [B, K] and the target's tokens [B, K + 1] (int64 numpy). On the
        card each is a graph replay (the first spec tick runs them eagerly
        and captures them); the verify reads the proposal's output buffer
        on the card. ``live`` (the live rows) goes to the verify span."""
        cur_t, lens_t, tables_t, prev_t = self._inputs(cur, lens, tables,
                                                       prev)
        K = self.spec_tokens
        with _trace.span("spec_draft", attrs={"k": K}, cat="serve"):
            d = self._draft.propose(prev_t, cur_t, lens_t, tables_t)

        def verify():
            return self._verify_step(cur_t, d, lens_t, tables_t)

        with _trace.span("spec_verify", attrs={"live": live, "k": K},
                         cat="serve"):
            if self.device.type != "cuda":
                out = verify()
            elif self._verify_graph is None:
                self._verify_graph, self._verify_out, out = _capture(
                    verify, self.device,
                    "ContinuousBatchingEngine._verify_step",
                    self._graph_signature(cur_t, d, lens_t, tables_t))
                self._graph_ptrs = self._weight_ptrs()
            else:
                self._verify_graph.replay()
                out = self._verify_out
            out = out.cpu().numpy()
        return out[:, :K], out[:, K:]

    # -- engine surface -----------------------------------------------------
    def submit(self, prompt_ids, temperature=0.0, top_k=0, top_p=1.0,
               on_token=None, deadline_seconds=None, rid=None) -> int:
        """Queue a request. ``temperature=0`` decodes greedily; otherwise
        softmax sampling with optional top_k / top_p truncation.
        ``on_token(rid, token_id)`` streams each generated token.
        ``deadline_seconds`` cancels the request, queued or running, once
        that much wall time has passed since submit. ``rid`` sets the
        request id (the caller keeps ids unique)."""
        if len(prompt_ids) == 0:
            raise ValueError("empty prompt: a request needs at least one "
                             "token to prefill")
        total = len(prompt_ids) + self.max_new_tokens
        if total > self.max_seq:
            raise ValueError(
                f"request needs {total} tokens (prompt {len(prompt_ids)} + "
                f"max_new {self.max_new_tokens}) > max_seq_len "
                f"{self.max_seq}")
        if self._draft is not None and total + self.spec_tokens > self.max_seq:
            raise ValueError(
                f"speculative decoding writes up to {self.spec_tokens} "
                f"draft tokens of KV past the sequence end: request needs "
                f"{total} + {self.spec_tokens} spec headroom > max_seq_len "
                f"{self.max_seq}")
        # the pool must hold a lone request's speculative window too, or
        # _grow_pages could preempt it forever
        spec_pad = self.spec_tokens if self._draft is not None else 0
        need = (total + spec_pad + self.page - 1) // self.page
        if need > self.pool.num_pages:
            raise ValueError(
                f"request needs {need} pages (incl. {spec_pad} tokens of "
                f"speculative headroom) > pool size {self.pool.num_pages}")
        if rid is None:
            rid = self._next_rid
            self._next_rid += 1
        else:
            rid = int(rid)
            self._next_rid = max(self._next_rid, rid + 1)
        deadline = (time.perf_counter() + float(deadline_seconds)
                    if deadline_seconds is not None else None)
        self._waiting.append(_Request(
            rid, [int(t) for t in prompt_ids], temperature, top_k, top_p,
            on_token, deadline=deadline))
        # the request's span tree: "request" covers submit to retire,
        # "queue" submit to admission (opened again on a requeue)
        _trace.async_begin("request", rid,
                           {"prompt_tokens": len(prompt_ids)})
        _trace.async_begin("queue", rid)
        return rid

    # -- cancellation / deadlines -------------------------------------------
    def _cancel_req(self, req, reason, slot_idx=None):
        """Tear a request out of the engine: release its pages (completed
        prefix pages still register into the prefix cache: their KV is
        valid), drop any host snapshot, and record it in
        ``self.cancelled`` (rid -> reason)."""
        if slot_idx is not None:
            self._slots[slot_idx] = None
            if req.first_token_t is None:
                _trace.async_end("prefill", req.rid, {"cancelled": reason})
        else:
            try:
                self._waiting.remove(req)
            except ValueError:
                pass
            _trace.async_end("queue", req.rid, {"cancelled": reason})
        if req.pages:
            self._release_pages(req, register=True)
        req.swapped = None
        self.cancelled[req.rid] = reason
        self.cancellations += 1
        _CANCELLATIONS.inc(labels=(reason,))
        _trace.async_end("request", req.rid, {"cancelled": reason})

    def cancel(self, rid, reason="user") -> bool:
        """Cancel a queued or running request by id. Returns True if it was
        found live; its pages return to the pool at once."""
        for i, r in enumerate(self._slots):
            if r is not None and r.rid == rid:
                self._cancel_req(r, reason, slot_idx=i)
                return True
        for r in list(self._waiting):
            if r.rid == rid:
                self._cancel_req(r, reason)
                return True
        return False

    def _sweep_deadlines(self):
        """Cancel every request, queued or running, whose deadline has
        passed. A request that has already generated all its tokens is not
        cancelled: the retire loop right after returns it as done."""
        now = time.perf_counter()
        for i, r in enumerate(list(self._slots)):
            if (r is not None and r.deadline is not None
                    and now >= r.deadline and not self._finished(r)):
                self._cancel_req(r, "deadline", slot_idx=i)
        for r in [r for r in self._waiting
                  if r.deadline is not None and now >= r.deadline]:
            self._cancel_req(r, "deadline")

    def _emit(self, req, tok):
        if req.first_token_t is None:
            req.first_token_t = time.perf_counter()
            _TTFT.observe(req.first_token_t - req.submit_t)
            _trace.async_end("prefill", req.rid)
            _trace.async_instant("first_token", req.rid)
        req.generated.append(tok)
        if req.on_token is not None:
            req.on_token(req.rid, tok)

    def _admit(self):
        group = []
        for i in range(self.max_slots):
            if self._slots[i] is not None or not self._waiting:
                continue
            req = self._waiting[0]
            if req.swapped is not None:
                # swap re-admission (a swap victim, or a request handed
                # over by extract()): copy the host snapshot back into fresh
                # pages, no prefill. The reservation is the whole prompt for
                # a mid-prefill victim (its chunk pass writes there) and
                # includes this tick's growth page for a decoding one
                # (without it a page-aligned restoree would be the starved
                # youngest and swap straight back out)
                snap = req.swapped
                n = snap["n"]
                if snap["prefill_pos"] < len(req.seq_tokens):
                    need = max(n, (len(req.seq_tokens) + self.page - 1)
                               // self.page)
                else:
                    need = max(n, (snap["length"] + self.page) // self.page)
                if need > self.pool.available:
                    break  # head-of-line waits for pages
                self._waiting.popleft()
                req.pages = self.pool.alloc(need)
                self._swap_scatter(req.pages[:n], *self._swap_stage(snap))
                req.prefill_pos = snap["prefill_pos"]
                req.length = snap["length"]
                req.swapped = None
                self.swaps_in += 1
                req.admit_seq = self._admit_counter
                self._admit_counter += 1
                self._slots[i] = req
                if (self._draft is not None
                        and req.prefill_pos >= len(req.seq_tokens)):
                    # a decode-phase snapshot carries no draft KV: rebuild
                    # it for the restored context (a mid-prefill one
                    # rebuilds at its prefill completion)
                    self._draft.prefill(
                        [req], [(req.prompt + req.generated)[:req.length]])
                _ADMISSIONS.inc(labels=("swap_restore",))
                _trace.async_end("queue", req.rid)
                _trace.async_instant("admitted", req.rid,
                                     {"kind": "swap_restore"})
                if req.first_token_t is None:
                    # a mid-prefill victim resumes its prefill here: the
                    # span opens again so the TTFT anatomy keeps it
                    _trace.async_begin(
                        "prefill", req.rid,
                        {"kind": "swap_restore",
                         "resume_tokens": len(req.seq_tokens)})
                continue  # not part of any prefill group
            # reserve only what prefill writes; decode pages are allocated
            # as the sequence grows. With the prefix cache on, pages that
            # hold an already computed prefix of this prompt are reused
            # (read-only) and only the tail is reserved and prefilled.
            shared = self._match_prefix(req.seq_tokens)
            need = ((len(req.seq_tokens) + self.page - 1) // self.page
                    - len(shared))
            if self.enable_prefix_cache:
                # pin the matched pages before any eviction runs: a ref-0
                # cached page is otherwise a legal FIFO victim, and
                # reclaiming it here would alias one page into the
                # prefix-read and tail-write roles
                for pg in shared:
                    self._page_ref[pg] = self._page_ref.get(pg, 0) + 1
                if not self._free_pages_for(need):
                    for pg in shared:  # unpin; retry next tick
                        self._page_ref[pg] -= 1
                    break  # head-of-line waits for pages
            elif need > self.pool.available:
                break  # head-of-line waits for pages
            self._waiting.popleft()
            if self.enable_prefix_cache:
                req.pages = shared + self._alloc_ref(need)
                if shared:
                    req.prefill_pos = max(req.prefill_pos,
                                          len(shared) * self.page)
                    self.prefix_cache_hits += len(shared)
                    self.prefix_tokens_skipped += len(shared) * self.page
            else:
                req.pages = self.pool.alloc(need)
            req.admit_seq = self._admit_counter
            self._admit_counter += 1
            self._slots[i] = req
            _ADMISSIONS.inc(labels=("prefill",))
            _trace.async_end("queue", req.rid)
            _trace.async_instant("admitted", req.rid, {"kind": "prefill"})
            if req.first_token_t is None:
                _trace.async_begin("prefill", req.rid,
                                   {"resume_tokens": len(req.seq_tokens)})
            group.append(req)
        if group and self.prefill_chunk is None:
            with _trace.span("prefill_group",
                             attrs={"requests": len(group)}, cat="serve"):
                first = self._prefill_group(group)
            for req, tok in zip(group, first):
                self._emit(req, tok)
        # chunked mode: KV fills incrementally in _prefill_tick

    def _prefill_chunk_step(self, ids, pos0, nvalid, tok_pages, offs, hist):
        """ONE fixed-shape chunk pass over ALL prefilling slots: ids [B, c]
        chunk tokens (zero-padded), pos0 [B] absolute start, nvalid [B]
        real tokens this chunk, tok_pages/offs [B, c] scatter targets
        (padded rows -> the scratch page), hist [B, pages_per_seq] page
        tables. Returns the final-normed last-valid hidden rows [B, H]."""
        w = self._weights
        dev = self.device
        B, c = ids.shape
        S = self.pages_per_seq * self.page
        x = w["embed"][ids]                                  # [B, c, H]
        row_pos = pos0[:, None] + torch.arange(c, device=dev)[None, :]
        cols = torch.arange(S, device=dev)
        # chunk rows attend to [cached prefix + own chunk] causally
        mask = cols[None, None, :] <= row_pos[:, :, None]    # [B, c, S]
        tp = tok_pages.reshape(-1)
        of = offs.reshape(-1)

        def attend(li, q, k, v):
            # write the chunk's kv FIRST, then gather the prefix back (in
            # int8 mode dequantized to the model type: what decode reads)
            kc_l, vc_l = _kv_index(self.kc, li), _kv_index(self.vc, li)
            _kv_write(kc_l, tp, of,
                      k.reshape(B * c, self.hkv, self.hd).transpose(0, 1))
            _kv_write(vc_l, tp, of,
                      v.reshape(B * c, self.hkv, self.hd).transpose(0, 1))
            dt = self._kv_dtype
            ck = _kv_gather_rows(kc_l, hist, dt).reshape(
                self.hkv, B, S, self.hd).permute(1, 2, 0, 3)
            cv = _kv_gather_rows(vc_l, hist, dt).reshape(
                self.hkv, B, S, self.hd).permute(1, 2, 0, 3)
            return _attention_plain(q, ck, cv, mask[:, None])

        for li, lp in enumerate(w["layers"]):
            x = self._layer_forward(li, lp, x, pos0, attend)
        last_rows = (nvalid - 1).clamp(0, c - 1)
        last = x[torch.arange(B, device=dev), last_rows]     # [B, H]
        return _rms_pure(last, w["fnorm"])

    def _prefill_tick(self):
        """Chunked prefill: advance EVERY prefilling slot by up to
        ``prefill_chunk`` prompt tokens in one batched pass, so running
        requests keep decoding every tick while long prompts fill. A
        brownout ``prefill_chunk_cap`` lowers the tokens a row takes per
        pass; the pass keeps its [B, c] shape."""
        reqs = [r for r in self._slots
                if r is not None and r.prefill_pos < len(r.seq_tokens)]
        if not reqs:
            return
        B, c = self.max_slots, self.prefill_chunk
        c_eff = (c if self.prefill_chunk_cap is None
                 else max(1, min(c, self.prefill_chunk_cap)))
        ids_np = np.zeros((B, c), np.int64)
        pos0 = np.zeros(B, np.int64)
        nvalid = np.zeros(B, np.int64)
        tok_pages = np.full((B, c), self._trash_page, np.int64)
        offs = np.zeros((B, c), np.int64)
        hist = np.zeros((B, self.pages_per_seq), np.int64)
        for i, r in enumerate(reqs):
            pos = r.prefill_pos
            n = min(c_eff, len(r.seq_tokens) - pos)
            ids_np[i, :n] = r.seq_tokens[pos:pos + n]
            pos0[i], nvalid[i] = pos, n
            pages = np.asarray(r.pages, np.int64)
            ap = np.arange(pos, pos + n)
            tok_pages[i, :n] = pages[ap // self.page]
            offs[i, :n] = ap % self.page
            own = r.pages[:self.pages_per_seq]
            hist[i, :len(own)] = own
        t = lambda a: self._tensor(a, torch.long)  # noqa: E731
        last = self._prefill_chunk_step(t(ids_np), t(pos0), t(nvalid),
                                        t(tok_pages), t(offs), t(hist))
        self.prefill_chunk_steps += 1
        self._note_int8_tokens(int(nvalid.sum()))
        completed = []
        for i, r in enumerate(reqs):
            r.prefill_pos += int(nvalid[i])
            if r.prefill_pos == len(r.seq_tokens):
                completed.append((i, r))
        if completed:
            rows = last[self._tensor([i for i, _ in completed], torch.long)]
            done = [r for _, r in completed]
            for r, tok in zip(done, self._head_tokens(rows, done)):
                self.prefills_completed += 1
                r.length = len(r.seq_tokens)
                self._emit(r, tok)
            if self._draft is not None:
                self._draft.prefill(done, [r.seq_tokens for r in done])

    # -- swap preemption ----------------------------------------------------
    def _swap_gather(self, pages):
        """Every layer's rows of ``pages`` -> host copies
        [L, Hkv, len(pages), page, D] (an int8 cache yields a (codes,
        scales) pair), pinned on a CUDA engine. One ``index_select`` and
        one device-to-host copy per cache leaf."""
        idx = self._tensor(pages, torch.long)
        pin = self.device.type == "cuda"

        def g(c):
            rows = c.index_select(2, idx)
            return torch.empty(rows.shape, dtype=rows.dtype,
                               pin_memory=pin).copy_(rows)

        return _kv_map(g, self.kc), _kv_map(g, self.vc)

    def _swap_stage(self, snap):
        """A host snapshot's pages -> device tensors (host-to-device copies
        from the pinned buffers)."""
        up = lambda h: h.to(self.device, non_blocking=True)  # noqa: E731
        return _kv_map(up, snap["k"]), _kv_map(up, snap["v"])

    def _swap_scatter(self, pages, k, v):
        """Copy staged snapshot pages into the caches at ``pages``, in
        place (``index_copy_``)."""
        idx = self._tensor(pages, torch.long)
        _kv_map2(lambda c, s: c.index_copy_(2, idx, s), self.kc, k)
        _kv_map2(lambda c, s: c.index_copy_(2, idx, s), self.vc, v)

    def _snapshot_to_host(self, r):
        """Build ``r.swapped``, the host KV snapshot the swap re-admission
        restores (a swap-out and ``extract()`` both make it): only the
        pages that hold written tokens leave the card (a mid-prefill
        victim's untouched prompt pages and grown but empty decode pages
        do not); the restore re-allocates the full reservation from
        ``prefill_pos`` and ``length``."""
        written = max(r.length, r.prefill_pos)
        n = min((written + self.page - 1) // self.page, len(r.pages))
        k, v = self._swap_gather(r.pages[:n])
        r.swapped = {"k": k, "v": v, "n": n, "prefill_pos": r.prefill_pos,
                     "length": r.length}
        return r.swapped

    # -- prefix cache (content-addressed KV pages) --------------------------
    def _chain_keys(self, tokens, n_pages):
        """Chain digests of pages 0..n_pages-1: key_i = sha1(key_{i-1} ||
        tokens of page i), O(1) bytes per entry whatever the prefix
        depth."""
        keys, prev = [], b""
        for i in range(n_pages):
            block = np.asarray(
                tokens[i * self.page: (i + 1) * self.page],
                np.int64).tobytes()
            prev = hashlib.sha1(prev + block).digest()
            keys.append(prev)
        return keys

    def _evictable(self):
        return [k for k, pg in self._prefix_cache.items()
                if self._page_ref.get(pg, 0) == 0]

    def _free_pages_for(self, n):
        """True if n pages can be allocated, evicting ref-0 cached pages
        (FIFO) as needed. Callers pin (incref) any matched shared pages
        first, or eviction could reclaim them."""
        while self.pool.available < n:
            victims = self._evictable()
            if not victims:
                return False
            key = victims[0]
            page = self._prefix_cache.pop(key)
            self._cached_pages.discard(page)
            self._page_ref.pop(page, None)
            self.pool.free([page])
            self.prefix_cache_evictions += 1
        return True

    def _alloc_ref(self, n):
        pages = self.pool.alloc(n)
        for pg in pages:
            self._page_ref[pg] = self._page_ref.get(pg, 0) + 1
        return pages

    def _release_pages(self, req, register):
        """Drop req's claim on its pages. Own pages that hold a complete
        token-prefix page are registered into the prefix cache (kept,
        lazily evictable) instead of freed; the rest return to the pool.
        Without the cache this is ``pool.free``."""
        if not self.enable_prefix_cache:
            self.pool.free(req.pages)
            req.pages = []
            return
        register = register and req.admit_seq >= self._cache_admit_floor
        written = max(req.length, req.prefill_pos)
        full = req.prompt + req.generated
        n_complete = min(written // self.page, len(req.pages))
        keys = (self._chain_keys(full, n_complete)
                if register and n_complete else [])
        freed = []
        for i, pg in enumerate(req.pages):
            ref = self._page_ref.get(pg, 0) - 1
            if ref < 0:
                _REF_UNDERFLOWS.inc()
                raise RuntimeError(
                    f"PagePool refcount underflow: page {pg} released by "
                    f"request {req.rid} but holds no claim (double "
                    "release)")
            self._page_ref[pg] = ref
            if ref > 0:
                continue  # another live request still reads it
            if pg in self._cached_pages:
                continue  # kept by the cache (free but cached)
            if i < len(keys) and keys[i] not in self._prefix_cache:
                self._prefix_cache[keys[i]] = pg
                self._cached_pages.add(pg)
                continue
            freed.append(pg)
            self._page_ref.pop(pg, None)
        self.pool.free(freed)
        req.pages = []

    def _match_prefix(self, tokens):
        """Longest cached full-page chain strictly shorter than the prompt
        (at least one token is left to prefill). Returns the shared
        pages."""
        if not self.enable_prefix_cache:
            return []
        max_pages = (len(tokens) - 1) // self.page
        shared = []
        for key in self._chain_keys(tokens, max_pages):
            pg = self._prefix_cache.get(key)
            if pg is None:
                break
            shared.append(pg)
        return shared

    def _preempt(self, slot_idx):
        """Evict a running request and requeue it at the FRONT of the
        waiting queue. Policy "recompute": release the pages and fold the
        generated tokens into the resume prompt, which re-admission
        prefills again. Policy "swap": snapshot the written pages to host
        memory first; re-admission copies them back, with no
        recompute."""
        r = self._slots[slot_idx]
        if self.preempt_policy == "swap" and r.pages:
            self._snapshot_to_host(r)
            self.swaps_out += 1
            self.pool.free(r.pages)
            r.pages = []
        else:
            # release before resetting the bookkeeping: registration needs
            # the written-token count
            self._release_pages(r, register=True)
            r.seq_tokens = r.prompt + r.generated
            r.prefill_pos = 0
            r.length = 0
        self._slots[slot_idx] = None
        self._waiting.appendleft(r)
        self.preemptions += 1
        _PREEMPTIONS.inc(labels=(self.preempt_policy,))
        if r.first_token_t is None:
            _trace.async_end("prefill", r.rid, {"preempted": True})
        _trace.async_instant("preempt", r.rid,
                             {"policy": self.preempt_policy})
        _trace.async_begin("queue", r.rid, {"requeue": True})

    def _grow_pages(self):
        """Ensure every decoding slot owns pages for this tick's writes:
        the carry token, and under a draft model the K draft tokens too.
        On pool exhaustion, preempt the YOUNGEST occupied slot (its oldest
        peers keep their pages and finish first; a lone request always
        fits by the submit() feasibility check). A prefill-only engine
        never grows: its admissions reserve every page prefill writes."""
        if self.prefill_only:
            return
        while True:
            live = sorted(
                ((i, r) for i, r in enumerate(self._slots)
                 if r is not None and r.length > 0),
                key=lambda ir: ir[1].admit_seq)
            short = False
            for i, r in live:
                need = ((r.length + self._lookahead + self.page - 1)
                        // self.page)
                grow = need - len(r.pages)
                if grow <= 0:
                    continue
                ok = (self._free_pages_for(grow) if self.enable_prefix_cache
                      else grow <= self.pool.available)
                if not ok:
                    short = True
                    break
                r.pages.extend(self._alloc_ref(grow)
                               if self.enable_prefix_cache
                               else self.pool.alloc(grow))
            if not short:
                return
            occupied = [(i, r) for i, r in enumerate(self._slots)
                        if r is not None]
            victim = max(occupied, key=lambda ir: ir[1].admit_seq)
            self._preempt(victim[0])

    def _finished(self, r):
        """True when a request has nothing left to generate: max_new
        reached (or the brownout ``max_new_cap``, while it is set), or its
        newest token is eos. Retire, the decode tick's live filter and the
        disaggregated handoff all ask this."""
        limit = self.max_new_tokens
        if self.max_new_cap is not None:
            limit = min(limit, self.max_new_cap)
        return (len(r.generated) >= limit
                or (self.eos is not None and bool(r.generated)
                    and r.generated[-1] == self.eos))

    def _retire(self, req: _Request):
        _REQ_LATENCY.observe(time.perf_counter() - req.submit_t)
        self._release_pages(req, register=True)
        with _trace.span("detokenize", attrs={"rid": req.rid},
                         cat="serve"):
            out = req.prompt + req.generated
        _trace.async_end("request", req.rid,
                         {"generated_tokens": len(req.generated)})
        return out

    @torch.inference_mode()
    def step(self):
        """Sweep deadlines, retire, admit, one chunk pass and one batched
        decode tick: speculative when a draft model is attached, every live
        request is greedy and ``spec_paused`` is off, else the plain tick
        (after which the draft catches up on the carry tokens). Returns
        {rid: full_ids} for requests finishing THIS tick."""
        newly = {}
        # deadlines first: an expired request must not hold a slot or
        # pages for one more tick
        self._sweep_deadlines()
        # retire next: a finishing slot frees pages and a slot for this
        # very tick's admissions
        for i, r in enumerate(list(self._slots)):
            if r is not None and self._finished(r):
                newly[r.rid] = self._retire(r)
                self._slots[i] = None
        with _trace.span("admission", cat="serve"):
            self._admit()
        if self.prefill_chunk is not None:
            with _trace.span("prefill_tick", cat="serve"):
                self._prefill_tick()
        self._grow_pages()
        # a request that finished at prefill completion this tick must not
        # decode once more
        live = ([] if self.prefill_only else
                [(i, r) for i, r in enumerate(self._slots)
                 if r is not None and r.generated and r.length > 0
                 and not self._finished(r)])
        if _TELEMETRY_REG.enabled:
            # host state only: the pool's free list and the queues
            _STEPS.inc()
            _QUEUE_DEPTH.set(len(self._waiting))
            _SLOTS_OCCUPIED.set(sum(1 for s in self._slots if s is not None))
            _KV_UTIL.set(1.0 - self.pool.available / self.pool.num_pages)
            _INT8_KV.set(1.0 if self.int8_kv else 0.0)
            if live:
                _BATCH_OCCUPANCY.observe(len(live) / self.max_slots)
        if not live:
            return newly
        do_sample = any(r.temperature > 0.0 for _, r in live)
        if self._draft is not None and not do_sample and not self.spec_paused:
            self._spec_tick(live)
            return newly
        if self._draft is not None:
            _SPEC_TICKS.inc(labels=("fallback",))
        # fixed-width batch: pad with the first live row's state (its
        # results are discarded; its KV write repeats the same values)
        rows = [r for _, r in live] + [live[0][1]] * (
            self.max_slots - len(live))
        args = self._inputs(
            np.asarray([r.generated[-1] for r in rows], np.int32),
            np.asarray([r.length for r in rows], np.int32),
            self._table_rows(rows))
        with _trace.span("decode_tick", attrs={"live": len(live)},
                         cat="serve"):
            lg = self._tick(args)
            if do_sample:
                nxt = _sample_rows(
                    lg,
                    self._tensor([r.temperature for r in rows],
                                 torch.float32),
                    self._tensor([r.top_k for r in rows], torch.long),
                    self._tensor([r.top_p for r in rows], torch.float32),
                    self._gen)
            else:
                nxt = lg.argmax(-1)
            # the read-back is the tick's sync point: inside the span, so
            # its wall covers the device work
            nxt = nxt.cpu().numpy()
        if self._draft is not None:
            # write the draft's KV row for each carry token (its proposal
            # is discarded), so the draft cache has no hole once greedy
            # ticks resume
            self._draft.catch_up(*args[:3])
        self.decode_ticks += 1
        self._note_int8_tokens(len(live))
        for j, (_, r) in enumerate(live):
            r.length += 1
            self._emit(r, int(nxt[j]))
        return newly

    def _spec_tick(self, live):
        """The speculative tick: the draft proposes K greedy tokens a live
        row, the target verifies them in ONE forward, and the longest draft
        prefix equal to the target's own tokens is emitted with the
        target's next token: 1..K+1 tokens a row, each the token plain
        greedy decode gives (clipped at eos and at ``max_new_tokens``)."""
        K = self.spec_tokens
        rows = [r for _, r in live] + [live[0][1]] * (
            self.max_slots - len(live))
        lens = np.asarray([r.length for r in rows], np.int32)

        def ctx_tok(r, i):
            # context token i without building prompt + generated
            n = len(r.prompt)
            return r.prompt[i] if i < n else r.generated[i - n]

        # context[length] is the carry token (generated[-1]); context
        # [length - 1] re-primes the draft's previous position, a rewrite of
        # the same value except after a fully accepted window, where it
        # fills the row of the token the draft proposed but never consumed
        prev = np.asarray([ctx_tok(r, int(n) - 1) for r, n in zip(rows, lens)],
                          np.int32)
        cur = np.asarray([ctx_tok(r, int(n)) for r, n in zip(rows, lens)],
                         np.int32)
        d_toks, t_np = self._spec_outputs(prev, cur, lens,
                                          self._table_rows(rows), len(live))
        accepted_total = 0
        for j, (_, r) in enumerate(live):
            drafts, targets = d_toks[j], t_np[j]
            m = 0
            while m < K and int(drafts[m]) == int(targets[m]):
                m += 1
            accepted_total += m
            out = []
            for t in [int(x) for x in drafts[:m]] + [int(targets[m])]:
                out.append(t)
                if self.eos is not None and t == self.eos:
                    break
                if len(r.generated) + len(out) >= self.max_new_tokens:
                    break
            r.length += len(out)
            for t in out:
                self._emit(r, t)
        self.spec_ticks += 1
        self._note_int8_tokens((K + 1) * len(live))
        self.spec_draft_tokens += K * len(live)
        self.spec_accepted_tokens += accepted_total
        if _TELEMETRY_REG.enabled:
            _SPEC_TICKS.inc(labels=("spec",))
            _SPEC_DRAFTED.inc(K * len(live))
            _SPEC_ACCEPTED.inc(accepted_total)
        _trace.instant("spec_accept", {"accepted": accepted_total,
                                       "drafted": K * len(live)},
                       cat="serve")

    @property
    def spec_acceptance_rate(self):
        """Fraction of drafted tokens the target verify accepted."""
        return self.spec_accepted_tokens / max(1, self.spec_draft_tokens)

    def _table_rows(self, rows):
        """Fixed-shape [B, pages_per_seq] int32 page tables (zero-padded;
        the kernel clamps and length-masks padded entries)."""
        table = np.zeros((len(rows), self.pages_per_seq), np.int32)
        for j, r in enumerate(rows):
            own = r.pages[: self.pages_per_seq]
            table[j, :len(own)] = own
        return table

    def run_until_complete(self, max_ticks=10000):
        done = {}
        for _ in range(max_ticks):
            done.update(self.step())
            if not self._waiting and all(s is None for s in self._slots):
                return done
        raise TimeoutError("serving loop did not drain")

    @torch.inference_mode()
    def warmup(self, sample=False):
        """Build what the engine's ticks run, on dummy operands, and record
        the wall time in ``self.build_seconds`` (returned). On the card
        that is the kernels and the decode graphs (each one's eager pass
        and capture, or a replay once captured): the tick's, and under a
        draft model the draft's catch-up, its proposal and the verify; the
        CPU times one eager pass of each. With chunked prefill one chunk
        pass runs too, and ``sample=True`` runs the sampler once on a
        generator of its own. A prefill-only engine builds only its
        prefill. Every table entry is the scratch page, so every write
        lands in the scratch page."""
        t0 = time.perf_counter()
        b = self.max_slots
        zeros = np.zeros(b, np.int32)
        trash = np.full((b, self.pages_per_seq), self._trash_page, np.int32)
        if not self.prefill_only:
            args = self._inputs(zeros, zeros, trash)
            lg = self._tick(args)
            if sample:
                gen = torch.Generator(device=self.device)
                ones = torch.ones(b, device=self.device)
                _sample_rows(lg, ones,
                             torch.zeros_like(ones, dtype=torch.long), ones,
                             gen)
            lg.cpu()
            if self._draft is not None:
                self._draft.catch_up(*args[:3])
                # the re-prime writes position lens - 1: lens of 1
                self._spec_outputs(zeros, zeros, np.ones(b, np.int32), trash)
        if self.prefill_chunk is not None:
            B, c = self.max_slots, self.prefill_chunk
            zeros_t = lambda *s: torch.zeros(  # noqa: E731
                s, dtype=torch.long, device=self.device)
            trash_t = lambda *s: torch.full(  # noqa: E731
                s, self._trash_page, dtype=torch.long, device=self.device)
            self._prefill_chunk_step(zeros_t(B, c), zeros_t(B), zeros_t(B),
                                     trash_t(B, c), zeros_t(B, c),
                                     trash_t(B, self.pages_per_seq)).cpu()
        self.build_seconds = time.perf_counter() - t0
        return self.build_seconds

    # -- fleet surface (router, disaggregated serving, drain) ---------------
    def load(self):
        """Live load signals for an admission router: queue depth, slot
        occupancy, KV headroom and the resident decode weights' bytes by
        dtype."""
        occupied = sum(1 for s in self._slots if s is not None)
        return {
            "queue_depth": len(self._waiting),
            "occupied_slots": occupied,
            "free_slots": self.max_slots - occupied,
            "kv_free_fraction": self.pool.available / self.pool.num_pages,
            "int8_weights": self.int8_weights,
            "weight_bytes": self.weight_bytes,
        }

    def prefix_match_pages(self, tokens):
        """How many full KV pages of this prompt's prefix the prefix cache
        already holds (0 with the cache off; nothing is pinned)."""
        return len(self._match_prefix([int(t) for t in tokens]))

    def extract(self, slot_idx):
        """The disaggregation seam: snapshot a slot's KV pages and resume
        state to the host as a swap-out does, release the slot and its
        pages (completed prefix pages register into this engine's prefix
        cache) and return the request for another engine's ``inject``.
        Works under either preempt policy; exact caches move their values
        and int8 caches their codes and scales, unchanged."""
        r = self._slots[slot_idx]
        if r is None:
            raise ValueError(f"slot {slot_idx} is empty")
        self._snapshot_to_host(r)
        self._release_pages(r, register=True)
        self._slots[slot_idx] = None
        return r

    def inject(self, req):
        """Queue a request extracted from another engine; its snapshot
        restores through the swap re-admission. Both engines share the
        page geometry and the KV mode (``fleet.disagg`` checks)."""
        self._next_rid = max(self._next_rid, req.rid + 1)
        self._waiting.append(req)

    def export_prefix_pages(self, max_pages=None):
        """The prefix cache's entries as ``{"key", "k", "v"}`` dicts (chain
        digest and the page's host KV, [L, Hkv, 1, page, D] per cache
        leaf), in insertion order so every chain ships head first.
        ``max_pages`` caps the count; a chain cut short imports as a valid
        shorter prefix."""
        if not self.enable_prefix_cache:
            return []
        keys = list(self._prefix_cache)
        if max_pages is not None:
            keys = keys[: int(max_pages)]
        entries = []
        for start in range(0, len(keys), self.pages_per_seq):
            chunk = keys[start: start + self.pages_per_seq]
            k, v = self._swap_gather([self._prefix_cache[x] for x in chunk])
            for i, key in enumerate(chunk):
                cut = lambda c, i=i: c[:, :, i: i + 1].clone()  # noqa: E731
                entries.append({"key": bytes(key), "k": _kv_map(cut, k),
                                "v": _kv_map(cut, v)})
        self.prefix_pages_exported += len(entries)
        return entries

    def import_prefix_pages(self, entries):
        """Install exported prefix pages: each takes a free page, its KV is
        copied in, and its key maps to the page at refcount 0 (cached,
        evictable like any cached page). Known keys are skipped; import
        evicts nothing and stops when the pool is empty. Returns the
        number of pages imported."""
        if not self.enable_prefix_cache:
            return 0
        n = 0
        for e in entries:
            key = bytes(e["key"])
            if key in self._prefix_cache:
                continue
            if self.pool.available == 0:
                break
            pg = self.pool.alloc(1)[0]
            self._swap_scatter([pg], *self._swap_stage(e))
            self._prefix_cache[key] = pg
            self._cached_pages.add(pg)
            self._page_ref[pg] = 0
            n += 1
        self.prefix_pages_imported += n
        return n
