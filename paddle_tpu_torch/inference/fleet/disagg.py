"""Disaggregated prefill/decode serving.

Counterpart of ``paddle_tpu/inference/fleet/disagg.py``. Long prompts
stall decode ticks: a chunked-prefill pass shares the tick with decode, so
every running request's gap between tokens absorbs the prefill. Here the
work splits onto two engines:

- the prefill worker (``prefill_only=True``) admits requests, runs chunked
  prefill, takes the first token and owns the prefix cache;
- the decode worker receives finished prefills over an explicit seam and
  runs decode ticks (speculative ones when a draft model is attached).

The seam is ``ContinuousBatchingEngine.extract()`` -> ``inject()``: the KV
pages and resume state move as a host snapshot (the swap-out machinery),
and the decode worker's swap-restore admission copies them into its own
pages. Exact caches move their values and int8 caches their codes and
scales, unchanged, so greedy disaggregated output equals the single
engine's. ``handoffs`` and ``handoff_bytes`` count the transfers, and
each handoff is traced as a per-request ``handoff`` mark and counted with
its payload bytes in ``serving_handoffs_total`` and
``serving_handoff_bytes_total``, as the reference does.
"""
from __future__ import annotations

from ... import telemetry as _telemetry
from ...telemetry import trace as _trace
from ..serving import ContinuousBatchingEngine, _kv_nbytes

__all__ = ["DisaggregatedEngine"]

_HANDOFFS = _telemetry.counter(
    "serving_handoffs_total",
    "prefill->decode KV transfers (docs/SERVING.md)")
_HANDOFF_BYTES = _telemetry.counter(
    "serving_handoff_bytes_total",
    "KV snapshot bytes crossing the prefill->decode seam")


class DisaggregatedEngine:
    """Same surface as ContinuousBatchingEngine (submit, step, cancel,
    run_until_complete, load, prefix_match_pages, warmup), backed by a
    prefill worker and a decode worker on ``device``."""

    def __init__(self, model, prefill_slots=2, decode_slots=4,
                 page_size=64, max_seq_len=None, max_new_tokens=32,
                 eos_token_id=None, seed=0, prefill_chunk=32,
                 prefill_pages=None, decode_pages=None,
                 enable_prefix_cache=False, int8_kv=False,
                 draft_model=None, spec_tokens=4, rid_base=0, device=None):
        if prefill_chunk is None:
            raise ValueError("disaggregated prefill requires chunked "
                             "prefill (prefill_chunk=...)")
        # the prefill half: admissions, chunked prefill, the prefix cache;
        # it never decodes, so its pool only ever holds prompt pages
        self.prefill = ContinuousBatchingEngine(
            model, max_slots=prefill_slots, page_size=page_size,
            num_pages=prefill_pages, max_seq_len=max_seq_len,
            max_new_tokens=max_new_tokens, eos_token_id=eos_token_id,
            seed=seed, prefill_chunk=prefill_chunk,
            enable_prefix_cache=enable_prefix_cache, int8_kv=int8_kv,
            prefill_only=True, rid_base=rid_base, device=device)
        # the decode half: restores handed-off snapshots and decodes; it
        # keeps chunked prefill for recompute resumes after a preemption
        self.decode = ContinuousBatchingEngine(
            model, max_slots=decode_slots, page_size=page_size,
            num_pages=decode_pages, max_seq_len=max_seq_len,
            max_new_tokens=max_new_tokens, eos_token_id=eos_token_id,
            seed=seed, prefill_chunk=prefill_chunk, int8_kv=int8_kv,
            draft_model=draft_model, spec_tokens=spec_tokens,
            rid_base=rid_base, device=device)
        if self.prefill.int8_kv != self.decode.int8_kv:
            raise RuntimeError("prefill and decode workers resolved "
                               "different KV modes: the handoff moves raw "
                               "pages and needs one format")
        self.max_slots = decode_slots      # router capacity signal
        self.handoffs = 0
        self.handoff_bytes = 0
        self.build_seconds = None
        self._cancelled = {}

    # -- engine surface -----------------------------------------------------
    def submit(self, prompt_ids, **kwargs):
        """Queue a request on the prefill worker, after the decode worker's
        feasibility checks: a handed-off request skips its submit(), and
        one its pool can never hold would block its queue for good."""
        total = len(prompt_ids) + self.decode.max_new_tokens
        spec = self.decode._draft is not None
        if spec and total + self.decode.spec_tokens > self.decode.max_seq:
            raise ValueError(
                f"request needs {total} tokens + {self.decode.spec_tokens} "
                f"spec headroom > max_seq_len {self.decode.max_seq}")
        page = self.decode.page
        spec_pad = self.decode.spec_tokens if spec else 0
        need = (total + spec_pad + page - 1) // page
        if need > self.decode.pool.num_pages:
            raise ValueError(
                f"request needs {need} pages > decode worker pool size "
                f"{self.decode.pool.num_pages}")
        return self.prefill.submit(prompt_ids, **kwargs)

    def cancel(self, rid, reason="user"):
        return (self.prefill.cancel(rid, reason=reason)
                or self.decode.cancel(rid, reason=reason))

    @property
    def cancelled(self):
        """One persistent cancellation dict: the halves' dicts drain into
        it, so a caller popping entries here changes real state."""
        for src in (self.prefill.cancelled, self.decode.cancelled):
            while src:
                rid, reason = src.popitem()
                self._cancelled[rid] = reason
        return self._cancelled

    def prefix_match_pages(self, tokens):
        return self.prefill.prefix_match_pages(tokens)

    def load(self):
        """Router signal: the queue spans both halves (a request waiting
        anywhere delays its first token); the slots are the decode
        worker's (the throughput bound)."""
        p, d = self.prefill.load(), self.decode.load()
        return {
            "queue_depth": (p["queue_depth"] + p["occupied_slots"]
                            + d["queue_depth"]),
            "occupied_slots": d["occupied_slots"],
            "free_slots": d["free_slots"],
            "kv_free_fraction": min(p["kv_free_fraction"],
                                    d["kv_free_fraction"]),
        }

    def _handoff(self):
        """Move every finished prefill to the decode worker: extract on
        the prefill side (its prefix pages stay in its cache), inject on
        the decode side."""
        eng = self.prefill
        for i, r in enumerate(list(eng._slots)):
            if (r is None or not r.generated
                    or r.prefill_pos < len(r.seq_tokens)):
                continue
            if eng._finished(r):
                # complete at its first token: the prefill worker retires
                # it, and step() returns it with the decode worker's
                continue
            req = eng.extract(i)
            size = (_kv_nbytes(req.swapped["k"])
                    + _kv_nbytes(req.swapped["v"]))
            self.handoffs += 1
            self.handoff_bytes += size
            _HANDOFFS.inc()
            _HANDOFF_BYTES.inc(size)
            _trace.async_instant("handoff", req.rid,
                                 {"pages": req.swapped["n"], "bytes": size})
            self.decode.inject(req)

    def step(self):
        """One disaggregated tick: the prefill worker's step, the handoff
        sweep, the decode worker's step. Returns the completions of both
        workers (a request complete at its first token never crosses)."""
        done = self.prefill.step()
        self._handoff()
        out = self.decode.step()
        out.update(done)
        return out

    def run_until_complete(self, max_ticks=10000):
        done = {}
        for _ in range(max_ticks):
            done.update(self.step())
            if (not self.prefill._waiting and not self.decode._waiting
                    and all(s is None for s in self.prefill._slots)
                    and all(s is None for s in self.decode._slots)):
                return done
        raise TimeoutError("disaggregated serving loop did not drain")

    def warmup(self, sample=False):
        b = self.prefill.warmup(sample=sample)
        b += self.decode.warmup(sample=sample)
        self.build_seconds = b
        return b
