"""Draft-model speculative decoding for the serving engine.

Counterpart of ``paddle_tpu/inference/fleet/spec_decode.py``. The decode
tick is bound by reading the weights: one pass gives one token a sequence.
A small draft model proposes K tokens, and the target verifies them all in
ONE forward (``ContinuousBatchingEngine._verify_step``); the target emits
the longest draft prefix equal to its own greedy tokens and its next
token, so one target pass gives 1..K+1 tokens.

Every emitted token is the token plain greedy decode gives: the verify
runs the same row-local projections (at the tick's GEMM row count, see
``serving.DECODE_GEMM_ROWS``) and the same per-position paged attention as
a plain tick; the draft only decides WHICH positions are accepted.
Sampled requests fall back to the plain tick.

The draft rides the TARGET's page tables: its KV lives in a cache of its
own, ``[Ld, Hkv_d, num_pages + 1, page, D_d]``, always exact, addressed by
the same page ids, so there is no second allocator. Draft KV is built at
the target's prefill completion and at decode-phase snapshot restores
(handoffs, swap-ins); each spec tick re-primes position ``length - 1``
before proposing, which fills the one-token hole a fully accepted window
leaves and otherwise rewrites the same values.

On the card the proposal (a C = 2 window, then K - 1 windows of one token,
each window's argmax feeding the next on the device) is one CUDA graph
and the catch-up after a fallback tick another, both over the engine's
static input buffer.
"""
from __future__ import annotations

import torch

from ..serving import _capture, _DecoderStack, _pack_weights

__all__ = ["DraftRunner"]


class DraftRunner(_DecoderStack):
    """The draft model's packed weights (exact; a self-draft packs views of
    the target's parameters, no copy), its paged KV cache and its
    proposal, prefill and catch-up for one engine."""

    def __init__(self, engine, draft_model):
        cfg = draft_model.config
        if cfg.vocab_size != engine.cfg.vocab_size:
            raise ValueError(
                f"draft vocab {cfg.vocab_size} != target vocab "
                f"{engine.cfg.vocab_size}: speculative decoding needs a "
                "shared tokenizer")
        core = draft_model.model if hasattr(draft_model, "model") \
            else draft_model
        wdev = core.embed_tokens.weight.device
        if wdev.type != engine.device.type:
            raise ValueError(f"engine device {engine.device} but the draft "
                             f"model's weights are on {wdev}")
        self.engine = engine
        self.cfg = cfg
        self.hd = cfg.hidden_size // cfg.num_heads
        self.hkv = cfg.num_kv_heads
        self.device = engine.device
        self.page = engine.page
        self.pages_per_seq = engine.pages_per_seq
        self._rows = engine._rows
        self._weights = _pack_weights(draft_model)
        shape = (cfg.num_layers, self.hkv, engine.pool.num_pages + 1,
                 engine.page, self.hd)
        dt = self._weights["embed"].dtype
        self.kc = torch.zeros(shape, dtype=dt, device=self.device)
        self.vc = torch.zeros(shape, dtype=dt, device=self.device)
        self._propose_graph = self._propose_out = None
        self._catch_graph = None
        self.prefills = 0             # requests whose draft KV was built
        self.prefill_batches = 0      # group passes that built it

    def _window_step(self, toks, pos0, tables):
        """Draft forward over a C-token window at positions pos0 .. pos0 +
        C - 1: writes draft KV for every window row and returns the greedy
        next token after the LAST position [B]. C = 1 is one decode step;
        C = 2 re-primes the previous position first."""
        B, C = toks.shape
        h = self._window_hidden(toks, pos0, tables)
        return self._logits(h)[(C - 1) * B:C * B].float().argmax(-1)

    def _propose(self, prev, cur, lens, tables):
        """K greedy draft tokens a row [B, K]: one C = 2 window ([prev at
        lens - 1, cur at lens], the re-prime), then K - 1 windows of one
        token, each fed the previous window's token on the device."""
        d = self._window_step(torch.stack([prev, cur], 1), lens - 1, tables)
        out = [d]
        for j in range(1, self.engine.spec_tokens):
            d = self._window_step(d[:, None], lens + j, tables)
            out.append(d)
        return torch.stack(out, 1)

    def propose(self, prev, cur, lens, tables):
        """The proposal [B, K] on the device, no read-back. On the card the
        arguments are the engine's static views and the result is the
        proposal graph's output buffer (the first call runs eagerly and
        captures the graph)."""
        if self.device.type != "cuda":
            return self._propose(prev, cur, lens, tables)
        if self._propose_graph is None:
            self._propose_graph, self._propose_out, d = _capture(
                lambda: self._propose(prev, cur, lens, tables), self.device)
            self._propose_out.copy_(d)
        else:
            self._propose_graph.replay()
        return self._propose_out

    @torch.inference_mode()
    def prefill(self, reqs, tokens_list):
        """Write draft KV for whole token prefixes into the requests' pages
        as ONE padded batch: the engine's group prefill, op for op, so a
        draft of the target's own architecture holds the target's KV when
        the target prefilled the same group."""
        self._group_pass([r.pages for r in reqs], tokens_list)
        self.prefills += len(reqs)
        self.prefill_batches += 1

    def catch_up(self, tokens, lens, tables):
        """Write the draft's KV row for a plain (fallback) tick's carry
        tokens at positions ``lens``; the proposal is discarded. Keeps the
        draft cache continuous across sampled ticks. On the card one
        replay of its graph over the engine's static views."""
        if self.device.type != "cuda":
            self._window_step(tokens[:, None], lens, tables)
        elif self._catch_graph is None:
            self._catch_graph, _, _ = _capture(
                lambda: self._window_step(tokens[:, None], lens, tables),
                self.device)
        else:
            self._catch_graph.replay()
