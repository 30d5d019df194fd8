"""Continuous-batching LLM serving over paged KV caches, in PyTorch.

Counterpart of ``paddle_tpu/inference/serving.py`` (exact-KV mode):

- KV lives in pages: one cache per K and V, ``[L, Hkv, num_pages + 1,
  page_size, D]``, whose per-layer slices are the layout the paged
  attention kernel reads. The last page is a non-allocable scratch page
  that padded prefill rows write to. A ``PagePool`` hands pages to
  sequences on admission and as they grow, and takes them back on
  completion.
- ``ContinuousBatchingEngine`` admits waiting requests into free slots
  (group prefill, or chunked prefill of ``prefill_chunk`` tokens per tick)
  and runs one batched decode tick for every live slot per ``step()``.
  Decode attention is the hand-written CUDA kernel
  (``ops.kernels.decode_attention.paged_attention``); every RMS norm is the
  Triton kernel. Prefill attention is plain PyTorch (matmul, masked f32
  softmax, matmul).
- On pool exhaustion the youngest request is preempted and recomputed:
  its tokens fold into the resume prompt.

Unlike the JAX package, which donates its caches to functional updates,
the KV writes here happen in place. Layers run as a Python loop (no scan).
Int8 KV and weights, swap preemption, the prefix cache, deadlines and
cancellation, speculative decoding, disaggregation and the brownout caps
are not ported yet.
"""
from __future__ import annotations

from collections import deque

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models.gpt import _attention_plain, _rms_pure, _rope_at_positions
from ..ops.kernels.decode_attention import paged_attention

__all__ = ["PagePool", "ContinuousBatchingEngine"]

_DECODE_WEIGHT_NAMES = ("ln1", "wq", "wk", "wv", "wo", "ln2", "wg", "wu",
                        "wd")


# ------------------------------------------------------- KV cache helpers
def _kv_write(cache_l, pages, offs, vals):
    """Scatter token rows into a PER-LAYER cache [Hkv, P, page, D], in
    place: ``pages``/``offs`` index tensors of one shape S*, ``vals``
    [Hkv, *S, D]."""
    cache_l[:, pages, offs, :] = vals.to(cache_l.dtype)


def _kv_write_layer(cache, li, pages, offs, vals):
    """``_kv_write`` against layer ``li`` of a stacked cache. ``vals`` is
    [Hkv, N, D]; the JAX package's advanced-index payload is [N, Hkv, D]
    and lands in the same cells."""
    _kv_write(cache[li], pages, offs, vals)


def _kv_gather_rows(cache_l, idx):
    """Pages by id from a PER-LAYER cache: [Hkv, *idx.shape, page, D]."""
    return cache_l[:, idx.long()]


def _pack_weights(model):
    """Decode weight tree {"layers": [9-tuple per layer], "embed", "fnorm",
    "head"} in ``_DECODE_WEIGHT_NAMES`` order. Counterpart of the JAX
    package's ``_pack_weights_stacked``: the Python layer loop needs no
    stacked copy, so the tree references the model's parameters."""
    core = model.model
    head = getattr(model, "lm_head", None)
    layers = [tuple(p[n] for n in _DECODE_WEIGHT_NAMES)
              for p in model._decode_params()]
    return {"layers": layers,
            "embed": core.embed_tokens.weight,
            "fnorm": core.final_norm.weight,
            "head": head.weight if head is not None else None}


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
                 "seq_tokens", "admit_seq")

    def __init__(self, rid, prompt, temperature=0.0, top_k=0, top_p=1.0,
                 on_token=None):
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
        # after a preemption, prompt + generated-so-far
        self.seq_tokens = self.prompt
        self.admit_seq = -1      # admission order (victims: youngest)


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


class ContinuousBatchingEngine:
    """Paged-KV continuous batcher over a ``LlamaForCausalLM``.

    ``device`` defaults to CUDA and must be where the model's weights are;
    ``device="cpu"`` runs the kernels' plain versions."""

    def __init__(self, model, max_slots=4, page_size=64, num_pages=None,
                 max_seq_len=None, max_new_tokens=32, eos_token_id=None,
                 seed=0, prefill_chunk=None, preempt_policy="recompute",
                 device=None):
        self.device = resolve_device(device)
        wdev = model.model.embed_tokens.weight.device
        if wdev.type != self.device.type:
            raise ValueError(f"engine device {self.device} but the model's "
                             f"weights are on {wdev}")
        if preempt_policy != "recompute":
            raise NotImplementedError(
                "only preempt_policy='recompute' is ported")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
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

        self._weights = _pack_weights(model)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        dt = self._weights["embed"].dtype
        cache_shape = (cfg.num_layers, self.hkv, num_pages + 1, page_size,
                       self.hd)
        self.kc = torch.zeros(cache_shape, dtype=dt, device=self.device)
        self.vc = torch.zeros(cache_shape, dtype=dt, device=self.device)

        self._slots: list[_Request | None] = [None] * max_slots
        self._waiting: deque[_Request] = deque()
        self._next_rid = 0
        self._admit_counter = 0
        self.prefill_batches = 0      # admission groups (group prefill)
        self.prefill_chunk_steps = 0  # batched chunk passes
        self.decode_ticks = 0
        self.preemptions = 0

    def _tensor(self, values, dtype):
        return torch.as_tensor(np.asarray(values), dtype=dtype,
                               device=self.device)

    # -- model math ---------------------------------------------------------
    def _layer_forward(self, li, lp, x, pos0, attend):
        """One decoder layer: projections + rope + ``attend(li, q, k, v)``
        (which owns the cache writes and the attention) + MLP. Shared by
        the prefill paths and decode."""
        ln1, wq, wk, wv, wo, ln2, wg, wu, wd = lp
        B, S = x.shape[:2]
        h = _rms_pure(x, ln1)
        q = F.linear(h, wq).reshape(B, S, self.cfg.num_heads, self.hd)
        k = F.linear(h, wk).reshape(B, S, self.hkv, self.hd)
        v = F.linear(h, wv).reshape(B, S, self.hkv, self.hd)
        q, k = _rope_at_positions(q, pos0), _rope_at_positions(k, pos0)
        o = attend(li, q, k, v)                       # [B, S, Hq, D]
        x = x + F.linear(o.reshape(B, S, -1), wo)
        h2 = _rms_pure(x, ln2)
        return x + F.linear(F.silu(F.linear(h2, wg)) * F.linear(h2, wu), wd)

    def _logits(self, x):
        w = self._weights
        return F.linear(x, w["head"] if w["head"] is not None
                        else w["embed"])

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
        w = self._weights
        dev = self.device
        B = len(reqs)
        lens = np.asarray([len(r.seq_tokens) for r in reqs])
        S = int(lens.max())
        ids_np = np.zeros((B, S), np.int64)
        for i, r in enumerate(reqs):
            ids_np[i, : lens[i]] = r.seq_tokens
        x = w["embed"][self._tensor(ids_np, torch.long)]     # [B, S, H]
        pos0 = torch.zeros(B, dtype=torch.long, device=dev)
        mask = torch.ones(S, S, dtype=torch.bool, device=dev).tril()

        # flattened valid (row, pos) pairs -> page/offset scatter targets
        rows = self._tensor(
            np.concatenate([np.full(l, i) for i, l in enumerate(lens)]),
            torch.long)
        poss_np = np.concatenate([np.arange(l) for l in lens])
        poss = self._tensor(poss_np, torch.long)
        tok_pages = self._tensor(np.concatenate(
            [np.asarray(r.pages, np.int64)[np.arange(l) // self.page]
             for r, l in zip(reqs, lens)]), torch.long)
        offs = self._tensor(poss_np % self.page, torch.long)

        def attend(li, q, k, v):
            o = _attention_plain(q, k, v, mask)
            _kv_write_layer(self.kc, li, tok_pages, offs,
                            k[rows, poss].transpose(0, 1))
            _kv_write_layer(self.vc, li, tok_pages, offs,
                            v[rows, poss].transpose(0, 1))
            return o

        for li, lp in enumerate(w["layers"]):
            x = self._layer_forward(li, lp, x, pos0, attend)
        x = _rms_pure(x, w["fnorm"])
        last = x[torch.arange(B, device=dev),
                 self._tensor(lens - 1, torch.long)]          # [B, H]
        toks = self._head_tokens(last, reqs)
        for i, r in enumerate(reqs):
            r.length = int(lens[i])
            r.prefill_pos = int(lens[i])
        return toks

    def _paged_attend(self, q, kc_l, vc_l, tables, lens):
        """Single-position paged attention over a PER-LAYER cache:
        q [B, Hq, D] -> [B, Hq, D], through the paged attention kernel."""
        return paged_attention(q.contiguous(), kc_l, vc_l, tables, lens)

    def _decode_layer(self, li, lp, x, lens, tables, page_ids, offs,
                      kv_lens):
        """One decoder layer of the batched decode tick: write this
        token's KV row in place, paged-attend, MLP."""

        def attend(li, q, k, v):
            _kv_write(self.kc[li], page_ids, offs, k[:, 0].transpose(0, 1))
            _kv_write(self.vc[li], page_ids, offs, v[:, 0].transpose(0, 1))
            o = self._paged_attend(q[:, 0], self.kc[li], self.vc[li],
                                   tables, kv_lens)
            return o[:, None]                         # [B, 1, Hq, D]

        return self._layer_forward(li, lp, x, lens, attend)

    def _decode_step(self, tokens, lens, tables, temps, top_ks, top_ps,
                     do_sample=False):
        """ONE batched decode: tokens [B] (last emitted), lens [B] tokens
        already cached, tables [B, pages_per_seq] int32. Returns next [B].
        The kernel sees ``lens + 1`` valid rows: the current token's row is
        written first."""
        w = self._weights
        b = tokens.shape[0]
        x = w["embed"][tokens][:, None]                      # [B, 1, H]
        page_ids = tables.long()[torch.arange(b, device=self.device),
                                 lens // self.page]
        offs = lens % self.page
        kv_lens = (lens + 1).to(torch.int32)
        for li, lp in enumerate(w["layers"]):
            x = self._decode_layer(li, lp, x, lens, tables, page_ids, offs,
                                   kv_lens)
        x = _rms_pure(x, w["fnorm"])[:, 0]
        lg = self._logits(x)
        if do_sample:
            return _sample_rows(lg, temps, top_ks, top_ps, self._gen)
        return lg.float().argmax(-1)

    # -- engine surface -----------------------------------------------------
    def submit(self, prompt_ids, temperature=0.0, top_k=0, top_p=1.0,
               on_token=None) -> int:
        """Queue a request. ``temperature=0`` decodes greedily; otherwise
        softmax sampling with optional top_k / top_p truncation.
        ``on_token(rid, token_id)`` streams each generated token."""
        if len(prompt_ids) == 0:
            raise ValueError("empty prompt: a request needs at least one "
                             "token to prefill")
        total = len(prompt_ids) + self.max_new_tokens
        if total > self.max_seq:
            raise ValueError(
                f"request needs {total} tokens (prompt {len(prompt_ids)} + "
                f"max_new {self.max_new_tokens}) > max_seq_len "
                f"{self.max_seq}")
        need = (total + self.page - 1) // self.page
        if need > self.pool.num_pages:
            raise ValueError(f"request needs {need} pages > pool size "
                             f"{self.pool.num_pages}")
        rid = self._next_rid
        self._next_rid += 1
        self._waiting.append(_Request(
            rid, [int(t) for t in prompt_ids], temperature, top_k, top_p,
            on_token))
        return rid

    def _emit(self, req, tok):
        req.generated.append(tok)
        if req.on_token is not None:
            req.on_token(req.rid, tok)

    def _admit(self):
        group = []
        for i in range(self.max_slots):
            if self._slots[i] is not None or not self._waiting:
                continue
            req = self._waiting[0]
            # reserve only what prefill writes; decode pages are allocated
            # as the sequence grows
            need = (len(req.seq_tokens) + self.page - 1) // self.page
            if need > self.pool.available:
                break  # head-of-line waits for pages
            self._waiting.popleft()
            req.pages = self.pool.alloc(need)
            req.admit_seq = self._admit_counter
            self._admit_counter += 1
            self._slots[i] = req
            group.append(req)
        if group and self.prefill_chunk is None:
            for req, tok in zip(group, self._prefill_group(group)):
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
            # write the chunk's kv FIRST, then gather the prefix back
            _kv_write(self.kc[li], tp, of,
                      k.reshape(B * c, self.hkv, self.hd).transpose(0, 1))
            _kv_write(self.vc[li], tp, of,
                      v.reshape(B * c, self.hkv, self.hd).transpose(0, 1))
            ck = _kv_gather_rows(self.kc[li], hist).reshape(
                self.hkv, B, S, self.hd).permute(1, 2, 0, 3)
            cv = _kv_gather_rows(self.vc[li], hist).reshape(
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
        requests keep decoding every tick while long prompts fill."""
        reqs = [r for r in self._slots
                if r is not None and r.prefill_pos < len(r.seq_tokens)]
        if not reqs:
            return
        B, c = self.max_slots, self.prefill_chunk
        ids_np = np.zeros((B, c), np.int64)
        pos0 = np.zeros(B, np.int64)
        nvalid = np.zeros(B, np.int64)
        tok_pages = np.full((B, c), self._trash_page, np.int64)
        offs = np.zeros((B, c), np.int64)
        hist = np.zeros((B, self.pages_per_seq), np.int64)
        for i, r in enumerate(reqs):
            pos = r.prefill_pos
            n = min(c, len(r.seq_tokens) - pos)
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
        completed = []
        for i, r in enumerate(reqs):
            r.prefill_pos += int(nvalid[i])
            if r.prefill_pos == len(r.seq_tokens):
                completed.append((i, r))
        if completed:
            rows = last[self._tensor([i for i, _ in completed], torch.long)]
            toks = self._head_tokens(rows, [r for _, r in completed])
            for (_, r), tok in zip(completed, toks):
                r.length = len(r.seq_tokens)
                self._emit(r, tok)

    def _preempt(self, slot_idx):
        """Evict a running request and requeue it at the FRONT of the
        waiting queue: free its pages and fold the generated tokens into
        the resume prompt, which re-admission prefills again."""
        r = self._slots[slot_idx]
        self.pool.free(r.pages)
        r.pages = []
        r.seq_tokens = r.prompt + r.generated
        r.prefill_pos = 0
        r.length = 0
        self._slots[slot_idx] = None
        self._waiting.appendleft(r)
        self.preemptions += 1

    def _grow_pages(self):
        """Ensure every decoding slot owns a page for this tick's token. On
        pool exhaustion, preempt the YOUNGEST occupied slot (its oldest
        peers keep their pages and finish first; a lone request always
        fits by the submit() feasibility check)."""
        while True:
            live = sorted(
                ((i, r) for i, r in enumerate(self._slots)
                 if r is not None and r.length > 0),
                key=lambda ir: ir[1].admit_seq)
            short = False
            for i, r in live:
                grow = (r.length + self.page) // self.page - len(r.pages)
                if grow <= 0:
                    continue
                if grow > self.pool.available:
                    short = True
                    break
                r.pages.extend(self.pool.alloc(grow))
            if not short:
                return
            occupied = [(i, r) for i, r in enumerate(self._slots)
                        if r is not None]
            victim = max(occupied, key=lambda ir: ir[1].admit_seq)
            self._preempt(victim[0])

    def _finished(self, r):
        """True when a request has nothing left to generate: max_new
        reached, or its newest token is eos."""
        return (len(r.generated) >= self.max_new_tokens
                or (self.eos is not None and bool(r.generated)
                    and r.generated[-1] == self.eos))

    def _retire(self, req: _Request):
        self.pool.free(req.pages)
        req.pages = []
        return req.prompt + req.generated

    @torch.inference_mode()
    def step(self):
        """Admit + one batched decode tick. Returns {rid: full_ids} for
        requests finishing THIS tick."""
        newly = {}
        # retire first: a finishing slot frees pages and a slot for this
        # very tick's admissions
        for i, r in enumerate(list(self._slots)):
            if r is not None and self._finished(r):
                newly[r.rid] = self._retire(r)
                self._slots[i] = None
        self._admit()
        if self.prefill_chunk is not None:
            self._prefill_tick()
        self._grow_pages()
        # a request that finished at prefill completion this tick must not
        # decode once more
        live = [(i, r) for i, r in enumerate(self._slots)
                if r is not None and r.generated and r.length > 0
                and not self._finished(r)]
        if not live:
            return newly
        do_sample = any(r.temperature > 0.0 for _, r in live)
        # fixed-width batch: pad with the first live row's state (its
        # results are discarded; its KV write repeats the same values)
        rows = [r for _, r in live] + [live[0][1]] * (
            self.max_slots - len(live))
        nxt = self._decode_step(
            self._tensor([r.generated[-1] for r in rows], torch.long),
            self._tensor([r.length for r in rows], torch.long),
            self._table_rows(rows),
            self._tensor([r.temperature for r in rows], torch.float32),
            self._tensor([r.top_k for r in rows], torch.long),
            self._tensor([r.top_p for r in rows], torch.float32),
            do_sample).cpu().numpy()
        self.decode_ticks += 1
        for j, (_, r) in enumerate(live):
            r.length += 1
            self._emit(r, int(nxt[j]))
        return newly

    def _table_rows(self, rows):
        """Fixed-shape [B, pages_per_seq] int32 page tables (zero-padded;
        the kernel clamps and length-masks padded entries)."""
        table = np.zeros((len(rows), self.pages_per_seq), np.int32)
        for j, r in enumerate(rows):
            own = r.pages[: self.pages_per_seq]
            table[j, :len(own)] = own
        return self._tensor(table, torch.int32)

    def run_until_complete(self, max_ticks=10000):
        done = {}
        for _ in range(max_ticks):
            done.update(self.step())
            if not self._waiting and all(s is None for s in self._slots):
                return done
        raise TimeoutError("serving loop did not drain")

    def load(self):
        """Live load signals for an admission router: queue depth, slot
        occupancy and KV headroom."""
        occupied = sum(1 for s in self._slots if s is not None)
        return {
            "queue_depth": len(self._waiting),
            "occupied_slots": occupied,
            "free_slots": self.max_slots - occupied,
            "kv_free_fraction": self.pool.available / self.pool.num_pages,
        }
