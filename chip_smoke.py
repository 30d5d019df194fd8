#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py [--out results.json] [--quick]

Phases, each of which fails the run on error:

1. device  - the card's name and power limit; fails without CUDA.
2. build   - nvcc builds ops/kernels/csrc/*.cu for sm_90a (one nvcc per
             source, in parallel); Triton compiles the rms_norm kernel at
             its first launch.
3. kernels - each kernel against its plain PyTorch version on the card,
             in bf16 and f32, with times (CUDA events, median), the plain
             version's and one library call's time, and the bound.
4. serving - LLaMA-7B width and depth in bf16, random weights from a
             seeded generator, through ContinuousBatchingEngine's submit /
             step / run_until_complete with chunked prefill. Checks every
             request's token count and that the kernels' launch counts are
             32 (paged attention) and 65 (rms norm) per decode tick.
5. consistency - f32, full width, depth 2: the engine's greedy streams
             equal the dense-cache generate token for token.
6. training - GPT-3 1.3B (config 4) at full width and depth in bf16:
             GPTForCausalLMPipe -> chunked-CE loss -> AdamW(factored) ->
             TrainStep, batch 3 x seq 2048, one warm-up and 5 timed steps
             and one profiled step. Checks finite, falling losses that
             start near ln(vocab) and the launch counts per step.
7. training consistency - f32, full width, depth 2: three TrainSteps on
             the card equal the same three on the CPU (plain versions).

The line before the last lists every kernel with its launch counts on the
serving and training runs; the last line is {"ok": true, "device": {...}}.
``--quick`` runs phases 1-3 only, with fewer repetitions, and prints no
result line.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12                    # H100 SXM data sheet
DEVICE = "cuda"
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_ms(fn, reps=15, inner=5):
    """Median over ``reps`` samples of the mean time of ``inner`` calls,
    on CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def bound_ms(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phase 1
def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    smi_line = smi.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} | nvidia-smi: {smi_line} | count "
          f"{torch.cuda.device_count()} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    return {"name": name, "smi": smi_line}


# ---------------------------------------------------------------- phase 2
def phase_build():
    from paddle_tpu_torch.ops import kernels

    secs, logs = kernels.build(force=True, ptxas_info=True)
    print(f"build: nvcc {secs:.2f} s", flush=True)
    for src, log in sorted(logs.items()):
        regs = [ln.split("Used ")[1] for ln in log.splitlines()
                if "Used " in ln and "registers" in ln]
        spills = sum("0 bytes spill stores" not in ln
                     for ln in log.splitlines() if "spill stores" in ln)
        print(f"build: {src}: {len(regs)} kernels, {spills} with spills; "
              f"{'; '.join(r.split(',')[0] for r in regs)}", flush=True)
    from paddle_tpu_torch.ops.kernels.rms_norm import rms_norm_fwd

    x = torch.randn(8, 4096, device="cuda")
    t0 = time.perf_counter()
    rms_norm_fwd(x, torch.ones(4096, device="cuda"))
    torch.cuda.synchronize()
    tsecs = time.perf_counter() - t0
    print(f"build: triton rms_norm first launch {tsecs:.2f} s", flush=True)
    return {"nvcc_s": secs, "triton_first_launch_s": tsecs,
            "ptxas": logs}


# ---------------------------------------------------------------- phase 3
PAGED_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
RMS_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-2)}


def _paged_case(b, hq, hkv, d, page, max_len, dtype, gen):
    from paddle_tpu_torch.ops.kernels.decode_attention import (
        paged_attention, paged_attention_plain)

    pps = max_len // page
    num_pages = b * pps + 1
    lengths = np.linspace(1, max_len, b).astype(np.int64)
    lengths[1] = page + 1                    # one row just past a page edge
    lengths = np.sort(lengths)
    rng = np.random.default_rng(0)
    perm = rng.permutation(num_pages)
    tables = np.empty((b, pps), np.int64)
    used = 0
    for i, n in enumerate(lengths):
        own = -(-int(n) // page)
        tables[i, :own] = perm[used:used + own]
        used += own
        # garbage past the length: out-of-range and foreign page ids
        tables[i, own:] = rng.integers(-5, num_pages + 5, pps - own)
    dev = "cuda"
    q = torch.randn(b, hq, d, generator=gen, device=dev).to(dtype)
    kp = torch.randn(hkv, num_pages, page, d, generator=gen,
                     device=dev).to(dtype)
    vp = torch.randn(hkv, num_pages, page, d, generator=gen,
                     device=dev).to(dtype)
    tab = torch.as_tensor(tables, dtype=torch.int32, device=dev)
    lens = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    out = paged_attention(q, kp, vp, tab, lens)
    ref = paged_attention_plain(q, kp, vp, tab, lens)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    check(torch.isfinite(out.float()).all().item(), "paged_attention: nan")
    check(err <= PAGED_TOL[dtype],
          f"paged_attention {dtype} Hq={hq} Hkv={hkv}: max err {err}")
    # library yardstick: SDPA over the pages gathered into a dense cache
    # (gather untimed; SDPA computes all max_len rows, masked)
    idx = tab.long().clamp(0, num_pages - 1)
    kd = kp[:, idx].reshape(hkv, b, pps * page, d).transpose(0, 1)
    vd = vp[:, idx].reshape(hkv, b, pps * page, d).transpose(0, 1)
    rep = hq // hkv
    if rep > 1:
        kd = kd.repeat_interleave(rep, 1)
        vd = vd.repeat_interleave(rep, 1)
    kd, vd = kd.contiguous(), vd.contiguous()
    mask = (torch.arange(pps * page, device=dev)[None, :]
            < lens.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    lib = F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask)[:, :, 0]
    check((lib.float() - ref.float()).abs().max().item()
          <= 4 * PAGED_TOL[dtype], "sdpa yardstick disagrees")
    item = torch.tensor([], dtype=dtype).element_size()
    live = int(lengths.sum())
    nbytes = (2 * live * hkv * d + 2 * b * hq * d) * item + tab.numel() * 4 \
        + b * 4
    ops = 4 * live * hq * d
    bms, by = bound_ms(nbytes, ops, dtype)
    res = {
        "shape": f"B={b} Hq={hq} Hkv={hkv} D={d} page={page} "
                 f"lengths={lengths.tolist()}",
        "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
        "ms": time_ms(lambda: paged_attention(q, kp, vp, tab, lens)),
        "plain_ms": time_ms(
            lambda: paged_attention_plain(q, kp, vp, tab, lens)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q4, kd, vd, attn_mask=mask)),
        "bound_ms": bms, "bound_by": by,
    }
    return res


def _rms_case(n, h, dtype, gen):
    from paddle_tpu_torch.ops.kernels.rms_norm import (rms_norm_fwd,
                                                       rms_norm_plain)

    x = torch.randn(n, h, generator=gen, device="cuda").to(dtype)
    w = (1 + 0.1 * torch.randn(h, generator=gen, device="cuda")).to(dtype)
    o, rstd = rms_norm_fwd(x, w)
    ro, rrstd = rms_norm_plain(x, w)
    torch.cuda.synchronize()
    err = (o.float() - ro.float()).abs().max().item()
    rtol, atol = RMS_TOL[dtype]
    check(torch.allclose(o.float(), ro.float(), rtol=rtol, atol=atol),
          f"rms_norm {dtype} [{n},{h}]: max err {err}")
    check(torch.allclose(rstd, rrstd, rtol=1e-5, atol=1e-6),
          f"rms_norm rstd {dtype} [{n},{h}]")
    item = x.element_size()
    bms, by = bound_ms(2 * n * h * item + h * item + n * 4, 4 * n * h, dtype)
    return {
        "shape": f"[{n},{h}]", "dtype": str(dtype).replace("torch.", ""),
        "max_abs_err": err,
        "ms": time_ms(lambda: rms_norm_fwd(x, w)),
        "plain_ms": time_ms(lambda: rms_norm_plain(x, w)),
        "library_ms": time_ms(lambda: F.rms_norm(x, (h,), w, 1e-6)),
        "bound_ms": bms, "bound_by": by,
    }


#: error relative to the largest reference value. f32: summation order
#: (and, in the backward, the run-to-run order of the dq atomics). bf16: p
#: and ds are rounded from f32 values whose last bits differ between the
#: routes, and the outputs are rounded to bf16.
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: f32: summation order over M; bf16: output rounding (2^-8) and products
#: rounded from f32 values whose last bits differ
SWIGLU_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _rel_err(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    abs_err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(got, want))
    rel = max(((a.float() - b.float()).abs().max()
               / b.float().abs().max().clamp_min(1e-6)).item()
              for a, b in zip(got, want))
    return abs_err, rel


def _flash_cases(b, hq, hkv, s, d, dtype, gen):
    """The forward and the fused backward at [b, s, hq/hkv, d], causal."""
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_fwd_plain)

    q = torch.randn(b * hq, s, d, generator=gen, device=DEVICE).to(dtype)
    k = torch.randn(b * hkv, s, d, generator=gen, device=DEVICE).to(dtype)
    v = torch.randn(b * hkv, s, d, generator=gen, device=DEVICE).to(dtype)
    do = torch.randn(b * hq, s, d, generator=gen, device=DEVICE).to(dtype)
    shape = f"[{b},{s},{hq}/{hkv},{d}] causal"
    name = str(dtype).replace("torch.", "")
    o, lse = flash_attention_fwd(q, k, v, True)
    ro, rlse = flash_attention_fwd_plain(q, k, v, True)
    torch.cuda.synchronize()
    err, rel = _rel_err(o, ro)
    lse_err = (lse - rlse).abs().max().item()
    check(torch.isfinite(o.float()).all().item(), f"flash fwd {shape}: nan")
    check(rel <= FLASH_TOL[dtype] and lse_err <= 1e-3,
          f"flash fwd {name} {shape}: rel err {rel}, lse err {lse_err}")
    grads = flash_attention_bwd(q, k, v, ro, rlse, do, True)
    want = flash_attention_bwd_plain(q, k, v, ro, rlse, do, True)
    torch.cuda.synchronize()
    berr, brel = _rel_err(grads, want)
    check(all(torch.isfinite(g.float()).all().item() for g in grads),
          f"flash bwd {shape}: nan")
    check(brel <= FLASH_TOL[dtype],
          f"flash bwd {name} {shape}: rel err {brel}")
    # library yardstick: SDPA on the [B, H, S, D] views of the same data
    q4, k4, v4, do4 = (t.view(b, -1, s, d) for t in (q, k, v, do))
    gqa = hq != hkv
    lib_o = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                           enable_gqa=gqa)
    check(_rel_err(lib_o, ro.view(b, hq, s, d))[1] <= 2 * FLASH_TOL[dtype],
          "sdpa yardstick disagrees")
    ql, kl, vl = (t.detach().requires_grad_() for t in (q4, k4, v4))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                             enable_gqa=gqa)
    item = q.element_size()
    pairs = b * hq * s * (s + 1) // 2          # causal (query, key) pairs
    io_q, io_kv = b * hq * s * d * item, b * hkv * s * d * item
    fbms, fby = bound_ms(2 * io_q + 2 * io_kv + b * hq * s * 4,
                         4 * d * pairs, dtype)
    bbms, bby = bound_ms(4 * io_q + 4 * io_kv + b * hq * s * 4,
                         10 * d * pairs, dtype)
    fwd = {"shape": shape, "dtype": name, "max_abs_err": err,
           "max_rel_err": rel, "lse_max_abs_err": lse_err,
           "ms": time_ms(lambda: flash_attention_fwd(q, k, v, True)),
           "plain_ms": time_ms(
               lambda: flash_attention_fwd_plain(q, k, v, True)),
           "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
               q4, k4, v4, is_causal=True, enable_gqa=gqa)),
           "bound_ms": fbms, "bound_by": fby}
    bwd = {"shape": shape, "dtype": name, "max_abs_err": berr,
           "max_rel_err": brel,
           "ms": time_ms(lambda: flash_attention_bwd(q, k, v, ro, rlse, do,
                                                     True)),
           "plain_ms": time_ms(lambda: flash_attention_bwd_plain(
               q, k, v, ro, rlse, do, True), reps=5, inner=2),
           "library_ms": time_ms(lambda: torch.autograd.grad(
               lib_out, (ql, kl, vl), do4, retain_graph=True)),
           "bound_ms": bbms, "bound_by": bby}
    return fwd, bwd


def _swiglu_case(rows, m, h, dtype, gen):
    from paddle_tpu_torch.ops.kernels.swiglu_down import (swiglu_down_fwd,
                                                          swiglu_down_plain)

    g = torch.randn(rows, m, generator=gen, device=DEVICE).to(dtype)
    u = torch.randn(rows, m, generator=gen, device=DEVICE).to(dtype)
    wd = (0.02 * torch.randn(m, h, generator=gen, device=DEVICE)).to(dtype)
    out = swiglu_down_fwd(g, u, wd)
    want = swiglu_down_plain(g, u, wd)
    torch.cuda.synchronize()
    err, rel = _rel_err(out, want)
    check(torch.isfinite(out.float()).all().item(), "swiglu_down: nan")
    check(rel <= SWIGLU_TOL[dtype],
          f"swiglu_down {dtype} [{rows},{m}]x[{m},{h}]: rel err {rel}")
    item = g.element_size()
    bms, by = bound_ms((2 * rows * m + m * h + rows * h) * item,
                       2 * rows * m * h + 4 * rows * m, dtype)
    return {"shape": f"[{rows},{m}]x[{m},{h}]",
            "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
            "max_rel_err": rel,
            "ms": time_ms(lambda: swiglu_down_fwd(g, u, wd)),
            "plain_ms": time_ms(lambda: swiglu_down_plain(g, u, wd)),
            # the unfused pair: F.silu(g) * u, then torch.matmul
            "library_ms": time_ms(lambda: torch.matmul(F.silu(g) * u, wd)),
            "bound_ms": bms, "bound_by": by}


def phase_kernels():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = {"paged_attention": [], "rms_norm": [], "flash_attention_fwd": [],
             "flash_attention_bwd": [], "swiglu_down": []}
    for dtype in (torch.bfloat16, torch.float32):
        # LLaMA-7B decode: MHA; LLaMA-70B attention: GQA 64/8
        cases["paged_attention"].append(
            _paged_case(8, 32, 32, 128, 64, 2048, dtype, gen))
        cases["paged_attention"].append(
            _paged_case(8, 64, 8, 128, 64, 2048, dtype, gen))
        for n in (8, 2048):
            cases["rms_norm"].append(_rms_case(n, 4096, dtype, gen))
        # config 4's block norms at batch 3 x seq 2048 tokens
        cases["rms_norm"].append(_rms_case(6144, 2048, dtype, gen))
        # config 4 (GPT-3 1.3B, MHA 16 heads) and config 5's GQA 32/8, at
        # batch 3 x seq 2048; f32 at batch 1
        b = 3 if dtype == torch.bfloat16 else 1
        for hq, hkv in ((16, 16), (32, 8)):
            fwd, bwd = _flash_cases(b, hq, hkv, 2048, 128, dtype, gen)
            cases["flash_attention_fwd"].append(fwd)
            cases["flash_attention_bwd"].append(bwd)
        # config 4's FFN seam at batch 3 x seq 2048 tokens
        cases["swiglu_down"].append(_swiglu_case(6144, 5504, 2048, dtype,
                                                 gen))
    for name, rows in cases.items():
        for r in rows:
            print(f"kernel {name} {r['dtype']} {r['shape']}: "
                  f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library "
                  f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} by "
                  f"{r['bound_by']}) max_abs_err {r['max_abs_err']:.3g}",
                  flush=True)
    return cases


# ---------------------------------------------------------------- phase 4
def _random_model(cfg, dtype, seed):
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    return LlamaForCausalLM(cfg, device=DEVICE, dtype=dtype).init_weights(
        gen, std=0.02)


def _decode_window(engine, ticks):
    """``ticks`` pure decode ticks on the host clock, then ``ticks`` more
    under the profiler: device busy time (sum of kernel times) and the
    time in each kernel. The host share is 1 - busy / unprofiled wall."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        engine.step()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = 0.0
    by_kernel = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dt = ev.time_range.elapsed_us()
            busy += dt
            by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + dt
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {"ticks": ticks, "wall_ms_per_tick": plain_wall * 1e3 / ticks,
            "profiled_wall_ms_per_tick": wall * 1e3 / ticks,
            "device_busy_ms_per_tick": busy / 1e3 / ticks,
            "host_share": (1 - busy / 1e6 / plain_wall) if busy > 0 else None,
            "top_kernels_ms_per_tick": [(k[:80], v / 1e3 / ticks)
                                        for k, v in top]}


def phase_serving():
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.models.llama import llama_preset
    from paddle_tpu_torch.ops import kernels

    cfg = llama_preset("7b")
    check((cfg.hidden_size, cfg.num_layers, cfg.num_heads,
           cfg.intermediate_size, cfg.vocab_size, cfg.tie_embeddings)
          == (4096, 32, 32, 11008, 32000, False), "7b preset")
    t0 = time.perf_counter()
    model = _random_model(cfg, torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in model.parameters())
    print(f"serving: LLaMA-7B width, {nparams / 1e9:.3f} B params bf16, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    new = 32
    eng = ContinuousBatchingEngine(model, max_slots=8, page_size=64,
                                   max_seq_len=2048, max_new_tokens=new,
                                   prefill_chunk=512, seed=0,
                                   device=DEVICE)
    rng = np.random.default_rng(0)
    # warm-up request (cuBLAS handles, allocator) outside the counted run
    eng.submit(rng.integers(1, cfg.vocab_size, 80).tolist())
    eng.run_until_complete()
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (128, 1024, 256, 896, 384, 768, 512, 640)]
    ticks0, chunks0 = eng.decode_ticks, eng.prefill_chunk_steps
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    first_t, submit_t = {}, {}

    def on_token(rid, tok):
        first_t.setdefault(rid, time.perf_counter())

    def submit(p):
        t = time.perf_counter()
        rid = eng.submit(p, on_token=on_token)
        submit_t[rid] = t
        return rid

    rids = [submit(p) for p in prompts[:5]]
    done = {}
    step_ms = []

    def timed_step():
        c0, d0 = eng.prefill_chunk_steps, eng.decode_ticks
        s = time.perf_counter()
        done.update(eng.step())
        torch.cuda.synchronize()
        if eng.prefill_chunk_steps == c0 and eng.decode_ticks == d0 + 1:
            step_ms.append((time.perf_counter() - s) * 1e3)

    timed_step()
    timed_step()
    rids += [submit(p) for p in prompts[5:]]
    while eng._waiting or any(s is not None for s in eng._slots):
        timed_step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    ticks = eng.decode_ticks - ticks0
    chunks = eng.prefill_chunk_steps - chunks0
    check(sorted(done) == sorted(rids), f"completed {sorted(done)}")
    for rid, p in zip(rids, prompts):
        out = done[rid]
        check(len(out) == len(p) + new and out[:len(p)] == p,
              f"request {rid}: {len(out)} tokens for prompt {len(p)}")
        check(all(0 <= t < cfg.vocab_size for t in out[len(p):]),
              f"request {rid}: token out of vocab")
    L = cfg.num_layers
    check(counts["paged_attention"] == L * ticks,
          f"paged_attention launches {counts['paged_attention']} != "
          f"{L} x {ticks} decode ticks")
    check(counts["rms_norm"] == (2 * L + 1) * (ticks + chunks),
          f"rms_norm launches {counts['rms_norm']} != {2 * L + 1} x "
          f"({ticks} decode ticks + {chunks} prefill passes)")
    gen_tokens = new * len(prompts)
    res = {"wall_s": wall, "decode_ticks": ticks, "prefill_passes": chunks,
           "generated_tokens": gen_tokens,
           "tokens_per_s": gen_tokens / wall,
           "decode_tick_ms_median": statistics.median(step_ms),
           "decode_tick_ms_all": step_ms, "launches": counts,
           "ttft_ms": {len(p): (first_t[r] - submit_t[r]) * 1e3
                       for r, p in zip(rids, prompts)}}
    print(f"serving: 8 requests, {gen_tokens} tokens in {wall:.3f} s = "
          f"{res['tokens_per_s']:.1f} tok/s; {ticks} decode ticks, {chunks} "
          f"prefill passes; pure decode tick median "
          f"{res['decode_tick_ms_median']:.2f} ms over {len(step_ms)}; "
          f"launches {counts}", flush=True)
    print("serving: TTFT ms by prompt length "
          + json.dumps({k: round(v, 1) for k, v in res["ttft_ms"].items()}),
          flush=True)
    # a second batch for the decode window (outside the counted run)
    for p in prompts:
        eng.submit(p[:512])
    while any(s is None for s in eng._slots) or any(
            s.prefill_pos < len(s.seq_tokens) for s in eng._slots):
        eng.step()
    res["decode_window"] = _decode_window(eng, 10)
    eng.run_until_complete()
    dw = res["decode_window"]
    print(f"serving: decode tick {dw['wall_ms_per_tick']:.2f} ms wall, "
          f"{dw['device_busy_ms_per_tick']:.2f} ms device busy, host share "
          f"{dw['host_share']}", flush=True)
    for k, v in dw["top_kernels_ms_per_tick"]:
        print(f"serving:   {v:8.3f} ms/tick  {k}", flush=True)
    del eng, model
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------- phase 5
def phase_consistency():
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.models.llama import llama_preset

    cfg = llama_preset("7b", num_layers=2)
    model = _random_model(cfg, torch.float32, seed=1)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (37, 130, 200)]
    new = 8
    want = {i: model.generate(np.asarray([p]), max_new_tokens=new)[0]
            .tolist() for i, p in enumerate(prompts)}
    eng = ContinuousBatchingEngine(model, max_slots=2, page_size=64,
                                   max_seq_len=512, max_new_tokens=new,
                                   prefill_chunk=64, seed=0,
                                   device=DEVICE)
    eng.submit(prompts[0])
    eng.submit(prompts[1])
    done = {}
    done.update(eng.step())
    done.update(eng.step())
    eng.submit(prompts[2])
    done.update(eng.run_until_complete())
    for rid in range(3):
        check(done[rid] == want[rid],
              f"engine vs generate, request {rid}: {done[rid][-new:]} != "
              f"{want[rid][-new:]}")
    print("consistency: f32 depth-2 engine streams == generate on 3 "
          "prompts", flush=True)
    del eng, model
    torch.cuda.empty_cache()
    return {"prompts": [len(p) for p in prompts], "new_tokens": new}

# ---------------------------------------------------------------- phase 6
def _profile_step(step, batch, wall_ms):
    """One step under the profiler: device busy time (sum of kernel
    times), the host share against the unprofiled step wall, the top 8
    kernels by time (as _decode_window does for serving), and the busy
    time split into the port's kernels, cuBLAS GEMMs and everything
    else (elementwise, copies, reductions)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(*batch)
        torch.cuda.synchronize()
    busy = 0.0
    by_kernel = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dt = ev.time_range.elapsed_us()
            busy += dt
            by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + dt
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    groups = {"port_kernels": 0.0, "gemm": 0.0, "other": 0.0}
    for k, v in by_kernel.items():
        if any(n in k for n in ("flash_fwd_kernel", "flash_bwd_kernel",
                                "swiglu_down_kernel", "_rms_fwd",
                                "paged_attention_kernel")):
            groups["port_kernels"] += v / 1e3
        elif any(n in k for n in ("nvjet", "gemm", "splitKreduce")):
            groups["gemm"] += v / 1e3
        else:
            groups["other"] += v / 1e3
    return {"device_busy_ms": busy / 1e3,
            "host_share": (1 - busy / 1e3 / wall_ms) if busy > 0 else None,
            "top_kernels_ms": [(k[:80], v / 1e3) for k, v in top],
            "by_group_ms": groups}


def _train_setup(cfg, dtype, device, seed):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTForCausalLMPipe
    from paddle_tpu_torch.optimizer import AdamW

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model = GPTForCausalLMPipe(cfg, device=device, dtype=dtype).init_weights(
        gen, std=0.02)
    opt = AdamW(model.parameters(), lr=3e-4, weight_decay=0.01,
                factored=True)
    return model, TrainStep(model, model.loss, opt)


def _train_batch(vocab, batch, seq, seed, device):
    """Seeded random ids and labels, as bench.py:638-639 makes them."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
    labels = rng.integers(0, vocab, (batch, seq)).astype(np.int64)
    return (torch.as_tensor(ids, device=device).long(),
            torch.as_tensor(labels, device=device))


def phase_training():
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.ops import kernels

    # GPT-3 1.3B, BASELINE.md config 4 (bench.py:259-262)
    cfg = GPTConfig(vocab_size=32000, hidden_size=2048, num_layers=24,
                    num_heads=16, max_seq_len=2048, dropout=0.0,
                    dtype="bfloat16", recompute=True)
    check((cfg.vocab_size, cfg.hidden_size, cfg.num_layers, cfg.num_heads,
           cfg.intermediate_size, cfg.tie_embeddings)
          == (32000, 2048, 24, 16, 5504, True), "config 4")
    batch, seq, timed = 3, 2048, 5
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, step = _train_setup(cfg, torch.bfloat16, DEVICE, seed=0)
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in model.parameters())
    print(f"training: config 4, {nparams / 1e9:.4f} B params bf16, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ids, labels = _train_batch(cfg.vocab_size, batch, seq, 0, DEVICE)
    losses, step_ms = [], []
    t0 = time.perf_counter()
    losses.append(step(ids, labels).item())          # warm-up
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    kernels.reset_launch_counts()
    for _ in range(timed):
        t0 = time.perf_counter()
        loss = step(ids, labels)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    counts = kernels.launch_counts()
    health = step.last_health
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    L = cfg.num_layers
    # full remat: each block's forward runs twice (forward, recompute);
    # the flash backward once per block; two rms norms per block forward
    want = {"flash_attention_fwd": 2 * L, "flash_attention_bwd": L,
            "swiglu_down": 2 * L, "rms_norm": 4 * L, "paged_attention": 0}
    formula = ("per step: flash_attention_fwd 2L, flash_attention_bwd L, "
               "swiglu_down 2L, rms_norm 4L, paged_attention 0; L = "
               f"{L}, {timed} steps")
    print(f"training: launches {counts}; {formula}", flush=True)
    for name, per_step in want.items():
        check(counts[name] == per_step * timed,
              f"{name} launches {counts[name]} != {per_step} x {timed}")
    check(all(np.isfinite(losses)), f"losses {losses}")
    ln_v = float(np.log(cfg.vocab_size))
    check(ln_v - 0.1 <= losses[0] <= ln_v + 1.5,
          f"first loss {losses[0]} outside [ln V - 0.1, ln V + 1.5]")
    check(losses[-1] < losses[0], f"losses do not fall: {losses}")
    check(health.finite and health.ok, f"health {health}")
    med = statistics.median(step_ms)
    tokens = batch * seq
    tps = tokens / (med / 1e3)
    mfu = 6.0 * nparams * tps / PEAK_OPS[torch.bfloat16]
    res = {"config": "gpt3-1.3b (config 4)", "params": nparams,
           "batch": batch, "seq": seq, "losses": losses,
           "warmup_step_ms": warm_ms, "step_ms": step_ms,
           "step_ms_median": med, "tokens_per_s": tps,
           "model_flops_share": mfu,
           "model_flops_formula": "6 * params * tokens_per_s / 989e12 "
                                  "(bench.py:886-895; H100 SXM dense bf16)",
           "grad_norm": health.grad_norm, "peak_memory_gib": peak_gb,
           "launches": counts, "launch_formula": formula}
    print(f"training: losses {[round(x, 4) for x in losses]}", flush=True)
    print(f"training: step median {med:.1f} ms over {timed} "
          f"({[round(x, 1) for x in step_ms]}), warm-up {warm_ms:.0f} ms, "
          f"{tps:.0f} tokens/s, model-flops share {mfu:.4f} = "
          f"{res['model_flops_formula']}; peak memory {peak_gb:.1f} GiB, "
          f"grad norm {health.grad_norm:.4f}", flush=True)
    res["profile"] = prof = _profile_step(step, (ids, labels), med)
    print(f"training: profiled step {prof['device_busy_ms']:.1f} ms device "
          f"busy, host share {prof['host_share']}; by group "
          + json.dumps({k: round(v, 2) for k, v in
                        prof["by_group_ms"].items()}), flush=True)
    for k, v in prof["top_kernels_ms"]:
        print(f"training:   {v:9.3f} ms/step  {k}", flush=True)
    del step, model
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------- phase 7
#: f32 on both devices: matmuls, attention and the CE head sum in other
#: orders on the card and the CPU, and the card's dq atomics in an order
#: that changes from run to run
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 5e-4            # of each leaf's norm


def phase_train_consistency():
    from paddle_tpu_torch.models.gpt import GPTConfig

    cfg = GPTConfig(vocab_size=32000, hidden_size=2048, num_layers=2,
                    num_heads=16, max_seq_len=2048, dropout=0.0,
                    dtype="float32", recompute=True)
    cpu_model, cpu_step = _train_setup(cfg, torch.float32, "cpu", seed=1)
    gpu_model, gpu_step = _train_setup(cfg, torch.float32, DEVICE, seed=1)
    gpu_model.load_state_dict(cpu_model.state_dict())
    losses, grads = {}, {}
    for dev, model, step in (("cpu", cpu_model, cpu_step),
                             (DEVICE, gpu_model, gpu_step)):
        ids, labels = _train_batch(cfg.vocab_size, 1, 256, 1, dev)
        losses[dev] = [step(ids, labels).item()]
        grads[dev] = {n: p.grad.detach().float().cpu().clone()
                      for n, p in model.named_parameters()}
        losses[dev] += [step(ids, labels).item() for _ in range(2)]
    worst = {}
    for n, g in grads["cpu"].items():
        worst[n] = ((grads[DEVICE][n] - g).norm()
                    / g.norm().clamp_min(1e-30)).item()
    rel = [abs(a - b) / abs(b) for a, b in zip(losses[DEVICE],
                                                losses["cpu"])]
    print(f"train consistency: f32 depth 2 seq 256, losses card "
          f"{losses[DEVICE]} cpu {losses['cpu']} (max rel {max(rel):.2e}, "
          f"tol {TRAIN_LOSS_RTOL}); step-1 grads max rel "
          f"{max(worst.values()):.2e} ({max(worst, key=worst.get)}, tol "
          f"{TRAIN_GRAD_RTOL})", flush=True)
    check(max(rel) <= TRAIN_LOSS_RTOL, f"losses differ: {losses}")
    check(max(worst.values()) <= TRAIN_GRAD_RTOL, f"grads differ: {worst}")
    del gpu_model, gpu_step
    torch.cuda.empty_cache()
    return {"losses": losses, "grad_rel_err": worst}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="write every measurement here as JSON")
    ap.add_argument("--quick", action="store_true",
                    help="phases 1-3 only; no result line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import paddle_tpu_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    report = {"device": phase_device(), "build": phase_build(),
              "kernels": phase_kernels()}
    if not args.quick:
        report["serving"] = phase_serving()
        report["consistency"] = phase_consistency()
        report["training"] = phase_training()
        report["train_consistency"] = phase_train_consistency()
    report["seconds"] = time.perf_counter() - t0
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    if args.quick:
        return 0
    src = "paddle_tpu_torch/ops/kernels/"
    pallas = "paddle_tpu/ops/pallas/"
    meta = {
        "paged_attention": ("cuda", src + "csrc/paged_attention.cu",
                            pallas + "decode_attention.py:336"),
        "rms_norm": ("triton", src + "rms_norm.py", pallas + "rms_norm.py:43"),
        "flash_attention_fwd": ("cuda", src + "csrc/flash_attention.cu",
                                pallas + "flash_attention.py:248"),
        "flash_attention_bwd": ("cuda", src + "csrc/flash_attention.cu",
                                pallas + "flash_attention.py:581"),
        "swiglu_down": ("cuda", src + "csrc/swiglu_down.cu",
                        pallas + "swiglu_down.py:86"),
    }
    line = []
    for name, (route, source, replaces) in meta.items():
        # bf16 at the main path's shape: serving for the decode kernels,
        # config 4 training for the others
        main_case = report["kernels"][name][0]
        by_path = {"serving": report["serving"]["launches"][name],
                   "training": report["training"]["launches"][name]}
        line.append({"name": name, "route": route, "source": source,
                     "replaces": replaces,
                     "launches": sum(by_path.values()),
                     "launches_by_path": by_path,
                     "shape": main_case["shape"],
                     "max_abs_err": main_case["max_abs_err"],
                     "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
                     "bound_ms": main_case["bound_ms"],
                     "bound_by": main_case["bound_by"],
                     "library_ms": main_case["library_ms"]})
    print(f"{report['device']['smi']}")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
