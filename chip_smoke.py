#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py [--out results.json] [--quick]

Phases, each of which fails the run on error:

1. device  - the card's name and power limit; fails without CUDA.
2. build   - nvcc builds ops/kernels/csrc/*.cu for sm_90a (one nvcc per
             source, in parallel), with ptxas's registers and spills per
             source, per bf16 fused and split flash-backward kernel and per
             instantiation of the rms_norm and add_rms_norm kernels and of
             the three decode kernels (none of which may spill).
3. kernels - each kernel against its plain PyTorch version on the card,
             in bf16 and f32, with times (CUDA events, median), the plain
             version's and one library call's time, and the bound; for the
             two norms, paged_attention_int8 and their library yardsticks
             also the time of the same calls replayed from a CUDA graph
             (the card's time without the host's launch cost). The
             flash forward runs twice at [3, 2048, 16/16, 128] for the same
             bits. At the long-context shapes in bf16: the split flash
             backward at [1, 32768, 16/16, 128] against its plain versions
             (one head at a time), against the fused kernel, and twice for
             the same bits; the flash forward there against its plain
             version (one head at a time) and SDPA; swiglu_down at
             [32768, 5504] x [5504, 2048] against its plain version and the
             library pair. Then paged_attention and paged_attention_int8
             in bf16 at D = 96, rep 16, and decode_attention at the incubate decoder's shape (lengths
             under 76 in a 2048-row cache).
4. serving - LLaMA-7B width and depth in bf16, random weights from a
             seeded generator, through ContinuousBatchingEngine's submit /
             step / run_until_complete with chunked prefill. Checks every
             request's token count and that the kernels' launch counts are
             32 (paged attention) and 65 (rms norm) per decode tick;
             prints the attention kernel's ms per tick.
   serving_int8 - the same model, requests and engine with int8_kv=True:
             paged_attention_int8 32 times per decode tick and
             paged_attention never, the KV cache at exactly 132/256 of the
             bf16 bytes; reports the share of tokens equal to phase 4's.
   incubate - the same model as a decoder built from the incubate fused
             ops (fused_rms_norm, masked_multihead_attention over a dense
             [2, 8, 32, 2048, 128] cache per layer, swiglu), 8 rows joining
             at staggered steps: decode_attention L, add_rms_norm 2L and
             rms_norm once per token.
5. consistency - f32, full width, depth 2: the engine's greedy streams
             equal the dense-cache generate token for token; the int8
             engine on the card equals the same engine on the CPU under
             group and chunked prefill; the incubate decoder's streams
             equal generate.
6. training - GPT-3 1.3B (config 4) at full width and depth in bf16:
             GPTForCausalLMPipe -> chunked-CE loss -> AdamW(factored) ->
             TrainStep, batch 3 x seq 2048, one warm-up and 5 timed steps
             and one profiled step. Checks finite, falling losses that
             start near ln(vocab) and the launch counts per step.
7. training consistency - f32, full width, depth 2: three TrainSteps on
             the card equal the same three on the CPU (plain versions).
8. long_context - GPT-3 1.3B at seq 32768 as bench.py:81-86 builds it:
             selective remat "names:attn_res,attn_lse,attn_q,attn_k,attn_v,
             resid_mid", AdamW(lr=3e-4), TrainStep, batch 1, one warm-up,
             3 timed steps and one profiled step. Checks finite, falling
             losses that start near ln(vocab) and the launch counts per
             step: flash forward L, split dq L, split dk/dv L, fused
             backward 0, swiglu_down 2L, rms_norm 4L.
9. long_context_remat - bf16, full width, depth 2, seq 32768: the step-1
             loss and gradients under that policy equal those under full
             remat.

The line before the last lists every kernel with its launch counts on the
serving, int8 serving, incubate, training and long-context runs; the last
line is {"ok": true, "device": {...}}.
``--quick`` runs phases 1-3 only, with fewer repetitions, and prints no
result line.
"""
from __future__ import annotations

import argparse
import json
import re
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


def graph_ms(fn, reps=15, inner=5):
    """Like :func:`time_ms`, but the ``inner`` calls are captured once in a
    CUDA graph and the graph is replayed: the card's time per call without
    the host's launch cost."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm-up outside the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    del graph
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
#: kernels whose every instantiation phase 2 prints and holds to no spill,
#: by source: (name fragments, instantiations). The bf16 flash backward's
#: TMA/wgmma kernels (fused; split dq and dk/dv) are built for D = 64 and
#: 128; rms_norm_kernel for x f32 (1, 2, 4 or 8 chunks a thread) and bf16
#: (1, 2 or 4), each with an f32 and a bf16 weight; add_rms_norm_kernel
#: for the same x layouts, each with every mix of residual and weight types.
SPILL_CHECKED = {"flash_attention.cu": (("flash_bwd_wgmma",), 2),
                 "flash_attention_split.cu": (("flash_bwd_dq_wgmma",
                                               "flash_bwd_dkv_wgmma"), 4),
                 "rms_norm.cu": (("rms_norm_kernel",), 14),
                 "add_rms_norm.cu": (("add_rms_norm_kernel",), 28)}


def ptxas_by_kernel(log, names=("",)):
    """``{mangled name: (registers, spill store bytes + spill load
    bytes)}`` from ``nvcc -Xptxas=-v`` output, for the entry functions
    whose names contain one of ``names`` (every one by default)."""
    out, cur, spill = {}, None, 0
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            cur = name if any(n in name for n in names) else None
        elif cur and "spill stores" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split()
                    if w.isdigit()]
            spill = nums[1] + nums[2]      # stack frame, stores, loads
        elif cur and "Used " in ln and "registers" in ln:
            out[cur] = (int(ln.split("Used ")[1].split()[0]), spill)
            cur = None
    return out


#: the decode kernels by source, each built for f32 and bf16 q, every head
#: width of EXACT_HEAD_DIMS and q-row groups of 1, 2, 4 and 8
DECODE_KERNELS = {"paged_attention.cu": "paged_attention_kernel",
                  "decode_attention.cu": "decode_attention_kernel",
                  "paged_attention_int8.cu": "paged_attention_int8_kernel"}
DECODE_ROW_GROUPS = (1, 2, 4, 8)


def decode_instance(mangled):
    """``"bf16 D=128 R=8"`` from a decode kernel's mangled name."""
    m = re.search(r"I(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E", mangled)
    if m is None:
        return mangled
    return (f"{'f32' if m.group(1) == 'f' else 'bf16'} D={m.group(2)} "
            f"R={m.group(3)}")


def phase_build():
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels.decode_attention import EXACT_HEAD_DIMS

    secs, logs = kernels.build(force=True, ptxas_info=True)
    print(f"build: nvcc {secs:.2f} s", flush=True)
    for src, log in sorted(logs.items()):
        found = ptxas_by_kernel(log).values()
        print(f"build: {src}: {len(found)} kernels, "
              f"{sum(spill > 0 for _, spill in found)} with spills; "
              f"{'; '.join(f'{regs} registers' for regs, _ in found)}",
              flush=True)
    for src, (names, want) in SPILL_CHECKED.items():
        found = ptxas_by_kernel(logs[src], names)
        for name, (regs, spill) in sorted(found.items()):
            print(f"build: {name}: {regs} registers, {spill} bytes spilled",
                  flush=True)
        check(len(found) == want,
              f"ptxas lines of {names} in {src}: {len(found)} != {want}")
        check(all(spill == 0 for _, spill in found.values()),
              f"a kernel of {src} spills: {found}")
    want = 2 * len(EXACT_HEAD_DIMS) * len(DECODE_ROW_GROUPS)
    for src, kname in DECODE_KERNELS.items():
        found = {decode_instance(k): v for k, v in
                 ptxas_by_kernel(logs[src], (kname,)).items()}
        for inst, (regs, spill) in sorted(found.items()):
            print(f"build: {kname} {inst}: {regs} registers, {spill} bytes "
                  f"spilled", flush=True)
        check(len(found) == want,
              f"ptxas lines of {kname}: {len(found)} != {want}")
        check(all(spill == 0 for _, spill in found.values()),
              f"a {kname} instantiation spills: {found}")
    return {"nvcc_s": secs, "ptxas": logs}


# ---------------------------------------------------------------- phase 3
PAGED_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
RMS_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-2)}


def _paged_inputs(b, hq, hkv, d, page, max_len, dtype, gen):
    """The serving phase's mixed lengths over shuffled pages, with garbage
    table entries past each length."""
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
    return q, kp, vp, tab, lens, lengths


def _len_mask(lens, s):
    """SDPA's boolean mask [B, 1, 1, S]: True on the first lens[b] rows."""
    return (torch.arange(s, device=lens.device)[None, :]
            < lens.long()[:, None])[:, None, None, :]


def _paged_case(b, hq, hkv, d, page, max_len, dtype, gen):
    from paddle_tpu_torch.ops.kernels.decode_attention import (
        paged_attention, paged_attention_plain)

    q, kp, vp, tab, lens, lengths = _paged_inputs(b, hq, hkv, d, page,
                                                  max_len, dtype, gen)
    pps, num_pages = max_len // page, kp.shape[1]
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
    mask = _len_mask(lens, pps * page)
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


def _paged_int8_case(b, hq, hkv, d, page, max_len, dtype, gen):
    """paged_attention_int8 over the pages of _paged_inputs quantized with
    the engine's quantizer; q and the output in ``dtype``."""
    from paddle_tpu_torch.memory import (dequantize_rows_int8,
                                         quantize_rows_int8)
    from paddle_tpu_torch.ops.kernels.decode_attention import (
        paged_attention_int8, paged_attention_int8_plain)

    q, kp, vp, tab, lens, lengths = _paged_inputs(b, hq, hkv, d, page,
                                                  max_len, dtype, gen)
    pps, num_pages = max_len // page, kp.shape[1]
    (kc, ks), (vc, vs) = quantize_rows_int8(kp), quantize_rows_int8(vp)
    del kp, vp
    args = (q, kc, ks, vc, vs, tab, lens)
    out = paged_attention_int8(*args)
    ref = paged_attention_int8_plain(*args)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    check(torch.isfinite(out.float()).all().item(), "paged_attention_int8: "
          "nan")
    check(err <= PAGED_TOL[dtype],
          f"paged_attention_int8 {dtype} Hq={hq} Hkv={hkv} D={d}: max err "
          f"{err}")
    check(torch.equal(paged_attention_int8(*args), out),
          f"paged_attention_int8 {dtype} Hq={hq} Hkv={hkv} D={d}: a second "
          f"call differs")
    # library yardstick, timed as one pair: gather and dequantize the
    # sequences' pages to q's type, then SDPA over all max_len rows, masked
    idx = tab.long().clamp(0, num_pages - 1)
    mask = _len_mask(lens, pps * page)
    q4 = q[:, :, None, :]

    def library():
        kd = dequantize_rows_int8(kc[:, idx], ks[:, idx], dtype).reshape(
            hkv, b, pps * page, d).transpose(0, 1)
        vd = dequantize_rows_int8(vc[:, idx], vs[:, idx], dtype).reshape(
            hkv, b, pps * page, d).transpose(0, 1)
        return F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask,
                                              enable_gqa=hq != hkv)

    lib = library()[:, :, 0]
    check((lib.float() - ref.float()).abs().max().item()
          <= 4 * PAGED_TOL[torch.bfloat16], "sdpa yardstick disagrees")
    item = q.element_size()
    live = int(lengths.sum())
    # codes (D bytes) + one f32 scale per live row, for K and V
    nbytes = (2 * live * hkv * (d + 4) + 2 * b * hq * d * item
              + tab.numel() * 4 + b * 4)
    # q.k and p.v (2 * 2 * D per row and q head), dequantization (D per
    # row of K and of V and kv head); all in f32
    ops = 4 * live * hq * d + 2 * live * hkv * d
    bms, by = bound_ms(nbytes, ops, torch.float32)
    return {
        "shape": f"B={b} Hq={hq} Hkv={hkv} D={d} page={page} int8 pages "
                 f"lengths={lengths.tolist()}",
        "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
        "ms": time_ms(lambda: paged_attention_int8(*args)),
        "plain_ms": time_ms(lambda: paged_attention_int8_plain(*args)),
        "library_ms": time_ms(library),
        # the card's time without the wrapper's host cost
        "device_ms": graph_ms(lambda: paged_attention_int8(*args)),
        "library_device_ms": graph_ms(library),
        "bound_ms": bms, "bound_by": by,
    }


def _decode_case(b, h, s, d, dtype, gen, max_len=None):
    """decode_attention over a dense [b, h, s, d] cache, mixed lengths up
    to ``max_len`` (default s)."""
    from paddle_tpu_torch.ops.kernels.decode_attention import (
        decode_attention, decode_attention_plain)

    lengths = np.linspace(1, max_len or s, b).astype(np.int64)
    lengths[1] = 33                          # one row just past a tile
    lengths = np.sort(lengths)
    q = torch.randn(b, h, d, generator=gen, device=DEVICE).to(dtype)
    kc = torch.randn(b, h, s, d, generator=gen, device=DEVICE).to(dtype)
    vc = torch.randn(b, h, s, d, generator=gen, device=DEVICE).to(dtype)
    lens = torch.as_tensor(lengths, dtype=torch.int32, device=DEVICE)
    out = decode_attention(q, kc, vc, lens)
    ref = decode_attention_plain(q, kc, vc, lens)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    check(torch.isfinite(out.float()).all().item(), "decode_attention: nan")
    check(err <= PAGED_TOL[dtype],
          f"decode_attention {dtype} [{b},{h},{s},{d}]: max err {err}")
    # library yardstick: SDPA over all s rows with a length mask
    mask = _len_mask(lens, s)
    q4 = q[:, :, None, :]
    lib = F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask)[:, :, 0]
    check((lib.float() - ref.float()).abs().max().item()
          <= 4 * PAGED_TOL[dtype], "sdpa yardstick disagrees")
    item = q.element_size()
    live = int(lengths.sum())
    nbytes = (2 * live * h * d + 2 * b * h * d) * item + b * 4
    bms, by = bound_ms(nbytes, 4 * live * h * d, dtype)
    return {
        "shape": f"[{b},{h},{s},{d}] lengths={lengths.tolist()}",
        "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
        "ms": time_ms(lambda: decode_attention(q, kc, vc, lens)),
        "plain_ms": time_ms(lambda: decode_attention_plain(q, kc, vc, lens)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q4, kc, vc, attn_mask=mask)),
        "bound_ms": bms, "bound_by": by,
    }


def _add_rms_case(n, h, dtype, gen):
    from paddle_tpu_torch.ops.kernels.add_rms_norm import (add_rms_norm_fwd,
                                                           add_rms_norm_plain)

    x = torch.randn(n, h, generator=gen, device=DEVICE).to(dtype)
    r = torch.randn(n, h, generator=gen, device=DEVICE).to(dtype)
    w = (1 + 0.1 * torch.randn(h, generator=gen, device=DEVICE)).to(dtype)
    y, o, rstd = add_rms_norm_fwd(x, r, w)
    ry, ro, rrstd = add_rms_norm_plain(x, r, w)
    torch.cuda.synchronize()
    check(torch.equal(y, ry), f"add_rms_norm y {dtype} [{n},{h}]")
    err = (o.float() - ro.float()).abs().max().item()
    rtol, atol = RMS_TOL[dtype]
    check(torch.allclose(o.float(), ro.float(), rtol=rtol, atol=atol),
          f"add_rms_norm {dtype} [{n},{h}]: max err {err}")
    check(torch.allclose(rstd, rrstd, rtol=1e-5, atol=1e-6),
          f"add_rms_norm rstd {dtype} [{n},{h}]")
    item = x.element_size()
    # x and r read, y and o written; the add, the square-sum and three
    # products per element
    bms, by = bound_ms(4 * n * h * item + h * item + n * 4, 6 * n * h, dtype)
    return {
        "shape": f"[{n},{h}]", "dtype": str(dtype).replace("torch.", ""),
        "max_abs_err": err,
        "ms": time_ms(lambda: add_rms_norm_fwd(x, r, w)),
        "plain_ms": time_ms(lambda: add_rms_norm_plain(x, r, w)),
        # the unfused pair: x + r, then F.rms_norm
        "library_ms": time_ms(lambda: F.rms_norm(x + r, (h,), w, 1e-6)),
        "device_ms": graph_ms(lambda: add_rms_norm_fwd(x, r, w)),
        "library_device_ms": graph_ms(
            lambda: F.rms_norm(x + r, (h,), w, 1e-6)),
        "bound_ms": bms, "bound_by": by,
    }


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
        "device_ms": graph_ms(lambda: rms_norm_fwd(x, w)),
        "library_device_ms": graph_ms(lambda: F.rms_norm(x, (h,), w, 1e-6)),
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


def _split_rows(args, b, hq, hkv, s, d, library_ms, reps, plain_reps):
    """The split backward's dq and dk/dv kernels on ``args = (q, k, v, do,
    lse, delta)`` at [b, s, hq/hkv, d], causal: each against its plain
    version, with times and bounds. Returns the two rows and the kernels'
    (dq, dk, dv)."""
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dkv_plain,
        flash_attention_bwd_dq, flash_attention_bwd_dq_plain)

    q, dtype = args[0], args[0].dtype
    shape = f"[{b},{s},{hq}/{hkv},{d}] causal"
    name = str(dtype).replace("torch.", "")
    dq = flash_attention_bwd_dq(*args, True)
    dk, dv = flash_attention_bwd_dkv(*args, True)
    want_dq = flash_attention_bwd_dq_plain(*args, True)
    want_dkv = flash_attention_bwd_dkv_plain(*args, True)
    torch.cuda.synchronize()
    qerr, qrel = _rel_err(dq, want_dq)
    kerr, krel = _rel_err((dk, dv), want_dkv)
    check(all(torch.isfinite(g.float()).all().item() for g in (dq, dk, dv)),
          f"flash split bwd {shape}: nan")
    check(qrel <= FLASH_TOL[dtype] and krel <= FLASH_TOL[dtype],
          f"flash split bwd {name} {shape}: rel err dq {qrel}, dk/dv {krel}")
    del want_dq, want_dkv
    item = q.element_size()
    pairs = b * hq * s * (s + 1) // 2          # causal (query, key) pairs
    io_q, io_kv, rows = b * hq * s * d * item, b * hkv * s * d * item, \
        b * hq * s * 4
    # dq pass: q, do, k, v, lse, delta read, dq written; S, dP and dS K
    dq_bound = bound_ms(3 * io_q + 2 * io_kv + 2 * rows, 6 * d * pairs,
                        dtype)
    # dk/dv pass: q, do, k, v, lse, delta read, dk, dv written; S, dP,
    # P^T dO and dS^T Q
    dkv_bound = bound_ms(2 * io_q + 4 * io_kv + 2 * rows, 8 * d * pairs,
                         dtype)
    out = []
    for kernel, plain, (err, rel), (bms, by) in (
            (flash_attention_bwd_dq, flash_attention_bwd_dq_plain,
             (qerr, qrel), dq_bound),
            (flash_attention_bwd_dkv, flash_attention_bwd_dkv_plain,
             (kerr, krel), dkv_bound)):
        out.append({
            "shape": shape, "dtype": name, "max_abs_err": err,
            "max_rel_err": rel,
            "ms": time_ms(lambda: kernel(*args, True), reps=reps,
                          inner=1 if reps < 15 else 5),
            "plain_ms": time_ms(lambda: plain(*args, True), reps=plain_reps,
                                inner=1),
            "library_ms": library_ms, "bound_ms": bms, "bound_by": by})
    return out, (dq, dk, dv)


def _flash_cases(b, hq, hkv, s, d, dtype, gen):
    """The forward, the fused backward and the split backward's two
    kernels at [b, s, hq/hkv, d], causal. The fused backward's ``ms`` is
    its wrapper's (delta given, as for the split pair); ``with_delta_ms``
    is flash_attention_bwd's, which computes delta first."""
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_fused,
        flash_attention_bwd_fused_plain, flash_attention_bwd_plain,
        flash_attention_fwd, flash_attention_fwd_plain)

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
    again = flash_attention_fwd(q, k, v, True)
    torch.cuda.synchronize()
    fwd_bitwise = torch.equal(o, again[0]) and torch.equal(lse, again[1])
    check(fwd_bitwise, f"flash fwd {name} {shape}: a second run differs")
    del again
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
    # fused backward: q, do, k, v, lse, delta read, dq, dk, dv written
    bbms, bby = bound_ms(3 * io_q + 4 * io_kv + 2 * b * hq * s * 4,
                         10 * d * pairs, dtype)
    fwd = {"shape": shape, "dtype": name, "max_abs_err": err,
           "max_rel_err": rel, "lse_max_abs_err": lse_err,
           "two_runs_bitwise": fwd_bitwise,
           "ms": time_ms(lambda: flash_attention_fwd(q, k, v, True)),
           "plain_ms": time_ms(
               lambda: flash_attention_fwd_plain(q, k, v, True)),
           "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
               q4, k4, v4, is_causal=True, enable_gqa=gqa)),
           "bound_ms": fbms, "bound_by": fby}
    delta = (do.float() * ro.float()).sum(-1)
    bwd = {"shape": shape, "dtype": name, "max_abs_err": berr,
           "max_rel_err": brel,
           "ms": time_ms(lambda: flash_attention_bwd_fused(
               q, k, v, do, rlse, delta, True)),
           "with_delta_ms": time_ms(lambda: flash_attention_bwd(
               q, k, v, ro, rlse, do, True)),
           "plain_ms": time_ms(lambda: flash_attention_bwd_fused_plain(
               q, k, v, do, rlse, delta, True), reps=5, inner=2),
           "library_ms": time_ms(lambda: torch.autograd.grad(
               lib_out, (ql, kl, vl), do4, retain_graph=True)),
           "bound_ms": bbms, "bound_by": bby}
    split, _ = _split_rows((q, k, v, do, rlse, delta), b, hq, hkv, s, d,
                           bwd["library_ms"], reps=15, plain_reps=3)
    return fwd, bwd, split


#: the long-context line's attention (bench.py:81-86): GPT-3 1.3B heads at
#: batch 1 x seq 32768, where the router takes the split backward
LONG_SHAPE = (1, 16, 16, 32768, 128)


def _flash_long_cases(gen):
    """The split pair at the long-context shape in bf16: against the plain
    versions (one head at a time, every head), against the fused kernel,
    and run twice for the same bits; the fused kernel's and SDPA's
    backward times beside them. The inputs' o and lse come from the
    forward kernel (the plain forward would hold [16, S, S] f32)."""
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        bwd_route, flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_bwd_fused, flash_attention_fwd)

    b, hq, hkv, s, d = LONG_SHAPE
    dtype = torch.bfloat16
    check(bwd_route(hq // hkv, s, d) == "split", "long shape takes split")
    q = torch.randn(b * hq, s, d, generator=gen, device=DEVICE).to(dtype)
    k = torch.randn(b * hkv, s, d, generator=gen, device=DEVICE).to(dtype)
    v = torch.randn(b * hkv, s, d, generator=gen, device=DEVICE).to(dtype)
    do = torch.randn(b * hq, s, d, generator=gen, device=DEVICE).to(dtype)
    o, lse = flash_attention_fwd(q, k, v, True)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta)
    q4, k4, v4, do4 = (t.view(b, -1, s, d) for t in (q, k, v, do))
    ql, kl, vl = (t.detach().requires_grad_() for t in (q4, k4, v4))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    lib_ms = time_ms(lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), do4, retain_graph=True), reps=3, inner=1)
    del lib_out, ql, kl, vl
    rows, split = _split_rows(args, b, hq, hkv, s, d, lib_ms, reps=3,
                              plain_reps=1)
    fused = flash_attention_bwd_fused(*args, True)
    torch.cuda.synchronize()
    err, rel = _rel_err(split, fused)
    check(rel <= FLASH_TOL[dtype],
          f"flash split against fused at {rows[0]['shape']}: rel err {rel}")
    again = (flash_attention_bwd_dq(*args, True),
             *flash_attention_bwd_dkv(*args, True))
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, c) for a, c in zip(split, again))
    check(bitwise, "the split backward is not the same bits on a second run")
    pairs = b * hq * s * (s + 1) // 2
    item = q.element_size()
    fbms, fby = bound_ms(3 * b * hq * s * d * item + 4 * b * hkv * s * d
                         * item + 2 * b * hq * s * 4, 10 * d * pairs, dtype)
    fused_row = {"shape": rows[0]["shape"], "dtype": "bfloat16",
                 "max_abs_err": err, "max_rel_err": rel,
                 "against": "the split pair",
                 "ms": time_ms(lambda: flash_attention_bwd_fused(*args, True),
                               reps=3, inner=1),
                 "plain_ms": None, "library_ms": lib_ms, "bound_ms": fbms,
                 "bound_by": fby}
    for r in rows:
        r.update(plain_check="every head, one [1,32768,1/1,128] problem at "
                             "a time", split_against_fused_rel_err=rel,
                 two_runs_bitwise=bitwise)
    del fused, split, again, args, delta, do
    torch.cuda.empty_cache()
    return rows, fused_row, _flash_long_fwd(q, k, v, o, lse)


def _flash_long_fwd(q, k, v, o, lse):
    """The forward at the long-context shape against its plain version one
    head at a time (all of them; one head's [S, S] f32 is 4 GiB), with its
    time, SDPA's and the bound."""
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_fwd, flash_attention_fwd_plain)

    b, hq, hkv, s, d = LONG_SHAPE
    dtype, rep = q.dtype, hq // hkv

    def plain_heads():
        out = []
        for i in range(b * hq):
            j = i // rep
            out.append(flash_attention_fwd_plain(
                q[i:i + 1], k[j:j + 1], v[j:j + 1], True))
        return out

    t0 = time.perf_counter()
    want = plain_heads()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max((o[i].float() - w[0][0].float()).abs().max().item()
              for i, w in enumerate(want))
    rel = err / max(w[0].float().abs().max().item() for w in want)
    lse_err = max((lse[i] - w[1][0]).abs().max().item()
                  for i, w in enumerate(want))
    del want
    torch.cuda.empty_cache()
    check(rel <= FLASH_TOL[dtype] and lse_err <= 1e-3,
          f"flash fwd at the long shape: rel err {rel}, lse err {lse_err}")
    q4, k4, v4 = (t.view(b, -1, s, d) for t in (q, k, v))
    pairs = b * hq * s * (s + 1) // 2
    item = q.element_size()
    bms, by = bound_ms(2 * b * hq * s * d * item + 2 * b * hkv * s * d * item
                       + b * hq * s * 4, 4 * d * pairs, dtype)
    return {"shape": f"[{b},{s},{hq}/{hkv},{d}] causal", "dtype": "bfloat16",
            "max_abs_err": err, "max_rel_err": rel,
            "lse_max_abs_err": lse_err,
            "plain_check": "every head, one at a time",
            "ms": time_ms(lambda: flash_attention_fwd(q, k, v, True), reps=5,
                          inner=2),
            "plain_ms": plain_ms,
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True), reps=5, inner=2),
            "bound_ms": bms, "bound_by": by}


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
             "flash_attention_bwd": [], "swiglu_down": [],
             "paged_attention_int8": [], "decode_attention": [],
             "add_rms_norm": [], "flash_attention_bwd_dq": [],
             "flash_attention_bwd_dkv": []}
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
            fwd, bwd, (dq, dkv) = _flash_cases(b, hq, hkv, 2048, 128,
                                               dtype, gen)
            cases["flash_attention_fwd"].append(fwd)
            cases["flash_attention_bwd"].append(bwd)
            cases["flash_attention_bwd_dq"].append(dq)
            cases["flash_attention_bwd_dkv"].append(dkv)
        # config 4's FFN seam at batch 3 x seq 2048 tokens
        cases["swiglu_down"].append(_swiglu_case(6144, 5504, 2048, dtype,
                                                 gen))
        # the int8 engine at LLaMA-7B width, and GQA 32/8
        for hq, hkv in ((32, 32), (32, 8)):
            cases["paged_attention_int8"].append(
                _paged_int8_case(8, hq, hkv, 128, 64, 2048, dtype, gen))
        # masked_multihead_attention's dense cache at LLaMA-7B width
        cases["decode_attention"].append(
            _decode_case(8, 32, 2048, 128, dtype, gen))
        # the incubate decoder's rows, and a prefill-sized block
        for n in (8, 4096):
            cases["add_rms_norm"].append(_add_rms_case(n, 4096, dtype, gen))
    # the long-context shape first: the split pair's main path
    (dq, dkv), fused, long_fwd = _flash_long_cases(gen)
    cases["flash_attention_bwd_dq"].insert(0, dq)
    cases["flash_attention_bwd_dkv"].insert(0, dkv)
    cases["flash_attention_bwd"].append(fused)
    # the long-context step's forward and FFN seam (batch 1 x seq 32768);
    # the config-4 shapes stay the first case of each kernel
    cases["flash_attention_fwd"].append(long_fwd)
    cases["swiglu_down"].append(_swiglu_case(32768, 5504, 2048,
                                             torch.bfloat16, gen))
    # Phi-3-mini's head width under MQA-like sharing (rep 16), exact and
    # int8, and the incubate decoder's cache with its live lengths under 76
    # rows
    cases["paged_attention"].append(
        _paged_case(8, 32, 2, 96, 64, 2048, torch.bfloat16, gen))
    cases["paged_attention_int8"].append(
        _paged_int8_case(8, 32, 2, 96, 64, 2048, torch.bfloat16, gen))
    cases["decode_attention"].append(
        _decode_case(8, 32, 2048, 128, torch.bfloat16, gen, max_len=75))
    for name, rows in cases.items():
        for r in rows:
            plain = ("none" if r["plain_ms"] is None
                     else f"{r['plain_ms']:.4f}")
            graphed = (f"; from a CUDA graph {r['device_ms']:.4f} ms, "
                       f"library {r['library_device_ms']:.4f}"
                       if "device_ms" in r else "")
            if "with_delta_ms" in r:
                graphed += (f"; with delta {r['with_delta_ms']:.4f}")
            print(f"kernel {name} {r['dtype']} {r['shape']}: "
                  f"{r['ms']:.4f} ms (plain {plain}, library "
                  f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} by "
                  f"{r['bound_by']}{graphed}) max_abs_err "
                  f"{r['max_abs_err']:.3g}"
                  + (f" against {r['against']}" if "against" in r else ""),
                  flush=True)
    print(f"kernel flash fwd at {cases['flash_attention_fwd'][0]['shape']}:"
          f" two runs bitwise "
          f"{cases['flash_attention_fwd'][0]['two_runs_bitwise']}",
          flush=True)
    print(f"kernel flash split bwd at {dq['shape']}: against fused rel err "
          f"{dq['split_against_fused_rel_err']:.3g}, two runs bitwise "
          f"{dq['two_runs_bitwise']}", flush=True)
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
    attn = {name: sum(v for k, v in by_kernel.items() if sym in k) / 1e3
            / ticks for name, sym in ATTENTION_SYMBOLS.items()}
    return {"ticks": ticks, "wall_ms_per_tick": plain_wall * 1e3 / ticks,
            "attention_ms_per_tick": attn,
            "profiled_wall_ms_per_tick": wall * 1e3 / ticks,
            "device_busy_ms_per_tick": busy / 1e3 / ticks,
            "host_share": (1 - busy / 1e6 / plain_wall) if busy > 0 else None,
            "top_kernels_ms_per_tick": [(k[:80], v / 1e3 / ticks)
                                        for k, v in top]}


SERVE_PROMPT_LENS = (128, 1024, 256, 896, 384, 768, 512, 640)
#: the decode tick's attention kernels as the profiler names them
ATTENTION_SYMBOLS = {"paged_attention": "paged_attention_kernel",
                     "paged_attention_int8": "paged_attention_int8_kernel"}


def _serve(eng, cfg, new, tag):
    """The serving run of one engine: a warm-up request, then 8 greedy
    requests (five up front, three after two steps), a decode window
    under the profiler on a second batch. Checks every request's tokens
    and the launch counts per decode tick; returns the measurements and
    the streams in prompt order."""
    from paddle_tpu_torch.inference.serving import _kv_nbytes
    from paddle_tpu_torch.ops import kernels

    rng = np.random.default_rng(0)
    # warm-up request (cuBLAS handles, allocator) outside the counted run
    eng.submit(rng.integers(1, cfg.vocab_size, 80).tolist())
    eng.run_until_complete()
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in SERVE_PROMPT_LENS]
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
    attn, other = (("paged_attention_int8", "paged_attention") if eng.int8_kv
                   else ("paged_attention", "paged_attention_int8"))
    check(counts[attn] == L * ticks and counts[other] == 0,
          f"{attn} launches {counts[attn]} != {L} x {ticks} decode ticks, "
          f"or {other} launches {counts[other]} != 0")
    check(counts["rms_norm"] == (2 * L + 1) * (ticks + chunks),
          f"rms_norm launches {counts['rms_norm']} != {2 * L + 1} x "
          f"({ticks} decode ticks + {chunks} prefill passes)")
    gen_tokens = new * len(prompts)
    res = {"wall_s": wall, "decode_ticks": ticks, "prefill_passes": chunks,
           "generated_tokens": gen_tokens,
           "tokens_per_s": gen_tokens / wall,
           "decode_tick_ms_median": statistics.median(step_ms),
           "decode_tick_ms_all": step_ms, "launches": counts,
           "kv_bytes": _kv_nbytes(eng.kc) + _kv_nbytes(eng.vc),
           "ttft_ms": {len(p): (first_t[r] - submit_t[r]) * 1e3
                       for r, p in zip(rids, prompts)}}
    print(f"{tag}: 8 requests, {gen_tokens} tokens in {wall:.3f} s = "
          f"{res['tokens_per_s']:.1f} tok/s; {ticks} decode ticks, {chunks} "
          f"prefill passes; pure decode tick median "
          f"{res['decode_tick_ms_median']:.2f} ms over {len(step_ms)}; KV "
          f"cache {res['kv_bytes']} bytes; launches {counts}", flush=True)
    print(f"{tag}: TTFT ms by prompt length "
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
    print(f"{tag}: decode tick {dw['wall_ms_per_tick']:.2f} ms wall, "
          f"{dw['device_busy_ms_per_tick']:.2f} ms device busy, host share "
          f"{dw['host_share']}; {attn} "
          f"{dw['attention_ms_per_tick'][attn]:.4f} ms per tick", flush=True)
    for k, v in dw["top_kernels_ms_per_tick"]:
        print(f"{tag}:   {v:8.3f} ms/tick  {k}", flush=True)
    return res, [done[r] for r in rids]


SERVE_ENGINE = dict(max_slots=8, page_size=64, max_seq_len=2048,
                    prefill_chunk=512, seed=0, device=DEVICE)


def phase_serving():
    """Phase 4; returns its results, the model (reused by the int8 and
    incubate paths) and the greedy streams."""
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.models.llama import llama_preset

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
    eng = ContinuousBatchingEngine(model, max_new_tokens=new, **SERVE_ENGINE)
    res, streams = _serve(eng, cfg, new, "serving")
    del eng
    torch.cuda.empty_cache()
    return res, model, streams


def phase_serving_int8(model, exact, exact_streams):
    """Phase 4 again with int8_kv=True on the same model and requests."""
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine

    cfg = model.config
    new = 32
    eng = ContinuousBatchingEngine(model, max_new_tokens=new, int8_kv=True,
                                   **SERVE_ENGINE)
    check(eng.int8_kv, "int8_kv did not engage")
    res, streams = _serve(eng, cfg, new, "serving_int8")
    check(res["kv_bytes"] * 256 == exact["kv_bytes"] * 132,
          f"int8 KV bytes {res['kv_bytes']} != 132/256 of "
          f"{exact['kv_bytes']}")
    same = sum(a == b for s, e in zip(streams, exact_streams)
               for a, b in zip(s[-new:], e[-new:]))
    res["tokens_equal_to_exact_share"] = same / (new * len(streams))
    print(f"serving_int8: KV bytes {res['kv_bytes'] / exact['kv_bytes']:.6f}"
          f" of bf16 (132/256 = {132 / 256:.6f}); generated tokens equal to "
          f"the bf16 engine's streams: {same} of {new * len(streams)}",
          flush=True)
    del eng
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------------- incubate decoder
def incubate_params(model):
    """The decoder weights of a LlamaForCausalLM as the incubate decoder
    reads them."""
    core = model.model
    return {"layers": model._decode_params(),
            "embed": core.embed_tokens.weight,
            "fnorm": core.final_norm.weight,
            "head": (model.lm_head.weight if model.lm_head is not None
                     else core.embed_tokens.weight)}


def incubate_step(params, cfg, tokens, seq_lens, caches):
    """One token for each of B rows through the incubate fused ops: per
    layer fused_rms_norm (with the residual, but for the first norm of the
    token), q/k/v projections with the model's rope packed as
    [B, 3 * H * D], masked_multihead_attention over the layer's dense
    cache [2, B, H, MaxLen, D] at ``seq_lens``, the o projection,
    fused_rms_norm(residual=), swiglu and the down projection; then a
    final fused_rms_norm(residual=) and the head. Returns the logits."""
    from paddle_tpu_torch.incubate.nn.functional import (
        fused_rms_norm, masked_multihead_attention, swiglu)
    from paddle_tpu_torch.models.gpt import _rope_at_positions

    b, nh = tokens.shape[0], cfg.num_heads
    hd = cfg.hidden_size // nh
    x = params["embed"][tokens]                              # [B, H]
    resid = delta = None
    for lp, cache in zip(params["layers"], caches):
        if resid is None:
            h, resid = fused_rms_norm(x, lp["ln1"]), x
        else:
            h, resid = fused_rms_norm(delta, lp["ln1"], residual=resid)
        q, k = (_rope_at_positions(F.linear(h, w).reshape(b, 1, nh, hd),
                                   seq_lens).reshape(b, -1)
                for w in (lp["wq"], lp["wk"]))
        qkv = torch.cat([q, k, F.linear(h, lp["wv"])], -1)
        out, _ = masked_multihead_attention(qkv, cache,
                                            sequence_lengths=seq_lens)
        h2, resid = fused_rms_norm(F.linear(out, lp["wo"]), lp["ln2"],
                                   residual=resid)
        delta = F.linear(swiglu(F.linear(h2, lp["wg"]),
                                F.linear(h2, lp["wu"])), lp["wd"])
    xn, _ = fused_rms_norm(delta, params["fnorm"], residual=resid)
    return F.linear(xn, params["head"])


def incubate_generate(model, prompts, starts, new, max_len, step_ms=None):
    """Greedy streams of the incubate decoder. Row i joins at step
    ``starts[i]``, feeds its prompt one token per step, then its own
    argmax, until it holds ``new`` new tokens. Before it joins (and after
    it ends) a row writes a dummy token at position 0, which its first
    real step overwrites. Returns prompt + new tokens per row."""
    cfg = model.config
    check(cfg.num_kv_heads == cfg.num_heads,
          "masked_multihead_attention packs H heads for k and v (MHA)")
    dev = model.model.embed_tokens.weight.device
    params = incubate_params(model)
    hd = cfg.hidden_size // cfg.num_heads
    caches = [torch.zeros(2, len(prompts), cfg.num_heads, max_len, hd,
                          dtype=params["embed"].dtype, device=dev)
              for _ in params["layers"]]
    outs = [list(p) for p in prompts]
    steps = max(s + len(p) + new - 1 for s, p in zip(starts, prompts))
    with torch.inference_mode():
        for t in range(steps):
            live = [s <= t < s + len(p) + new - 1
                    for s, p in zip(starts, prompts)]
            pos = [t - s if on else 0 for s, on in zip(starts, live)]
            toks = [o[i] if on else 0 for o, i, on in zip(outs, pos, live)]
            t0 = time.perf_counter()
            logits = incubate_step(
                params, cfg, torch.as_tensor(toks, device=dev),
                torch.as_tensor(pos, dtype=torch.int32, device=dev), caches)
            nxt = logits.float().argmax(-1).tolist()
            if step_ms is not None:
                step_ms.append((time.perf_counter() - t0) * 1e3)
            for o, p, i, on, tok in zip(outs, prompts, pos, live, nxt):
                if on and i + 1 >= len(p):
                    o.append(tok)
    return outs, steps


def phase_incubate(model):
    """The incubate decoder at LLaMA-7B width and depth in bf16 over a
    dense [2, 8, 32, 2048, 128] cache per layer; launch counts per token."""
    from paddle_tpu_torch.ops import kernels

    cfg = model.config
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, 16).tolist()
               for _ in range(8)]
    starts = [4 * i for i in range(8)]
    new = 32
    step_ms = []
    incubate_generate(model, prompts[:1], [0], 2, 64)       # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    outs, steps = incubate_generate(model, prompts, starts, new, 2048,
                                    step_ms)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    L = cfg.num_layers
    want = {"decode_attention": L, "add_rms_norm": 2 * L, "rms_norm": 1}
    for name, per_token in want.items():
        check(counts[name] == per_token * steps,
              f"incubate: {name} launches {counts[name]} != {per_token} x "
              f"{steps} tokens")
    for o, p in zip(outs, prompts):
        check(len(o) == len(p) + new
              and all(0 <= t < cfg.vocab_size for t in o),
              f"incubate stream of {len(o)} tokens")
    res = {"rows": len(prompts), "starts": starts, "steps": steps,
           "wall_s": wall, "ms_per_token_median": statistics.median(step_ms),
           "ms_per_token_all": step_ms, "launches": counts,
           "launch_formula": "per token: decode_attention L, add_rms_norm "
                             f"2L, rms_norm 1; L = {L}"}
    print(f"incubate: 8 rows joining at steps {starts}, {steps} tokens in "
          f"{wall:.3f} s, median {res['ms_per_token_median']:.2f} ms per "
          f"token; launches {counts}; {res['launch_formula']}", flush=True)
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------- phase 5
def _staggered(eng, prompts):
    """Two requests, two steps, then the third; every stream by rid."""
    eng.submit(prompts[0])
    eng.submit(prompts[1])
    done = {}
    done.update(eng.step())
    done.update(eng.step())
    eng.submit(prompts[2])
    done.update(eng.run_until_complete())
    return done


CONSIST_ENGINE = dict(max_slots=2, page_size=64, max_seq_len=512, seed=0)


def phase_consistency():
    """f32, full width, depth 2: the engine on the card equals generate;
    returns the model for the int8 and incubate checks."""
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
    eng = ContinuousBatchingEngine(model, max_new_tokens=new,
                                   prefill_chunk=64, device=DEVICE,
                                   **CONSIST_ENGINE)
    done = _staggered(eng, prompts)
    for rid in range(3):
        check(done[rid] == want[rid],
              f"engine vs generate, request {rid}: {done[rid][-new:]} != "
              f"{want[rid][-new:]}")
    print("consistency: f32 depth-2 engine streams == generate on 3 "
          "prompts", flush=True)
    del eng
    torch.cuda.empty_cache()
    res = {"prompts": [len(p) for p in prompts], "new_tokens": new}
    return res, model, prompts, want


def phase_int8_consistency(model, prompts):
    """The int8 engine on the card equals the same engine on the CPU (the
    plain versions) token for token, under group and chunked prefill."""
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.ops import kernels

    cpu_model = LlamaForCausalLM(model.config, device="cpu",
                                 dtype=torch.float32)
    cpu_model.load_state_dict(model.state_dict())
    new = 8
    res = {}
    for chunk in (None, 64):
        streams = {}
        for dev, m in (("cpu", cpu_model), (DEVICE, model)):
            eng = ContinuousBatchingEngine(m, max_new_tokens=new,
                                           prefill_chunk=chunk, device=dev,
                                           int8_kv=True, **CONSIST_ENGINE)
            check(eng.int8_kv, "int8_kv did not engage")
            kernels.reset_launch_counts()
            streams[dev] = _staggered(eng, prompts)
            counts = kernels.launch_counts()
        L = model.config.num_layers
        check(counts["paged_attention_int8"] == L * eng.decode_ticks
              and counts["paged_attention"] == 0,
              f"int8 consistency launches {counts}")
        mode = "group" if chunk is None else "chunked"
        for rid in range(3):
            check(streams[DEVICE][rid] == streams["cpu"][rid],
                  f"int8 engine {mode} prefill, request {rid}: card "
                  f"{streams[DEVICE][rid][-new:]} != cpu "
                  f"{streams['cpu'][rid][-new:]}")
        res[mode] = {"streams": streams[DEVICE], "launches": counts}
        del eng
    print("int8 consistency: f32 depth-2 int8 engine on the card == on the "
          "CPU under group and chunked prefill, 3 prompts", flush=True)
    del cpu_model
    torch.cuda.empty_cache()
    return res


def phase_incubate_consistency(model, prompts, want):
    """f32, full width, depth 2: the incubate decoder's greedy streams
    equal generate, rows joining at staggered steps."""
    new = 8
    outs, _ = incubate_generate(model, prompts, [0, 3, 7], new, 256)
    for i, o in enumerate(outs):
        check(o == want[i], f"incubate vs generate, row {i}: {o[-new:]} != "
                            f"{want[i][-new:]}")
    print("incubate consistency: f32 depth-2 incubate decoder streams == "
          "generate on 3 prompts", flush=True)
    torch.cuda.empty_cache()
    return {"prompts": [len(p) for p in prompts], "new_tokens": new}

# ---------------------------------------------------------------- phase 6
#: the port's kernels as the profiler names them (the bf16 TMA/wgmma
#: forward, fused and split backward and swiglu_down, the first port's
#: bodies for f32, the rms_norm row kernel)
PORT_KERNEL_SYMBOLS = ("flash_fwd_wgmma", "flash_fwd_kernel",
                       "flash_bwd_wgmma", "flash_bwd_kernel",
                       "flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma",
                       "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
                       "swiglu_down_wgmma", "swiglu_down_kernel",
                       "rms_norm_kernel", "paged_attention_kernel")


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
    port = {}
    for k, v in by_kernel.items():
        name = next((n for n in PORT_KERNEL_SYMBOLS if n in k), None)
        if name is not None:
            groups["port_kernels"] += v / 1e3
            port[name] = port.get(name, 0.0) + v / 1e3
        elif any(n in k for n in ("nvjet", "gemm", "splitKreduce")):
            groups["gemm"] += v / 1e3
        else:
            groups["other"] += v / 1e3
    return {"device_busy_ms": busy / 1e3,
            "host_share": (1 - busy / 1e3 / wall_ms) if busy > 0 else None,
            "top_kernels_ms": [(k[:80], v / 1e3) for k, v in top],
            "by_group_ms": groups, "port_kernels_ms": port}


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
    # (at seq 2048 the router takes the fused backward)
    want = {"flash_attention_fwd": 2 * L, "flash_attention_bwd": L,
            "swiglu_down": 2 * L, "rms_norm": 4 * L, "paged_attention": 0,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0}
    formula = ("per step: flash_attention_fwd 2L, flash_attention_bwd L, "
               "swiglu_down 2L, rms_norm 4L, paged_attention 0, "
               f"flash_attention_bwd_dq/dkv 0; L = {L}, {timed} steps")
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
    print(f"training: port kernels ms/step "
          + json.dumps({k: round(v, 3) for k, v in
                        prof["port_kernels_ms"].items()}), flush=True)
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


# ---------------------------------------------------------------- phase 8
#: bench.py:84-85, the long-context line's selective remat
LONG_POLICY = "names:attn_res,attn_lse,attn_q,attn_k,attn_v,resid_mid"


def _long_config(num_layers, policy=LONG_POLICY):
    """GPT-3 1.3B at seq 32768 as bench.py:81-86 builds it on one device."""
    from paddle_tpu_torch.models.gpt import GPTConfig

    return GPTConfig(vocab_size=32000, hidden_size=2048,
                     num_layers=num_layers, num_heads=16, max_seq_len=32768,
                     dropout=0.0, dtype="bfloat16", recompute=True,
                     recompute_policy=policy)


def phase_long_context():
    """The long-context training line at full width, depth and length:
    GPTForCausalLMPipe under the names: policy -> chunked-CE loss ->
    AdamW(lr=3e-4) -> TrainStep, batch 1 x seq 32768."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTForCausalLMPipe
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.optimizer import AdamW

    cfg = _long_config(24)
    check((cfg.vocab_size, cfg.hidden_size, cfg.num_layers, cfg.num_heads,
           cfg.intermediate_size, cfg.tie_embeddings)
          == (32000, 2048, 24, 16, 5504, True), "long-context config")
    batch, seq, timed = 1, 32768, 3
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(4)
    model = GPTForCausalLMPipe(cfg, device=DEVICE,
                               dtype=torch.bfloat16).init_weights(gen,
                                                                  std=0.02)
    # bench.py:112-113: the reference's AdamW defaults (weight decay 0.01,
    # moments in the parameters' type, not factored)
    step = TrainStep(model, model.loss, AdamW(model.parameters(), lr=3e-4))
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in model.parameters())
    print(f"long_context: {nparams / 1e9:.4f} B params bf16, policy "
          f"{LONG_POLICY!r}, built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    # bench.py:125-131: ids and labels from default_rng(0)
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
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    L = cfg.num_layers
    # attn_res/attn_lse saved: the forward runs once per block; the rest
    # of each block is recomputed (its FFN and both norms run twice); the
    # router takes the split backward (dq scratch 16 MiB > 8 MiB)
    want = {name: 0 for name in counts}
    want.update({"flash_attention_fwd": L, "flash_attention_bwd_dq": L,
                 "flash_attention_bwd_dkv": L, "swiglu_down": 2 * L,
                 "rms_norm": 4 * L})
    formula = ("per step: flash_attention_fwd L, flash_attention_bwd_dq L, "
               "flash_attention_bwd_dkv L, flash_attention_bwd (fused) 0, "
               f"swiglu_down 2L, rms_norm 4L, the rest 0; L = {L}, {timed} "
               "steps")
    print(f"long_context: launches {counts}; {formula}", flush=True)
    for name, per_step in want.items():
        check(counts[name] == per_step * timed,
              f"long_context {name} launches {counts[name]} != {per_step} x "
              f"{timed}")
    check(all(np.isfinite(losses)), f"long_context losses {losses}")
    ln_v = float(np.log(cfg.vocab_size))
    check(ln_v - 0.1 <= losses[0] <= ln_v + 1.5,
          f"long_context first loss {losses[0]} outside [ln V - 0.1, "
          "ln V + 1.5]")
    check(losses[-1] < losses[0], f"long_context losses do not fall: "
                                  f"{losses}")
    health = step.last_health
    check(health.finite and health.ok, f"long_context health {health}")
    med = statistics.median(step_ms)
    tps = batch * seq / (med / 1e3)
    mfu = 6.0 * nparams * tps / PEAK_OPS[torch.bfloat16]
    res = {"config": "gpt3-1.3b at seq 32768 (bench.py:81-86)",
           "policy": LONG_POLICY, "params": nparams, "batch": batch,
           "seq": seq, "losses": losses, "warmup_step_ms": warm_ms,
           "step_ms": step_ms, "step_ms_median": med, "tokens_per_s": tps,
           "model_flops_share": mfu,
           "model_flops_formula": "6 * params * tokens_per_s / 989e12 "
                                  "(bench.py:157; H100 SXM dense bf16); it "
                                  "leaves out attention",
           "grad_norm": health.grad_norm, "peak_memory_gib": peak_gb,
           "launches": counts, "launch_formula": formula}
    print(f"long_context: losses {[round(x, 4) for x in losses]}",
          flush=True)
    print(f"long_context: step median {med:.1f} ms over {timed} "
          f"({[round(x, 1) for x in step_ms]}), warm-up {warm_ms:.0f} ms, "
          f"{tps:.0f} tokens/s, model-flops share {mfu:.4f} = "
          f"{res['model_flops_formula']}; peak memory {peak_gb:.1f} GiB",
          flush=True)
    res["profile"] = prof = _profile_step(step, (ids, labels), med)
    print(f"long_context: profiled step {prof['device_busy_ms']:.1f} ms "
          f"device busy, host share {prof['host_share']}; by group "
          + json.dumps({k: round(v, 2) for k, v in
                        prof["by_group_ms"].items()}), flush=True)
    for k, v in prof["top_kernels_ms"]:
        print(f"long_context:   {v:9.3f} ms/step  {k}", flush=True)
    print(f"long_context: port kernels ms/step "
          + json.dumps({k: round(v, 3) for k, v in
                        prof["port_kernels_ms"].items()}), flush=True)
    del step, model
    torch.cuda.empty_cache()
    return res


#: bf16 gradients of a leaf that is not the same bits under the two
#: policies: a library kernel whose sum order varies between runs (the
#: split flash backward repeats bit for bit, phase 3)
REMAT_GRAD_RTOL = 1e-2


def phase_long_context_remat():
    """bf16, full width, depth 2, seq 32768: step-1 loss and gradients
    under the names: policy equal those under full remat (both take the
    split backward); the flash forward launches L and 2L times."""
    from paddle_tpu_torch.models.gpt import GPTForCausalLMPipe
    from paddle_tpu_torch.ops import kernels

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(5)
    ids, labels = _train_batch(_long_config(2).vocab_size, 1, 32768, 0,
                               DEVICE)
    state, out = None, {}
    for policy in (LONG_POLICY, "full"):
        cfg = _long_config(2, policy)
        model = GPTForCausalLMPipe(cfg, device=DEVICE, dtype=torch.bfloat16)
        if state is None:
            state = model.init_weights(gen, std=0.02).state_dict()
        else:
            model.load_state_dict(state)
        kernels.reset_launch_counts()
        loss = model.loss(ids, labels)
        loss.backward()
        torch.cuda.synchronize()
        out[policy] = (loss.detach(), kernels.launch_counts(),
                       {n: p.grad for n, p in model.named_parameters()})
        del model
    L = 2
    for policy, fwd in ((LONG_POLICY, L), ("full", 2 * L)):
        c = out[policy][1]
        check((c["flash_attention_fwd"], c["flash_attention_bwd_dq"],
               c["flash_attention_bwd_dkv"], c["flash_attention_bwd"])
              == (fwd, L, L, 0), f"long_context_remat {policy}: launches {c}")
    (loss_n, _, g_n), (loss_f, _, g_f) = out[LONG_POLICY], out["full"]
    loss_bitwise = torch.equal(loss_n, loss_f)
    rel = {n: ((g_n[n].float() - g.float()).norm()
               / g.float().norm().clamp_min(1e-30)).item()
           for n, g in g_f.items()}
    not_bitwise = sorted(n for n, g in g_f.items()
                         if not torch.equal(g_n[n], g))
    print(f"long_context_remat: depth 2 seq 32768 bf16, loss {loss_n.item()}"
          f" (names:) vs {loss_f.item()} (full), bitwise {loss_bitwise}; "
          f"gradients bitwise except {not_bitwise}, max rel "
          f"{max(rel.values()):.3g} (tol {REMAT_GRAD_RTOL} where not "
          "bitwise); flash_attention_fwd launches L and 2L", flush=True)
    check(loss_bitwise, f"loss differs: {loss_n.item()} {loss_f.item()}")
    check(max(rel.values()) <= REMAT_GRAD_RTOL, f"grads differ: {rel}")
    del out
    torch.cuda.empty_cache()
    return {"loss": loss_n.item(), "loss_bitwise": loss_bitwise,
            "grads_not_bitwise": not_bitwise, "grad_rel_err": rel}


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
    report = {"phase_seconds": {}}

    def run(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        report["phase_seconds"][name] = time.perf_counter() - t
        print(f"phase {name}: {report['phase_seconds'][name]:.1f} s",
              flush=True)
        return out

    report["device"] = run("device", phase_device)
    report["build"] = run("build", phase_build)
    report["kernels"] = run("kernels", phase_kernels)
    if not args.quick:
        report["serving"], model, streams = run("serving", phase_serving)
        report["serving_int8"] = run("serving_int8", phase_serving_int8,
                                     model, report["serving"], streams)
        report["incubate"] = run("incubate", phase_incubate, model)
        del model
        torch.cuda.empty_cache()
        report["consistency"], model, prompts, want = run(
            "consistency", phase_consistency)
        report["int8_consistency"] = run(
            "int8_consistency", phase_int8_consistency, model, prompts)
        report["incubate_consistency"] = run(
            "incubate_consistency", phase_incubate_consistency, model,
            prompts, want)
        del model
        torch.cuda.empty_cache()
        report["training"] = run("training", phase_training)
        report["train_consistency"] = run("train_consistency",
                                          phase_train_consistency)
        report["long_context"] = run("long_context", phase_long_context)
        report["long_context_remat"] = run("long_context_remat",
                                           phase_long_context_remat)
    report["seconds"] = time.perf_counter() - t0
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    if args.quick:
        return 0
    src = "paddle_tpu_torch/ops/kernels/"
    pallas = "paddle_tpu/ops/pallas/"
    meta = {
        "paged_attention": ("cuda", src + "csrc/decode_split.cuh",
                            pallas + "decode_attention.py:336"),
        "rms_norm": ("cuda", src + "csrc/rms_norm.cu",
                     pallas + "rms_norm.py:43"),
        "flash_attention_fwd": ("cuda", src + "csrc/flash_attention.cu",
                                pallas + "flash_attention.py:248"),
        "flash_attention_bwd": ("cuda", src + "csrc/flash_attention.cu",
                                pallas + "flash_attention.py:581"),
        "swiglu_down": ("cuda", src + "csrc/swiglu_down.cu",
                        pallas + "swiglu_down.py:86"),
        "paged_attention_int8": ("cuda", src + "csrc/paged_attention_int8.cu",
                                 pallas + "decode_attention.py:267"),
        "decode_attention": ("cuda", src + "csrc/decode_split.cuh",
                             pallas + "decode_attention.py:105"),
        "add_rms_norm": ("cuda", src + "csrc/add_rms_norm.cu",
                         pallas + "add_rms_norm.py:48"),
        "flash_attention_bwd_dq": ("cuda",
                                   src + "csrc/flash_attention_split.cu",
                                   pallas + "flash_attention.py:515"),
        "flash_attention_bwd_dkv": ("cuda",
                                    src + "csrc/flash_attention_split.cu",
                                    pallas + "flash_attention.py:539"),
    }
    line = []
    for name, (route, source, replaces) in meta.items():
        # bf16 at the main path's shape: serving for the decode kernels,
        # the incubate decoder for add_rms_norm, long-context training for
        # the split backward, config 4 training for the others
        main_case = report["kernels"][name][0]
        by_path = {path: report[path]["launches"][name]
                   for path in ("serving", "serving_int8", "incubate",
                                "training", "long_context")}
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
