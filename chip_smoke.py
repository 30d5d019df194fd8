#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py [--out results.json] [--quick]

Phases, each of which fails the run on error:

1. device  - the card's name and power limit; fails without CUDA.
2. build   - nvcc builds ops/kernels/csrc/*.cu for sm_90a; Triton
             compiles the rms_norm kernel at its first launch.
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

The line before the last lists every kernel with its launch count on the
serving run; the last line is {"ok": true, "device": {...}}. ``--quick``
runs phases 1-3 only, with fewer repetitions, and prints no result line.
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

    secs = kernels.build(force=True)
    print(f"build: nvcc {secs:.2f} s", flush=True)
    from paddle_tpu_torch.ops.kernels.rms_norm import rms_norm_fwd

    x = torch.randn(8, 4096, device="cuda")
    t0 = time.perf_counter()
    rms_norm_fwd(x, torch.ones(4096, device="cuda"))
    torch.cuda.synchronize()
    tsecs = time.perf_counter() - t0
    print(f"build: triton rms_norm first launch {tsecs:.2f} s", flush=True)
    return {"nvcc_s": secs, "triton_first_launch_s": tsecs}


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


def phase_kernels():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = {"paged_attention": [], "rms_norm": []}
    for dtype in (torch.bfloat16, torch.float32):
        # LLaMA-7B decode: MHA; LLaMA-70B attention: GQA 64/8
        cases["paged_attention"].append(
            _paged_case(8, 32, 32, 128, 64, 2048, dtype, gen))
        cases["paged_attention"].append(
            _paged_case(8, 64, 8, 128, 64, 2048, dtype, gen))
        for n in (8, 2048):
            cases["rms_norm"].append(_rms_case(n, 4096, dtype, gen))
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
    report["seconds"] = time.perf_counter() - t0
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    if args.quick:
        return 0
    src = "paddle_tpu_torch/ops/kernels/"
    meta = {
        "paged_attention": ("cuda", src + "csrc/paged_attention.cu",
                            "paddle_tpu/ops/pallas/decode_attention.py:336"),
        "rms_norm": ("triton", src + "rms_norm.py",
                     "paddle_tpu/ops/pallas/rms_norm.py:43"),
    }
    line = []
    for name, (route, source, replaces) in meta.items():
        main_case = report["kernels"][name][0]     # bf16, the serving shape
        line.append({"name": name, "route": route, "source": source,
                     "replaces": replaces,
                     "launches": report["serving"]["launches"][name],
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
