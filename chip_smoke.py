#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py [--out results.json] [--quick]

Phases, each of which fails the run on error:

1. device  - the card's name and power limit; fails without CUDA.
2. build   - nvcc builds ops/kernels/csrc/*.cu for sm_90a (one nvcc per
             source, in parallel), with ptxas's registers and spills per
             source, per instance of every flash kernel (each padded
             width, bf16 and f32) and per instantiation of the rms_norm
             and add_rms_norm kernels and of the three decode kernels
             (none of which may spill).
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
   flash_widths - the four flash kernels at D = 64, 80, 96, 128 (phase
             3's config-4 rows), 192 and 256 in bf16 at [3, 2048, H, D]
             (H = 32 up to D = 96, GQA 32/8 at 96; 16 above), causal, and
             in f32 at [1, 256, 4/2, D]: each against its plain version
             (FLASH_TOL, lse 1e-3) with its ms, bound and SDPA's ms; the
             ptxas registers and spills of every flash instance; then one
             TrainStep of a two-layer GPTForCausalLMPipe at D = 96
             (Phi-3-mini's attention) and D = 256 (Gemma-2B's, 8 heads
             over 1 kv head), batch 1 x seq 2048: flash launches
             asserted, loss and gradients against the same step through
             the plain attention.
4. serving - LLaMA-7B width and depth in bf16, random weights from a
             seeded generator, through ContinuousBatchingEngine's warmup /
             submit / step / run_until_complete with chunked prefill; each
             decode tick is one replay of the engine's CUDA graph. Checks
             every request's token count and that the kernels' launch
             counts are 32 (paged attention) and 65 (rms norm) per decode
             tick; prints warmup's seconds (the capture), the tick's wall,
             device busy (profiler, and the graph's replay on CUDA events)
             and host share, the attention kernel's ms per tick, and one
             graphed tick against the eager _decode_step on the same state
             (tokens must be equal).
   serving_int8 - the same model, requests and engine with int8_kv=True:
             paged_attention_int8 32 times per decode tick and
             paged_attention never, the KV cache at exactly 132/256 of the
             bf16 bytes; reports the share of tokens equal to phase 4's.
   serving_engine - the same model: (a) phase 4's requests under
             preempt_policy="swap" in 74 pages, at least two swaps out and
             in, streams equal to phase 4's, swapped bytes and ms; (b) 8
             requests over one 1,024-token prefix (16 pages of 64), the
             first alone, with the prefix cache on and off: at least 7 x
             16 page hits, equal streams, TTFT per request both ways.
   serving_spec - the same model and requests on engines with
             spec_tokens=4: (a) a self-draft, (b) a small seeded draft
             (hidden 1024, 4 layers, 8 heads of 128, FFN 2816). Streams
             equal phase 4's; per spec tick paged_attention (K+1)(L+Ld)
             and rms_norm (2L+1) + K(2Ld+1) (the verify graph and the
             draft's proposal graph); acceptance, tokens a row per target
             pass, the spec tick's wall and busy and the two graphs'
             replays on CUDA events; on one state the verify's position-0
             logits equal the tick's (eager and graphed), and one verify
             replay equals the eager verify.
   serving_int8w - the same with int8_weights=True: the weight bytes by
             dtype (int8 codes half the bf16 projections, 4 bytes a column
             of f32 scales), the checks of phase 4, the GEMMs' ms per tick
             and the share of tokens equal to phase 4's.
   serving_disagg - phase 4's requests on a DisaggregatedEngine of 8
             prefill and 8 decode slots: streams equal phase 4's; handoffs,
             bytes and ms a handoff.
   serving_fleet - the same model: (a) a FleetRouter over two replicas
             of phase 4's engine (make_replicas, one model, the prefix
             cache on) serving phase 4's requests under round_robin,
             least_loaded and prefix_affinity: streams equal phase 4's,
             outcomes conserved, launches per tick per replica exactly
             paged_attention L and rms_norm 2L+1; tokens/s, TTFT, the
             router's host ms a step; (b) kill_replica(1) after three
             ticks: requeued onto replica 0, streams equal phase 4's, each
             token delivered once; (c) overload_block, replica 1 a
             flapping ChaosReplica, 48 requests of 128-512 tokens at twice
             (a)'s capacity: tools/bench_gate.py's overload gate clean,
             outcomes conserved, a breaker opened and no replica died, the
             brownout ladder engaged and restored, every served stream a
             prefix of a clean engine's.
   telemetry - the same model and requests with paddle_tpu_torch.
             telemetry: the graphed tick's wall, busy and host share with
             telemetry off and on (in turns, two batches each); phase 4's
             requests with telemetry and tracing on (streams equal phase
             4's, serving_steps_total equal to the steps, one admission,
             TTFT and latency sample a request, every request tree with
             queue, prefill, admitted and first_token, the tick's capture
             at the recompile watchdog); the self-draft spec engine's
             counters equal to its own; a traced config-4 TrainStep
             (step_anatomy, and the train_step span beside the step's
             CUDA-event time); Prometheus text, JSONL, snapshot, Perfetto
             and flight-bundle dumps under build/telemetry/, read by
             tools/telemetry_report.py, trace_report.py and
             flight_report.py (each must exit 0).
   incubate - the same model as a decoder built from the incubate fused
             ops (fused_rms_norm, masked_multihead_attention over a dense
             [2, 8, 32, 2048, 128] cache per layer, swiglu), 8 rows joining
             at staggered steps: decode_attention L, add_rms_norm 2L and
             rms_norm once per token.
   incubate_surface - the same model: (a) a paged decoder built from
             fused_rms_norm, fused_linear and block_multihead_attention
             over [MaxBlockNum, 32, 64, 128] caches serves phase 4's 8
             prompts for 32 new tokens: paged_attention L and rms_norm
             2L + 1 per decode step (the kernel reads the page-major cache
             in place), ms per token, new tokens equal to generate's as a
             reading (phase 5 holds the streams equal in f32);
             (b) FusedMultiTransformer at config 4's widths (FFN 8192,
             gelu, 24 layers) on [3, 2048] bf16: the non-causal flash
             forward L times, each layer within FLASH_TOL of the plain
             route from the same input; (c) a
             training step of 2 FusedTransformerEncoderLayers: the
             non-causal backward once a layer, gradients within FLASH_TOL
             of the plain route's; (d) fused_linear_cross_entropy at config
             4's head against the Pipe's head (1e-4), with ms; (e) the
             non-causal flash forward and backward alone with bound and
             SDPA's ms.
5. consistency - f32, full width, depth 2: the engine's greedy streams
             equal the dense-cache generate token for token; the int8
             engine on the card equals the same engine on the CPU under
             group and chunked prefill; the incubate decoder's streams
             equal generate; the engine on the card equals the CPU's under
             swap preemption and under the prefix cache; the paged decoder
             of incubate_surface (block_multihead_attention) serves phase
             4's prompts with generate's and the incubate decoder's
             streams; a GPTForCausalLMPipe and a tied LlamaForCausalLM on the same
             weights serve the same streams; spec streams (self-draft at
             acceptance exactly 1.0, and a small draft) on the card equal
             the CPU's and the plain engine's, int8-weight streams the
             CPU's, a DisaggregatedEngine's the single engine's, and prefix
             pages exported from one engine and imported into another give
             hits and the donor's streams; a two-replica FleetRouter on the
             card and on the CPU serve the single engine's streams.
   fleet_procs - LLaMA-7B width at 8 layers in bf16, weights built from
             a spec's seed: (a) FleetSupervisor(proc=True), two worker
             processes on the card, upgrade_block with a SIGKILL and a
             rolling upgrade: the upgrade gate clean, no lost or duplicate
             token, a respawn, streams equal an in-process engine's, the
             replica_death bundle read by tools/flight_report.py; spawn,
             warmup, respawn and migration times, RPC round trips; (b)
             partition_block over two local hosts (a TCPStore on
             localhost): the partition gate clean, the severed host's
             requests replayed, streams equal the in-process engine's.
6. training - GPT-3 1.3B (config 4) at full width and depth in bf16:
             GPTForCausalLMPipe -> chunked-CE loss (int8 logits, the
             card's gated default) -> AdamW(factored) ->
             TrainStep, batch 3 x seq 2048, one warm-up and 5 timed steps
             and one profiled step. Checks finite, falling losses that
             start near ln(vocab) and the launch counts per step. Then the
             trained Pipe serves 8 requests from its own parameters, takes
             one more step, reload_weights() and serves again: the streams
             change and equal a fresh engine's.
7. training consistency - f32, full width, depth 2: three TrainSteps on
             the card equal the same three on the CPU (plain versions),
             the CE head pinned to f32 logits on both.
   resilience - config 4 in bf16 at full width and depth, batch 3 x seq
             2048, with LinearWarmup(CosineAnnealingDecay), a global-norm
             clip and AdamW(factored) leaving the norms undecayed: four
             clean unguarded runs of 8 steps (their largest loss
             difference at a step is the card's run-to-run spread; the
             first two runs' difference is printed too); a guarded run
             (StepGuard over a CheckpointManager under build/ckpt/,
             keep=2, and a HangWatchdog) with committed saves after steps
             2 (sync) and 4 (async) and NaN gradients injected at step 5
             for two attempts: exactly one skip and one rollback, no byte
             of a parameter or slot changed by either discarded attempt,
             every byte equal to step 4's after the restore, the replayed
             step 5's loss equal to the discarded attempt's bit for bit,
             every loss within the spread of a clean run's, the launch
             counts of every attempt, and no watchdog fire; then a fresh
             model and optimizer restored from the newest committed step
             take step 5 to the same loss bit for bit. Prints the guarded
             and unguarded step medians, the checkpoint's bytes, snapshot
             and write-and-commit seconds (trace spans) and GB/s, and the
             restore seconds, beside the card's name and power limit;
             removes build/ckpt/.
   quant_train - config 4 as phase 6 builds it, 8 steps of one seeded
             batch per step number from the same seeded weights, three
             runs: (a) names:<bench.py's base saves>,resid_mid,ffn_gate,
             ffn_up with the head pinned to f32; (b) the same with
             quant:all (fp8 forward GEMMs, torch._scaled_mm, delayed
             scaling) and the default int8 head; (c) the all-int8 saves
             with quant:all. Checks gemm_dtype_mode 2 for wq wk wv wo wg
             wu and 0 for wd (swiglu_down owns it), the quant_gemm plan
             verdicts, loss_head_mode, quant_gemm_flops_total per step,
             the amax buffer after step 1, an armed NaN attempt leaving
             every byte of quant_amax, the launch counts per step, finite
             losses within 2% of (a)'s, the parity gate and the
             loss-drift probe on the card; prints step medians, peak
             memory, the relative drift per step, _scaled_mm and bf16
             matmul at config 4's projection shapes with their bounds,
             the quantize passes and the CE head's int8 and f32 times.
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
10. model_rest - the model files' one-card rest, bf16 at full width, 3
             AdamW(factored) TrainSteps of batch 3 x seq 2048 each:
             (a) config 5 at degree 1 (bench.py:253-257) through
             LlamaForCausalLMPipe (launches asserted, step median,
             tokens/s, model-flops share); (b) the GPT-3 architecture
             (LayerNorm, exact gelu, learned positions) at config 4's
             widths and depth through the per-layer GPTForCausalLM.loss
             (flash fwd 2L and bwd L, rms_norm 0); (c) config 4's Pipe
             with fused_addrms (add_rms_norm 2L, rms_norm 2L a step), with
             int8_ffn (swiglu_down 0) and unfused on one seeded state and
             batch: each seam's losses within 2% of the unfused run's;
             (e) that int8_ffn Pipe and its optimizer saved through
             CheckpointManager, restored into a per-layer GPTForCausalLM
             by restore_decoder_any_layout and back into a fresh Pipe:
             every converted tensor bytes-equal after the transpose, the
             next loss of both trees within phase 7's bound; (d)
             GPTForCausalLMMoE at config 4's width and depth, 8 experts
             of FFN width 5504, top 2, gshard, capacity factor 2: losses,
             aux loss, dropped (token, choice) pairs per layer, peak
             memory; (f) f32 depth 2, card against CPU for (b)'s variant
             and (d)'s MoE, phase 7's bounds. One more step of (a), (b)
             and (d) runs under the profiler (busy, host share, groups).
11. shared_block - config 4's widths and depth as a per-layer
             GPTForCausalLM whose layers run through the shared block, bf16,
             a warm-up and 3 timed AdamW(factored) steps of batch 3 x seq
             2048 under (a) full
             recompute, (b) phase 8's names: policy, (c) fused_addrms:
             launches a step asserted (flash fwd 2L or L, bwd L,
             swiglu_down 2L, rms_norm 4L + 1, or 2L + 1 with add_rms_norm
             2L), finite losses in phase 6's window; (a)'s first loss
             against the Pipe on the same weights, step medians, tokens/s
             and host share beside phase 6's, the down projections' copies
             a step; f32 depth 2: per-layer against the Pipe and card
             against CPU within phase 7's bounds.
12. paddle_surface - BERT-base pretraining (config 3 at degree 1: vocab
             30522, hidden 768, 12 layers, 12 heads, FFN 3072; dropout 0.1)
             at batch 32 x seq 512, a seeded batch a step, written only
             with ``import paddle_tpu_torch as paddle``, in this order:
             (f) the flash forward and fused backward at [32, 512,
             12/12, 64] non-causal in f32 and bf16 against their plain
             versions, with bounds and SDPA's forward and backward
             times; (e) depth 2, f32, 2 x 128, card against CPU within
             phase 7's bounds; (a) f32 eager ``loss.backward()``,
             ``opt.step()``, ``opt.clear_grad()`` with ``AdamW``, 3
             steps, flash forward 12 and fused backward 12 launches a
             step asserted, finite losses, then three steps on one
             repeated batch whose third loss is below the first (AdamW
             at 1e-4 without warmup can raise the first step's); the
             first loss beside ln V + ln 2, the step median, the ops a
             step and the host share of one profiled step; (c) an
             all-ones ``attention_mask`` against none in eval: 0 flash
             launches and the sequence output within FLASH_TOL; (b)
             ``model.bfloat16()`` through ``jit.TrainStep`` with
             ``AdamW(multi_precision=True)``, a warm-up and 3 timed
             steps, the same launches asserted: step median, tokens/s,
             model-flops share, host share, peak memory; (d) host
             microseconds per op through ``Tensor`` against raw torch
             (add, matmul, reshape, getitem, one Linear).
13. vision - configs 1 and 2 through ``import paddle_tpu_torch as
             paddle`` (no kernel of the port lies on this path: convs,
             pools and batch norms are plain PyTorch, cuDNN for the
             convs): (e) LeNet and resnet18 (4 classes, 2 x 3 x 64 x 64)
             one f32 train step each, card against CPU within phase 7's
             bounds and the running statistics within 1e-5, and the conv
             and pooling functionals at the reference's forms (groups,
             dilation, "SAME" at stride 2 in NCHW and NHWC, a transposed
             conv's output_size, exclusive and inclusive average pools,
             adaptive pools at sizes that do not divide), the pooling mask
             bitwise, under cudnn allow_tf32=False; (a) config 1: LeNet
             through ``Model.fit`` (Adam 1e-3, CrossEntropyLoss,
             Accuracy) on 256 separable FakeMNIST images, batch 64
             shuffled, 6 epochs, then ``evaluate`` on 128 held-out images
             (accuracy above 0.8) and ``predict``; (b) config 2 at degree
             1: ``vision.models.resnet50()`` (25.56 M parameters, f32,
             NCHW) at batch 256 x 3 x 224 x 224, a seeded batch a step,
             labels uniform over 1000, ``Momentum(0.1, 0.9,
             L2Decay(1e-4))`` through ``jit.TrainStep``: a warm-up and 3
             timed steps with cuDNN's default TF32 and again with it off,
             the first loss within 0.5 of ln 1000 + s^2 / 2 (s the spread
             of the first batch's logits), the running statistics moved
             and finite; step median, images/s, model-flops share (6 x
             conv and linear MACs x batch), host share, peak memory; (d)
             the same step fed by ``io.DataLoader`` over
             ``vision.datasets.FakeData`` (8 batches, a transform that
             calls ``paddle.to_tensor`` after ``Normalize``, 4 worker
             processes forked after CUDA started here): every batch on the
             card, the workers other processes, the labels in the
             sampler's order; the loader alone in images/s, the fed step
             median against the resident one, the host share and longest
             idle gap of one profiled fed step; (c) ``model.bfloat16()``
             (buffers too), the same step, a warm-up and 3 timed steps.

The line before the last lists every kernel with its launch counts on the
serving, int8 serving, spec, int8-weight, disaggregated and fleet
serving, incubate, incubate_surface, training, quant_train (run b),
long-context, model_rest, shared_block, paddle_surface and vision runs;
the last
line is {"ok": true, "device": {...}}.
``--quick`` runs phases 1-3 and flash_widths only, and prints no result
line.
"""
from __future__ import annotations

import argparse
import gc
import json
import re
import shutil
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
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
            torch.float8_e4m3fn: 1979e12, torch.int8: 1979e12}


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
#: by source: (name fragments, instantiations). Every flash kernel: in
#: flash_attention.cu the bf16 forward at the padded widths 64, 128, 192
#: and 256, the bf16 fused backward at 64 and 128 and its 192/256-column
#: kernel at 192 and 256, the f32 forward and fused backward at all four;
#: in flash_attention_split.cu the bf16 dq pass at all four, the bf16 dk/dv
#: pass at 64 and 128 and the 192/256-column kernel without dq at 192 and
#: 256, the f32 dq and dk/dv passes at all four. rms_norm_kernel for x f32
#: (1, 2, 4 or 8 chunks a thread) and bf16 (1, 2 or 4), each with an f32
#: and a bf16 weight; add_rms_norm_kernel for the same x layouts, each with
#: every mix of residual and weight types.
SPILL_CHECKED = {"flash_attention.cu": (("flash",), 16),
                 "flash_attention_split.cu": (("flash",), 16),
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


# ------------------------------------------------------- phase flash_widths
#: the flash kernels at every padded width: (D, q heads, kv heads) at
#: config 4's [3, 2048, H, D] (D = 128 is phase 3's config-4 row)
FLASH_WIDTHS = ((64, 32, 32), (80, 32, 32), (96, 32, 8), (192, 16, 16),
                (256, 16, 16))
#: the two-layer training steps at other head widths: Phi-3-mini's
#: attention (hidden 3072, 32 heads of 96; FFN 8192) and Gemma-2B's
#: (hidden 2048, 8 heads of 256 over 1 kv head; FFN 16384)
WIDTH_STEPS = {96: dict(hidden_size=3072, num_heads=32, num_kv_heads=32,
                        intermediate_size=8192),
               256: dict(hidden_size=2048, num_heads=8, num_kv_heads=1,
                         intermediate_size=16384)}
#: kernels against the plain attention in one bf16 step: the loss to 1e-3
#: of its value (the attention outputs agree to FLASH_TOL; two residual
#: layers and the CE head average them), each gradient to FLASH_TOL of its
#: norm (the p and ds roundings are the same, the sums' orders are not)
WIDTH_LOSS_RTOL = 1e-3


class _PlainFlash(torch.autograd.Function):
    """flash_attention's function through the kernels' plain versions
    (forward and backward), on any device: the reference step of the
    width checks."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        from paddle_tpu_torch.ops.kernels.flash_attention import (
            flash_attention_fwd_plain)

        o, lse = flash_attention_fwd_plain(q, k, v, True, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        from paddle_tpu_torch.ops.kernels.flash_attention import (
            flash_attention_bwd_plain)

        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_plain(q, k, v, o, lse,
                                               do.contiguous(), True,
                                               ctx.scale)
        return dq, dk, dv, None


def _plain_flash_attention(q, k, v, causal=True, scale=None):
    from paddle_tpu_torch.ops.kernels.flash_attention import from_bh, to_bh

    scale = 1.0 / float(q.shape[-1]) ** 0.5 if scale is None else scale
    o = _PlainFlash.apply(to_bh(q).contiguous(), to_bh(k).contiguous(),
                          to_bh(v).contiguous(), scale)
    return from_bh(o, q.shape[0])


def _width_step(d):
    """One TrainStep of a two-layer GPTForCausalLMPipe at head width d,
    batch 1 x seq 2048, bf16, from one seeded init: through the flash
    kernels (launch counts asserted), then on a fresh copy through the
    card's plain attention; the losses and every gradient compared."""
    import paddle_tpu_torch.models.gpt as gpt
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels.flash_attention import bwd_route

    cfg = GPTConfig(vocab_size=32000, num_layers=2, max_seq_len=2048,
                    dropout=0.0, dtype="bfloat16", recompute=True,
                    **WIDTH_STEPS[d])
    check(cfg.hidden_size // cfg.num_heads == d, f"head width {d}")
    ids, labels = _train_batch(cfg.vocab_size, 1, 2048, 5, DEVICE)
    out = {}
    for route in ("kernel", "plain"):
        model, step = _train_setup(cfg, torch.bfloat16, DEVICE, seed=3)
        kernels.reset_launch_counts()
        saved = gpt.flash_attention
        if route == "plain":
            gpt.flash_attention = _plain_flash_attention
        try:
            t0 = time.perf_counter()
            loss = step(ids, labels)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            gpt.flash_attention = saved
        out[route] = (loss.float().item(), ms, kernels.launch_counts(),
                      {n: p.grad.float().clone()
                       for n, p in model.named_parameters()})
        del model, step
        torch.cuda.empty_cache()
    L = cfg.num_layers
    rep = cfg.num_heads // cfg.num_kv_heads
    route = bwd_route(rep, 2048, d)
    counts = out["kernel"][2]
    want = {"flash_attention_fwd": 2 * L,
            "flash_attention_bwd": L if route == "fused" else 0,
            "flash_attention_bwd_dq": L if route == "split" else 0,
            "flash_attention_bwd_dkv": L if route == "split" else 0}
    check({k: counts[k] for k in want} == want,
          f"width {d}: flash launches {counts} != {want}")
    check(all(out["plain"][2][k] == 0 for k in want),
          f"width {d}: the plain step launched {out['plain'][2]}")
    lk, lp = out["kernel"][0], out["plain"][0]
    rel = {n: ((g - out["plain"][3][n]).norm()
               / out["plain"][3][n].norm().clamp_min(1e-30)).item()
           for n, g in out["kernel"][3].items()}
    worst = max(rel, key=rel.get)
    res = {"d": d, "heads": (cfg.num_heads, cfg.num_kv_heads),
           "hidden": cfg.hidden_size, "bwd_route": route,
           "loss_kernel": lk, "loss_plain": lp, "launches": counts,
           "step_ms_kernel": out["kernel"][1],
           "step_ms_plain": out["plain"][1],
           "grad_rel_err": rel}
    print(f"flash_widths: train step D={d} (hidden {cfg.hidden_size}, "
          f"heads {cfg.num_heads}/{cfg.num_kv_heads}, backward {route}): "
          f"loss {lk} kernels vs {lp} plain; gradients' largest relative "
          f"error {rel[worst]:.3g} ({worst}); first-step ms kernels "
          f"{out['kernel'][1]:.1f}, plain {out['plain'][1]:.1f}; flash "
          f"launches {want}", flush=True)
    check(abs(lk - lp) <= WIDTH_LOSS_RTOL * abs(lp),
          f"width {d}: loss {lk} != {lp}")
    check(rel[worst] <= FLASH_TOL[torch.bfloat16],
          f"width {d}: gradient {worst} rel err {rel[worst]}")
    return res


def phase_flash_widths(config4_rows, ptxas_logs):
    """The four flash kernels at every padded width (phase 3 holds
    D = 128 at config 4's shape): each against its plain version in bf16
    at [3, 2048, H, D] with its times, bound and SDPA's time, and in f32 at
    [1, 256, 4/2, D]; the ptxas registers and spills of every instance;
    then the two-layer training steps at D = 96 and 256."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    rows = {"flash_attention_fwd": [], "flash_attention_bwd": [],
            "flash_attention_bwd_dq": [], "flash_attention_bwd_dkv": []}
    for d, hq, hkv in FLASH_WIDTHS[:2] + ((128, 16, 16),) + FLASH_WIDTHS[2:]:
        for dtype, b, s, h, k in ((torch.bfloat16, 3, 2048, hq, hkv),
                                  (torch.float32, 1, 256, 4, 2)):
            if d == 128 and dtype == torch.bfloat16:
                cases = [next(r for r in config4_rows[n]
                              if r["shape"] == "[3,2048,16/16,128] causal"
                              and r["dtype"] == "bfloat16") for n in rows]
            else:
                fwd, bwd, (dq, dkv) = _flash_cases(b, h, k, s, d, dtype, gen)
                cases = [fwd, bwd, dq, dkv]
            for name, r in zip(rows, cases):
                r = dict(r, d=d)
                rows[name].append(r)
                print(f"flash_widths: {name} D={d} {r['dtype']} "
                      f"{r['shape']}: {r['ms']:.4f} ms (bound "
                      f"{r['bound_ms']:.4f} by {r['bound_by']}, SDPA "
                      f"{r['library_ms']:.4f}, plain {r['plain_ms']:.4f}) "
                      f"rel err {r['max_rel_err']:.3g}"
                      + (f", lse err {r['lse_max_abs_err']:.3g}"
                         if "lse_max_abs_err" in r else ""), flush=True)
    ptxas = {}
    for src in ("flash_attention.cu", "flash_attention_split.cu"):
        for name, (regs, spill) in sorted(
                ptxas_by_kernel(ptxas_logs[src], ("flash",)).items()):
            ptxas[name] = (regs, spill)
            print(f"flash_widths: ptxas {src} {name}: {regs} registers, "
                  f"{spill} bytes spilled", flush=True)
    check(all(spill == 0 for _, spill in ptxas.values()),
          "a flash kernel spills")
    steps = [_width_step(d) for d in WIDTH_STEPS]
    return {"cases": rows, "ptxas": ptxas, "train_steps": steps}


# ---------------------------------------------------------------- phase 4
def _random_model(cfg, dtype, seed):
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    return LlamaForCausalLM(cfg, device=DEVICE, dtype=dtype).init_weights(
        gen, std=0.02)


#: the projections' GEMM kernels as the profiler names them (cuBLAS's
#: Hopper kernels, split-K ones included, and the CUTLASS kernels it
#: takes for int8)
GEMM_SYMBOLS = ("gemm", "nvjet", "xmma", "cutlass")
#: of those, the int8 x int8 -> int32 ones
INT8_GEMM_SYMBOLS = ("gemm_s8", "s8s8", "imma")


def _decode_window(engine, ticks, replays=None):
    """``ticks`` pure decode ticks on the host clock, then ``ticks`` more
    under the profiler: device busy time (sum of kernel times), the time
    in each kernel and in the GEMMs. The host share is 1 - busy /
    unprofiled wall. Then each of ``replays`` (name -> a graph's replay;
    by default the tick's graph) ``ticks`` times back to back on CUDA
    events: the card's time for it (it rewrites the same KV rows with the
    same values)."""
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
        # a record_function range on the card's timeline (such as
        # torch.optim's "Optimizer.step#AdamW.step") spans kernels that
        # are counted on their own
        if ev.device_type == torch.autograd.DeviceType.CUDA and not getattr(
                ev, "is_user_annotation", False):
            dt = ev.time_range.elapsed_us()
            busy += dt
            by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + dt
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    attn = {name: sum(v for k, v in by_kernel.items() if sym in k) / 1e3
            / ticks for name, sym in ATTENTION_SYMBOLS.items()}
    gemm, int8_gemm = (sum(v for k, v in by_kernel.items()
                           if any(sym in k for sym in syms)) / 1e3 / ticks
                       for syms in (GEMM_SYMBOLS, INT8_GEMM_SYMBOLS))
    res = {"ticks": ticks, "wall_ms_per_tick": plain_wall * 1e3 / ticks,
           "attention_ms_per_tick": attn, "gemm_ms_per_tick": gemm,
           "int8_gemm_ms_per_tick": int8_gemm,
           "profiled_wall_ms_per_tick": wall * 1e3 / ticks,
           "device_busy_ms_per_tick": busy / 1e3 / ticks,
           "host_share": (1 - busy / 1e6 / plain_wall) if busy > 0 else None,
           "top_kernels_ms_per_tick": [(k[:80], v / 1e3 / ticks)
                                       for k, v in top]}
    for key, replay in (replays or
                        {"graph_replay_ms": engine._graph.replay}).items():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ticks):
            replay()
        end.record()
        end.synchronize()
        res[key] = start.elapsed_time(end) / ticks
    return res


SERVE_PROMPT_LENS = (128, 1024, 256, 896, 384, 768, 512, 640)


def _serve_prompts(cfg):
    """Phase 4's warm-up prompt and its 8 prompts, from a seeded rng."""
    rng = np.random.default_rng(0)
    warm = rng.integers(1, cfg.vocab_size, 80).tolist()
    return warm, [rng.integers(1, cfg.vocab_size, n).tolist()
                  for n in SERVE_PROMPT_LENS]


def _tick_inputs(eng):
    """The next decode tick's (tokens, lens, tables) as step() builds
    them."""
    eng._grow_pages()
    live = [r for r in eng._slots if r is not None and r.generated
            and r.length > 0 and not eng._finished(r)]
    rows = live + [live[0]] * (eng.max_slots - len(live))
    return (np.asarray([r.generated[-1] for r in rows], np.int32),
            np.asarray([r.length for r in rows], np.int32),
            eng._table_rows(rows))


@torch.inference_mode()
def _graph_vs_eager(eng):
    """One replay of the engine's decode graph against the eager
    _decode_step on the same state (the KV cells the tick writes are put
    back in between): tokens, written KV cells, logits."""
    tokens, lens, tables = _tick_inputs(eng)
    b = np.arange(len(lens))
    pages = torch.as_tensor(tables[b, lens // eng.page], device=DEVICE).long()
    offs = torch.as_tensor(lens % eng.page, device=DEVICE).long()
    leaves = [x for c in (eng.kc, eng.vc)
              for x in (c if isinstance(c, tuple) else (c,))]

    def cells():
        return [x[:, :, pages, offs].clone() for x in leaves]

    before = cells()
    eager = eng._decode_step(*(torch.as_tensor(a, device=DEVICE)
                               for a in (tokens, lens, tables))).clone()
    eager_cells = cells()
    for x, c in zip(leaves, before):
        x[:, :, pages, offs] = c
    graphed = eng._decode_logits(tokens, lens, tables).clone()
    kv_equal = all(torch.equal(a, c) for a, c in zip(cells(), eager_cells))
    return {"tokens_equal": torch.equal(graphed.argmax(-1),
                                        eager.argmax(-1)),
            "kv_equal": kv_equal,
            "logits_max_abs_diff": (graphed - eager).abs().max().item()}
@torch.inference_mode()
def _own_rows_tick(eng, reps=5, rounds=4):
    """On one state, the tick's graph captured at the batch's own row count
    (max_slots) and at the engine's shared GEMM row count, replayed in
    turns (``rounds`` x ``reps`` each, own first) on CUDA events; the
    median of each: what the shared row count costs. The replays rewrite
    the row the next tick writes."""
    tokens, lens, tables = _tick_inputs(eng)
    saved = (eng._graph, eng._graph_out, eng._graph_ptrs, eng._rows)
    graphs = {}
    try:
        for key, rows in (("own_rows", eng.max_slots),
                          ("engine_rows", eng._rows)):
            eng._graph, eng._rows = None, rows
            eng._decode_logits(tokens, lens, tables).cpu()   # capture
            graphs[key] = eng._graph
    finally:
        eng._graph, eng._graph_out, eng._graph_ptrs, eng._rows = saved
    samples = {k: [] for k in graphs}
    for _ in range(rounds):
        for key, graph in graphs.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                graph.graph.replay()
            end.record()
            end.synchronize()
            samples[key].append(start.elapsed_time(end) / reps)
    out = {f"{k}_replay_ms": statistics.median(v) for k, v in samples.items()}
    out["rows"] = (eng.max_slots, eng._rows)
    return out


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

    build_s = eng.warmup()
    print(f"{tag}: warmup (kernels, the decode tick's CUDA graph) "
          f"{build_s:.3f} s", flush=True)
    warm, prompts = _serve_prompts(cfg)
    # warm-up request (cuBLAS handles, allocator) outside the counted run
    eng.submit(warm)
    eng.run_until_complete()
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
    res = {"build_seconds": build_s, "wall_s": wall, "decode_ticks": ticks,
           "prefill_passes": chunks,
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
    res["graph_vs_eager"] = gve = _graph_vs_eager(eng)
    res["own_rows_tick"] = own = _own_rows_tick(eng)
    eng.run_until_complete()
    dw = res["decode_window"]
    print(f"{tag}: decode tick (one CUDA graph replay) "
          f"{dw['wall_ms_per_tick']:.2f} ms wall, "
          f"{dw['device_busy_ms_per_tick']:.2f} ms device busy (profiler), "
          f"{dw['graph_replay_ms']:.2f} ms a replay on CUDA events, host "
          f"share {dw['host_share']}; {attn} "
          f"{dw['attention_ms_per_tick'][attn]:.4f} ms per tick, GEMMs "
          f"{dw['gemm_ms_per_tick']:.4f} ms per tick", flush=True)
    print(f"{tag}: graphed tick against the eager _decode_step on the same "
          f"state: tokens equal {gve['tokens_equal']}, KV cells equal "
          f"{gve['kv_equal']}, logits' largest difference "
          f"{gve['logits_max_abs_diff']}", flush=True)
    check(gve["tokens_equal"], "graphed tick's tokens != eager tick's")
    print(f"{tag}: the tick's graph replay at its own {own['rows'][0]} rows "
          f"{own['own_rows_replay_ms']:.3f} ms, at the engine's "
          f"{own['rows'][1]} {own['engine_rows_replay_ms']:.3f} ms (CUDA "
          f"events, one state)", flush=True)
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


# ------------------------------------------------- phase 4 serving_engine
#: phase 4's prompts submitted in reverse order into a pool of 74 pages (80
#: are needed at the end): the growth pages run short twice, so two
#: requests are swapped out and back
SWAP_NUM_PAGES = 74
#: phase 4b: a 1,024-token shared prefix (16 pages of 64) and 8 tails
PREFIX_LEN = 1024
PREFIX_TAILS = (64, 96, 128, 160, 192, 224, 256, 80)


def _swap_timers(eng):
    """Wrap the engine's swap copies with synchronised host timers: bytes
    and ms out (index_select and the copy to pinned host memory) and in
    (the copy to the card and index_copy_)."""
    t = {"bytes_out": 0, "ms_out": 0.0, "bytes_in": 0, "ms_in": 0.0}
    gather, stage, scatter = (eng._swap_gather, eng._swap_stage,
                              eng._swap_scatter)

    def nbytes(kv):
        return sum(x.numel() * x.element_size() for c in kv
                   for x in (c if isinstance(c, tuple) else (c,)))

    def timed(fn, key):
        def run(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            t["ms_" + key] += (time.perf_counter() - t0) * 1e3
            if out is not None:
                t["bytes_" + key] += nbytes(out)
            return out
        return run

    eng._swap_gather = timed(gather, "out")
    eng._swap_stage = timed(stage, "in")
    eng._swap_scatter = timed(scatter, "in")
    return t


def _ttft_run(eng, groups):
    """Submit each group of prompts and run it to completion before the
    next; returns the streams in prompt order and each request's TTFT
    (submit to first token, host clock, ms)."""
    first_t, submit_t, out = {}, {}, []

    def on_token(rid, tok):
        first_t.setdefault(rid, time.perf_counter())

    for group in groups:
        rids = []
        for p in group:
            t = time.perf_counter()
            rids.append(eng.submit(p, on_token=on_token))
            submit_t[rids[-1]] = t
        done = eng.run_until_complete()
        out += [(done[r], (first_t[r] - submit_t[r]) * 1e3) for r in rids]
    return [o[0] for o in out], [o[1] for o in out]


def phase_serving_engine(model, streams):
    """LLaMA-7B width and depth in bf16 on phase 4's model: (a) phase 4's
    requests under swap preemption, (b) 8 requests over one 1,024-token
    prefix with the prefix cache on and off."""
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine

    cfg = model.config
    new = 32
    _, prompts = _serve_prompts(cfg)
    eng = ContinuousBatchingEngine(model, max_new_tokens=new,
                                   preempt_policy="swap",
                                   **dict(SERVE_ENGINE,
                                          num_pages=SWAP_NUM_PAGES))
    eng.warmup()
    swap = _swap_timers(eng)
    rids = [eng.submit(p) for p in reversed(prompts)]
    t0 = time.perf_counter()
    done = eng.run_until_complete()
    wall = time.perf_counter() - t0
    got = [done[r] for r in reversed(rids)]
    res = {"swap": dict(swap, swaps_out=eng.swaps_out, swaps_in=eng.swaps_in,
                        preemptions=eng.preemptions, wall_s=wall,
                        num_pages=SWAP_NUM_PAGES)}
    print(f"serving_engine: swap, {SWAP_NUM_PAGES} pages: {eng.swaps_out} "
          f"out, {eng.swaps_in} in, {eng.preemptions} preemptions; out "
          f"{swap['bytes_out']} bytes in {swap['ms_out']:.2f} ms, in "
          f"{swap['bytes_in']} bytes in {swap['ms_in']:.2f} ms; 8 requests "
          f"in {wall:.3f} s", flush=True)
    check(eng.swaps_in == eng.swaps_out >= 2,
          f"swaps out {eng.swaps_out}, in {eng.swaps_in}: want >= 2 each")
    check(eng.pool.available == eng.pool.num_pages, "swap run leaks pages")
    same = [a == b for a, b in zip(got, streams)]
    check(all(same), f"swap streams != phase 4's: {same}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    rng = np.random.default_rng(4)
    prefix = rng.integers(1, cfg.vocab_size, PREFIX_LEN).tolist()
    shared = [prefix + rng.integers(1, cfg.vocab_size, n).tolist()
              for n in PREFIX_TAILS]
    groups = [shared[:1], shared[1:]]    # the first registers the prefix
    runs = {}
    for cache in (False, True):
        eng = ContinuousBatchingEngine(model, max_new_tokens=new,
                                       enable_prefix_cache=cache,
                                       **SERVE_ENGINE)
        eng.warmup()
        t0 = time.perf_counter()
        out, ttft = _ttft_run(eng, groups)
        runs[cache] = {"streams": out, "ttft_ms": ttft,
                       "wall_s": time.perf_counter() - t0,
                       "prefill_passes": eng.prefill_chunk_steps,
                       "hits": eng.prefix_cache_hits,
                       "tokens_skipped": eng.prefix_tokens_skipped}
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    on, off = runs[True], runs[False]
    res["prefix"] = {"on": {k: v for k, v in on.items() if k != "streams"},
                     "off": {k: v for k, v in off.items()
                             if k != "streams"}}
    print(f"serving_engine: prefix cache, {PREFIX_LEN}-token prefix and "
          f"tails {list(PREFIX_TAILS)}: {on['hits']} page hits, "
          f"{on['tokens_skipped']} tokens skipped; prefill passes "
          f"{on['prefill_passes']} (off: {off['prefill_passes']}); wall "
          f"{on['wall_s']:.3f} s (off: {off['wall_s']:.3f} s)", flush=True)
    print("serving_engine: TTFT ms per request, cache on "
          + json.dumps([round(x, 1) for x in on["ttft_ms"]]) + ", off "
          + json.dumps([round(x, 1) for x in off["ttft_ms"]]), flush=True)
    check(on["hits"] >= 7 * PREFIX_LEN // 64,
          f"prefix cache hits {on['hits']} < {7 * PREFIX_LEN // 64}")
    same = [a == b for a, b in zip(on["streams"], off["streams"])]
    check(all(same), f"prefix cache streams != cache off: {same}")
    return res


# ------------------------------------------- phase 4 speculative decoding
#: the verify's window is K + 1 = 5 tokens a row
SPEC_K = 4
#: phase 4's small draft: LLaMA's vocabulary at a twentieth of its width
SMALL_DRAFT = dict(vocab_size=32000, hidden_size=1024, num_layers=4,
                   num_heads=8, intermediate_size=2816, max_seq_len=4096)


def _spec_inputs(eng):
    """The next spec tick's (prev, cur, lens, tables) as _spec_tick builds
    them."""
    eng._grow_pages()
    live = [r for r in eng._slots if r is not None and r.generated
            and r.length > 0 and not eng._finished(r)]
    rows = live + [live[0]] * (eng.max_slots - len(live))
    lens = np.asarray([r.length for r in rows], np.int32)
    ctx = [r.prompt + r.generated for r in rows]
    return (np.asarray([c[n - 1] for c, n in zip(ctx, lens)], np.int32),
            np.asarray([c[n] for c, n in zip(ctx, lens)], np.int32),
            lens, eng._table_rows(rows))


@torch.inference_mode()
def _spec_state_checks(eng):
    """On one state of a spec engine (the KV cells a window writes are put
    back after each pass): the verify's position-0 logits against the
    eager and the graphed tick's on the same inputs, at the engine's GEMM
    row count; the same pair with each forward at its own row count (a
    reading: what the shared row count is there for); one replay of the
    verify graph against the eager verify (tokens, KV cells)."""
    K = eng.spec_tokens
    prev, cur, lens, tables = _spec_inputs(eng)
    B = len(lens)
    pos = lens[:, None] + np.arange(K + 1)[None, :]
    pidx = np.minimum(pos // eng.page, eng.pages_per_seq - 1)
    pages = torch.as_tensor(np.take_along_axis(tables, pidx, 1).reshape(-1),
                            device=DEVICE).long()
    offs = torch.as_tensor((pos % eng.page).reshape(-1),
                           device=DEVICE).long()
    leaves = [x for c in (eng.kc, eng.vc)
              for x in (c if isinstance(c, tuple) else (c,))]

    def cells():
        return [x[:, :, pages, offs].clone() for x in leaves]

    before = cells()

    def restore():
        for x, c in zip(leaves, before):
            x[:, :, pages, offs] = c

    torch.cuda.synchronize()
    cur_t, lens_t, tables_t, prev_t = eng._inputs(cur, lens, tables, prev)
    d = eng._draft.propose(prev_t, cur_t, lens_t, tables_t).clone()

    def pos0_logits(rows):
        saved, eng._rows = eng._rows, rows
        try:
            toks = torch.cat([cur_t.long()[:, None], d], 1)
            lv = eng._logits(eng._window_hidden(toks, lens_t, tables_t))
            lv = lv[:B].float().clone()
            restore()
            lt = eng._decode_step(cur_t, lens_t, tables_t).clone()
            restore()
        finally:
            eng._rows = saved
        return lv, lt

    lv, lt = pos0_logits(eng._rows)
    lv1, lt1 = pos0_logits(1)
    graphed = []
    for _ in range(2):            # the first call may capture the graph
        torch.cuda.synchronize()
        graphed.append(eng._decode_logits(cur, lens, tables).clone())
        restore()
    eager = eng._verify_step(cur_t, d, lens_t, tables_t).clone()
    eager_cells = cells()
    restore()
    eng._draft._propose_out.copy_(d)
    eng._verify_graph.replay()
    replayed = eng._verify_out.clone()
    replay_cells = cells()
    restore()
    torch.cuda.synchronize()
    return {"pos0_equal_eager_tick": torch.equal(lv, lt),
            "pos0_equal_graphed_tick": torch.equal(lv, graphed[-1]),
            "own_rows_pos0_equal_tick": torch.equal(lv1, lt1),
            "own_rows_max_abs_diff": (lv1 - lt1).abs().max().item(),
            "own_rows_argmax_equal": torch.equal(lv1.argmax(-1),
                                                 lt1.argmax(-1)),
            "verify_graph_tokens_equal": torch.equal(replayed, eager),
            "verify_graph_kv_equal": all(
                torch.equal(a, b) for a, b in zip(replay_cells, eager_cells))}


def _serve_spec(eng, cfg, new, tag, want):
    """Phase 4's serving run on a speculative engine: the warm-up request,
    then the 8 staggered greedy requests, each step timed; checks the
    streams against phase 4's and the launches per spec tick; then a
    window of spec ticks on a second batch under the profiler, the two
    graphs' replays on CUDA events, and the state checks."""
    from paddle_tpu_torch.ops import kernels

    build_s = eng.warmup()
    warm, prompts = _serve_prompts(cfg)
    eng.submit(warm)
    eng.run_until_complete()
    names = ("spec_ticks", "spec_draft_tokens", "spec_accepted_tokens",
             "decode_ticks", "prefill_chunk_steps")
    base = {k: getattr(eng, k) for k in names}
    dp0 = eng._draft.prefill_batches
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rids = [eng.submit(p) for p in prompts[:5]]
    done, tick_ms = {}, []

    def timed_step():
        c0, s0 = eng.prefill_chunk_steps, eng.spec_ticks
        t = time.perf_counter()
        done.update(eng.step())
        torch.cuda.synchronize()
        if eng.prefill_chunk_steps == c0 and eng.spec_ticks == s0 + 1:
            tick_ms.append((time.perf_counter() - t) * 1e3)

    timed_step()
    timed_step()
    rids += [eng.submit(p) for p in prompts[5:]]
    while eng._waiting or any(s is not None for s in eng._slots):
        timed_step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    d = {k: getattr(eng, k) - base[k] for k in names}
    batches = eng._draft.prefill_batches - dp0
    got = [done[r] for r in rids]
    same = [a == b for a, b in zip(got, want)]
    check(all(same), f"{tag}: streams != phase 4's: {same}")
    check(d["decode_ticks"] == 0, f"{tag}: {d['decode_ticks']} plain ticks")
    L, Ld, K = cfg.num_layers, eng._draft.cfg.num_layers, eng.spec_tokens
    ticks, chunks = d["spec_ticks"], d["prefill_chunk_steps"]
    want_pa = (K + 1) * (L + Ld) * ticks
    want_rms = ((2 * L + 1) * (ticks + chunks) + K * (2 * Ld + 1) * ticks
                + 2 * Ld * batches)
    check(counts["paged_attention"] == want_pa
          and counts["paged_attention_int8"] == 0,
          f"{tag}: paged_attention {counts['paged_attention']} != (K + 1)"
          f"(L + Ld) x {ticks} spec ticks = {want_pa}")
    check(counts["rms_norm"] == want_rms,
          f"{tag}: rms_norm {counts['rms_norm']} != {want_rms}")
    rows = d["spec_draft_tokens"] // K          # rows verified
    gen = new * len(prompts)
    res = {"build_seconds": build_s, "wall_s": wall, "spec_ticks": ticks,
           "prefill_passes": chunks, "draft_prefill_batches": batches,
           "generated_tokens": gen, "tokens_per_s": gen / wall,
           "acceptance_rate": d["spec_accepted_tokens"]
           / d["spec_draft_tokens"],
           "tokens_per_target_pass": (gen - len(prompts)) / rows,
           "spec_tick_ms_median": statistics.median(tick_ms),
           "spec_tick_ms_all": tick_ms, "launches": counts,
           "launch_formula": "per spec tick: paged_attention (K+1)(L+Ld), "
                             "rms_norm (2L+1) + K(2Ld+1); per chunk pass "
                             "rms_norm 2L+1; per draft prefill 2Ld"}
    print(f"{tag}: build (warmup) {build_s:.3f} s; 8 requests, {gen} tokens "
          f"in {wall:.3f} s = {res['tokens_per_s']:.1f} tok/s; {ticks} spec "
          f"ticks, {chunks} prefill passes; acceptance "
          f"{res['acceptance_rate']:.4f}, {res['tokens_per_target_pass']:.3f}"
          f" tokens a row per target pass; spec tick median "
          f"{res['spec_tick_ms_median']:.2f} ms; launches {counts}",
          flush=True)
    # a second batch for the window, with room for 10 spec ticks of K + 1
    # tokens and the state checks (outside the counted run)
    eng.max_new_tokens = 96
    for p in prompts:
        eng.submit(p[:512])
    while any(s is None for s in eng._slots) or any(
            s.prefill_pos < len(s.seq_tokens) for s in eng._slots):
        eng.step()
    res["decode_window"] = dw = _decode_window(
        eng, 5, {"propose_replay_ms": eng._draft._propose_graph.replay,
                 "verify_replay_ms": eng._verify_graph.replay})
    res["state_checks"] = sc = _spec_state_checks(eng)
    eng.run_until_complete()
    print(f"{tag}: spec tick {dw['wall_ms_per_tick']:.2f} ms wall, "
          f"{dw['device_busy_ms_per_tick']:.2f} ms device busy, host share "
          f"{dw['host_share']}; propose replay {dw['propose_replay_ms']:.3f}"
          f" ms, verify replay {dw['verify_replay_ms']:.3f} ms on CUDA "
          f"events; paged_attention "
          f"{dw['attention_ms_per_tick']['paged_attention']:.4f} ms, GEMMs "
          f"{dw['gemm_ms_per_tick']:.4f} ms per spec tick", flush=True)
    for k, v in dw["top_kernels_ms_per_tick"]:
        print(f"{tag}:   {v:8.3f} ms/tick  {k}", flush=True)
    print(f"{tag}: one state: " + json.dumps(sc), flush=True)
    check(sc["pos0_equal_eager_tick"] and sc["pos0_equal_graphed_tick"],
          f"{tag}: the verify's position-0 logits != the tick's")
    check(sc["verify_graph_tokens_equal"] and sc["verify_graph_kv_equal"],
          f"{tag}: the verify graph's replay != the eager verify")
    return res


def phase_serving_spec(model, streams):
    """Phase 4's requests on engines with spec_tokens=4: (a) a self-draft,
    (b) a small seeded draft. Streams equal phase 4's."""
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.models.llama import LlamaConfig

    cfg = model.config
    new = 32
    small = _random_model(LlamaConfig(**SMALL_DRAFT), torch.bfloat16, seed=2)
    res = {}
    for name, draft in (("self", model), ("small", small)):
        eng = ContinuousBatchingEngine(model, max_new_tokens=new,
                                       draft_model=draft, spec_tokens=SPEC_K,
                                       **SERVE_ENGINE)
        res[name] = _serve_spec(eng, cfg, new, f"serving_spec ({name} "
                                f"draft)", streams)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    res["launches"] = {k: res["self"]["launches"][k]
                       + res["small"]["launches"][k]
                       for k in res["self"]["launches"]}
    del small
    torch.cuda.empty_cache()
    return res


# ------------------------------------------- phase 4 int8-resident weights
def phase_serving_int8w(model, exact, streams):
    """Phase 4 again with int8_weights=True: every projection is the int8
    x int8 -> int32 GEMM over codes and per-column scales."""
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine

    cfg = model.config
    new = 32
    eng = ContinuousBatchingEngine(model, max_new_tokens=new,
                                   int8_weights=True, **SERVE_ENGINE)
    check(eng.int8_weights, "int8_weights did not engage")
    proj = [w for lp in model._decode_params() for n, w in lp.items()
            if n not in ("ln1", "ln2")]
    proj_bytes = sum(w.numel() * w.element_size() for w in proj)
    cols = sum(w.shape[0] for w in proj)
    model_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    wb = eng.weight_bytes
    check(wb == {"int8": proj_bytes // 2, "float32": 4 * cols,
                 "bfloat16": model_bytes - proj_bytes},
          f"int8 weight bytes {wb}: want int8 {proj_bytes // 2}, float32 "
          f"{4 * cols}, bfloat16 {model_bytes - proj_bytes}")
    res, got = _serve(eng, cfg, new, "serving_int8w")
    res["weight_bytes"] = wb
    same = sum(a == b for s, e in zip(got, streams)
               for a, b in zip(s[-new:], e[-new:]))
    res["tokens_equal_to_exact_share"] = same / (new * len(got))
    dw = res["decode_window"]
    print(f"serving_int8w: weight bytes {wb} (bf16 projections "
          f"{proj_bytes}); int8 GEMMs {dw['int8_gemm_ms_per_tick']:.4f} ms "
          f"a tick, all GEMMs {dw['gemm_ms_per_tick']:.4f} (exact engine "
          f"{exact['decode_window']['gemm_ms_per_tick']:.4f});"
          f" generated tokens equal to the bf16 engine's: {same} of "
          f"{new * len(got)}", flush=True)
    del eng
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------ phase 4 disaggregation
def phase_serving_disagg(model, streams):
    """Phase 4's requests on a DisaggregatedEngine of 8 prefill and 8
    decode slots (the prefill passes keep phase 4's [8, 512] shape):
    streams equal phase 4's; handoffs, bytes and ms."""
    from paddle_tpu_torch.inference.fleet import DisaggregatedEngine
    from paddle_tpu_torch.ops import kernels

    cfg = model.config
    new = 32
    dis = DisaggregatedEngine(
        model, prefill_slots=8, decode_slots=8, page_size=64,
        max_seq_len=2048, max_new_tokens=new, prefill_chunk=512,
        device=DEVICE)
    build_s = dis.warmup()
    warm, prompts = _serve_prompts(cfg)
    dis.submit(warm)
    dis.run_until_complete()
    restore = _swap_timers(dis.decode)
    ext = {"ms": 0.0}
    extract = dis.prefill.extract

    def timed_extract(i):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = extract(i)
        ext["ms"] += (time.perf_counter() - t) * 1e3
        return r

    dis.prefill.extract = timed_extract
    h0, b0 = dis.handoffs, dis.handoff_bytes
    t0_ticks = dis.decode.decode_ticks
    c0 = dis.prefill.prefill_chunk_steps + dis.decode.prefill_chunk_steps
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rids = [dis.submit(p) for p in prompts[:5]]
    done = {}
    done.update(dis.step())
    done.update(dis.step())
    rids += [dis.submit(p) for p in prompts[5:]]
    done.update(dis.run_until_complete())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    got = [done[r] for r in rids]
    same = [a == b for a, b in zip(got, streams)]
    check(all(same), f"serving_disagg: streams != phase 4's: {same}")
    n = dis.handoffs - h0
    nbytes = dis.handoff_bytes - b0
    ticks = dis.decode.decode_ticks - t0_ticks
    chunks = (dis.prefill.prefill_chunk_steps
              + dis.decode.prefill_chunk_steps - c0)
    L = cfg.num_layers
    check(n == len(prompts), f"serving_disagg: {n} handoffs")
    check(counts["paged_attention"] == L * ticks
          and counts["rms_norm"] == (2 * L + 1) * (ticks + chunks),
          f"serving_disagg: launches {counts} for {ticks} decode ticks and "
          f"{chunks} prefill passes")
    gen = new * len(prompts)
    res = {"build_seconds": build_s, "wall_s": wall, "handoffs": n,
           "handoff_bytes": nbytes, "extract_ms": ext["ms"],
           "restore_ms": restore["ms_in"],
           "ms_per_handoff": (ext["ms"] + restore["ms_in"]) / n,
           "decode_ticks": ticks, "prefill_passes": chunks,
           "tokens_per_s": gen / wall, "launches": counts}
    print(f"serving_disagg: build {build_s:.3f} s; {n} handoffs, {nbytes} "
          f"bytes, {res['ms_per_handoff']:.2f} ms a handoff (extract "
          f"{ext['ms']:.2f} ms, restore {restore['ms_in']:.2f} ms in all); "
          f"{gen} tokens in {wall:.3f} s = {res['tokens_per_s']:.1f} tok/s; "
          f"{ticks} decode ticks, {chunks} prefill passes; launches "
          f"{counts}", flush=True)
    del dis
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------- serving fleet
FLEET_POLICIES = ("round_robin", "least_loaded", "prefix_affinity")
#: the overload scenario (c): 48 requests of 128-512 prompt tokens, 32 new
OVERLOAD_REQUESTS = 48
OVERLOAD_PROMPT_LENS = (128, 192, 256, 320, 384, 448, 512)
#: a TTFT SLO in simulated seconds far above any TTFT the run sees, so the
#: brownout pressure is the router's pending depth over shed_depth alone
#: (a TTFT-driven pressure rides the measured tick times and its recovery
#: is not deterministic)
OVERLOAD_TTFT_SLO = 1000.0
#: replica 1's flap: 12 clean steps, then 2 failing ones. A burst opens
#: its breaker at most twice (at the threshold of 2 failures, or at each
#: failing half-open probe), which is the bound the gate embeds; with 3
#: failing steps a burst that finds the breaker already half-open (an
#: idle replica) opens it three times
OVERLOAD_FLAP = (12, 2)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _bench_gate():
    import importlib.util

    path = Path(__file__).resolve().parent / "tools" / "bench_gate.py"
    spec = importlib.util.spec_from_file_location("bench_gate", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _route_run(router, prompts, device, kill=None):
    """Phase 4's schedule through a router: five requests, two fleet
    ticks, the other three, then ticks until it drains. Returns the
    streams in prompt order, the placement of each request, the tokens
    each stream callback saw, TTFT per request, and the router's own host
    ms per step (the step's wall minus the replicas' step times) with the
    simulated-parallel seconds (each tick costs its slowest replica plus
    the router, as fleet.soak's clock counts it). ``kill=(tick, idx)``
    kills a replica after that many ticks."""
    seen, first_t, submit_t, placed = {}, {}, {}, {}

    def on_token(rid, tok):
        seen[rid] = seen.get(rid, 0) + 1
        first_t.setdefault(rid, time.perf_counter())

    def submit(p):
        t = time.perf_counter()
        rid = router.submit(p, on_token=on_token)
        submit_t[rid] = t
        return rid

    def note():
        for rid, entry in router._inflight.items():
            placed[rid] = entry[0]

    done, host_ms, sim = {}, [], [0.0]

    def tick():
        busy0 = [h.busy_seconds for h in router.replicas]
        t = time.perf_counter()
        done.update(router.step())
        _sync(device)
        wall = time.perf_counter() - t
        deltas = [h.busy_seconds - b for h, b in zip(router.replicas, busy0)]
        host_ms.append((wall - sum(deltas)) * 1e3)
        sim[0] += max(deltas) + max(0.0, wall - sum(deltas))
        note()

    t0 = time.perf_counter()
    rids = [submit(p) for p in prompts[:5]]
    note()
    tick()
    tick()
    rids += [submit(p) for p in prompts[5:]]
    note()
    ticks = 2
    while not router.drained():
        tick()
        ticks += 1
        if kill is not None and ticks == kill[0]:
            router.kill_replica(kill[1], RuntimeError(
                f"chip_smoke: replica {kill[1]} killed"))
    _sync(device)
    wall = time.perf_counter() - t0
    return {"streams": [done[r] for r in rids],
            "placed": [placed.get(r) for r in rids],
            "seen": [seen.get(r, 0) for r in rids],
            "ttft_ms": [(first_t[r] - submit_t[r]) * 1e3 for r in rids],
            "wall_s": wall, "sim_s": sim[0], "router_steps": len(host_ms),
            "router_host_ms_per_step": statistics.median(host_ms),
            "router_host_ms_all": host_ms}


def phase_serving_fleet(model, streams, device=DEVICE, new=32,
                        engine_kw=None, prompts=None):
    """(a) FleetRouter over two replicas of phase 4's engine on the one
    model (make_replicas; the prefix cache on, so prefix_affinity has
    pages to follow), phase 4's requests under each policy: streams equal
    phase 4's, outcomes conserved, launches per tick per replica exactly
    paged_attention L and rms_norm 2L+1. (b) kill_replica(1) after three
    ticks: the requests requeue onto replica 0, streams equal phase 4's,
    every stream callback saw each token once. (c) overload_block over two
    replicas, replica 1 a flapping ChaosReplica, 48 requests at twice the
    capacity (a) measured on the soak's clock: the bench_gate overload
    gate clean, outcomes conserved, the breaker opened and no replica
    died, the brownout ladder engaged and back at 0, every served stream
    a prefix of a clean engine's. ``device``, ``engine_kw`` and
    ``prompts`` let a CPU run rehearse it on a small model."""
    from paddle_tpu_torch.inference.fleet import (FleetRouter, POLICIES,
                                                  build_workload,
                                                  overload_block)
    from paddle_tpu_torch.inference.fleet.overload import OverloadConfig
    from paddle_tpu_torch.inference.fleet.router import make_replicas
    from paddle_tpu_torch.inference.fleet.soak import overload_workload
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.testing.chaos import ChaosReplica

    cfg = model.config
    L = cfg.num_layers
    engine_kw = dict(SERVE_ENGINE if engine_kw is None else engine_kw,
                     device=device, max_new_tokens=new)
    if prompts is None:
        _, prompts = _serve_prompts(cfg)
    engines = make_replicas(lambda i: model, 2, enable_prefix_cache=True,
                            **engine_kw)
    build_s = [e.warmup() for e in engines]
    res = {"build_seconds": build_s, "policies": {}}

    def counters():
        return [(e.decode_ticks, e.prefill_chunk_steps) for e in engines]

    _sync(device)
    kernels.reset_launch_counts()
    c0 = counters()
    for policy in FLEET_POLICIES:
        router = FleetRouter(engines, policy=policy)
        k0 = counters()
        hits0 = [e.prefix_cache_hits for e in engines]
        run = _route_run(router, prompts, device)
        k1 = counters()
        check(run["streams"] == streams,
              f"serving_fleet {policy}: streams != phase 4's: "
              f"{[a == b for a, b in zip(run['streams'], streams)]}")
        out = router.outcomes()
        check(out["served"] == len(prompts) and out["pending"] == 0
              and out["inflight"] == 0 and out["cancelled"] == 0
              and out["shed"] == 0, f"serving_fleet {policy}: {out}")
        ticks = [b[0] - a[0] for a, b in zip(k0, k1)]
        gen = new * len(prompts)
        res["policies"][policy] = r = {
            "tokens_per_s": gen / run["wall_s"], "wall_s": run["wall_s"],
            "sim_s": run["sim_s"], "ttft_ms": run["ttft_ms"],
            "decode_ticks": ticks,
            "prefill_passes": [b[1] - a[1] for a, b in zip(k0, k1)],
            "placed": run["placed"], "dispatched": [h.dispatched for h in
                                                   router.replicas],
            "router_steps": run["router_steps"],
            "router_host_ms_per_step": run["router_host_ms_per_step"],
            "router_host_ms_all": run["router_host_ms_all"],
            "prefix_hits": [e.prefix_cache_hits - h
                            for e, h in zip(engines, hits0)],
            "outcomes": out}
        print(f"serving_fleet {policy}: {gen} tokens in {run['wall_s']:.3f} "
              f"s = {r['tokens_per_s']:.1f} tok/s (simulated-parallel "
              f"{run['sim_s']:.3f} s); decode ticks {ticks}, prefill passes "
              f"{r['prefill_passes']}; placed {run['placed']}; router host "
              f"{run['router_host_ms_per_step']:.3f} ms a step (median of "
              f"{run['router_steps']}); prefix hits {r['prefix_hits']}; "
              f"TTFT ms {[round(x, 1) for x in run['ttft_ms']]}", flush=True)
    _sync(device)
    counts = kernels.launch_counts()
    c1 = counters()
    ticks = sum(b[0] - a[0] for a, b in zip(c0, c1))
    chunks = sum(b[1] - a[1] for a, b in zip(c0, c1))
    attn = "paged_attention_int8" if engines[0].int8_kv else "paged_attention"
    # the CPU runs the plain versions, which count nothing
    check(torch.device(device).type != "cuda" or (
        counts[attn] == L * ticks
        and counts["rms_norm"] == (2 * L + 1) * (ticks + chunks)),
          f"serving_fleet: launches {counts} for {ticks} decode ticks and "
          f"{chunks} prefill passes over both replicas")
    res["launches"] = counts
    aff = res["policies"]["prefix_affinity"]
    check(aff["placed"] == res["policies"]["least_loaded"]["placed"]
          and sum(aff["prefix_hits"]) > 0,
          f"prefix_affinity: placed {aff['placed']}, hits "
          f"{aff['prefix_hits']}")

    # (b) requeue on death
    router = FleetRouter(engines, policy="least_loaded")
    run = _route_run(router, prompts, device, kill=(3, 1))
    check(run["streams"] == streams,
          "serving_fleet requeue: streams != phase 4's")
    check(run["seen"] == [new] * len(prompts),
          f"serving_fleet requeue: tokens seen per stream {run['seen']}")
    check(router.requeues > 0 and not router.replicas[1].healthy
          and set(run["placed"]) == {0},
          f"serving_fleet requeue: {router.requeues} requeues, placed "
          f"{run['placed']}")
    res["requeue"] = {"requeues": router.requeues, "wall_s": run["wall_s"],
                      "outcomes": router.outcomes()}
    print(f"serving_fleet requeue: replica 1 killed after 3 ticks, "
          f"{router.requeues} requests requeued onto replica 0, streams == "
          f"phase 4's, each token delivered once", flush=True)

    # (c) overload: the arrival rate is twice what (a) served a simulated
    # second (round_robin, both replicas busy)
    rr = res["policies"]["round_robin"]
    capacity = len(prompts) / rr["sim_s"]
    wl = overload_workload(capacity, OVERLOAD_REQUESTS, OVERLOAD_PROMPT_LENS,
                           cfg.vocab_size, rate_x_capacity=2.0,
                           batch_fraction=0.4, seed=11)
    # the clean run every served stream must be a prefix of: replica 0
    # (phase 4's engine with the prefix cache, which these random prompts
    # never hit), all 48 requests
    ref_rids = {engines[0].submit(p): tuple(p) for _, p, _ in wl}
    ref_done = engines[0].run_until_complete()
    ref = {p: ref_done[r] for r, p in ref_rids.items()}
    del router, engines
    gc.collect()
    torch.cuda.empty_cache()

    holder, routers = [], []

    class Recorded(ChaosReplica):
        """A ChaosReplica that keeps every completion it returns."""
        _OWN = ChaosReplica._OWN | {"outputs"}

        def step(self):
            out = super().step()
            self.outputs.update(out)
            return out

    def wrap(flap):
        def fn(e):
            holder.append(Recorded(e, flap=flap))
            holder[-1].outputs = {}
            return holder[-1]
        return fn

    def least_loaded(router, prompt, cands):
        # the stock policy under its own name; keeps the router at hand
        if not routers:
            routers.append(router)
        return POLICIES["least_loaded"](router, prompt, cands)

    # shedding holds the pending depth at or under shed_depth, so the
    # ladder steps down at a quarter of it
    depth = 2 * engine_kw["max_slots"]
    ov_cfg = OverloadConfig(
        ttft_slo=OVERLOAD_TTFT_SLO, admit_depth=2 * depth, shed_depth=depth,
        breaker_backoff=0.05, breaker_threshold=2, breaker_close_after=2,
        brownout_high=0.25, brownout_low=0.1, brownout_up_ticks=2,
        brownout_down_ticks=6)
    t0 = time.perf_counter()
    block = overload_block(
        model, replicas=2, workload=wl, overload_cfg=ov_cfg,
        policy=least_loaded, engine_kw=engine_kw,
        chaos_wrap={0: wrap(None), 1: wrap(OVERLOAD_FLAP)},
        shed_ceiling=0.9, rate_x_capacity=2.0)
    wall = time.perf_counter() - t0
    chaos = holder[1]
    block["breaker_flap_bound"] = 2 * (
        chaos.steps // sum(OVERLOAD_FLAP) + 1) + 2
    violations = _bench_gate().overload_violations({"overload": block})
    served = {**holder[0].outputs, **holder[1].outputs}
    prompts_c = [p for _, p, _ in wl]
    prefix_ok = all(
        ref[tuple(max((q for q in prompts_c if ids[:len(q)] == q),
                      key=len))][:len(ids)] == ids
        for ids in served.values())
    block["policy"] = "least_loaded"
    res["overload"] = dict(block, wall_s=wall, capacity_req_per_sim_s=capacity,
                           chaos={"flap": list(OVERLOAD_FLAP),
                                  "steps": chaos.steps,
                                  "faults": chaos.faults},
                           ttft_slo=OVERLOAD_TTFT_SLO, violations=violations)
    print(f"serving_fleet overload: {block['submitted']} submitted at 2x "
          f"{capacity:.3f} req/sim-s: served {block['served']}, cancelled "
          f"{block['cancelled']}, shed {block['shed']} "
          f"{block['shed_reasons']}, rejected {block['rejected']} "
          f"{block['reject_reasons']}; breaker opens "
          f"{block['breaker_opens']} (bound {block['breaker_flap_bound']}), "
          f"brownout {block['brownout']}; chaos faults {chaos.faults} of "
          f"{chaos.steps} steps; p99 TTFT {block['p99_ttft_seconds']} "
          f"sim-s; goodput {block['goodput_tokens_per_sec']} tok/sim-s; "
          f"{wall:.1f} s wall; gate {violations}", flush=True)
    check(violations == [], f"overload gate: {violations}")
    check(block["conserved"] and block["served"] + block["cancelled"]
          + block["shed"] + block["rejected"] == block["submitted"]
          == OVERLOAD_REQUESTS, f"overload conservation: {block}")
    check(block["breaker_opens"] >= 1 and chaos.faults > 0
          and all(h.healthy for h in routers[0].replicas),
          "overload: the breaker never opened, or a replica died")
    check(block["brownout"]["max_level"] >= 1
          and block["brownout"]["level"] == 0,
          f"overload: brownout {block['brownout']}")
    check(len(served) == block["served"] and prefix_ok,
          "overload: a served stream is not a prefix of the clean engine's")
    del holder, routers, served
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------------------ fleet procs
#: fleet_procs' replica: LLaMA-7B's width (hidden 4096, 32 heads of 128,
#: FFN 11008, vocabulary 32000) at 8 of its 32 layers, bf16: every spawn,
#: respawn and upgrade builds the weights anew in a fresh process
FLEET_PROC_CONFIG = dict(vocab_size=32000, hidden_size=4096, num_layers=8,
                         num_heads=32, num_kv_heads=32,
                         intermediate_size=11008, max_seq_len=4096,
                         dtype="bfloat16")
FLEET_PROC_ENGINE = dict(max_slots=8, page_size=64, max_seq_len=2048,
                         prefill_chunk=512, max_new_tokens=16, seed=0)
FLEET_DIR = Path(__file__).resolve().parent / "build" / "fleet"


def _timed(readings, fn):
    """``fn`` with its wall seconds appended to ``readings``."""
    def run(*a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        readings.append(time.perf_counter() - t)
        return out
    return run


def _recording(sup):
    """Every completion the supervisor's router returns, by rid."""
    done = {}
    step = sup.router.step

    def recorded():
        out = step()
        done.update(out)
        return out

    sup.router.step = recorded
    return done


def phase_fleet_procs(smi="", config_kw=None, engine_kw=None,
                      device=DEVICE, n_requests=16,
                      prompt_lens=(128, 256, 384, 512)):
    """(a) FleetSupervisor(spec, 2, proc=True): two worker processes on the
    card, each building the spec's weights (LLaMA-7B width at 8 layers,
    bf16) from its seed; upgrade_block with a SIGKILL at tick 2 and a
    rolling upgrade (version_seed_stride 0) from tick 5: the bench_gate
    upgrade gate clean, outcomes conserved, no lost or duplicate stream
    token, the upgrade complete, a respawn, streams equal to an
    in-process engine built from the same spec, and flight_report.py
    --quiet exits 0 on the replica_death bundle. Readings: each worker's
    spawn-to-ready and warmup seconds, the respawn's seconds, the
    migration's bytes and ms, the RPC ping and step round trips. (b)
    partition_block over two local hosts (agents in this process over the
    port's TCPStore on localhost), one replica each, host0 severed at
    tick 3: the partition gate clean, its requests replayed on host1, the
    streams those of the in-process engine. ``config_kw``, ``engine_kw``
    and ``device`` let a CPU run rehearse it small."""
    import shutil

    from paddle_tpu_torch import telemetry
    from paddle_tpu_torch.inference.fleet import (FleetSupervisor,
                                                  build_model_from_spec,
                                                  build_workload,
                                                  make_model_spec,
                                                  partition_block,
                                                  upgrade_block)
    from paddle_tpu_torch.inference.fleet import cluster, transport
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine

    config_kw = dict(config_kw or FLEET_PROC_CONFIG)
    engine_kw = dict(engine_kw or FLEET_PROC_ENGINE)
    shutil.rmtree(FLEET_DIR, ignore_errors=True)
    flight_dir = FLEET_DIR / "flight"
    spec = make_model_spec(config_kw, seed=0, engine_kw=engine_kw,
                           flight_dir=str(flight_dir), device=device)
    wl = build_workload(n_requests, 50.0, prompt_lens,
                        config_kw["vocab_size"], seed=5)
    t = time.perf_counter()
    model = build_model_from_spec(spec)
    _sync(device)
    build_s = time.perf_counter() - t
    nparams = sum(p.numel() for p in model.parameters())
    eng = ContinuousBatchingEngine(model, device=device, **engine_kw)
    rids = [eng.submit(p) for _, p, _ in wl]
    done = eng.run_until_complete()
    want = {i: done[r] for i, r in enumerate(rids)}
    del eng, model, done
    gc.collect()
    torch.cuda.empty_cache()
    print(f"fleet_procs: spec {nparams / 1e9:.3f} B params "
          f"{config_kw['dtype']}, built in process in {build_s:.1f} s; "
          f"{n_requests} requests served by the in-process engine",
          flush=True)
    from paddle_tpu_torch.inference.fleet import wire

    res = {"params": nparams, "in_process_build_s": build_s,
           "wire_codec": {wire.CODEC_MSGPACK: "msgpack",
                          wire.CODEC_STDLIB: "stdlib"}[wire.DEFAULT_CODEC]}
    gate = _bench_gate()

    # (a) process replicas: a kill, a respawn and a rolling upgrade
    spawn_s, warm_s, respawn_s, migrate_s = [], [], [], []
    hs, warm = cluster.ProcChild._handshake, transport.RemoteEngine.warmup
    cluster.ProcChild._handshake = _timed(spawn_s, hs)
    transport.RemoteEngine.warmup = _timed(warm_s, warm)
    rec = telemetry.flight.install(str(flight_dir))
    try:
        t = time.perf_counter()
        sup = FleetSupervisor(spec, 2, proc=True,
                              workdir=str(FLEET_DIR / "procs"))
        start_s = time.perf_counter() - t
        try:
            check(sup.proc and all(c.pid > 0 for c in sup.children.values()),
                  "fleet_procs: no worker processes")
            sup._spawn_replacement = _timed(respawn_s, sup._spawn_replacement)
            sup._migrate_off = _timed(migrate_s, sup._migrate_off)
            got = _recording(sup)
            t = time.perf_counter()
            blk = upgrade_block(sup, wl, version=1, upgrade_tick=5,
                                kill_tick=2)
            wall = time.perf_counter() - t
            live = next(h for h in sup.router.replicas
                        if h.healthy and not h.retired)
            rtt = {}
            for name, call in (("ping", live.engine.ping),
                               ("step", live.engine.step)):
                ms = []
                for _ in range(7):
                    t = time.perf_counter()
                    call()
                    ms.append((time.perf_counter() - t) * 1e3)
                rtt[name] = statistics.median(ms[2:])
        finally:
            sup.close()
    finally:
        cluster.ProcChild._handshake = hs
        transport.RemoteEngine.warmup = warm
        telemetry.flight.uninstall()
    deaths = [p for p in rec.bundle_paths() if "replica_death" in p]
    report = (subprocess.run(
        [sys.executable, str(Path(__file__).resolve().parent / "tools"
                             / "flight_report.py"), "--quiet", deaths[0]],
        capture_output=True, text=True, timeout=120).returncode
        if deaths else None)
    violations = gate.upgrade_violations({"upgrade": blk})
    up = blk["upgrade"]
    res["upgrade"] = dict(
        blk, wall_s=wall, supervisor_start_s=start_s,
        spawn_to_ready_s=spawn_s, warmup_s=warm_s, respawn_s=respawn_s,
        migrate_ms=[x * 1e3 for x in migrate_s], rpc_ms=rtt,
        death_bundles=len(deaths), flight_report_exit=report,
        violations=violations)
    print(f"fleet_procs upgrade: {blk['served']}/{blk['submitted']} served "
          f"in {wall:.1f} s; workers spawn-to-ready "
          f"{[round(x, 2) for x in spawn_s]} s (handshake: import, weights, "
          f"engine), warmup {[round(x, 2) for x in warm_s]} s, supervisor "
          f"start {start_s:.1f} s, respawn {[round(x, 2) for x in respawn_s]}"
          f" s; kill {blk['kill']}; upgrade complete {up['complete']} "
          f"upgraded {up['upgraded_replicas']}, migrated "
          f"{up['migrated_requests']} requests, {up['migration_bytes']} "
          f"bytes in {[round(x * 1e3, 1) for x in migrate_s]} ms; RPC "
          f"round trip ping {rtt['ping']:.3f} ms, idle step "
          f"{rtt['step']:.3f} ms; stream tokens duplicate "
          f"{blk['duplicate_stream_tokens']} lost "
          f"{blk['lost_stream_tokens']}; wire codec {res['wire_codec']}; "
          f"flight_report exit {report}; gate {violations}; {smi}",
          flush=True)
    check(violations == [], f"fleet_procs upgrade gate: {violations}")
    check(blk["conserved"] and blk["served"] == n_requests
          and blk["lost_requests"] == 0
          and blk["duplicate_stream_tokens"] == 0
          and blk["lost_stream_tokens"] == 0,
          f"fleet_procs upgrade outcomes: {blk}")
    check(up["complete"] and blk["kill"]["respawns"] >= 1,
          f"fleet_procs: upgrade {up}, kill {blk['kill']}")
    check({r: got.get(r) for r in want} == want,
          "fleet_procs: process fleet streams != the in-process engine's")
    check(report == 0, f"flight_report on {deaths}: exit {report}")

    # (b) two hosts, one partitioned away and healed
    got = None
    t = time.perf_counter()
    sup = FleetSupervisor(spec, 2, proc=False, hosts=2)
    try:
        got = _recording(sup)
        blk = partition_block(sup, wl, host="host0", sever_tick=3)
        requeues = sup.router.requeues
    finally:
        sup.close()
    wall = time.perf_counter() - t
    violations = gate.partition_violations({"partition": blk})
    res["partition"] = dict(blk, wall_s=wall, requeues=requeues,
                            violations=violations)
    part = blk["partition"]
    print(f"fleet_procs partition: {blk['served']}/{blk['submitted']} served "
          f"in {wall:.1f} s; host0 severed at tick {part['sever_tick']}, "
          f"healed {part['healed']} ({part['heal_tick']}); {requeues} "
          f"requests replayed, respawns {blk['respawns']}, adopted "
          f"{part['adopted_workers']}, lease epoch {part['lease_epoch']}; "
          f"stream tokens duplicate {blk['duplicate_stream_tokens']} lost "
          f"{blk['lost_stream_tokens']}; gate {violations}", flush=True)
    check(violations == [], f"fleet_procs partition gate: {violations}")
    check(blk["conserved"] and blk["served"] == n_requests
          and requeues > 0 and blk["respawns"] >= 1
          and part["host_severs"] == 1,
          f"fleet_procs partition: {blk}")
    check({r: got.get(r) for r in want} == want,
          "fleet_procs partition: streams != the in-process engine's")
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------------- incubate decoder
# ------------------------------------------------------- phase telemetry
TELEMETRY_DIR = Path(__file__).resolve().parent / "build" / "telemetry"


def _collect(on):
    """Telemetry and tracing on (emptied first) or off."""
    from paddle_tpu_torch import telemetry

    if on:
        telemetry.reset()
        telemetry.trace.reset()
        telemetry.enable()
        telemetry.trace.enable()
    else:
        telemetry.disable()
        telemetry.trace.disable()


def _tick_cost(eng, prompts, on):
    """A batch of phase 4's prompts (cut to 512 tokens) prefilled, then
    _decode_window's pure decode ticks with telemetry on or off."""
    _collect(on)
    for p in prompts:
        eng.submit(p[:512])
    while any(s is None for s in eng._slots) or any(
            s.prefill_pos < len(s.seq_tokens) for s in eng._slots):
        eng.step()
    res = _decode_window(eng, 10)
    eng.run_until_complete()
    _collect(False)
    return res


def _served_with_telemetry(eng, prompts):
    """Phase 4's schedule (five requests, two steps, three more) with
    telemetry and tracing on; returns the streams in prompt order and the
    number of step() calls."""
    rids = [eng.submit(p) for p in prompts[:5]]
    done, steps = {}, 0
    for _ in range(2):
        done.update(eng.step())
        steps += 1
    rids += [eng.submit(p) for p in prompts[5:]]
    while eng._waiting or any(s is not None for s in eng._slots):
        done.update(eng.step())
        steps += 1
    check(sorted(done) == sorted(rids), f"telemetry: completed {sorted(done)}")
    return [done[r] for r in rids], steps


def _check_serving_counters(snap, eng, steps, n, tag):
    c, h = snap["counters"], snap["histograms"]
    got = {"steps": c["serving_steps_total"].get("", 0),
           "admissions": c["serving_admissions_total"],
           "ttft": sum(v["count"] for v in
                       h["serving_ttft_seconds"].values()),
           "latency": sum(v["count"] for v in
                          h["serving_request_latency_seconds"].values())}
    want = {"steps": steps, "admissions": {"kind=prefill": n}, "ttft": n,
            "latency": n}
    print(f"telemetry: {tag}: counters {got}, engine {want}", flush=True)
    check(got == want, f"telemetry {tag}: counters {got} != {want}")
    check(snap["gauges"]["serving_int8_kv_active"] == {"": 0.0},
          "serving_int8_kv_active")
    return got


def _check_trees(tag):
    from paddle_tpu_torch import telemetry

    trees = telemetry.trace.request_trees()
    for rid, root in trees.items():
        kids = {k["name"] for k in root["children"]}
        marks = {m["name"] for m in root["marks"]}
        check(root["name"] == "request" and root["end"] is not None
              and {"queue", "prefill"} <= kids
              and {"admitted", "first_token"} <= marks,
              f"telemetry {tag}: request {rid} tree {kids} {marks}")
    return len(trees)


def _traced_train_step():
    """Config 4's TrainStep traced: a warm-up step with telemetry off,
    then two with telemetry and tracing on again (the serving readings
    kept), each timed on CUDA events beside its train_step span;
    step_anatomy of the two."""
    from paddle_tpu_torch import telemetry
    from paddle_tpu_torch.models.gpt import GPTConfig

    cfg = GPTConfig(vocab_size=32000, hidden_size=2048, num_layers=24,
                    num_heads=16, max_seq_len=2048, dropout=0.0,
                    dtype="bfloat16", recompute=True)
    model, step = _train_setup(cfg, torch.bfloat16, DEVICE, seed=0)
    ids, labels = _train_batch(cfg.vocab_size, 3, 2048, 0, DEVICE)
    telemetry.disable()
    telemetry.trace.disable()
    step(ids, labels)                       # warm-up, telemetry off
    torch.cuda.synchronize()
    # on again, keeping the spec run's readings for the dumps
    telemetry.enable()
    telemetry.trace.enable()
    event_ms = []
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(ids, labels)
        end.record()
        end.synchronize()
        event_ms.append(start.elapsed_time(end))
    spans = [e["dur"] * 1e3 for e in telemetry.trace.get_tracer().events()
             if e["name"] == "train_step"]
    anatomy = telemetry.trace.step_anatomy("train_step")
    print(f"telemetry: config-4 TrainStep: train_step span ms {spans} "
          f"(the host's dispatch of the step), CUDA-event step ms "
          f"{event_ms}; anatomy {json.dumps(anatomy)}", flush=True)
    check(anatomy is not None and anatomy["steps"] == 2
          and {"dispatch", "grad_clip", "opt_update"}
          <= set(anatomy["phases"]), f"train anatomy {anatomy}")
    del model, step
    torch.cuda.empty_cache()
    return {"train_step_span_ms": spans, "cuda_event_step_ms": event_ms,
            "anatomy": anatomy}


def _dump_and_report():
    """The Prometheus text, the JSONL and snapshot dumps, the Perfetto
    trace and one flight bundle, each read by the repo's report tool."""
    from paddle_tpu_torch import telemetry

    TELEMETRY_DIR.mkdir(parents=True, exist_ok=True)
    d = TELEMETRY_DIR
    prom = d / "metrics.prom"
    telemetry.export_prometheus(str(prom))
    telemetry.dump_jsonl(str(d / "metrics.jsonl"), mode="w")
    (d / "snapshot.json").write_text(json.dumps(telemetry.snapshot()))
    telemetry.trace.get_tracer().to_perfetto(str(d / "trace.json"))
    rec = telemetry.flight.install(str(d / "flight"))
    bundle = rec.dump("chip_smoke", force=True)
    telemetry.flight.uninstall()
    tools = Path(__file__).resolve().parent / "tools"
    rcs = {}
    for tool, args in (("telemetry_report.py", [str(d / "snapshot.json")]),
                       ("trace_report.py", [str(d / "trace.json")]),
                       ("flight_report.py", ["--quiet", bundle])):
        proc = subprocess.run([sys.executable, str(tools / tool), *args],
                              capture_output=True, text=True, timeout=120)
        rcs[tool] = proc.returncode
        print(f"telemetry: {tool}: exit {proc.returncode}; "
              + " | ".join(proc.stdout.strip().splitlines()[:4]), flush=True)
    check(all(rc == 0 for rc in rcs.values()), f"report tools: {rcs}")
    return {"prometheus_bytes": prom.stat().st_size, "tool_exit": rcs}


def phase_telemetry(model, streams):
    """Phase 4's LLaMA-7B engine with telemetry: the graphed tick's wall
    and host share with telemetry off and on (in turns, two batches
    each); phase 4's requests served with telemetry and tracing on
    (streams equal phase 4's, counters equal the engine's state, a full
    span tree per request, the captures at the recompile watchdog); the
    self-draft spec engine's counters against its own; a traced config-4
    TrainStep; the dumps and the repo's three report tools on them."""
    from paddle_tpu_torch import telemetry
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine

    cfg = model.config
    new = 32
    warm, prompts = _serve_prompts(cfg)
    out = {}
    # the tick's cost, off and on in turns
    eng = ContinuousBatchingEngine(model, max_new_tokens=new, **SERVE_ENGINE)
    eng.warmup()
    eng.submit(warm)
    eng.run_until_complete()
    cost = {"off": [], "on": []}
    for on in (False, True, False, True):
        cost["on" if on else "off"].append(_tick_cost(eng, prompts, on))
    out["tick"] = {k: {"wall_ms_per_tick": [r["wall_ms_per_tick"]
                                            for r in v],
                       "host_share": [r["host_share"] for r in v],
                       "device_busy_ms_per_tick":
                           [r["device_busy_ms_per_tick"] for r in v],
                       "graph_replay_ms": [r["graph_replay_ms"]
                                           for r in v]}
                   for k, v in cost.items()}
    off = statistics.mean(out["tick"]["off"]["wall_ms_per_tick"])
    on_ = statistics.mean(out["tick"]["on"]["wall_ms_per_tick"])
    out["tick"]["wall_change"] = on_ / off - 1
    print(f"telemetry: graphed decode tick wall ms off "
          f"{out['tick']['off']['wall_ms_per_tick']} on "
          f"{out['tick']['on']['wall_ms_per_tick']} ({100 * (on_ / off - 1):+.2f}"
          f"%); host share off {out['tick']['off']['host_share']} on "
          f"{out['tick']['on']['host_share']}; replay ms off "
          f"{out['tick']['off']['graph_replay_ms']} on "
          f"{out['tick']['on']['graph_replay_ms']}", flush=True)
    del eng
    torch.cuda.empty_cache()

    # phase 4's requests with telemetry and tracing on, from a fresh engine
    _collect(True)
    eng = ContinuousBatchingEngine(model, max_new_tokens=new, **SERVE_ENGINE)
    eng.warmup()
    got, steps = _served_with_telemetry(eng, prompts)
    check(got == streams, "telemetry: streams differ from phase 4's")
    snap = telemetry.snapshot()
    out["serving"] = _check_serving_counters(snap, eng, steps, len(prompts),
                                             "serving")
    out["serving"]["trees"] = _check_trees("serving")
    wd = telemetry.recompile_watchdog().stats()
    caps = snap["histograms"]["cuda_compile_seconds"]["event=graph_capture"]
    print(f"telemetry: recompile watchdog {wd}; graph captures "
          f"{caps['count']} in {caps['sum']:.3f} s", flush=True)
    check(wd.get("ContinuousBatchingEngine._decode_step") == 1,
          f"the tick's capture at the watchdog: {wd}")
    out["serving"]["watchdog"] = wd
    del eng
    torch.cuda.empty_cache()

    # the self-draft spec engine: its counters against its own state
    _collect(True)
    eng = ContinuousBatchingEngine(model, max_new_tokens=new,
                                   draft_model=model, spec_tokens=SPEC_K,
                                   **SERVE_ENGINE)
    eng.warmup()
    got, steps = _served_with_telemetry(eng, prompts)
    check(got == streams, "telemetry: spec streams differ from phase 4's")
    c = telemetry.snapshot()["counters"]
    spec = {"ticks": c["serving_spec_ticks_total"].get("mode=spec", 0),
            "drafted": c["serving_spec_draft_tokens_total"].get("", 0),
            "accepted": c["serving_spec_accepted_tokens_total"].get("", 0)}
    want = {"ticks": eng.spec_ticks, "drafted": eng.spec_draft_tokens,
            "accepted": eng.spec_accepted_tokens}
    rate = eng.spec_acceptance_rate
    print(f"telemetry: spec counters {spec}, engine {want}, acceptance "
          f"{rate:.4f} x drafted = {rate * spec['drafted']:.1f}", flush=True)
    check(spec == want and abs(spec["accepted"] - rate * spec["drafted"])
          < 1e-6 * max(1, spec["drafted"]), f"spec counters {spec} {want}")
    out["spec"] = dict(spec, acceptance=rate, trees=_check_trees("spec"))
    del eng
    torch.cuda.empty_cache()

    out["train"] = _traced_train_step()
    out["dumps"] = _dump_and_report()
    _collect(False)
    return out


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


def _serve_groups(eng, groups):
    """Run each group of prompts to completion before the next; the
    streams in prompt order."""
    out = []
    for group in groups:
        rids = [eng.submit(p) for p in group]
        done = eng.run_until_complete()
        out += [done[r] for r in rids]
    return out


def phase_engine_consistency(model, prompts):
    """f32, full width, depth 2: the engine on the card equals the same
    engine on the CPU under swap preemption (26 pages of 16: a swap out
    and back) and under the prefix cache (a 128-token shared prefix);
    GPTForCausalLMPipe and a tied LlamaForCausalLM carrying the same
    weights serve the same streams on the card, the Pipe from its own
    parameters."""
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.models.gpt import (BLOCK_PARAMS, GPTConfig,
                                             GPTForCausalLMPipe)
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_preset

    cpu_model = LlamaForCausalLM(model.config, device="cpu",
                                 dtype=torch.float32)
    cpu_model.load_state_dict(model.state_dict())
    system = prompts[1][:128]
    shared = [[system + prompts[0][:20]],
              [system + prompts[2][:30], system + prompts[0][:5]]]
    runs = {
        "swap": (dict(max_slots=3, page_size=16, max_seq_len=512,
                      num_pages=26, max_new_tokens=24,
                      preempt_policy="swap"),
                 lambda eng: _staggered(eng, prompts)),
        "prefix": (dict(max_slots=2, page_size=16, max_seq_len=512,
                        max_new_tokens=8, prefill_chunk=64,
                        enable_prefix_cache=True),
                   lambda eng: _serve_groups(eng, shared)),
    }
    res = {}
    for name, (kw, drive) in runs.items():
        out = {}
        for dev, m in (("cpu", cpu_model), (DEVICE, model)):
            eng = ContinuousBatchingEngine(m, device=dev, seed=0, **kw)
            out[dev] = (drive(eng), eng.swaps_out, eng.swaps_in,
                        eng.prefix_cache_hits, eng.pool.available)
            del eng
        check(out[DEVICE] == out["cpu"],
              f"{name}: the card's streams or counters differ from the "
              f"CPU's: {out[DEVICE][1:]} vs {out['cpu'][1:]}")
        res[name] = dict(zip(("swaps_out", "swaps_in", "prefix_cache_hits",
                              "free_pages"), out[DEVICE][1:]))
    check(res["swap"]["swaps_out"] >= 1, "swap run: no swap")
    check(res["prefix"]["prefix_cache_hits"] >= 2 * 128 // 16,
          f"prefix run: {res['prefix']['prefix_cache_hits']} hits")
    del cpu_model

    # the same weights as a tied Llama and as the training model
    c = model.config
    llama = LlamaForCausalLM(llama_preset("7b", num_layers=c.num_layers,
                                          tie_embeddings=True),
                             device=DEVICE, dtype=torch.float32)
    llama.load_state_dict({k: v for k, v in model.state_dict().items()
                           if not k.startswith("lm_head")})
    pipe = GPTForCausalLMPipe(GPTConfig(
        vocab_size=c.vocab_size, hidden_size=c.hidden_size,
        num_layers=c.num_layers, num_heads=c.num_heads,
        num_kv_heads=c.num_kv_heads, intermediate_size=c.intermediate_size,
        max_seq_len=c.max_seq_len, dtype="float32"), device=DEVICE)
    with torch.no_grad():
        pipe.embed_tokens.weight.copy_(llama.model.embed_tokens.weight)
        pipe.final_norm.weight.copy_(llama.model.final_norm.weight)
        for n, w in zip(BLOCK_PARAMS, (
                "input_norm", "attn.q_proj", "attn.k_proj", "attn.v_proj",
                "attn.o_proj", "post_attn_norm", "mlp.gate_proj",
                "mlp.up_proj", "mlp.down_proj")):
            per = [layer.get_submodule(w).weight for layer in
                   llama.model.layers]
            getattr(pipe.decoder, n).copy_(torch.stack(
                [p if p.dim() == 1 else p.t() for p in per]))
    streams = {}
    for name, m in (("llama", llama), ("pipe", pipe)):
        eng = ContinuousBatchingEngine(m, max_new_tokens=8, prefill_chunk=64,
                                       device=DEVICE, **CONSIST_ENGINE)
        streams[name] = _staggered(eng, prompts)
        if name == "pipe":
            d = pipe.decoder
            check(all(w.data_ptr() == getattr(d, n)[i].data_ptr()
                      for i, lp in enumerate(eng._weights["layers"])
                      for n, w in zip(BLOCK_PARAMS, lp)),
                  "the engine's weights are not views of the Pipe's")
        del eng
    check(streams["pipe"] == streams["llama"],
          "Pipe and tied Llama streams differ on the same weights")
    print(f"engine consistency: f32 depth 2, card == CPU under swap "
          f"({res['swap']['swaps_out']} out and in) and the prefix cache "
          f"({res['prefix']['prefix_cache_hits']} page hits); "
          f"GPTForCausalLMPipe == tied LlamaForCausalLM on the card, 3 "
          f"prompts, served from the Pipe's parameters", flush=True)
    del llama, pipe
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_fleet_consistency(model, prompts):
    """f32, full width, depth 2, card against CPU: speculative decoding
    with a self-draft (acceptance exactly 1.0) and with a small draft, each
    equal to the plain engine on the card; int8-resident weights; a
    two-replica FleetRouter on the card and on the CPU against the single
    engine; a DisaggregatedEngine against the single engine; prefix pages
    exported from one engine and imported into another (hits, equal
    streams)."""
    from paddle_tpu_torch.inference.fleet import (DisaggregatedEngine,
                                                  FleetRouter, make_replicas)
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    def on_cpu(m):
        c = LlamaForCausalLM(m.config, device="cpu", dtype=torch.float32)
        c.load_state_dict(m.state_dict())
        return c

    cpu_model = on_cpu(model)
    small = _random_model(LlamaConfig(**SMALL_DRAFT), torch.float32, seed=3)
    cpu_small = on_cpu(small)
    new = 8
    res = {}
    plain = _staggered(ContinuousBatchingEngine(
        model, max_new_tokens=new, device=DEVICE, **CONSIST_ENGINE), prompts)
    for name, drafts in (("self", (cpu_model, model)),
                         ("small", (cpu_small, small))):
        out = {}
        for dev, m, d in (("cpu", cpu_model, drafts[0]),
                          (DEVICE, model, drafts[1])):
            eng = ContinuousBatchingEngine(m, max_new_tokens=new,
                                           draft_model=d, spec_tokens=SPEC_K,
                                           device=dev, **CONSIST_ENGINE)
            out[dev] = (_staggered(eng, prompts), eng.spec_ticks,
                        eng.spec_acceptance_rate)
            del eng
        check(out[DEVICE][0] == out["cpu"][0] == plain,
              f"spec ({name} draft): card, CPU and plain streams differ")
        check(out[DEVICE][1] > 0, f"spec ({name} draft): no spec tick")
        if name == "self":
            check(out[DEVICE][2] == out["cpu"][2] == 1.0,
                  f"self-draft acceptance {out[DEVICE][2]} (card), "
                  f"{out['cpu'][2]} (CPU) != 1.0")
        res[f"spec_{name}"] = {"spec_ticks": out[DEVICE][1],
                               "acceptance_rate": out[DEVICE][2],
                               "cpu_acceptance_rate": out["cpu"][2]}
    del small, cpu_small
    out = {}
    for dev, m in (("cpu", cpu_model), (DEVICE, model)):
        eng = ContinuousBatchingEngine(m, max_new_tokens=new, prefill_chunk=64,
                                       int8_weights=True, device=dev,
                                       **CONSIST_ENGINE)
        check(eng.int8_weights, "int8_weights did not engage")
        out[dev] = _staggered(eng, prompts)
        del eng
    check(out[DEVICE] == out["cpu"], "int8 weights: card != CPU")
    res["int8w_tokens_equal_to_exact"] = sum(
        a == b for r in range(3)
        for a, b in zip(out[DEVICE][r][-new:], plain[r][-new:]))
    routed = {}
    for dev, m in (("cpu", cpu_model), (DEVICE, model)):
        router = FleetRouter(make_replicas(
            lambda i, m=m: m, 2, max_new_tokens=new, device=dev,
            **CONSIST_ENGINE), policy="round_robin")
        routed[dev] = _staggered(router, prompts)
        check([h.dispatched for h in router.replicas] == [2, 1],
              f"router on {dev}: dispatched "
              f"{[h.dispatched for h in router.replicas]}")
        del router
    check(routed[DEVICE] == routed["cpu"] == plain,
          "2-replica router: card, CPU and single-engine streams differ")
    res["router"] = {"replicas": 2, "policy": "round_robin"}
    del cpu_model
    single = _staggered(ContinuousBatchingEngine(
        model, max_new_tokens=new, prefill_chunk=64, device=DEVICE,
        **CONSIST_ENGINE), prompts)
    dis = DisaggregatedEngine(model, prefill_slots=2, decode_slots=2,
                              page_size=64, max_seq_len=512,
                              max_new_tokens=new, prefill_chunk=64,
                              device=DEVICE)
    check(_staggered(dis, prompts) == single,
          "disaggregated streams != the single engine's")
    res["disagg"] = {"handoffs": dis.handoffs,
                     "handoff_bytes": dis.handoff_bytes}
    del dis
    system = prompts[1][:128]
    warm = [system + prompts[0][:20]]
    probe = [system + prompts[2][:30], system + prompts[0][:5]]
    kw = dict(max_slots=2, page_size=16, max_seq_len=512, max_new_tokens=new,
              prefill_chunk=64, enable_prefix_cache=True, device=DEVICE)
    donor = ContinuousBatchingEngine(model, **kw)
    _serve_groups(donor, [warm])
    entries = donor.export_prefix_pages()
    peer = ContinuousBatchingEngine(model, **kw)
    imported = peer.import_prefix_pages(entries)
    got = _serve_groups(peer, [probe])
    check(got == _serve_groups(donor, [probe]),
          "imported prefix pages: streams != the donor's")
    check(imported == len(entries) >= 128 // 16
          and peer.prefix_cache_hits >= 2 * 128 // 16,
          f"prefix import: {imported} of {len(entries)} pages, "
          f"{peer.prefix_cache_hits} hits")
    res["prefix_import"] = {"exported": len(entries), "imported": imported,
                            "hits": peer.prefix_cache_hits}
    del donor, peer
    print(f"fleet consistency: f32 depth 2: spec streams (self and small "
          f"draft) card == CPU == the plain engine, self-draft acceptance "
          f"1.0; int8 weights card == CPU; 2-replica router card == CPU == "
          f"single engine; disaggregated == single engine "
          f"({res['disagg']['handoffs']} handoffs); prefix pages "
          f"{imported} imported, {res['prefix_import']['hits']} hits, "
          f"streams == the donor's", flush=True)
    gc.collect()
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

def phase_blha_consistency(model):
    """f32, full width, depth 2: the paged decoder of blha_generate serves
    phase 4's 8 prompts for 32 new tokens with the streams of generate and
    of the incubate decoder."""
    _, prompts = _serve_prompts(model.config)
    new = 32
    want = [model.generate(np.asarray([p]), max_new_tokens=new)[0].tolist()
            for p in prompts]
    inc, _ = incubate_generate(model, prompts, [0] * len(prompts), new,
                               max(len(p) for p in prompts) + new)
    got = blha_generate(model, prompts, new)
    for i, (g, w, c) in enumerate(zip(got, want, inc)):
        check(g == w, f"paged decoder vs generate, row {i}: {g[-new:]} != "
                      f"{w[-new:]}")
        check(g == c, f"paged decoder vs incubate decoder, row {i}: "
                      f"{g[-new:]} != {c[-new:]}")
    print("blha consistency: f32 depth-2 paged decoder streams == generate "
          "== incubate decoder on phase 4's 8 prompts, 32 new tokens",
          flush=True)
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


def _profile_step(step, batch, wall_ms, kernel_groups=None, repeat=1):
    """``repeat`` steps back to back under the profiler: device busy time
    (sum of kernel times), the host share against the unprofiled wall of
    those steps, the top 8 kernels by time (as _decode_window does for
    serving), and the busy time split into the port's kernels, cuBLAS
    GEMMs and everything else (elementwise, copies, reductions); with
    ``kernel_groups`` (group -> name fragments, the first match wins,
    "other" the rest) also that split. Also the union of the kernels'
    intervals and the longest gap between them on the card's timeline:
    across ``repeat`` > 1 steps that gap sees what the host does between
    steps (such as waiting for a loader's batch)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(repeat):
            step(*batch)
        torch.cuda.synchronize()
    busy = 0.0
    by_kernel = {}
    spans = []
    for ev in prof.events():
        # a record_function range on the card's timeline (such as
        # torch.optim's "Optimizer.step#AdamW.step") spans kernels that
        # are counted on their own
        if ev.device_type == torch.autograd.DeviceType.CUDA and not getattr(
                ev, "is_user_annotation", False):
            dt = ev.time_range.elapsed_us()
            busy += dt
            by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + dt
            spans.append((ev.time_range.start, ev.time_range.end))
    longest, union, end = 0.0, 0.0, None
    for s, e in sorted(spans):
        if end is not None and s > end:
            longest = max(longest, s - end)
        if end is None or s > end:
            union += e - s
            end = e
        elif e > end:
            union += e - end
            end = e
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
    out = {"device_busy_ms": busy / 1e3,
           "host_share": (1 - busy / 1e3 / wall_ms) if busy > 0 else None,
           "device_union_ms": union / 1e3, "longest_idle_ms": longest / 1e3,
           "top_kernels_ms": [(k[:80], v / 1e3) for k, v in top],
           "by_group_ms": groups, "port_kernels_ms": port}
    if kernel_groups is not None:
        split = dict.fromkeys(list(kernel_groups) + ["other"], 0.0)
        for k, v in by_kernel.items():
            name = next((g for g, frags in kernel_groups.items()
                         if any(f in k for f in frags)), "other")
            split[name] += v / 1e3
        out["by_kernel_group_ms"] = split
    return out


def _train_setup(cfg, dtype, device, seed, int8=None):
    """Config ``cfg`` with seeded weights, AdamW(factored) and a TrainStep
    over ``model.loss``; ``int8`` True or False pins the CE head's logits,
    None leaves them to the device's default (int8 on the card)."""
    import functools

    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTForCausalLMPipe
    from paddle_tpu_torch.optimizer import AdamW

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model = GPTForCausalLMPipe(cfg, device=device, dtype=dtype).init_weights(
        gen, std=0.02)
    opt = AdamW(model.parameters(), lr=3e-4, weight_decay=0.01,
                factored=True)
    return model, TrainStep(model, functools.partial(model.loss, int8=int8),
                            opt)


def _train_batch(vocab, batch, seq, seed, device):
    """Seeded random ids and labels, as bench.py:638-639 makes them."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
    labels = rng.integers(0, vocab, (batch, seq)).astype(np.int64)
    return (torch.as_tensor(ids, device=device).long(),
            torch.as_tensor(labels, device=device))


#: phase 6's serving of the trained model: 8 prompts of 64..512 tokens
TRAINED_PROMPT_LENS = (64, 128, 192, 256, 320, 384, 448, 512)


def _serve_trained(model, step, batch):
    """Serve 8 greedy requests from the trained GPTForCausalLMPipe (its
    parameters, not a copy), take one more TrainStep, reload_weights() and
    serve again: the streams change, and equal a fresh engine's on the
    updated model."""
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.models.gpt import BLOCK_PARAMS

    cfg = model.config
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in TRAINED_PROMPT_LENS]
    kw = dict(max_slots=8, page_size=64, max_seq_len=1024,
              prefill_chunk=512, max_new_tokens=16, device=DEVICE)
    eng = ContinuousBatchingEngine(model, **kw)
    d = model.decoder
    check(all(w.data_ptr() == getattr(d, n)[i].data_ptr()
              for i, lp in enumerate(eng._weights["layers"])
              for n, w in zip(BLOCK_PARAMS, lp))
          and eng._weights["embed"].data_ptr()
          == model.embed_tokens.weight.data_ptr(),
          "the engine's weights are not the Pipe's parameters")
    t0 = time.perf_counter()
    before = _serve_groups(eng, [prompts])
    serve_s = time.perf_counter() - t0
    graph = eng._graph
    # at the run's lr one step moves each weight by about 1.5% of its
    # scale, which need not flip a greedy token of a random model: this
    # step takes lr 1e-2, so the change is one the streams show
    groups = step.optimizer.param_groups
    lrs = [g["lr"] for g in groups]
    for g in groups:
        g["lr"] = 1e-2
    loss = step(*batch).item()
    for g, lr in zip(groups, lrs):
        g["lr"] = lr
    eng.reload_weights()
    kept = eng._graph is graph
    after = _serve_groups(eng, [prompts])
    fresh = _serve_groups(ContinuousBatchingEngine(model, **kw), [prompts])
    changed = sum(a != b for a, b in zip(after, before))
    print(f"training: served 8 requests from the trained Pipe in "
          f"{serve_s:.3f} s (zero-copy); one more step at lr 1e-2 (loss "
          f"{loss:.4f}), "
          f"reload_weights() kept the graph: {kept}; {changed} of 8 "
          f"streams changed; equal to a fresh engine's: {after == fresh}",
          flush=True)
    check(changed > 0, "the streams did not change after a training step")
    check(after == fresh, "reloaded engine != a fresh engine")
    return {"serve_s": serve_s, "graph_kept_on_reload": kept,
            "streams_changed": changed}


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
    res["serving"] = _serve_trained(model, step, (ids, labels))
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
    # the same head on both sides: f32 logits (the card's default is int8)
    cpu_model, cpu_step = _train_setup(cfg, torch.float32, "cpu", seed=1,
                                       int8=False)
    gpu_model, gpu_step = _train_setup(cfg, torch.float32, DEVICE, seed=1,
                                       int8=False)
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


# ---------------------------------------------------------- resilience
#: the guarded run: steps, the steps saved (sync, then async), the step
#: whose gradients are NaN and for how many attempts
RES_STEPS, RES_SAVES, RES_NAN_STEP, RES_NAN_COUNT = 8, (2, 4), 5, 2
#: clean runs that measure the run-to-run spread. The fused backward's dq
#: reduce-adds make each step's loss differ by a few 1e-4 from run to run
#: (config 4 on an H100 80GB HBM3 at 700 W). A third run falls outside the
#: spread of two at one of 7 steps about one time in four by chance (iid
#: normal noise, simulated); outside the spread of four about one time in
#: 100.
RES_CLEAN_RUNS = 4
#: the norm weights AdamW's apply_decay_param_fun leaves undecayed
RES_NO_DECAY = ("decoder.ln1", "decoder.ln2", "final_norm.weight")


def _res_setup(cfg, device, seed):
    """Config 4 as _train_setup builds it, with a schedule, a clip and
    the decay filter: AdamW(factored) over named parameters."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTForCausalLMPipe
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import (CosineAnnealingDecay,
                                               LinearWarmup)

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model = GPTForCausalLMPipe(cfg, device=device).init_weights(gen,
                                                                std=0.02)
    sched = LinearWarmup(CosineAnnealingDecay(3e-4, T_max=8),
                         warmup_steps=2, start_lr=0.0, end_lr=3e-4)
    opt = AdamW(model.named_parameters(), lr=sched, weight_decay=0.01,
                factored=True, grad_clip=ClipGradByGlobalNorm(1.0),
                apply_decay_param_fun=lambda n: n not in RES_NO_DECAY)
    return model, opt, sched, TrainStep(model, model.loss, opt)


def _res_tensors(model, opt):
    """Every parameter and optimizer slot, by name (live tensors)."""
    out = {}
    for n, p in model.named_parameters():
        out[n] = p
        for k, v in opt.state.get(p, {}).items():
            out[f"{n}.{k}"] = v
    return out


def _res_same(live, snap):
    """Names whose bytes differ between two {name: tensor} maps."""
    return sorted(n for n in snap if not torch.equal(
        live[n].detach().reshape(-1).view(torch.uint8),
        snap[n].reshape(-1).view(torch.uint8)))


def _hex32(v):
    return np.float32(v).tobytes().hex()


def phase_resilience(smi="", cfg=None, batch=3, seq=2048, device=DEVICE,
                     root=Path("build/ckpt")):
    """Config 4 (bf16, full width and depth, batch 3 x seq 2048) under
    LinearWarmup(CosineAnnealingDecay), ClipGradByGlobalNorm(1.0) and
    AdamW(factored) with the norms undecayed: (a) RES_CLEAN_RUNS clean
    unguarded runs of RES_STEPS steps from one seed (the largest loss
    difference among them at any step is the card's run-to-run spread;
    the first two runs' own difference is printed too); (b) a guarded
    run: StepGuard over a
    CheckpointManager (keep=2) with a HangWatchdog, committed saves after
    steps 2 (sync) and 4 (async), NaN gradients injected at step 5 for
    two attempts: one skip, one rollback to step 4, a replay to step 8;
    (c) a fresh model and optimizer restored from the newest committed
    step take one step. The batch of step s is _train_batch(seed=s).
    Tracing is on for the whole phase (the checkpoint's spans give the
    snapshot and write times), so both step medians carry its few spans.
    The checkpoint root is removed at the end, pass or fail. ``smi`` is
    the card's name and power limit, printed beside the readings; the
    other arguments let the same phase run at a small size on the CPU."""
    import shutil

    from paddle_tpu_torch.distributed.checkpoint import CHECKSUM_ALGO
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.telemetry import trace

    if cfg is None:
        cfg = GPTConfig(vocab_size=32000, hidden_size=2048, num_layers=24,
                        num_heads=16, max_seq_len=2048, dropout=0.0,
                        dtype="bfloat16", recompute=True)
    t_phase = time.perf_counter()
    batches = {s: _train_batch(cfg.vocab_size, batch, seq, s, device)
               for s in range(1, RES_STEPS + 1)}
    trace.enable()
    trace.reset()
    try:
        res = _resilience_runs(cfg, device, root, batches)
    finally:
        trace.disable()
        trace.reset()
        shutil.rmtree(root, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    snap_gbs = {s: round(v, 2) for s, v in res["snapshot_gb_per_s"].items()}
    print(f"resilience: {smi}: step median unguarded "
          f"{res['unguarded_step_ms_median']:.1f} ms, guarded "
          f"{res['guarded_step_ms_median']:.1f} ms (host clock, each ends "
          f"in a device read); checkpoint {res['checkpoint_bytes']} bytes "
          f"on disk ({res['state_bytes']} of tensors); snapshot s "
          f"{res['snapshot_s']} ({snap_gbs} GB/s); write and commit s "
          f"{res['write_commit_s']}; restore s "
          f"{res['rollback_restore_s']:.3f} (rollback), "
          f"{res['fresh_restore_s']:.3f} (fresh); checksum "
          f"{CHECKSUM_ALGO}; phase {res['seconds']:.1f} s (runs a, b, c: "
          + ", ".join(f"{v:.1f}" for v in res["part_seconds"].values())
          + ")", flush=True)
    return res


def _resilience_runs(cfg, device, root, batches):
    """The three runs of :func:`phase_resilience`; returns the readings."""
    from paddle_tpu_torch.distributed.checkpoint.manager import \
        CheckpointManager
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.resilience import HangWatchdog, StepGuard
    from paddle_tpu_torch.telemetry import trace
    from paddle_tpu_torch.testing import chaos

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    part_s = {"a": time.perf_counter()}

    # (a) clean unguarded runs
    clean, clean_ms = [], []
    for _ in range(RES_CLEAN_RUNS):
        model, opt, sched, step = _res_setup(cfg, device, 0)
        losses = []
        for s in range(1, RES_STEPS + 1):
            sched.step(s)
            t0 = time.perf_counter()
            losses.append(step(*batches[s]).item())
            clean_ms.append((s, (time.perf_counter() - t0) * 1e3))
        clean.append(losses)
        del model, opt, step
    spread = max(max(c) - min(c) for c in zip(*clean))
    two = max(abs(a - b) for a, b in zip(clean[0], clean[1]))
    print(f"resilience: (a) clean losses {clean}; largest difference of "
          f"the first two runs {two!r}, of all {RES_CLEAN_RUNS} {spread!r} "
          f"(the card's run-to-run spread)", flush=True)

    # (b) the guarded run
    part_s["b"] = time.perf_counter()
    model, opt, sched, step = _res_setup(cfg, device, 0)
    live = {}                 # every parameter and slot, once they exist
    mgr = CheckpointManager(str(root), keep=2)
    guard = StepGuard(step, manager=mgr, max_consecutive=2)
    saved, seen = {}, {}
    real_restore = mgr.restore_last_good

    def restore_checked(model_, opt_, before_step=None, strict=True):
        # the second discarded attempt changed nothing; then scribble over
        # every live tensor, so the restore has to write each byte
        seen["before_restore"] = _res_same(live, saved)
        with torch.no_grad():
            for t in live.values():
                t.fill_(float("nan") if t.is_floating_point() else 0)
        sync()
        t0 = time.perf_counter()
        restored = real_restore(model_, opt_, before_step=before_step,
                                strict=strict)
        sync()
        seen["rollback_restore_s"] = time.perf_counter() - t0
        seen["after_restore"] = _res_same(live, saved)
        return restored

    mgr.restore_last_good = restore_checked
    log, guarded_ms, save_calls = [], [], {}
    kernels.reset_launch_counts()
    with HangWatchdog(root / "debris") as wd, \
            chaos.inject_nonfinite(RES_NAN_STEP, kind="nan",
                                   count=RES_NAN_COUNT):
        gstep = 1
        while gstep <= RES_STEPS:
            sched.step(gstep)
            wd.step_started(gstep)
            t0 = time.perf_counter()
            out = guard(gstep, *batches[gstep])
            dt = (time.perf_counter() - t0) * 1e3
            wd.step_finished()
            log.append((gstep, out.action, out.health.loss))
            if out.accepted:
                guarded_ms.append((gstep, dt))
                if gstep in RES_SAVES:
                    t0 = time.perf_counter()
                    mgr.save_training_state(
                        gstep, model, opt,
                        async_save=gstep == RES_SAVES[-1])
                    save_calls[gstep] = time.perf_counter() - t0
                    if gstep == RES_SAVES[-1]:
                        live.update(_res_tensors(model, opt))
                        saved = {n: t.detach().clone()
                                 for n, t in live.items()}
            elif out.action == "skip":
                seen["after_skip"] = _res_same(live, saved)
            gstep = out.next_step
    mgr.wait()
    sync()
    counts = kernels.launch_counts()
    spans = [e for e in trace.events()
             if e["name"].startswith("ckpt:") and e["ph"] == "X"]
    committed = mgr.latest_step()
    ckpt_bytes = sum(f.stat().st_size
                     for f in Path(mgr.step_dir(committed)).iterdir())
    state_bytes = sum(t.numel() * t.element_size() for t in live.values())
    del saved
    print(f"resilience: (b) attempts {log}; skips {guard.skips}, "
          f"rollbacks {guard.rollbacks}; bytes changed by the skip "
          f"{seen.get('after_skip')}, by the second attempt "
          f"{seen.get('before_restore')}, differing from step "
          f"{RES_SAVES[-1]} after the restore {seen.get('after_restore')};"
          f" watchdog debris {wd.debris_files}", flush=True)
    check(guard.skips == 1 and guard.rollbacks == 1,
          f"skips {guard.skips}, rollbacks {guard.rollbacks}")
    check(seen.get("after_skip") == [] and seen.get("before_restore") == [],
          f"a discarded attempt changed {seen}")
    check(seen.get("after_restore") == [],
          f"restored state differs from step {RES_SAVES[-1]}: {seen}")
    check(not wd.debris_files, f"the hang watchdog fired: "
                               f"{wd.debris_files}")
    L, n = cfg.num_layers, len(log)
    if cuda:
        want = {"flash_attention_fwd": 2 * L * n,
                "flash_attention_bwd": L * n, "swiglu_down": 2 * L * n,
                "rms_norm": 4 * L * n}
        check(all(counts[k] == v for k, v in want.items()),
              f"guarded run launches {counts}, want {want} ({n} attempts)")
    guarded = {s: loss for s, action, loss in log if action == "accept"}
    first = next(loss for s, _, loss in log if s == RES_NAN_STEP)
    replay = guarded[RES_NAN_STEP]
    worst = max(min(abs(guarded[s] - c[s - 1]) for c in clean)
                for s in guarded)
    print(f"resilience: (b) losses {[guarded[s] for s in sorted(guarded)]};"
          f" step {RES_NAN_STEP}: discarded attempt {_hex32(first)}, replay"
          f" {_hex32(replay)}; largest distance to the nearest clean run "
          f"{worst!r} (spread {spread!r})", flush=True)
    check(_hex32(replay) == _hex32(first),
          f"replayed step {RES_NAN_STEP} loss {replay!r} != the discarded "
          f"attempt's {first!r}")
    check(worst <= spread, f"guarded losses {guarded} leave the clean "
                           f"runs' spread {spread}: {clean}")
    del model, opt, step, guard, live
    if cuda:
        torch.cuda.empty_cache()

    # (c) a fresh model and optimizer from the newest committed step
    part_s["c"] = time.perf_counter()
    model, opt, sched, step = _res_setup(cfg, device, 1)
    sync()
    t0 = time.perf_counter()
    restored = mgr.restore_training_state(model, opt)
    sync()
    fresh_restore_s = time.perf_counter() - t0
    sched.step(restored + 1)
    resumed = step(*batches[restored + 1]).item()
    print(f"resilience: (c) restored step {restored} into a fresh model "
          f"in {fresh_restore_s:.3f} s; step {restored + 1} loss "
          f"{_hex32(resumed)} against the guarded run's "
          f"{_hex32(guarded[restored + 1])}", flush=True)
    check(restored == RES_SAVES[-1], f"restored step {restored}")
    check(_hex32(resumed) == _hex32(guarded[restored + 1]),
          f"resumed loss {resumed!r} != {guarded[restored + 1]!r}")
    del model, opt, step
    mgr.close()
    if cuda:
        torch.cuda.empty_cache()

    part_s["end"] = time.perf_counter()
    part_s = {k: part_s[n] - part_s[k] for k, n in
              (("a", "b"), ("b", "c"), ("c", "end"))}

    def med(rows):
        return statistics.median(ms for s, ms in rows if s > 1)

    snap = {e["attrs"]["step"]: e["dur"] for e in spans
            if e["name"] == "ckpt:snapshot"}
    write = {e["attrs"]["step"]: e["dur"] for e in spans
             if e["name"] == "ckpt:write_commit"}
    return {"clean_losses": clean, "spread": spread, "spread_of_two": two,
            "guarded_losses": guarded, "attempts": log,
            "unguarded_step_ms_median": med(clean_ms),
            "guarded_step_ms_median": med(guarded_ms),
            "checkpoint_bytes": ckpt_bytes, "state_bytes": state_bytes,
            "save_call_s": save_calls, "snapshot_s": snap,
            "snapshot_gb_per_s": {s: state_bytes / d / 1e9
                                  for s, d in snap.items()},
            "write_commit_s": write,
            "rollback_restore_s": seen["rollback_restore_s"],
            "fresh_restore_s": fresh_restore_s, "launches": counts,
            "skips": 1, "rollbacks": 1, "part_seconds": part_s}


# ---------------------------------------------------------- quant_train
#: bench.py's base_saves (``rms_rstd`` saves nothing on the port's route)
QT_BASE = "attn_res,attn_lse,attn_q,attn_k,attn_v,rms_rstd"
#: the three runs: (policy, head). (a) bench.py's r5 row with the head
#: pinned to f32; (b) the same with quant:all; (c) the planner grid's
#: all-int8 row with quant:all; the head of (b) and (c) is the default
QT_RUNS = {
    "a": (f"names:{QT_BASE},resid_mid,ffn_gate,ffn_up", False),
    "b": (f"names:{QT_BASE},resid_mid,ffn_gate,ffn_up,quant:all", None),
    "c": (f"names:{QT_BASE},int8:resid_mid,int8:ffn_gate,int8:ffn_up,"
          "quant:all", None),
}
QT_STEPS = 8
#: each loss of (b) and (c) against (a)'s at the same step: the
#: reference's end-to-end bound for int8 saves (tests/test_memory.py:
#: 113-122)
QT_LOSS_RTOL = 0.02
#: bench.py:745-746, the QUANT gate's loss-drift budget
QT_DRIFT_BUDGET = 0.005


def _qt_config(policy, cfg=None):
    from paddle_tpu_torch.models.gpt import GPTConfig

    base = cfg.__dict__ if cfg is not None else dict(
        vocab_size=32000, hidden_size=2048, num_layers=24, num_heads=16,
        max_seq_len=2048, dropout=0.0, dtype="bfloat16", recompute=True)
    return GPTConfig(**dict(base, recompute_policy=policy))


def _qt_gemm_readings(cuda):
    """``torch._scaled_mm`` (through the port's fp8 route, quantize
    included and alone) against a bf16 ``torch.matmul`` at config 4's two
    projection shapes, each with its bound; the quantize passes of one
    site."""
    from paddle_tpu_torch.quant import gemm as qg

    out = {}
    if not cuda:
        return out
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    for m, k, n in ((6144, 2048, 2048), (6144, 2048, 5504)):
        x = torch.randn(m, k, device=DEVICE, generator=gen,
                        dtype=torch.bfloat16)
        w = torch.randn(k, n, device=DEVICE, generator=gen,
                        dtype=torch.bfloat16) * 0.02
        one = torch.ones((), device=DEVICE)
        sx = x.abs().amax().float() / 448.0
        sw = w.abs().amax().float() / 448.0
        xq = qg._quantize(x, sx, "fp8", m, k)
        wq_t = qg._quantize(w.t(), sw, "fp8", n, k)
        ops = 2.0 * m * n * k
        fp8_ms = time_ms(lambda: torch._scaled_mm(
            xq, wq_t.t(), scale_a=one, scale_b=one, out_dtype=torch.bfloat16,
            use_fast_accum=False))
        bf16_ms = time_ms(lambda: torch.matmul(x, w))
        quant_ms = time_ms(lambda: (qg._quantize(x, sx, "fp8", m, k),
                                    qg._quantize(w.t(), sw, "fp8", n, k),
                                    x.abs().amax(), w.abs().amax()))
        fp8_bound, fp8_by = bound_ms(m * k + k * n + 2 * m * n, ops,
                                     torch.float8_e4m3fn)
        bf16_bound, bf16_by = bound_ms(2 * (m * k + k * n + m * n), ops,
                                       torch.bfloat16)
        out[f"{m}x{k}x{n}"] = {
            "scaled_mm_ms": fp8_ms, "scaled_mm_bound_ms": fp8_bound,
            "scaled_mm_bound_by": fp8_by, "bf16_matmul_ms": bf16_ms,
            "bf16_bound_ms": bf16_bound, "bf16_bound_by": bf16_by,
            "quantize_pair_ms": quant_ms}
        print(f"quant_train: [{m},{k}]x[{k},{n}]: _scaled_mm {fp8_ms:.4f} "
              f"ms (bound {fp8_bound:.4f}, {fp8_by}), bf16 matmul "
              f"{bf16_ms:.4f} ms (bound {bf16_bound:.4f}, {bf16_by}); "
              f"quantize x and w with their amax {quant_ms:.4f} ms",
              flush=True)
    return out


def _qt_head_readings(cfg, batch, seq, cuda):
    """The chunked CE head's forward and backward at the step's shapes,
    int8 against f32 logits, on CUDA events."""
    from paddle_tpu_torch.nn.functional import chunked_lm_loss_arrays

    if not cuda:
        return {}
    gen = torch.Generator(device=DEVICE).manual_seed(8)
    h = torch.randn(batch * seq, cfg.hidden_size, device=DEVICE,
                    generator=gen, dtype=torch.bfloat16).requires_grad_()
    w = (torch.randn(cfg.vocab_size, cfg.hidden_size, device=DEVICE,
                     generator=gen, dtype=torch.bfloat16) * 0.02
         ).requires_grad_()
    y = torch.randint(0, cfg.vocab_size, (batch * seq,), device=DEVICE,
                      generator=gen)
    out = {}
    for int8 in (True, False):
        def run():
            loss = chunked_lm_loss_arrays(h, w, y, int8=int8)
            torch.autograd.grad(loss, (h, w))
        out["int8" if int8 else "f32"] = time_ms(run, reps=5, inner=2)
    print(f"quant_train: CE head forward + backward at [{batch * seq}, "
          f"{cfg.hidden_size}] x [{cfg.vocab_size}, {cfg.hidden_size}]: "
          f"int8 {out['int8']:.3f} ms, f32 {out['f32']:.3f} ms",
          flush=True)
    return out


def _qt_run(name, cfg, batch, seq, device, batches, smi):
    """One run of :func:`phase_quant_train`: QT_STEPS TrainSteps, the
    checks of its run, and its readings."""
    from paddle_tpu_torch import quant, telemetry
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.testing import chaos

    policy, head = QT_RUNS[name]
    cfg = _qt_config(policy, cfg)
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    model, step = _train_setup(cfg, getattr(torch, cfg.dtype), device,
                               seed=0, int8=head)
    # bytes the forward leaves held for the backward (saved activations,
    # the head's residuals), on the allocator's count
    held = []
    loss_fn = step.train_fn

    def train_fn(*b):
        base = torch.cuda.memory_allocated() if cuda else 0
        loss = loss_fn(*b)
        held.append((torch.cuda.memory_allocated() if cuda else 0) - base)
        return loss

    step.train_fn = train_fn
    quantized = name != "a"
    telemetry.reset()
    telemetry.enable()
    flops = []
    losses, step_ms = [], []
    try:
        for s in range(1, QT_STEPS + 1):
            if s == 2:
                kernels.reset_launch_counts()
            before = telemetry.snapshot()["counters"].get(
                "quant_gemm_flops_total", {}).get("dtype=fp8", 0.0)
            sync()
            t0 = time.perf_counter()
            losses.append(step(*batches[s]).item())
            step_ms.append((time.perf_counter() - t0) * 1e3)
            snap = telemetry.snapshot()
            flops.append(snap["counters"].get("quant_gemm_flops_total", {})
                         .get("dtype=fp8", 0.0) - before)
            if s == 1:
                first = snap
                amax1 = (model.decoder.quant_amax.detach().cpu().clone()
                         if quantized else None)
        counts = kernels.launch_counts()
    finally:
        telemetry.disable()
    peak_gb = (torch.cuda.max_memory_allocated() / 2 ** 30 if cuda
               else None)
    L = cfg.num_layers
    res = {"policy": policy, "head": "f32 (pinned)" if head is False
           else "default", "losses": losses, "step_ms": step_ms,
           "step_ms_median": statistics.median(step_ms[1:]),
           "peak_memory_gib": peak_gb,
           "forward_held_gib": held[-1] / 2 ** 30, "launches": counts}
    if cuda:
        res["profile"] = prof = _profile_step(step, batches[QT_STEPS],
                                              res["step_ms_median"])
        print(f"quant_train: ({name}) profiled step "
              f"{prof['device_busy_ms']:.1f} ms device busy, host share "
              f"{prof['host_share']}; by group "
              + json.dumps({k: round(v, 2) for k, v in
                            prof["by_group_ms"].items()}), flush=True)
        for k, v in prof["top_kernels_ms"]:
            print(f"quant_train:   {v:9.3f} ms/step  {k}", flush=True)
    check(all(np.isfinite(losses)), f"quant_train ({name}) losses {losses}")
    if cuda:
        # attn_res and attn_lse saved: the flash forward once a block, the
        # rest of the block (its FFN and both norms) recomputed
        want = {"flash_attention_fwd": L, "flash_attention_bwd": L,
                "swiglu_down": 2 * L, "rms_norm": 4 * L}
        n = QT_STEPS - 1
        check(all(counts[k] == v * n for k, v in want.items()),
              f"quant_train ({name}) launches {counts}, want {want} x {n}")
    heads = first["gauges"].get("loss_head_mode", {})
    if quantized:
        modes = {k.split(",")[0][5:]: v for k, v in
                 first["gauges"]["gemm_dtype_mode"].items()
                 if k.endswith("path=train")}
        plans = first["counters"].get("plan_engagement_total", {})
        res.update(gemm_dtype_mode=modes, plan_engagement=plans,
                   loss_head_mode=heads, flops_per_step=flops)
        want_flops = 2.0 * (4 * cfg.hidden_size ** 2 + 2 * cfg.hidden_size
                            * cfg.intermediate_size) * L * batch * seq
        print(f"quant_train: ({name}) gemm_dtype_mode {modes}; plans "
              f"{plans}; loss_head_mode {heads}; quant_gemm_flops_total "
              f"per step {set(flops)} (want {want_flops:.0f})", flush=True)
        check(modes == {s: (0.0 if s == "wd" else 2.0)
                        for s in quant.GEMM_SITES},
              f"quant_train ({name}) gemm_dtype_mode {modes}")
        check(plans == {
            "plan=quant_gemm,verdict=engaged,reason=engaged": 1,
            "plan=quant_gemm,verdict=declined,"
            "reason=fused_kernel_owns_gemm": 1},
            f"quant_train ({name}) plan_engagement {plans}")
        check(set(flops) == {want_flops},
              f"quant_train ({name}) flops per step {flops} != {want_flops}")
        wd = quant.GEMM_SITES.index("wd")
        check(bool((amax1[:, :wd, :, 0] > 0).all())
              and not amax1[:, wd].any(),
              f"quant_train ({name}) amax after step 1 {amax1[..., 0]}")
        if cuda:
            check(heads.get("mode=chunked,int8=on") == 1,
                  f"quant_train ({name}) loss_head_mode {heads}")
        # one armed attempt with NaN gradients: every byte of the
        # histories stays
        amax = model.decoder.quant_amax
        old = amax.detach().clone()
        step._guard_threshold = float("inf")
        with chaos.inject_nonfinite(step._call_index + 1, kind="nan"):
            step(*batches[QT_STEPS])
        step._guard_threshold = None
        sync()
        health = step.last_health
        same = torch.equal(amax.view(torch.uint8), old.view(torch.uint8))
        res["nan_attempt_amax_unchanged"] = same
        print(f"quant_train: ({name}) NaN attempt ok={health.ok}; "
              f"quant_amax bytes unchanged: {same}", flush=True)
        check(not health.ok and same,
              f"quant_train ({name}) NaN attempt changed quant_amax")
    elif cuda:
        check(heads.get("mode=chunked,int8=off") == 1,
              f"quant_train ({name}) loss_head_mode {heads}")
    print(f"quant_train: ({name}) {policy}: losses "
          f"{[round(x, 5) for x in losses]}; step median "
          f"{res['step_ms_median']:.1f} ms (steps 2-{QT_STEPS}), peak "
          f"memory {peak_gb} GiB, held by the forward "
          f"{res['forward_held_gib']:.3f} GiB; {smi}", flush=True)
    del model, step
    return res


def phase_quant_train(smi="", cfg=None, batch=3, seq=2048, device=DEVICE):
    """Config 4 in bf16 (batch 3 x seq 2048, AdamW(lr=3e-4,
    weight_decay=0.01, factored=True), one seeded batch per step number,
    the same seeded weights) under the three policies of ``QT_RUNS``, 8
    steps each: engagement, the FLOP counter, the amax buffer, a discarded
    NaN attempt, launches and losses checked; the GEMMs, the quantize
    passes and the CE head timed; the parity gate and the drift probe on
    the card. ``cfg``, ``batch``, ``seq`` and ``device`` let the phase run
    at a small size on the CPU."""
    from paddle_tpu_torch import quant

    cuda = torch.device(device).type == "cuda"
    t_phase = time.perf_counter()
    batches = {s: _train_batch((cfg or _qt_config("full")).vocab_size,
                               batch, seq, s, device)
               for s in range(1, QT_STEPS + 1)}
    runs = {name: _qt_run(name, cfg, batch, seq, device, batches, smi)
            for name in QT_RUNS}
    drift = {name: [abs(x - a) / abs(a) for x, a in
                    zip(runs[name]["losses"], runs["a"]["losses"])]
             for name in ("b", "c")}
    print(f"quant_train: relative loss drift per step against (a): "
          + json.dumps({k: [f"{x:.2e}" for x in v]
                        for k, v in drift.items()}), flush=True)
    check(max(max(v) for v in drift.values()) <= QT_LOSS_RTOL,
          f"quant_train losses leave {QT_LOSS_RTOL} of (a)'s: {drift}")
    gate = quant.quant_gate_report(device=device)
    probe = quant.loss_drift_probe(device=device)
    print(f"quant_train: parity gate on {device}: {gate}; loss_drift_probe "
          f"{probe!r} (budget {QT_DRIFT_BUDGET})", flush=True)
    check(gate["ok"] and gate["dtype"] == "fp8", f"quant gate {gate}")
    check(probe < QT_DRIFT_BUDGET, f"loss_drift_probe {probe}")
    res = {"runs": runs, "relative_drift": drift, "gate": gate,
           "loss_drift_probe": probe,
           "launches": runs["b"]["launches"] if cuda else {}}
    res["gemm"] = _qt_gemm_readings(cuda)
    cfg4 = cfg or _qt_config("full")
    res["ce_head_ms"] = _qt_head_readings(cfg4, batch, seq, cuda)
    if cuda:
        # the scaled GEMMs run in the forward and again in the backward's
        # recompute: 2 x L x (three [h, h] sites and wo, gate and up)
        g = res["gemm"]
        per = (4 * g["6144x2048x2048"]["quantize_pair_ms"]
               + 2 * g["6144x2048x5504"]["quantize_pair_ms"])
        res["quantize_ms_per_step"] = 2 * cfg4.num_layers * per
        print(f"quant_train: quantize passes ~{res['quantize_ms_per_step']:.1f}"
              f" ms a step (2 x L x the six sites' timed pairs); {smi}",
              flush=True)
    res["seconds"] = time.perf_counter() - t_phase
    return res


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


# ------------------------------------------------------------ model_rest
#: config 5 at degree 1 (bench.py:253-257): LLaMA-7B's widths at 8 layers
CONFIG5 = dict(vocab_size=32000, hidden_size=4096, num_layers=8,
               num_heads=32, num_kv_heads=8, intermediate_size=11008,
               max_seq_len=2048, dropout=0.0, dtype="bfloat16",
               recompute=True)
#: config 4 (bench.py:259-262)
CONFIG4 = dict(vocab_size=32000, hidden_size=2048, num_layers=24,
               num_heads=16, max_seq_len=2048, dropout=0.0, dtype="bfloat16",
               recompute=True)
#: the GPT-3 architecture's variant knobs: LayerNorm, exact gelu, learned
#: positions (intermediate 4H by the config rule)
GPT3_ARCH = dict(norm_type="layernorm", act="gelu", rope=False)
#: the MoE decoder of (d): 8 experts of config 4's FFN width, top 2
MOE_KW = dict(num_experts=8, top_k=2, gate="gshard", capacity_factor=2.0)
REST_STEPS = 3
#: (c): a seam's losses against the unfused run's, the reference's bound
#: for int8 saves (tests/test_memory.py:113-122)
REST_SEAM_RTOL = 0.02


def _rest_steps(tag, model, loss_fn, batches, want, profile=False):
    """One AdamW(factored) TrainStep of ``loss_fn`` on each of
    ``batches``: losses, each step's wall (host clock, ending in the
    loss's read), the launches of all steps, each kernel in ``want``
    asserted at its count per step times the steps. A new batch a step:
    a wide model learns one repeated random batch by heart within two
    steps. ``profile`` adds one more step on the last batch under the
    profiler (``_profile_step``) on a card. Returns (readings,
    optimizer)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.optimizer import AdamW

    opt = AdamW(model.parameters(), lr=3e-4, weight_decay=0.01,
                factored=True)
    step = TrainStep(model, loss_fn, opt)
    kernels.reset_launch_counts()
    losses, ms = [], []
    steps = len(batches)
    for batch in batches:
        t0 = time.perf_counter()
        losses.append(step(*batch).item())
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = kernels.launch_counts()
    for name, per_step in want.items():
        check(counts[name] == per_step * steps,
              f"{tag}: {name} launches {counts[name]} != {per_step} x "
              f"{steps}")
    check(all(np.isfinite(losses)), f"{tag}: losses {losses}")
    res = {"losses": losses, "step_ms": ms,
           "step_ms_median": statistics.median(ms), "launches": counts,
           "launches_per_step": want}
    if profile and next(model.parameters()).is_cuda:
        res["profile"] = prof = _profile_step(step, batches[-1],
                                              res["step_ms_median"])
        print(f"model_rest {tag}: profiled step "
              f"{prof['device_busy_ms']:.1f} ms device busy, host share "
              f"{prof['host_share']}; by group "
              + json.dumps({k: round(v, 2) for k, v in
                            prof["by_group_ms"].items()})
              + "; top kernels "
              + json.dumps([(k[:60], round(v, 2))
                            for k, v in prof["top_kernels_ms"][:5]]),
              flush=True)
    return res, opt


def _rest_report(tag, res, nparams, tokens):
    tps = tokens / (res["step_ms_median"] / 1e3)
    res.update(params=nparams, tokens_per_s=tps,
               model_flops_share=6.0 * nparams * tps
               / PEAK_OPS[torch.bfloat16])
    print(f"model_rest {tag}: {nparams / 1e9:.4f} B params, losses "
          f"{[round(x, 4) for x in res['losses']]}, step ms "
          f"{[round(x, 1) for x in res['step_ms']]} (median "
          f"{res['step_ms_median']:.1f}, the first step included), "
          f"{tps:.0f} tokens/s, model-flops share "
          f"{res['model_flops_share']:.4f}; launches per step "
          f"{res['launches_per_step']}", flush=True)


def _first_loss_near_ln_v(tag, loss, vocab):
    ln_v = float(np.log(vocab))
    check(ln_v - 0.1 <= loss <= ln_v + 1.5,
          f"{tag}: first loss {loss} outside [ln V - 0.1, ln V + 1.5]")


def _nbytes_equal(a, b):
    return (a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8),
        b.contiguous().reshape(-1).view(torch.uint8)))


def _rest_layouts(pipe, popt, cfg, batch, root, device):
    """(e): the Pipe's state and optimizer saved through CheckpointManager,
    restored into a per-layer GPTForCausalLM (restore_decoder_any_layout),
    saved again and restored into a fresh Pipe. Every converted tensor's
    bytes (after the transpose, factored slots swapped) are asserted
    equal; the factored norms' second moments, which have no counterpart
    in the other layout, are listed. The next loss of both trees on one
    batch agrees within phase 7's bound."""
    from paddle_tpu_torch.distributed.checkpoint import (
        training_state_dict, training_state_target)
    from paddle_tpu_torch.distributed.checkpoint.manager import \
        CheckpointManager
    from paddle_tpu_torch.models.gpt import (GPTForCausalLM,
                                             GPTForCausalLMPipe,
                                             convert_decoder_state_dict,
                                             restore_decoder_any_layout)
    from paddle_tpu_torch.optimizer import AdamW

    def fresh(cls):
        model = cls(cfg, device=device)
        opt = AdamW(model.parameters(), lr=3e-4, weight_decay=0.01,
                    factored=True)
        return model, opt

    def compare(src, dst, layout):
        conv = convert_decoder_state_dict(src, layout)
        same = [k for k, t in dst.items()
                if k in conv and _nbytes_equal(conv[k], t)]
        differ = sorted(k for k, t in dst.items()
                        if k in conv and k not in same)
        return len(same), differ, sorted(k for k in dst if k not in conv)

    out = {}
    mgr = CheckpointManager(str(root))
    try:
        t0 = time.perf_counter()
        mgr.save_training_state(1, pipe, popt)
        out["save_s"] = time.perf_counter() - t0
        eager, eopt = fresh(GPTForCausalLM)
        t0 = time.perf_counter()
        check(restore_decoder_any_layout(mgr, eager, eopt, strict=False)
              == 1, "layouts: restore into the per-layer tree")
        out["to_per_layer_s"] = time.perf_counter() - t0
        n, differ, kept = compare(training_state_dict(pipe, popt),
                                  training_state_target(eager, eopt),
                                  "per_layer")
        check(not differ, f"layouts: bytes differ after the transpose: "
                          f"{differ[:8]}")
        out["per_layer"] = {"equal": n, "kept": kept}
        with torch.no_grad():
            loss = {k: m.loss(*batch, int8=False).item()
                    for k, m in (("pipe", pipe), ("per_layer", eager))}
        rel = abs(loss["per_layer"] - loss["pipe"]) / abs(loss["pipe"])
        out.update(next_loss=loss, next_loss_rel=rel)
        t0 = time.perf_counter()
        mgr.save_training_state(2, eager, eopt)
        out["save2_s"] = time.perf_counter() - t0
        del eopt
        back, bopt = fresh(GPTForCausalLMPipe)
        t0 = time.perf_counter()
        check(restore_decoder_any_layout(mgr, back, bopt, strict=False) == 2,
              "layouts: restore back into the Pipe")
        out["to_stacked_s"] = time.perf_counter() - t0
        n2, differ2, kept2 = compare(training_state_dict(eager, None),
                                     training_state_target(back, None),
                                     "stacked")
        mine = training_state_dict(pipe, popt)
        theirs = training_state_target(back, bopt)
        lost = sorted(k for k in mine if not _nbytes_equal(mine[k],
                                                           theirs[k]))
        check(not differ2, f"layouts: bytes differ coming back: {differ2}")
        out["stacked"] = {"equal": n2, "not_round_tripped": lost}
    finally:
        mgr.close()
        shutil.rmtree(root, ignore_errors=True)
    print(f"model_rest (e): Pipe -> per-layer: {out['per_layer']['equal']} "
          f"tensors bytes-equal after the transpose, kept at the target's "
          f"own value {out['per_layer']['kept']}; per-layer -> Pipe: "
          f"{out['stacked']['equal']} parameters bytes-equal, the round "
          f"trip's changed tensors {out['stacked']['not_round_tripped']}; "
          f"next loss {loss} (rel {rel:.2e}, tol {TRAIN_LOSS_RTOL}); save "
          f"{out['save_s']:.1f} s, restore {out['to_per_layer_s']:.1f} s, "
          f"save {out['save2_s']:.1f} s, restore {out['to_stacked_s']:.1f} "
          "s", flush=True)
    check(rel <= TRAIN_LOSS_RTOL, f"layouts: next losses differ: {loss}")
    check(all(k.endswith(("norm.weight.moment2", "ln1.vr", "ln1.vc",
                          "ln2.vr", "ln2.vc"))
              for k in out["per_layer"]["kept"]
              + out["stacked"]["not_round_tripped"]),
          "layouts: a tensor besides the factored norms' second moments "
          "did not convert")
    return out


def _rest_card_vs_cpu(tag, build, loss_fn, vocab, device, seq=256):
    """(f): f32, three AdamW(factored) TrainSteps of one model on the card
    and on the CPU from the same weights, as phase 7: losses within
    TRAIN_LOSS_RTOL, step-1 gradients within TRAIN_GRAD_RTOL of each
    leaf's norm."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW

    cpu = build("cpu")
    gpu = build(device)
    gpu.load_state_dict(cpu.state_dict())
    losses, grads = {}, {}
    for dev, model in (("cpu", cpu), (device, gpu)):
        step = TrainStep(model, loss_fn(model), AdamW(
            model.parameters(), lr=1e-3, factored=True))
        ids, labels = _train_batch(vocab, 1, seq, 1, dev)
        losses[dev] = [step(ids, labels).item()]
        grads[dev] = {n: p.grad.detach().float().cpu().clone()
                      for n, p in model.named_parameters()}
        losses[dev] += [step(ids, labels).item() for _ in range(2)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses[device],
                                                  losses["cpu"]))
    worst = {n: ((grads[device][n] - g).norm()
                 / g.norm().clamp_min(1e-30)).item()
             for n, g in grads["cpu"].items()}
    print(f"model_rest (f) {tag}: f32 depth 2 seq {seq}, losses card "
          f"{losses[device]} cpu {losses['cpu']} (max rel {rel:.2e}, tol "
          f"{TRAIN_LOSS_RTOL}); step-1 grads max rel "
          f"{max(worst.values()):.2e} ({max(worst, key=worst.get)}, tol "
          f"{TRAIN_GRAD_RTOL})", flush=True)
    check(rel <= TRAIN_LOSS_RTOL, f"{tag}: losses differ: {losses}")
    check(max(worst.values()) <= TRAIN_GRAD_RTOL,
          f"{tag}: grads differ: {worst}")
    return {"losses": losses, "grad_rel_err": worst}


def phase_model_rest(smi="", cfg5=None, cfg4=None, batch=3, seq=2048,
                     device=DEVICE, root=Path("build/ckpt_layouts"),
                     steps=REST_STEPS):
    """The model files' one-card rest, bf16 at full width:
    (a) config 5 at degree 1 through LlamaForCausalLMPipe;
    (b) the GPT-3 architecture (LayerNorm, gelu, learned positions) at
        config 4's widths and depth through the per-layer
        GPTForCausalLM.loss: the flash kernels under the per-layer tree,
        rms_norm never;
    (c) config 4's Pipe with fused_addrms, then with int8_ffn, and
        unfused, on the same weights and batch (the CE head pinned to f32
        logits in all three): exact launches, each seam's losses within
        REST_SEAM_RTOL of the unfused run's;
    (d) GPTForCausalLMMoE at config 4's width and depth, 8 experts of
        FFN width 5504, top 2: losses, aux loss, tokens dropped per layer,
        peak memory;
    (e) the layout converters on (c)'s last Pipe and its optimizer;
    (f) card against CPU, f32, depth 2, for (b)'s variant and (d)'s MoE.
    Each of (a)-(d) runs ``steps`` AdamW(factored) TrainSteps, a seeded
    batch x seq batch each (the same batches for the three runs of (c));
    (a), (b) and (d) one more under the profiler (device busy, host
    share, time by kernel group).
    ``smi`` is printed beside the readings; the other arguments let
    the phase run small on the CPU."""
    import functools

    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                             GPTForCausalLMMoE,
                                             GPTForCausalLMPipe)
    from paddle_tpu_torch.models.llama import LlamaForCausalLMPipe
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels.swiglu_down import \
        swiglu_down_supported

    cuda = torch.device(device).type == "cuda"
    cfg5 = GPTConfig(**(cfg5 or CONFIG5))
    cfg4_kw = dict(cfg4 or CONFIG4)
    cfg4 = GPTConfig(**cfg4_kw)
    tokens = batch * seq
    out = {"smi": smi, "part_seconds": {}}
    launches = {k: 0 for k in kernels.launch_counts()}

    def timed(part, fn):
        t0 = time.perf_counter()
        res = fn()
        out["part_seconds"][part] = time.perf_counter() - t0
        for k, v in res.get("launches", {}).items():
            launches[k] += v
        return res

    def batches(cfg, seed):
        return [_train_batch(cfg.vocab_size, batch, seq, 100 * seed + s,
                             device) for s in range(steps)]

    def model_of(cls, cfg, seed, **kw):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return cls(cfg, device=device, **kw).init_weights(gen, std=0.02)

    def pipe_want(cfg, addrms=False, int8=False):
        L = cfg.num_layers
        m = cfg.intermediate_size
        fused = swiglu_down_supported((batch, seq, m),
                                      (m, cfg.hidden_size)) and not int8
        return {"flash_attention_fwd": 2 * L, "flash_attention_bwd": L,
                "flash_attention_bwd_dq": 0, "rms_norm": (2 + 2 * (
                    not addrms)) * L, "add_rms_norm": 2 * L * addrms,
                "swiglu_down": 2 * L * fused}

    def part_a():
        torch.cuda.reset_peak_memory_stats() if cuda else None
        model = model_of(LlamaForCausalLMPipe, cfg5, seed=0)
        res, _ = _rest_steps("(a)", model, model.loss, batches(cfg5, 0),
                                pipe_want(cfg5) if cuda else {},
                                profile=True)
        _first_loss_near_ln_v("(a)", res["losses"][0], cfg5.vocab_size)
        _rest_report("(a) config 5, LlamaForCausalLMPipe", res,
                     sum(p.numel() for p in model.parameters()), tokens)
        if cuda:
            res["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        return res

    def part_b():
        cfg = GPTConfig(**dict(cfg4_kw, **GPT3_ARCH))
        model = model_of(GPTForCausalLM, cfg, seed=1)
        L = cfg.num_layers
        want = ({"flash_attention_fwd": 2 * L, "flash_attention_bwd": L,
                 "rms_norm": 0, "add_rms_norm": 0, "swiglu_down": 0}
                if cuda else {})
        res, _ = _rest_steps("(b)", model, model.loss, batches(cfg, 1),
                                want, profile=True)
        _first_loss_near_ln_v("(b)", res["losses"][0], cfg.vocab_size)
        _rest_report("(b) GPT-3 architecture, per-layer", res,
                     sum(p.numel() for p in model.parameters()), tokens)
        return res

    keep = {}

    def part_c():
        b = batches(cfg4, 2)
        runs = {}
        for name, kw in (("unfused", {}), ("fused_addrms",
                                           {"fused_addrms": True}),
                         ("int8_ffn", {"int8_ffn": True})):
            cfg = GPTConfig(**dict(cfg4_kw, **kw))
            model = model_of(GPTForCausalLMPipe, cfg, seed=2)
            want = pipe_want(cfg, addrms="fused_addrms" in kw,
                             int8="int8_ffn" in kw) if cuda else {}
            res, opt = _rest_steps(
                f"(c) {name}", model, functools.partial(model.loss,
                                                        int8=False),
                b, want)
            runs[name] = res
            if name == "int8_ffn":
                keep.update(pipe=model, opt=opt, batch=b[0])
            del model, opt
        base = runs["unfused"]["losses"]
        for name in ("fused_addrms", "int8_ffn"):
            rel = max(abs(a - u) / abs(u)
                      for a, u in zip(runs[name]["losses"], base))
            runs[name]["loss_rel_to_unfused"] = rel
        print(f"model_rest (c) {smi}: config 4 Pipe, losses unfused "
              f"{[round(x, 4) for x in base]}; "
              + "; ".join(f"{n} {[round(x, 4) for x in r['losses']]} (max "
                          f"rel {r.get('loss_rel_to_unfused', 0):.2e}, tol "
                          f"{REST_SEAM_RTOL})"
                          for n, r in runs.items() if n != "unfused")
              + "; step medians ms "
              + ", ".join(f"{n} {r['step_ms_median']:.1f}"
                          for n, r in runs.items())
              + f"; launches per step {runs['fused_addrms']['launches_per_step']}"
              f" (seam), {runs['int8_ffn']['launches_per_step']} (int8 FFN)",
              flush=True)
        for name in ("fused_addrms", "int8_ffn"):
            check(runs[name]["loss_rel_to_unfused"] <= REST_SEAM_RTOL,
                  f"(c) {name}: losses {runs[name]['losses']} against "
                  f"{base}")
        launch = {k: sum(r["launches"][k] for r in runs.values())
                  for k in launches}
        return {"runs": runs, "launches": launch}

    def part_d():
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        model = model_of(GPTForCausalLMMoE, cfg4, seed=3, **MOE_KW)
        L = cfg4.num_layers
        want = ({"flash_attention_fwd": 2 * L, "flash_attention_bwd": L,
                 "rms_norm": 4 * L + 1, "swiglu_down": 0,
                 "add_rms_norm": 0} if cuda else {})
        res, _ = _rest_steps("(d)", model, model.loss, batches(cfg4, 3),
                                want, profile=True)
        _first_loss_near_ln_v("(d)", res["losses"][0], cfg4.vocab_size)
        res["aux_loss"] = model.aux_loss().item()
        res["dropped_per_layer"] = [int(l.moe.dropped) for l in model.layers]
        res["routed_per_layer"] = tokens * MOE_KW["top_k"]
        nparams = sum(p.numel() for p in model.parameters())
        _rest_report("(d) MoE, 8 experts top 2", res, nparams, tokens)
        if cuda:
            res["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        print(f"model_rest (d) {smi}: aux loss {res['aux_loss']:.4f}; "
              f"(token, choice) pairs dropped per layer "
              f"{res['dropped_per_layer']} of {res['routed_per_layer']}; "
              f"peak memory {res.get('peak_memory_gib', 0):.1f} GiB",
              flush=True)
        return res

    def part_f():
        small = dict(cfg4_kw, num_layers=2, dtype="float32")
        variant = GPTConfig(**dict(small, **GPT3_ARCH))
        moe_cfg = GPTConfig(**small)

        def build(cls, cfg, **kw):
            def make(dev):
                m = cls(cfg, device=dev, **kw)
                if dev == "cpu":
                    m.init_weights(torch.Generator().manual_seed(4), std=0.02)
                return m
            return make

        return {"variant": _rest_card_vs_cpu(
                    "GPT-3 architecture", build(GPTForCausalLM, variant),
                    lambda m: functools.partial(m.loss, int8=False),
                    variant.vocab_size, device, min(seq, 256)),
                "moe": _rest_card_vs_cpu(
                    "MoE", build(GPTForCausalLMMoE, moe_cfg, **MOE_KW),
                    lambda m: m.loss, moe_cfg.vocab_size, device,
                    min(seq, 256))}

    out["a"] = timed("a", part_a)
    out["b"] = timed("b", part_b)
    out["c"] = timed("c", part_c)
    out["e"] = timed("e", lambda: _rest_layouts(
        keep["pipe"], keep["opt"], GPTConfig(**cfg4_kw), keep["batch"],
        root, device))
    keep.clear()
    if cuda:
        torch.cuda.empty_cache()
    out["d"] = timed("d", part_d)
    if cuda:
        torch.cuda.empty_cache()
    out["f"] = timed("f", part_f)
    out["launches"] = launches
    print(f"model_rest: {smi}: parts s "
          + ", ".join(f"{k} {v:.1f}" for k, v in out["part_seconds"].items())
          + f"; launches {launches}", flush=True)
    return out


# ------------------------------------------------------- incubate_surface
#: the paged decoder's page (block) size: block_multihead_attention's
#: caches are [MaxBlockNum, Hkv, 64, D]
BLHA_PAGE = 64


def blha_generate(model, prompts, new, page=BLHA_PAGE, step_ms=None,
                  counts=None):
    """Greedy streams of a paged decoder built from the incubate ops:
    fused_rms_norm, fused_linear (the model's [out, in] weights with
    transpose_weight) and block_multihead_attention over one
    [MaxBlockNum, Hkv, page, D] key and value cache per layer, whose pages
    a seeded permutation scatters; rope from a caller's table (neox
    halves, base 10000, as the model's). The prompts are prefilled by one
    call per layer, then every row takes one token per decode call. The
    sequence lengths travel as CPU tensors, so no call waits for the
    card to read them. ``step_ms`` collects each decode step's ms (host
    clock, synchronised); ``counts`` the kernel launches of each decode
    step. Returns prompt + ``new`` tokens per row."""
    from paddle_tpu_torch.incubate.nn.functional import (
        block_multihead_attention, fused_linear, fused_rms_norm, swiglu)
    from paddle_tpu_torch.ops import kernels

    cfg = model.config
    params = incubate_params(model)
    dev, dtype = params["embed"].device, params["embed"].dtype
    hd = cfg.hidden_size // cfg.num_heads
    b = len(prompts)
    lens = np.array([len(p) for p in prompts])
    max_pos = int(lens.max()) + new
    pps = -(-max_pos // page)
    nblocks = b * pps
    perm = torch.randperm(nblocks, generator=torch.Generator().manual_seed(3))
    tables = perm.reshape(b, pps).to(dev, torch.int32)
    caches = [tuple(torch.zeros(nblocks, cfg.num_kv_heads, page, hd,
                                dtype=dtype, device=dev) for _ in range(2))
              for _ in params["layers"]]
    inv = 10000.0 ** (-torch.arange(0, hd, 2, dtype=torch.float32,
                                    device=dev) / hd)
    ang = torch.arange(max_pos, dtype=torch.float32, device=dev)[:, None] * inv
    rope = torch.stack([ang.cos(), ang.sin()])[:, None, :, None, :].expand(
        2, b, max_pos, 1, hd // 2)

    def lin(x, w):
        return fused_linear(x, w, transpose_weight=True)

    def forward(tokens, enc, dec, this):
        meta = [torch.as_tensor(a, dtype=torch.int32)[:, None]
                for a in (enc, dec, this)]
        x = params["embed"][tokens]
        for lp, (kc, vc) in zip(params["layers"], caches):
            h = fused_rms_norm(x, lp["ln1"])
            qkv = torch.cat([lin(h, lp[w]) for w in ("wq", "wk", "wv")], -1)
            out, _, _, _ = block_multihead_attention(
                qkv, kc, vc, *meta, None, None, None, None, tables,
                rope_emb=rope, block_size=page, use_neox_style=True)
            x = x + lin(out, lp["wo"])
            h2 = fused_rms_norm(x, lp["ln2"])
            x = x + lin(swiglu(lin(h2, lp["wg"]), lin(h2, lp["wu"])),
                        lp["wd"])
        return fused_rms_norm(x, params["fnorm"])

    outs = [list(p) for p in prompts]
    with torch.inference_mode():
        ids = torch.as_tensor(np.concatenate(prompts), device=dev)
        last = torch.as_tensor(np.cumsum(lens) - 1, device=dev)
        x = forward(ids, lens, np.zeros(b, np.int64), lens)[last]
        nxt = F.linear(x, params["head"]).float().argmax(-1)
        for o, t in zip(outs, nxt.tolist()):
            o.append(t)
        for i in range(new - 1):
            t0 = time.perf_counter()
            if counts is not None:
                kernels.reset_launch_counts()
            x = forward(nxt, np.zeros(b, np.int64), lens + i,
                        np.ones(b, np.int64))
            nxt = F.linear(x, params["head"]).float().argmax(-1)
            toks = nxt.tolist()
            if step_ms is not None:
                step_ms.append((time.perf_counter() - t0) * 1e3)
            if counts is not None:
                counts.append(kernels.launch_counts())
            for o, t in zip(outs, toks):
                o.append(t)
    return outs


def _fused_init(module, seed, std=0.02):
    """Seeded weights for a Fused* module: matrices N(0, std^2), biases 0,
    LayerNorm scales 1."""
    gen = torch.Generator(device=next(module.parameters()).device)
    gen.manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("_scale"):
                p.fill_(1.0)
            elif p.dim() == 1:
                p.zero_()
            else:
                p.normal_(0.0, std, generator=gen)
    return module


def _leaf_errs(got, want):
    """Each leaf's relative error against its norm."""
    return {n: ((got[n].float() - g.float()).norm()
                / g.float().norm().clamp_min(1e-30)).item()
            for n, g in want.items()}


#: config 4's widths as a FusedMultiTransformer (bench.py:259-262, hidden
#: 2048, 16 heads, 24 layers; the fused layers' FFN 4H, gelu)
FMT_KW = dict(embed_dim=2048, num_heads=16, dim_feedforward=8192,
              activation="gelu", normalize_before=True, num_layers=24)
#: (b), (c) and (e)'s batch x seq (config 4's), and (d)'s head: config
#: 4's tokens a step x its vocabulary
SURFACE_SHAPE = dict(batch=3, seq=2048, vocab=32000)


def phase_incubate_surface(model, smi=""):
    """incubate_surface on phase 4's LLaMA-7B model, bf16:
    (a) the paged decoder of blha_generate serving phase 4's 8 prompts for
        32 new tokens over [MaxBlockNum, 32, 64, 128] caches:
        paged_attention L and rms_norm 2L + 1 per decode step, ms per
        token, no page-layout copy (the kernel reads the page-major cache
        in place), the new tokens equal to generate's as a reading (in
        bf16 no two of the port's decoders round alike; phase 5's
        blha_consistency holds the streams equal in f32);
    (b) FusedMultiTransformer at config 4's widths (FFN 8192, gelu, 24
        layers, normalize_before) on [3, 2048] in eval mode: the non-causal
        flash forward L times, each layer's output within FLASH_TOL of the
        same layer through the plain attention (an all-True mask) from the
        same input, the whole stack's difference a reading;
    (c) one training step of a 2-layer FusedTransformerEncoderLayer stack
        at those widths, dropout 0: the non-causal backward L times (the
        fused kernel or the split pair), every gradient within FLASH_TOL of
        its leaf's norm against the plain route;
    (d) fused_linear_cross_entropy at config 4's head, [6144, 2048] x
        [32000, 2048], against the Pipe's head (chunked_lm_loss_arrays) on
        the same tensors under the same int8-head gate: loss within 1e-4
        relative, forward and backward ms of both;
    (e) the non-causal flash forward and fused backward alone at (b)'s
        shape [3, 2048, 16/16, 128]: ms, bound (B*H*S^2 pairs) and SDPA's
        (is_causal=False) ms."""
    from paddle_tpu_torch.incubate.nn import (FusedMultiTransformer,
                                              FusedTransformerEncoderLayer)
    from paddle_tpu_torch.incubate.nn.functional import \
        fused_linear_cross_entropy
    from paddle_tpu_torch.nn.functional import (chunked_lm_loss_arrays,
                                                int8_head_enabled)
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_fused,
        flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_fwd_plain)

    cfg = model.config
    L = cfg.num_layers
    bsz, seq = SURFACE_SHAPE["batch"], SURFACE_SHAPE["seq"]
    e, nh = FMT_KW["embed_dim"], FMT_KW["num_heads"]
    out = {"smi": smi, "part_seconds": {}}
    launches = {k: 0 for k in kernels.launch_counts()}

    def part(name, fn):
        t0 = time.perf_counter()
        res = fn()
        _sync(DEVICE)
        out["part_seconds"][name] = time.perf_counter() - t0
        for k, v in res.get("launches", {}).items():
            launches[k] += v
        out[name] = res
        return res

    def part_a():
        _, prompts = _serve_prompts(cfg)
        new = 32
        blha_generate(model, [prompts[0][:64]], 2)              # warm-up
        step_ms, counts = [], []
        streams = blha_generate(model, prompts, new, step_ms=step_ms,
                                counts=counts)
        per_step = {k: [c[k] for c in counts] for k in counts[0]}
        want = [model.generate(np.asarray([p]), max_new_tokens=new)[0]
                .tolist() for p in prompts]
        same = [sum(a == b for a, b in zip(s[len(p):], w[len(p):]))
                for s, w, p in zip(streams, want, prompts)]
        res = {"rows": len(prompts), "prompt_lens": [len(p) for p in prompts],
               "new_tokens": new, "page": BLHA_PAGE,
               "ms_per_token_median": statistics.median(step_ms),
               "ms_per_token_all": step_ms,
               "page_layout_copy_ms": 0.0,
               "paged_attention_per_step": per_step["paged_attention"],
               "rms_norm_per_step": per_step["rms_norm"],
               "new_tokens_equal_generate": same,
               "launches": {k: sum(v) for k, v in per_step.items()}}
        print(f"incubate_surface (a) {smi}: paged decoder over "
              f"[{8 * -(-(1024 + new) // BLHA_PAGE)}, {cfg.num_kv_heads}, "
              f"{BLHA_PAGE}, {cfg.hidden_size // cfg.num_heads}] caches, 8 "
              f"rows: median {res['ms_per_token_median']:.2f} ms per token "
              f"(decode step); launches per step: paged_attention "
              f"{sorted(set(res['paged_attention_per_step']))}, rms_norm "
              f"{sorted(set(res['rms_norm_per_step']))} (L = {L}); page-"
              "layout copy 0 ms (read in place); bf16 new tokens equal to "
              f"generate's {same} of {new} (a reading: equality is held in "
              "f32, blha_consistency)", flush=True)
        check(all(n == L for n in res["paged_attention_per_step"])
              and all(n == 2 * L + 1 for n in res["rms_norm_per_step"]),
              f"(a) launches per step {per_step}")
        check(all(len(s) == len(p) + new
                  and all(0 <= t < cfg.vocab_size for t in s)
                  for s, p in zip(streams, prompts)), "(a) streams")
        return res

    def part_b():
        fmt = _fused_init(FusedMultiTransformer(
            **FMT_KW, device=DEVICE, dtype=torch.bfloat16), seed=5).eval()
        x = torch.randn(bsz, seq, e, device=DEVICE,
                        generator=torch.Generator(DEVICE).manual_seed(6)
                        ).to(torch.bfloat16)
        every = torch.ones(seq, seq, dtype=torch.bool, device=DEVICE)
        with torch.no_grad():
            fmt(x)                                          # warm-up
            _sync(DEVICE)
            kernels.reset_launch_counts()
            got = fmt(x)
            _sync(DEVICE)
            counts = kernels.launch_counts()
            # each layer through the flash op and through the plain route
            # from the same input: FLASH_TOL is a layer's bound; the whole
            # stack's difference compounds over 24 bf16 layers (a reading)
            layer_rel, h = [], x
            for layer in fmt.layers:
                flash = layer(h)
                layer_rel.append(_rel_err(flash, layer(
                    h, src_mask=every))[1])
                h = flash
            err, rel = _rel_err(got, fmt(x, attn_mask=every))
            ms = time_ms(lambda: fmt(x), reps=5, inner=1)
            plain_ms = time_ms(lambda: fmt(x, attn_mask=every), reps=3,
                               inner=1)
        res = {"shape": f"[{bsz}, {seq}, {e}] bf16, {FMT_KW['num_layers']} "
                        "layers", "launches": counts,
               "layer_max_rel_err": layer_rel, "stack_max_abs_err": err,
               "stack_max_rel_err": rel, "forward_ms": ms,
               "plain_route_forward_ms": plain_ms}
        print(f"incubate_surface (b) {smi}: FusedMultiTransformer at config "
              f"4's widths, {res['shape']} eval: flash fwd launches "
              f"{counts['flash_attention_fwd']} (L = {FMT_KW['num_layers']});"
              f" each layer against the plain route from the same input: "
              f"max rel err {max(layer_rel):.4g} (tol "
              f"{FLASH_TOL[torch.bfloat16]}); the whole stack's {rel:.4g} "
              f"(max abs {err:.4g}); forward {ms:.2f} ms, plain route "
              f"{plain_ms:.2f} ms", flush=True)
        check(counts["flash_attention_fwd"] == FMT_KW["num_layers"],
              f"(b) flash fwd launches {counts}")
        check(torch.isfinite(got.float()).all().item() and
              max(layer_rel) <= FLASH_TOL[torch.bfloat16],
              f"(b) rel errs by layer {layer_rel}")
        del fmt
        return res

    def part_c():
        stack = torch.nn.Sequential(*(
            FusedTransformerEncoderLayer(
                e, nh, FMT_KW["dim_feedforward"], dropout_rate=0.0,
                activation="gelu", normalize_before=True, device=DEVICE,
                dtype=torch.bfloat16) for _ in range(2)))
        _fused_init(stack, seed=7)
        x = torch.randn(bsz, seq, e, device=DEVICE,
                        generator=torch.Generator(DEVICE).manual_seed(8)
                        ).to(torch.bfloat16)
        every = torch.ones(seq, seq, dtype=torch.bool, device=DEVICE)

        def grads(mask):
            stack.zero_grad()
            h = x
            for layer in stack:
                h = layer(h, src_mask=mask)
            loss = h.float().square().mean()
            loss.backward()
            # pre-LayerNorm layers leave their post-LayerNorm unused
            return loss.item(), {n: p.grad.detach().clone()
                                 for n, p in stack.named_parameters()
                                 if p.grad is not None}

        grads(None)                                         # warm-up
        _sync(DEVICE)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        loss, got = grads(None)
        step_ms = (time.perf_counter() - t0) * 1e3
        counts = kernels.launch_counts()
        ploss, want = grads(every)
        errs = _leaf_errs(got, want)
        bwd = (counts["flash_attention_bwd"]
               + counts["flash_attention_bwd_dq"])
        res = {"launches": counts, "loss": loss, "plain_loss": ploss,
               "grad_rel_err": errs, "step_ms": step_ms}
        print(f"incubate_surface (c) {smi}: 2 FusedTransformerEncoderLayers "
              f"at config 4's widths, [{bsz}, {seq}] bf16, dropout 0: "
              "launches "
              f"fwd {counts['flash_attention_fwd']}, fused bwd "
              f"{counts['flash_attention_bwd']}, split dq/dkv "
              f"{counts['flash_attention_bwd_dq']}/"
              f"{counts['flash_attention_bwd_dkv']}; loss {loss:.6f} against "
              f"the plain route's {ploss:.6f}; grads max rel "
              f"{max(errs.values()):.3e} ({max(errs, key=errs.get)}, tol "
              f"{FLASH_TOL[torch.bfloat16]}); step {step_ms:.1f} ms",
              flush=True)
        check(counts["flash_attention_fwd"] == 2 and bwd == 2,
              f"(c) launches {counts}")
        check(max(errs.values()) <= FLASH_TOL[torch.bfloat16],
              f"(c) gradients {errs}")
        del stack
        return res

    def part_d():
        g = torch.Generator(DEVICE).manual_seed(9)
        vocab = SURFACE_SHAPE["vocab"]
        h = (torch.randn(bsz * seq, e, device=DEVICE, generator=g)
             ).to(torch.bfloat16).requires_grad_()
        w = (0.02 * torch.randn(vocab, e, device=DEVICE, generator=g)
             ).to(torch.bfloat16).requires_grad_()
        y = torch.randint(0, vocab, (bsz * seq,), device=DEVICE, generator=g)
        int8 = int8_head_enabled(h.device)

        def run(fn):
            loss = fn()
            gh, gw = torch.autograd.grad(loss, (h, w))
            return loss.item(), gh, gw

        fused = lambda: fused_linear_cross_entropy(h, w, y)     # noqa: E731
        pipe = lambda: chunked_lm_loss_arrays(h, w, y)          # noqa: E731
        lf, ghf, gwf = run(fused)
        lp, ghp, gwp = run(pipe)
        rel = abs(lf - lp) / abs(lp)
        gerr = _leaf_errs({"h": ghf, "w": gwf}, {"h": ghp, "w": gwp})
        res = {"int8_head": int8, "loss": lf, "pipe_loss": lp,
               "loss_rel": rel, "grad_rel_err": gerr,
               "ms": time_ms(lambda: run(fused), reps=5, inner=1),
               "pipe_ms": time_ms(lambda: run(pipe), reps=5, inner=1),
               "forward_ms": time_ms(lambda: fused().item(), reps=5,
                                     inner=1),
               "pipe_forward_ms": time_ms(lambda: pipe().item(), reps=5,
                                          inner=1)}
        print(f"incubate_surface (d) {smi}: fused_linear_cross_entropy "
              f"[{bsz * seq}, {e}] x [{vocab}, {e}] bf16, int8 head {int8}: "
              "loss "
              f"{lf:.6f} against the Pipe head's {lp:.6f} (rel {rel:.2e}, "
              f"tol 1e-4), grads rel {gerr}; forward+backward "
              f"{res['ms']:.2f} ms against {res['pipe_ms']:.2f}, forward "
              f"{res['forward_ms']:.2f} against {res['pipe_forward_ms']:.2f}",
              flush=True)
        check(rel <= 1e-4, f"(d) loss {lf} against {lp}")
        return res

    def part_e():
        b, hh, s, d = bsz, nh, seq, e // nh
        dtype = torch.bfloat16
        gen = torch.Generator(DEVICE).manual_seed(10)
        q, k, v, do = (torch.randn(b * hh, s, d, generator=gen,
                                   device=DEVICE).to(dtype)
                       for _ in range(4))
        o, lse = flash_attention_fwd(q, k, v, False)
        ro, rlse = flash_attention_fwd_plain(q, k, v, False)
        ferr, frel = _rel_err(o, ro)
        grads = flash_attention_bwd(q, k, v, ro, rlse, do, False)
        want = flash_attention_bwd_plain(q, k, v, ro, rlse, do, False)
        berr, brel = _rel_err(grads, want)
        check(frel <= FLASH_TOL[dtype] and brel <= FLASH_TOL[dtype],
              f"(e) non-causal rel errs {frel}, {brel}")
        q4, k4, v4, do4 = (t.view(b, hh, s, d) for t in (q, k, v, do))
        ql, kl, vl = (t.detach().requires_grad_() for t in (q4, k4, v4))
        lib = F.scaled_dot_product_attention(ql, kl, vl, is_causal=False)
        pairs = b * hh * s * s
        io = b * hh * s * d * q.element_size()
        fb, fby = bound_ms(4 * io + b * hh * s * 4, 4 * d * pairs, dtype)
        bb, bby = bound_ms(7 * io + 2 * b * hh * s * 4, 10 * d * pairs,
                           dtype)
        delta = (do.float() * ro.float()).sum(-1)
        res = {"shape": f"[{b},{s},{hh}/{hh},{d}] non-causal",
               "fwd": {"max_abs_err": ferr, "max_rel_err": frel,
                       "ms": time_ms(lambda: flash_attention_fwd(
                           q, k, v, False)),
                       "library_ms": time_ms(
                           lambda: F.scaled_dot_product_attention(
                               q4, k4, v4, is_causal=False)),
                       "bound_ms": fb, "bound_by": fby},
               "bwd": {"max_abs_err": berr, "max_rel_err": brel,
                       "ms": time_ms(lambda: flash_attention_bwd_fused(
                           q, k, v, do, rlse, delta, False)),
                       "with_delta_ms": time_ms(lambda: flash_attention_bwd(
                           q, k, v, ro, rlse, do, False)),
                       "library_ms": time_ms(lambda: torch.autograd.grad(
                           lib, (ql, kl, vl), do4, retain_graph=True)),
                       "bound_ms": bb, "bound_by": bby}}
        for key in ("fwd", "bwd"):
            r = res[key]
            print(f"incubate_surface (e) {smi}: non-causal flash {key} "
                  f"{res['shape']} bf16: {r['ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ({r['bound_by']}), SDPA "
                  f"{r['library_ms']:.4f} ms, max rel err "
                  f"{r['max_rel_err']:.3g}", flush=True)
        return res

    part("a", part_a)
    torch.cuda.empty_cache()
    part("b", part_b)
    part("c", part_c)
    torch.cuda.empty_cache()
    part("d", part_d)
    part("e", part_e)
    torch.cuda.empty_cache()
    out["launches"] = launches
    print(f"incubate_surface: {smi}: parts s "
          + ", ".join(f"{k} {v:.1f}" for k, v in out["part_seconds"].items())
          + f"; launches {launches}", flush=True)
    return out


# ---------------------------------------------------------- shared_block
def phase_shared_block(smi="", cfg4=None, batch=3, seq=2048, device=DEVICE,
                       steps=REST_STEPS, pipe_step=None):
    """Config 4's widths and depth as a per-layer GPTForCausalLM, whose
    layers run through the shared block (_make_block on the layers' own
    weights, transposed views), bf16, a warm-up and ``steps`` timed
    AdamW(factored) TrainSteps of a seeded batch x seq batch each (the
    step median over the timed ones), under (a) full recompute, (b) the
    long-context names: policy, (c) fused_addrms: launches a step
    asserted (flash fwd 2L, or L under (b); bwd L; swiglu_down 2L;
    rms_norm 4L + 1, the +1 the final norm; 2L + 1 and add_rms_norm 2L
    under (c)), finite losses with the first in phase 6's window. Readings:
    (a)'s first loss against config 4's Pipe on the same weights
    (convert_decoder_state_dict, the head pinned to f32 on both); step
    median, tokens/s and host share beside ``pipe_step`` (phase 6's
    results); the per-step copy of every down projection into the
    contiguous [M, H] swiglu_down takes (2L a step), timed. Then f32,
    depth 2, 1 x 256: the per-layer model against the Pipe on the same
    weights, and the card against the CPU, within phase 7's bounds."""
    import functools

    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                             GPTForCausalLMPipe,
                                             convert_decoder_state_dict)
    from paddle_tpu_torch.ops.kernels.swiglu_down import \
        swiglu_down_supported

    cuda = torch.device(device).type == "cuda"
    cfg_kw = dict(cfg4 or CONFIG4)
    L = cfg_kw["num_layers"]
    tokens = batch * seq
    out = {"smi": smi, "part_seconds": {}}
    launches = {}

    def model_of(cfg, seed):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return GPTForCausalLM(cfg, device=device).init_weights(gen, std=0.02)

    def batches(vocab, seed):
        return [_train_batch(vocab, batch, seq, 100 * seed + s, device)
                for s in range(steps + 1)]

    def want(cfg, fwd_per_layer, addrms=False):
        m = cfg.intermediate_size
        fused = swiglu_down_supported((batch, seq, m), (m, cfg.hidden_size))
        return {"flash_attention_fwd": fwd_per_layer * L,
                "flash_attention_bwd": L, "flash_attention_bwd_dq": 0,
                "swiglu_down": 2 * L * fused,
                "rms_norm": (2 + 2 * (not addrms)) * L + 1,
                "add_rms_norm": 2 * L * addrms} if cuda else {}

    runs = {}
    for name, kw, fwd in (("a", {}, 2),
                          ("b", {"recompute_policy": LONG_POLICY}, 1),
                          ("c", {"fused_addrms": True}, 2)):
        t0 = time.perf_counter()
        cfg = GPTConfig(**dict(cfg_kw, **kw))
        model = model_of(cfg, seed=11)
        if name == "a":
            ids, labels = _train_batch(cfg.vocab_size, batch, seq, 1100,
                                       device)
            pipe = GPTForCausalLMPipe(GPTConfig(**cfg_kw), device=device)
            pipe.load_state_dict(convert_decoder_state_dict(
                model.state_dict(), "stacked"))
            with torch.no_grad():
                first = {"per_layer": model.loss(ids, labels,
                                                 int8=False).item(),
                         "pipe": pipe.loss(ids, labels, int8=False).item()}
            del pipe
            first["rel"] = abs(first["per_layer"] - first["pipe"]) / abs(
                first["pipe"])
            out["loss_against_pipe"] = first
        res, _ = _rest_steps(f"shared_block ({name})", model, model.loss,
                             batches(cfg.vocab_size, 11), want(cfg, fwd,
                                                                "fused_addrms"
                                                                in kw),
                             profile=True)
        _first_loss_near_ln_v(f"shared_block ({name})", res["losses"][0],
                              cfg.vocab_size)
        res["warmup_step_ms"] = res["step_ms"][0]
        res["step_ms_median"] = statistics.median(res["step_ms"][1:])
        nparams = sum(p.numel() for p in model.parameters())
        tps = tokens / (res["step_ms_median"] / 1e3)
        res.update(params=nparams, tokens_per_s=tps,
                   model_flops_share=6.0 * nparams * tps
                   / PEAK_OPS[torch.bfloat16])
        print(f"shared_block ({name}) {smi}: per-layer config 4, "
              f"{kw or 'full recompute'}: {nparams / 1e9:.4f} B params, "
              f"losses {[round(x, 4) for x in res['losses']]}, step ms "
              f"{[round(x, 1) for x in res['step_ms']]} (median of the "
              f"timed steps {res['step_ms_median']:.1f}), {tps:.0f} "
              f"tokens/s, model-flops share "
              f"{res['model_flops_share']:.4f}; launches per step "
              f"{res['launches_per_step']}", flush=True)
        if name == "a" and cuda:
            wds = [l.mlp.down_proj.weight for l in model.model.layers]
            res["wd_copy_ms_per_step"] = 2 * time_ms(
                lambda: [w.t().contiguous() for w in wds], reps=5, inner=1)
        for k, v in res["launches"].items():
            launches[k] = launches.get(k, 0) + v
        runs[name] = res
        out["part_seconds"][name] = time.perf_counter() - t0
        del model
        if cuda:
            torch.cuda.empty_cache()
    out["runs"] = runs
    pipe_med = None if pipe_step is None else pipe_step["step_ms_median"]
    pipe_host = (None if pipe_step is None
                 else pipe_step.get("profile", {}).get("host_share"))
    print(f"shared_block {smi}: (a) first loss per-layer "
          f"{out['loss_against_pipe']['per_layer']:.6f} against the Pipe's "
          f"{out['loss_against_pipe']['pipe']:.6f} on the same weights (rel "
          f"{out['loss_against_pipe']['rel']:.2e}, f32 head); step medians "
          + ", ".join(f"({n}) {r['step_ms_median']:.1f} ms "
                      f"{r['tokens_per_s']:.0f} tok/s host share "
                      f"{r.get('profile', {}).get('host_share')}"
                      for n, r in runs.items())
          + f"; phase 6's Pipe step {pipe_med} ms, host share "
          f"{pipe_host}; the down projections' copies "
          f"{runs['a'].get('wd_copy_ms_per_step')} ms a step", flush=True)

    t0 = time.perf_counter()
    small = GPTConfig(**dict(cfg_kw, num_layers=2, dtype="float32"))

    def build(dev):
        m = GPTForCausalLM(small, device=dev)
        if dev == "cpu":
            m.init_weights(torch.Generator().manual_seed(12), std=0.02)
        return m

    out["card_vs_cpu"] = _rest_card_vs_cpu(
        "shared block", build, lambda m: functools.partial(m.loss,
                                                           int8=False),
        small.vocab_size, device, min(seq, 256))
    per_layer = build("cpu").to(device)
    pipe = GPTForCausalLMPipe(small, device=device)
    pipe.load_state_dict(convert_decoder_state_dict(per_layer.state_dict(),
                                                    "stacked"))
    ids, labels = _train_batch(small.vocab_size, 1, min(seq, 256), 13,
                               device)
    res = {}
    for tag, m in (("per_layer", per_layer), ("pipe", pipe)):
        loss = m.loss(ids, labels, int8=False)
        loss.backward()
        res[tag] = (loss.item(), {n: p.grad.detach().float().cpu()
                                  for n, p in m.named_parameters()})
    pl_grads = convert_decoder_state_dict(res["per_layer"][1], "stacked")
    errs = _leaf_errs(pl_grads, res["pipe"][1])
    rel = abs(res["per_layer"][0] - res["pipe"][0]) / abs(res["pipe"][0])
    out["per_layer_vs_pipe"] = {"losses": [res["per_layer"][0],
                                           res["pipe"][0]],
                                "loss_rel": rel, "grad_rel_err": errs}
    print(f"shared_block {smi}: f32 depth 2 seq {min(seq, 256)}: per-layer "
          f"loss {res['per_layer'][0]} against the Pipe's {res['pipe'][0]} "
          f"(rel {rel:.2e}, tol {TRAIN_LOSS_RTOL}); grads max rel "
          f"{max(errs.values()):.2e} (tol {TRAIN_GRAD_RTOL})", flush=True)
    check(rel <= TRAIN_LOSS_RTOL, f"per-layer against the Pipe: {rel}")
    check(max(errs.values()) <= TRAIN_GRAD_RTOL,
          f"per-layer grads against the Pipe: {errs}")
    out["part_seconds"]["f32"] = time.perf_counter() - t0
    out["launches"] = launches
    del per_layer, pipe
    if cuda:
        torch.cuda.empty_cache()
    return out


# -------------------------------------------------------- paddle_surface
#: BERT-base pretraining (BASELINE.md config 3 at degree 1): batch x seq
BERT_BATCH, BERT_SEQ = 32, 512
#: steps of (a), f32 eager, and of (b), bf16 through TrainStep, timed
SURFACE_STEPS = 3
#: (e): BERT at depth 2, f32, dropout 0, batch x seq, card against CPU
SURFACE_CPU_SHAPE = (2, 128)
#: host-cost reading (d): calls per op, after a warm-up
HOST_CALLS = 1000


def _bert_batch(paddle, vocab, batch, seq, seed):
    """Seeded token ids, MLM labels on 15% of positions (the rest -100)
    and NSP labels, as Tensors on the current place."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (batch, seq)).astype(np.int64)
    labels = np.full((batch, seq), -100, np.int64)
    pick = rng.rand(batch, seq) < 0.15
    labels[pick] = rng.randint(0, vocab, int(pick.sum()))
    nsp = rng.randint(0, 2, (batch,)).astype(np.int64)
    return (paddle.to_tensor(ids), paddle.to_tensor(labels),
            paddle.to_tensor(nsp))


def _surface_launches(L, counts, tag):
    """One BERT step: flash forward L, fused backward L, nothing else."""
    want = {name: 0 for name in counts}
    want["flash_attention_fwd"] = want["flash_attention_bwd"] = L
    check(counts == want, f"paddle_surface {tag}: launches {counts}, want "
          f"flash_attention_fwd {L}, flash_attention_bwd {L}, others 0")


def _bert_flash_case(dtype, gen, b, h, s, d):
    """The flash forward and fused backward at BERT's non-causal shape
    against their plain versions, with times, bounds, and SDPA's forward and
    autograd backward on the same data."""
    from paddle_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd_fused, flash_attention_bwd_fused_plain,
        flash_attention_fwd, flash_attention_fwd_plain)

    q, k, v, do = (torch.randn(b * h, s, d, generator=gen, device=DEVICE)
                   .to(dtype) for _ in range(4))
    shape = f"[{b},{s},{h}/{h},{d}] non-causal"
    name = str(dtype).replace("torch.", "")
    o, lse = flash_attention_fwd(q, k, v, False)
    ro, rlse = flash_attention_fwd_plain(q, k, v, False)
    err, rel = _rel_err(o, ro)
    check(rel <= FLASH_TOL[dtype], f"flash fwd {name} {shape}: rel {rel}")
    delta = (do.float() * ro.float()).sum(-1)
    grads = flash_attention_bwd_fused(q, k, v, do, rlse, delta, False)
    want = flash_attention_bwd_fused_plain(q, k, v, do, rlse, delta, False)
    berr, brel = _rel_err(grads, want)
    check(brel <= FLASH_TOL[dtype], f"flash bwd {name} {shape}: rel {brel}")
    q4, k4, v4, do4 = (t.view(b, h, s, d) for t in (q, k, v, do))
    ql, kl, vl = (t.detach().requires_grad_() for t in (q4, k4, v4))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl)
    item = q.element_size()
    pairs = b * h * s * s
    io, rows = b * h * s * d * item, b * h * s * 4
    fbms, fby = bound_ms(4 * io + rows, 4 * d * pairs, dtype)
    bbms, bby = bound_ms(7 * io + 2 * rows, 10 * d * pairs, dtype)
    fwd = {"shape": shape, "dtype": name, "max_abs_err": err,
           "max_rel_err": rel,
           "ms": time_ms(lambda: flash_attention_fwd(q, k, v, False)),
           "plain_ms": time_ms(lambda: flash_attention_fwd_plain(
               q, k, v, False), reps=5, inner=1),
           "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
               q4, k4, v4)),
           "bound_ms": fbms, "bound_by": fby}
    bwd = {"shape": shape, "dtype": name, "max_abs_err": berr,
           "max_rel_err": brel,
           "ms": time_ms(lambda: flash_attention_bwd_fused(
               q, k, v, do, rlse, delta, False)),
           "plain_ms": time_ms(lambda: flash_attention_bwd_fused_plain(
               q, k, v, do, rlse, delta, False), reps=5, inner=1),
           "library_ms": time_ms(lambda: torch.autograd.grad(
               lib_out, (ql, kl, vl), do4, retain_graph=True)),
           "bound_ms": bbms, "bound_by": bby}
    return fwd, bwd


def _host_us(fn, calls=HOST_CALLS):
    """Median host microseconds of one call, over ``calls`` calls after a
    warm-up (the card's work is queued, not waited for)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(calls):
        t = time.perf_counter()
        fn()
        samples.append((time.perf_counter() - t) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(samples)


def _wrapper_cost(paddle):
    """(d): microseconds per op through ``Tensor`` against raw torch on the
    same CUDA tensors."""
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    a = torch.randn(32, 768, generator=gen, device=DEVICE)
    b = torch.randn(32, 768, generator=gen, device=DEVICE)
    w = torch.randn(768, 768, generator=gen, device=DEVICE)
    ta, tb, tw = (paddle.to_tensor(t) for t in (a, b, w))
    lin = paddle.nn.Linear(768, 768)
    lw, lb = lin.weight._data, lin.bias._data
    pairs = {
        "add": (lambda: ta + tb, lambda: a + b),
        "matmul": (lambda: paddle.matmul(ta, tw), lambda: torch.matmul(a, w)),
        "reshape": (lambda: ta.reshape([64, 384]), lambda: a.reshape(64, 384)),
        "getitem": (lambda: ta[1:9], lambda: a[1:9]),
        "linear": (lambda: lin(ta), lambda: F.linear(a, lw.t(), lb)),
    }
    out = {}
    for name, (wrapped, raw) in pairs.items():
        out[name] = {"tensor_us": _host_us(wrapped), "torch_us": _host_us(raw)}
        out[name]["overhead_us"] = (out[name]["tensor_us"]
                                    - out[name]["torch_us"])
    return out


def phase_paddle_surface(smi="", cfg_kw=None, batch=BERT_BATCH,
                         seq=BERT_SEQ, place="gpu"):
    """BERT-base pretraining through ``import paddle_tpu_torch as paddle``:
    (f) the flash kernels at BERT's shape, (e) card against CPU at depth
    2, (a) f32 eager steps, (c) the masked route, (b) bf16 through
    ``TrainStep``, (d) the wrapper's host cost. ``cfg_kw`` (BertConfig
    overrides), ``batch``, ``seq`` and ``place="cpu"`` rehearse it small."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.dispatch import _OP_DISPATCH
    from paddle_tpu_torch.models import BertForPretraining, bert_base

    K = paddle.ops.kernels
    t_phase = time.perf_counter()
    paddle.set_device(place)
    res = {"smi": smi}
    cfg = bert_base(dropout=0.1, **(cfg_kw or {}))
    if cfg_kw is None:
        check((cfg.vocab_size, cfg.hidden_size, cfg.num_layers,
               cfg.num_heads, cfg.intermediate_size, cfg.max_seq_len)
              == (30522, 768, 12, 12, 3072, 512), "BERT-base config")
    L, V = cfg.num_layers, cfg.vocab_size
    b, s = batch, seq
    # (f) the flash kernels at BERT's shape, non-causal
    gen = torch.Generator(device=DEVICE).manual_seed(9)
    res["flash_at_bert_shape"] = {}
    for dtype in (torch.float32, torch.bfloat16):
        fwd, bwd = _bert_flash_case(dtype, gen, b, cfg.num_heads, s,
                                    cfg.hidden_size // cfg.num_heads)
        res["flash_at_bert_shape"][fwd["dtype"]] = {"fwd": fwd, "bwd": bwd}
        for tag, row in (("fwd", fwd), ("bwd", bwd)):
            print(f"paddle_surface: flash {tag} {row['dtype']} "
                  f"{row['shape']}: {row['ms']:.3f} ms, plain "
                  f"{row['plain_ms']:.3f}, sdpa {row['library_ms']:.3f}, "
                  f"bound {row['bound_ms']:.3f} ({row['bound_by']}), err "
                  f"{row['max_abs_err']:.2e}", flush=True)

    # (e) card against CPU: depth 2, f32, dropout 0, the same weights
    small = bert_base(**dict(cfg_kw or {}, num_layers=2, dropout=0.0))
    sb, ss = SURFACE_CPU_SHAPE
    got = {}
    paddle.seed(1)
    for where in ("cpu", place):
        paddle.set_device(where)
        m = BertForPretraining(small)
        if got:
            m.set_state_dict(got["cpu"][2])
        loss = m.loss(*_bert_batch(paddle, V, sb, ss, 3))
        loss.backward()
        got[where if not got else "card"] = (
            float(loss), {n: p.grad.numpy() for n, p in m.named_parameters()
                          if p.grad is not None}, m.state_dict())
    paddle.set_device(place)
    loss_rel = abs(got["card"][0] - got["cpu"][0]) / abs(got["cpu"][0])
    g_cpu, g_gpu = got["cpu"][1], got["card"][1]
    check(set(g_cpu) == set(g_gpu), "card vs cpu: other leaves have grads")
    top = max(np.linalg.norm(g) for g in g_cpu.values())
    # the key biases' exact gradient is 0 (softmax ignores a shift common
    # to a row): their norm is measured against 1e-4 of the largest leaf's
    grad_rel = {n: float(np.linalg.norm(g_gpu[n] - g)
                         / max(np.linalg.norm(g), 1e-4 * top))
                for n, g in g_cpu.items()}
    worst = max(grad_rel, key=grad_rel.get)
    check(loss_rel <= TRAIN_LOSS_RTOL, f"card vs cpu loss rel {loss_rel}")
    check(grad_rel[worst] <= TRAIN_GRAD_RTOL,
          f"card vs cpu grad {worst} rel {grad_rel[worst]}")
    res["card_vs_cpu"] = {"losses": [got["cpu"][0], got["card"][0]],
                          "loss_rel": loss_rel, "grad_rel_max": grad_rel[worst],
                          "grad_rel_worst": worst}
    print(f"paddle_surface: depth 2 card vs cpu loss rel {loss_rel:.2e} "
          f"(tol {TRAIN_LOSS_RTOL}), grads max rel {grad_rel[worst]:.2e} "
          f"({worst}, tol {TRAIN_GRAD_RTOL})", flush=True)
    del got

    torch.cuda.reset_peak_memory_stats()
    paddle.seed(0)
    model = BertForPretraining(cfg)
    nparams = sum(p.size for p in model.parameters())
    res["params"] = nparams
    launches = {name: 0 for name in K.launch_counts()}

    # (a) f32, eager: loss.backward(), opt.step(), opt.clear_grad()
    opt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=model.parameters())

    def eager_step(ids, labels, nsp):
        loss = model.loss(ids, labels, nsp)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    losses, step_ms = [], []
    for i in range(SURFACE_STEPS):
        batch = _bert_batch(paddle, V, b, s, 100 + i)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        loss = eager_step(*batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        counts = K.launch_counts()
        _surface_launches(L, counts, f"f32 eager step {i}")
        for name, n in counts.items():
            launches[name] += n
        losses.append(float(loss))
    check(all(np.isfinite(losses)), f"f32 losses {losses}")
    # one repeated batch: AdamW without warmup at 1e-4 still carries the
    # momentum of the earlier batches into the first step on it, which
    # can raise its loss (both packages on the CPU do the same), so the
    # third loss on it is held below the first
    rep = _bert_batch(paddle, V, b, s, 7)
    repeated = [float(eager_step(*rep)) for _ in range(3)]
    check(repeated[2] < repeated[0], f"repeated batch not learned: {repeated}")
    med = statistics.median(step_ms)
    _OP_DISPATCH.clear()
    paddle.telemetry.enable()
    eager_step(*rep)
    paddle.telemetry.disable()
    ops = _OP_DISPATCH.series()
    prof = _profile_step(eager_step, rep, med)
    res["f32_eager"] = {
        "losses": losses, "first_loss": losses[0],
        "ln_vocab_plus_ln2": float(np.log(V) + np.log(2)),
        "repeated_batch_losses": repeated, "step_ms": step_ms,
        "step_ms_median": med, "tokens_per_s": b * s / (med / 1e3),
        "host_share": prof["host_share"],
        "device_busy_ms": prof["device_busy_ms"],
        "by_group_ms": prof["by_group_ms"],
        "port_kernels_ms": prof["port_kernels_ms"],
        "top_kernels_ms": prof["top_kernels_ms"],
        "ops_per_step": sum(ops.values()),
        "top_ops": sorted(((k[0], v) for k, v in ops.items()),
                          key=lambda kv: -kv[1])[:8]}
    print(f"paddle_surface: BERT-base {nparams / 1e6:.1f} M params, batch "
          f"{b} x {s}; f32 eager losses {[round(x, 4) for x in losses]} "
          f"(ln V + ln 2 = {res['f32_eager']['ln_vocab_plus_ln2']:.4f}), "
          f"repeated batch {[round(x, 4) for x in repeated]}; step median "
          f"{med:.1f} ms ({[round(x, 1) for x in step_ms]}), host share "
          f"{prof['host_share']}, {sum(ops.values())} ops a step", flush=True)

    # (c) the masked route: an all-ones attention_mask against none
    model.eval()
    ids = _bert_batch(paddle, V, b, s, 100)[0]
    with paddle.no_grad():
        K.reset_launch_counts()
        free, _ = model.bert(ids)
        free_counts = K.launch_counts()
        K.reset_launch_counts()
        masked, _ = model.bert(ids, attention_mask=paddle.ones([b, s],
                                                               "int64"))
        masked_counts = K.launch_counts()
    check(free_counts["flash_attention_fwd"] == L,
          f"unmasked forward launches {free_counts}")
    check(sum(masked_counts.values()) == 0,
          f"masked forward launched {masked_counts}")
    merr, mrel = _rel_err(masked._data, free._data)
    check(mrel <= FLASH_TOL[torch.float32],
          f"masked vs unmasked: rel err {mrel}")
    res["masked_route"] = {"max_abs_err": merr, "max_rel_err": mrel,
                           "tol": FLASH_TOL[torch.float32],
                           "masked_launches": masked_counts}
    model.train()
    del free, masked, opt
    print(f"paddle_surface: masked route max abs err {merr:.3e} (rel "
          f"{mrel:.3e}, tol {FLASH_TOL[torch.float32]}), 0 flash launches",
          flush=True)

    # (b) bf16 through jit.TrainStep: model.bfloat16(), AdamW(multi_precision)
    model.bfloat16()
    opt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=model.parameters(),
                                 multi_precision=True)
    step = paddle.jit.TrainStep(model, lambda i, y, n: model.loss(i, y, n),
                                opt)
    torch.cuda.reset_peak_memory_stats()
    bf_losses = [float(step(*_bert_batch(paddle, V, b, s, 200)))]  # warm-up
    bf_ms = []
    for i in range(SURFACE_STEPS):
        batch = _bert_batch(paddle, V, b, s, 201 + i)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        loss = step(*batch)
        torch.cuda.synchronize()
        bf_ms.append((time.perf_counter() - t0) * 1e3)
        counts = K.launch_counts()
        _surface_launches(L, counts, f"bf16 TrainStep step {i}")
        for name, n in counts.items():
            launches[name] += n
        bf_losses.append(float(loss))
    check(all(np.isfinite(bf_losses)), f"bf16 losses {bf_losses}")
    bf_med = statistics.median(bf_ms)
    tps = b * s / (bf_med / 1e3)
    bprof = _profile_step(step, batch, bf_med)
    res["bf16_train_step"] = {
        "losses": bf_losses, "step_ms": bf_ms, "step_ms_median": bf_med,
        "tokens_per_s": tps,
        "model_flops_share": 6.0 * nparams * tps / PEAK_OPS[torch.bfloat16],
        "model_flops_formula": "6 * params * tokens_per_s / 989e12 "
                               "(phase 6's; H100 SXM dense bf16)",
        "host_share": bprof["host_share"],
        "device_busy_ms": bprof["device_busy_ms"],
        "by_group_ms": bprof["by_group_ms"],
        "port_kernels_ms": bprof["port_kernels_ms"],
        "top_kernels_ms": bprof["top_kernels_ms"],
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    r = res["bf16_train_step"]
    print(f"paddle_surface: bf16 TrainStep losses "
          f"{[round(x, 4) for x in bf_losses]}; step median {bf_med:.1f} ms "
          f"({[round(x, 1) for x in bf_ms]}), {tps:.0f} tokens/s, "
          f"model-flops share {r['model_flops_share']:.4f}, host share "
          f"{r['host_share']}, peak memory {r['peak_memory_gib']:.1f} GiB",
          flush=True)
    del step, opt, model
    torch.cuda.empty_cache()
    res["launches"] = launches

    # (d) the wrapper's host cost
    res["wrapper_us"] = _wrapper_cost(paddle)
    print("paddle_surface: host us per op (Tensor / torch): " + json.dumps(
        {k: [round(v["tensor_us"], 2), round(v["torch_us"], 2)]
         for k, v in res["wrapper_us"].items()}), flush=True)

    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    return res


# ------------------------------------------------------------ phase vision
VISION_BATCH = 256            # the per-256 batch of the ImageNet recipe
VISION_LR = 0.1               # 0.1 per 256 images (Goyal et al. 2017)
VISION_STEPS = 3
VISION_LOADER_BATCHES = 8
VISION_WORKERS = 4
LENET_EPOCHS = 6
#: the card against the CPU: a conv's sums run in another order (no TF32)
VISION_CONV_TOL = 1e-4        # of the output's largest entry
PEAK_TF32 = 494.7e12          # H100 SXM dense TF32
#: where a vision step's time goes, by kernel name (the first match wins):
#: cuDNN's convs with their layout transposes and the head's GEMM; the
#: pools; the reductions (the norms' statistics and their backward); every
#: other elementwise pass (the norms, ReLUs, residual adds, the optimizer)
VISION_KERNEL_GROUPS = {
    "conv_gemm": ("conv", "xmma", "implicit_gemm", "wgrad", "dgrad", "cudnn",
             "nchwToNhwc", "nhwcToNchw", "sm80_", "sm90_", "nvjet",
             "gemm"),
    "pool": ("pool",),
    "reduce": ("reduce_kernel",),
    "elementwise": ("elementwise",),
}
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _fake_mnist(paddle, n, seed):
    """``tests/test_hapi_lenet.py``'s separable digits: a band of rows per
    label under 0.05 noise."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, (n,))
    images = np.zeros((n, 1, 28, 28), np.float32)
    for i, lab in enumerate(labels):
        images[i, 0, lab * 2:lab * 2 + 4, :] = 1.0
        images[i] += rng.randn(1, 28, 28).astype(np.float32) * 0.05

    class FakeMNIST(paddle.io.Dataset):
        def __getitem__(self, idx):
            return images[idx], np.int64(labels[idx])

        def __len__(self):
            return n

    return FakeMNIST()


def _conv_macs(paddle, model, image):
    """Multiply-adds of one ``image`` x ``image`` forward: every Conv2D
    (out_h * out_w * out_c * in_c / groups * k_h * k_w) and Linear (in *
    out), counted by forward hooks on a batch of 1."""
    macs = []

    def conv_hook(layer, inputs, out):
        k = layer.weight.shape
        macs.append(out.shape[2] * out.shape[3] * k[0] * k[1] * k[2] * k[3])

    def linear_hook(layer, inputs, out):
        macs.append(layer.weight.shape[0] * layer.weight.shape[1])

    hooks = [layer.register_forward_post_hook(
        conv_hook if isinstance(layer, paddle.nn.Conv2D) else linear_hook)
        for layer in model.sublayers()
        if isinstance(layer, (paddle.nn.Conv2D, paddle.nn.Linear))]
    was_training = model.training
    model.eval()
    with paddle.no_grad():
        model(paddle.zeros([1, 3, image, image]))
    if was_training:
        model.train()
    for h in hooks:
        h.remove()
    return sum(macs)


def _cuda_ms(fn, reps=3):
    """``fn()``'s device time (ms) by CUDA events: the median of ``reps``
    after one warm-up call."""
    fn()
    ms = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        ms.append(t0.elapsed_time(t1))
    return statistics.median(ms)


def _batch_norm_ms(paddle, model, b, image):
    """The batch norms of one training step, timed apart from the step:
    each ``BatchNorm2D``'s input shape from forward hooks on a 1-image
    forward, then for each distinct shape a fresh ``BatchNorm2D`` in
    train mode, its forward and backward (the gradients of the input, the
    gain and the bias, as in the step) at batch ``b``, times the number
    of the model's norms at that shape. Returns the total (ms) and
    ``{"CxHxW": [layers, ms of one]}``."""
    import collections

    shapes = []

    def hook(layer, inputs, out):
        shapes.append(tuple(inputs[0].shape[1:]))

    hooks = [layer.register_forward_post_hook(hook)
             for layer in model.sublayers()
             if isinstance(layer, paddle.nn.BatchNorm2D)]
    was_training = model.training
    model.eval()
    with paddle.no_grad():
        model(paddle.zeros([1, 3, image, image]))
    if was_training:
        model.train()
    for h in hooks:
        h.remove()
    per = {}
    for (c, h, w), n in collections.Counter(shapes).items():
        bn = paddle.nn.BatchNorm2D(c)
        x = paddle.randn([b, c, h, w])
        x.stop_gradient = False
        g = torch.randn(b, c, h, w, device=x._data.device)
        leaves = [x._data, bn.weight._data, bn.bias._data]

        def fwd_bwd():
            torch.autograd.grad(bn(x)._data, leaves, g)

        per[f"{c}x{h}x{w}"] = [n, _cuda_ms(fwd_bwd)]
        del bn, x, g, leaves
    return sum(n * ms for n, ms in per.values()), per


def _optimizer_ms(paddle, lr):
    """The step's optimizer timed apart from it: ``_vision_step``'s
    Momentum with L2 decay over a second ResNet-50's parameters, each
    with a random gradient."""
    net = paddle.vision.models.resnet50()
    opt = paddle.optimizer.Momentum(
        learning_rate=lr, momentum=0.9,
        weight_decay=paddle.regularizer.L2Decay(1e-4),
        parameters=net.parameters())
    for p in net.parameters():
        p._data.grad = torch.randn_like(p._data)
    ms = _cuda_ms(opt.step)
    del opt, net
    return ms


def _iterable_loader_check(paddle, workers, n=16):
    """An IterableDataset whose ``__iter__`` makes each sample with
    ``paddle.to_tensor`` (in a forked worker that must be a CPU tensor),
    sharded by ``io.get_worker_info``, read by ``workers`` processes:
    every sample arrives once and each batch holds its own labels. Returns
    the one device type of every batch."""
    class Stream(paddle.io.IterableDataset):
        def __iter__(self):
            info = paddle.io.get_worker_info()
            for i in range(info.id, n, info.num_workers):
                yield (paddle.to_tensor(np.full((3, 8, 8), i, np.float32)),
                       np.int64(i))

    seen, types = [], set()
    for x, y in paddle.io.DataLoader(Stream(), batch_size=4,
                                     num_workers=workers):
        types |= {x._data.device.type, y._data.device.type}
        check((x.numpy()[:, 0, 0, 0] == y.numpy()).all(),
              "an iterable batch's images and labels parted")
        seen += y.numpy().tolist()
    check(sorted(seen) == list(range(n)), f"iterable loader gave {seen}")
    check(len(types) == 1, f"iterable batches on {types}")
    return types.pop()


def _damped(paddle, model, last_bn):
    """``model`` with the last batch norm of each residual branch at a
    fifth of its gain, as nets are initialised to train well: a deep net
    in train mode at a batch of 2 is otherwise so ill-conditioned that two
    libraries' f32 sums part by percents."""
    with paddle.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("layer") and name.endswith(last_bn):
                p.set_value(p * 0.2)
    return model


def _vision_card_vs_cpu(paddle, place):
    """(e): one train step of LeNet and of resnet18 (4 classes) in f32 on
    the card against the CPU on the same weights (TF32 off), and the
    conv and pooling functionals at the forms the reference's quirks
    live in. Returns the readings."""
    F = paddle.nn.functional
    res = {}
    rng = np.random.RandomState(11)
    cases = {
        "lenet": (lambda: paddle.vision.models.LeNet(), (4, 1, 28, 28)),
        "resnet18": (lambda: _damped(paddle, paddle.vision.models.resnet18(
            num_classes=4), "bn2.weight"), (2, 3, 64, 64)),
    }
    for tag, (build, shape) in cases.items():
        x = rng.randn(*shape).astype(np.float32)
        y = rng.randint(0, 10 if tag == "lenet" else 4,
                        (shape[0],)).astype(np.int64)
        got, init = {}, None
        for where in ("cpu", place):
            paddle.set_device(where)
            paddle.seed(12)
            m = build()
            if init is None:
                init = {k: v.numpy() for k, v in m.state_dict().items()}
            else:
                m.set_state_dict(init)
            m.train()
            loss = F.cross_entropy(m(paddle.to_tensor(x)),
                                   paddle.to_tensor(y))
            loss.backward()
            got["card" if got else "cpu"] = (
                float(loss),
                {n: p.grad.numpy() for n, p in m.named_parameters()},
                {k: v.numpy() for k, v in m.state_dict().items()})
        loss_rel = abs(got["card"][0] - got["cpu"][0]) / abs(got["cpu"][0])
        grad_rel = {n: float(np.linalg.norm(got["card"][1][n] - g)
                             / max(np.linalg.norm(g), 1e-12))
                    for n, g in got["cpu"][1].items()}
        worst = max(grad_rel, key=grad_rel.get)
        stat_err = max([float(np.abs(got["card"][2][k] - v).max())
                        for k, v in got["cpu"][2].items()
                        if k.endswith(("_mean", "_variance"))] or [0.0])
        check(loss_rel <= TRAIN_LOSS_RTOL, f"{tag} card vs cpu loss rel "
              f"{loss_rel}")
        check(grad_rel[worst] <= TRAIN_GRAD_RTOL, f"{tag} card vs cpu grad "
              f"{worst} rel {grad_rel[worst]}")
        check(stat_err <= 1e-5, f"{tag} running statistics err {stat_err}")
        res[tag] = {"loss_rel": loss_rel, "grad_rel_max": grad_rel[worst],
                    "grad_rel_worst": worst, "stat_abs_err": stat_err,
                    "shape": list(shape)}

    x = rng.randn(2, 8, 17, 15).astype(np.float32)
    w = rng.randn(8, 4, 3, 3).astype(np.float32)
    wt = rng.randn(8, 3, 3, 3).astype(np.float32)
    xt = rng.randn(2, 8, 7, 6).astype(np.float32)

    def nhwc(a):
        return a.transpose([0, 2, 3, 1])

    funcs = {
        "conv2d_groups_dilation": lambda t: F.conv2d(
            t(x), t(w), groups=2, dilation=2, padding=[1, 2, 0, 1]),
        "conv2d_same_s2_nchw": lambda t: F.conv2d(
            t(x), t(w), stride=2, padding="SAME", groups=2),
        "conv2d_same_s2_nhwc": lambda t: F.conv2d(
            nhwc(t(x)), t(w), stride=2, padding="SAME", groups=2,
            data_format="NHWC"),
        "conv2d_transpose_output_size": lambda t: F.conv2d_transpose(
            t(xt), t(wt), stride=2, padding=1, output_size=[14, 12]),
        "avg_pool2d_exclusive": lambda t: F.avg_pool2d(
            t(x), 3, 2, [0, 1, 1, 2], exclusive=True),
        "avg_pool2d_inclusive": lambda t: F.avg_pool2d(
            t(x), 3, 2, 1, exclusive=False),
        "adaptive_avg_pool2d": lambda t: F.adaptive_avg_pool2d(t(x), [4, 6]),
        "adaptive_max_pool2d": lambda t: F.adaptive_max_pool2d(t(x), [5, 4]),
        "max_pool2d": lambda t: F.max_pool2d(t(x), 3, 2, 1),
        "max_pool2d_mask": lambda t: F.max_pool2d(t(x), 3, 2, 1,
                                                  return_mask=True)[1],
    }
    res["functionals"] = {}
    for name, fn in funcs.items():
        outs = {}
        for where in ("cpu", place):
            paddle.set_device(where)
            outs[where] = fn(paddle.to_tensor).numpy()
        a, b = outs["cpu"], outs[place]
        check(a.shape == b.shape, f"{name} shapes {a.shape} {b.shape}")
        if name == "max_pool2d_mask":
            check(np.array_equal(a, b) and b.dtype == np.int32,
                  f"{name} not bitwise equal")
            err = 0.0
        else:
            err = float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-12))
            tol = VISION_CONV_TOL if name.startswith("conv") else 1e-6
            check(err <= tol, f"{name} card vs cpu rel err {err}")
        res["functionals"][name] = err
    paddle.set_device(place)
    return res



def _vision_step(paddle, model, lr):
    """``Momentum(lr, 0.9, L2Decay(1e-4))`` through ``jit.TrainStep`` over
    cross entropy."""
    opt = paddle.optimizer.Momentum(
        learning_rate=lr, momentum=0.9,
        weight_decay=paddle.regularizer.L2Decay(1e-4),
        parameters=model.parameters())
    step = paddle.jit.TrainStep(
        model, lambda x, y: paddle.nn.functional.cross_entropy(model(x), y),
        opt)
    return step, opt


def _imagenet_batch(paddle, b, image, seed, dtype="float32"):
    """A seeded batch: N(0, 1) images and labels uniform over 1000, made
    on the card."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn(b, 3, image, image, generator=gen, device=DEVICE)
    y = torch.randint(0, 1000, (b,), generator=gen, device=DEVICE)
    return (paddle.to_tensor(x).astype(dtype), paddle.to_tensor(y))


def _timed_steps(step, batches):
    """Each step's wall time (ms) with the card drained before and after,
    and the losses."""
    ms, losses = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(*batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    return ms, losses


def _step_readings(ms, flops, peak, b, prof):
    med = statistics.median(ms)
    return {"step_ms": ms, "step_ms_median": med,
            "images_per_s": b / (med / 1e3),
            "model_flops_share": flops / (med / 1e3) / peak,
            "host_share": prof["host_share"],
            "device_busy_ms": prof["device_busy_ms"],
            "by_kernel_group_ms": prof["by_kernel_group_ms"],
            "top_kernels_ms": prof["top_kernels_ms"]}


def phase_vision(smi="", batch=VISION_BATCH, image=224, lr=VISION_LR,
                 place="gpu", lenet_epochs=LENET_EPOCHS):
    """The vision path through ``import paddle_tpu_torch as paddle``: (e)
    the card against the CPU, (a) config 1 (LeNet through ``Model.fit``),
    (b) config 2 at degree 1 (ResNet-50, f32, TF32 on and off), (d) the
    same step fed by ``io.DataLoader`` over ``vision.datasets.FakeData``
    with 4 worker processes, (c) ResNet-50 in bf16. ``batch``, ``image``,
    ``lenet_epochs`` and ``place="cpu"`` rehearse it small."""
    import os

    import paddle_tpu_torch as paddle

    K = paddle.ops.kernels
    t_phase = time.perf_counter()
    paddle.set_device(place)
    res = {"smi": smi}
    # CUDA starts in this process before any loader forks (trap of the
    # forked workers)
    paddle.zeros([1])
    K.reset_launch_counts()

    # (e) card against CPU
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        res["card_vs_cpu"] = _vision_card_vs_cpu(paddle, place)
    cv = res["card_vs_cpu"]
    print(f"vision: card vs cpu lenet loss rel {cv['lenet']['loss_rel']:.2e}"
          f" grad {cv['lenet']['grad_rel_max']:.2e}; resnet18 loss rel "
          f"{cv['resnet18']['loss_rel']:.2e} grad "
          f"{cv['resnet18']['grad_rel_max']:.2e} stats "
          f"{cv['resnet18']['stat_abs_err']:.2e}; functionals max rel "
          f"{max(cv['functionals'].values()):.2e}, mask bitwise", flush=True)

    # (a) config 1: LeNet through Model.fit
    paddle.seed(0)
    model = paddle.Model(paddle.vision.models.LeNet(num_classes=10))
    model.prepare(paddle.optimizer.Adam(
        learning_rate=1e-3, parameters=model.network.parameters()),
        paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy())
    train = paddle.io.DataLoader(_fake_mnist(paddle, 256, 0), batch_size=64,
                                 shuffle=True)
    _sync(DEVICE)
    t0 = time.perf_counter()
    model.fit(train, epochs=lenet_epochs, verbose=0)
    _sync(DEVICE)
    fit_s = time.perf_counter() - t0
    held = paddle.io.DataLoader(_fake_mnist(paddle, 128, 1), batch_size=64)
    ev = model.evaluate(held, verbose=0)
    preds = model.predict(held)
    out0 = preds[0][0] if isinstance(preds[0], (list, tuple)) else preds[0]
    check(ev["acc"] > 0.8, f"LeNet held-out accuracy {ev}")
    check(out0.shape[-1] == 10 and len(preds) == 2,
          f"LeNet predictions {out0.shape} x {len(preds)}")
    steps = lenet_epochs * len(train)
    res["lenet_fit"] = {"epochs": lenet_epochs, "steps": steps,
                        "fit_s": fit_s, "steps_per_s": steps / fit_s,
                        "eval": ev, "pred_shape": out0.shape}
    print(f"vision: LeNet Model.fit {lenet_epochs} epochs ({steps} steps) "
          f"{fit_s:.2f} s, {steps / fit_s:.1f} steps/s; held-out {ev}",
          flush=True)
    del model, train, held, preds

    # (b) config 2 at degree 1: ResNet-50, f32, NCHW
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    paddle.seed(0)
    net = paddle.vision.models.resnet50()
    nparams = sum(p.size for p in net.parameters())
    check(abs(nparams - 25.56e6) < 0.05e6, f"ResNet-50 params {nparams}")
    macs = _conv_macs(paddle, net, image)
    flops = 6.0 * macs * batch          # 2 FLOP a MAC, forward + 2 x back
    # random init at the reference's initializers: logits of spread s give
    # a first loss near ln 1000 + s^2 / 2 (train mode, the first batch)
    with paddle.no_grad(), torch.backends.cudnn.flags(enabled=True,
                                                      allow_tf32=True):
        logits = net(_imagenet_batch(paddle, batch, image, 200)[0])
    spread = float(logits.astype("float32").std())
    want_first = float(np.log(1000) + spread ** 2 / 2)
    del logits
    stats0 = {k: v.numpy().copy() for k, v in net.state_dict().items()
              if k.endswith(("_mean", "_variance"))}
    step, opt = _vision_step(paddle, net, lr)
    b = batch
    res["resnet50"] = {"params": nparams, "batch": b, "image": image,
                       "lr": lr, "macs_per_image": macs,
                       "flops_per_step": flops,
                       "flops_formula": "6 * conv+linear MACs per image "
                                        "* batch (hooks on a 1-image "
                                        "forward)"}
    f32 = {}
    first = None
    for tag, tf32 in (("tf32_default", True), ("tf32_off", False)):
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=tf32):
            batches = [_imagenet_batch(paddle, b, image, 100 * (tf32 + 1) + i)
                       for i in range(VISION_STEPS + 1)]
            warm = float(step(*batches[0]))
            first = warm if first is None else first
            ms, losses = _timed_steps(step, batches[1:])
            prof = _profile_step(step, batches[1], statistics.median(ms),
                                 VISION_KERNEL_GROUPS)
        peak = PEAK_TF32 if tf32 else PEAK_OPS[torch.float32]
        f32[tag] = dict(_step_readings(ms, flops, peak, b, prof),
                        losses=[warm] + losses,
                        cudnn_allow_tf32=tf32,
                        matmul_allow_tf32=torch.backends.cuda.matmul.
                        allow_tf32, peak_flops=peak)
        check(all(np.isfinite(f32[tag]["losses"])), f"f32 losses {f32[tag]}")
        del batches
    f32["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    check(abs(first - want_first) <= 0.5,
          f"first loss {first}, ln 1000 + s^2/2 = {want_first}")
    stats1 = {k: v.numpy() for k, v in net.state_dict().items()
              if k.endswith(("_mean", "_variance"))}
    check(len(stats1) == 106, f"{len(stats1)} running statistics")
    check(all(np.isfinite(v).all() and not np.array_equal(v, stats0[k])
              for k, v in stats1.items()),
          "running statistics unchanged or not finite")
    f32.update(first_loss=first, logit_std=spread,
               ln1000_plus_half_s2=want_first)
    # the decomposed batch norms and the optimizer, each timed apart
    bn_ms, bn_shapes = _batch_norm_ms(paddle, net, b, image)
    opt_ms = _optimizer_ms(paddle, lr)
    nbn = sum(n for n, _ in bn_shapes.values())
    check(nbn == 53, f"{nbn} batch norms timed")
    busy = f32["tf32_default"]["device_busy_ms"]
    f32["apart"] = {"batch_norms_ms": bn_ms, "optimizer_ms": opt_ms,
                    "batch_norm_shapes": bn_shapes,
                    "batch_norms_share_of_busy": bn_ms / busy,
                    "optimizer_share_of_busy": opt_ms / busy}
    res["resnet50"]["f32"] = f32
    for tag in ("tf32_default", "tf32_off"):
        r = f32[tag]
        print(f"vision: ResNet-50 f32 batch {b} ({tag}) step median "
              f"{r['step_ms_median']:.1f} ms {[round(v, 1) for v in r['step_ms']]}"
              f", {r['images_per_s']:.0f} images/s, model-flops share "
              f"{r['model_flops_share']:.3f} of {r['peak_flops'] / 1e12:.1f} "
              f"TFLOP/s, host share {r['host_share']}, busy by kernel "
              f"group {r['by_kernel_group_ms']}, losses "
              f"{[round(v, 3) for v in r['losses']]}", flush=True)
    print(f"vision: ResNet-50 {nparams / 1e6:.2f} M params, {macs / 1e9:.2f} "
          f"G MACs an image, first loss {first:.3f} (ln 1000 + s^2/2 = "
          f"{want_first:.3f}, s {spread:.3f}), peak memory "
          f"{f32['peak_memory_gib']:.1f} GiB", flush=True)
    print(f"vision: timed apart, the {nbn} batch norms' forward and backward "
          f"{bn_ms:.1f} ms ({bn_ms / busy:.3f} of the TF32 step's busy "
          f"{busy:.1f} ms), the Momentum update {opt_ms:.2f} ms "
          f"({opt_ms / busy:.3f})", flush=True)

    # (d) the same f32 step fed by the loader, after CUDA started here
    normalize = paddle.vision.transforms.Normalize(IMAGENET_MEAN,
                                                   IMAGENET_STD)

    def to_tensor_after_normalize(img):
        return paddle.to_tensor(normalize(img))

    data = paddle.vision.datasets.FakeData(
        size=VISION_LOADER_BATCHES * b, image_shape=(3, image, image),
        num_classes=1000, transform=to_tensor_after_normalize)
    loader = paddle.io.DataLoader(data, batch_size=b, shuffle=True,
                                  num_workers=VISION_WORKERS)
    labels_of = paddle.vision.datasets.FakeData(
        size=VISION_LOADER_BATCHES * b, image_shape=(3, image, image),
        num_classes=1000)
    fed = {}
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        t0 = time.perf_counter()
        it = iter(loader)
        pids = [p.pid for p in it._workers]
        order = [list(ix) for ix in it._batches]
        got = list(it)
        _sync(DEVICE)
        alone_s = time.perf_counter() - t0
        check(len(got) == VISION_LOADER_BATCHES, f"{len(got)} batches")
        check(os.getpid() not in pids and len(set(pids)) == VISION_WORKERS,
              f"worker pids {pids} parent {os.getpid()}")
        for (x, y), ix in zip(got, order):
            check(x._data.device.type == torch.device(DEVICE).type,
                  f"batch on {x._data.device}")
            check(list(x.shape) == [b, 3, image, image]
                  and x.dtype == paddle.float32, f"batch {x.shape}")
            check(y.numpy().tolist() == [int(labels_of[i][1]) for i in ix],
                  "labels out of the sampler's order")
        del got
        fed["loader_alone_s"] = alone_s
        fed["loader_images_per_s"] = VISION_LOADER_BATCHES * b / alone_s
        it = iter(loader)
        ms, wait_ms = [], []
        for _ in range(VISION_LOADER_BATCHES - 2):
            _sync(DEVICE)
            t0 = time.perf_counter()
            x, y = next(it)
            wait_ms.append((time.perf_counter() - t0) * 1e3)
            loss = step(x, y)
            _sync(DEVICE)
            ms.append((time.perf_counter() - t0) * 1e3)
            check(np.isfinite(float(loss)), "fed loss not finite")

        def fed_step():
            return step(*next(it))

        # the last two batches back to back: the gap between them is the
        # wait for the next batch and the step's host work
        med = statistics.median(ms)
        prof = _profile_step(fed_step, (), 2 * med, repeat=2)
        fed.update(step_ms=ms, step_ms_median=med, next_wait_ms=wait_ms,
                   next_wait_ms_median=statistics.median(wait_ms),
                   resident_step_ms_median=f32["tf32_default"][
                       "step_ms_median"],
                   host_share_2_steps=1 - prof["device_union_ms"] / (2 * med),
                   device_union_ms_2_steps=prof["device_union_ms"],
                   longest_idle_ms_2_steps=prof["longest_idle_ms"],
                   top_kernels_ms_2_steps=prof["top_kernels_ms"],
                   workers=VISION_WORKERS, worker_pids=pids)
        # an IterableDataset's workers, forked after CUDA started here
        fed["iterable_batches_on"] = _iterable_loader_check(paddle, 2)
        check(fed["iterable_batches_on"] == torch.device(DEVICE).type,
              f"iterable batches on {fed['iterable_batches_on']}")
    res["resnet50"]["fed"] = fed
    del it, loader
    print(f"vision: loader alone {fed['loader_images_per_s']:.0f} images/s "
          f"({VISION_WORKERS} workers); fed step median {med:.1f} ms against "
          f"resident {fed['resident_step_ms_median']:.1f} ms, of it the wait "
          f"for the batch {[round(v, 1) for v in wait_ms]} ms; two fed "
          f"steps back to back: host share "
          f"{fed['host_share_2_steps']:.3f}, longest idle "
          f"{fed['longest_idle_ms_2_steps']:.1f} ms, top kernels "
          f"{[(k[:40], round(v, 1)) for k, v in prof['top_kernels_ms'][:4]]}"
          f"; an iterable loader's batches on "
          f"{fed['iterable_batches_on']}", flush=True)

    # (c) ResNet-50 in bf16: model.bfloat16() with its buffers
    del step, opt
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net.bfloat16()
    check(all(b_.dtype == paddle.bfloat16 for b_ in net.buffers()),
          "bfloat16() left a buffer in f32")
    step, opt = _vision_step(paddle, net, lr)
    batches = [_imagenet_batch(paddle, b, image, 300 + i, "bfloat16")
               for i in range(VISION_STEPS + 1)]
    warm = float(step(*batches[0]))
    ms, losses = _timed_steps(step, batches[1:])
    prof = _profile_step(step, batches[1], statistics.median(ms),
                         VISION_KERNEL_GROUPS)
    bf = dict(_step_readings(ms, flops, PEAK_OPS[torch.bfloat16], b, prof),
              losses=[warm] + losses,
              peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    check(all(np.isfinite(bf["losses"])), f"bf16 losses {bf['losses']}")
    res["resnet50"]["bf16"] = bf
    print(f"vision: ResNet-50 bf16 step median {bf['step_ms_median']:.1f} ms "
          f"{[round(v, 1) for v in ms]}, {bf['images_per_s']:.0f} images/s, "
          f"model-flops share {bf['model_flops_share']:.3f}, host share "
          f"{bf['host_share']}, busy by kernel group "
          f"{bf['by_kernel_group_ms']}, peak memory "
          f"{bf['peak_memory_gib']:.1f} GiB, "
          f"losses {[round(v, 3) for v in bf['losses']]}", flush=True)
    del step, opt, net, batches
    torch.cuda.empty_cache()
    res["launches"] = K.launch_counts()
    res["seconds"] = time.perf_counter() - t_phase
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="write every measurement here as JSON")
    ap.add_argument("--quick", action="store_true",
                    help="phases 1-3 and flash_widths only; no result line")
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
    report["flash_widths"] = run("flash_widths", phase_flash_widths,
                                 report["kernels"], report["build"]["ptxas"])
    if not args.quick:
        report["serving"], model, streams = run("serving", phase_serving)
        report["serving_int8"] = run("serving_int8", phase_serving_int8,
                                     model, report["serving"], streams)
        report["serving_engine"] = run("serving_engine",
                                       phase_serving_engine, model, streams)
        report["serving_spec"] = run("serving_spec", phase_serving_spec,
                                     model, streams)
        report["serving_int8w"] = run("serving_int8w", phase_serving_int8w,
                                      model, report["serving"], streams)
        report["serving_disagg"] = run("serving_disagg",
                                       phase_serving_disagg, model, streams)
        report["serving_fleet"] = run("serving_fleet", phase_serving_fleet,
                                      model, streams)
        report["telemetry"] = run("telemetry", phase_telemetry, model,
                                  streams)
        report["incubate"] = run("incubate", phase_incubate, model)
        report["incubate_surface"] = run(
            "incubate_surface", phase_incubate_surface, model,
            report["device"]["smi"])
        del model
        torch.cuda.empty_cache()
        report["consistency"], model, prompts, want = run(
            "consistency", phase_consistency)
        report["int8_consistency"] = run(
            "int8_consistency", phase_int8_consistency, model, prompts)
        report["incubate_consistency"] = run(
            "incubate_consistency", phase_incubate_consistency, model,
            prompts, want)
        report["blha_consistency"] = run(
            "blha_consistency", phase_blha_consistency, model)
        report["engine_consistency"] = run(
            "engine_consistency", phase_engine_consistency, model, prompts)
        report["fleet_consistency"] = run(
            "fleet_consistency", phase_fleet_consistency, model, prompts)
        del model
        torch.cuda.empty_cache()
        report["fleet_procs"] = run("fleet_procs", phase_fleet_procs,
                                    report["device"]["smi"])
        report["training"] = run("training", phase_training)
        report["train_consistency"] = run("train_consistency",
                                          phase_train_consistency)
        report["resilience"] = run("resilience", phase_resilience,
                                   report["device"]["smi"])
        report["quant_train"] = run("quant_train", phase_quant_train,
                                    report["device"]["smi"])
        report["long_context"] = run("long_context", phase_long_context)
        report["long_context_remat"] = run("long_context_remat",
                                           phase_long_context_remat)
        report["model_rest"] = run("model_rest", phase_model_rest,
                                   report["device"]["smi"])
        report["shared_block"] = run(
            "shared_block", phase_shared_block, report["device"]["smi"],
            None, 3, 2048, DEVICE, REST_STEPS, report["training"])
        report["paddle_surface"] = run("paddle_surface",
                                       phase_paddle_surface,
                                       report["device"]["smi"])
        report["vision"] = run("vision", phase_vision,
                               report["device"]["smi"])
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
                   for path in ("serving", "serving_int8", "serving_spec",
                                "serving_int8w", "serving_disagg",
                                "serving_fleet", "incubate",
                                "incubate_surface", "training",
                                "quant_train", "long_context",
                                "model_rest", "shared_block",
                                "paddle_surface", "vision")}
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
