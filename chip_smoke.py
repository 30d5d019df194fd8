#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py [--out results.json] [--quick]

Phases, each of which fails the run on error:

1. device  - the card's name and power limit; fails without CUDA. The
             seconds of ``import paddle_tpu_torch`` in a fresh interpreter,
             with and without the top level's incubate, distributed and
             inference imports (``-X importtime``).
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
   float16 - the same model cast to float16 in place: (a) the float16
             instances of rms_norm, add_rms_norm, swiglu_down,
             decode_attention, paged_attention and paged_attention_int8
             against their plain versions at their bf16 rows' main shapes,
             with ms (and from a CUDA graph for the norms and the int8
             kernel), bound, plain and library ms; (b) phase 4's requests
             through the engine with exact and int8 KV:
             paged_attention_f16 (paged_attention_int8_f16) L and
             rms_norm_f16 2L + 1 a tick, the graphed tick equal to the
             eager one bit for bit, the share of tokens equal to phase 4's;
             (c) the incubate decoder on paddle.Tensor inputs through the
             public names: decode_attention_f16 L, add_rms_norm_f16 2L and
             rms_norm_f16 1 a token, ms per token beside phase incubate's,
             and block_multihead_attention over float16 page-major caches
             (paged_attention_f16 L a step); (d) the config-4 Pipe (all 24
             layers) in float16, one loss and backward: swiglu_down_f16 2L,
             rms_norm_f16 4L, flash fwd f16 2L, flash bwd f16 L, the loss
             within [ln V - 0.1, ln V + 1.5]; (e) card against CPU at depth
             2: the engine's first-tick logits, the incubate decoder's, the
             Pipe's loss and gradients (F16_* bounds).
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
   resilience - config 4 in bf16 at full width (6 of its 24 layers in
             the whole script, RESILIENCE_CONFIG4), batch 3 x seq
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
   quant_train - config 4 as phase 6 builds it (6 of its 24 layers in the
             whole script, QUANT_TRAIN_CONFIG4), 8 steps of one seeded
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
             memory; (f) f32 depth 2, 1 x 128 (REST_CPU_SEQ), card
             against CPU for (b)'s variant and (d)'s MoE, phase 7's
             bounds. One more step of (a), (b) and (d) runs under the
             profiler (busy, host share, groups). The script runs (b)-(e)
             at 6 of config 4's 24 layers (MODEL_REST_CONFIG4), at its
             width.
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

   deploy  - how a Paddle user ships a model: (a) BERT-base (config 3's
             model, 110.1 M, f32, 32 x 512) through ``jit.to_static`` in
             eval, ``jit.save`` with a dynamic batch and
             ``inference.create_predictor`` on the card (a CUDA graph per
             feed shape): flash_attention_fwd L a run and nothing else,
             outputs within FLASH_TOL of eager, batch 8 from the same
             artifact, the graphed run equal to the eager run; save and
             load seconds, bytes, the run's ms against the eager and
             to_static forwards; (b) ``convert_to_mixed_precision``: the
             floating weights' bytes exactly halved, outputs within 2e-2
             of (a)'s, the graphed run equal to its eager run, and the
             device bytes the bf16 Predictor holds and peaks at below
             the f32 one's; (c) config 4's Pipe forward to logits (its width,
             bf16, 3 x 2048; 2 of its 24 layers, DEPLOY_PIPE_LAYERS)
             through ``jit.save`` and a Predictor:
             flash_attention_fwd L, rms_norm 2L, swiglu_down L a run,
             logits against eager; (d) ``FLAGS_check_nan_inf`` on a
             2-layer config-4-width TrainStep whose loss turns NaN: it
             raises naming aten.log and no byte of a parameter or slot
             changes; off, one step launches phase 6's per-layer counts.

   tools   - the operator's tools: (a) ``paddle.profiler`` over 6 steps of
             config 4's Pipe (its width, bf16, 3 x 2048, 4 of its 24
             layers) under make_scheduler(closed=1, ready=1, record=2,
             repeat=1) and export_chrome_tracing, each step a
             RecordEvent("train_step"): the device table gives each kernel
             the launches of the 2 recorded steps (flash fwd 2L, fused bwd
             L, swiglu_down 2L, rms_norm 4L a step), the chrome trace
             names the four, the host table counts 6 ranges; readings: the
             step median without the profiler, closed and recording, the
             family totals, the window's busy share against
             _profile_step's, and whether a graphed decode tick's kernels
             are listed; (b) the memory planner over config 4 at 24
             layers, batch {3, 6} x {no remat, phase 8's names: list}: each
             candidate's static memory_stats and trace seconds, a plan
             under a budget between two static peaks (the highest-scoring
             fit wins), its winner's real step peaking within the budget;
             (c) the JAX package's checkpoint fixture (tests/data/
             jax_ckpt): validated with CRC32C, restored into the port's
             f32 Pipe on the card, its next loss within 1e-4 relative of
             the JAX package's, its paddle.save file loaded bit for bit.

   static  - the static graph on BERT-base (f32, 32 x 512, dropout 0):
             (a) program_guard -> AdamW.minimize -> Executor.run, a
             warm-up and 3 timed runs on one batch against the eager step
             from the same weights: flash fwd L and fused bwd L a run, the
             first loss bit for bit, the next two within 1e-4, the timed
             runs' third below their first; (b) an eval program ->
             save_inference_model -> load_inference_model ->
             Executor.run(predictor): flash fwd L, logits within
             FLASH_TOL of the program's fetch; (c) its IR (12 layers):
             L flash_fwd nodes, the three built-in patterns, run, and
             serialize -> deserialize within FLASH_TOL; (d)
             cost_model.profile_measure of the forward within 1% of the
             analytic flops; (e) cinn.compiler.compile against eager and
             tensorrt.convert to BF16 (floating bytes halved, served
             within 2e-2); (f) two CheckpointManager steps of (a)'s
             model and AdamW and the inspector: exit 0, every key
             changed, exit 1 on a flipped payload byte.

   domains - the domain libraries, f32, each part against the CPU run of
             the same code (or float64, or dense attention): (a)
             SECOND's VoxelBackBone8x (12 sparse convs, BatchNorm, ReLU)
             at KITTI's grid [41, 1600, 1408], 2 x 16,000 seeded voxels
             (a ground plane and 40 box surfaces), forward, a sum loss
             and backward: at least 4 active sites a 3^3 window, each
             SubmConv3D keeps its sites, output and weight gradients
             within 1e-4 of the CPU run, peak under 1 GiB; (b) BigBird's
             pattern (12 heads, d 64, blocks of 64: 3 sliding, 2 global,
             3 random) at 4096 through sparse.nn.functional.attention
             against dense masked attention (output 1e-4, q/k/v
             gradients 1e-3), no S x S op output; (c) a GCN at
             ogbn-arxiv's size (169,343 nodes, 2.5 M messages, 128 ->
             256 -> 256 -> 40: send_ue_recv, send_u_recv mean, max), 3
             Adam steps: the first loss and gradients within 1e-4 of the
             float64 step, every loss moves, an isolated node reads 0
             under max; (d) Whisper's front end on 32 x 30 s clips:
             LogMelSpectrogram [32, 80, 3001] and a 40-coefficient MFCC
             within 1e-4 of the CPU run, stft -> istft within 1e-5 of
             the peak, istft under 50 ops a call (each op a kernel or
             two; the profiler's count a reading); (e) Categorical over
             [4096, 32000] sampled from a CUDA generator, Normal and
             MultivariateNormal (d 64) rsample gradients, Dirichlet and
             Gamma samples within 5 standard errors, every KL pair and
             closed form within 1e-5 of the CPU run, Viterbi over
             [64, 512, 9] with mixed lengths equal to the CPU run's,
             svd_lowrank and pca_lowrank of [4096, 1024] within the CPU
             run's error plus 1e-4. It launches none of the ten kernels.

   compression - the compression path on BERT-base (config 3's model,
             f32, dropout 0, AdamW at 1e-4, one seeded 32 x 512 batch
             with segment ids) and at LLaMA-7B's up projection: (a)
             QAT(QuantConfig()).quantize swaps exactly 75 QuantedLinears
             (a deep copy: parameters() and state_dict() see each inner
             Linear, an optimizer built after moves them); a warm-up and
             3 timed steps beside the same weights' unquantized eager
             step, flash fwd L and fused bwd L a step, finite losses, the
             third timed below the first; the card against the CPU at
             depth 2 (SURFACE_CPU_SHAPE), the port's quanter recording
             its codes: with every site quantized to the CPU's codes, the
             card's own codes within one level of the CPU's, each that
             moved at a rounding boundary between the two inputs, the
             weights' equal, the loss and gradients within phase 7's
             bounds (1e-4, 5e-4); with the card's own codes, the
             weights' codes equal, the rest readings; (b) PTQ of
             that model in eval: 2 observed batches, convert, every static
             scale
             exactly its inputs' largest |x|; the converted logits' error
             and MLM top-1 agreement read; (c) ASP: prune_model with
             mask_1d and mask_2d_best over the 75 weights timed (768 x 2
             takes the 1-D mask), the card's masks equal the CPU's for
             each of the three algorithms and all 75 weights, nsp excluded and dense, every other weight
             at density 0.5, decorate(AdamW) and 3 steps holding 2:4 on
             the optimizer's own tensors; (d) nn.quant on a [4096, 11008]
             bf16 weight: weight_quantize's codes equal the CPU's and its
             scales within 1e-7 for int8, int4 and llm.int8 at group
             -1/64/128; weight_only_linear against its plain route and
             within 0.03 of x @ w; llm_int8_linear with 4 outlier
             channels x 40 dispatching aten::_int_mm, its int32 sums
             exact, within 0.03 of x @ w, at 8 and 2048 rows; times
             against torch.matmul and the weights' bytes read; (e)
             get_cudnn_version, fftshift(axes=1) card against CPU, and a
             GPU profiler window that lists device events or raises.

Whole-script cuts (a phase's checks stated per layer hold at any
depth): model_rest (b)-(e) and resilience at 6 of config 4's 24 layers,
quant_train at 6 (QUANT_TRAIN_CONFIG4, for compression).

The line before the last lists every kernel with its launch counts on the
serving, int8 serving, spec, int8-weight, disaggregated and fleet
serving, incubate, incubate_surface, float16, training, quant_train (run b),
long-context, model_rest, shared_block, paddle_surface, vision, amp,
deploy, tools, static and compression runs;
the last
line is {"ok": true, "device": {...}}.
``--quick`` runs phases 1-3 and flash_widths only, and prints no result
line.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
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
from torch.utils._python_dispatch import TorchDispatchMode

HBM_BYTES_PER_S = 3.35e12                    # H100 SXM data sheet
DEVICE = "cuda"
PEAK_OPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
            torch.float32: 67e12,
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
#: the packages the top level imports since the incubate, distributed and
#: inference imports were added to it (its last three subpackage imports)
TOP_LEVEL_ADDED = ("incubate", "distributed", "inference")


def import_seconds():
    """``import paddle_tpu_torch`` in a fresh interpreter: (its seconds,
    the seconds of the three imports in TOP_LEVEL_ADDED within them, from
    ``-X importtime``'s cumulative column). Each of the three is first
    imported by its own top-level line, so the difference is the import
    without them."""
    code = ("import time; t = time.perf_counter(); import paddle_tpu_torch; "
            "print(time.perf_counter() - t)")
    r = subprocess.run([sys.executable, "-X", "importtime", "-c", code],
                       capture_output=True, text=True, timeout=300,
                       check=True, cwd=Path(__file__).resolve().parent)
    total = float(r.stdout.strip().splitlines()[-1])
    added = {}
    for ln in r.stderr.splitlines():
        parts = ln.split("|")
        for name in TOP_LEVEL_ADDED:
            if len(parts) == 3 and parts[2] == f"   paddle_tpu_torch.{name}":
                added[name] = int(parts[1]) / 1e6
    check(sorted(added) == sorted(TOP_LEVEL_ADDED),
          f"importtime lines of {TOP_LEVEL_ADDED}: {added}")
    return total, added


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
    total, added = import_seconds()
    print(f"device: import paddle_tpu_torch {total:.3f} s in a fresh "
          f"interpreter, {total - sum(added.values()):.3f} s without the "
          f"top level's incubate, distributed and inference imports ("
          + ", ".join(f"{k} {v:.3f} s" for k, v in added.items())
          + f"); {smi_line}", flush=True)
    return {"name": name, "smi": smi_line, "import_s": total,
            "import_added_s": added}


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
#: and a bf16 weight, and x f16 (1, 2 or 4) with an f32 and an f16 weight;
#: add_rms_norm_kernel for the same x layouts, each with every mix of
#: residual and weight types (f32 or bf16 beside f32 and bf16 x, f32 or f16
#: beside f16 x).
SPILL_CHECKED = {"flash_attention.cu": (("flash",), 24),
                 "flash_attention_split.cu": (("flash",), 24),
                 "rms_norm.cu": (("rms_norm_kernel",), 20),
                 "add_rms_norm.cu": (("add_rms_norm_kernel",), 40)}


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


#: the decode kernels by source, each built for f32, bf16 and f16 q, every
#: head width of EXACT_HEAD_DIMS and q-row groups of 1, 2, 4 and 8
DECODE_KERNELS = {"paged_attention.cu": "paged_attention_kernel",
                  "decode_attention.cu": "decode_attention_kernel",
                  "paged_attention_int8.cu": "paged_attention_int8_kernel"}
DECODE_ROW_GROUPS = (1, 2, 4, 8)
DECODE_TYPES = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16"}


def decode_instance(mangled):
    """``"bf16 D=128 R=8"`` from a decode kernel's mangled name."""
    m = re.search(r"I(f|13__nv_bfloat16|6__half)Li(\d+)ELi(\d+)E", mangled)
    if m is None:
        return mangled
    return f"{DECODE_TYPES[m.group(1)]} D={m.group(2)} R={m.group(3)}"


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
    want = len(DECODE_TYPES) * len(EXACT_HEAD_DIMS) * len(DECODE_ROW_GROUPS)
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
#: f16: about 3x the largest of float16's own readings (PERF.md), one
#: rounding of the output at 3 more mantissa bits than bf16: decode
#: kernels 4.9e-4 to 9.8e-4 absolute, the norms one f16 ulp (2^-11
#: relative)
PAGED_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 3e-3}
RMS_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-2),
           torch.float16: (1.5e-3, 1.5e-3)}


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
#: routes, and the outputs are rounded to bf16. f16: the same rounding
#: points at 3 more mantissa bits; measured 1.2e-4 to 6.6e-4 on every
#: shape of phase amp (c) (PERF.md), bf16 9.6e-4 to 2.5e-3, so about 3x
#: f16's largest and under bf16's largest.
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-3}
#: f32: summation order over M; bf16: output rounding (2^-8) and products
#: rounded from f32 values whose last bits differ; f16 the same at 2^-11
#: (3.7e-4 measured at config 4's seam, so about 3x that)
SWIGLU_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 1e-3}


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


def _serve(eng, cfg, new, tag, window=True):
    """The serving run of one engine: a warm-up request, then 8 greedy
    requests (five up front, three after two steps), then on a second
    batch a decode window under the profiler (unless ``window`` is False)
    and the graphed tick against the eager one. Checks every request's
    tokens and the launch counts per decode tick (under ``<name>_f16`` for
    a float16 model); returns the measurements and the streams in prompt
    order."""
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
    sfx = "_f16" if eng._kv_dtype == torch.float16 else ""
    for name, want in ((attn, L * ticks), (other, 0),
                       ("rms_norm", (2 * L + 1) * (ticks + chunks))):
        check(counts[name + sfx] == want,
              f"{name + sfx} launches {counts[name + sfx]} != {want} ({L} "
              f"layers, {ticks} decode ticks, {chunks} prefill passes)")
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
    if window:
        res["decode_window"] = _decode_window(eng, 10)
    res["graph_vs_eager"] = gve = _graph_vs_eager(eng)
    if not window:
        eng.run_until_complete()
        print(f"{tag}: graphed tick against the eager _decode_step on the "
              f"same state: tokens equal {gve['tokens_equal']}, KV cells "
              f"equal {gve['kv_equal']}, logits' largest difference "
              f"{gve['logits_max_abs_diff']}", flush=True)
        check(gve["tokens_equal"] and gve["kv_equal"]
              and gve["logits_max_abs_diff"] == 0.0,
              f"{tag}: graphed tick != eager tick: {gve}")
        return res, [done[r] for r in rids]
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
        fused_rms_norm_arrays as fused_rms_norm,
        masked_multihead_attention_arrays as masked_multihead_attention,
        swiglu_arrays as swiglu)
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


def incubate_step_surface(params, cfg, tokens, seq_lens, caches):
    """:func:`incubate_step` as a user writes it on the Paddle surface:
    every operand a ``paddle.Tensor`` (``params`` as
    :func:`incubate_params` makes them, wrapped), every op a public name
    (``incubate.nn.functional``'s fused_rms_norm, fused_linear with the
    model's ``[out, in]`` weights, fused_rotary_position_embedding over a
    ``[1, B, H, D]`` view whose rows take the table rows at their own
    positions, masked_multihead_attention and swiglu; ``paddle.concat``,
    ``nn.functional.embedding``). Returns the logits as a Tensor."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.incubate.nn.functional import (
        fused_linear, fused_rms_norm, fused_rotary_position_embedding,
        masked_multihead_attention, swiglu)

    b, nh = tokens.shape[0], cfg.num_heads
    hd = cfg.hidden_size // nh
    pos = seq_lens._data.float()[:, None]
    inv = 10000.0 ** (-torch.arange(0, hd, 2, dtype=torch.float32,
                                    device=pos.device) / hd)
    sin, cos = paddle.Tensor(torch.sin(pos * inv)), paddle.Tensor(
        torch.cos(pos * inv))

    def lin(h, w):
        return fused_linear(h, w, transpose_weight=True)

    def rope(t):
        out, _, _ = fused_rotary_position_embedding(
            t.reshape([1, b, nh, hd]), sin=sin, cos=cos)
        return out.reshape([b, nh * hd])

    x = paddle.nn.functional.embedding(tokens, params["embed"])
    resid = delta = None
    for lp, cache in zip(params["layers"], caches):
        if resid is None:
            h, resid = fused_rms_norm(x, lp["ln1"]), x
        else:
            h, resid = fused_rms_norm(delta, lp["ln1"], residual=resid)
        qkv = paddle.concat([rope(lin(h, lp["wq"])), rope(lin(h, lp["wk"])),
                             lin(h, lp["wv"])], -1)
        out, _ = masked_multihead_attention(qkv, cache,
                                            sequence_lengths=seq_lens)
        h2, resid = fused_rms_norm(lin(out, lp["wo"]), lp["ln2"],
                                   residual=resid)
        delta = lin(swiglu(lin(h2, lp["wg"]), lin(h2, lp["wu"])), lp["wd"])
    xn, _ = fused_rms_norm(delta, params["fnorm"], residual=resid)
    return lin(xn, params["head"])


def incubate_generate(model, prompts, starts, new, max_len, step_ms=None,
                      surface=False):
    """Greedy streams of the incubate decoder. Row i joins at step
    ``starts[i]``, feeds its prompt one token per step, then its own
    argmax, until it holds ``new`` new tokens. Before it joins (and after
    it ends) a row writes a dummy token at position 0, which its first
    real step overwrites. ``surface``: every step through
    :func:`incubate_step_surface` on ``paddle.Tensor`` s (over the same
    weights and caches). Returns prompt + new tokens per row."""
    from paddle_tpu_torch import Tensor
    from paddle_tpu_torch.core.dispatch import unwrap

    cfg = model.config
    check(cfg.num_kv_heads == cfg.num_heads,
          "masked_multihead_attention packs H heads for k and v (MHA)")
    dev = model.model.embed_tokens.weight.device
    params = incubate_params(model)
    hd = cfg.hidden_size // cfg.num_heads
    caches = [torch.zeros(2, len(prompts), cfg.num_heads, max_len, hd,
                          dtype=params["embed"].dtype, device=dev)
              for _ in params["layers"]]
    step, wrap = incubate_step, (lambda t: t)
    if surface:
        step, wrap = incubate_step_surface, Tensor
        params = {"layers": [{k: Tensor(v) for k, v in lp.items()}
                             for lp in params["layers"]],
                  **{k: Tensor(params[k]) for k in ("embed", "fnorm",
                                                    "head")}}
        caches = [Tensor(c) for c in caches]
    outs = [list(p) for p in prompts]
    steps = max(s + len(p) + new - 1 for s, p in zip(starts, prompts))
    with torch.inference_mode():
        for t in range(steps):
            live = [s <= t < s + len(p) + new - 1
                    for s, p in zip(starts, prompts)]
            pos = [t - s if on else 0 for s, on in zip(starts, live)]
            toks = [o[i] if on else 0 for o, i, on in zip(outs, pos, live)]
            t0 = time.perf_counter()
            logits = step(
                params, cfg, wrap(torch.as_tensor(toks, device=dev)),
                wrap(torch.as_tensor(pos, dtype=torch.int32, device=dev)),
                caches)
            nxt = unwrap(logits).float().argmax(-1).tolist()
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
#: model_rest's config-4 parts (b)-(e) at 6 of config 4's 24 layers in
#: the whole script (the width is config 4's): at 24, (b)-(e) took 96.2
#: of the phase's 152.2 s ((e)'s two 5 GB saves and restores 61.2 s), and
#: phase deploy's 60 s had to fit under the script's 1000; at 12 they took
#: 49.7 of 108.4 s, and phase domains had to fit too
MODEL_REST_CONFIG4 = dict(CONFIG4, num_layers=6)
#: phase resilience's depth in the whole script, for the same reason (at
#: 24 layers its two saves and restores of 5.12 GB took about 36 of its
#: 62-64 s, at 12 the phase 32.9 s): config 4's width and training setup
#: at 6 of its 24 layers
RESILIENCE_CONFIG4 = dict(CONFIG4, num_layers=6)
#: phase quant_train's depth in the whole script, for phase compression:
#: config 4's width and its three policies at 6 of its 24 layers (its
#: launches, flops and amax checks are stated per layer)
QUANT_TRAIN_CONFIG4 = dict(CONFIG4, num_layers=6)
#: the sequence of the f32 depth-2 card-against-CPU steps of model_rest
#: (f) and shared_block: at 256 the CPU runs took most of (f)'s 54.7 s
REST_CPU_SEQ = 128
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


def _rest_card_vs_cpu(tag, build, loss_fn, vocab, device,
                      seq=REST_CPU_SEQ):
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
                    variant.vocab_size, device, min(seq, REST_CPU_SEQ)),
                "moe": _rest_card_vs_cpu(
                    "MoE", build(GPTForCausalLMMoE, moe_cfg, **MOE_KW),
                    lambda m: m.loss, moe_cfg.vocab_size, device,
                    min(seq, REST_CPU_SEQ))}

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
        block_multihead_attention_arrays as block_multihead_attention,
        fused_linear_arrays as fused_linear,
        fused_rms_norm_arrays as fused_rms_norm, swiglu_arrays as swiglu)
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


def _fused_init(layer, seed, std=0.02):
    """Seeded weights for a Fused* layer (an ``nn.Layer``), in place in
    its parameters' type: matrices N(0, std^2), biases 0, LayerNorm scales
    1."""
    params = [(n, p._data) for n, p in layer.named_parameters()]
    gen = torch.Generator(device=params[0][1].device)
    gen.manual_seed(seed)
    with torch.no_grad():
        for name, p in params:
            if name.endswith("_scale"):
                p.fill_(1.0)
            elif p.dim() == 1:
                p.zero_()
            else:
                p.normal_(0.0, std, generator=gen)
    return layer


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
    from paddle_tpu_torch import Tensor
    from paddle_tpu_torch.incubate.nn import (FusedMultiTransformer,
                                              FusedTransformerEncoderLayer)
    from paddle_tpu_torch.nn import LayerList
    from paddle_tpu_torch.incubate.nn.functional import \
        fused_linear_cross_entropy_arrays as fused_linear_cross_entropy
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
        fmt = FusedMultiTransformer(**FMT_KW).to(dtype="bfloat16")
        _fused_init(fmt, seed=5).eval()
        x = Tensor(torch.randn(bsz, seq, e, device=DEVICE,
                               generator=torch.Generator(DEVICE).manual_seed(
                                   6)).to(torch.bfloat16))
        every = Tensor(torch.ones(seq, seq, dtype=torch.bool, device=DEVICE))
        with torch.no_grad():
            fmt(x)                                          # warm-up
            _sync(DEVICE)
            kernels.reset_launch_counts()
            got = fmt(x)._data
            _sync(DEVICE)
            counts = kernels.launch_counts()
            # each layer through the flash op and through the plain route
            # from the same input: FLASH_TOL is a layer's bound; the whole
            # stack's difference compounds over 24 bf16 layers (a reading)
            layer_rel, h = [], x
            for layer in fmt.layers:
                flash = layer(h)
                layer_rel.append(_rel_err(flash._data, layer(
                    h, src_mask=every)._data)[1])
                h = flash
            err, rel = _rel_err(got, fmt(x, attn_mask=every)._data)
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
        stack = LayerList([
            FusedTransformerEncoderLayer(
                e, nh, FMT_KW["dim_feedforward"], dropout_rate=0.0,
                activation="gelu", normalize_before=True)
            for _ in range(2)]).to(dtype="bfloat16")
        _fused_init(stack, seed=7)
        x = Tensor(torch.randn(bsz, seq, e, device=DEVICE,
                               generator=torch.Generator(DEVICE).manual_seed(
                                   8)).to(torch.bfloat16))
        every = Tensor(torch.ones(seq, seq, dtype=torch.bool, device=DEVICE))

        def grads(mask):
            stack.clear_gradients()
            h = x
            for layer in stack:
                h = layer(h, src_mask=mask)
            loss = h.astype("float32").square().mean()
            loss.backward()
            # pre-LayerNorm layers leave their post-LayerNorm unused
            return float(loss), {n: p.grad._data.detach().clone()
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


# ------------------------------------------------------------- float16
#: (d)'s depth: config 4 (bench.py:259-262) at all of its 24 layers (one
#: loss and backward take under a second; no cut)
F16_PIPE_LAYERS = 24
#: (e) card against CPU at depth 2 in float16, the same weights and inputs:
#: sums taken in other orders on the two devices, each product rounded to
#: f16 (2^-11) after them. Bounds about 3x the largest of float16's own
#: readings (PERF.md; two chip runs) and tighter than the bf16 bounds
#: (FLASH_TOL, AMP_LOSS_RTOL, AMP_GRAD_RTOL): the engine's first-tick
#: logits and the incubate decoder's, of the largest |logit| (read
#: 1.28e-3 to 1.51e-3); the Pipe's loss (3.9e-6 at seq 128, 2.2e-5 at 32),
#: and each gradient of its leaf's norm or of AMP_GRAD_FLOOR of the largest
#: leaf's norm, where that is more (1.5e-3 to 1.7e-3)
F16_LOGITS_RTOL = 4.5e-3
F16_LOSS_RTOL = 7e-5
F16_GRAD_RTOL = 5e-3
#: (e)'s shapes, cut for the CPU's float16 GEMMs (about 5.6 GFLOP/s on
#: the card's host, PERF.md): two prompts for the engine and the incubate
#: decoder (whose steps are the shorter prompt's tokens), the Pipe at
#: batch 1 x seq 32
F16_CPU_PROMPTS = (9, 16)
F16_CPU_SEQ = 32


def _surface_params(model):
    """:func:`incubate_params` as ``paddle.Tensor`` s over the same
    tensors."""
    from paddle_tpu_torch import Tensor

    params = incubate_params(model)
    return {"layers": [{k: Tensor(v) for k, v in lp.items()}
                       for lp in params["layers"]],
            **{k: Tensor(params[k]) for k in ("embed", "fnorm", "head")}}


@torch.inference_mode()
def _incubate_logits(model, prompts, dev):
    """The surface incubate decoder (:func:`incubate_step_surface`) fed the
    rows' prompts one token a step: every step's logits, f32 on the CPU."""
    from paddle_tpu_torch import Tensor

    cfg = model.config
    params = _surface_params(model)
    hd = cfg.hidden_size // cfg.num_heads
    n = min(len(p) for p in prompts)
    caches = [Tensor(torch.zeros(2, len(prompts), cfg.num_heads, n, hd,
                                 dtype=model.model.embed_tokens.weight.dtype,
                                 device=dev))
              for _ in params["layers"]]
    out = []
    for t in range(n):
        logits = incubate_step_surface(
            params, cfg, Tensor(torch.as_tensor([p[t] for p in prompts],
                                                device=dev)),
            Tensor(torch.full((len(prompts),), t, dtype=torch.int32,
                              device=dev)), caches)
        out.append(logits._data.float().cpu())
    return torch.stack(out)


def _logits_rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


#: (d) and (e)'s Pipe: config 4's widths (bench.py:259-262)
CONFIG4_WIDTHS = dict(vocab_size=32000, hidden_size=2048, num_heads=16,
                      max_seq_len=2048, dropout=0.0, dtype="float16",
                      recompute=True)


def phase_float16(model, smi="", streams=None, incubate_bf16=None,
                  pipe_kw=CONFIG4_WIDTHS, pipe_layers=F16_PIPE_LAYERS,
                  batch=3, seq=2048, device=DEVICE):
    """float16 on phase 4's LLaMA-7B model, cast in place:
    (a) the six kernels that gained a float16 instance (rms_norm,
        add_rms_norm, swiglu_down, decode_attention, paged_attention,
        paged_attention_int8) against their plain versions at their bf16
        rows' main shapes, with ms, bound, plain and library ms;
    (b) phase 4's 8 staggered requests through the engine, exact and int8
        KV: paged_attention_f16 L and rms_norm_f16 2L + 1 a tick
        (paged_attention_int8_f16 L an int8 tick), the graphed tick equal
        to the eager _decode_step bit for bit; tokens/s, TTFT, the median
        tick and the share of tokens equal to phase 4's bf16 streams;
    (c) the incubate decoder on paddle.Tensor inputs through the public
        names (incubate_step_surface) over dense caches:
        decode_attention_f16 L, add_rms_norm_f16 2L and rms_norm_f16 1 a
        token, ms per token beside phase incubate's bf16 torch-tensor run;
        block_multihead_attention over float16 page-major caches:
        paged_attention_f16 L a decode step;
    (d) the config-4 Pipe (GPT-3 1.3B) in float16 at ``pipe_layers``
        layers (all 24), batch x seq tokens: one forward loss and
        one backward, swiglu_down_f16 2L, rms_norm_f16 4L,
        flash_attention_fwd_f16 2L and flash_attention_bwd_f16 L, the loss
        within [ln V - 0.1, ln V + 1.5];
    (e) card against CPU at depth 2: the engine's first-tick logits, the
        incubate decoder's logits, the Pipe's loss and gradients."""
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLMPipe
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.ops import kernels

    f16 = torch.float16
    cfg = model.config
    L = cfg.num_layers
    out = {"smi": smi, "part_seconds": {}}
    launches = {k: 0 for k in kernels.launch_counts()}

    def part(name, fn):
        t0 = time.perf_counter()
        res = fn()
        _sync(device)
        out["part_seconds"][name] = time.perf_counter() - t0
        for k, v in res.get("launches", {}).items():
            launches[k] += v
        out[name] = res
        return res

    def add(*counts):
        return {k: sum(c[k] for c in counts) for k in counts[0]}

    def part_a():
        gen = torch.Generator(device=device)
        gen.manual_seed(21)
        rows = {
            # the engine tick's rows first (its main shape), then config
            # 4's block norms
            "rms_norm": [_rms_case(8, 4096, f16, gen),
                         _rms_case(6144, 2048, f16, gen)],
            # the incubate decoder's rows, then a prefill-sized block
            "add_rms_norm": [_add_rms_case(8, 4096, f16, gen),
                             _add_rms_case(4096, 4096, f16, gen)],
            "swiglu_down": [_swiglu_case(6144, 5504, 2048, f16, gen)],
            "decode_attention": [_decode_case(8, 32, 2048, 128, f16, gen)],
            "paged_attention": [_paged_case(8, 32, 32, 128, 64, 2048, f16,
                                            gen)],
            "paged_attention_int8": [_paged_int8_case(
                8, 32, 32, 128, 64, 2048, f16, gen)]}
        for name, cases in rows.items():
            for r in cases:
                graphed = (f"; from a CUDA graph {r['device_ms']:.4f} ms, "
                           f"library {r['library_device_ms']:.4f}"
                           if "device_ms" in r else "")
                print(f"float16 (a) {name}_f16 {r['shape']}: {r['ms']:.4f} "
                      f"ms (plain {r['plain_ms']:.4f}, library "
                      f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} by "
                      f"{r['bound_by']}{graphed}) max_abs_err "
                      f"{r['max_abs_err']:.3g}; {smi}", flush=True)
        return {"rows": rows}

    def part_b():
        model.to(f16)                                  # in place
        check({p.dtype for p in model.parameters()} == {f16},
              "the model is not float16")
        new = 32
        res = {}
        for tag, int8 in (("exact", False), ("int8", True)):
            eng = ContinuousBatchingEngine(model, max_new_tokens=new,
                                           int8_kv=int8, **SERVE_ENGINE)
            check(eng.int8_kv == int8 and eng._kv_dtype == f16,
                  f"(b) {tag}: int8_kv {eng.int8_kv}, KV type "
                  f"{eng._kv_dtype}")
            r, st = _serve(eng, cfg, new, f"float16 (b) {tag}",
                           window=False)
            if streams is not None:
                same = sum(a == b for s, e in zip(st, streams)
                           for a, b in zip(s[-new:], e[-new:]))
                r["tokens_equal_to_bf16_share"] = same / (new * len(st))
            res[tag] = r
            print(f"float16 (b) {tag}: {r['tokens_per_s']:.1f} tok/s, "
                  f"median tick {r['decode_tick_ms_median']:.2f} ms, TTFT "
                  f"median {statistics.median(r['ttft_ms'].values()):.1f} "
                  f"ms; share of tokens equal to phase 4's bf16 streams "
                  f"{r.get('tokens_equal_to_bf16_share')}; {smi}",
                  flush=True)
            del eng
            torch.cuda.empty_cache()
        check(res["int8"]["kv_bytes"] * 256 == res["exact"]["kv_bytes"] * 132,
              "(b) int8 KV bytes are not 132/256 of the float16 bytes")
        res["launches"] = add(res["exact"]["launches"],
                              res["int8"]["launches"])
        return res

    def part_c():
        rng = np.random.default_rng(2)
        prompts = [rng.integers(1, cfg.vocab_size, 16).tolist()
                   for _ in range(8)]
        starts = [4 * i for i in range(8)]
        new, step_ms = 32, []
        incubate_generate(model, prompts[:1], [0], 2, 64, surface=True)
        _sync(device)
        kernels.reset_launch_counts()
        outs, steps = incubate_generate(model, prompts, starts, new, 2048,
                                        step_ms, surface=True)
        _sync(device)
        counts = kernels.launch_counts()
        for name, per_token in (("decode_attention_f16", L),
                                ("add_rms_norm_f16", 2 * L),
                                ("rms_norm_f16", 1)):
            check(counts[name] == per_token * steps,
                  f"(c) {name} launches {counts[name]} != {per_token} x "
                  f"{steps} tokens")
        check(all(len(o) == len(p) + new for o, p in zip(outs, prompts)),
              "(c) streams")
        med = statistics.median(step_ms)
        bf16 = (incubate_bf16 or {}).get("ms_per_token_median")
        # block_multihead_attention over float16 page-major caches
        _, sp = _serve_prompts(cfg)
        blha_counts = []
        blha_generate(model, [p[:128] for p in sp[:4]], 4,
                      counts=blha_counts)
        for c in blha_counts:
            check(c["paged_attention_f16"] == L and c["paged_attention"] == 0,
                  f"(c) block_multihead_attention step launches {c}")
        res = {"steps": steps, "ms_per_token_median": med,
               "ms_per_token_all": step_ms,
               "bf16_torch_ms_per_token_median": bf16,
               "blha_steps": len(blha_counts),
               "launches": add(counts, *blha_counts)}
        print(f"float16 (c): the incubate decoder on paddle.Tensor inputs "
              f"through the public names, 8 rows, {steps} tokens: median "
              f"{med:.2f} ms per token (phase incubate's bf16 on torch "
              f"tensors {bf16} ms); launches per token decode_attention_f16 "
              f"{counts['decode_attention_f16'] // steps}, add_rms_norm_f16 "
              f"{counts['add_rms_norm_f16'] // steps}, rms_norm_f16 "
              f"{counts['rms_norm_f16'] // steps} (L = {L}); "
              f"block_multihead_attention {len(blha_counts)} decode steps, "
              f"paged_attention_f16 {L} each; {smi}", flush=True)
        return res

    def part_d():
        cfg4 = GPTConfig(**dict(pipe_kw, num_layers=pipe_layers))
        gen = torch.Generator(device=device)
        gen.manual_seed(22)
        pipe = GPTForCausalLMPipe(cfg4, device=device).init_weights(
            gen, std=0.02)
        check({p.dtype for p in pipe.parameters()} == {f16},
              "(d) the Pipe is not float16")
        ids, labels = _train_batch(cfg4.vocab_size, batch, seq, 0, device)
        _sync(device)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        loss = pipe.loss(ids, labels, int8=False)
        loss.backward()
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        counts = kernels.launch_counts()
        n = pipe_layers
        for name, want in (("swiglu_down_f16", 2 * n), ("rms_norm_f16", 4 * n),
                           ("flash_attention_fwd_f16", 2 * n),
                           ("flash_attention_bwd_f16", n)):
            check(counts[name] == want,
                  f"(d) {name} launches {counts[name]} != {want}")
        ln_v = float(np.log(cfg4.vocab_size))
        val = loss.item()
        check(math.isfinite(val) and ln_v - 0.1 <= val <= ln_v + 1.5,
              f"(d) loss {val} outside [ln V - 0.1, ln V + 1.5]")
        check(all(torch.isfinite(p.grad).all().item()
                  for p in pipe.parameters()), "(d) a gradient is not finite")
        res = {"layers": n, "batch": batch, "seq": seq, "loss": val,
               "step_ms": ms, "launches": counts}
        print(f"float16 (d): config-4 Pipe, {n} of 24 layers, [{batch}, "
              f"{seq}] float16, one forward loss and backward in {ms:.1f} ms "
              f"(the first at this shape): loss {val:.4f} (ln V "
              f"{ln_v:.4f}); launches swiglu_down_f16 "
              f"{counts['swiglu_down_f16']}, rms_norm_f16 "
              f"{counts['rms_norm_f16']}, flash fwd/bwd f16 "
              f"{counts['flash_attention_fwd_f16']}/"
              f"{counts['flash_attention_bwd_f16']}; {smi}", flush=True)
        del pipe, loss
        return res

    def part_e():
        res = {}
        # the engine's first decode tick, eager, on each device's own
        # prefilled state, fed the card engine's first tokens; the model
        # runs on the card, then moves to the CPU
        m = _random_model(LlamaConfig(**dict(vars(cfg), num_layers=2)), f16,
                          seed=23)
        rng = np.random.default_rng(24)
        prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
                   for n in F16_CPU_PROMPTS]
        logits, inc, toks, secs = {}, {}, None, {}
        for dev in (device, "cpu"):
            t0 = time.perf_counter()
            m.to(dev)
            eng = ContinuousBatchingEngine(
                m, max_new_tokens=4, device=dev, max_slots=2, page_size=64,
                max_seq_len=256, seed=0)
            if dev == "cpu":
                # the CPU's tick at its own 2 rows, not the card's 64: a
                # GEMM row does not depend on the others on the CPU
                eng._rows = eng.max_slots
            for p in prompts:
                eng.submit(p)
            eng.step()                                  # the prefill
            tokens, lens, tables = _tick_inputs(eng)
            toks = tokens if toks is None else toks
            with torch.inference_mode():
                logits[dev] = eng._decode_step(*(
                    torch.as_tensor(a, device=dev)
                    for a in (toks, lens, tables)))[:len(prompts)].float(
                    ).cpu()
            del eng
            inc[dev] = _incubate_logits(m, prompts, dev)
            secs[f"engine_incubate_{dev}"] = time.perf_counter() - t0
        del m
        res["engine_logits_rel"] = _logits_rel(logits[device], logits["cpu"])
        res["incubate_logits_rel"] = _logits_rel(inc[device], inc["cpu"])
        # the Pipe: one loss and backward on each device, the same weights
        cfg4 = GPTConfig(**dict(pipe_kw, num_layers=2))
        pipe = GPTForCausalLMPipe(cfg4, device=device).init_weights(
            torch.Generator(device=device).manual_seed(25), std=0.02)
        got = {}
        for dev in (device, "cpu"):
            t0 = time.perf_counter()
            pipe.to(dev)
            pipe.zero_grad(set_to_none=True)
            ids, labels = _train_batch(cfg4.vocab_size, 1, F16_CPU_SEQ, 3,
                                       dev)
            loss = pipe.loss(ids, labels, int8=False)
            loss.backward()
            got[dev] = (loss.item(), {n: p.grad.float().cpu() for n, p in
                                      pipe.named_parameters()})
            secs[f"pipe_{dev}"] = time.perf_counter() - t0
        del pipe
        g_cpu, g_card = got["cpu"][1], got[device][1]
        top = max(g.norm().item() for g in g_cpu.values())
        grad_rel = {n: ((g_card[n] - g).norm().item()
                        / max(g.norm().item(), AMP_GRAD_FLOOR * top))
                    for n, g in g_cpu.items()}
        worst = max(grad_rel, key=grad_rel.get)
        res.update(pipe_losses=[got["cpu"][0], got[device][0]],
                   pipe_loss_rel=abs(got[device][0] - got["cpu"][0])
                   / abs(got["cpu"][0]),
                   pipe_grad_rel_max=grad_rel[worst],
                   pipe_grad_rel_worst=worst, seconds=secs,
                   tols=[F16_LOGITS_RTOL, F16_LOSS_RTOL, F16_GRAD_RTOL])
        print(f"float16 (e) card vs cpu at depth 2: engine first-tick logits "
              f"rel {res['engine_logits_rel']:.3e}, incubate decoder logits "
              f"rel {res['incubate_logits_rel']:.3e} (tol "
              f"{F16_LOGITS_RTOL}); Pipe loss rel {res['pipe_loss_rel']:.2e} "
              f"(tol {F16_LOSS_RTOL}), grads max rel {grad_rel[worst]:.2e} "
              f"({worst}, tol {F16_GRAD_RTOL}); seconds "
              + ", ".join(f"{k} {v:.1f}" for k, v in secs.items())
              + f"; {smi}", flush=True)
        check(res["engine_logits_rel"] <= F16_LOGITS_RTOL
              and res["incubate_logits_rel"] <= F16_LOGITS_RTOL,
              f"(e) logits {res}")
        check(res["pipe_loss_rel"] <= F16_LOSS_RTOL, f"(e) loss {res}")
        check(grad_rel[worst] <= F16_GRAD_RTOL, f"(e) grads {res}")
        return res

    part("a", part_a)
    part("b", part_b)
    part("c", part_c)
    torch.cuda.empty_cache()
    part("d", part_d)
    torch.cuda.empty_cache()
    part("e", part_e)
    torch.cuda.empty_cache()
    out["launches"] = launches
    print(f"float16: {smi}: parts s "
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
    depth 2: the per-layer model against the Pipe on the same weights at
    1 x 256, and the card against the CPU at 1 x 128 (REST_CPU_SEQ),
    within phase 7's bounds."""
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
        small.vocab_size, device, min(seq, REST_CPU_SEQ))
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


# --------------------------------------------------------------- phase amp
#: (d) the card against the CPU at depth 2 under auto_cast bf16 (O1, O2):
#: bf16 products rounded after sums taken in other orders on the two
#: devices; bounds set from the chip runs' measured gaps (PERF.md): loss
#: 5.7e-5 (O1) and 2.6e-4 (O2), gradients 9.8e-3 and 1.04e-2
AMP_LOSS_RTOL = 1e-3
AMP_GRAD_RTOL = 5e-2              # of each leaf's norm
#: ... or of this share of the largest leaf's norm, where that is more: the
#: key projections' biases have an exact gradient of 0 (a row's softmax
#: ignores a shift common to its logits), which both devices compute as
#: bf16 rounding noise (bf16 keeps 2^-8 = 3.9e-3 of a value)
AMP_GRAD_FLOOR = 1e-2
#: (b)'s forced overflow: a loss scale no float16 gradient survives
AMP_OVERFLOW_SCALE = 2.0 ** 100
AMP_STEPS = 3
#: (e) paddle.nn.LSTM: 2 layers, bidirectional, 512 in and hidden, batch 64
#: x 128 steps; its card-vs-CPU check at 1 layer and a small width
LSTM_SHAPE = dict(num_layers=2, input_size=512, hidden_size=512, batch=64,
                  seq=128)
LSTM_CHECK_SHAPE = dict(num_layers=1, input_size=32, hidden_size=48,
                        batch=4, seq=16)
#: (c) the float16 flash kernels: config 4, config 5's GQA 32/8, GQA 32/4
#: at 4096 (rep * S * d * 4 = 16 MiB: the router takes the split pair),
#: and flash_widths' widths; BERT's shape comes first
AMP_FLASH_SHAPES = ((3, 16, 16, 2048, 128), (3, 32, 8, 2048, 128),
                    (1, 32, 4, 4096, 128)) + tuple(
    (3, hq, hkv, 2048, d) for d, hq, hkv in FLASH_WIDTHS)
#: (b2) the split pair's fp16 step through the surface: [B, S, Hq/Hkv, D]
AMP_SPLIT_STEP = (1, 4096, 32, 4, 128)


def _amp_launches(counts, want_nonzero, tag):
    """``counts`` equal ``want_nonzero`` (name -> launches), the rest 0."""
    want = {name: 0 for name in counts}
    want.update(want_nonzero)
    check(counts == want, f"amp {tag}: launches "
          f"{ {k: v for k, v in counts.items() if v} }, want {want_nonzero}")


def _max_abs_ds(q, k, v, o, lse, do, causal, scale):
    """The largest |dS| = |P (dO V^T - delta)| that the backward rounds to
    the operand type, from the plain version on these operands (kernel
    layout, every q head)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as FA

    rep = q.shape[0] // k.shape[0]
    scale = FA._scale(q, scale)
    delta = FA._delta(o, do)
    top = torch.zeros((), device=q.device)
    for i in range(q.shape[0]):
        _, ds = FA._p_ds(q[i], k[i // rep], v[i // rep], do[i], lse[i],
                         delta[i], causal, scale)
        top = torch.maximum(top, ds.abs().max())
        del ds
    return float(top)


def _amp_flash_rows(gen, bert_shape):
    """(c): each float16 flash kernel against its plain version, with its
    times, bound (fp16's dense peak) and SDPA's time; the largest |dS| on
    N(0, 1) operands at BERT's and config 4's shapes."""
    from paddle_tpu_torch.ops.kernels import flash_attention as FA

    f16 = torch.float16
    rows = {"flash_attention_fwd": [], "flash_attention_bwd": [],
            "flash_attention_bwd_dq": [], "flash_attention_bwd_dkv": []}
    b, h, s, d = bert_shape
    fwd, bwd = _bert_flash_case(f16, gen, b, h, s, d)
    rows["flash_attention_fwd"].append(fwd)
    rows["flash_attention_bwd"].append(bwd)
    for bb, hq, hkv, ss, dd in AMP_FLASH_SHAPES:
        fwd, bwd, (dq, dkv) = _flash_cases(bb, hq, hkv, ss, dd, f16, gen)
        for name, r in zip(rows, (fwd, bwd, dq, dkv)):
            rows[name].append(dict(r, d=dd))
    for name, rs in rows.items():
        for r in rs:
            print(f"amp: fp16 {name} {r['shape']}: {r['ms']:.4f} ms (bound "
                  f"{r['bound_ms']:.4f} by {r['bound_by']}, SDPA "
                  f"{r['library_ms']:.4f}, plain {r['plain_ms']:.4f}) rel "
                  f"err {r['max_rel_err']:.3g}", flush=True)
    ds = {}
    for tag, (bb, hq, hkv, ss, dd, causal) in (
            ("bert", (b, h, h, s, d, False)),
            ("config4", (3, 16, 16, 2048, 128, True))):
        q = torch.randn(bb * hq, ss, dd, generator=gen, device=DEVICE)
        k, v = (torch.randn(bb * hkv, ss, dd, generator=gen, device=DEVICE)
                for _ in range(2))
        do = torch.randn(bb * hq, ss, dd, generator=gen, device=DEVICE)
        q, k, v, do = (t.to(f16) for t in (q, k, v, do))
        o, lse = FA.flash_attention_fwd_plain(q, k, v, causal)
        ds[tag] = _max_abs_ds(q, k, v, o, lse, do, causal, None)
    print(f"amp: largest |dS| on N(0, 1) operands: {ds} (fp16 max 65504)",
          flush=True)
    return rows, ds


def phase_amp(smi="", cfg_kw=None, batch=BERT_BATCH, seq=BERT_SEQ,
              place="gpu", lstm_shape=None):
    """BASELINE config 3 through ``paddle.amp``: (a) BERT-base at O2 in bf16
    (``decorate``, AdamW ``multi_precision``, ``TrainStep``), (b) the same
    model at O1 in float16 under ``GradScaler``, with a forced overflow,
    and (b2) the split pair's fp16 step through the surface; (c) the
    float16 flash kernels; (d) card against CPU at depth 2 under bf16 O1
    and O2; (e) ``paddle.nn.LSTM`` and ``autograd.jacobian``/``hessian``.
    ``cfg_kw``, ``batch``, ``seq``, ``place="cpu"`` and ``lstm_shape``
    rehearse it small (with ``AMP_FLASH_SHAPES`` cut for (c))."""
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.ops.kernels.flash_attention as FA
    from paddle_tpu_torch.models import BertForPretraining, bert_base
    from paddle_tpu_torch.nn.layer.norm import LayerNorm, _BatchNormBase

    K = paddle.ops.kernels
    F16 = "_f16"
    t_phase = time.perf_counter()
    paddle.set_device(place)
    res = {"smi": smi}
    cfg = bert_base(dropout=0.1, **(cfg_kw or {}))
    L, V = cfg.num_layers, cfg.vocab_size
    b, s = batch, seq
    launches = {name: 0 for name in K.launch_counts()}

    def add(counts):
        for name, n in counts.items():
            launches[name] += n

    # (a) O2 bf16: decorate, AdamW(multi_precision), TrainStep
    bf16 = dict(enable=True, dtype="bfloat16", level="O2")
    paddle.seed(0)
    torch.cuda.reset_peak_memory_stats()
    with paddle.amp.auto_cast(**bf16):
        model = BertForPretraining(cfg)
    model = paddle.amp.decorate(model, level="O2", dtype="bfloat16")
    nparams = sum(p.size for p in model.parameters())
    norm_ids = {id(p) for layer in model.sublayers(include_self=True)
                if isinstance(layer, (LayerNorm, _BatchNormBase))
                for p in layer.parameters(include_sublayers=False)}
    dtypes = {n: str(p.dtype).split(".")[-1]
              for n, p in model.named_parameters()}
    wrong = [n for n, p in model.named_parameters()
             if (p._data.dtype == torch.float32) != (id(p) in norm_ids)
             or p._data.dtype not in (torch.float32, torch.bfloat16)]
    check(not wrong, f"amp (a): O2 parameter dtypes {wrong[:4]}")
    opt = paddle.optimizer.AdamW(learning_rate=1e-4, multi_precision=True,
                                 parameters=model.parameters())
    step = paddle.jit.TrainStep(model, lambda i, y, n: model.loss(i, y, n),
                                opt)

    def o2_step(*batch_):
        with paddle.amp.auto_cast(**bf16):
            return step(*batch_)

    losses = [float(o2_step(*_bert_batch(paddle, V, b, s, 300)))]  # warm-up
    # every bf16 parameter the loss reaches (without token types, all but
    # token_type_embeddings) has an f32 master in AdamW's state
    low = [p._data for p in model.parameters()
           if p._data.dtype != torch.float32 and p._data in opt.state]
    masters = [opt.state[p].get("master_weight") for p in low]
    check(len(low) == len(dtypes) - len(norm_ids) - 1 and all(
        m is not None and m.dtype == torch.float32 for m in masters),
          f"amp (a): AdamW keeps an f32 master of every bf16 parameter "
          f"({sum(m is not None for m in masters)} of {len(low)})")
    ms = []
    for i in range(AMP_STEPS):
        batch_ = _bert_batch(paddle, V, b, s, 301 + i)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        loss = o2_step(*batch_)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        counts = K.launch_counts()
        _amp_launches(counts, {"flash_attention_fwd": L,
                               "flash_attention_bwd": L}, f"O2 step {i}")
        add(counts)
        losses.append(float(loss))
    rep = _bert_batch(paddle, V, b, s, 7)
    repeated = [float(o2_step(*rep)) for _ in range(3)]
    check(all(np.isfinite(losses + repeated)), f"amp (a) losses {losses}")
    check(repeated[2] < repeated[0],
          f"amp (a): repeated batch not learned: {repeated}")
    med = statistics.median(ms)
    tps = b * s / (med / 1e3)
    prof = _profile_step(o2_step, rep, med)
    res["o2_bf16"] = {
        "losses": losses, "repeated_batch_losses": repeated,
        "param_dtypes": sorted(set(dtypes.values())),
        "f32_params": sorted(n for n, t in dtypes.items() if t == "float32"),
        "step_ms": ms, "step_ms_median": med, "tokens_per_s": tps,
        "model_flops_share": 6.0 * nparams * tps / PEAK_OPS[torch.bfloat16],
        "host_share": prof["host_share"],
        "device_busy_ms": prof["device_busy_ms"],
        "by_group_ms": prof["by_group_ms"],
        "port_kernels_ms": prof["port_kernels_ms"],
        "top_kernels_ms": prof["top_kernels_ms"],
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    r = res["o2_bf16"]
    print(f"amp: (a) BERT-base O2 bf16 {nparams / 1e6:.1f} M params, batch "
          f"{b} x {s}: losses {[round(x, 4) for x in losses]}, repeated "
          f"{[round(x, 4) for x in repeated]}; step median {med:.1f} ms "
          f"({[round(x, 1) for x in ms]}), {tps:.0f} tokens/s, model-flops "
          f"share {r['model_flops_share']:.4f}, host share "
          f"{r['host_share']}, peak {r['peak_memory_gib']:.2f} GiB",
          flush=True)
    del step, opt, model
    torch.cuda.empty_cache()

    # (b) O1 float16 under GradScaler (2^16, dynamic), eager steps
    f16 = dict(enable=True, dtype="float16", level="O1")
    paddle.seed(0)
    torch.cuda.reset_peak_memory_stats()
    model = BertForPretraining(cfg)
    opt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=model.parameters())
    scaler = paddle.amp.GradScaler()
    check(scaler.get_init_loss_scaling() == 2.0 ** 16
          and scaler.is_use_dynamic_loss_scaling(), "GradScaler defaults")

    def o1_step(*batch_):
        with paddle.amp.auto_cast(**f16):
            loss_ = model.loss(*batch_)
        scaler.scale(loss_).backward()
        scaler.step(opt)
        opt.clear_grad()
        return loss_

    f_losses = [float(o1_step(*_bert_batch(paddle, V, b, s, 400)))]
    f_ms = []
    for i in range(AMP_STEPS):
        batch_ = _bert_batch(paddle, V, b, s, 401 + i)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        loss = o1_step(*batch_)
        torch.cuda.synchronize()
        f_ms.append((time.perf_counter() - t0) * 1e3)
        counts = K.launch_counts()
        _amp_launches(counts, {"flash_attention_fwd" + F16: L,
                               "flash_attention_bwd" + F16: L},
                      f"O1 fp16 step {i}")
        add(counts)
        f_losses.append(float(loss))
    check(all(np.isfinite(f_losses)), f"amp (b) losses {f_losses}")
    f_med = statistics.median(f_ms)
    fprof = _profile_step(o1_step, batch_, f_med)
    # the largest |dS| of this step's backwards, from the plain version on
    # the operands each layer's backward gets
    seen = []
    real_bwd = FA.flash_attention_bwd

    def spy(q, k, v, o, lse, do, causal=False, scale=None):
        seen.append(_max_abs_ds(q, k, v, o, lse, do, causal, scale))
        return real_bwd(q, k, v, o, lse, do, causal, scale)

    FA.flash_attention_bwd = spy
    try:
        o1_step(*rep)
    finally:
        FA.flash_attention_bwd = real_bwd
    check(len(seen) == L, f"amp (b): {len(seen)} backwards seen, want {L}")
    # one step whose gradients overflow in fp16, through the loss scale
    params = [p._data for p in model.parameters()]
    snap = [t.detach().clone() for t in params] + [
        t.detach().clone() for st in opt.state.values()
        for t in st.values() if isinstance(t, torch.Tensor)]
    step_count = opt._step_count
    scaler.set_init_loss_scaling(AMP_OVERFLOW_SCALE)
    from paddle_tpu_torch.amp import _found_inf_counter

    paddle.telemetry.enable()
    inf0 = _found_inf_counter().value()
    ov_loss = float(o1_step(*rep))
    inf1 = _found_inf_counter().value()
    paddle.telemetry.disable()
    after = params + [t for st in opt.state.values() for t in st.values()
                      if isinstance(t, torch.Tensor)]
    same = len(after) == len(snap) and all(
        a.shape == c.shape and torch.equal(a.reshape(-1).view(torch.uint8),
                                           c.reshape(-1).view(torch.uint8))
        for a, c in zip(after, snap))
    check(scaler._found_inf and opt._step_count == step_count,
          "amp (b): the overflow step was not skipped")
    check(scaler.get_init_loss_scaling() == AMP_OVERFLOW_SCALE / 2,
          f"amp (b): scale {scaler.get_init_loss_scaling()} after overflow")
    check(same, "amp (b): a byte of a parameter or slot changed")
    check(inf1 - inf0 == 1, f"amp_found_inf_total went {inf0} -> {inf1}")
    res["o1_fp16"] = {
        "losses": f_losses, "step_ms": f_ms, "step_ms_median": f_med,
        "tokens_per_s": b * s / (f_med / 1e3),
        "host_share": fprof["host_share"],
        "device_busy_ms": fprof["device_busy_ms"],
        "port_kernels_ms": fprof["port_kernels_ms"],
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "max_abs_ds_by_layer": seen, "loss_scale": 2.0 ** 16,
        "overflow": {"loss": ov_loss, "scale_before": AMP_OVERFLOW_SCALE,
                     "scale_after": scaler.get_init_loss_scaling(),
                     "skipped": True, "bytes_unchanged": same,
                     "amp_found_inf_total": [inf0, inf1]}}
    print(f"amp: (b) BERT-base O1 fp16 + GradScaler: losses "
          f"{[round(x, 4) for x in f_losses]}; step median {f_med:.1f} ms "
          f"({[round(x, 1) for x in f_ms]}), host share "
          f"{fprof['host_share']}; largest |dS| a layer "
          f"{max(seen):.4g} (scale 2^16); overflow at 2^100 skipped, scale "
          f"-> 2^{math.log2(scaler.get_init_loss_scaling()):.0f}, no byte "
          f"changed, amp_found_inf_total {inf0} -> {inf1}", flush=True)
    del model, opt, scaler, snap, params, after
    torch.cuda.empty_cache()

    # (b2) the split pair in fp16: one long-sequence GQA attention step
    # through the surface under auto_cast float16
    sb_, ss_, shq, shk, sd = AMP_SPLIT_STEP
    rng = np.random.RandomState(5)
    qkv = [paddle.to_tensor(rng.randn(sb_, ss_, h, sd).astype(np.float32),
                            stop_gradient=False) for h in (shq, shk, shk)]
    check(FA.bwd_route(shq // shk, ss_, sd) == "split",
          "amp (b2): the router keeps the fused backward")
    K.reset_launch_counts()
    with paddle.amp.auto_cast(**f16):
        out = paddle.nn.functional.scaled_dot_product_attention(
            *qkv, is_causal=True)
    check(out.dtype == paddle.float16, f"amp (b2): sdpa gave {out.dtype}")
    (out.astype("float32") ** 2).mean().backward()
    torch.cuda.synchronize()
    counts = K.launch_counts()
    _amp_launches(counts, {"flash_attention_fwd" + F16: 1,
                           "flash_attention_bwd_dq" + F16: 1,
                           "flash_attention_bwd_dkv" + F16: 1}, "(b2)")
    add(counts)
    check(all(np.isfinite(t.grad.numpy()).all() for t in qkv),
          "amp (b2): gradients not finite")
    del qkv, out
    res["launches"] = launches

    # the wrapper's host cost an op (paddle_surface (d)) with autocast off
    # and on: the hook's attribute check, and under auto_cast the list
    # lookups and the casts
    res["wrapper_us"] = {"amp_off": _wrapper_cost(paddle)}
    with paddle.amp.auto_cast(**bf16):
        res["wrapper_us"]["amp_on"] = _wrapper_cost(paddle)
    print("amp: host us per op (Tensor / torch), amp off and on: " +
          json.dumps({k: {n: [round(v["tensor_us"], 2),
                              round(v["torch_us"], 2)] for n, v in w.items()}
                      for k, w in res["wrapper_us"].items()}), flush=True)

    # (c) the float16 flash kernels against their plain versions
    gen = torch.Generator(device=DEVICE).manual_seed(20)
    res["flash_f16"], res["max_abs_ds_random"] = _amp_flash_rows(
        gen, (b, cfg.num_heads, s, cfg.hidden_size // cfg.num_heads))
    torch.cuda.empty_cache()

    # (d) card against CPU at depth 2, bf16 O1 and O2, the same weights
    small = bert_base(**dict(cfg_kw or {}, num_layers=2, dropout=0.0))
    sb, ss = SURFACE_CPU_SHAPE
    res["card_vs_cpu"] = {}
    for level in ("O1", "O2"):
        got = {}
        for where in ("cpu", place):
            paddle.set_device(where)
            paddle.seed(1)
            m = BertForPretraining(small)
            if got:
                m.set_state_dict(got["cpu"][2])
            weights = {k: v.numpy() for k, v in m.state_dict().items()}
            if level == "O2":
                paddle.amp.decorate(m, level="O2")
            with paddle.amp.auto_cast(dtype="bfloat16", level=level):
                loss = m.loss(*_bert_batch(paddle, V, sb, ss, 3))
            loss.backward()
            got["card" if got else "cpu"] = (
                float(loss), {n: p.grad.numpy() for n, p in
                              m.named_parameters() if p.grad is not None},
                weights)
        paddle.set_device(place)
        g_cpu, g_gpu = got["cpu"][1], got["card"][1]
        check(set(g_cpu) == set(g_gpu), "card vs cpu: other leaves have grads")
        top = max(np.linalg.norm(g) for g in g_cpu.values())
        grad_rel = {n: float(np.linalg.norm(g_gpu[n] - g)
                             / max(np.linalg.norm(g), AMP_GRAD_FLOOR * top))
                    for n, g in g_cpu.items()}
        worst = max(grad_rel, key=grad_rel.get)
        loss_rel = abs(got["card"][0] - got["cpu"][0]) / abs(got["cpu"][0])
        res["card_vs_cpu"][level] = {
            "losses": [got["cpu"][0], got["card"][0]], "loss_rel": loss_rel,
            "grad_rel_max": grad_rel[worst], "grad_rel_worst": worst,
            "tols": [AMP_LOSS_RTOL, AMP_GRAD_RTOL]}
        print(f"amp: (d) bf16 {level} depth 2 card vs cpu loss rel "
              f"{loss_rel:.2e} (tol {AMP_LOSS_RTOL}), grads max rel "
              f"{grad_rel[worst]:.2e} ({worst}, tol {AMP_GRAD_RTOL})",
              flush=True)
        check(loss_rel <= AMP_LOSS_RTOL, f"{level} card vs cpu loss rel "
              f"{loss_rel}")
        check(grad_rel[worst] <= AMP_GRAD_RTOL,
              f"{level} card vs cpu grad {worst} rel {grad_rel[worst]}")
        del got

    # (e) paddle.nn.LSTM: a training step, and the card against the CPU
    sh = dict(lstm_shape or LSTM_SHAPE)
    paddle.seed(0)
    lstm = paddle.nn.LSTM(sh["input_size"], sh["hidden_size"],
                          sh["num_layers"], direction="bidirect")
    lopt = paddle.optimizer.Adam(learning_rate=1e-3,
                                 parameters=lstm.parameters())
    rng = np.random.RandomState(6)
    xb = paddle.to_tensor(rng.randn(sh["batch"], sh["seq"],
                                    sh["input_size"]).astype(np.float32))
    yb = paddle.to_tensor(rng.randn(sh["batch"], sh["seq"],
                                    2 * sh["hidden_size"]).astype(np.float32))

    def lstm_step(x, y):
        out, _ = lstm(x)
        loss_ = paddle.nn.functional.mse_loss(out, y)
        loss_.backward()
        lopt.step()
        lopt.clear_grad()
        return loss_

    l_losses = [float(lstm_step(xb, yb))]
    l_ms = []
    for _ in range(AMP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        l_losses.append(float(lstm_step(xb, yb)))
        l_ms.append((time.perf_counter() - t0) * 1e3)
    check(all(np.isfinite(l_losses)) and l_losses[-1] < l_losses[0],
          f"amp (e): LSTM losses {l_losses}")
    l_med = statistics.median(l_ms)
    lprof = _profile_step(lstm_step, (xb, yb), l_med)
    cs = LSTM_CHECK_SHAPE
    rng = np.random.RandomState(8)
    xs = rng.randn(cs["batch"], cs["seq"], cs["input_size"]).astype(
        np.float32)
    got = {}
    for where in ("cpu", place):
        paddle.set_device(where)
        paddle.seed(2)
        m = paddle.nn.LSTM(cs["input_size"], cs["hidden_size"],
                           cs["num_layers"])
        if got:
            m.set_state_dict(got["cpu"][2])
        out, (h, c) = m(paddle.to_tensor(xs))
        loss = (out ** 2).mean() + (c ** 2).mean()
        loss.backward()
        got["card" if got else "cpu"] = (
            float(loss), {n: p.grad.numpy()
                          for n, p in m.named_parameters()},
            {k: v.numpy() for k, v in m.state_dict().items()})
    paddle.set_device(place)
    l_rel = abs(got["card"][0] - got["cpu"][0]) / abs(got["cpu"][0])
    lg = max(float(np.linalg.norm(got["card"][1][n] - g)
                   / np.linalg.norm(g)) for n, g in got["cpu"][1].items())
    check(l_rel <= TRAIN_LOSS_RTOL and lg <= TRAIN_GRAD_RTOL,
          f"amp (e): LSTM card vs cpu loss rel {l_rel}, grad rel {lg}")
    # autograd.jacobian / hessian of a small function, card against CPU
    wj = np.random.RandomState(9).randn(6, 5).astype(np.float32)
    xj = np.random.RandomState(10).randn(4, 6).astype(np.float32)
    jac = {}
    for where in ("cpu", place):
        paddle.set_device(where)
        w_t = paddle.to_tensor(wj)
        f = (lambda x: paddle.tanh(paddle.matmul(x, w_t)))
        jac[where] = (paddle.autograd.jacobian(f, paddle.to_tensor(xj))
                      .numpy(),
                      paddle.autograd.hessian(lambda x: f(x).sum(),
                                              paddle.to_tensor(xj)).numpy())
    paddle.set_device(place)
    j_rel = [float(np.linalg.norm(jac[place][i] - jac["cpu"][i])
                   / np.linalg.norm(jac["cpu"][i])) for i in range(2)]
    check(max(j_rel) <= TRAIN_GRAD_RTOL, f"amp (e): jacobian/hessian card "
          f"vs cpu rel {j_rel}")
    res["lstm"] = {
        "shape": sh, "losses": l_losses, "step_ms": l_ms,
        "step_ms_median": l_med, "host_share": lprof["host_share"],
        "device_busy_ms": lprof["device_busy_ms"],
        "top_kernels_ms": lprof["top_kernels_ms"],
        "card_vs_cpu": {"shape": cs, "loss_rel": l_rel, "grad_rel_max": lg},
        "jacobian_hessian_rel": j_rel}
    print(f"amp: (e) LSTM {sh}: losses {[round(x, 4) for x in l_losses]}, "
          f"step median {l_med:.1f} ms ({[round(x, 1) for x in l_ms]}), "
          f"host share {lprof['host_share']}; card vs cpu {cs}: loss rel "
          f"{l_rel:.2e}, grads max rel {lg:.2e}; jacobian/hessian rel "
          f"{[f'{x:.2e}' for x in j_rel]}", flush=True)
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    return res


# ---------------------------------------------------------------- deploy
DEPLOY_DIR = Path(__file__).resolve().parent / "build" / "deploy"
#: the second batch the BERT artifact serves (its batch dim is dynamic)
DEPLOY_SMALL_BATCH = 8
#: the config-4 Pipe's depth in (c); the width is config 4's. At all 24
#: layers the phase took 94.2 s, (c) about 36 s of it: its save (22.9 s)
#: and load (11.0 s) go mostly to exporting and (de)serialising the
#: program, which grow with depth (at 4 layers 4.7 and 3.3 s, the phase
#: 66.2 s); 2 layers keep the phase under its 60 s
DEPLOY_PIPE_LAYERS = 2
#: the NaN check's config-4-width Pipe depth in (d)
DEPLOY_NAN_LAYERS = 2
#: (b): the bf16 weights' outputs against f32's, of the largest value
DEPLOY_BF16_TOL = 2e-2


def _wall_ms(fn, reps=3):
    """Median host-clock ms of ``fn()`` ending in a synchronise, after one
    warm-up call (the card's queue drained both sides)."""
    fn()
    _sync(DEVICE)
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(DEVICE)
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples)


def _artifact_bytes(prefix):
    return {ext: Path(prefix + ext).stat().st_size
            for ext in (".pdmodel", ".pdiparams", ".pdmeta.json")}


def _float_weight_bytes(prefix):
    """The bytes of the floating weights in a ``.pdiparams``."""
    with np.load(prefix + ".pdiparams", allow_pickle=False) as z:
        n = sum(1 for k in z.files if k.endswith("_dtype"))
        return sum(z[f"w{i}"].size for i in range(n)
                   if str(z[f"w{i}_dtype"]).startswith(("float", "bfloat")))


def _leaf_rel(got, want):
    """Largest |got - want| over the largest |want|, over matching
    leaves."""
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    top = max(float(w.float().abs().max()) for w in want)
    return err / top


def phase_deploy(smi="", bert_kw=None, batch=BERT_BATCH, seq=BERT_SEQ,
                 pipe_kw=None, pipe_batch=3, pipe_seq=2048):
    """How a Paddle user ships a model: (a) BERT-base (config 3's model,
    f32) through ``jit.to_static`` in eval, ``jit.save`` with a dynamic
    batch, ``inference.create_predictor`` on the card and ``run`` (a CUDA
    graph per feed shape): flash launches, outputs against eager, a second
    batch from the same artifact, save/load seconds, bytes and the run's
    ms against the eager and ``to_static`` forwards; (b) the same artifact
    after ``convert_to_mixed_precision``: floating weight bytes halved,
    outputs within the bf16 bound, and the device bytes each Predictor
    holds and peaks at; (c) config 4's Pipe forward to logits
    through ``jit.save`` and a ``Predictor``: exact launches a run, logits
    against eager; (d) ``FLAGS_check_nan_inf`` on a config-4-width
    ``TrainStep`` whose loss turns NaN: it raises naming the op and no
    byte of a parameter or slot changes; off, the step's launches are
    phase 6's per layer. ``bert_kw``/``pipe_kw`` (config overrides) and
    the shapes, with ``DEVICE = "cpu"``, rehearse it small (no launch or
    memory checks)."""
    import functools

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import BertForPretraining, bert_base
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLMPipe
    from paddle_tpu_torch.static import InputSpec
    from paddle_tpu_torch.utils.flags import set_flags

    K = paddle.ops.kernels
    card = DEVICE != "cpu"
    paddle.set_device("gpu" if card else "cpu")
    root = DEPLOY_DIR
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    res = {"smi": smi}
    launches = {name: 0 for name in K.launch_counts()}

    def counted(fn):
        K.reset_launch_counts()
        out = fn()
        _sync(DEVICE if card else "cpu")
        counts = K.launch_counts()
        for name, n in counts.items():
            launches[name] += n
        return out, counts

    def want_only(counts, want, tag):
        if not card:
            return
        full = {name: 0 for name in counts}
        full.update(want)
        check(counts == full, f"deploy {tag}: launches "
              f"{ {k: v for k, v in counts.items() if v} }, want {want}")

    def predictor(prefix):
        cfg = inference.Config(prefix + ".pdmodel", prefix + ".pdiparams")
        if not card:
            cfg.disable_gpu()
        check(cfg.use_gpu() == card, "Config.use_gpu()")
        return inference.create_predictor(cfg)

    def device_bytes(fn):
        """fn() on the card -> (its result, the bytes it left allocated,
        the most it had allocated at once), both above the start's."""
        if not card:
            return fn(), None, None
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return (out, torch.cuda.memory_allocated() - base,
                torch.cuda.max_memory_allocated() - base)

    def serve(prefix):
        """Load ``prefix``, then its eager first run and its capture ->
        (predictor, load seconds, first outputs, the capture's counts)."""
        t0 = time.perf_counter()
        pred = predictor(prefix)
        _sync(DEVICE)
        load_s = time.perf_counter() - t0
        first = pred.run([ids])
        return pred, load_s, first, counted(lambda: pred.run([ids]))[1]

    # (a) BERT-base: to_static in eval -> jit.save -> Predictor -> run
    cfg = bert_base(dropout=0.0, **(bert_kw or {}))
    paddle.seed(0)
    model = BertForPretraining(cfg)      # outputs (MLM logits, NSP logits)
    model.eval()
    nparams = sum(p.size for p in model.parameters())
    if bert_kw is None:
        check(round(nparams / 1e6, 1) == 110.1,
              f"BERT-base has {nparams} parameters")
    L = cfg.num_layers
    rng = np.random.RandomState(5)
    ids = paddle.to_tensor(rng.randint(0, cfg.vocab_size, (batch, seq))
                           .astype(np.int64))
    with paddle.no_grad():
        ref = [t._data for t in model(ids)]
        eager_ms = _wall_ms(lambda: model(ids))
    static = paddle.jit.to_static(model)
    t0 = time.perf_counter()
    with paddle.no_grad():
        got = [t._data for t in static(ids)]
    _sync(DEVICE if card else "cpu")
    capture_s = time.perf_counter() - t0
    tol = FLASH_TOL[torch.float32]
    rel = _leaf_rel(got, ref)
    check(rel <= tol, f"deploy (a): to_static vs eager rel {rel}")
    with paddle.no_grad():
        static_ms = _wall_ms(lambda: static(ids))
    prefix = str(root / "bert")
    t0 = time.perf_counter()
    paddle.jit.save(static, prefix, input_spec=[
        InputSpec([None, seq], "int64", name="input_ids")])
    save_s = time.perf_counter() - t0
    (pred, load_s, first, counts), held32, peak32 = device_bytes(
        lambda: serve(prefix))
    check(pred.get_input_names() == ["input_ids"], "deploy (a): feed names")
    want_only(counts, {"flash_attention_fwd": L}, "(a) capture run")
    outs, counts = counted(lambda: pred.run([ids]))
    want_only(counts, {"flash_attention_fwd": L}, "(a) graphed run")
    rel_pred = _leaf_rel(outs, ref)
    check(rel_pred <= tol, f"deploy (a): predictor vs eager rel {rel_pred}")
    check(all(torch.equal(a, b) for a, b in zip(outs, first)),
          "deploy (a): the graphed run differs from the eager run")
    pred_ms = _wall_ms(lambda: pred.run([ids]))
    graph_device_ms = (time_ms(next(iter(pred._prepared.values()))
                               .graph.replay, reps=5, inner=2)
                       if card else None)
    small = ids[:DEPLOY_SMALL_BATCH]
    outs8, _ = counted(lambda: pred.run([small]))
    with paddle.no_grad():
        ref8 = [t._data for t in model(small)]
    rel8 = _leaf_rel(outs8, ref8)
    check(rel8 <= tol and tuple(outs8[0].shape)
          == (DEPLOY_SMALL_BATCH, seq, cfg.vocab_size),
          f"deploy (a): batch {DEPLOY_SMALL_BATCH} rel {rel8}")
    res["a"] = {
        "model": "bert-base (config 3)", "params": nparams,
        "batch": batch, "seq": seq, "capture_s": capture_s,
        "save_s": save_s, "load_s": load_s,
        "artifact_bytes": _artifact_bytes(prefix),
        "eager_ms": eager_ms, "to_static_ms": static_ms,
        "predictor_ms": pred_ms, "graph_device_ms": graph_device_ms,
        "host_share_eager": (None if graph_device_ms is None
                             else 1.0 - graph_device_ms / eager_ms),
        "rel_to_static": rel, "rel_predictor": rel_pred,
        "rel_small_batch": rel8,
        "segments": static._segment_stats}
    print(f"deploy (a): BERT-base {nparams / 1e6:.1f} M params f32, "
          f"[{batch}, {seq}]: to_static capture {capture_s:.2f} s "
          f"({static._segment_stats}), save {save_s:.2f} s, load "
          f"{load_s:.2f} s, bytes {res['a']['artifact_bytes']}; eager "
          f"{eager_ms:.2f} ms, to_static {static_ms:.2f} ms, predictor "
          f"(graphed) {pred_ms:.2f} ms, its replay on the card "
          f"{graph_device_ms} ms, host share of eager "
          f"{res['a']['host_share_eager']}; rel err to_static {rel:.2e}, "
          f"predictor {rel_pred:.2e}, batch {DEPLOY_SMALL_BATCH} "
          f"{rel8:.2e} (tol {tol})", flush=True)

    # (b) convert_to_mixed_precision: bf16 weights upcast at the boundary
    mixed = str(root / "bert_bf16")
    t0 = time.perf_counter()
    inference.convert_to_mixed_precision(
        prefix + ".pdmodel", prefix + ".pdiparams", mixed + ".pdmodel",
        mixed + ".pdiparams")
    convert_s = time.perf_counter() - t0
    f32_bytes, bf16_bytes = (_float_weight_bytes(prefix),
                             _float_weight_bytes(mixed))
    check(2 * bf16_bytes == f32_bytes,
          f"deploy (b): floating weights {bf16_bytes} B against f32's "
          f"{f32_bytes} B")
    del first
    (pred16, _, first16, _), held16, peak16 = device_bytes(
        lambda: serve(mixed))
    outs16, counts = counted(lambda: pred16.run([ids]))
    want_only(counts, {"flash_attention_fwd": L}, "(b) graphed run")
    check(all(torch.equal(a, b) for a, b in zip(outs16, first16)),
          "deploy (b): the graphed run differs from the eager run")
    rel16 = _leaf_rel(outs16, outs)
    check(rel16 <= DEPLOY_BF16_TOL, f"deploy (b): bf16 weights rel {rel16}")
    if card:
        # each weight's f32 copy lives from its first use to its last, so
        # the bf16 artifact holds and peaks below the f32 one on the card
        check(held16 < held32 and peak16 < peak32,
              f"deploy (b): device bytes held {held16} and peak {peak16} "
              f"against f32's {held32} and {peak32}")
    res["b"] = {"convert_s": convert_s, "float_bytes_f32": f32_bytes,
                "float_bytes_bf16": bf16_bytes, "rel_to_f32": rel16,
                "device_bytes_held_f32": held32,
                "device_bytes_held_bf16": held16,
                "device_bytes_peak_f32": peak32,
                "device_bytes_peak_bf16": peak16,
                "predictor_ms": _wall_ms(lambda: pred16.run([ids]))}
    print(f"deploy (b): convert {convert_s:.2f} s, floating weights "
          f"{f32_bytes} -> {bf16_bytes} B, rel err to (a) {rel16:.2e} "
          f"(tol {DEPLOY_BF16_TOL}), predictor {res['b']['predictor_ms']:.2f}"
          f" ms; device bytes a Predictor holds after its capture, f32 "
          f"{held32}, bf16 {held16}; its peak while loading, running and "
          f"capturing, f32 {peak32}, bf16 {peak16}", flush=True)
    del pred, pred16, first16, static, model
    _free(card)

    # (c) config 4's Pipe forward to logits through jit.save -> Predictor
    pcfg = GPTConfig(**dict(dict(vocab_size=32000, hidden_size=2048,
                                 num_heads=16, max_seq_len=2048,
                                 dropout=0.0, dtype="bfloat16"),
                            **(pipe_kw or {}),
                            num_layers=DEPLOY_PIPE_LAYERS))
    gen = torch.Generator(device=DEVICE if card else "cpu").manual_seed(4)
    pipe = GPTForCausalLMPipe(pcfg, device=DEVICE if card else "cpu",
                              dtype=torch.bfloat16).init_weights(gen)
    pids = torch.as_tensor(np.random.default_rng(6).integers(
        0, pcfg.vocab_size, (pipe_batch, pipe_seq)),
        device=DEVICE if card else "cpu")
    with torch.no_grad():
        (plogits,), _ = counted(lambda: (pipe(pids),))
    pprefix = str(root / "pipe")
    t0 = time.perf_counter()
    paddle.jit.save(pipe, pprefix, input_spec=[
        InputSpec([pipe_batch, pipe_seq], "int64", name="input_ids")])
    psave_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ppred = predictor(pprefix)
    pload_s = time.perf_counter() - t0
    ppred.run([pids])
    (lg,), counts = counted(lambda: ppred.run([pids]))
    PL = DEPLOY_PIPE_LAYERS
    want_only(counts, {"flash_attention_fwd": PL, "rms_norm": 2 * PL,
                       "swiglu_down": PL}, "(c) graphed run")
    prel = _leaf_rel([lg], [plogits])
    check(prel <= FLASH_TOL[torch.bfloat16],
          f"deploy (c): predictor logits vs eager rel {prel}")
    res["c"] = {"model": "gpt3-1.3b Pipe (config 4) forward",
                "layers": PL, "batch": pipe_batch, "seq": pipe_seq,
                "params": sum(p.numel() for p in pipe.parameters()),
                "save_s": psave_s, "load_s": pload_s,
                "artifact_bytes": _artifact_bytes(pprefix),
                "launches_per_run": {k: v for k, v in counts.items() if v},
                "launch_formula": "per run: flash_attention_fwd L, rms_norm "
                                  f"2L, swiglu_down L; L = {PL}",
                "rel_logits": prel, "bitwise": bool(torch.equal(lg,
                                                                plogits)),
                "predictor_ms": _wall_ms(lambda: ppred.run([pids]))}
    print(f"deploy (c): Pipe at {PL} layers, width {pcfg.hidden_size}, "
          f"[{pipe_batch}, {pipe_seq}] bf16: save {psave_s:.2f} s, load "
          f"{pload_s:.2f} s, bytes {res['c']['artifact_bytes']}; launches "
          f"a run {res['c']['launches_per_run']} "
          f"({res['c']['launch_formula']}); logits rel {prel:.2e}, bitwise "
          f"{res['c']['bitwise']}; predictor {res['c']['predictor_ms']:.2f}"
          f" ms", flush=True)
    del ppred, pipe, plogits, lg
    _free(card)

    # (d) FLAGS_check_nan_inf on a config-4-width TrainStep
    ncfg = GPTConfig(**dict(dict(vocab_size=32000, hidden_size=2048,
                                 num_heads=16, max_seq_len=2048,
                                 dropout=0.0, dtype="bfloat16"),
                            **(pipe_kw or {}),
                            num_layers=DEPLOY_NAN_LAYERS, recompute=True))
    dev = DEVICE if card else "cpu"
    nmodel, step = _train_setup(ncfg, torch.bfloat16, dev, seed=3,
                                int8=False)
    nids, nlabels = _train_batch(ncfg.vocab_size, pipe_batch, pipe_seq, 3,
                                 dev)
    step(nids, nlabels)                       # the slots exist after this
    _, counts = counted(lambda: step(nids, nlabels))
    NL = DEPLOY_NAN_LAYERS
    want_only(counts, {"flash_attention_fwd": 2 * NL,
                       "flash_attention_bwd": NL, "swiglu_down": 2 * NL,
                       "rms_norm": 4 * NL}, "(d) the step with the flag off")
    opt = step.optimizer

    def state_bytes():
        ts = [p for p in nmodel.parameters()]
        ts += [t for p in ts for t in opt.state.get(p, {}).values()
               if isinstance(t, torch.Tensor)]
        return [t.detach().reshape(-1).view(torch.uint8).to("cpu",
                                                             copy=True)
                for t in ts], opt._step_count

    def nan_loss(i, lab):
        # log(loss - loss - 1) = log(-1): the first non-finite op is aten.log
        loss = nmodel.loss(i, lab, int8=False)
        return torch.log(loss - loss.detach() - 1.0)

    before, count_before = state_bytes()
    nan_step = TrainStep(nmodel, nan_loss, opt)
    set_flags({"FLAGS_check_nan_inf": True})
    try:
        nan_step(nids, nlabels)
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    finally:
        set_flags({"FLAGS_check_nan_inf": False})
    check(raised is not None and "aten.log" in raised,
          f"deploy (d): the NaN step raised {raised!r}")
    after, count_after = state_bytes()
    same = (count_after == count_before and len(after) == len(before)
            and all(torch.equal(a, b) for a, b in zip(after, before)))
    check(same, "deploy (d): the refused step changed a parameter or slot")
    res["d"] = {"layers": NL, "raised": raised, "unchanged_tensors":
                len(before), "launches_flag_off": {k: v for k, v in
                                                   counts.items() if v}}
    print(f"deploy (d): {raised}; {len(before)} parameter and slot tensors "
          f"unchanged byte for byte; flag off, one step's launches "
          f"{res['d']['launches_flag_off']} (phase 6's per layer at L = "
          f"{NL})", flush=True)
    del step, nan_step, nmodel, opt
    _free(card)
    res["launches"] = launches
    return res



# ------------------------------------------------------------- phase tools
#: (a) config 4's Pipe at this many of its 24 layers under the profiler
TOOLS_PROFILE_LAYERS = 4
#: (b) the planner's config 4 at this many of its 24 layers, and its grid
TOOLS_PLAN_LAYERS = 24
TOOLS_PLAN_BATCHES = (3, 6)
#: no remat against phase 8's names: list. Under full remat at 24 layers
#: the optimizer update's f32 temporaries, not the activations, set the
#: static peak (18.5 GB at batch 3 and 6 alike, PR 23's first call), so
#: a grid of full and names: would give budgets no bytes apart
TOOLS_PLAN_POLICIES = ("none", LONG_POLICY)
PROFILER_DIR = Path(__file__).resolve().parent / "build" / "profiler"
#: (c) the JAX package's checkpoint, written by tests/data/jax_ckpt/
#: write_fixture.py (a depth-2 f32 Pipe after two AdamW steps)
JAX_FIXTURE = Path(__file__).resolve().parent / "tests" / "data" / "jax_ckpt"


def phase_tools(smi="", cfg4=None, batch=3, seq=2048, plan_layers=None,
                plan_batches=TOOLS_PLAN_BATCHES, engine_kw=None):
    """The operator's tools on the card: (a) ``paddle.profiler`` over 6
    steps of config 4's Pipe at ``TOOLS_PROFILE_LAYERS`` layers, bf16,
    ``batch`` x ``seq``, under ``make_scheduler(closed=1, ready=1,
    record=2, repeat=1)`` and ``export_chrome_tracing``, each step in a
    ``RecordEvent("train_step")``: the device table's launches of each
    kernel against the 2 recorded steps', the exported trace naming the
    four kernels, the host table's ranges; readings: the step median
    without a profiler, with it closed and while recording, the family
    totals, the window's busy share against ``_profile_step``'s, and
    whether a graphed decode tick's kernels are listed; (b) the memory
    planner over config 4 at ``plan_layers`` layers: each candidate's
    static ``memory_stats`` and trace seconds, then a plan under a budget
    between two static peaks, its winner's real step and its
    ``max_memory_allocated`` within the budget; (c) the JAX package's
    checkpoint fixture (``tests/data/jax_ckpt``): validated (CRC32C through
    the native library), restored into the port's Pipe on the card, its
    next loss against the JAX package's within phase 7's bound, and its
    ``paddle.save`` file loaded on the card bit for bit. ``cfg4``,
    ``plan_layers``, the shapes and ``engine_kw``, with ``DEVICE = "cpu"``,
    rehearse it small (no launch or memory checks)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import memory, profiler
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLMPipe
    from paddle_tpu_torch.models.llama import llama_preset
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.profiler import device_trace

    K = paddle.ops.kernels
    card = DEVICE != "cpu"
    dev = DEVICE if card else "cpu"
    res = {"smi": smi}
    launches = {name: 0 for name in K.launch_counts()}

    def add(counts):
        for name, n in counts.items():
            launches[name] += n

    # (a) paddle.profiler over config 4's Pipe at TOOLS_PROFILE_LAYERS
    base_kw = dict(CONFIG4, **(cfg4 or {}))
    L = TOOLS_PROFILE_LAYERS
    cfg = GPTConfig(**dict(base_kw, num_layers=L))
    model, step = _train_setup(cfg, torch.bfloat16, dev, seed=0)
    ids, labels = _train_batch(cfg.vocab_size, batch, seq, 0, dev)

    def timed_step():
        t0 = time.perf_counter()
        loss = step(ids, labels)
        _sync(dev)
        return (time.perf_counter() - t0) * 1e3, loss

    timed_step()                                           # warm-up
    plain_ms = [timed_step()[0] for _ in range(3)]
    shutil.rmtree(PROFILER_DIR, ignore_errors=True)
    prof = profiler.Profiler(
        scheduler=profiler.make_scheduler(closed=1, ready=1, record=2,
                                          repeat=1),
        on_trace_ready=profiler.export_chrome_tracing(str(PROFILER_DIR)))
    states, prof_ms, losses = [], [], []
    K.reset_launch_counts()
    prof.start()
    for _ in range(6):
        states.append(prof._state.name)
        with profiler.RecordEvent("train_step"):
            ms, loss = timed_step()
        prof_ms.append(ms)
        losses.append(loss.item())
        prof.step()
    prof.stop()
    counts = K.launch_counts()
    add(counts)
    per_step = {"flash_attention_fwd": 2 * L, "flash_attention_bwd": L,
                "swiglu_down": 2 * L, "rms_norm": 4 * L}
    check(states == ["CLOSED", "READY", "RECORD", "RECORD_AND_RETURN",
                     "CLOSED", "CLOSED"], f"tools (a): states {states}")
    recorded = [i for i, st in enumerate(states) if st.startswith("RECORD")]
    rows = prof.device_rows()
    by_kernel = {}
    for r in rows:
        name = device_trace.port_kernel(r["name"])
        if name is not None:
            by_kernel[name] = by_kernel.get(name, 0) + r["calls"]
    files = sorted(PROFILER_DIR.glob("*.json"))
    check(len(files) == 1, f"tools (a): trace files {files}")
    trace = json.loads(files[0].read_text())
    traced = {device_trace.port_kernel(e.get("name", ""))
              for e in trace["traceEvents"] if e.get("cat") == "kernel"}
    stats = profiler.host_event_statistics(prof._host_events)
    check(stats.get("train_step", {}).get("calls") == 6,
          f"tools (a): host ranges {stats.get('train_step')}")
    check(all(np.isfinite(losses)), f"tools (a): losses {losses}")
    if card:
        want = {k: v * len(recorded) for k, v in per_step.items()}
        check(by_kernel == want, f"tools (a): the device table's launches "
              f"{by_kernel}, want {want} (2 recorded steps, L = {L})")
        check({k: counts[k] for k in per_step}
              == {k: v * 6 for k, v in per_step.items()},
              f"tools (a): launches {counts}")
        check(set(per_step) <= traced, f"tools (a): the chrome trace names "
              f"{sorted(n for n in traced if n)}")
    union_us, span_us = device_trace.busy_us(prof._device_events)
    window_ms = sum(prof_ms[i] for i in recorded)
    fams = device_trace.summarize_families(rows)
    ref = _profile_step(step, (ids, labels), statistics.median(plain_ms),
                        repeat=2) if card else None
    res["a"] = {
        "layers": L, "batch": batch, "seq": seq, "states": states,
        "step_ms_no_profiler": plain_ms, "step_ms_profiled": prof_ms,
        "median_no_profiler": statistics.median(plain_ms),
        "median_closed": statistics.median(
            [prof_ms[i] for i, st in enumerate(states) if st == "CLOSED"]),
        "median_recording": statistics.median([prof_ms[i]
                                               for i in recorded]),
        "device_launches_recorded": by_kernel,
        "families_us": {f["family"]: round(f["total_us"], 1) for f in fams},
        "window_busy_share": (union_us / 1e3 / window_ms
                              if window_ms else None),
        "profile_step_busy_share": (ref["device_union_ms"] / 2
                                    / statistics.median(plain_ms)
                                    if ref else None),
        "trace_file": str(files[0].relative_to(Path(__file__).parent)),
        "trace_bytes": files[0].stat().st_size,
        "host_ranges": stats["train_step"]["calls"]}
    print(f"tools (a): Pipe at {L} layers bf16 [{batch}, {seq}]: step "
          f"median {res['a']['median_no_profiler']:.1f} ms without the "
          f"profiler, {res['a']['median_closed']:.1f} closed, "
          f"{res['a']['median_recording']:.1f} recording; device table "
          f"launches over the 2 recorded steps {by_kernel}; families "
          f"{res['a']['families_us']} us; window busy share "
          f"{res['a']['window_busy_share']} against _profile_step's "
          f"{res['a']['profile_step_busy_share']}; trace "
          f"{res['a']['trace_bytes']} B", flush=True)
    del step, model
    _free(card)

    # (a') a graphed decode tick under the profiler: are its kernels listed?
    lcfg = llama_preset("tiny")
    gen = torch.Generator(device=dev).manual_seed(1)
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    lm = LlamaForCausalLM(lcfg, device=dev, dtype=torch.bfloat16) \
        .init_weights(gen, std=0.02)
    eng = ContinuousBatchingEngine(lm, max_new_tokens=16, **dict(
        dict(max_slots=4, page_size=64, max_seq_len=512, prefill_chunk=128,
             seed=0, device=dev), **(engine_kw or {})))
    rng = np.random.default_rng(3)
    for n in (40, 70, 90, 120):
        eng.submit(rng.integers(1, lcfg.vocab_size, n).tolist())
    for _ in range(4):                       # prefills, then graphed ticks
        eng.step()
    tick = profiler.Profiler()
    K.reset_launch_counts()
    with tick:
        for _ in range(4):
            eng.step()
        _sync(dev)
    tick_counts = K.launch_counts()
    add(tick_counts)
    listed = {}
    for r in tick.device_rows():
        name = device_trace.port_kernel(r["name"])
        if name is not None:
            listed[name] = listed.get(name, 0) + r["calls"]
    res["a_tick"] = {"graphed": getattr(eng, "_graph", None) is not None,
                     "launches": {k: v for k, v in tick_counts.items() if v},
                     "listed": listed}
    print(f"tools (a'): 4 decode ticks of a graphed engine (tiny LLaMA): "
          f"launches {res['a_tick']['launches']}, the profiler lists "
          f"{listed}", flush=True)
    del eng, lm
    _free(card)

    # (b) the planner over config 4 at plan_layers layers
    PL = plan_layers or TOOLS_PLAN_LAYERS
    pcfg = GPTConfig(**dict(base_kw, num_layers=PL))
    _sync(dev)
    base = torch.cuda.memory_allocated() if card else 0
    t0 = time.perf_counter()
    pmodel, pstep = _train_setup(pcfg, torch.bfloat16, dev, seed=2)
    build_s = time.perf_counter() - t0
    popt = pstep.optimizer

    def factory(cand):
        pcfg.recompute = cand.policy != "none"
        pcfg.recompute_policy = cand.policy
        step = TrainStep(pmodel, pstep.train_fn, popt)
        return step, tuple(torch.empty(cand.batch, seq, dtype=torch.int64,
                                       device="meta") for _ in range(2))

    cands = [memory.Candidate(b, pol) for b in plan_batches
             for pol in TOOLS_PLAN_POLICIES]
    priced = []
    for cand in cands:
        t0 = time.perf_counter()
        cstep, cbatch = factory(cand)
        mem = cstep.memory_stats(*cbatch)
        priced.append({"batch": cand.batch, "policy": cand.policy,
                       "score": memory.throughput_score(cand.batch,
                                                        cand.policy),
                       "trace_s": time.perf_counter() - t0, **mem})
        c = priced[-1]
        print(f"tools (b): batch {c['batch']} {c['policy']}: argument "
              f"{c['argument_bytes']} temp {c['temp_bytes']} peak "
              f"{c['peak_bytes']} B, score {c['score']:.4f}, traced in "
              f"{c['trace_s']:.2f} s", flush=True)
    order = sorted(priced, key=lambda c: -c["score"])
    first = order[0]["peak_bytes"]
    below = [c for c in order[1:] if c["peak_bytes"] < first]
    check(bool(below), f"tools (b): no candidate prices below the "
          f"highest-scoring one: {priced}")
    budget = (first + max(c["peak_bytes"] for c in below)) // 2
    fit = [c for c in order if c["peak_bytes"] <= budget]
    t0 = time.perf_counter()
    decision = memory.plan_train_step(factory, cands, budget_bytes=budget,
                                      cache_path="")
    plan_s = time.perf_counter() - t0
    check((decision.batch, decision.policy)
          == (fit[0]["batch"], fit[0]["policy"]),
          f"tools (b): the plan chose {decision.batch}, {decision.policy}; "
          f"the highest-scoring fit is {fit[0]}")
    pcfg.recompute = decision.policy != "none"
    pcfg.recompute_policy = decision.policy
    wids, wlabels = _train_batch(pcfg.vocab_size, decision.batch, seq, 2,
                                 dev)
    if card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    wloss = pstep(wids, wlabels).item()
    _sync(dev)
    win_ms = (time.perf_counter() - t0) * 1e3
    add(K.launch_counts())
    measured = (torch.cuda.max_memory_allocated() - base) if card else None
    check(np.isfinite(wloss), f"tools (b): the winner's loss {wloss}")
    if card:
        check(measured <= budget, f"tools (b): the winner's real step "
              f"peaked at {measured} B over the budget {budget} B")
    res["b"] = {"layers": PL, "seq": seq, "build_s": build_s,
                "candidates": priced, "budget_bytes": budget,
                "decision": decision.as_json(), "plan_s": plan_s,
                "winner_step_ms": win_ms, "winner_loss": wloss,
                "measured_peak_bytes": measured,
                "static_peak_bytes": decision.peak_bytes,
                "measured_over_static": (measured / decision.peak_bytes
                                         if measured else None)}
    print(f"tools (b): config 4 at {PL} layers: budget {budget} B -> batch "
          f"{decision.batch} {decision.policy} (static peak "
          f"{decision.peak_bytes} B, planned in {plan_s:.2f} s); its real "
          f"step {win_ms:.0f} ms, loss {wloss:.4f}, measured peak "
          f"{measured} B ({res['b']['measured_over_static']} of static)",
          flush=True)
    del pstep, pmodel, popt
    _free(card)

    # (c) the JAX package's checkpoint on the card
    exp = json.loads((JAX_FIXTURE / "expected.json").read_text())
    mgr = CheckpointManager(str(JAX_FIXTURE / "root"))
    problems = mgr.validate_step(2)
    check(mgr.latest_step() == 2 and problems == [],
          f"tools (c): the fixture's root: {problems}")
    jcfg = GPTConfig(**exp["config"])
    jmodel = GPTForCausalLMPipe(jcfg, device=dev)
    jopt = AdamW(jmodel.named_parameters(), lr=exp["lr"], factored=True)
    check(mgr.restore_training_state(jmodel, jopt) == 2,
          "tools (c): restore")
    rng = np.random.default_rng(exp["next_seed"])
    jids = rng.integers(0, jcfg.vocab_size, (exp["batch"], exp["seq"]))
    jlabels = rng.integers(0, jcfg.vocab_size, (exp["batch"], exp["seq"]))
    paddle.set_device("gpu" if card else "cpu")
    saved = paddle.load(str(JAX_FIXTURE / "state.pdparams"))
    same = all(torch.equal(saved[n]._data, t)
               for n, t in jmodel.state_dict().items())
    check(same and saved["extra.bf16"]._data.dtype == torch.bfloat16
          and saved["extra.bf16"]._data.device.type == dev.split(":")[0],
          "tools (c): paddle.load of the JAX file against the restored "
          "parameters")
    K.reset_launch_counts()
    jstep = TrainStep(jmodel, jmodel.loss, jopt)
    jloss = jstep(torch.as_tensor(jids, device=dev),
                  torch.as_tensor(jlabels, device=dev)).item()
    add(K.launch_counts())
    rel = abs(jloss - exp["next_loss"]) / abs(exp["next_loss"])
    check(rel <= TRAIN_LOSS_RTOL, f"tools (c): the next loss {jloss} "
          f"against the JAX package's {exp['next_loss']} (rel {rel})")
    res["c"] = {"next_loss": jloss, "jax_next_loss": exp["next_loss"],
                "rel": rel, "validated": problems == []}
    print(f"tools (c): the JAX root validates (crc32c), restores into the "
          f"port's Pipe on {dev}; next loss {jloss:.7f} against the JAX "
          f"package's {exp['next_loss']:.7f} (rel {rel:.2e}, bound "
          f"{TRAIN_LOSS_RTOL}); paddle.load of its state file bit for bit",
          flush=True)
    del jstep, jmodel, jopt
    _free(card)
    res["launches"] = launches
    return res


# ------------------------------------------------------------ phase static
STATIC_DIR = Path(__file__).resolve().parent / "build" / "static"
#: Executor runs of (a): one warm-up, then timed
STATIC_RUNS = 4


def _bert_arrays(vocab, batch, seq, seed):
    """Seeded ``ids``, ``types`` (segment ids), MLM ``labels`` on 15% of
    positions (the rest -100) and ``nsp`` labels, as numpy int64."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (batch, seq)).astype(np.int64)
    types = rng.randint(0, 2, (batch, seq)).astype(np.int64)
    labels = np.full((batch, seq), -100, np.int64)
    pick = rng.rand(batch, seq) < 0.15
    labels[pick] = rng.randint(0, vocab, int(pick.sum()))
    nsp = rng.randint(0, 2, (batch,)).astype(np.int64)
    return {"ids": ids, "types": types, "labels": labels, "nsp": nsp}


def phase_static(smi="", cfg_kw=None, batch=BERT_BATCH, seq=BERT_SEQ):
    """BERT-base (config 3's model, f32, dropout 0) through the static
    graph: (a) ``program_guard`` -> ``AdamW.minimize`` ->
    ``Executor.run`` (a warm-up and 3 timed runs on one batch) against
    the eager step from the same weights: launches a run, the first loss
    bit for bit, the next two within 1e-4, each loss on the repeated
    batch moved from the one before (a frozen update repeats it), the
    step medians, a profiled run's host share and the replay's host µs a
    record (an eval replay's); (b) an eval program -> ``save_inference_model`` ->
    ``load_inference_model`` -> ``Executor.run(predictor)``: launches,
    logits against the program's own fetch, save/load s and bytes; (c)
    ``ir_module`` of the eval program, the three
    built-in patterns, ``run`` before and after, ``serialize`` ->
    ``deserialize``: the flash op's nodes, values, node counts and
    seconds; (d) ``cost_model.profile_measure`` of the forward against
    the analytic flops; (e) ``cinn.compiler.compile`` against eager and
    ``tensorrt.convert`` of (b)'s artifact to BF16 served by a
    ``Predictor``; (f) two ``CheckpointManager`` steps of (a)'s model and
    optimizer and the inspector: exit codes, the diff, a flipped byte.
    ``cfg_kw`` (BertConfig overrides) and the shapes, with ``DEVICE =
    "cpu"``, rehearse it small (no launch checks, no profile)."""
    import contextlib
    import io

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import cinn, cost_model, inference, static, tensorrt
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.distributed.checkpoint import inspect as ckpt
    from paddle_tpu_torch.ir import (AddZeroPattern, CastChainPattern,
                                     TransposePairPattern, graph_targets)
    from paddle_tpu_torch.models import BertForPretraining, bert_base

    K = paddle.ops.kernels
    card = DEVICE != "cpu"
    dev = DEVICE if card else "cpu"
    paddle.set_device("gpu" if card else "cpu")
    exe = static.Executor(paddle.CUDAPlace(0) if card else paddle.CPUPlace())
    root = STATIC_DIR
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    res = {"smi": smi}
    launches = {name: 0 for name in K.launch_counts()}
    tol = FLASH_TOL[torch.float32]

    def counted(fn):
        K.reset_launch_counts()
        out = fn()
        _sync(dev)
        counts = K.launch_counts()
        for name, n in counts.items():
            launches[name] += n
        return out, counts

    def want_only(counts, want, tag):
        if not card:
            return
        full = {name: 0 for name in counts}
        full.update(want)
        check(counts == full, f"static {tag}: launches "
              f"{ {k: v for k, v in counts.items() if v} }, want {want}")

    t_phase = time.perf_counter()
    cfg = bert_base(dropout=0.0, **(cfg_kw or {}))
    L, V = cfg.num_layers, cfg.vocab_size
    b, s = batch, seq
    feed = _bert_arrays(V, b, s, 11)
    ids_t, types_t, labels_t, nsp_t = (paddle.to_tensor(feed[k]) for k in
                                       ("ids", "types", "labels", "nsp"))

    # (a) the eager step, then the static program, from the same weights
    paddle.seed(0)
    model = BertForPretraining(cfg)
    init = {k: v._data.detach().clone() for k, v in
            model.state_dict().items()}
    opt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=model.parameters())
    eager_losses, eager_ms = [], []
    for i in range(STATIC_RUNS):
        _sync(dev)
        t0 = time.perf_counter()
        loss = model.loss(ids_t, labels_t, nsp_t, token_type_ids=types_t)
        loss.backward()
        opt.step()
        opt.clear_grad()
        eager_losses.append(float(loss))
        eager_ms.append((time.perf_counter() - t0) * 1e3)
    del opt, loss
    model.set_state_dict(init)
    del init
    _free(card)
    t0 = time.perf_counter()
    main = static.Program()
    with static.program_guard(main, static.Program()):
        vs = {k: static.data(k, [b, s] if k != "nsp" else [b], "int64")
              for k in ("ids", "types", "labels", "nsp")}
        sloss = model.loss(vs["ids"], vs["labels"], vs["nsp"],
                           token_type_ids=vs["types"])
        sopt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                      parameters=model.parameters())
        sopt.minimize(sloss)
    _sync(dev)
    build_s = time.perf_counter() - t0
    losses, ms = [], []
    for i in range(STATIC_RUNS):
        t0 = time.perf_counter()
        (lv,), counts = counted(lambda: exe.run(main, feed=feed,
                                                fetch_list=[sloss]))
        ms.append((time.perf_counter() - t0) * 1e3)
        want_only(counts, {"flash_attention_fwd": L,
                           "flash_attention_bwd": L}, f"(a) run {i}")
        losses.append(float(lv))
    check(all(np.isfinite(losses)), f"static (a): losses {losses}")
    check(_hex32(losses[0]) == _hex32(eager_losses[0]),
          f"static (a): first loss {losses[0]!r} against the eager step's "
          f"{eager_losses[0]!r}")
    rels = [abs(a - e) / abs(e) for a, e in zip(losses, eager_losses)]
    check(max(rels[1:3]) <= TRAIN_LOSS_RTOL,
          f"static (a): losses {losses} against eager {eager_losses}")
    # AdamW at 1e-4 without warm-up raises the loss of its first steps on
    # a fresh BERT-base, the eager step's too, so this run shows that the
    # update acts (a frozen one repeats the loss bit for bit) and, with
    # the eager comparison above, that it is the eager step's; not that
    # the repeated batch is learned
    check(all(a != c for a, c in zip(losses, losses[1:])),
          f"static (a): the update left the loss unchanged: {losses}")
    med, eager_med = statistics.median(ms[1:]), statistics.median(
        eager_ms[1:])
    prof = (_profile_step(lambda: exe.run(main, feed=feed,
                                          fetch_list=[sloss]), (), med)
            if card else {})
    res["a"] = {"seconds": time.perf_counter() - t_phase,
                "records": len(main.records), "build_s": build_s,
                "losses": losses, "eager_losses": eager_losses,
                "loss_rel": rels, "run_ms": ms, "run_ms_median": med,
                "eager_ms": eager_ms, "eager_ms_median": eager_med,
                "host_share": prof.get("host_share"),
                "device_busy_ms": prof.get("device_busy_ms"),
                "by_group_ms": prof.get("by_group_ms")}
    print(f"static (a): BERT-base [{b}, {s}] f32 program of "
          f"{len(main.records)} records, built in {build_s:.2f} s; losses "
          f"{losses} against eager {eager_losses} (first bit for bit, rel "
          f"{[f'{r:.1e}' for r in rels]}); Executor.run median {med:.1f} ms "
          f"against the eager step's {eager_med:.1f} ms; host share "
          f"{prof.get('host_share')}", flush=True)

    # (b) the eval program and its inference model
    model.eval()
    evalp = static.Program()
    with paddle.no_grad(), static.program_guard(evalp):
        eids = static.data("ids", [b, s], "int64")
        mlm, _ = model(eids)
    efeed = {"ids": feed["ids"]}
    (ref,), counts = counted(lambda: exe.run(
        evalp, feed=efeed, fetch_list=[mlm], return_numpy=False))
    want_only(counts, {"flash_attention_fwd": L}, "(b) eval run")
    ref = ref._data
    t_host = time.perf_counter()
    with torch.no_grad():
        static.replay(evalp.records, {id(eids): ref.new_tensor(
            feed["ids"], dtype=torch.int64)})
    replay_host_s = time.perf_counter() - t_host
    _sync(dev)
    prefix = str(root / "bert")
    t0 = time.perf_counter()
    static.save_inference_model(prefix, [eids], [mlm], program=evalp)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred, feeds, fetches = static.load_inference_model(prefix, exe)
    _sync(dev)
    load_s = time.perf_counter() - t0
    check(feeds == ["ids"], f"static (b): feed names {feeds}")
    first = exe.run(pred, feed=efeed, fetch_list=fetches,
                    return_numpy=False)[0]._data.clone()
    (got,), counts = counted(lambda: exe.run(
        pred, feed=efeed, fetch_list=fetches, return_numpy=False))
    want_only(counts, {"flash_attention_fwd": L}, "(b) predictor run")
    err, rel = _rel_err(got._data, ref)
    check(rel <= tol, f"static (b): predictor logits rel {rel}")
    check(torch.equal(got._data, first),
          "static (b): the graphed run differs from the eager run")
    pred_ms = _wall_ms(lambda: exe.run(pred, feed=efeed, fetch_list=fetches,
                                       return_numpy=False))
    res["b"] = {"seconds": time.perf_counter() - t_phase, "save_s": save_s, "load_s": load_s,
                "artifact_bytes": _artifact_bytes(prefix),
                "max_abs_err": err, "max_rel_err": rel,
                "predictor_ms": pred_ms,
                "replay_host_us_per_record": replay_host_s * 1e6
                / len(evalp.records)}
    print(f"static (b): save_inference_model {save_s:.2f} s, load "
          f"{load_s:.2f} s, bytes {res['b']['artifact_bytes']}; predictor "
          f"logits rel {rel:.2e} (tol {tol}), {pred_ms:.2f} ms a run; eval "
          f"replay {res['b']['replay_host_us_per_record']:.1f} host us a "
          f"record over {len(evalp.records)} records", flush=True)
    del first, got
    _free(card)

    # (c) the IR of the eval program
    t_c = time.perf_counter()
    ir = evalp.ir_module([mlm])
    t0 = time.perf_counter()
    g0 = ir.graph(efeed)
    trace_s = time.perf_counter() - t0
    n0 = graph_targets(g0)
    check(n0.count("flash_fwd") == L,
          f"static (c): {n0.count('flash_fwd')} flash_fwd nodes, want {L}")
    before, counts = counted(lambda: ir.run(efeed, return_numpy=False)[0])
    want_only(counts, {"flash_attention_fwd": L}, "(c) IR run")
    ir.apply(TransposePairPattern(), CastChainPattern(), AddZeroPattern())
    t0 = time.perf_counter()
    n1 = graph_targets(ir.graph(efeed))
    rewrite_s = time.perf_counter() - t0
    after = ir.run(efeed, return_numpy=False)[0]
    _, rel_ir = _rel_err(after._data, before._data)
    check(rel_ir <= tol, f"static (c): rewritten IR rel {rel_ir}")
    path = str(root / "bert_ir.pt2")
    t0 = time.perf_counter()
    ir.serialize(path, efeed)
    call = static.IrProgram.deserialize(path)
    back = call(feed["ids"])[0]
    serial_s = time.perf_counter() - t0
    _, rel_rt = _rel_err(back, before._data)
    check(rel_rt <= tol, f"static (c): deserialized program rel {rel_rt}")
    res["c"] = {"layers": L, "nodes_before": len(n0),
                "nodes_after": len(n1), "flash_nodes": n0.count("flash_fwd"),
                "trace_s": trace_s, "rewrite_s": rewrite_s,
                "serialize_roundtrip_s": serial_s, "rel_rewrite": rel_ir,
                "rel_roundtrip": rel_rt,
                "seconds": time.perf_counter() - t_c}
    print(f"static (c): IR at {L} layers, {len(n0)} nodes ({n0.count('flash_fwd')} "
          f"flash_fwd) -> {len(n1)} after the patterns; trace {trace_s:.2f} "
          f"s, rewrite {rewrite_s:.2f} s, serialize+load+run {serial_s:.2f} "
          f"s; rel {rel_ir:.2e} rewritten, {rel_rt:.2e} round trip",
          flush=True)
    del before, after, back, call, ir
    _free(card)

    # (d) the cost model of the forward
    cm = cost_model.CostModel()
    (cost,), counts = counted(lambda: [cm.profile_measure(
        lambda i: model(i)[0], ids_t)])
    h, f = cfg.hidden_size, cfg.intermediate_size
    tokens = b * s
    proj = 2 * tokens * (L * (4 * h * h + 2 * h * f) + h * h + h * V)
    attn = L * 4 * b * cfg.num_heads * s * s * (h // cfg.num_heads)
    want_flops = proj + attn
    frel = abs(cost["flops"] - want_flops) / want_flops
    check(frel <= 0.01, f"static (d): flops {cost['flops']} against the "
          f"analytic {want_flops} (rel {frel})")
    check(cost["flops"] - proj > attn / 2,
          f"static (d): the attention's flops not counted ({cost['flops']}"
          f" against the projections' {proj})")
    with paddle.no_grad():
        fwd_ms = _wall_ms(lambda: model(ids_t))
    res["d"] = {"seconds": time.perf_counter() - t_phase,
                "flops": cost["flops"], "analytic_flops": want_flops,
                "attention_flops": attn, "rel": frel,
                "bytes": cost["bytes accessed"], "roofline_ms":
                None if cost["time"] is None else cost["time"] * 1e3,
                "forward_ms": fwd_ms}
    print(f"static (d): profile_measure flops {cost['flops']:.4e} against "
          f"{want_flops:.4e} (rel {frel:.2e}; attention {attn:.3e}), bytes "
          f"{cost['bytes accessed']:.4e}, roofline {res['d']['roofline_ms']} "
          f"ms against the measured forward {fwd_ms:.2f} ms", flush=True)

    # (e) cinn.compiler.compile and tensorrt.convert
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(256, 256, generator=gen, device=dev)
    y = torch.randn(256, 256, generator=gen, device=dev)

    def fn(a, c):
        return torch.tanh(a @ c) * 2.0 + c.sum(0)

    compiled = cinn.compiler.compile(fn)
    cerr, crel = _rel_err(compiled(x, y), fn(x, y))
    check(crel <= 1e-6, f"static (e): cinn.compile rel {crel}")
    trt_dir = str(root / "trt")
    t0 = time.perf_counter()
    out = tensorrt.convert(prefix, tensorrt.TensorRTConfig(
        precision_mode=tensorrt.PrecisionMode.BF16, save_model_dir=trt_dir))
    convert_s = time.perf_counter() - t0
    f32_bytes, bf16_bytes = (_float_weight_bytes(prefix),
                             _float_weight_bytes(out))
    check(2 * bf16_bytes == f32_bytes, f"static (e): floating weights "
          f"{bf16_bytes} B against f32's {f32_bytes} B")
    trt_pred, _, _ = static.load_inference_model(out, exe)
    exe.run(trt_pred, feed=efeed, return_numpy=False)
    (tgot,), counts = counted(lambda: exe.run(trt_pred, feed=efeed,
                                              return_numpy=False))
    want_only(counts, {"flash_attention_fwd": L}, "(e) bf16 predictor run")
    trel = _leaf_rel([tgot._data], [ref])
    check(trel <= DEPLOY_BF16_TOL, f"static (e): bf16 weights rel {trel}")
    res["e"] = {"seconds": time.perf_counter() - t_phase, "cinn_rel": crel, "convert_s": convert_s,
                "float_bytes": [f32_bytes, bf16_bytes], "bf16_rel": trel}
    print(f"static (e): cinn.compile rel {crel:.1e}; tensorrt.convert BF16 "
          f"{convert_s:.2f} s, floating bytes {f32_bytes} -> {bf16_bytes}, "
          f"served rel {trel:.2e} (tol {DEPLOY_BF16_TOL})", flush=True)
    del pred, trt_pred, tgot, ref, compiled
    _free(card)

    # (f) two checkpoint steps of (a)'s model and optimizer, inspected
    model.train()
    ck = str(root / "ckpt")
    mgr = CheckpointManager(ck)
    t0 = time.perf_counter()
    mgr.save_training_state(1, model, sopt)
    mgr.wait()
    save1_s = time.perf_counter() - t0
    counted(lambda: exe.run(main, feed=feed, fetch_list=[sloss]))
    mgr.save_training_state(2, model, sopt)
    mgr.wait()

    def inspect(*argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = ckpt.main([ck, *argv, "--json"])
        return rc, json.loads(buf.getvalue()), time.perf_counter() - t0

    rc, rep, validate_s = inspect()
    check(rc == 0 and [r["step"] for r in rep] == [1, 2]
          and not any(r["problems"] for r in rep),
          f"static (f): inspector exit {rc}, {rep}")
    rc, rep, diff_s = inspect("--diff", "1", "2")
    keys = set(mgr.saved_keys(2))
    check(rc == 0 and not rep["identical"] and not rep["added"]
          and not rep["removed"]
          and {c.split(":")[0] for c in rep["changed"]} == keys,
          f"static (f): the diff left {rep['identical']} identical")
    payload = Path(mgr.step_dir(2)) / "0_0.distcp"
    with open(payload, "r+b") as fh:
        fh.seek(payload.stat().st_size // 2)
        byte = fh.read(1)
        fh.seek(-1, 1)
        fh.write(bytes([byte[0] ^ 0xFF]))
    rc_bad, rep_bad, _ = inspect("--step", "2")
    check(rc_bad == 1 and rep_bad[0]["problems"],
          f"static (f): a flipped byte gave exit {rc_bad}, {rep_bad}")
    res["f"] = {"seconds": time.perf_counter() - t_phase, "save_s": save1_s, "validate_s": validate_s,
                "diff_s": diff_s, "keys": len(keys),
                "step_bytes": sum(p.stat().st_size for p in
                                  Path(mgr.step_dir(1)).iterdir()),
                "flipped": rep_bad[0]["problems"]}
    print(f"static (f): {len(keys)} keys a step "
          f"({res['f']['step_bytes']} B), save {save1_s:.2f} s, validate "
          f"{validate_s:.2f} s (exit 0), diff {diff_s:.2f} s (every key "
          f"changed), a flipped byte: exit 1 ({rep_bad[0]['problems']})",
          flush=True)
    mgr.close()
    del main, evalp, model, sopt, mgr
    shutil.rmtree(root, ignore_errors=True)
    _free(card)
    res["launches"] = launches
    return res


# ------------------------------------------------------------ phase domains
#: SECOND's VoxelBackBone8x (OpenPCDet pcdet/models/backbones_3d/
#: spconv_backbone.py) at KITTI's voxel grid (z, y, x) and its
#: MAX_NUMBER_OF_VOXELS for train (tools/cfgs/dataset_configs/
#: kitti_dataset.yaml): (in, out, kernel, stride, padding, subm) per conv
SECOND_GRID = (41, 1600, 1408)
SECOND_VOXELS = 16000
SECOND_BATCH = 2
SECOND_BOXES = 40
SECOND_CONVS = (
    (4, 16, 3, 1, 1, True), (16, 16, 3, 1, 1, True),
    (16, 32, 3, 2, 1, False), (32, 32, 3, 1, 1, True),
    (32, 32, 3, 1, 1, True),
    (32, 64, 3, 2, 1, False), (64, 64, 3, 1, 1, True),
    (64, 64, 3, 1, 1, True),
    (64, 64, 3, 2, (0, 1, 1), False), (64, 64, 3, 1, 1, True),
    (64, 64, 3, 1, 1, True),
    (64, 128, (3, 1, 1), (2, 1, 1), 0, False))
#: google/bigbird-roberta-base's block-sparse pattern
BIGBIRD = dict(heads=12, head_dim=64, block=64, window=3, globals=2,
               randoms=3, seq=4096)
#: ogbn-arxiv's size and OGB's arxiv GCN widths
ARXIV = dict(nodes=169343, edges=1166243, features=128, hidden=256,
             classes=40, steps=3)
#: openai/whisper audio.py: 16 kHz, N_FFT 400, HOP_LENGTH 160, 80 mels,
#: 30 s chunks
WHISPER = dict(clips=32, samples=480000, sr=16000, n_fft=400, hop=160,
               n_mels=80, n_mfcc=40)
#: the distributions, Viterbi and low-rank tail: LLaMA's vocabulary,
#: CoNLL-2003's 9 BIO tags
DOMAINS_TAIL = dict(cat_rows=4096, vocab=32000, cat_draws=16, mvn_dim=64,
                    viterbi=(64, 512, 9), lowrank=(4096, 1024), rank=16)
DOMAINS_REL_TOL = 1e-4            # card against the CPU run / float64
DOMAINS_GRAD_TOL = 1e-3           # BigBird's gradients against dense
DOMAINS_CLOSED_TOL = 1e-5         # closed forms card against CPU
#: the f32 GCN step's gradients against float64, of each leaf's norm: the
#: first layers' gradients sum thousands of messages of both signs into
#: each hub node, and f32 keeps about 4e-4 of the leaf's norm there (the
#: CPU at 40,000 nodes the same), so 1e-4 is out of f32's reach
GCN_GRAD_TOL = 1e-3
ROUND_TRIP_TOL = 1e-5             # istft(stft(x)) of the clips' peak
ISTFT_MAX_LAUNCHES = 50           # ops a call (the reference: 2 a frame)


def _rel(got, want):
    """max |got - want| over max |want| (float64, on the host)."""
    g = got.detach().double().cpu()
    w = want.detach().double().cpu()
    return float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))


def _kitti_voxels(grid, n, batch, boxes, seed):
    """``batch`` point-cloud-like voxel sets of ``n`` distinct sites each:
    a ground patch with height noise and ``boxes`` box surfaces (top and
    four sides) standing on it, subsampled to ``n``. Returns indices
    [4, batch * n] (b, z, y, x) and features [batch * n, 4]."""
    rng = np.random.default_rng(seed)
    Z, Y, X = grid
    out = []
    for b in range(batch):
        side = int(math.ceil(math.sqrt(0.8 * n)))
        y0 = int(rng.integers(0, max(1, Y - side)))
        x0 = int(rng.integers(0, max(1, X - side)))
        yy, xx = np.meshgrid(np.arange(y0, y0 + side),
                             np.arange(x0, x0 + side), indexing="ij")
        ground = (Z // 4 + np.round(np.sin(yy / 9.0) + np.cos(xx / 13.0)
                                    + 0.3 * rng.standard_normal(yy.shape)))
        pts = [np.stack([ground.ravel(), yy.ravel(), xx.ravel()], 1)]
        for _ in range(boxes):
            ly, lx, h = (int(rng.integers(4, 9)), int(rng.integers(8, 17)),
                         int(rng.integers(4, 9)))
            by = int(rng.integers(y0, y0 + side - ly))
            bx = int(rng.integers(x0, x0 + side - lx))
            gz = int(ground[by - y0, bx - x0]) + 1
            cz, cy, cx = np.meshgrid(np.arange(gz, gz + h),
                                     np.arange(by, by + ly),
                                     np.arange(bx, bx + lx), indexing="ij")
            shell = ((cz == gz + h - 1) | (cy == by) | (cy == by + ly - 1)
                     | (cx == bx) | (cx == bx + lx - 1))
            pts.append(np.stack([cz[shell], cy[shell], cx[shell]], 1))
        p = np.concatenate(pts).astype(np.int64)
        p[:, 0] = p[:, 0].clip(0, Z - 1)
        p = np.unique(p, axis=0)
        check(len(p) >= n, f"domains (a): {len(p)} candidate sites < {n}")
        p = p[np.sort(rng.choice(len(p), n, replace=False))]
        out.append(np.concatenate([np.full((n, 1), b), p], 1))
    idx = np.concatenate(out).T
    return idx, rng.standard_normal((idx.shape[1], 4)).astype(np.float32)


def _second_net(paddle, sp):
    layers = []
    for cin, cout, k, s, p, subm in SECOND_CONVS:
        conv = (sp.nn.SubmConv3D(cin, cout, k, padding=p, bias_attr=False)
                if subm else sp.nn.Conv3D(cin, cout, k, stride=s,
                                          padding=p, bias_attr=False))
        layers += [conv, sp.nn.BatchNorm(cout, epsilon=1e-3, momentum=0.99),
                   sp.nn.ReLU()]
    return paddle.nn.Sequential(*layers)


def _second_forward(net, x, sp, checks):
    """The backbone, layer by layer; each SubmConv3D's output sites are
    its input's (when ``checks``)."""
    for layer in net:
        y = layer(x)
        if checks and isinstance(layer, sp.nn.SubmConv3D):
            check(torch.equal(y.indices()._data, x.indices()._data),
                  "domains (a): a SubmConv3D moved its sites")
        x = y
    return x


def _domains_second(paddle, card, grid, n, batch, boxes):
    import paddle_tpu_torch.sparse as sp
    from paddle_tpu_torch import device as tdevice
    from paddle_tpu_torch.convert import layer_state_from_numpy
    from paddle_tpu_torch.sparse.nn import functional as SF

    dev = torch.device(DEVICE)
    idx, feats = _kitti_voxels(grid, n, batch, boxes, seed=0)
    shape = (batch,) + tuple(grid) + (4,)
    cpu = torch.device("cpu")
    with tdevice._place_scope(cpu):
        paddle.seed(0)
        net_cpu = _second_net(paddle, sp)
    net = _second_net(paddle, sp)
    layer_state_from_numpy({k: v.numpy() for k, v in
                            net_cpu.state_dict().items()}, net)

    # the first SubmConv3D's rulebook: active sites in each 3^3 window;
    # each build's wall (host reads included), the median of 3 warm ones
    ind = torch.as_tensor(idx, device=dev)

    def build(subm, reps=3):
        walls, rb = [], None
        for _ in range(reps + 1):
            _sync(DEVICE)
            t = time.perf_counter()
            _, rb, _ = SF._build_rulebook(
                ind, list(grid), [3, 3, 3], [1, 1, 1] if subm else
                [2, 2, 2], [1, 1, 1], [1, 1, 1], subm, batch)
            _sync(DEVICE)
            walls.append((time.perf_counter() - t) * 1e3)
        return rb, statistics.median(walls[1:])

    rb, subm_rb_ms = build(True)
    _, strided_rb_ms = build(False)
    neighbours = sum(int(p[0].numel()) for p in rb) / ind.shape[1]
    check(neighbours >= 4, f"domains (a): {neighbours:.2f} active sites "
          "per 3^3 window, want >= 4")

    def step(model, place, checks):
        with tdevice._place_scope(place):
            vals = paddle.to_tensor(feats)
            x = sp.sparse_coo_tensor(idx, vals, shape)
            _sync(place.type)
            t0 = time.perf_counter()
            out = _second_forward(model, x, sp, checks)
            _sync(place.type)
            t1 = time.perf_counter()
            out.values().sum().backward()
            _sync(place.type)
            t2 = time.perf_counter()
        grads = [p.grad._data.clone() for p in model.parameters()]
        model.clear_gradients()
        return out, grads, (t1 - t0) * 1e3, (t2 - t1) * 1e3

    # the backbone's own peak, above what earlier phases left allocated
    if card:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    out, grads, _, _ = step(net, dev, True)
    peak = torch.cuda.max_memory_allocated() - base if card else 0
    want, want_g, _, _ = step(net_cpu, cpu, False)
    check(torch.equal(out.indices()._data.cpu(), want.indices()._data),
          "domains (a): output sites differ from the CPU run's")
    out_rel = _rel(out.values()._data, want.values()._data)
    grad_rel = max(_rel(g, w) for g, w in zip(grads, want_g))
    check(out_rel <= DOMAINS_REL_TOL and grad_rel <= DOMAINS_REL_TOL,
          f"domains (a): card against CPU: output {out_rel:.2e}, weight "
          f"gradients {grad_rel:.2e} (tol {DOMAINS_REL_TOL})")
    check(not card or peak < 2 ** 30,
          f"domains (a): peak {peak / 2 ** 20:.1f} MiB, want < 1 GiB")
    runs = [step(net, dev, False)[2:] for _ in range(3)]
    res = dict(grid=list(grid), voxels=[n] * batch, out_shape=out.shape,
               out_sites=out.nnz(), neighbours=neighbours,
               rulebook_ms=dict(subm=subm_rb_ms, strided=strided_rb_ms),
               fwd_ms=statistics.median(r[0] for r in runs),
               bwd_ms=statistics.median(r[1] for r in runs),
               peak_mib=peak / 2 ** 20, out_rel=out_rel, grad_rel=grad_rel)
    print(f"  domains (a) SECOND backbone {list(grid)} x {batch} x {n}: "
          f"{neighbours:.2f} sites a 3^3 window, out {out.shape} "
          f"({out.nnz()} sites), rulebook subm {subm_rb_ms:.2f} ms / "
          f"strided {strided_rb_ms:.2f} ms, fwd {res['fwd_ms']:.2f} ms, "
          f"bwd {res['bwd_ms']:.2f} ms, peak {res['peak_mib']:.1f} MiB, "
          f"card vs CPU out {out_rel:.2e} grads {grad_rel:.2e}", flush=True)
    return res


def _bigbird_blocks(cfg, seed):
    """[heads, nb, nb] block mask: sliding window, global first and last
    blocks (rows and columns), and ``randoms`` random blocks a row."""
    rng = np.random.default_rng(seed)
    nb = cfg["seq"] // cfg["block"]
    m = np.zeros((cfg["heads"], nb, nb), bool)
    half = cfg["window"] // 2
    for i in range(nb):
        m[:, i, max(0, i - half):i + half + 1] = True
    g = [0, nb - 1][:cfg["globals"]]
    m[:, g, :] = True
    m[:, :, g] = True
    for h in range(cfg["heads"]):
        for i in range(1, nb - 1):
            free = np.flatnonzero(~m[h, i])
            m[h, i, rng.choice(free, min(cfg["randoms"], len(free)),
                               replace=False)] = True
    return m


class _OpOutputs(TorchDispatchMode):
    """Records the shape of every op's output while it is on."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in (out if isinstance(out, (list, tuple)) else (out,)):
            if isinstance(o, torch.Tensor):
                self.shapes.append(tuple(o.shape))
        return out


def _domains_bigbird(paddle, card, cfg):
    import paddle_tpu_torch.sparse as sp
    from paddle_tpu_torch.core.dispatch import apply_op
    from paddle_tpu_torch.sparse.nn import functional as SF

    dev = torch.device(DEVICE)
    H, D, S, blk = cfg["heads"], cfg["head_dim"], cfg["seq"], cfg["block"]
    bm = torch.as_tensor(_bigbird_blocks(cfg, seed=1), device=dev)
    hb = torch.nonzero(bm)                                   # [blocks, 3]
    d = torch.arange(blk, device=dev)
    rows = (hb[:, 1, None, None] * blk + d[:, None]).expand(-1, blk, blk)
    cols = (hb[:, 2, None, None] * blk + d[None, :]).expand(-1, blk, blk)
    heads = hb[:, 0, None, None].expand(-1, blk, blk)
    ind = torch.stack([heads.reshape(-1), rows.reshape(-1),
                       cols.reshape(-1)])
    nnz = ind.shape[1]
    del rows, cols, heads
    mask = sp.sparse_coo_tensor(ind, torch.ones(nnz, device=dev),
                                (H, S, S))
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v, do = (torch.randn(1, H, S, D, generator=g, device=dev)
                   for _ in range(4))
    ts = [paddle.to_tensor(a, stop_gradient=False) for a in (q, k, v)]

    def sparse():
        return SF.attention(*ts, mask)

    if card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    with _OpOutputs() as rec:
        out = sparse()
        out.backward(paddle.to_tensor(do))
    _sync(DEVICE)
    peak = torch.cuda.max_memory_allocated() - base if card else 0
    got = [out._data.detach()] + [t.grad._data.clone() for t in ts]
    for t in ts:
        t.clear_grad()
    biggest = max(math.prod(s) for s in rec.shapes)
    check(not any(list(s).count(S) >= 2 for s in rec.shapes),
          "domains (b): the sparse call made an S x S tensor")
    check(biggest <= nnz * D, f"domains (b): an op output of {biggest} "
          f"elements, above nnz * D = {nnz * D}")
    del out

    def timed(fn):
        _sync(DEVICE)
        t0 = time.perf_counter()
        o = fn()
        _sync(DEVICE)
        t1 = time.perf_counter()
        o.backward(paddle.to_tensor(do))
        _sync(DEVICE)
        for t in ts:
            t.clear_grad()
        return (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3

    sparse_ms = [timed(sparse) for _ in range(2)][-1]
    dense_mask = bm.repeat_interleave(blk, 1).repeat_interleave(blk, 2)

    def dense():
        def _d(q_, k_, v_):
            s = (q_[0] @ k_[0].transpose(-1, -2)) / math.sqrt(D)
            s = s.masked_fill(~dense_mask, float("-inf"))
            return (torch.softmax(s, -1) @ v_[0])[None]

        return apply_op(_d, *ts, _op_name="dense_attention")

    out_d = dense()
    out_d.backward(paddle.to_tensor(do))
    want = [out_d._data.detach()] + [t.grad._data.clone() for t in ts]
    for t in ts:
        t.clear_grad()
    del out_d
    dense_ms = timed(dense)
    out_rel = _rel(got[0], want[0])
    grad_rel = max(_rel(a, b) for a, b in zip(got[1:], want[1:]))
    check(out_rel <= DOMAINS_REL_TOL, f"domains (b): output {out_rel:.2e} "
          f"from dense masked attention (tol {DOMAINS_REL_TOL})")
    check(grad_rel <= DOMAINS_GRAD_TOL, f"domains (b): q, k, v gradients "
          f"{grad_rel:.2e} from dense (tol {DOMAINS_GRAD_TOL})")
    res = dict(seq=S, heads=H, nnz=nnz, density=nnz / (H * S * S),
               biggest_output=biggest, peak_gb=peak / 1e9,
               fwd_ms=sparse_ms[0], bwd_ms=sparse_ms[1],
               dense_fwd_ms=dense_ms[0], dense_bwd_ms=dense_ms[1],
               out_rel=out_rel, grad_rel=grad_rel)
    print(f"  domains (b) BigBird {H} x {S}: nnz {nnz} "
          f"({res['density']:.4f} of S^2), largest op output {biggest}, "
          f"sparse fwd {sparse_ms[0]:.2f} ms bwd {sparse_ms[1]:.2f} ms, "
          f"peak {res['peak_gb']:.2f} GB; dense fwd {dense_ms[0]:.2f} ms "
          f"bwd {dense_ms[1]:.2f} ms; out {out_rel:.2e}, grads "
          f"{grad_rel:.2e}", flush=True)
    del ts, q, k, v, do, dense_mask, mask, ind, got, want
    _free(card)
    return res


def _arxiv_graph(cfg, seed):
    """Seeded power-law edges over ``nodes`` (the last node isolated),
    symmetrised: (src, dst) without and (src, dst, norm) with self
    loops."""
    rng = np.random.default_rng(seed)
    n = cfg["nodes"]
    w = rng.permutation(n - 1)
    p = 1.0 / (w + 1.0) ** 0.8
    p /= p.sum()
    src = rng.choice(n - 1, cfg["edges"], p=p)
    dst = rng.choice(n - 1, cfg["edges"], p=p)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    s2, d2 = np.concatenate([src, dst]), np.concatenate([dst, src])
    loops = np.arange(n)
    gs, gd = np.concatenate([s2, loops]), np.concatenate([d2, loops])
    deg = np.bincount(gd, minlength=n).astype(np.float64)
    norm = (1.0 / np.sqrt(deg[gs] * deg[gd]))[:, None]
    return s2, d2, gs, gd, norm


class _ArxivNet:
    """GCN (sym-normalised ``send_ue_recv``), then GraphSAGE with
    ``send_u_recv`` mean, then GraphSAGE with max."""

    def __init__(self, paddle, cfg):
        f, h, c = cfg["features"], cfg["hidden"], cfg["classes"]
        nn = paddle.nn
        self.layers = nn.LayerList([
            nn.Linear(f, h), nn.Linear(h, h), nn.Linear(h, h),
            nn.Linear(h, c), nn.Linear(h, c)])

    def __call__(self, paddle, x, g):
        geo = paddle.geometric
        lin, s1, n1, s2, n2 = self.layers
        relu = paddle.nn.functional.relu
        h = relu(geo.send_ue_recv(lin(x), g["norm"], g["gs"], g["gd"], "mul",
                                  "sum"))
        h = relu(s1(h) + n1(geo.send_u_recv(h, g["src"], g["dst"], "mean")))
        agg = geo.send_u_recv(h, g["src"], g["dst"], "max")
        return s2(h) + n2(agg), agg


def _domains_gcn(paddle, card, cfg):
    dev = torch.device(DEVICE)
    s2, d2, gs, gd, norm = _arxiv_graph(cfg, seed=3)
    rng = np.random.default_rng(4)
    n = cfg["nodes"]
    x_np = rng.standard_normal((n, cfg["features"])).astype(np.float32)
    y_np = rng.integers(0, cfg["classes"], n)
    paddle.seed(5)
    net = _ArxivNet(paddle, cfg)
    init = {k: v.numpy().copy() for k, v in
            net.layers.state_dict().items()}

    def graph(dtype):
        return dict(src=paddle.to_tensor(s2), dst=paddle.to_tensor(d2),
                    gs=paddle.to_tensor(gs), gd=paddle.to_tensor(gd),
                    norm=paddle.to_tensor(norm, dtype=dtype))

    g32 = graph("float32")
    x = paddle.to_tensor(x_np)
    y = paddle.to_tensor(y_np)
    ce = paddle.nn.functional.cross_entropy
    opt = paddle.optimizer.Adam(learning_rate=1e-2,
                                parameters=net.layers.parameters())
    losses, ms, first = [], [], None
    for i in range(cfg["steps"]):
        _sync(DEVICE)
        t0 = time.perf_counter()
        logits, agg = net(paddle, x, g32)
        loss = ce(logits, y)
        loss.backward()
        if i == 0:
            first = [p.grad._data.clone() for p in net.layers.parameters()]
            lonely = agg._data[n - 1]
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
        _sync(DEVICE)
        ms.append((time.perf_counter() - t0) * 1e3)
    check(bool((lonely == 0).all()), "domains (c): the node with no in-edge "
          "does not read 0 under max")
    check(all(a != b for a, b in zip(losses, losses[1:])),
          f"domains (c): a loss did not move: {losses}")
    check(all(math.isfinite(v) for v in losses), f"domains (c): {losses}")
    # the same first step in float64 on the card
    net64 = _ArxivNet(paddle, cfg)
    net64.layers.astype("float64")
    layer_state = {k: v.astype(np.float64) for k, v in init.items()}
    from paddle_tpu_torch.convert import layer_state_from_numpy

    layer_state_from_numpy(layer_state, net64.layers)
    logits64, _ = net64(paddle, paddle.to_tensor(x_np, dtype="float64"),
                        graph("float64"))
    loss64 = ce(logits64, y)
    loss64.backward()
    loss_rel = abs(losses[0] - float(loss64)) / abs(float(loss64))
    want = [p.grad._data.double() for p in net64.layers.parameters()]
    grad_norm_rel = max(float((a.double() - w).norm() / w.norm())
                        for a, w in zip(first, want))
    grad_rel = max(_rel(a, w) for a, w in zip(first, want))
    check(loss_rel <= DOMAINS_REL_TOL and grad_norm_rel <= GCN_GRAD_TOL,
          f"domains (c): first step against float64: loss {loss_rel:.2e} "
          f"(tol {DOMAINS_REL_TOL}), gradients {grad_norm_rel:.2e} of a "
          f"leaf's norm (tol {GCN_GRAD_TOL})")
    res = dict(nodes=n, messages=len(gs), edges_sym=len(s2), losses=losses,
               step_ms=ms, loss_rel=loss_rel, grad_norm_rel=grad_norm_rel,
               grad_rel=grad_rel)
    print(f"  domains (c) arxiv GCN: {n} nodes, {len(gs)} messages, losses "
          f"{[round(v, 5) for v in losses]}, step ms "
          f"{[round(v, 2) for v in ms]}, first step vs float64 loss "
          f"{loss_rel:.2e} grads {grad_norm_rel:.2e} of a leaf's norm "
          f"({grad_rel:.2e} of its largest entry)", flush=True)
    del net, net64, opt, g32, x, y, first
    _free(card)
    return res


class _OpCount(TorchDispatchMode):
    """The ATen ops dispatched while it is on, by name (``n`` of them)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    @property
    def n(self):
        return len(self.ops)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


def _launch_count(fn):
    """(ops dispatched, CUDA kernels traced) for one call of ``fn``. The
    dispatch mode's count is exact in any process; the profiler's is a
    reading: on the card a window can lose the first kernels it launches,
    intermittently once the process has run a while (``PERF.md`` §6 PR
    26), so a window as short as one istft may trace none of them."""
    from torch.profiler import ProfilerActivity, profile

    with _OpCount() as ops:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return ops.n, sum(1 for ev in prof.events()
                      if ev.device_type == torch.autograd.DeviceType.CUDA
                      and not getattr(ev, "is_user_annotation", False))


def _domains_whisper(paddle, card, cfg):
    from paddle_tpu_torch import device as tdevice

    rng = np.random.default_rng(6)
    n, c = cfg["samples"], cfg["clips"]
    t = np.arange(n) / cfg["sr"]
    tones = rng.uniform(80, 4000, (c, 3))
    clips = (0.05 * rng.standard_normal((c, n))
             + sum(0.3 * np.sin(2 * np.pi * tones[:, i, None] * t)
                   for i in range(3))).astype(np.float32)
    feat = paddle.audio.features
    kw = dict(sr=cfg["sr"], n_fft=cfg["n_fft"], hop_length=cfg["hop"],
              n_mels=cfg["n_mels"], f_min=0.0, top_db=80.0)

    def layers():
        return (feat.LogMelSpectrogram(**kw),
                feat.MFCC(n_mfcc=cfg["n_mfcc"], **kw))

    logmel, mfcc = layers()
    x = paddle.to_tensor(clips)
    lm, mf = logmel(x), mfcc(x)
    frames = 1 + n // cfg["hop"]
    check(lm.shape == [c, cfg["n_mels"], frames],
          f"domains (d): log-mel {lm.shape}")
    with tdevice._place_scope(torch.device("cpu")):
        logmel_c, mfcc_c = layers()
        xc = paddle.to_tensor(clips)
        lm_c, mf_c = logmel_c(xc), mfcc_c(xc)
    lm_rel, mf_rel = _rel(lm._data, lm_c._data), _rel(mf._data, mf_c._data)
    check(lm_rel <= DOMAINS_REL_TOL and mf_rel <= DOMAINS_REL_TOL,
          f"domains (d): card against CPU: log-mel {lm_rel:.2e}, MFCC "
          f"{mf_rel:.2e} (tol {DOMAINS_REL_TOL})")
    win = paddle.audio.functional.get_window("hann", cfg["n_fft"])
    sig = paddle.signal

    def stft():
        return sig.stft(x, cfg["n_fft"], cfg["hop"], window=win)

    spec = stft()

    def istft():
        return sig.istft(spec, cfg["n_fft"], cfg["hop"], window=win,
                         length=n)

    back = istft()
    rt = _rel(back._data, x._data)
    check(rt <= ROUND_TRIP_TOL, f"domains (d): istft(stft(x)) {rt:.2e} of "
          f"the peak (tol {ROUND_TRIP_TOL})")
    ops, kernels = _launch_count(istft) if card else (0, 0)
    check(not card or 0 < ops < ISTFT_MAX_LAUNCHES,
          f"domains (d): istft dispatched {ops} ops")
    timer = time_ms if card else (lambda fn, **k: 0.0)
    res = dict(shape=lm.shape, logmel_rel=lm_rel, mfcc_rel=mf_rel,
               round_trip=rt, istft_ops=ops, istft_kernels=kernels,
               logmel_ms=timer(lambda: logmel(x), reps=5, inner=1),
               mfcc_ms=timer(lambda: mfcc(x), reps=5, inner=1),
               stft_ms=timer(stft, reps=5, inner=1),
               istft_ms=timer(istft, reps=5, inner=1))
    print(f"  domains (d) Whisper front end {c} x {n}: log-mel {lm.shape} "
          f"{res['logmel_ms']:.2f} ms, MFCC {res['mfcc_ms']:.2f} ms, stft "
          f"{res['stft_ms']:.2f} ms, istft {res['istft_ms']:.2f} ms "
          f"({ops} ops, {kernels} kernels traced); card vs CPU log-mel "
          f"{lm_rel:.2e} MFCC "
          f"{mf_rel:.2e}; round trip {rt:.2e}", flush=True)
    del x, spec, back, lm, mf
    _free(card)
    return res


def _on_both(fn):
    """``fn()`` on the current place and again on the CPU."""
    from paddle_tpu_torch import device as tdevice

    here = fn()
    with tdevice._place_scope(torch.device("cpu")):
        there = fn()
    return here, there


def _within_se(samples, mean, var, tag):
    """The largest distance, in standard errors, of a column mean of
    ``samples`` from ``mean`` (population variance ``var``)."""
    samples, mean, var = (torch.as_tensor(t).double().cpu()
                          for t in (samples, mean, var))
    n = samples.shape[0]
    z = ((samples.mean(0) - mean) / (var / n).sqrt()).abs().max()
    check(float(z) <= 5, f"domains (e): {tag} sample mean {float(z):.2f} "
          "standard errors off")
    return float(z)


def _domains_tail(paddle, card, cfg):
    from paddle_tpu_torch import device as tdevice

    D = paddle.distribution
    dev = torch.device(DEVICE)

    def P(t, **kw):
        """A host tensor as a Tensor on the current place."""
        return paddle.to_tensor(t.numpy(), **kw)

    gcpu = torch.Generator().manual_seed(7)
    closed = {}

    def closed_rel(tag, pair):
        got, want = pair
        got = got if isinstance(got, (list, tuple)) else [got]
        want = want if isinstance(want, (list, tuple)) else [want]
        r = max(_rel(a._data, b._data) for a, b in zip(got, want))
        closed[tag] = r
        check(r <= DOMAINS_CLOSED_TOL, f"domains (e): {tag} card against "
              f"CPU {r:.2e} (tol {DOMAINS_CLOSED_TOL})")

    # Categorical over LLaMA's vocabulary
    R, V, m = cfg["cat_rows"], cfg["vocab"], cfg["cat_draws"]
    logits = torch.randn(R, V, generator=gcpu) * 2.0
    cat = D.Categorical(P(logits))
    gen = torch.Generator(device=dev).manual_seed(8)
    _sync(DEVICE)
    t0 = time.perf_counter()
    draws = cat.sample([m], generator=gen)
    _sync(DEVICE)
    sample_ms = (time.perf_counter() - t0) * 1e3
    lp = cat.log_prob(draws)
    ent = cat.entropy()
    with tdevice._place_scope(torch.device("cpu")):
        cat_c = D.Categorical(P(logits))
        lp_c = cat_c.log_prob(P(draws._data.cpu()))
        ent_c = cat_c.entropy()
    closed_rel("categorical", ([lp, ent], [lp_c, ent_c]))
    p = torch.softmax(logits.double(), -1)
    lpd = torch.log_softmax(logits.double(), -1)
    var = ((p * lpd ** 2).sum(-1) - (p * lpd).sum(-1) ** 2).mean()
    z_cat = _within_se(lp._data.reshape(-1, 1), -ent_c._data.mean(),
                       var.expand(1), "categorical log-prob")
    # Normal and MultivariateNormal rsample, with gradients
    loc = P(torch.randn(4096, generator=gcpu), stop_gradient=False)
    scale = P(torch.rand(4096, generator=gcpu) + 0.5, stop_gradient=False)
    xs = D.Normal(loc, scale).rsample([8])
    xs.mean().backward()
    d = cfg["mvn_dim"]
    a = torch.randn(d, d, generator=gcpu) / math.sqrt(d)
    tril = torch.tril(a, -1) + torch.diag(torch.rand(d, generator=gcpu) + 0.5)
    mloc = P(torch.randn(d, generator=gcpu), stop_gradient=False)
    mtril = P(tril, stop_gradient=False)
    mvn = D.MultivariateNormal(mloc, scale_tril=mtril)
    mx = mvn.rsample([8192], generator=gen)
    mx.sum().backward()
    for tag, t in (("loc", loc), ("scale", scale), ("mvn loc", mloc),
                   ("mvn scale_tril", mtril)):
        check(t.grad is not None and float(t.grad.abs().sum()) > 0,
              f"domains (e): {tag} got no rsample gradient")
    cov = (tril @ tril.T).double()
    z_mvn = _within_se(mx._data.detach(), mloc._data.detach(),
                       torch.diagonal(cov), "mvn")
    # Dirichlet (an explicit CUDA generator) and Gamma (the default one)
    conc = torch.rand(32, generator=gcpu) * 2.5 + 0.5
    dx = D.Dirichlet(P(conc)).sample([8192], generator=gen)
    a0 = conc.sum()
    mean = (conc / a0).double()
    z_dir = _within_se(dx._data, mean, mean * (1 - mean) / (a0 + 1),
                       "dirichlet")
    gc_ = torch.rand(1024, generator=gcpu) * 3 + 0.2
    gr = torch.rand(1024, generator=gcpu) + 0.5
    gx = D.Gamma(P(gc_), P(gr)).sample([256])
    z_gam = _within_se(gx._data, gc_ / gr, gc_ / gr ** 2, "gamma")
    # the KL table, each registered pair at a batch of 1024
    u = [torch.rand(1024, generator=gcpu) + 0.2 for _ in range(8)]
    pairs = {
        "Normal": ((u[0] - 0.6, u[1]), (u[2] - 0.6, u[3])),
        "Uniform": ((u[0] - 2.0, u[1]), (u[0] - 2.5, u[1] + 0.5)),
        "Bernoulli": ((u[0] * 0.8,), (u[1] * 0.8,)),
        "Exponential": ((u[0],), (u[1],)),
        "Laplace": ((u[0], u[1]), (u[2], u[3])),
        "Beta": ((u[0] * 3, u[1] * 3), (u[2] * 3, u[3] * 3)),
        "Gamma": ((u[0] * 3, u[1]), (u[2] * 3, u[3])),
        "Dirichlet": ((torch.stack(u[:4], -1) * 3,),
                      (torch.stack(u[4:], -1) * 3,)),
        "Categorical": ((torch.stack(u[:4], -1),), (torch.stack(u[4:], -1),)),
    }
    for name, (pa, qa) in pairs.items():
        def kl(name=name, pa=pa, qa=qa):
            cls = getattr(D, name)
            return D.kl_divergence(cls(*[P(t) for t in pa]),
                                   cls(*[P(t) for t in qa]))

        closed_rel(f"kl {name}", _on_both(kl))
    check({(a.__name__, b.__name__) for a, b in D._KL_REGISTRY}
          == {(k, k) for k in pairs}, "domains (e): the KL table changed")
    # Viterbi over CoNLL-2003's tags
    B, T, N = cfg["viterbi"]
    pot = torch.randn(B, T, N, generator=gcpu)
    trans = torch.randn(N, N, generator=gcpu)
    lens = torch.randint(1, T + 1, (B,), generator=gcpu)
    lens[:4] = T

    def vit():
        return paddle.text.viterbi_decode(P(pot), P(trans), P(lens))

    (vs, vp), (vs_c, vp_c) = _on_both(vit)
    _sync(DEVICE)
    t0 = time.perf_counter()
    vit()
    _sync(DEVICE)
    viterbi_ms = (time.perf_counter() - t0) * 1e3
    check(torch.equal(vp._data.cpu(), vp_c._data),
          "domains (e): Viterbi paths differ from the CPU run's")
    closed_rel("viterbi scores", (vs, vs_c))
    # low-rank factorisations of a rank-r matrix plus noise
    M, K = cfg["lowrank"]
    r = cfg["rank"]
    s = torch.logspace(1, -1, r)
    base = (torch.linalg.qr(torch.randn(M, r, generator=gcpu))[0] * s
            ) @ torch.linalg.qr(torch.randn(K, r, generator=gcpu))[0].T
    mat = base + 1e-4 * torch.randn(M, K, generator=gcpu)

    def lowrank():
        A = P(mat)
        out = []
        for fn, centred in ((paddle.linalg.svd_lowrank, False),
                            (paddle.linalg.pca_lowrank, True)):
            u_, s_, v_ = fn(A, q=r)
            ref = A._data - A._data.mean(0) if centred else A._data
            rec = (u_._data * s_._data) @ v_._data.T
            out.append(float((rec - ref).norm() / ref.norm()))
        return out

    err, err_c = _on_both(lowrank)
    for e, ec, tag in zip(err, err_c, ("svd_lowrank", "pca_lowrank")):
        check(e <= ec + 1e-4, f"domains (e): {tag} reconstructs to {e:.2e}, "
              f"the CPU run to {ec:.2e}")
    res = dict(closed=closed, se=dict(categorical=z_cat, mvn=z_mvn,
                                      dirichlet=z_dir, gamma=z_gam),
               categorical_sample_ms=sample_ms, viterbi_ms=viterbi_ms,
               lowrank_err=err, lowrank_err_cpu=err_c)
    print(f"  domains (e) Categorical [{R}, {V}] x {m} draws "
          f"{sample_ms:.2f} ms; sample means in SE: "
          f"{ {k: round(v, 2) for k, v in res['se'].items()} }; closed "
          f"forms card vs CPU max {max(closed.values()):.2e}; Viterbi "
          f"{list(cfg['viterbi'])} {viterbi_ms:.1f} ms, paths "
          f"equal; low-rank err {[f'{e:.2e}' for e in err]} (CPU "
          f"{[f'{e:.2e}' for e in err_c]})", flush=True)
    _free(card)
    return res


def phase_domains(smi="", second=None, bigbird=None, arxiv=None,
                  whisper=None, tail=None):
    """The domain libraries on the card, f32, each part against the CPU
    run of the same port code (or float64, or the dense attention):
    (a) SECOND's backbone (sparse convs) at KITTI's grid, forward and
    backward; (b) BigBird's pattern through the O(nnz) sparse attention
    against dense masked attention; (c) a GCN at ogbn-arxiv's size, 3
    Adam steps; (d) Whisper's front end (log-mel, MFCC, stft, istft);
    (e) distributions, the KL table, Viterbi and the low-rank tail. The
    keyword arguments override the configurations (``DEVICE = "cpu"``
    rehearses the phase small: no launch or memory checks)."""
    import paddle_tpu_torch as paddle

    card = DEVICE != "cpu"
    paddle.set_device("gpu" if card else "cpu")
    sec = dict(dict(grid=SECOND_GRID, n=SECOND_VOXELS, batch=SECOND_BATCH,
                    boxes=SECOND_BOXES), **(second or {}))
    res = {"smi": smi}
    t = time.perf_counter()
    res["a"] = _domains_second(paddle, card, sec["grid"], sec["n"],
                               sec["batch"], sec["boxes"])
    res["b"] = _domains_bigbird(paddle, card, dict(BIGBIRD, **(bigbird or {})))
    res["c"] = _domains_gcn(paddle, card, dict(ARXIV, **(arxiv or {})))
    res["d"] = _domains_whisper(paddle, card, dict(WHISPER, **(whisper or {})))
    res["e"] = _domains_tail(paddle, card, dict(DOMAINS_TAIL, **(tail or {})))
    res["seconds"] = time.perf_counter() - t
    print(f"  domains: {res['seconds']:.1f} s on {smi}", flush=True)
    return res


# -------------------------------------------------------- phase compression
QAT_QMAX = 127.0


#: (a): QAT steps timed after one warm-up, on one seeded batch
COMPRESSION_STEPS = 3
#: (d): LLaMA-7B's up projection [hidden, FFN] and the rows of a decode
#: batch and of a prefill chunk
LLAMA_PROJ = dict(k=4096, n=11008, rows=(8, 2048))
#: (d): the relative error of weight_only_linear and llm_int8_linear
#: against x @ w in f32, the bound of the reference's own test
#: (tests/test_r5_surface.py:28)
NN_QUANT_RTOL = 0.03
#: (d): scales card against CPU, relative
NN_QUANT_SCALE_RTOL = 1e-7
#: (d): weight_only_linear against its plain route (dequantize, then one
#: f32 GEMM): one bf16 rounding step of the output, 2^-7 of its largest
WOL_PLAIN_RTOL = 2.0 ** -7
#: (d): LLM.int8's outlier input channels (spread over k) and their factor
LLM_INT8_OUTLIERS = (4, 40.0)


def _retain_site_inputs(model, quanted):
    """Give every ``QuantedLinear`` of ``model`` an input of its own (a
    copy, so each site's ``dL/dx`` is its own even where q, k and v read
    one tensor) whose gradient is kept: returns the list of those torch
    tensors, filled as the model runs."""
    got = []
    for sub in model.sublayers():
        if isinstance(sub, quanted):
            fwd = sub.forward

            def forward(x, fwd=fwd):
                xc = x.clone()
                xc._data.retain_grad()
                got.append(xc._data)
                return fwd(xc)

            sub.forward = forward
    return got


def _compression_qat(paddle, card, cfg, cfg_kw, feed, counted, want_only):
    """(a): QAT on BERT-base against the same model's unquantized eager
    step; the card against the CPU at depth 2 (:func:`_qat_card_vs_cpu`)."""
    from paddle_tpu_torch.models import BertForPretraining, bert_base
    from paddle_tpu_torch.quantization import QAT, QuantConfig, QuantedLinear

    dev = DEVICE if card else "cpu"
    L, V = cfg.num_layers, cfg.vocab_size
    ids, types, labels, nsp = (paddle.to_tensor(feed[k]) for k in
                               ("ids", "types", "labels", "nsp"))
    paddle.seed(0)
    model = BertForPretraining(cfg)
    qmodel = QAT(QuantConfig()).quantize(model)     # a deep copy
    quanted = [m for m in qmodel.sublayers() if isinstance(m, QuantedLinear)]
    check(len(quanted) == 6 * L + 3,
          f"compression (a): {len(quanted)} QuantedLinears, want {6 * L + 3}")
    inner = {id(m.inner.weight) for m in quanted}
    params = qmodel.parameters()
    check(len(params) == len(model.parameters())
          and inner <= {id(p) for p in params}
          and len(qmodel.state_dict()) == len(model.state_dict()),
          "compression (a): parameters()/state_dict() miss inner Linears")
    before = [m.inner.weight._data.detach().clone() for m in quanted]

    def train(m, tag):
        opt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                     parameters=m.parameters())
        losses, ms = [], []
        for i in range(1 + COMPRESSION_STEPS):
            def step():
                loss = m.loss(ids, labels, nsp, token_type_ids=types)
                loss.backward()
                opt.step()
                opt.clear_grad()
                return float(loss)

            _sync(dev)
            t0 = time.perf_counter()
            lv, counts = counted(step)
            ms.append((time.perf_counter() - t0) * 1e3)
            want_only(counts, {"flash_attention_fwd": L,
                               "flash_attention_bwd": L}, f"(a) {tag} {i}")
            losses.append(lv)
        return losses, ms, opt

    fp_losses, fp_ms, _ = train(model, "fp")
    q_losses, q_ms, qopt = train(qmodel, "QAT")
    stepped = {id(t) for g in qopt.param_groups for t in g["params"]}
    moved = [not torch.equal(m.inner.weight._data, b)
             for m, b in zip(quanted, before)]
    check(all(moved) and len(stepped) == len(params)
          and all(id(m.inner.weight._data) in stepped for m in quanted),
          f"compression (a): the optimizer moved {sum(moved)} of "
          f"{len(quanted)} inner weights")
    del before
    check(all(np.isfinite(q_losses)), f"compression (a): losses {q_losses}")
    check(q_losses[3] < q_losses[1], "compression (a): the third timed "
          f"QAT loss {q_losses[3]} not below the first {q_losses[1]}")
    res = {"quanted_linears": len(quanted), "qat_losses": q_losses,
           "fp_losses": fp_losses, "qat_ms": q_ms, "fp_ms": fp_ms,
           "qat_ms_median": statistics.median(q_ms[1:]),
           "fp_ms_median": statistics.median(fp_ms[1:])}
    print(f"compression (a): QAT BERT-base [{feed['ids'].shape[0]}, "
          f"{feed['ids'].shape[1]}] f32, {len(quanted)} QuantedLinears; "
          f"losses {[round(x, 4) for x in q_losses]} (unquantized "
          f"{[round(x, 4) for x in fp_losses]}); step median "
          f"{res['qat_ms_median']:.1f} ms against the unquantized eager "
          f"step's {res['fp_ms_median']:.1f} ms", flush=True)
    del qmodel, qopt, quanted
    _free(card)

    res["card_vs_cpu"] = _qat_card_vs_cpu(paddle, card, cfg_kw, V)
    return res, model


class _RecordedQuanter:
    """The port's ``FakeQuanterWithAbsMax`` with each call's codes read off
    its output (``q = round(out · qmax / s)``, ``s`` the input's abs max)
    and kept on the host beside ``s``. Given another run's codes
    (``replay``), it counts how many of its own codes lie off them and by
    how many levels at most, and passes the other run's dequantized values
    on in place of its own (straight through), so the sites after it see
    that run's inputs."""

    def __init__(self, replay=None):
        from paddle_tpu_torch.quantization import FakeQuanterWithAbsMax

        self.quanter = FakeQuanterWithAbsMax()
        self.replay = replay
        self.codes = []
        self.moved = 0
        self.most = 0.0

    def __call__(self, x):
        from paddle_tpu_torch.core.dispatch import apply_op

        out = self.quanter(x)
        s = torch.clamp_min(x._data.detach().abs().max(), 1e-8)
        q = torch.round(out._data.detach() * QAT_QMAX / s)
        self.codes.append((q.cpu(), s.cpu()))
        if self.replay is None:
            return out
        qc, sc = self.replay[len(self.codes) - 1]
        d = (self.codes[-1][0] - qc).abs()
        self.moved += int((d > 0).sum())
        self.most = max(self.most, float(d.max()))
        sd = sc.to(s.device)
        deq = qc.to(s.device) * sd / sd.new_full((), QAT_QMAX)
        return apply_op(lambda a, dq: a + (dq - a).detach(), x, deq,
                        _op_name="fake_quant")


def _code_levels(codes, other):
    """(elements whose codes differ, the most levels between them) over
    all sites of two runs."""
    moved = most = 0
    for (q, _), (q2, _) in zip(codes, other):
        d = (q - q2).abs()
        moved += int((d > 0).sum())
        most = max(most, float(d.max()))
    return moved, most


def _unexplained_codes(codes, other, sites, other_sites, qmax=QAT_QMAX):
    """The codes of one run that differ from another's where no rounding
    boundary (a half level) lies between the two runs' scaled inputs
    ``x / s · qmax``, give or take 1e-4 of a level (the f32 rounding of
    the quantizer's own division and product): what a quantizer that
    rounds otherwise than the other gives. ``sites`` and ``other_sites``:
    per site ``(x, dL/dx)`` of each run."""
    bad = 0
    for (q, s), (q2, s2), (x, _), (x2, _) in zip(codes, other, sites,
                                                 other_sites):
        moved = (q != q2).numpy()
        if not moved.any():
            continue
        v = np.asarray(x, np.float64)[moved] / float(s) * qmax
        v2 = np.asarray(x2, np.float64)[moved] / float(s2) * qmax
        lo = np.minimum(v, v2) - 1e-4
        hi = np.maximum(v, v2) + 1e-4
        bad += int((np.floor(hi - 0.5) < np.ceil(lo - 0.5)).sum())
    return bad


def _qat_card_vs_cpu(paddle, card, cfg_kw, V):
    """(a)'s card against the CPU: BERT at depth 2, f32, dropout 0, one
    QAT forward and backward of SURFACE_CPU_SHAPE on the same weights,
    every site the port's quanter recording its codes
    (:class:`_RecordedQuanter`). With every site quantized to the CPU's
    codes and scales, so each site sees the CPU's inputs up to f32
    rounding: the card's own codes within one level of the CPU's, each
    that moved at a rounding boundary between the two inputs
    (:func:`_unexplained_codes`), the weights' codes equal, the loss and
    gradients within phase 7's f32 bounds. With the card's own codes (a
    moved code moves the later sites' inputs, where more codes move, by
    more than a level): the weights' codes equal; the codes moved, the
    loss and the gradients are readings."""
    from paddle_tpu_torch.models import BertForPretraining, bert_base
    from paddle_tpu_torch.quantization import QAT, QuantConfig, QuantedLinear

    small = bert_base(**dict(cfg_kw or {}, num_layers=2, dropout=0.0))
    sb, ss = SURFACE_CPU_SHAPE
    cpu_act, cpu_w = _RecordedQuanter(), _RecordedQuanter()
    runs = {"cpu": ("cpu", cpu_act, cpu_w),
            "card": ("gpu" if card else "cpu", _RecordedQuanter(),
                     _RecordedQuanter()),
            "pinned": ("gpu" if card else "cpu",
                       _RecordedQuanter(cpu_act.codes),
                       _RecordedQuanter(cpu_w.codes))}
    state, got = None, {}
    for tag, (where, act, wq) in runs.items():
        paddle.set_device(where)
        paddle.seed(1)
        m = BertForPretraining(small)
        if state is None:
            state = m.state_dict()
        else:
            m.set_state_dict(state)
        qm = QAT(QuantConfig(activation=act, weight=wq)).quantize(
            m, inplace=True)
        sites = _retain_site_inputs(qm, QuantedLinear)
        loss = qm.loss(*_bert_batch(paddle, V, sb, ss, 3))
        loss.backward()
        got[tag] = (float(loss), {n: p.grad.numpy() for n, p in
                                  qm.named_parameters()
                                  if p.grad is not None},
                    [(x.detach().cpu().numpy(), x.grad.cpu().numpy())
                     for x in sites])
        del m, qm, sites, loss
    paddle.set_device("gpu" if card else "cpu")
    g_cpu = got["cpu"][1]
    top = max(np.linalg.norm(g) for g in g_cpu.values())

    def grad_rel(tag):
        g_dev = got[tag][1]
        check(set(g_cpu) == set(g_dev), f"compression (a): {tag} leaves")
        rel = {n: float(np.linalg.norm(g_dev[n] - g)
                        / max(np.linalg.norm(g), 1e-4 * top))
               for n, g in g_cpu.items()}
        worst = max(rel, key=rel.get)
        return worst, rel[worst]

    l_cpu = got["cpu"][0]
    own_act, own_w = runs["card"][1], runs["card"][2]
    moved, most = _code_levels(own_act.codes, cpu_act.codes)
    w_moved, _ = _code_levels(own_w.codes, cpu_w.codes)
    check(w_moved == 0, f"compression (a): weights' codes moved {w_moved}")
    own_diff = abs(got["card"][0] - l_cpu)
    own_worst, own_rel = grad_rel("card")
    act, wq = runs["pinned"][1], runs["pinned"][2]
    unexplained = _unexplained_codes(act.codes, cpu_act.codes,
                                     got["pinned"][2], got["cpu"][2])
    check(act.most <= 1 and wq.moved == 0 and unexplained == 0,
          f"compression (a): pinned, the card's codes lie up to "
          f"{act.most} levels from the CPU's ({act.moved} moved, "
          f"{unexplained} with no rounding boundary between the two "
          f"inputs); weights' codes moved {wq.moved}")
    pin_rel_loss = abs(got["pinned"][0] - l_cpu) / abs(l_cpu)
    pin_worst, pin_rel = grad_rel("pinned")
    check(pin_rel_loss <= TRAIN_LOSS_RTOL and pin_rel <= TRAIN_GRAD_RTOL,
          f"compression (a): with the CPU's codes, loss rel {pin_rel_loss}, "
          f"gradient {pin_worst} rel {pin_rel}")
    n_codes = sum(q.numel() for q, _ in cpu_act.codes)
    out = {"losses": [l_cpu, got["card"][0], got["pinned"][0]],
           "loss_diff": own_diff, "grad_rel_max": own_rel,
           "grad_rel_worst": own_worst, "sites": len(cpu_act.codes),
           "codes": n_codes, "codes_moved": moved, "most_levels": most,
           "pinned_codes_moved": act.moved, "pinned_loss_rel": pin_rel_loss,
           "pinned_grad_rel_max": pin_rel, "pinned_grad_rel_worst": pin_worst}
    print(f"compression (a): depth 2 QAT card vs CPU, {len(cpu_act.codes)} "
          f"sites, {n_codes} activation codes: with the CPU's codes "
          f"pinned, {act.moved} of the card's own one level off, each at a "
          f"rounding boundary between the two inputs, weights' equal; loss "
          f"rel {pin_rel_loss:.2e}, grads max rel {pin_rel:.2e} "
          f"({pin_worst}; bounds {TRAIN_LOSS_RTOL}, {TRAIN_GRAD_RTOL}); "
          f"with the card's own codes (readings): {moved} moved, up to "
          f"{most:.0f} levels, loss diff {own_diff:.3e} (rel "
          f"{own_diff / abs(l_cpu):.2e}), grads max rel {own_rel:.2e} "
          f"({own_worst})", flush=True)
    return out


def _compression_ptq(paddle, card, model, V, b, s, counted, want_only):
    """(b): PTQ of (a)'s unquantized model in eval: 2 observed batches,
    ``convert``; each layer's scale against its inputs' largest |x|."""
    from paddle_tpu_torch.quantization import PTQ, QuantConfig, QuantedLinear

    L = len(model.bert.layers)
    ptq = PTQ(QuantConfig())
    pm = ptq.quantize(model)
    seen = {}
    for sub in pm.sublayers():
        if isinstance(sub, QuantedLinear):
            seen[id(sub)] = []
            fwd = sub.forward

            def forward(x, fwd=fwd, acc=seen[id(sub)]):
                acc.append(x._data.detach().abs().max())
                return fwd(x)

            sub.forward = forward
    model.eval()
    pm.eval()
    with paddle.no_grad():
        for i in range(2):
            f = _bert_arrays(V, b, s, 21 + i)
            _, counts = counted(lambda: pm(paddle.to_tensor(f["ids"]),
                                           paddle.to_tensor(f["types"])))
            want_only(counts, {"flash_attention_fwd": L}, f"(b) observe {i}")
    ptq.convert(pm)
    layers = [m for m in pm.sublayers() if isinstance(m, QuantedLinear)]
    exact = [m.static_scales == float(torch.stack(seen[id(m)]).max())
             for m in layers]
    check(len(layers) == 6 * L + 3 and all(exact),
          f"compression (b): {sum(exact)} of {len(layers)} static scales "
          "equal their inputs' largest |x|")
    f = _bert_arrays(V, b, s, 23)
    with paddle.no_grad():
        ids, types = paddle.to_tensor(f["ids"]), paddle.to_tensor(f["types"])
        fp_mlm, fp_nsp = model(ids, types)
        (q_mlm, q_nsp), counts = counted(lambda: pm(ids, types))
        want_only(counts, {"flash_attention_fwd": L}, "(b) converted")
        a, w = q_mlm._data, fp_mlm._data
        rel = float((a - w).abs().max() / w.abs().max())
        top1 = float((a.argmax(-1) == w.argmax(-1)).float().mean())
        nsp_rel = float((q_nsp._data - fp_nsp._data).abs().max()
                        / fp_nsp._data.abs().max())
    model.train()
    res = {"layers": len(layers), "scales_exact": all(exact),
           "scale_range": [min(m.static_scales for m in layers),
                           max(m.static_scales for m in layers)],
           "mlm_rel": rel, "mlm_top1_agreement": top1, "nsp_rel": nsp_rel}
    print(f"compression (b): PTQ {len(layers)} static scales equal the "
          f"observed largest |x| (range {res['scale_range'][0]:.3f}-"
          f"{res['scale_range'][1]:.3f}); converted MLM logits rel "
          f"{rel:.3e}, top-1 agreement {top1:.4f}, NSP rel {nsp_rel:.3e}",
          flush=True)
    del pm, fp_mlm, q_mlm, a, w
    _free(card)
    return res


def _compression_asp(paddle, card, model, feed, counted, want_only):
    """(c): 2:4 pruning of BERT-base: the card's masks against the CPU's
    for every algorithm and each of the 75 weights, each pruning algorithm
    timed over them, ``nsp`` excluded, and 3 AdamW steps under
    ``decorate``."""
    import copy

    from paddle_tpu_torch.incubate import asp

    dev = DEVICE if card else "cpu"
    L = len(model.bert.layers)
    ids, types, labels, nsp = (paddle.to_tensor(feed[k]) for k in
                               ("ids", "types", "labels", "nsp"))
    weights = [sub.weight._data.detach() for sub in model.sublayers()
               if isinstance(sub, paddle.nn.Linear)]
    check(len(weights) == 6 * L + 3, f"compression (c): {len(weights)} "
          "Linear weights")
    same = {}
    for algo, fn in asp._MASK_ALGOS.items():
        same[algo] = sum(bool(torch.equal(fn(w).cpu(), fn(w.cpu())))
                         for w in weights)
    check(all(n == len(weights) for n in same.values()),
          f"compression (c): card masks equal the CPU's for {same} of "
          f"{len(weights)} weights")
    del weights
    asp.reset_excluded_layers()
    times = {}
    for algo in ("mask_1d", "mask_2d_best"):
        m = copy.deepcopy(model)
        _sync(dev)
        t0 = time.perf_counter()
        masks = asp.prune_model(m, mask_algo=algo)
        _sync(dev)
        times[algo] = (time.perf_counter() - t0) * 1e3
        check(len(masks) == 6 * L + 3, f"compression (c): {algo} pruned "
              f"{len(masks)} weights")
        if algo == "mask_2d_best":
            # 768 x 2: 4 does not divide 2, so the 1-D mask, as the reference
            check(np.array_equal(masks["nsp"], asp.get_mask_1d(
                model.nsp.weight.numpy())), "compression (c): nsp mask")
        del m, masks
        _free(card)
    asp.set_excluded_layers(model, ["nsp"])
    masks = asp.prune_model(model, mask_algo="mask_2d_best")
    asp.reset_excluded_layers()
    dens = {n: asp.calculate_density(sub.weight) for n, sub in
            model.named_sublayers() if n in masks}
    check(len(masks) == 6 * L + 2 and set(dens.values()) == {0.5}
          and asp.calculate_density(model.nsp.weight) == 1.0
          and getattr(model.nsp.weight, "_asp_mask", None) is None,
          f"compression (c): {len(masks)} pruned, densities "
          f"{sorted(set(dens.values()))}, nsp "
          f"{asp.calculate_density(model.nsp.weight)}")
    opt = asp.decorate(paddle.optimizer.AdamW(learning_rate=1e-4,
                                              parameters=model.parameters()))
    check(asp.decorate(opt) is opt, "compression (c): decorate twice")
    losses, held = [], 0
    for i in range(3):
        def step():
            loss = model.loss(ids, labels, nsp, token_type_ids=types)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return float(loss)

        lv, counts = counted(step)
        want_only(counts, {"flash_attention_fwd": L,
                           "flash_attention_bwd": L}, f"(c) step {i}")
        losses.append(lv)
        held = 0
        for t in (t for g in opt.param_groups for t in g["params"]):
            p = opt._paddle_params[id(t)]
            if getattr(p, "_asp_mask", None) is None:
                continue
            check(p._data is t and asp.check_sparsity(
                t, func_name="check_mask_2d"),
                f"compression (c): step {i}: {p.name} lost its 2:4 mask")
            held += 1
    check(held == 6 * L + 2 and all(np.isfinite(losses)),
          f"compression (c): {held} masked weights held, losses {losses}")
    res = {"prune_ms": times, "pruned": len(masks), "masks_equal": same,
           "losses": losses}
    print(f"compression (c): ASP prune_model over {6 * L + 3} weights: "
          f"mask_1d {times['mask_1d']:.1f} ms, mask_2d_best "
          f"{times['mask_2d_best']:.1f} ms; card masks = CPU's for each "
          f"algorithm on all {6 * L + 3} weights; "
          f"{len(masks)} pruned to density 0.5, nsp dense; 3 decorated "
          f"AdamW steps, 2:4 held on the optimizer's tensors; losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    return res


def _compression_nn_quant(paddle, card, shape):
    """(d): ``nn.quant`` at LLaMA-7B's up projection, bf16."""
    from paddle_tpu_torch.nn import quant as nq
    from paddle_tpu_torch.quant.gemm import _int_mm

    dev = DEVICE if card else "cpu"
    k, n = shape["k"], shape["n"]
    gen = torch.Generator(device=dev).manual_seed(13)
    w = (0.02 * torch.randn(k, n, generator=gen, device=dev)).to(
        torch.bfloat16)
    wt, wc = paddle.to_tensor(w), w.cpu()
    codes = {}
    for algo in ("weight_only_int8", "weight_only_int4", "llm.int8"):
        for gs in (-1, 64, 128):
            q, s = nq.weight_quantize(wt, algo=algo, group_size=gs)
            qc, sc = nq.weight_quantize_arrays(wc, algo, gs)
            srel = float(((s._data.cpu() - sc).abs() / sc).max())
            same = torch.equal(q._data.cpu(), qc)
            check(same and srel <= NN_QUANT_SCALE_RTOL,
                  f"compression (d): {algo} group {gs}: codes equal {same}, "
                  f"scales rel {srel}")
            codes[f"{algo},{gs}"] = (q, s)
    wbytes = {key: q._data.nbytes + s._data.nbytes
              for key, (q, s) in codes.items()}
    check(codes["weight_only_int4,-1"][0]._data.nbytes
          == codes["weight_only_int8,-1"][0]._data.nbytes == k * n,
          "compression (d): int4 codes hold as many bytes as int8's")
    q8, s8 = codes["weight_only_int8,-1"]
    q4, s4 = codes["weight_only_int4,128"]
    ql, sl = codes["llm.int8,-1"]
    wf = w.float()
    rows = {}
    for m in shape["rows"]:
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        xt = paddle.to_tensor(x)
        ref = x.float() @ wf
        scale = ref.abs().max()
        y = nq.weight_only_linear(xt, q8, weight_scale=s8)._data
        plain = (x.float() @ nq.weight_dequantize(
            q8, s8, out_dtype="float32")._data).to(torch.bfloat16)
        wol_plain = float((y.float() - plain.float()).abs().max() / scale)
        wol_ref = float((y.float() - ref).abs().max() / scale)
        check(wol_plain <= WOL_PLAIN_RTOL and wol_ref < NN_QUANT_RTOL,
              f"compression (d): weight_only_linear [{m}, {k}]: rel "
              f"{wol_plain} against its plain route, {wol_ref} against "
              "x @ w")
        count, factor = LLM_INT8_OUTLIERS
        chans = [7 + i * (k // count) for i in range(count)]
        xo = x.clone()
        xo[:, chans] *= factor
        xot = paddle.to_tensor(xo)
        with _OpCount() as ops:
            yl = nq.llm_int8_linear(xot, ql, weight_scale=sl)._data
        a_q, a_s, q_in, outlier, _ = nq.llm_int8_parts(xo, ql._data,
                                                       sl._data, 6.0)
        acc = _int_mm(a_q, q_in)
        exact = torch.equal(acc.double(),
                            a_q.double() @ q_in.double().t())
        refo = xo.float() @ wf
        l_ref = float((yl.float() - refo).abs().max() / refo.abs().max())
        check((not card or "aten._int_mm" in ops.ops) and exact
              and int(outlier.sum()) == len(chans) and l_ref < NN_QUANT_RTOL,
              f"compression (d): llm_int8_linear [{m}, {k}]: _int_mm "
              f"{'aten._int_mm' in ops.ops}, int32 sums exact {exact}, "
              f"outliers {int(outlier.sum())}, rel {l_ref}")
        # on the CPU each timed call runs once, untimed
        timer = time_ms if card else (lambda fn, **kw: (fn(), 0.0)[1])
        rows[m] = {"wol_rel_plain": wol_plain, "wol_rel_ref": wol_ref,
                   "llm_int8_rel_ref": l_ref, "int32_exact": exact,
                   "wol_ms": timer(lambda: nq.weight_only_linear(
                       xt, q8, weight_scale=s8), reps=5, inner=2),
                   "wol_int4_g128_ms": timer(lambda: nq.weight_only_linear(
                       xt, q4, weight_scale=s4, weight_dtype="int4",
                       group_size=128), reps=5, inner=2),
                   "llm_int8_ms": timer(lambda: nq.llm_int8_linear(
                       xot, ql, weight_scale=sl), reps=5, inner=2),
                   "int_mm_ms": timer(lambda: _int_mm(a_q, q_in), reps=5,
                                      inner=2),
                   "bf16_matmul_ms": timer(lambda: torch.matmul(x, w),
                                           reps=5, inner=2)}
        print(f"compression (d): [{m}, {k}] x [{k}, {n}] bf16: "
              f"weight_only_linear {rows[m]['wol_ms']:.3f} ms (int4 g128 "
              f"{rows[m]['wol_int4_g128_ms']:.3f}), llm_int8_linear "
              f"{rows[m]['llm_int8_ms']:.3f} ms (its _int_mm "
              f"{rows[m]['int_mm_ms']:.3f}), torch.matmul bf16 "
              f"{rows[m]['bf16_matmul_ms']:.3f} ms; rel against x @ w "
              f"{wol_ref:.2e} and {l_ref:.2e}, against the plain route "
              f"{wol_plain:.2e}; int32 sums exact", flush=True)
    res = {"codes_equal_cpu": sorted(codes), "weight_bytes": wbytes,
           "bf16_bytes": w.nbytes, "rows": rows}
    print(f"compression (d): weight_quantize codes = CPU's for "
          f"{len(codes)} (algo, group) pairs; bytes: bf16 {w.nbytes}, "
          f"int8 {wbytes['weight_only_int8,-1']}, int4 (as int8) "
          f"{wbytes['weight_only_int4,-1']}, int4 g128 "
          f"{wbytes['weight_only_int4,128']}", flush=True)
    del codes, w, wt, wc, wf
    _free(card)
    return res


def _compression_names(paddle, card):
    """(e): the device queries, C.3's int ``axes`` and C.4's GPU window on
    the card."""
    from paddle_tpu_torch import device as tdevice
    from paddle_tpu_torch import profiler as pprof
    from paddle_tpu_torch.profiler import device_trace

    res = {"cudnn": paddle.device.get_cudnn_version(),
           "distribute": paddle.device.is_compiled_with_distribute()}
    check(res["cudnn"] == torch.backends.cudnn.version(),
          f"compression (e): get_cudnn_version {res['cudnn']}")
    a = np.arange(24, dtype=np.float32).reshape(4, 6)
    got = paddle.fft.fftshift(paddle.to_tensor(a), axes=1).numpy()
    with tdevice._place_scope(torch.device("cpu")):
        want = paddle.fft.fftshift(paddle.to_tensor(a), axes=1).numpy()
    check(np.array_equal(got, want) and np.array_equal(
        want, np.fft.fftshift(a, axes=1)), "compression (e): fftshift")
    if not card:
        return res
    x = torch.randn(32, 480000, device=DEVICE)
    win = torch.hann_window(400, device=DEVICE)
    spec = torch.stft(x, 400, 160, window=win, return_complex=True)

    def istft():
        return torch.istft(spec, 400, 160, window=win, length=480000)

    istft()
    gpu = [pprof.ProfilerTarget.CPU, pprof.ProfilerTarget.GPU]
    p = pprof.Profiler(targets=gpu)
    with p:
        istft()
        torch.cuda.synchronize()
    try:
        rows = p.device_rows()
        dev_names = {e[0] for e in p._device_events if e[1] == "device"}
        check(rows and {r["name"] for r in rows} <= dev_names,
              "compression (e): a GPU window's table holds host ops")
        calls = sum(r["calls"] for r in rows)
        outcome = f"{len(rows)} device rows, {calls} kernels"
    except device_trace.NoDeviceEvents as e:
        outcome = f"raised NoDeviceEvents ({e})"
    res["gpu_window"] = outcome
    print(f"compression (e): cuDNN {res['cudnn']}, distribute "
          f"{res['distribute']}; fftshift(axes=1) card = CPU; a GPU "
          f"profiler window: {outcome}", flush=True)
    del x, spec
    _free(card)
    return res


def phase_compression(smi="", cfg_kw=None, batch=BERT_BATCH, seq=BERT_SEQ,
                      proj=None):
    """The compression path: (a) ``QAT`` on BERT-base (config 3's model,
    f32, dropout 0, AdamW at 1e-4, one seeded batch with segment ids): 75
    ``QuantedLinear``s, a warm-up and 3 timed steps against the same
    model's unquantized eager step, launches a step, and the card against
    the CPU at depth 2 with the CPU's codes pinned; (b) ``PTQ`` of that model in eval: 2
    observed batches, each static scale exactly its inputs' largest |x|,
    the converted logits against the float ones; (c) ASP: ``prune_model``
    with ``mask_1d`` and ``mask_2d_best`` timed, the card's masks against
    the CPU's, ``nsp`` excluded, 3 ``decorate``d AdamW steps holding 2:4 on
    the optimizer's tensors; (d) ``nn.quant`` at LLaMA-7B's up projection
    in bf16: codes and scales against the CPU's, ``weight_only_linear`` and
    ``llm_int8_linear`` against their plain routes and ``x @ w``, times
    and bytes; (e) the device queries, ``fftshift(axes=1)`` and a GPU
    profiler window. ``cfg_kw``, the shapes and ``proj``, with ``DEVICE =
    "cpu"``, rehearse it small (no launch checks, no times)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models import bert_base

    K = paddle.ops.kernels
    card = DEVICE != "cpu"
    dev = DEVICE if card else "cpu"
    paddle.set_device("gpu" if card else "cpu")
    t_phase = time.perf_counter()
    res = {"smi": smi}
    launches = {name: 0 for name in K.launch_counts()}

    def counted(fn):
        K.reset_launch_counts()
        out = fn()
        _sync(dev)
        counts = K.launch_counts()
        for name, n in counts.items():
            launches[name] += n
        return out, counts

    def want_only(counts, want, tag):
        if not card:
            return
        full = {name: 0 for name in counts}
        full.update(want)
        check(counts == full, f"compression {tag}: launches "
              f"{ {k: v for k, v in counts.items() if v} }, want {want}")

    cfg = bert_base(dropout=0.0, **(cfg_kw or {}))
    feed = _bert_arrays(cfg.vocab_size, batch, seq, 11)
    res["a"], model = _compression_qat(paddle, card, cfg, cfg_kw, feed,
                                       counted, want_only)
    res["b"] = _compression_ptq(paddle, card, model, cfg.vocab_size, batch,
                                seq, counted, want_only)
    res["c"] = _compression_asp(paddle, card, model, feed, counted,
                                want_only)
    del model
    _free(card)
    res["d"] = _compression_nn_quant(paddle, card, dict(LLAMA_PROJ,
                                                        **(proj or {})))
    res["e"] = _compression_names(paddle, card)
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    print(f"  compression: {res['seconds']:.1f} s on {smi}", flush=True)
    return res


def _free(card):
    gc.collect()
    if card:
        torch.cuda.empty_cache()


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
    from paddle_tpu_torch.models.gpt import GPTConfig

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
        report["float16"] = run("float16", phase_float16, model,
                                report["device"]["smi"], streams,
                                report["incubate"])
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
        report["resilience"] = run(
            "resilience", phase_resilience, report["device"]["smi"],
            GPTConfig(**RESILIENCE_CONFIG4))
        report["quant_train"] = run("quant_train", phase_quant_train,
                                    report["device"]["smi"],
                                    GPTConfig(**QUANT_TRAIN_CONFIG4))
        report["long_context"] = run("long_context", phase_long_context)
        report["long_context_remat"] = run("long_context_remat",
                                           phase_long_context_remat)
        report["model_rest"] = run("model_rest", phase_model_rest,
                                   report["device"]["smi"], None,
                                   MODEL_REST_CONFIG4)
        report["shared_block"] = run(
            "shared_block", phase_shared_block, report["device"]["smi"],
            None, 3, 2048, DEVICE, REST_STEPS, report["training"])
        report["paddle_surface"] = run("paddle_surface",
                                       phase_paddle_surface,
                                       report["device"]["smi"])
        report["vision"] = run("vision", phase_vision,
                               report["device"]["smi"])
        report["amp"] = run("amp", phase_amp, report["device"]["smi"])
        report["deploy"] = run("deploy", phase_deploy,
                               report["device"]["smi"])
        report["tools"] = run("tools", phase_tools, report["device"]["smi"])
        report["static"] = run("static", phase_static,
                               report["device"]["smi"])
        report["domains"] = run("domains", phase_domains,
                                report["device"]["smi"])
        report["compression"] = run("compression", phase_compression,
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
    # the float16 instantiations of the flash kernels, at the amp path's
    # shapes: BERT's for the forward and the fused backward, GQA 32/4 at
    # 4096 (where the router takes it) for the split pair
    f16_case = {"flash_attention_fwd": 0, "flash_attention_bwd": 0,
                "flash_attention_bwd_dq": 2, "flash_attention_bwd_dkv": 2}
    for name, i in f16_case.items():
        meta[name + "_f16"] = meta[name]
    # the six kernels that took a float16 instance in phase float16, at
    # their bf16 rows' main shapes
    f16_rows = report["float16"]["a"]["rows"]
    for name in f16_rows:
        meta[name + "_f16"] = meta[name]
    line = []
    for name, (route, source, replaces) in meta.items():
        # bf16 at the main path's shape: serving for the decode kernels,
        # the incubate decoder for add_rms_norm, long-context training for
        # the split backward, config 4 training for the others
        if name.endswith("_f16"):
            base = name[:-len("_f16")]
            main_case = (f16_rows[base][0] if base in f16_rows else
                         report["amp"]["flash_f16"][base][f16_case[base]])
        else:
            main_case = report["kernels"][name][0]
        by_path = {path: report[path]["launches"][name]
                   for path in ("serving", "serving_int8", "serving_spec",
                                "serving_int8w", "serving_disagg",
                                "serving_fleet", "incubate",
                                "incubate_surface", "float16", "training",
                                "quant_train", "long_context",
                                "model_rest", "shared_block",
                                "paddle_surface", "vision", "amp",
                                "deploy", "tools", "static",
                                "compression")}
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
