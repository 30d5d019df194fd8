"""The port's CUDA kernels on the card (marked ``cuda``).

Each kernel against its plain PyTorch version on the same CUDA tensors
(and the split flash backward run twice, bit for bit), the serving
engine (exact and int8 KV) on the card against the same engine on the
CPU (under swap preemption and the prefix cache too), its decode tick's
CUDA graph against the eager tick and its launch counts over replays,
speculative decoding (its verify graph against the eager verify, the
verify's position-0 logits against the tick's, streams and launches),
int8-resident weights (the int8 GEMM bit for bit against the CPU's) and
the disaggregated pair on the card against the CPU or the single engine,
the incubate decoder of ``chip_smoke.py`` on the card against
the CPU, three training steps on the card against the same three on
the CPU, under full and under selective remat, a guarded step's
keep-select on CUDA tensors (a NaN injection changes no byte of any
parameter or slot) and a CheckpointManager round trip of CUDA tensors,
bit for bit, and the low-precision training path: the fp8 and int8
scaled GEMMs (``torch._scaled_mm``, ``torch._int_mm``) against the CPU's
plain route, the int8 LM head against the CPU's, and a quantized
two-layer step on the card against the CPU; the fleet: a two-replica
FleetRouter on the card against the CPU's and the single engine's
streams, a swapped bf16 and int8 KV snapshot through the wire and
``inject`` bit for bit, and a worker process on the card that serves,
is killed and is respawned; the per-layer ``Attention`` on the flash
kernels against the CPU, the stacked block's attn->norm seam and
int8-saved FFN with their launch counts, and a small MoE decoder on the
card against the CPU; a per-layer model through the shared block (its
launches and the CPU's step), the paged kernel over a page-major cache
against the contiguous one bit for bit, ``block_multihead_attention``'s
decode against its CPU route, and ``FusedMultiHeadAttention`` on the
non-causal flash kernels against the plain route; the Paddle surface: a
tensor made with no place on the card, ``F.scaled_dot_product_attention``
through the flash kernels against its CPU route, BERT at depth 2 on the
card against the CPU, and ``bfloat16()`` keeping ``parameters()`` live;
the vision path: LeNet and resnet18 one step and the conv and pooling
functionals on the card against the CPU, the DataLoader's batches on the
card from its prefetch thread and from worker processes forked after
CUDA started, and a ResNet's ``bfloat16()`` casting its buffers.
Every test skips where there is no CUDA card. This file imports neither
jax nor the JAX package, so it also runs where neither is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import functools

import numpy as np
import pytest
import torch

from chip_smoke import _tick_inputs, incubate_generate
from paddle_tpu_torch.incubate.nn import functional as TF
from paddle_tpu_torch.inference import serving
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.memory import quantize_rows_int8
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLMPipe
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels.add_rms_norm import (add_rms_norm_fwd,
                                                       add_rms_norm_plain)
from paddle_tpu_torch.ops.kernels.decode_attention import (
    EXACT_HEAD_DIMS, decode_attention, decode_attention_plain,
    paged_attention, paged_attention_int8, paged_attention_int8_plain,
    paged_attention_plain, split_count)
from paddle_tpu_torch.ops.kernels.flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_plain, flash_attention_bwd_dq,
    flash_attention_bwd_dq_plain, flash_attention_bwd_fused,
    flash_attention_bwd_plain, flash_attention_fwd, flash_attention_fwd_plain,
    from_bh, fwd_route, to_bh)
from paddle_tpu_torch.ops.kernels.rms_norm import (rms_norm_fwd,
                                                   rms_norm_plain)
from paddle_tpu_torch.ops.kernels.swiglu_down import (swiglu_down_fwd,
                                                      swiglu_down_plain)
from paddle_tpu_torch.distributed.checkpoint.manager import CheckpointManager
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.testing import chaos

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _paged_inputs(b, hq, hkv, d, page, pps, lengths, dtype, device):
    g = torch.Generator().manual_seed(0)
    num_pages = b * pps + 1
    q = torch.randn(b, hq, d, generator=g)
    kp = torch.randn(hkv, num_pages, page, d, generator=g)
    vp = torch.randn(hkv, num_pages, page, d, generator=g)
    tables = torch.randint(-3, num_pages + 3, (b, pps), generator=g)
    perm = torch.randperm(num_pages, generator=g)
    used = 0
    for i, n in enumerate(lengths):
        own = -(-n // page)
        tables[i, :own] = perm[used:used + own]
        used += own
    return ([t.to(device, dtype) for t in (q, kp, vp)]
            + [tables.to(device, torch.int32),
               torch.tensor(lengths, dtype=torch.int32, device=device)])


#: (hq, hkv, d, page): the first port's cases, then every head width the
#: exact kernels take at rep 1, 4, 8 and 16 over pages of 7, 16 and 64
PAGED_SHAPES = ([(16, 16, 128, 64), (16, 2, 64, 16), (8, 8, 128, 7)]
                + [(2 * rep, 2, d, page) for d in EXACT_HEAD_DIMS
                   for rep in (1, 4, 8, 16) for page in (7, 16, 64)])


def _split_edges(rows, align):
    """Lengths that split evenly into the kernel's shares (``align`` rows:
    a page, or the dense route's 16) and one row past that, for a call
    that allows ``rows`` rows."""
    n = split_count(rows)
    exact = n * align * max(1, rows // (align * n * 2))
    return [exact + 1, exact]


def _exact_kernel_checks(fn, args, atol, want):
    """One launch per call, within ``atol`` of the plain version, and the
    same bits on a second call. Returns the output."""
    kernels.reset_launch_counts()
    got = fn(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[fn.__name__] == 1
    assert got.dtype == args[0].dtype
    assert (got.float() - want.float()).abs().max().item() <= atol
    assert torch.equal(fn(*args), got)
    return got


#: f32: summation order only; bf16: p is rounded against the running max
#: in the kernel and against the global max in the plain version
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hq,hkv,d,page", PAGED_SHAPES)
def test_paged_attention_kernel_matches_plain(cuda_device, dtype, atol, hq,
                                              hkv, d, page):
    """A table of 2048 rows (a full cluster of 8 CTAs) under lengths 0, 1,
    one row past a page, one row past an even split, an even split and
    the whole table: the short ones leave most ranks without rows."""
    pps = -(-2048 // page)
    lengths = [0, 1, page + 1, *_split_edges(pps * page, page), pps * page]
    args = _paged_inputs(len(lengths), hq, hkv, d, page, pps, lengths, dtype,
                         cuda_device)
    got = _exact_kernel_checks(paged_attention, args, atol,
                               paged_attention_plain(*args))
    assert torch.all(got[0] == 0)
    # rows past each length are never read: NaN over the rest of each
    # sequence's last page and over every page no sequence owns
    q, kp, vp, tables, lens = args
    owned = torch.zeros(kp.shape[1], dtype=torch.bool, device=cuda_device)
    for i, n in enumerate(lengths):
        own = tables[i, :-(-n // page)].long()
        owned[own] = True
        pos = torch.arange(n, -(-n // page) * page, device=cuda_device)
        for t in (kp, vp):
            t[:, tables[i].long()[pos // page], pos % page] = float("nan")
    for t in (kp, vp):
        t[:, ~owned] = float("nan")
    assert torch.equal(paged_attention(*args), got)


def test_paged_attention_rejects_what_it_does_not_take(cuda_device):
    args = _paged_inputs(1, 4, 4, 64, 16, 1, [3], torch.float16, cuda_device)
    with pytest.raises(TypeError):
        paged_attention(*args)
    for d in (32, 72, 320):
        args = _paged_inputs(1, 4, 4, d, 16, 1, [3], torch.float32,
                             cuda_device)
        with pytest.raises(ValueError):
            paged_attention(*args)


#: x and weight types: f32 and bf16 in every mix (fused_rms_norm passes a
#: bf16 x with an f32 weight)
RMS_TYPES = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
             (torch.bfloat16, torch.float32),
             (torch.bfloat16, torch.bfloat16)]


#: one row, rows off the kernel's rows per block, config 4's 6144 rows;
#: widths off its 16-byte vectors (96 in f32 and bf16 are whole vectors,
#: 100 is not), config 4's and LLaMA-7B's, and the widest it takes
@pytest.mark.parametrize("x_dtype,w_dtype", RMS_TYPES)
@pytest.mark.parametrize("h", [96, 100, 2048, 4096, 8192])
@pytest.mark.parametrize("n", [1, 300, 6144])
def test_rms_norm_kernel_matches_plain(cuda_device, x_dtype, w_dtype, n, h):
    g = torch.Generator().manual_seed(n + h)
    x = (2 * torch.randn(n, h, generator=g)).to(cuda_device, x_dtype)
    w = (torch.rand(h, generator=g) + 0.5).to(cuda_device, w_dtype)
    kernels.reset_launch_counts()
    o, rstd = rms_norm_fwd(x, w)
    ro, rrstd = rms_norm_plain(x, w)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["rms_norm"] == 1
    assert o.dtype == x_dtype and rstd.dtype == torch.float32
    tol = 1e-5 if x_dtype == torch.float32 else 1e-2
    torch.testing.assert_close(o, ro, atol=tol, rtol=tol)
    torch.testing.assert_close(rstd, rrstd, atol=1e-6, rtol=1e-5)


#: f32: summation order only; bf16 q: the kernel and the plain version
#: both compute in f32, so only the output rounding (2^-8) differs
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("hq,hkv,d,page", PAGED_SHAPES)
def test_paged_attention_int8_kernel_matches_plain(cuda_device, dtype, atol,
                                                   hq, hkv, d, page):
    """A table of 2048 rows (a full cluster of 8 CTAs) under lengths 0, 1,
    one row past a page, one row past an even split, an even split and
    the whole table, as for the exact kernel."""
    pps = -(-2048 // page)
    lengths = [0, 1, page + 1, *_split_edges(pps * page, page), pps * page]
    q, kp, vp, tables, lens = _paged_inputs(len(lengths), hq, hkv, d, page,
                                            pps, lengths, torch.float32,
                                            cuda_device)
    (kc, ks), (vc, vs) = quantize_rows_int8(kp), quantize_rows_int8(vp)
    args = [q.to(dtype), kc, ks, vc, vs, tables, lens]
    got = _exact_kernel_checks(paged_attention_int8, args, atol,
                               paged_attention_int8_plain(*args))
    assert torch.all(got[0] == 0)
    # rows past each length are never read: poison the scales of the rest
    # of each sequence's last page
    for i, n in enumerate(lengths):
        pos = torch.arange(n, -(-n // page) * page, device=cuda_device)
        pages = tables[i].long()[pos // page]
        ks[:, pages, pos % page] = float("nan")
        vs[:, pages, pos % page] = float("nan")
    assert torch.equal(paged_attention_int8(*args), got)


#: (hq, hkv, d): the first port's cases, then every head width the exact
#: kernels take at rep 1, 4, 8 and 16
DENSE_SHAPES = ([(16, 16, 128), (8, 2, 64)]
                + [(2 * rep, 2, d) for d in EXACT_HEAD_DIMS
                   for rep in (1, 4, 8, 16)])


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hq,hkv,d", DENSE_SHAPES)
def test_decode_attention_kernel_matches_plain(cuda_device, dtype, atol, hq,
                                               hkv, d):
    """A cache of 2000 rows (8 CTAs a sequence, the last share short)
    under lengths 0, 1, 33, one row past an even split, an even split and
    the whole cache."""
    g = torch.Generator().manual_seed(hq + d)
    s = 2000
    lengths = [0, 1, 33, *_split_edges(s, 16), s]
    b = len(lengths)
    q = torch.randn(b, hq, d, generator=g).to(cuda_device, dtype)
    kc = torch.randn(b, hkv, s, d, generator=g).to(cuda_device, dtype)
    vc = torch.randn(b, hkv, s, d, generator=g).to(cuda_device, dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    args = (q, kc, vc, lens)
    got = _exact_kernel_checks(decode_attention, args, atol,
                               decode_attention_plain(*args))
    assert torch.all(got[0] == 0)
    for i, n in enumerate(lengths):             # never read past the length
        kc[i, :, n:] = float("nan")
        vc[i, :, n:] = float("nan")
    assert torch.equal(decode_attention(*args), got)


#: x, residual and weight types: f32 and bf16 in every mix
ADD_RMS_TYPES = [(x, r, w) for x in (torch.float32, torch.bfloat16)
                 for r in (torch.float32, torch.bfloat16)
                 for w in (torch.float32, torch.bfloat16)]


#: no rows; the incubate decoder's rows; rows off the rows per block at a
#: width of whole vectors (96) and a ragged one (100); a prefill-sized
#: block; the widest row. offset 1 starts x and r one element past a
#: 16-byte boundary (the scalar-load layout).
@pytest.mark.parametrize("x_dtype,r_dtype,w_dtype", ADD_RMS_TYPES)
@pytest.mark.parametrize("n,h", [(0, 4096), (8, 4096), (300, 96),
                                 (300, 100), (4096, 4096), (3, 8192)])
@pytest.mark.parametrize("offset", [0, 1])
def test_add_rms_norm_kernel_matches_plain(cuda_device, x_dtype, r_dtype,
                                           w_dtype, n, h, offset):
    g = torch.Generator().manual_seed(n + h)

    def rows(dtype):
        flat = torch.randn(n * h + offset, generator=g).to(cuda_device, dtype)
        return flat[offset:].view(n, h)

    x, r = rows(x_dtype), rows(r_dtype)
    w = (torch.rand(h, generator=g) + 0.5).to(cuda_device, w_dtype)
    kernels.reset_launch_counts()
    y, o, rstd = add_rms_norm_fwd(x, r, w)
    ry, ro, rrstd = add_rms_norm_plain(x, r, w)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["add_rms_norm"] == (1 if n else 0)
    assert y.dtype == o.dtype == x_dtype and rstd.dtype == torch.float32
    assert torch.equal(y, ry)
    tol = 1e-5 if x_dtype == torch.float32 else 1e-2
    torch.testing.assert_close(o, ro, atol=tol, rtol=tol)
    torch.testing.assert_close(rstd, rrstd, atol=1e-6, rtol=1e-5)


def test_decode_kernels_reject_what_they_do_not_take(cuda_device):
    q, kp, vp, tables, lens = _paged_inputs(1, 4, 4, 64, 16, 1, [3],
                                            torch.float32, cuda_device)
    (kc, ks), (vc, vs) = quantize_rows_int8(kp), quantize_rows_int8(vp)
    with pytest.raises(TypeError):
        paged_attention_int8(q.half(), kc, ks, vc, vs, tables, lens)
    with pytest.raises(TypeError):
        paged_attention_int8(q, kp, ks, vp, vs, tables, lens)
    with pytest.raises(ValueError):
        paged_attention_int8(q[..., :32].contiguous(), kc[..., :32],
                             ks, vc[..., :32], vs, tables, lens)
    dense = torch.zeros(1, 4, 16, 64, device=cuda_device)
    with pytest.raises(TypeError):
        decode_attention(q.bfloat16(), dense, dense, lens)
    with pytest.raises(ValueError):
        decode_attention(q, dense, dense, lens.long())
    x = torch.ones(2, 16, device=cuda_device)
    with pytest.raises(ValueError):
        add_rms_norm_fwd(x, x[:1], torch.ones(16, device=cuda_device))
    with pytest.raises(TypeError):
        add_rms_norm_fwd(x.half(), x.half(),
                         torch.ones(16, device=cuda_device).half())


#: head_dim 64 under GQA 4/2, and Phi-3-mini's head_dim 96 under MQA (16
#: q heads over one kv head), each with exact and with int8 KV
@pytest.mark.parametrize("int8_kv,hidden,heads,kv_heads",
                         [(False, 256, 4, 2), (True, 256, 4, 2),
                          (False, 1536, 16, 1), (True, 1536, 16, 1)],
                         ids=["exact", "int8", "exact-d96-rep16",
                              "int8-d96-rep16"])
def test_engine_on_card_matches_cpu_and_counts_launches(
        cuda_device, int8_kv, hidden, heads, kv_heads):
    cfg = LlamaConfig(vocab_size=96, hidden_size=hidden, num_layers=2,
                      num_heads=heads, num_kv_heads=kv_heads,
                      max_seq_len=128)
    cpu = LlamaForCausalLM(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(0), std=0.2)
    gpu = LlamaForCausalLM(cfg, device=cuda_device)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 96, n).tolist() for n in (5, 19, 33)]
    for chunk in (None, 8):
        outs = []
        for model, dev in ((cpu, "cpu"), (gpu, cuda_device)):
            eng = ContinuousBatchingEngine(model, max_slots=2, page_size=16,
                                           max_seq_len=64, max_new_tokens=6,
                                           prefill_chunk=chunk, device=dev,
                                           int8_kv=int8_kv)
            assert eng.int8_kv == int8_kv
            kernels.reset_launch_counts()
            for p in prompts:
                eng.submit(p)
            outs.append(eng.run_until_complete())
            counts = kernels.launch_counts()
        assert outs[0] == outs[1]
        attn = "paged_attention_int8" if int8_kv else "paged_attention"
        assert counts[attn] == cfg.num_layers * eng.decode_ticks
        assert counts["paged_attention" if int8_kv
                      else "paged_attention_int8"] == 0
        assert counts["rms_norm"] == (2 * cfg.num_layers + 1) * (
            eng.decode_ticks + eng.prefill_chunk_steps + eng.prefill_batches)


def _engine_pair(cuda_device, int8_kv=False, seed=0, **kw):
    """A tiny f32 LlamaForCausalLM on the CPU and its copy on the card,
    and an engine on each with the same settings."""
    cfg = LlamaConfig(vocab_size=96, hidden_size=256, num_layers=2,
                      num_heads=4, num_kv_heads=2, max_seq_len=128)
    cpu = LlamaForCausalLM(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(seed), std=0.2)
    gpu = LlamaForCausalLM(cfg, device=cuda_device)
    gpu.load_state_dict(cpu.state_dict())
    kw = dict(dict(max_slots=2, page_size=16, max_seq_len=64,
                   max_new_tokens=6, int8_kv=int8_kv), **kw)
    return (ContinuousBatchingEngine(cpu, device="cpu", **kw),
            ContinuousBatchingEngine(gpu, device=cuda_device, **kw))


def _serve(eng, prompts, **kw):
    for p in prompts:
        eng.submit(p, **kw)
    return eng.run_until_complete()


def _cache_leaves(eng):
    return [x for c in (eng.kc, eng.vc)
            for x in (c if isinstance(c, tuple) else (c,))]


@pytest.mark.parametrize("int8_kv", [False, True], ids=["exact", "int8"])
@torch.inference_mode()
def test_graphed_tick_equals_eager_decode_step(cuda_device, int8_kv):
    """One replay of the captured tick against the eager _decode_step on
    the same engine state: the same kernels on the same bytes, so the
    logits, the greedy tokens, a sampled draw under one generator seed and
    every KV byte are equal."""
    _, eng = _engine_pair(cuda_device, int8_kv, max_new_tokens=12,
                          prefill_chunk=8)
    rng = np.random.default_rng(2)
    for p in [rng.integers(1, 96, n).tolist() for n in (5, 19)]:
        eng.submit(p)
    for _ in range(4):
        eng.step()
    assert eng._graph is not None
    tokens, lens, tables = _tick_inputs(eng)
    saved = [x.clone() for x in _cache_leaves(eng)]
    eager = eng._decode_step(*(torch.from_numpy(a).to(cuda_device)
                               for a in (tokens, lens, tables))).clone()
    eager_kv = [x.clone() for x in _cache_leaves(eng)]
    for x, s in zip(_cache_leaves(eng), saved):
        x.copy_(s)
    graphed = eng._decode_logits(tokens, lens, tables).clone()
    assert torch.equal(graphed, eager)
    assert torch.equal(graphed.argmax(-1), eager.argmax(-1))
    for x, want, before in zip(_cache_leaves(eng), eager_kv, saved):
        assert torch.equal(x, want)
        assert not torch.equal(x, before)       # the tick wrote its rows
    b = eng.max_slots
    draws = []
    for lg in (graphed, eager):
        gen = torch.Generator(device=cuda_device).manual_seed(11)
        draws.append(serving._sample_rows(
            lg, torch.full((b,), 0.9, device=cuda_device),
            torch.zeros(b, dtype=torch.long, device=cuda_device),
            torch.ones(b, device=cuda_device), gen))
    assert torch.equal(draws[0], draws[1])


@pytest.mark.parametrize("warm", [False, True], ids=["lazy", "warmup"])
def test_graph_replays_count_launches_exactly(cuda_device, warm):
    """The capture counts nothing and every replay counts its kernels: L
    paged_attention and 2L + 1 rms_norm per tick, whether the graph was
    captured by warmup() or by the first tick (whose eager pass is the
    tick)."""
    _, eng = _engine_pair(cuda_device, prefill_chunk=8, max_new_tokens=10)
    if warm:
        assert eng.warmup() > 0 and eng._graph is not None
    kernels.reset_launch_counts()
    rng = np.random.default_rng(3)
    _serve(eng, [rng.integers(1, 96, n).tolist() for n in (7, 12, 3)])
    counts = kernels.launch_counts()
    L = eng.cfg.num_layers
    assert eng._graph.launches == {"paged_attention": L,
                                   "rms_norm": 2 * L + 1}
    assert counts["paged_attention"] == L * eng.decode_ticks
    assert counts["rms_norm"] == (2 * L + 1) * (eng.decode_ticks
                                                + eng.prefill_chunk_steps)


def test_sampled_streams_repeat_and_follow_the_seed(cuda_device):
    prompts = [np.random.default_rng(4).integers(1, 96, n).tolist()
               for n in (6, 10, 4)]
    runs = []
    for seed in (5, 5, 6):
        _, eng = _engine_pair(cuda_device, seed=0, prefill_chunk=8)
        eng._gen.manual_seed(seed)
        runs.append(_serve(eng, prompts, temperature=1.5))
    assert runs[0] == runs[1] != runs[2]


@torch.inference_mode()
def test_warmup_on_card_writes_only_the_scratch_page(cuda_device):
    cpu_eng, eng = _engine_pair(cuda_device, int8_kv=True, prefill_chunk=8)
    assert eng.warmup(sample=True) == eng.build_seconds > 0
    trash = eng._trash_page
    for x in _cache_leaves(eng):
        assert not x[:, :, :trash].any() and x[:, :, trash].any()
    prompts = [np.random.default_rng(6).integers(1, 96, n).tolist()
               for n in (5, 19, 33)]
    assert _serve(eng, prompts) == _serve(cpu_eng, prompts)


def test_reload_weights_recaptures_on_new_storage(cuda_device):
    """An update in place keeps the graph, which reads the new values; a
    weight moved to new storage drops it and the next tick captures again.
    Either way the streams equal the CPU engine's on the same weights."""
    cpu_eng, eng = _engine_pair(cuda_device, prefill_chunk=8)
    prompts = [np.random.default_rng(7).integers(1, 96, n).tolist()
               for n in (9, 4)]
    assert _serve(eng, prompts) == _serve(cpu_eng, prompts)
    first = eng._graph
    cpu_m, gpu_m = cpu_eng._model, eng._model
    g = torch.Generator().manual_seed(8)
    with torch.no_grad():
        w = cpu_m.model.layers[0].mlp.up_proj.weight
        w.copy_(torch.randn(w.shape, generator=g) * 0.2)
        gpu_m.model.layers[0].mlp.up_proj.weight.copy_(w)
    for e in (cpu_eng, eng):
        e.reload_weights()
    assert eng._graph is first
    want = _serve(cpu_eng, prompts)
    assert _serve(eng, prompts) == want
    with torch.no_grad():
        e = cpu_m.model.embed_tokens.weight
        e.copy_(torch.randn(e.shape, generator=g) * 0.2)
        gpu_m.model.embed_tokens.weight.data = e.to(cuda_device)
    for e in (cpu_eng, eng):
        e.reload_weights()
    assert eng._graph is None
    want2 = _serve(cpu_eng, prompts)
    assert want2 != want
    assert _serve(eng, prompts) == want2
    assert eng._graph is not None and eng._graph is not first


@pytest.mark.parametrize("int8_kv,chunk", [(False, None), (False, 5),
                                           (True, None), (True, 5)],
                         ids=["group", "chunked", "int8-group",
                              "int8-chunked"])
def test_swap_on_card_matches_cpu(cuda_device, int8_kv, chunk):
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 96, n).tolist() for n in (10, 9, 11)]
    engines = _engine_pair(cuda_device, int8_kv, max_slots=3, page_size=4,
                           max_seq_len=48, num_pages=10, max_new_tokens=12,
                           prefill_chunk=chunk, preempt_policy="swap")
    outs = [_serve(e, prompts) for e in engines]
    assert outs[0] == outs[1]
    counts = [(e.preemptions, e.swaps_out, e.swaps_in, e.pool.available)
              for e in engines]
    assert counts[0] == counts[1] and counts[1][1] > 0


def test_prefix_cache_on_card_matches_cpu(cuda_device):
    system = list(range(1, 13))
    prompts = [system + [20, 21, 22], system + [30, 31],
               system + [20, 21, 22], list(range(40, 49))]
    engines = _engine_pair(cuda_device, max_slots=2, page_size=4,
                           max_seq_len=48, num_pages=12, max_new_tokens=8,
                           prefill_chunk=4, enable_prefix_cache=True)
    outs = [_serve(e, prompts) for e in engines]
    assert outs[0] == outs[1]
    counts = [(e.prefix_cache_hits, e.prefix_cache_evictions,
               e.prefix_tokens_skipped, e.pool.available) for e in engines]
    assert counts[0] == counts[1] and counts[1][0] >= 3


@pytest.mark.parametrize("d", [64, 80])
def test_incubate_ops_on_card_match_cpu(cuda_device, d):
    g = torch.Generator().manual_seed(3)
    x, r = torch.randn(2, 6, 128, generator=g), torch.randn(2, 6, 128,
                                                             generator=g)
    w = torch.rand(128, generator=g) + 0.5
    kernels.reset_launch_counts()
    out, y = TF.fused_rms_norm(*(t.to(cuda_device) for t in (x, w)),
                               residual=r.to(cuda_device))
    plain = TF.fused_rms_norm(x.to(cuda_device), w.to(cuda_device))
    cout, cy = TF.fused_rms_norm(x, w, residual=r)
    torch.testing.assert_close(out.cpu(), cout, atol=1e-5, rtol=1e-5)
    assert torch.equal(y.cpu(), cy)
    torch.testing.assert_close(plain.cpu(), TF.fused_rms_norm(x, w),
                               atol=1e-5, rtol=1e-5)
    qkv = torch.randn(3, 3 * 4 * d, generator=g)
    cache = torch.randn(2, 3, 4, 40, d, generator=g)
    lens = torch.tensor([0, 7, 39], dtype=torch.int32)
    gcache = cache.to(cuda_device)
    gout, _ = TF.masked_multihead_attention(
        qkv.to(cuda_device), gcache, sequence_lengths=lens.to(cuda_device))
    cout, _ = TF.masked_multihead_attention(qkv, cache, sequence_lengths=lens)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {
        **{k: 0 for k in kernels.LAUNCHES}, "add_rms_norm": 1,
        "rms_norm": 1, "decode_attention": 1}
    torch.testing.assert_close(gout.cpu(), cout, atol=1e-4, rtol=1e-4)
    assert torch.equal(gcache.cpu(), cache)


def test_incubate_decoder_on_card_matches_cpu(cuda_device):
    """chip_smoke.py's incubate decoder, MHA head_dim 64: greedy streams
    on the card equal the CPU's; launches per token are decode_attention
    L, add_rms_norm 2L and rms_norm 1."""
    cfg = LlamaConfig(vocab_size=96, hidden_size=256, num_layers=2,
                      num_heads=4, max_seq_len=128)
    cpu = LlamaForCausalLM(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(1), std=0.2)
    gpu = LlamaForCausalLM(cfg, device=cuda_device)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 96, n).tolist() for n in (4, 9, 2)]
    want, _ = incubate_generate(cpu, prompts, [0, 2, 5], 6, 32)
    kernels.reset_launch_counts()
    got, steps = incubate_generate(gpu, prompts, [0, 2, 5], 6, 32)
    counts = kernels.launch_counts()
    assert got == want
    L = cfg.num_layers
    assert (counts["decode_attention"], counts["add_rms_norm"],
            counts["rms_norm"]) == (L * steps, 2 * L * steps, steps)


# ------------------------------------- speculative decoding, int8 weights
def _spec_pair(cuda_device, draft_cfg=None, **kw):
    """_engine_pair's models with a draft on each side: the target itself,
    or a seeded model of ``draft_cfg``."""
    cpu_eng, gpu_eng = _engine_pair(cuda_device, **kw)
    if draft_cfg is None:
        return cpu_eng, gpu_eng, cpu_eng._model, gpu_eng._model
    cpu_d = LlamaForCausalLM(draft_cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(9), std=0.2)
    gpu_d = LlamaForCausalLM(draft_cfg, device=cuda_device)
    gpu_d.load_state_dict(cpu_d.state_dict())
    return cpu_eng, gpu_eng, cpu_d, gpu_d


@pytest.mark.parametrize("draft", ["self", "small"])
@pytest.mark.parametrize("int8_kv", [False, True], ids=["exact", "int8"])
def test_spec_engine_on_card_matches_cpu_and_counts_launches(
        cuda_device, draft, int8_kv):
    """Spec streams on the card equal the CPU's and the plain engine's; a
    self-draft accepts every token; each spec tick launches the verify's
    (K + 1) L and the proposal's (K + 1) Ld attention kernels."""
    small = LlamaConfig(vocab_size=96, hidden_size=128, num_layers=1,
                        num_heads=2, num_kv_heads=2, max_seq_len=128)
    kw = dict(int8_kv=int8_kv, max_new_tokens=10, prefill_chunk=None)
    cpu_eng, gpu_eng, cpu_d, gpu_d = _spec_pair(
        cuda_device, None if draft == "self" else small, **kw)
    prompts = [np.random.default_rng(12).integers(1, 96, n).tolist()
               for n in (5, 19, 33)]
    want = _serve(gpu_eng, prompts)
    outs, K = [], 3
    for eng_model, d, dev in ((cpu_eng._model, cpu_d, "cpu"),
                              (gpu_eng._model, gpu_d, cuda_device)):
        eng = ContinuousBatchingEngine(eng_model, draft_model=d,
                                       spec_tokens=K, device=dev,
                                       **dict(max_slots=2, page_size=16,
                                              max_seq_len=64, **kw))
        kernels.reset_launch_counts()
        outs.append(_serve(eng, prompts))
        counts = kernels.launch_counts()
        if draft == "self":
            assert eng.spec_acceptance_rate == 1.0
    assert outs[0] == outs[1] == want
    L, Ld = eng.cfg.num_layers, eng._draft.cfg.num_layers
    ticks = eng.spec_ticks
    assert ticks > 0 and eng.decode_ticks == 0
    # the draft's cache is always exact
    if int8_kv:
        assert counts["paged_attention_int8"] == (K + 1) * L * ticks
        assert counts["paged_attention"] == (K + 1) * Ld * ticks
    else:
        assert counts["paged_attention"] == (K + 1) * (L + Ld) * ticks
    attn = "paged_attention_int8" if int8_kv else "paged_attention"
    assert eng._verify_graph.launches[attn] == (K + 1) * L
    assert eng._draft._propose_graph.launches["paged_attention"] == \
        (K + 1) * Ld


@torch.inference_mode()
def test_verify_graph_and_position_zero_logits_on_one_state(cuda_device):
    """On one engine state: one replay of the verify graph equals the eager
    verify (tokens and KV cells), and the verify's position-0 logits equal
    the tick's, eager and graphed, bit for bit (the forwards share one
    GEMM row count)."""
    from chip_smoke import _spec_state_checks

    _, eng, _, gpu_d = _spec_pair(cuda_device, max_new_tokens=20,
                                  prefill_chunk=8)
    eng = ContinuousBatchingEngine(eng._model, draft_model=gpu_d,
                                   spec_tokens=3, device=cuda_device,
                                   max_slots=2, page_size=16,
                                   max_seq_len=64, max_new_tokens=20,
                                   prefill_chunk=8)
    rng = np.random.default_rng(2)
    for p in [rng.integers(1, 96, n).tolist() for n in (5, 19)]:
        eng.submit(p)
    for _ in range(5):
        eng.step()
    assert eng._verify_graph is not None
    checks = _spec_state_checks(eng)
    for key in ("pos0_equal_eager_tick", "pos0_equal_graphed_tick",
                "verify_graph_tokens_equal", "verify_graph_kv_equal"):
        assert checks[key], (key, checks)


def test_fallback_and_warmup_on_card_match_cpu(cuda_device):
    """Sampled requests force plain ticks with the draft's catch-up (one
    graph each); warmup() captures all four graphs and writes only the
    scratch page; greedy streams equal the CPU's."""
    cpu_eng, eng, cpu_d, gpu_d = _spec_pair(cuda_device, prefill_chunk=8)
    engines = [ContinuousBatchingEngine(e._model, draft_model=d,
                                        spec_tokens=2, device=dev,
                                        max_slots=2, page_size=16,
                                        max_seq_len=64, max_new_tokens=8,
                                        prefill_chunk=8)
               for e, d, dev in ((cpu_eng, cpu_d, "cpu"),
                                 (eng, gpu_d, cuda_device))]
    gpu = engines[1]
    assert gpu.warmup() > 0
    assert None not in (gpu._graph, gpu._verify_graph,
                        gpu._draft._propose_graph, gpu._draft._catch_graph)
    trash = gpu._trash_page
    for x in (gpu.kc, gpu.vc, gpu._draft.kc, gpu._draft.vc):
        assert not x[:, :, :trash].any() and x[:, :, trash].any()
    outs = []
    for e in engines:
        r_s = e.submit([3, 4, 5, 6, 7], temperature=0.9, top_k=8)
        e.step()
        e.step()
        r_g = e.submit([9, 8, 7, 6, 5, 4])
        done = e.run_until_complete()
        assert r_s in done and e.spec_ticks > 0 and e.decode_ticks > 0
        outs.append(done[r_g])
    assert outs[0] == outs[1]


def test_draft_on_another_device_raises(cuda_device):
    """No fallback: a CUDA engine does not take a draft whose weights are
    on the CPU."""
    cpu_eng, eng = _engine_pair(cuda_device)
    with pytest.raises(ValueError, match="draft model's weights"):
        ContinuousBatchingEngine(eng._model, draft_model=cpu_eng._model,
                                 device=cuda_device)


def test_int8_weight_matmul_on_card_equals_cpu_bitwise(cuda_device):
    from paddle_tpu_torch import quant

    g = torch.Generator().manual_seed(3)
    for rows in (3, 8, 40, 64):
        w = torch.randn(256, 512, generator=g)
        x = torch.randn(rows, 512, generator=g)
        packed = quant.quantize_linear_int8(w)
        gpu = tuple(t.to(cuda_device) for t in packed)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(gpu, packed))
        xq, _ = quantize_rows_int8(x)
        want_acc = torch._int_mm(xq, packed[0].t())
        a = torch.nn.functional.pad(xq.to(cuda_device),
                                    (0, 0, 0, max(0, 32 - rows)))
        got_acc = torch._int_mm(a, gpu[0].t())[:rows].cpu()
        assert torch.equal(got_acc, want_acc)
        for dt in (torch.float32, torch.bfloat16):
            want = quant.int8_linear(x.to(dt), packed)
            got = quant.int8_linear(x.to(dt).to(cuda_device), gpu).cpu()
            assert got.dtype == dt and torch.equal(got, want)


@pytest.mark.parametrize("chunk", [None, 8], ids=["group", "chunked"])
def test_int8_weight_engine_on_card_matches_cpu(cuda_device, chunk):
    engines = _engine_pair(cuda_device, int8_weights=True,
                           prefill_chunk=chunk, max_new_tokens=8)
    prompts = [np.random.default_rng(13).integers(1, 96, n).tolist()
               for n in (5, 19, 33)]
    outs = [_serve(e, prompts) for e in engines]
    assert outs[0] == outs[1]
    assert engines[1].int8_weights
    assert engines[1].load()["weight_bytes"] == engines[0].weight_bytes
    assert torch.equal(engines[1]._weights["layers"][0][1][0].cpu(),
                       engines[0]._weights["layers"][0][1][0])


def test_disagg_on_card_matches_single_engine(cuda_device):
    from paddle_tpu_torch.inference.fleet import DisaggregatedEngine

    _, eng = _engine_pair(cuda_device, prefill_chunk=8)
    prompts = [np.random.default_rng(14).integers(1, 96, n).tolist()
               for n in (19, 7, 26, 4)]
    want = _serve(eng, prompts)
    dis = DisaggregatedEngine(eng._model, prefill_slots=2, decode_slots=2,
                              page_size=16, max_seq_len=64,
                              max_new_tokens=6, prefill_chunk=8,
                              device=cuda_device)
    got = _serve(dis, prompts)
    assert got == want and dis.handoffs == len(prompts)


def test_fleet_router_on_card_matches_single_engine(cuda_device):
    from paddle_tpu_torch.inference.fleet import FleetRouter, make_replicas

    cpu_eng, eng = _engine_pair(cuda_device, prefill_chunk=8)
    prompts = [np.random.default_rng(15).integers(1, 96, n).tolist()
               for n in (19, 7, 26, 4, 11, 30)]
    want = _serve(eng, prompts)
    kw = dict(max_slots=2, page_size=16, max_seq_len=64, max_new_tokens=6,
              prefill_chunk=8)
    for policy in ("round_robin", "least_loaded"):
        routers = [FleetRouter(make_replicas(lambda i, m=m: m, 2, device=d,
                                             **kw), policy=policy)
                   for m, d in ((eng._model, cuda_device),
                                (cpu_eng._model, "cpu"))]
        got = [_serve(r, prompts) for r in routers]
        assert got[0] == got[1] == want
        assert all(h.dispatched > 0 for h in routers[0].replicas)


@pytest.mark.parametrize("int8_kv", [False, True], ids=["bf16", "int8"])
def test_swapped_kv_crosses_the_wire_on_card(cuda_device, int8_kv):
    from paddle_tpu_torch.inference.fleet import wire

    cfg = LlamaConfig(vocab_size=96, hidden_size=256, num_layers=2,
                      num_heads=4, num_kv_heads=2, max_seq_len=128)
    model = LlamaForCausalLM(cfg, device=cuda_device,
                             dtype=torch.bfloat16).init_weights(
        torch.Generator(device=cuda_device).manual_seed(3), std=0.2)
    kw = dict(max_slots=2, page_size=16, max_seq_len=64, max_new_tokens=6,
              int8_kv=int8_kv, device=cuda_device)
    prompt = np.random.default_rng(16).integers(1, 96, 21).tolist()
    ref = ContinuousBatchingEngine(model, **kw)
    want = _serve(ref, [prompt])[0]
    src = ContinuousBatchingEngine(model, **kw)
    rid = src.submit(prompt)
    while src._slots[0] is None or len(src._slots[0].generated) < 2:
        src.step()
    req = src.extract(0)
    leaves = [x for c in (req.swapped["k"], req.swapped["v"])
              for x in (c if isinstance(c, tuple) else (c,))]
    assert leaves[0].dtype == (torch.int8 if int8_kv else torch.bfloat16)
    for codec in wire.available_codecs():
        back = wire.request_from_wire(wire.decode_frame(wire.encode_frame(
            wire.request_to_wire(req), codec)))
        got = [x for c in (back.swapped["k"], back.swapped["v"])
               for x in (c if isinstance(c, tuple) else (c,))]
        assert all(a.dtype == b.dtype and torch.equal(
            a.view(torch.uint8), b.view(torch.uint8))
            for a, b in zip(leaves, got))
        dst = ContinuousBatchingEngine(model, **kw)
        dst.inject(back)
        assert dst.run_until_complete()[rid] == want


def test_proc_child_on_card_serves_and_respawns(cuda_device, tmp_path):
    from paddle_tpu_torch.inference.fleet import (FleetSupervisor,
                                                  build_model_from_spec,
                                                  make_model_spec)

    spec = make_model_spec(
        dict(vocab_size=96, hidden_size=256, num_layers=2, num_heads=4,
             num_kv_heads=2, max_seq_len=128),
        engine_kw=dict(max_slots=2, page_size=16, max_seq_len=64,
                       max_new_tokens=6), device=cuda_device)
    local = ContinuousBatchingEngine(build_model_from_spec(spec),
                                     device=cuda_device,
                                     **spec["engine_kw"])
    prompts = [np.random.default_rng(17).integers(1, 96, n).tolist()
               for n in (9, 14)]
    want = sorted(_serve(local, prompts).values())
    sup = FleetSupervisor(spec, 1, proc=True, lease_seconds=120.0,
                          workdir=str(tmp_path))
    try:
        assert sup.children[0].pid > 0
        assert sorted(_serve(sup, prompts).values()) == want
        sup.children[0].kill()
        for _ in range(20):
            sup.step()
            if sup.respawns:
                break
        assert sup.respawns == 1 and sup.router.replicas[1].healthy
        assert sorted(_serve(sup, prompts).values()) == want
    finally:
        sup.close()


def _rel_err(got, want):
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp_min(1e-6)).item()


#: error relative to the largest value. f32: summation order (and, in the
#: backward, the run-to-run order of the dq atomics). bf16: p and ds are
#: rounded from f32 values that differ in their last bits between the two
#: routes (running max against global max, sum order), and the outputs
#: are rounded to bf16 (2^-8).
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
FLASH_SHAPES = [  # (hq, hkv, d, sq, sk)
    (2, 2, 128, 200, 200), (4, 2, 64, 200, 200), (8, 2, 128, 130, 130),
    (4, 4, 64, 100, 200), (4, 1, 128, 64, 192)]


#: every padded width of the four flash kernels beside 64 and 128: 40
#: (padded to 48 columns, then 64 in the kernel), Phi-2's 80, Phi-3-mini's
#: 96 under GQA, 192, and Gemma's 256 under MHA and MQA (the 192/256-column
#: backward's 64-key blocks); ragged sq and sk, sq < sk, sq > sk
WIDTH_SHAPES = [  # (hq, hkv, d, sq, sk)
    (4, 2, 40, 130, 257), (2, 2, 80, 257, 257), (8, 2, 96, 200, 300),
    (2, 1, 192, 130, 130), (4, 4, 256, 257, 129), (8, 1, 256, 300, 300),
    (16, 16, 96, 700, 900)]


def _flash_inputs(hq, hkv, d, sq, sk, dtype, device, b=2):
    g = torch.Generator().manual_seed(hq * 1000 + d + sq)
    q = torch.randn(b * hq, sq, d, generator=g)
    k = torch.randn(b * hkv, sk, d, generator=g)
    v = torch.randn(b * hkv, sk, d, generator=g)
    do = torch.randn(b * hq, sq, d, generator=g)
    return [t.to(device, dtype) for t in (q, k, v, do)]


#: the forward's tile edges (128-row q tiles, 128-key k tiles): sq and sk
#: off a multiple of 128, sk > sq, sq > sk (causal rows that see no key),
#: several tiles, GQA 8/2 and D = 64; the last two have more (head, q
#: tile) items than the card has SMs, so a block walks several
FWD_EDGE_SHAPES = [  # (hq, hkv, d, sq, sk)
    (8, 2, 64, 130, 257), (2, 2, 128, 257, 130), (2, 1, 128, 513, 700),
    (4, 4, 64, 384, 384), (32, 8, 128, 1000, 1000), (16, 16, 64, 700, 900)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hq,hkv,d,sq,sk",
                         FLASH_SHAPES + FWD_EDGE_SHAPES + WIDTH_SHAPES)
def test_flash_fwd_kernel_matches_plain(cuda_device, dtype, causal, hq, hkv,
                                        d, sq, sk):
    q, k, v, _ = _flash_inputs(hq, hkv, d, sq, sk, dtype, cuda_device)
    kernels.reset_launch_counts()
    o, lse = flash_attention_fwd(q, k, v, causal)
    ro, rlse = flash_attention_fwd_plain(q, k, v, causal)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention_fwd"] == 1
    assert _rel_err(o, ro) <= FLASH_TOL[dtype]
    assert (lse - rlse).abs().max().item() <= 1e-3


#: the bf16 fused backward's tile edges (128-key tiles, 64-row q tiles
#: over the rep q heads, a [64 q x 64] dq product per consumer): 127, 129
#: and 257 keys, sq < sk, sq > sk (causal rows that see no key), rep 1, 4
#: and 8, D 64 and 128, several tiles, and more (kv head, key tile) items
#: than the card has SMs
FUSED_EDGE_SHAPES = [  # (hq, hkv, d, sq, sk)
    (2, 2, 128, 127, 127), (4, 1, 64, 129, 129), (8, 1, 64, 100, 257),
    (4, 1, 128, 257, 257), (2, 2, 128, 64, 129), (8, 2, 64, 130, 257),
    (4, 4, 128, 257, 129), (2, 2, 64, 1000, 1000), (16, 16, 128, 700, 900)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hq,hkv,d,sq,sk",
                         FLASH_SHAPES + FUSED_EDGE_SHAPES + WIDTH_SHAPES)
def test_flash_bwd_kernel_matches_plain(cuda_device, dtype, causal, hq, hkv,
                                        d, sq, sk):
    q, k, v, do = _flash_inputs(hq, hkv, d, sq, sk, dtype, cuda_device)
    o, lse = flash_attention_fwd_plain(q, k, v, causal)
    kernels.reset_launch_counts()
    got = flash_attention_bwd(q, k, v, o, lse, do, causal)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention_bwd"] == 1
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _rel_err(a, b) <= FLASH_TOL[dtype], name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_kernel_takes_a_negative_scale(cuda_device, dtype):
    q, k, v, _ = _flash_inputs(4, 2, 64, 130, 257, dtype, cuda_device)
    o, lse = flash_attention_fwd(q, k, v, True, -0.2)
    ro, rlse = flash_attention_fwd_plain(q, k, v, True, -0.2)
    torch.cuda.synchronize()
    assert _rel_err(o, ro) <= FLASH_TOL[dtype]
    assert (lse - rlse).abs().max().item() <= 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_kernel_repeats_bitwise(cuda_device, dtype):
    """No atomics, one fixed order: two forwards give the same bits (the
    selective-remat check of chip_smoke.py relies on it)."""
    q, k, v, _ = _flash_inputs(8, 2, 128, 300, 300, dtype, cuda_device)
    first = flash_attention_fwd(q, k, v, True)
    again = flash_attention_fwd(q, k, v, True)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def _split_inputs(hq, hkv, d, sq, sk, dtype, causal, device):
    q, k, v, do = _flash_inputs(hq, hkv, d, sq, sk, dtype, device)
    o, lse = flash_attention_fwd_plain(q, k, v, causal)
    return q, k, v, do, lse, (do.float() * o.float()).sum(-1)


#: the bf16 split kernels' tile edges (dq: 128-row q tiles over 64-key
#: tiles; dk/dv: 128-key tiles over 64-row q tiles walking the rep q
#: heads): sq and sk straddling 64 and 128, sq < sk, sq > sk (causal rows
#: that see no key), rep 1, 2, 4 and 8, D 64 and 128, several tiles, and
#: more (head, tile) items than the card has SMs
SPLIT_EDGE_SHAPES = [  # (hq, hkv, d, sq, sk)
    (2, 2, 128, 127, 127), (2, 1, 64, 129, 129), (4, 1, 128, 257, 257),
    (8, 1, 64, 130, 257), (16, 2, 128, 200, 300), (4, 2, 64, 257, 129),
    (2, 2, 128, 1000, 1000), (16, 16, 128, 700, 900)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hq,hkv,d,sq,sk",
                         FLASH_SHAPES + SPLIT_EDGE_SHAPES + WIDTH_SHAPES)
def test_flash_split_kernels_match_plain(cuda_device, dtype, causal, hq, hkv,
                                         d, sq, sk):
    """The dq and dk/dv kernels against their plain versions: MHA, GQA and
    MQA, causal and full, ragged sq (200, 130, 100 rows), sq < sk, and the
    bf16 kernels' tile edges."""
    args = _split_inputs(hq, hkv, d, sq, sk, dtype, causal, cuda_device)
    kernels.reset_launch_counts()
    dq = flash_attention_bwd_dq(*args, causal)
    dk, dv = flash_attention_bwd_dkv(*args, causal)
    want = (flash_attention_bwd_dq_plain(*args, causal),
            *flash_attention_bwd_dkv_plain(*args, causal))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["flash_attention_bwd_dq"] == 1
    assert counts["flash_attention_bwd_dkv"] == 1
    for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _rel_err(a, b) <= FLASH_TOL[dtype], name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,d,sq,sk",
                         [(8, 2, 128, 300, 300)] + SPLIT_EDGE_SHAPES
                         + WIDTH_SHAPES)
def test_flash_split_kernels_repeat_bitwise(cuda_device, dtype, hq, hkv, d,
                                            sq, sk):
    """Each output element is summed by one thread in a fixed order: two
    runs give the same bits (the fused kernel's dq adds do not)."""
    args = _split_inputs(hq, hkv, d, sq, sk, dtype, True, cuda_device)
    first = (flash_attention_bwd_dq(*args, True),
             *flash_attention_bwd_dkv(*args, True))
    again = (flash_attention_bwd_dq(*args, True),
             *flash_attention_bwd_dkv(*args, True))
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hq,hkv,d,sq,sk", [
    (16, 16, 128, 2048, 2048), (8, 2, 64, 257, 300), (4, 1, 128, 130, 130),
    (8, 2, 96, 257, 300), (8, 1, 256, 300, 300), (4, 4, 192, 200, 200)])
def test_flash_split_kernels_match_fused(cuda_device, causal, hq, hkv, d, sq,
                                         sk):
    """The bf16 split pair against the bf16 fused kernel on the same
    inputs: two algorithms with the same roundings of p and ds, held to
    FLASH_TOL (the fused kernel adds dq tiles into its f32 workspace by
    bulk reduce-adds, in another order)."""
    args = _split_inputs(hq, hkv, d, sq, sk, torch.bfloat16, causal,
                         cuda_device)
    split = (flash_attention_bwd_dq(*args, causal),
             *flash_attention_bwd_dkv(*args, causal))
    fused = flash_attention_bwd_fused(*args, causal)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), split, fused):
        assert _rel_err(a, b) <= FLASH_TOL[torch.bfloat16], name


@pytest.mark.parametrize("hq,hkv,sq,route", [
    (1, 1, 16384, "fused"), (1, 1, 16512, "split"),
    (4, 1, 4096, "fused"), (4, 1, 4224, "split")])
def test_flash_bwd_router_takes_split_above_8_mib(cuda_device, hq, hkv, sq,
                                                  route):
    """The router by the launch counters, on both sides of the fused
    kernel's 8 MiB dq scratch (head_dim 128)."""
    q, k, v, do = _flash_inputs(hq, hkv, 128, sq, sq, torch.bfloat16,
                                cuda_device, b=1)
    o, lse = flash_attention_fwd(q, k, v, True)
    kernels.reset_launch_counts()
    flash_attention_bwd(q, k, v, o, lse, do, True)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    split = int(route == "split")
    assert (counts["flash_attention_bwd"], counts["flash_attention_bwd_dq"],
            counts["flash_attention_bwd_dkv"]) == (1 - split, split, split)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_takes_plain_above_256_by_the_reference_rule(
        cuda_device, dtype):
    """At head_dim 320 the reference takes XLA's plain attention
    (``_use_pallas``: d <= 256); flash_attention takes the plain version,
    with gradients, and launches no kernel. At 256 it launches both."""
    for d, launches in ((320, 0), (256, 1)):
        assert fwd_route(d) == ("plain" if d > 256 else "kernel")
        q, k, v, do = _flash_inputs(4, 2, d, 130, 130, dtype, cuda_device,
                                    b=1)
        q4, k4, v4, do4 = (from_bh(t, 1).detach().requires_grad_()
                           for t in (q, k, v, do))
        kernels.reset_launch_counts()
        o = flash_attention(q4, k4, v4, causal=True)
        grads = torch.autograd.grad(o, (q4, k4, v4), do4)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert (counts["flash_attention_fwd"],
                counts["flash_attention_bwd"]) == (launches, launches)
        ro, _ = flash_attention_fwd_plain(q, k, v, True)
        assert _rel_err(to_bh(o), ro) <= FLASH_TOL[dtype]
        assert all(torch.isfinite(g.float()).all() for g in grads)


#: f32: summation order over M; bf16: the output rounding (2^-8) and
#: products rounded from f32 values that differ in their last bits
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("rows,m,h", [
    (200, 256, 128), (256, 384, 256),
    # the bf16 kernel's tile edges: 128 x 256 output tiles, k steps of 64
    (200, 5504, 128), (6144 + 37, 5504, 384), (200, 288, 384)])
def test_swiglu_down_kernel_matches_plain(cuda_device, dtype, tol, rows, m,
                                          h):
    g = torch.Generator().manual_seed(rows + m)
    gate = torch.randn(rows, m, generator=g).to(cuda_device, dtype)
    up = torch.randn(rows, m, generator=g).to(cuda_device, dtype)
    wd = (0.05 * torch.randn(m, h, generator=g)).to(cuda_device, dtype)
    kernels.reset_launch_counts()
    out = swiglu_down_fwd(gate, up, wd)
    want = swiglu_down_plain(gate, up, wd)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["swiglu_down"] == 1
    assert _rel_err(out, want) <= tol


def test_training_kernels_reject_what_they_do_not_take(cuda_device):
    q, k, v, do = _flash_inputs(2, 2, 64, 64, 64, torch.float16,
                                cuda_device)
    with pytest.raises(TypeError):
        flash_attention_fwd(q, k, v, True)
    q, k, v, do = _flash_inputs(2, 2, 320, 64, 64, torch.float32,
                                cuda_device)
    with pytest.raises(ValueError):
        flash_attention_fwd(q, k, v, True)
    q, k, v, do = _flash_inputs(2, 2, 64, 64, 64, torch.float32,
                                cuda_device)
    with pytest.raises(TypeError):
        flash_attention_bwd(q, k, v, q, torch.zeros(4, 64, device=q.device),
                            do.bfloat16(), True)
    lse = torch.zeros(4, 64, device=q.device)
    with pytest.raises(ValueError):
        flash_attention_bwd_dq(q, k, v, do, lse, lse[:, :32], True)
    with pytest.raises(ValueError):
        flash_attention_bwd_dkv(q, k, v, do, lse.double(), lse, True)
    x = torch.ones(2, 8193, device=cuda_device)
    with pytest.raises(ValueError):
        rms_norm_fwd(x, torch.ones(8193, device=cuda_device))
    with pytest.raises(TypeError):
        rms_norm_fwd(x[:, :16].half(), torch.ones(16, device=cuda_device))
    gate = torch.randn(64, 48, device=cuda_device)
    with pytest.raises(ValueError):
        swiglu_down_fwd(gate, gate, torch.randn(48, 128,
                                                device=cuda_device))
    with pytest.raises(TypeError):
        swiglu_down_fwd(gate.half(), gate.half(),
                        torch.randn(48, 128, device=cuda_device).half())


def test_train_steps_on_card_match_cpu_and_count_launches(cuda_device):
    """Depth 2, GQA, head_dim 64, f32: three AdamW(factored) TrainSteps on
    the card (kernels) against the same three on the CPU (plain
    versions). f32 on both: sums run in other orders, and the dq atomics
    in an order that changes from run to run, so losses agree to 1e-4
    and step-1 gradients to 5e-4 of each leaf's norm."""
    cfg = GPTConfig(vocab_size=1024, hidden_size=256, num_layers=2,
                    num_heads=4, num_kv_heads=2, max_seq_len=256,
                    recompute=True)
    cpu = GPTForCausalLMPipe(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(0), std=0.05)
    gpu = GPTForCausalLMPipe(cfg, device=cuda_device)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, 1024, (2, 200)))
    labels = torch.as_tensor(rng.integers(0, 1024, (2, 200)))
    out = {}
    for model in (cpu, gpu):
        dev = model.device
        # the same head on both: f32 logits (the card's default is int8)
        step = TrainStep(model, functools.partial(model.loss, int8=False),
                         AdamW(model.parameters(), lr=1e-3, factored=True))
        kernels.reset_launch_counts()
        losses = [step(ids.to(dev), labels.to(dev)).item()]
        counts = kernels.launch_counts()
        grads = {n: p.grad.float().cpu() for n, p in model.named_parameters()}
        losses += [step(ids.to(dev), labels.to(dev)).item() for _ in range(2)]
        out[dev.type] = (losses, grads, counts)
    L = cfg.num_layers
    assert out["cpu"][2] == {k: 0 for k in out["cpu"][2]}
    assert out["cuda"][2] == {"paged_attention": 0, "rms_norm": 4 * L,
                              "flash_attention_fwd": 2 * L,
                              "flash_attention_bwd": L, "swiglu_down": 2 * L,
                              "paged_attention_int8": 0,
                              "decode_attention": 0, "add_rms_norm": 0,
                              "flash_attention_bwd_dq": 0,
                              "flash_attention_bwd_dkv": 0}
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    for n, g in out["cpu"][1].items():
        err = (out["cuda"][1][n] - g).norm() / g.norm()
        assert err.item() <= 5e-4, n


def test_selective_remat_on_card_matches_cpu_and_launches_fwd_once(
        cuda_device):
    """Depth 2, f32, under the long-context names: policy: one TrainStep on
    the card against the CPU, with the flash forward launched once per
    block (its o and lse are kept), the FFN and the norms recomputed."""
    cfg = GPTConfig(vocab_size=1024, hidden_size=256, num_layers=2,
                    num_heads=4, max_seq_len=256, recompute=True,
                    recompute_policy="names:attn_res,attn_lse,attn_q,attn_k,"
                                     "attn_v,resid_mid")
    cpu = GPTForCausalLMPipe(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(1), std=0.05)
    gpu = GPTForCausalLMPipe(cfg, device=cuda_device)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    ids = torch.as_tensor(rng.integers(0, 1024, (1, 256)))
    out = {}
    for model in (cpu, gpu):
        dev = model.device
        step = TrainStep(model, functools.partial(model.loss, int8=False),
                         AdamW(model.parameters(), lr=3e-4))
        kernels.reset_launch_counts()
        loss = step(ids.to(dev), ids.to(dev)).item()
        out[dev.type] = (loss, kernels.launch_counts(),
                         {n: p.grad.float().cpu()
                          for n, p in model.named_parameters()})
    L = cfg.num_layers
    counts = out["cuda"][1]
    assert (counts["flash_attention_fwd"], counts["flash_attention_bwd"],
            counts["swiglu_down"], counts["rms_norm"]) == (L, L, 2 * L, 4 * L)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    for n, g in out["cpu"][2].items():
        assert ((out["cuda"][2][n] - g).norm() / g.norm()).item() <= 5e-4, n


def _guard_model(device, seed):
    cfg = GPTConfig(vocab_size=1024, hidden_size=256, num_layers=2,
                    num_heads=4, max_seq_len=256, recompute=True,
                    dtype="bfloat16")
    gen = torch.Generator(device=device).manual_seed(seed)
    return GPTForCausalLMPipe(cfg, device=device,
                              dtype=torch.bfloat16).init_weights(gen,
                                                                 std=0.05)


def _state_bytes(model, opt):
    out = {n: p.detach().reshape(-1).view(torch.uint8).to("cpu", copy=True)
           for n, p in model.named_parameters()}
    for n, p in model.named_parameters():
        for k, v in opt.state.get(p, {}).items():
            out[f"{n}.{k}"] = v.reshape(-1).view(torch.uint8).to("cpu",
                                                                 copy=True)
    return out


GUARD_OPTS = {
    "adamw-factored-decay_fun-clip": lambda P: AdamW(
        P, lr=1e-3, factored=True, grad_clip=ClipGradByGlobalNorm(1.0),
        apply_decay_param_fun=lambda n: "ln" not in n and "norm" not in n),
    "adamw-multi_precision-amsgrad": lambda P: AdamW(
        P, lr=1e-3, multi_precision=True, amsgrad=True),
    "adam-int8": lambda P: Adam(P, lr=1e-3, moment_dtype="int8"),
}


@pytest.mark.parametrize("name", list(GUARD_OPTS))
def test_guarded_step_on_card_keeps_every_byte_on_nan(cuda_device, name):
    """A two-layer bf16 Pipe on the card: one clean step, then an armed
    step with NaN gradients leaves every parameter and slot byte (moments,
    factored statistics, int8 codes and scales, beta powers, master
    weights) unchanged; the next armed clean step updates."""
    model = _guard_model(cuda_device, 0)
    opt = GUARD_OPTS[name](model.named_parameters())
    step = TrainStep(model, model.loss, opt)
    rng = np.random.default_rng(2)
    ids = torch.as_tensor(rng.integers(0, 1024, (2, 256)),
                          device=cuda_device)
    step(ids, ids)
    assert step.last_health.ok
    before = _state_bytes(model, opt)
    step._guard_threshold = float("inf")
    with chaos.inject_nonfinite(step._call_index + 1):
        step(ids, ids)
    assert not step.last_health.ok and not step.last_health.finite
    after = _state_bytes(model, opt)
    for k in before:
        assert torch.equal(before[k], after[k]), k
    step(ids, ids)
    assert step.last_health.ok
    moved = _state_bytes(model, opt)
    assert not torch.equal(moved["decoder.wq"], before["decoder.wq"])


def test_checkpoint_round_trip_of_cuda_tensors_is_bitwise(cuda_device,
                                                          tmp_path):
    """An async save of a CUDA model and optimizer, the live tensors
    changed in place right after; restoring into a fresh model and into
    the changed one gives the saved bytes, on the same CUDA tensors."""
    model = _guard_model(cuda_device, 1)
    opt = GUARD_OPTS["adamw-factored-decay_fun-clip"](
        model.named_parameters())
    step = TrainStep(model, model.loss, opt)
    ids = torch.as_tensor(np.random.default_rng(3).integers(0, 1024,
                                                            (2, 256)),
                          device=cuda_device)
    step(ids, ids)
    saved = _state_bytes(model, opt)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save_training_state(1, model, opt, async_save=True)
    step(ids, ids)                         # training goes on, in place
    mgr.wait()
    fresh = _guard_model(cuda_device, 2)
    fresh_opt = GUARD_OPTS["adamw-factored-decay_fun-clip"](
        fresh.named_parameters())
    ptrs = [p.data_ptr() for p in model.parameters()]
    for m, o in ((fresh, fresh_opt), (model, opt)):
        assert mgr.restore_training_state(m, o) == 1
        got = _state_bytes(m, o)
        assert got.keys() == saved.keys()
        for k in saved:
            assert torch.equal(got[k], saved[k]), k
        assert all(p.device.type == cuda_device.type for p in m.parameters())
    assert [p.data_ptr() for p in model.parameters()] == ptrs



# ------------------------------------------------- low-precision training
@pytest.mark.parametrize("dtype", ["fp8", "int8"])
@pytest.mark.parametrize("in_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("m,k,n", [(6144, 2048, 2048), (6144, 2048, 5504),
                                   (77, 100, 40)],
                         ids=["config4-attn", "config4-ffn", "padded-k100"])
def test_scaled_gemm_on_card_matches_the_plain_route(cuda_device, monkeypatch,
                                                     dtype, in_dtype, m, k,
                                                     n):
    """The card's narrow GEMM (``torch._scaled_mm`` for fp8, K and N
    padded to multiples of 16; ``torch._int_mm`` for int8) against the
    CPU's plain route on the same operands and histories, forward and the
    wide backward. The codes and scales are the same on both devices; the
    f32 sums run in other orders (f32: 1e-5 of the largest magnitude;
    bf16 out: one bf16 rounding, 2**-7 of it). Hopper's fp8 tensor cores
    keep their partial sums at about 14 bits between the f32 promotions
    that ``use_fast_accum=False`` asks for: the fp8 forward in f32 is
    held to 1e-3 of its largest magnitude (measured 2.0e-4 to 2.4e-4 on
    an H100 80GB HBM3 at 700 W)."""
    from paddle_tpu_torch.quant import gemm as qg

    calls = []
    real = torch._scaled_mm
    monkeypatch.setattr(torch, "_scaled_mm",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    g = torch.Generator().manual_seed(0)
    x = torch.randn(m, k, generator=g).to(in_dtype)
    w = (torch.randn(k, n, generator=g) * 0.02).to(in_dtype)
    gy = torch.randn(m, n, generator=g).to(in_dtype)
    hist = torch.tensor([0.0, 2.0 * float(x.abs().max()), 0.0, 0.0])
    out = {}
    for dev in ("cpu", cuda_device):
        xx = x.to(dev).requires_grad_()
        ww = w.to(dev).requires_grad_()
        h = hist.to(dev)
        y, nhx, nhw = qg.scaled_gemm(xx, ww, h, torch.zeros_like(h),
                                     dtype=dtype)
        dx, dw = torch.autograd.grad(y, (xx, ww), gy.to(dev))
        out[torch.device(dev).type] = [t.float().cpu() for t in
                                       (y, dx, dw, nhx, nhw)]
    assert len(calls) == (1 if dtype == "fp8" else 0)
    rel = 1e-5 if in_dtype == torch.float32 else 2.0 ** -7
    fwd_rel = 1e-3 if (dtype, in_dtype) == ("fp8", torch.float32) else rel
    for got, want, r in zip(out["cuda"][:3], out["cpu"][:3],
                            (fwd_rel, rel, rel)):
        err = ((got - want).abs().max() / want.abs().max()).item()
        print(f"{dtype} {in_dtype} [{m},{k}]x[{k},{n}]: {err:.3g} (tol {r})")
        assert err <= r
    assert torch.equal(out["cuda"][3], out["cpu"][3])
    assert torch.equal(out["cuda"][4], out["cpu"][4])


def test_int8_head_on_card_matches_the_cpu(cuda_device):
    """The int8 LM head (``torch._int_mm`` logits over in-loop quantized
    vocab chunks, straight-through backward) on the card against the
    CPU's at a config-4 width: the codes, scales and int32 sums are the
    same; the softmax and the f32 contractions sum in other orders
    (1e-5). The card's default head is int8 behind its gate."""
    from paddle_tpu_torch.nn.functional import (chunked_lm_loss_arrays,
                                                int8_head_enabled)

    assert int8_head_enabled(cuda_device)
    g = torch.Generator().manual_seed(1)
    h = torch.randn(512, 2048, generator=g)
    w = torch.randn(32000, 2048, generator=g) * 0.02
    y = torch.randint(0, 32000, (512,), generator=g)
    y[:5] = -100
    out = {}
    for dev in ("cpu", cuda_device):
        hh = h.to(dev).requires_grad_()
        ww = w.to(dev).requires_grad_()
        loss = chunked_lm_loss_arrays(hh, ww, y.to(dev), int8=True)
        gh, gw = torch.autograd.grad(loss, (hh, ww))
        out[torch.device(dev).type] = (loss.item(), gh.cpu(), gw.cpu())
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for i in (1, 2):
        want = out["cpu"][i]
        assert ((out["cuda"][i] - want).norm() / want.norm()).item() <= 1e-5


def test_quantized_step_on_card_matches_cpu(cuda_device):
    """Depth 2, f32, ``quant:all`` over the r5 saves: one TrainStep on the
    card against the CPU from the same weights, the head pinned to f32:
    loss, gradients, the new amax histories (``wd`` wide: swiglu_down owns
    it) and the launches (the flash forward once a block). The card's fp8
    GEMMs keep about 14 bits of their partial sums between f32 promotions
    (2e-4 of a product's magnitude), which moves values across e4m3
    rounding boundaries: each such code moves by an e4m3 step (up to 1/8
    of the value), so the step is held as a quantized one is: loss 1e-3,
    gradients 1e-1 of each leaf's norm, histories 2e-2 (measured on an
    H100 80GB HBM3 at 700 W: loss 2.4e-4, gradients 3.2e-2, histories
    5.9e-3)."""
    from paddle_tpu_torch.quant import GEMM_SITES

    cfg = GPTConfig(vocab_size=1024, hidden_size=256, num_layers=2,
                    num_heads=4, max_seq_len=256, recompute=True,
                    recompute_policy="names:attn_res,attn_lse,attn_q,attn_k,"
                                     "attn_v,rms_rstd,resid_mid,ffn_gate,"
                                     "ffn_up,quant:all")
    cpu = GPTForCausalLMPipe(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(2), std=0.05)
    gpu = GPTForCausalLMPipe(cfg, device=cuda_device)
    gpu.load_state_dict(cpu.state_dict())
    ids = torch.as_tensor(np.random.default_rng(2).integers(0, 1024,
                                                            (2, 256)))
    out = {}
    for model in (cpu, gpu):
        dev = model.device
        step = TrainStep(model, functools.partial(model.loss, int8=False),
                         AdamW(model.parameters(), lr=1e-3))
        kernels.reset_launch_counts()
        loss = step(ids.to(dev), ids.to(dev)).item()
        out[dev.type] = (loss, kernels.launch_counts(),
                         {n: p.grad.float().cpu()
                          for n, p in model.named_parameters()},
                         model.decoder.quant_amax.cpu())
    L = cfg.num_layers
    c = out["cuda"][1]
    assert (c["flash_attention_fwd"], c["flash_attention_bwd"],
            c["swiglu_down"], c["rms_norm"]) == (L, L, 2 * L, 4 * L)
    loss_err = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    grad_err = {n: ((out["cuda"][2][n] - g).norm() / g.norm()).item()
                for n, g in out["cpu"][2].items()}
    amax = out["cuda"][3]
    amax_err = ((amax - out["cpu"][3]).abs().max()
                / out["cpu"][3].abs().max()).item()
    print(f"quantized step card vs cpu: loss {loss_err:.3g}, grads "
          f"{max(grad_err.values()):.3g}, amax {amax_err:.3g}")
    assert loss_err <= 1e-3
    assert max(grad_err.values()) <= 1e-1, grad_err
    assert amax_err <= 2e-2
    wd = GEMM_SITES.index("wd")
    assert bool((amax[:, :wd, :, 0] > 0).all()) and not amax[:, wd].any()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_per_layer_attention_launches_flash_and_matches_cpu(cuda_device,
                                                            dtype, tol):
    """The per-layer ``Attention`` (GQA 8/2, rope) launches the flash
    forward and backward on CUDA tensors and matches its CPU plain route;
    a masked call takes the plain masked attention and launches none."""
    from paddle_tpu_torch.models.gpt import Attention

    cfg = GPTConfig(hidden_size=512, num_heads=8, num_kv_heads=2)
    cpu = Attention(cfg, device="cpu", dtype=dtype)
    with torch.no_grad():
        for p in cpu.parameters():
            p.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(0))
    gpu = Attention(cfg, device=cuda_device, dtype=dtype)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 256, 512, generator=torch.Generator().manual_seed(1))
    out = {}
    for mod in (cpu, gpu):
        dev = mod.q_proj.weight.device
        xi = x.to(dev, dtype, copy=True).requires_grad_()
        kernels.reset_launch_counts()
        y = mod(xi)
        y.float().square().mean().backward()
        counts = kernels.launch_counts()
        out[dev.type] = (y.float().cpu(), xi.grad.float().cpu(), counts)
    assert out["cpu"][2] == {k: 0 for k in out["cpu"][2]}
    assert out["cuda"][2]["flash_attention_fwd"] == 1
    assert (out["cuda"][2]["flash_attention_bwd"]
            + out["cuda"][2]["flash_attention_bwd_dq"]) == 1
    for i in (0, 1):
        want = out["cpu"][i]
        assert ((out["cuda"][i] - want).norm() / want.norm()).item() <= tol
    kernels.reset_launch_counts()
    with torch.no_grad():
        gpu(x.to(cuda_device, dtype), torch.ones(256, 256, dtype=torch.bool,
                                                 device=cuda_device))
    assert kernels.launch_counts()["flash_attention_fwd"] == 0


@pytest.mark.parametrize("seam,grad_tol", [("fused_addrms", 5e-4),
                                           ("int8_ffn", 2e-3)])
def test_pipe_seams_on_card_count_launches_and_match_cpu(cuda_device, seam,
                                                         grad_tol):
    """Depth 2, f32, full recompute: one TrainStep with the attn->norm seam
    (add_rms_norm 2L, rms_norm 2L: the seam takes each block's second
    norm) or the int8-saved FFN (swiglu_down 0) on the card against the
    CPU. Under int8_ffn the two devices' gate and up differ in their last
    bits, which can move an int8 code by one step, hence its bound."""
    cfg = GPTConfig(vocab_size=1024, hidden_size=256, num_layers=2,
                    num_heads=4, num_kv_heads=2, max_seq_len=256,
                    recompute=True, **{seam: True})
    cpu = GPTForCausalLMPipe(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(0), std=0.05)
    gpu = GPTForCausalLMPipe(cfg, device=cuda_device)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, 1024, (2, 200)))
    labels = torch.as_tensor(rng.integers(0, 1024, (2, 200)))
    out = {}
    for model in (cpu, gpu):
        dev = model.device
        step = TrainStep(model, functools.partial(model.loss, int8=False),
                         AdamW(model.parameters(), lr=1e-3, factored=True))
        kernels.reset_launch_counts()
        loss = step(ids.to(dev), labels.to(dev)).item()
        out[dev.type] = (loss, {n: p.grad.float().cpu()
                                for n, p in model.named_parameters()},
                         kernels.launch_counts())
    L = cfg.num_layers
    addrms = seam == "fused_addrms"
    want = {"flash_attention_fwd": 2 * L, "flash_attention_bwd": L,
            "add_rms_norm": 2 * L if addrms else 0,
            "rms_norm": 2 * L if addrms else 4 * L,
            "swiglu_down": 2 * L if addrms else 0}
    assert {k: out["cuda"][2][k] for k in want} == want
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    for n, g in out["cpu"][1].items():
        err = (out["cuda"][1][n] - g).norm() / g.norm()
        assert err.item() <= grad_tol, n


def test_moe_decoder_on_card_matches_cpu(cuda_device):
    """A two-layer GPTForCausalLMMoE (gshard, top 2, 8 experts), f32: the
    loss and its gradients on the card against the CPU, the attention on
    the flash kernels."""
    from paddle_tpu_torch.models.gpt import GPTForCausalLMMoE

    cfg = GPTConfig(vocab_size=512, hidden_size=256, num_layers=2,
                    num_heads=4, max_seq_len=256, intermediate_size=512)
    torch.manual_seed(0)
    cpu = GPTForCausalLMMoE(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(0), std=0.05)
    gpu = GPTForCausalLMMoE(cfg, device=cuda_device)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    ids = torch.as_tensor(rng.integers(0, 512, (2, 128)))
    out = {}
    for model in (cpu, gpu):
        dev = model.device
        kernels.reset_launch_counts()
        loss = model.loss(ids.to(dev), ids.to(dev))
        loss.backward()
        out[dev.type] = (loss.item(), {n: p.grad.float().cpu()
                                       for n, p in model.named_parameters()},
                         kernels.launch_counts())
    assert out["cuda"][2]["flash_attention_fwd"] == cfg.num_layers
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    for n, g in out["cpu"][1].items():
        err = (out["cuda"][1][n] - g).norm() / g.norm().clamp_min(1e-30)
        assert err.item() <= 5e-4, n


# ------------------------------------ the shared block, the incubate surface
@pytest.mark.parametrize("case", ["full", "names", "fused_addrms"])
def test_per_layer_shared_block_launches_and_matches_cpu(cuda_device, case):
    """Depth 2, f32: a per-layer LLaMA-family GPTForCausalLM runs its
    layers through the shared block, so one TrainStep launches what the
    Pipe's block does (flash fwd 2L, or L under the names: policy that
    keeps the flash outputs; bwd L; swiglu_down 2L; rms_norm 4L + 1, the
    final norm being the kernel's; 2L + 1 and add_rms_norm 2L under the
    seam), with the loss and gradients of the same step on the CPU."""
    from paddle_tpu_torch.models.gpt import GPTForCausalLM

    opts = {"full": {}, "fused_addrms": {"fused_addrms": True},
            "names": {"recompute_policy": "names:attn_res,attn_lse,attn_q,"
                                          "attn_k,attn_v,resid_mid"}}[case]
    cfg = GPTConfig(vocab_size=1024, hidden_size=256, num_layers=2,
                    num_heads=4, num_kv_heads=2, max_seq_len=256,
                    recompute=True, **opts)
    cpu = GPTForCausalLM(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(0), std=0.05)
    gpu = GPTForCausalLM(cfg, device=cuda_device)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, 1024, (2, 200)))
    labels = torch.as_tensor(rng.integers(0, 1024, (2, 200)))
    out = {}
    for model in (cpu, gpu):
        dev = model.device
        step = TrainStep(model, functools.partial(model.loss, int8=False),
                         AdamW(model.parameters(), lr=1e-3, factored=True))
        kernels.reset_launch_counts()
        loss = step(ids.to(dev), labels.to(dev)).item()
        out[dev.type] = (loss, {n: p.grad.float().cpu()
                                for n, p in model.named_parameters()},
                         kernels.launch_counts())
    L = cfg.num_layers
    addrms = case == "fused_addrms"
    want = {"flash_attention_fwd": L if case == "names" else 2 * L,
            "flash_attention_bwd": L, "swiglu_down": 2 * L,
            "rms_norm": (2 if addrms else 4) * L + 1,
            "add_rms_norm": 2 * L if addrms else 0}
    assert {k: out["cuda"][2][k] for k in want} == want
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    for n, g in out["cpu"][1].items():
        err = (out["cuda"][1][n] - g).norm() / g.norm()
        assert err.item() <= 5e-4, n


@pytest.mark.parametrize("d", EXACT_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_reads_a_page_major_cache_bit_for_bit(cuda_device,
                                                              dtype, d):
    """The paged kernel over the transposed view of a page-major
    ``[P, Hkv, page, D]`` cache (head and page strides as launch
    arguments) gives the bits it gives over the contiguous copy, at rep 1,
    4 and 8 and pages of 16 and 64."""
    g = torch.Generator().manual_seed(d)
    for rep, page in ((1, 16), (4, 64), (8, 16)):
        hkv, b, pps = 2, 3, 5
        num_pages = b * pps + 2
        cache = [torch.randn(num_pages, hkv, page, d, generator=g).to(
            cuda_device, dtype) for _ in range(2)]
        q = torch.randn(b, hkv * rep, d, generator=g).to(cuda_device, dtype)
        tables = torch.randperm(num_pages, generator=g)[:b * pps].reshape(
            b, pps).to(cuda_device, torch.int32)
        lens = torch.tensor([1, page * pps, page * 2 + 3], dtype=torch.int32,
                            device=cuda_device)
        views = [c.transpose(0, 1) for c in cache]
        assert not views[0].is_contiguous()
        kernels.reset_launch_counts()
        got = paged_attention(q, *views, tables, lens)
        want = paged_attention(q, *(v.contiguous() for v in views), tables,
                               lens)
        assert kernels.launch_counts()["paged_attention"] == 2
        assert torch.equal(got, want), (rep, page)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_block_multihead_attention_decode_on_card_matches_cpu(cuda_device,
                                                              dtype, tol):
    """A prefill then two decode steps of block_multihead_attention (GQA
    8/2, D 128, pages of 64 scattered, rope from a table, slot 1 finished
    at the second step) on the card against its CPU route: each decode
    step is one paged_attention launch, the outputs within the kernel's
    tolerance, the caches written in place."""
    g = torch.Generator().manual_seed(0)
    hq, hkv, d, page, b = 8, 2, 128, 64, 3
    width = (hq + 2 * hkv) * d
    cache = torch.zeros(16, hkv, page, d)
    tables = torch.randperm(16, generator=g)[:12].reshape(b, 4).int()
    ang = torch.rand(b, 256, 1, d // 2, generator=g) * 3
    rope = torch.stack([ang.cos(), ang.sin()])
    dev = {"cpu": [cache.clone().to(dtype), cache.clone().to(dtype)],
           "cuda": [cache.to(cuda_device, dtype),
                    cache.to(cuda_device, dtype)]}
    lens = np.array([100, 40, 130])
    steps = [(lens, np.zeros(b, int)), (np.ones(b, int), lens),
             (np.array([1, 0, 1]), lens + 1)]
    for i, (this, dec) in enumerate(steps):
        qkv = torch.randn(int(this.sum()), width, generator=g).to(dtype)
        enc = np.where(dec == 0, this, 0)
        outs = {}
        for name, (kc, vc) in dev.items():
            at = cuda_device if name == "cuda" else "cpu"
            kernels.reset_launch_counts()
            out, _, kc2, vc2 = TF.block_multihead_attention(
                qkv.to(at), kc, vc,
                *(torch.as_tensor(a, dtype=torch.int32)[:, None]
                  for a in (enc, dec, this)),
                None, None, None, None, tables.to(at),
                rope_emb=rope.to(at), use_neox_style=True)
            assert kc2 is kc and vc2 is vc
            outs[name] = (out.float().cpu(), kernels.launch_counts())
        assert outs["cuda"][1]["paged_attention"] == (i > 0)
        err = (outs["cuda"][0] - outs["cpu"][0]).abs().max().item()
        assert err <= tol * outs["cpu"][0].abs().max().item(), i
        for c_gpu, c_cpu in zip(dev["cuda"], dev["cpu"]):
            torch.testing.assert_close(c_gpu.cpu(), c_cpu, atol=tol,
                                       rtol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_fused_multi_head_attention_on_card_matches_the_plain_route(
        cuda_device, dtype, tol):
    """FusedMultiHeadAttention (E 512, 4 heads of 128, seq 256) in
    training at dropout 0: the non-causal flash forward and backward
    launch once each, and the output and every gradient agree with the
    same module through the plain attention (an all-True mask), and in f32
    with the CPU's (a bf16 CPU run rounds its LayerNorm and GEMMs in other
    places)."""
    from paddle_tpu_torch.incubate.nn import FusedMultiHeadAttention

    cpu = FusedMultiHeadAttention(512, 4, dropout_rate=0.0,
                                  attn_dropout_rate=0.0,
                                  normalize_before=True, device="cpu")
    with torch.no_grad():
        for p in cpu.parameters():
            p.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(1))
    gpu = FusedMultiHeadAttention(512, 4, dropout_rate=0.0,
                                  attn_dropout_rate=0.0,
                                  normalize_before=True, device=cuda_device,
                                  dtype=dtype)
    gpu.load_state_dict(cpu.state_dict())
    cpu.to(dtype)
    x = torch.randn(2, 256, 512, generator=torch.Generator().manual_seed(2))
    every = torch.ones(256, 256, dtype=torch.bool)
    runs = {}
    for tag, mod, mask in (("flash", gpu, None),
                           ("plain", gpu, every.to(cuda_device)),
                           ("cpu", cpu, None)):
        mod.zero_grad()
        xi = x.to(mod.qkv_weight.device, dtype)
        kernels.reset_launch_counts()
        y = mod(xi, attn_mask=mask)
        y.float().square().mean().backward()
        runs[tag] = (y.float().cpu(),
                     {n: p.grad.float().cpu()
                      for n, p in mod.named_parameters()
                      if p.grad is not None}, kernels.launch_counts())
    counts = runs["flash"][2]
    assert counts["flash_attention_fwd"] == 1
    assert counts["flash_attention_bwd"] + counts["flash_attention_bwd_dq"] \
        == 1
    assert runs["plain"][2]["flash_attention_fwd"] == 0
    for other in ("plain", "cpu") if dtype == torch.float32 else ("plain",):
        want = runs[other]
        assert ((runs["flash"][0] - want[0]).norm()
                / want[0].norm()).item() <= tol
        for n, g in want[1].items():
            err = (runs["flash"][1][n] - g).norm() / g.norm().clamp_min(
                1e-30)
            assert err.item() <= tol, (other, n)


# -- the Paddle surface (import paddle_tpu_torch as paddle) -------------------
@pytest.fixture
def surface(cuda_device):
    """``paddle_tpu_torch`` with no place chosen yet; restored after."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import device as pdevice

    prev = (getattr(pdevice._state, "device", None),
            getattr(pdevice._state, "place", None))
    pdevice._state.device = pdevice._state.place = None
    yield paddle
    pdevice._state.device, pdevice._state.place = prev


def test_surface_tensor_lands_on_the_card(surface):
    paddle = surface
    t = paddle.ones([2, 3])
    assert t.place == paddle.CUDAPlace(0) and t._data.is_cuda
    assert paddle.to_tensor(np.arange(3)).place.is_gpu_place()
    assert paddle.get_device() == "gpu:0"
    assert paddle.nn.Linear(4, 2).weight._data.is_cuda


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("hk,causal", [(4, False), (2, True)])
def test_surface_sdpa_launches_flash_and_matches_cpu(surface, dtype, tol, hk,
                                                     causal):
    """F.scaled_dot_product_attention on CUDA tensors launches the flash
    forward and backward once each, and its output and gradients match the
    CPU route's (the kernels' plain versions)."""
    paddle = surface
    rng = np.random.RandomState(0)
    arrays = [rng.randn(2, 128, h, 64).astype(np.float32)
              for h in (4, hk, hk)]
    res = {}
    for place in ("cpu", "gpu"):
        paddle.set_device(place)
        ts = [paddle.to_tensor(a).astype(dtype) for a in arrays]
        for t in ts:
            t.stop_gradient = False
        kernels.reset_launch_counts()
        out = paddle.nn.functional.scaled_dot_product_attention(
            *ts, is_causal=causal)
        (out.astype("float32") ** 2).sum().backward()
        counts = kernels.launch_counts()
        res[place] = [out.numpy()] + [t.grad.numpy() for t in ts]
        if place == "gpu":
            assert counts["flash_attention_fwd"] == 1
            assert counts["flash_attention_bwd"] == 1
            assert sum(counts.values()) == 2
    for a, b in zip(res["cpu"], res["gpu"]):
        assert np.abs(b - a).max() <= tol * max(np.abs(a).max(), 1e-6)


def test_surface_bert_depth2_on_card_matches_cpu(surface):
    """BERT at depth 2, f32: the card's loss and step-1 gradients against
    the CPU's on the same weights (phase 7's bounds: loss 1e-4 relative,
    each leaf's gradient norm 5e-4, the zero-gradient key biases against
    1e-4 of the largest leaf's norm)."""
    from paddle_tpu_torch.models import BertForPretraining, bert_base

    paddle = surface
    cfg = bert_base(vocab_size=1024, num_layers=2, dropout=0.0)
    rng = np.random.RandomState(2)
    ids = rng.randint(0, 1024, (2, 128))
    labels = np.where(rng.rand(2, 128) < 0.15, rng.randint(0, 1024, (2, 128)),
                      -100)
    nsp = rng.randint(0, 2, (2,))
    got = {}
    for place in ("cpu", "gpu"):
        paddle.set_device(place)
        paddle.seed(4)
        m = BertForPretraining(cfg)
        if got:
            m.set_state_dict(got["cpu"][2])
        kernels.reset_launch_counts()
        loss = m.loss(*(paddle.to_tensor(a) for a in (ids, labels, nsp)))
        loss.backward()
        if place == "gpu":
            counts = kernels.launch_counts()
            assert counts["flash_attention_fwd"] == 2
            assert counts["flash_attention_bwd"] == 2
        got[place] = (float(loss),
                      {n: q.grad.numpy() for n, q in m.named_parameters()
                       if q.grad is not None}, m.state_dict())
    assert abs(got["gpu"][0] - got["cpu"][0]) <= 1e-4 * abs(got["cpu"][0])
    top = max(np.linalg.norm(g) for g in got["cpu"][1].values())
    for n, g in got["cpu"][1].items():
        denom = max(np.linalg.norm(g), 1e-4 * top)
        assert np.linalg.norm(got["gpu"][1][n] - g) <= 5e-4 * denom, n


def test_surface_bfloat16_keeps_parameters_live(surface):
    """``model.bfloat16()`` on the card keeps ``parameters()`` naming the
    live tensors: an optimizer made after it updates what the model
    reads."""
    paddle = surface
    net = paddle.nn.Sequential(paddle.nn.Linear(64, 32),
                               paddle.nn.LayerNorm(32))
    params = net.parameters()
    net.bfloat16()
    assert [q for q in net.parameters()] == params
    assert all(q._data.is_cuda and q.dtype == paddle.bfloat16
               for q in params)
    opt = paddle.optimizer.AdamW(learning_rate=1e-2, parameters=params,
                                 multi_precision=True)
    before = [q.numpy().copy() for q in params]
    x = paddle.randn([8, 64]).astype("bfloat16")
    opt.minimize(net(x).astype("float32").square().mean())
    assert all(np.abs(q.numpy() - b).max() > 0
               for q, b in zip(params, before))
    assert all(q.grad is None for q in params)


# -- the vision path (conv, pooling, io, hapi, vision) ------------------------
def test_vision_card_vs_cpu(surface):
    """chip_smoke's part (e): LeNet and resnet18 one f32 train step and the
    conv and pooling functionals on the card against the CPU (TF32 off),
    the pooling mask bit for bit."""
    from chip_smoke import _vision_card_vs_cpu

    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        res = _vision_card_vs_cpu(surface, "gpu")
    assert res["functionals"]["max_pool2d_mask"] == 0.0
    assert res["resnet18"]["loss_rel"] <= 1e-4


def _vision_dataset(paddle):
    class DS(paddle.io.Dataset):
        def __getitem__(self, i):
            # a transform's to_tensor: in a forked worker it must land on
            # the CPU, where the child can make it
            return (paddle.to_tensor(np.full((3, 4, 4), i, np.float32)),
                    np.int64(i))

        def __len__(self):
            return 8

    return DS()


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_batches_land_on_the_card(surface, workers):
    """After ``set_device("gpu")`` a prefetching loader (its producer a
    thread of its own) and a worker pool forked after CUDA started both
    yield CUDA tensors, in the sampler's order."""
    paddle = surface
    paddle.set_device("gpu")
    paddle.zeros([1])                       # CUDA started in the parent
    loader = paddle.io.DataLoader(_vision_dataset(paddle), batch_size=4,
                                  num_workers=workers, prefetch_factor=2)
    seen = []
    for x, y in loader:
        assert x._data.is_cuda and y._data.is_cuda
        assert x.place == paddle.CUDAPlace(0)
        seen += y.numpy().tolist()
        assert (x.numpy()[:, 0, 0, 0] == y.numpy()).all()
    assert seen == list(range(8))
    paddle.set_device("cpu")
    x, _ = next(iter(loader))
    assert not x._data.is_cuda


def test_iterable_loader_workers_forked_after_cuda(surface):
    """An IterableDataset whose ``__iter__`` calls ``paddle.to_tensor``,
    read by 2 workers forked after CUDA started in the parent: the
    workers make CPU tensors, and the parent's batches are CUDA tensors."""
    from chip_smoke import _iterable_loader_check

    paddle = surface
    paddle.set_device("gpu")
    paddle.zeros([1])                       # CUDA started in the parent
    assert _iterable_loader_check(paddle, workers=2) == "cuda"


def test_vision_bfloat16_casts_buffers_and_keeps_parameters(surface):
    paddle = surface
    paddle.set_device("gpu")
    net = paddle.vision.models.resnet18(num_classes=4)
    params = net.parameters()
    net.bfloat16()
    assert net.parameters() == params
    assert all(q.dtype == paddle.bfloat16 and q._data.is_cuda
               for q in params)
    assert all(b.dtype == paddle.bfloat16 for b in net.buffers())
    step = paddle.jit.TrainStep(
        net, lambda x, y: paddle.nn.functional.cross_entropy(net(x), y),
        paddle.optimizer.Momentum(learning_rate=0.01, parameters=params))
    x = paddle.randn([2, 3, 64, 64]).astype("bfloat16")
    before = net.bn1._mean.numpy().copy()
    loss = step(x, paddle.to_tensor(np.array([0, 3])))
    assert np.isfinite(float(loss))
    assert not np.array_equal(net.bn1._mean.numpy(), before)
