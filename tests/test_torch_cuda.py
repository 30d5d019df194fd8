"""The port's CUDA and Triton kernels on the card (marked ``cuda``).

Each kernel against its plain PyTorch version on the same CUDA tensors
(and the split flash backward run twice, bit for bit), the serving
engine (exact and int8 KV) on the card against the same engine on the
CPU, the incubate decoder of ``chip_smoke.py`` on the card against
the CPU, and three training steps on the card against the same three on
the CPU, under full and under selective remat.
Every test skips where there is no CUDA card. This file imports neither
jax nor the JAX package, so it also runs where neither is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from chip_smoke import incubate_generate
from paddle_tpu_torch.incubate.nn import functional as TF
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
    flash_attention_bwd, flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_plain, flash_attention_bwd_dq,
    flash_attention_bwd_dq_plain, flash_attention_bwd_fused,
    flash_attention_bwd_plain, flash_attention_fwd, flash_attention_fwd_plain)
from paddle_tpu_torch.ops.kernels.rms_norm import (rms_norm_fwd,
                                                   rms_norm_plain)
from paddle_tpu_torch.ops.kernels.swiglu_down import (swiglu_down_fwd,
                                                      swiglu_down_plain)
from paddle_tpu_torch.optimizer import AdamW

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
@pytest.mark.parametrize("hq,hkv,d,page", [(16, 16, 128, 64),
                                           (16, 2, 64, 16),
                                           (8, 8, 128, 7)])
def test_paged_attention_int8_kernel_matches_plain(cuda_device, dtype, atol,
                                                   hq, hkv, d, page):
    lengths = [1, page + 1, 3 * page, 6 * page]
    q, kp, vp, tables, lens = _paged_inputs(4, hq, hkv, d, page, 6, lengths,
                                            torch.float32, cuda_device)
    (kc, ks), (vc, vs) = quantize_rows_int8(kp), quantize_rows_int8(vp)
    args = [q.to(dtype), kc, ks, vc, vs, tables, lens]
    kernels.reset_launch_counts()
    got = paged_attention_int8(*args)
    want = paged_attention_int8_plain(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["paged_attention_int8"] == 1
    assert got.dtype == dtype
    assert (got.float() - want.float()).abs().max().item() <= atol
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h", [(8, 4096), (300, 96)])
def test_add_rms_norm_kernel_matches_plain(cuda_device, dtype, n, h):
    g = torch.Generator().manual_seed(n + h)
    x = torch.randn(n, h, generator=g).to(cuda_device, dtype)
    r = torch.randn(n, h, generator=g).to(cuda_device, dtype)
    w = (torch.rand(h, generator=g) + 0.5).to(cuda_device, dtype)
    kernels.reset_launch_counts()
    y, o, rstd = add_rms_norm_fwd(x, r, w)
    ry, ro, rrstd = add_rms_norm_plain(x, r, w)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["add_rms_norm"] == 1
    assert torch.equal(y, ry)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
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


#: head_dim 64 under GQA 4/2, exact and int8 KV; Phi-3-mini's head_dim 96
#: under MQA (16 q heads over one kv head), which only the exact kernel
#: takes
@pytest.mark.parametrize("int8_kv,hidden,heads,kv_heads",
                         [(False, 256, 4, 2), (True, 256, 4, 2),
                          (False, 1536, 16, 1)],
                         ids=["exact", "int8", "exact-d96-rep16"])
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
@pytest.mark.parametrize("hq,hkv,d,sq,sk", FLASH_SHAPES + FWD_EDGE_SHAPES)
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
@pytest.mark.parametrize("hq,hkv,d,sq,sk", FLASH_SHAPES + FUSED_EDGE_SHAPES)
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
@pytest.mark.parametrize("hq,hkv,d,sq,sk", FLASH_SHAPES + SPLIT_EDGE_SHAPES)
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
                         [(8, 2, 128, 300, 300)] + SPLIT_EDGE_SHAPES)
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
    (16, 16, 128, 2048, 2048), (8, 2, 64, 257, 300), (4, 1, 128, 130, 130)])
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
    q, k, v, do = _flash_inputs(2, 2, 32, 64, 64, torch.float32,
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
        step = TrainStep(model, model.loss,
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
        step = TrainStep(model, model.loss, AdamW(model.parameters(),
                                                  lr=3e-4))
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
