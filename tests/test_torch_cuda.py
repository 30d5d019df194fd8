"""The port's CUDA and Triton kernels on the card (marked ``cuda``).

Each kernel against its plain PyTorch version on the same CUDA tensors,
the serving engine on the card against the same engine on the CPU, and
three training steps on the card against the same three on the CPU.
Every test skips where there is no CUDA card. This file imports neither
jax nor the JAX package, so it also runs where neither is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLMPipe
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels.decode_attention import (
    paged_attention, paged_attention_plain)
from paddle_tpu_torch.ops.kernels.flash_attention import (
    flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
    flash_attention_fwd_plain)
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


#: f32: summation order only; bf16: p is rounded against the running max
#: in the kernel and against the global max in the plain version
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hq,hkv,d,page", [(16, 16, 128, 64),
                                           (16, 2, 64, 16),
                                           (8, 8, 128, 7)])
def test_paged_attention_kernel_matches_plain(cuda_device, dtype, atol, hq,
                                              hkv, d, page):
    args = _paged_inputs(4, hq, hkv, d, page, 6, [1, page + 1, 3 * page,
                                                   6 * page], dtype,
                         cuda_device)
    got = paged_attention(*args)
    want = paged_attention_plain(*args)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= atol


def test_paged_attention_rejects_what_it_does_not_take(cuda_device):
    args = _paged_inputs(1, 4, 4, 64, 16, 1, [3], torch.float16, cuda_device)
    with pytest.raises(TypeError):
        paged_attention(*args)
    args = _paged_inputs(1, 4, 4, 32, 16, 1, [3], torch.float32, cuda_device)
    with pytest.raises(ValueError):
        paged_attention(*args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_kernel_matches_plain(cuda_device, dtype):
    x = torch.randn(64, 4096, device=cuda_device).to(dtype)
    w = (torch.rand(4096, device=cuda_device) + 0.5).to(dtype)
    o, rstd = rms_norm_fwd(x, w)
    ro, rrstd = rms_norm_plain(x, w)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(o, ro, atol=tol, rtol=tol)
    torch.testing.assert_close(rstd, rrstd, atol=1e-6, rtol=1e-5)


def test_engine_on_card_matches_cpu_and_counts_launches(cuda_device):
    # head_dim 64: the paged attention kernel takes 64 and 128
    cfg = LlamaConfig(vocab_size=96, hidden_size=256, num_layers=2,
                      num_heads=4, num_kv_heads=2, max_seq_len=128)
    cpu = LlamaForCausalLM(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(0), std=0.2)
    gpu = LlamaForCausalLM(cfg, device=cuda_device)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 96, n).tolist() for n in (5, 19, 33)]
    outs = []
    for model, dev in ((cpu, "cpu"), (gpu, cuda_device)):
        eng = ContinuousBatchingEngine(model, max_slots=2, page_size=16,
                                       max_seq_len=64, max_new_tokens=6,
                                       prefill_chunk=8, device=dev)
        kernels.reset_launch_counts()
        for p in prompts:
            eng.submit(p)
        outs.append(eng.run_until_complete())
        counts = kernels.launch_counts()
    assert outs[0] == outs[1]
    assert counts["paged_attention"] == cfg.num_layers * eng.decode_ticks
    assert counts["rms_norm"] == (2 * cfg.num_layers + 1) * (
        eng.decode_ticks + eng.prefill_chunk_steps)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hq,hkv,d,sq,sk", FLASH_SHAPES)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hq,hkv,d,sq,sk", FLASH_SHAPES)
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


#: f32: summation order over M; bf16: the output rounding (2^-8) and
#: products rounded from f32 values that differ in their last bits
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("rows,m,h", [(200, 256, 128), (256, 384, 256)])
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
                              "flash_attention_bwd": L, "swiglu_down": 2 * L}
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    for n, g in out["cpu"][1].items():
        err = (out["cuda"][1][n] - g).norm() / g.norm()
        assert err.item() <= 5e-4, n
