"""The port's CUDA and Triton kernels on the card (marked ``cuda``).

Each kernel against its plain PyTorch version on the same CUDA tensors,
and the serving engine on the card against the same engine on the CPU.
Every test skips where there is no CUDA card. This file imports neither
jax nor the JAX package, so it also runs where neither is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels.decode_attention import (
    paged_attention, paged_attention_plain)
from paddle_tpu_torch.ops.kernels.rms_norm import (rms_norm_fwd,
                                                   rms_norm_plain)

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
