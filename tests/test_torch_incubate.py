"""The port's incubate fused decode ops against the JAX package's, on the
CPU, in f32, with inputs from numpy and a seed.

``fused_rms_norm`` and ``masked_multihead_attention`` take the same numpy
inputs as ``paddle_tpu.incubate.nn.functional``; the decoder that
``chip_smoke.py`` builds from these ops is held against ``generate`` (the
port's and the JAX package's) at a tiny size.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate.nn.functional as JF
from chip_smoke import incubate_generate
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.convert import state_dict_from_jax
from paddle_tpu_torch.incubate.nn import functional as TF
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import kernels

#: f32 on both sides; only the summation order differs
ATOL = 1e-5


def _np(t):
    return np.asarray(t.numpy())


def _pt(a):
    return paddle.to_tensor(a)


@pytest.mark.parametrize("case", ["residual", "plain", "norm_bias", "bias",
                                  "axis1"])
def test_fused_rms_norm_matches_jax(case):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32) * 2
    r = rng.standard_normal((3, 5, 32)).astype(np.float32)
    w = (1 + 0.2 * rng.standard_normal(32)).astype(np.float32)
    nb = rng.standard_normal(32).astype(np.float32)
    kw = {"residual": dict(residual=r), "plain": {},
          "norm_bias": dict(norm_bias=nb, residual=r),
          "bias": dict(bias=nb, residual=r)}.get(case)
    if case == "axis1":
        w = (1 + 0.2 * rng.standard_normal((5, 32))).astype(np.float32)
        kw = dict(begin_norm_axis=1)
    want = JF.fused_rms_norm(_pt(x), _pt(w), **{k: _pt(v) if isinstance(
        v, np.ndarray) else v for k, v in kw.items()})
    got = TF.fused_rms_norm(torch.from_numpy(x), torch.from_numpy(w),
                            **{k: torch.from_numpy(v) if isinstance(
                                v, np.ndarray) else v for k, v in kw.items()})
    if "residual" in kw:
        (out, y), (jout, jy) = got, want
        np.testing.assert_allclose(y.numpy(), _np(jy), atol=0, rtol=0)
    else:
        out, jout = got, want
    np.testing.assert_allclose(out.numpy(), _np(jout), atol=ATOL, rtol=0)


def test_fused_rms_norm_refuses_quantized_output():
    with pytest.raises(NotImplementedError, match="quant_scale"):
        TF.fused_rms_norm(torch.ones(2, 8), torch.ones(8), quant_scale=0.5)


@pytest.mark.parametrize("halves", [False, True])
def test_swiglu_matches_jax(halves):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 16)).astype(np.float32)
    y = rng.standard_normal((4, 16)).astype(np.float32)
    if halves:
        want, got = JF.swiglu(_pt(x)), TF.swiglu(torch.from_numpy(x))
    else:
        want = JF.swiglu(_pt(x), _pt(y))
        got = TF.swiglu(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-6, rtol=0)


def _mmha_inputs(seed, b=3, h=2, d=64, max_len=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 3 * h * d)).astype(np.float32)
    cache = rng.standard_normal((2, b, h, max_len, d)).astype(np.float32)
    bias = rng.standard_normal((3, h, d)).astype(np.float32)
    mask = rng.standard_normal((b, 1, 1, max_len)).astype(np.float32)
    return x, cache, bias, mask


#: a bf16 cache under a src_mask: both sides compute the logits, the
#: softmax and the output in f32 from the same bf16-rounded values, so only
#: the summation order differs, as in f32
BF16_MASK_CASES = {"src_mask_bf16_cache_f32_mask": torch.float32,
                   "src_mask_bf16_cache_bf16_mask": torch.bfloat16}


@pytest.mark.parametrize("case", ["lengths", "no_lengths", "bias",
                                  "src_mask", *BF16_MASK_CASES])
def test_masked_multihead_attention_matches_jax(case):
    """Per-row lengths 0, 5 and 15 (the last row fills the cache); without
    lengths every row writes at 0. The cache is written in place at
    ``cur`` and the row attends to ``cur + 1`` rows. Under a ``src_mask``
    the output is f32, also over a bf16 cache with an f32 or a bf16 mask,
    as the JAX package's is."""
    x, cache, bias, mask = _mmha_inputs(3)
    lens = np.asarray([0, 5, 15], np.int32)
    jkw, tkw = {}, {}
    jcache_in, tcache = _pt(cache), torch.from_numpy(cache.copy())
    if case in BF16_MASK_CASES:
        jcache_in = jcache_in.astype("bfloat16")
        tcache = tcache.to(torch.bfloat16)
        cache = tcache.float().numpy()      # the values both sides hold
    if case != "no_lengths":
        jkw["sequence_lengths"] = _pt(lens)
        tkw["sequence_lengths"] = torch.from_numpy(lens)
    if case == "bias":
        jkw["bias"], tkw["bias"] = _pt(bias), torch.from_numpy(bias)
    if case.startswith("src_mask"):
        jkw["src_mask"], tkw["src_mask"] = _pt(mask), torch.from_numpy(mask)
        if BF16_MASK_CASES.get(case) == torch.bfloat16:
            jkw["src_mask"] = jkw["src_mask"].astype("bfloat16")
            tkw["src_mask"] = tkw["src_mask"].to(torch.bfloat16)
    jout, jcache = JF.masked_multihead_attention(_pt(x), cache_kv=jcache_in,
                                                 **jkw)
    out, ret = TF.masked_multihead_attention(torch.from_numpy(x),
                                             cache_kv=tcache, **tkw)
    assert ret is tcache
    assert out.dtype == torch.float32 and _np(jout).dtype == np.float32
    np.testing.assert_array_equal(tcache.float().numpy(),
                                  _np(jcache).astype(np.float32))
    np.testing.assert_allclose(out.numpy(), _np(jout), atol=ATOL, rtol=0)
    cur = lens if case != "no_lengths" else np.zeros(3, np.int32)
    changed = np.any(tcache.float().numpy() != cache, axis=(0, 2, 4))
    assert [list(np.flatnonzero(c)) for c in changed] == [[c] for c in cur]


def test_masked_multihead_attention_kernel_route_counts_no_launch_on_cpu():
    x, cache, _, _ = _mmha_inputs(4)
    kernels.reset_launch_counts()
    TF.masked_multihead_attention(torch.from_numpy(x),
                                  cache_kv=torch.from_numpy(cache))
    TF.fused_rms_norm(torch.ones(2, 8), torch.ones(8),
                      residual=torch.ones(2, 8))
    assert all(n == 0 for n in kernels.launch_counts().values())


@pytest.mark.parametrize("arg", ["rotary_tensor", "beam_cache_offset",
                                 "qkv_out_scale", "out_shift", "out_smooth",
                                 "out_scale"])
def test_masked_multihead_attention_refuses_what_it_ignores(arg):
    """The JAX package silently ignores these; the port raises."""
    x, cache, _, _ = _mmha_inputs(5)
    val = 0.5 if arg == "out_scale" else torch.ones(1)
    with pytest.raises(NotImplementedError, match=arg):
        TF.masked_multihead_attention(torch.from_numpy(x),
                                      cache_kv=torch.from_numpy(cache),
                                      **{arg: val})


TINY = dict(vocab_size=96, hidden_size=128, num_layers=2, num_heads=2,
            max_seq_len=64, dropout=0.0)


@pytest.fixture(scope="module")
def models():
    """MHA (masked_multihead_attention packs H heads for k and v) with
    head_dim 64, as the decode kernel takes on the card."""
    rng = np.random.default_rng(7)
    jm = JaxLlama(JaxLlamaConfig(**TINY))
    sd = {k: (0.25 * rng.standard_normal(tuple(v.shape))).astype(np.float32)
          if not k.endswith("norm.weight") else
          (1 + 0.1 * rng.standard_normal(tuple(v.shape))).astype(np.float32)
          for k, v in jm.state_dict().items()}
    jm.set_state_dict({k: paddle.to_tensor(a) for k, a in sd.items()})
    tm = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu")
    tm.load_state_dict(state_dict_from_jax(sd, tm.config))
    return jm, tm


def test_incubate_decoder_streams_match_generate(models):
    """The whole slice: chip_smoke.py's decoder built from fused_rms_norm,
    masked_multihead_attention and swiglu, three rows joining at steps 0,
    3 and 7, gives the greedy streams of the port's generate and of the
    JAX package's."""
    jm, tm = models
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 96, (n,)).tolist() for n in (5, 11, 3)]
    new = 6
    outs, steps = incubate_generate(tm, prompts, [0, 3, 7], new, 32)
    assert steps == max(s + len(p) + new - 1
                        for s, p in zip([0, 3, 7], prompts))
    for p, o in zip(prompts, outs):
        want = tm.generate(np.asarray([p]), max_new_tokens=new)[0].tolist()
        jwant = np.asarray(jm.generate(paddle.to_tensor(np.asarray([p])),
                                       max_new_tokens=new).numpy())
        assert o == want == jwant[0].tolist()
