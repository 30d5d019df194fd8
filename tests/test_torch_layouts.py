"""The stacked <-> per-layer layout converters against the JAX package's,
and ``restore_decoder_any_layout`` over the port's ``CheckpointManager``
(mirroring ``tests/test_scan_layers.py:370-515``), on the CPU.

The port's per-layer tree keeps ``torch.nn.Linear``'s ``[out, in]`` where
the JAX package's keeps ``[in, out]``; both stacked trees keep ``[L, in,
out]``. So a port state is held against the JAX converter through the
one per-layer correspondence: projections and their parameter-shaped
slots transposed, a factored moment's ``vr`` and ``vc`` swapped.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.models.gpt import \
    convert_decoder_state_dict as jax_convert
from paddle_tpu_torch.distributed.checkpoint import (
    CheckpointManager, MissingKeysError, training_state_dict)
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                         GPTForCausalLMPipe,
                                         convert_decoder_state_dict,
                                         decoder_state_layout,
                                         restore_decoder_any_layout)
from paddle_tpu_torch.optimizer import AdamW
from test_torch_threads import one_intra_op_thread  # noqa: F401

CFG = dict(vocab_size=64, hidden_size=32, num_layers=3, num_heads=2,
           max_seq_len=32, dropout=0.0)
PROJ = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
        "down_proj")


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 64, (2, 8))),
            torch.from_numpy(rng.integers(0, 64, (2, 8))))


def _trained(cls, factored, seed=0, steps=1):
    """A model of ``cls`` with seeded weights and AdamW slots after
    ``steps`` TrainSteps."""
    torch.manual_seed(seed)
    cfg = GPTConfig(**CFG, intermediate_size=48)
    model = cls(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(seed), std=0.2)
    opt = AdamW(model.parameters(), lr=1e-2, factored=factored)
    step = TrainStep(model, model.loss, opt)
    for _ in range(steps):
        step(*_batch(seed))
    return model, opt


def _state(model, opt):
    return {k: v.detach().clone()
            for k, v in training_state_dict(model, opt).items()}


def _to_jax_per_layer(state):
    """The port's per-layer state in the JAX package's per-layer layout
    (numpy)."""
    out = {}
    for k, v in state.items():
        a = v.numpy()
        parts = k.split(".")
        proj = next((i for i, p in enumerate(parts) if p in PROJ), None)
        if proj is not None and "layers" in parts:
            slot = parts[proj + 2:]
            if slot in (["vr"], ["vc"]):
                k = ".".join(parts[:proj + 2] + [{"vr": "vc",
                                                  "vc": "vr"}[slot[0]]])
            elif a.ndim == 2:
                a = a.T
        out[k] = np.array(a, order="C")
    return out


def _same_bytes(a, b):
    a, b = np.array(a, order="C"), np.array(b, order="C")
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("factored", [False, True],
                         ids=["adamw", "adamw-factored"])
def test_converter_matches_jax_both_ways(factored):
    """Per-layer -> stacked is the JAX converter's result on the same
    state, bit for bit, slots included; stacked -> per-layer is too, in
    the port's layout."""
    model, opt = _trained(GPTForCausalLM, factored)
    per_layer = _state(model, opt)
    if factored:
        assert per_layer["opt.model.layers.0.attn.q_proj.weight.vr"].shape \
            == (32,)
        assert "opt.model.layers.0.input_norm.weight.moment2" in per_layer
    stacked = convert_decoder_state_dict(per_layer, "stacked")
    want = jax_convert(_to_jax_per_layer(per_layer), "stacked")
    assert sorted(stacked) == sorted(want)
    for k in want:
        assert _same_bytes(stacked[k].contiguous().numpy(), want[k]), k
    assert tuple(stacked["decoder.wg"].shape) == (3, 32, 48)
    assert tuple(stacked["embed_tokens.weight"].shape) == (64, 32)

    pipe, popt = _trained(GPTForCausalLMPipe, factored, seed=1)
    pstate = _state(pipe, popt)
    back = convert_decoder_state_dict(pstate, "per_layer")
    want = jax_convert({k: v.numpy() for k, v in pstate.items()},
                       "per_layer")
    mapped = _to_jax_per_layer(back)
    assert sorted(mapped) == sorted(want)
    for k in want:
        assert _same_bytes(mapped[k], want[k]), k


def test_round_trips_are_bitwise():
    """Per-layer -> stacked -> per-layer and stacked -> per-layer ->
    stacked give the same bytes back (Adam slots, which convert both
    ways; factored stacked norms do not, see below)."""
    for cls in (GPTForCausalLM, GPTForCausalLMPipe):
        model, opt = _trained(cls, factored=cls is GPTForCausalLM)
        state = _state(model, opt)
        layout = decoder_state_layout(state)
        other = "stacked" if layout == "per_layer" else "per_layer"
        back = convert_decoder_state_dict(
            convert_decoder_state_dict(state, other), layout)
        assert sorted(back) == sorted(state)
        for k, v in state.items():
            assert _same_bytes(back[k].contiguous().numpy(), v.numpy()), k


def test_factored_stacked_norms_do_not_collapse_back():
    """A factored stacked norm ``[L, H]`` keeps per-layer row factors:
    unstacked they are one scalar a layer, which cannot stack back into
    one entry (the reference's rule: scalar slots must agree bitwise)."""
    pipe, opt = _trained(GPTForCausalLMPipe, factored=True)
    per = convert_decoder_state_dict(_state(pipe, opt), "per_layer")
    assert per["opt.model.layers.1.input_norm.weight.vr"].dim() == 0
    with pytest.raises(ValueError, match="differs between layers"):
        convert_decoder_state_dict(per, "stacked")


def test_converter_refusals():
    model, opt = _trained(GPTForCausalLM, factored=False)
    state = _state(model, opt)
    with pytest.raises(ValueError, match="stacked\\|per_layer"):
        convert_decoder_state_dict(state, "scan")
    gap = {k: v for k, v in state.items()
           if not k.startswith("model.layers.1.attn.q_proj.weight")}
    with pytest.raises(ValueError, match="missing layers \\[1\\]"):
        convert_decoder_state_dict(gap, "stacked")
    with pytest.raises(ValueError, match="num_layers"):
        convert_decoder_state_dict({"opt.decoder.wq.beta1_pow":
                                    torch.ones(())}, "per_layer")
    int8 = AdamW(model.parameters(), lr=1e-2, moment_dtype="int8")
    TrainStep(model, model.loss, int8)(*_batch())
    with pytest.raises(ValueError, match="blockwise-int8"):
        convert_decoder_state_dict(_state(model, int8), "stacked")
    assert decoder_state_layout({"lm_head.weight": None}) is None


def _manager(tmp_path, name):
    return CheckpointManager(str(tmp_path / name))


def test_per_layer_checkpoint_restores_into_stacked(tmp_path):
    eager, opt = _trained(GPTForCausalLM, factored=False)
    mgr = _manager(tmp_path, "per_layer")
    mgr.save_training_state(1, eager, opt)
    mgr.close()
    pipe, popt = _trained(GPTForCausalLMPipe, factored=False, seed=3)
    mgr = _manager(tmp_path, "per_layer")
    assert restore_decoder_any_layout(mgr, pipe, popt) == 1
    want = convert_decoder_state_dict(_state(eager, opt), "stacked")
    got = _state(pipe, popt)
    assert sorted(want) == sorted(got)
    for k in want:
        assert _same_bytes(got[k].numpy(), want[k].contiguous().numpy()), k
    # one more step from either layout gives the same loss
    ids, labels = _batch(7)
    for m in (eager, pipe):
        m.eval()
    with torch.no_grad():
        np.testing.assert_allclose(pipe.loss(ids, labels).item(),
                                   eager.loss(ids, labels).item(), rtol=1e-5)
    mgr.close()


def test_stacked_checkpoint_restores_into_per_layer(tmp_path):
    pipe, _ = _trained(GPTForCausalLMPipe, factored=False)
    mgr = _manager(tmp_path, "stacked")
    mgr.save_training_state(3, pipe)
    mgr.close()
    eager, _ = _trained(GPTForCausalLM, factored=False, seed=4)
    mgr = _manager(tmp_path, "stacked")
    assert mgr.saved_keys() == set(pipe.state_dict())
    assert restore_decoder_any_layout(mgr, eager) == 3
    sd = eager.state_dict()
    assert _same_bytes(sd["model.embed_tokens.weight"].numpy(),
                       pipe.embed_tokens.weight.detach().numpy())
    for i in range(CFG["num_layers"]):
        got = sd[f"model.layers.{i}.attn.q_proj.weight"]
        assert _same_bytes(got.t().contiguous().numpy(),
                           pipe.decoder.wq[i].detach().numpy())
    mgr.close()


def test_factored_pipe_into_per_layer_is_strict_about_the_norms(tmp_path):
    """A factored Pipe's norm slots (row and column factors of ``[L, H]``)
    have no per-layer counterpart (a plain second moment): strict raises
    MissingKeysError naming them; strict=False converts everything else
    and keeps the target's norm moments."""
    pipe, popt = _trained(GPTForCausalLMPipe, factored=True)
    mgr = _manager(tmp_path, "factored")
    mgr.save_training_state(2, pipe, popt)
    eager, eopt = _trained(GPTForCausalLM, factored=True, seed=5)
    with pytest.raises(MissingKeysError, match="input_norm.weight.moment2"):
        restore_decoder_any_layout(mgr, eager, eopt)
    before = eopt.state_of(eager.model.layers[0].input_norm.weight)[
        "moment2"].clone()
    assert restore_decoder_any_layout(mgr, eager, eopt, strict=False) == 2
    st = eopt.state_of(eager.model.layers[0].attn.q_proj.weight)
    assert _same_bytes(st["vr"].numpy(),
                       popt.state_of(pipe.decoder.wq)["vc"][0].numpy())
    assert _same_bytes(st["moment1"].t().contiguous().numpy(),
                       popt.state_of(pipe.decoder.wq)["moment1"][0].numpy())
    assert torch.equal(eopt.state_of(eager.model.layers[0].input_norm
                                     .weight)["moment2"], before)
    mgr.close()


def test_strict_false_still_converts_cross_layout(tmp_path):
    eager, _ = _trained(GPTForCausalLM, factored=False)
    mgr = _manager(tmp_path, "pl")
    mgr.save_training_state(1, eager)
    pipe, _ = _trained(GPTForCausalLMPipe, factored=False, seed=6)
    before = pipe.decoder.wq.detach().clone()
    assert restore_decoder_any_layout(mgr, pipe, strict=False) == 1
    assert not torch.equal(before, pipe.decoder.wq)
    mgr.close()


def test_strict_false_same_layout_stays_native(tmp_path):
    """A model-only same-layout checkpoint restored with an optimizer and
    strict=False takes the native lenient path: the missing ``opt.*``
    keys are tolerated, the weights restored."""
    eager, _ = _trained(GPTForCausalLM, factored=False)
    mgr = _manager(tmp_path, "mo")
    mgr.save_training_state(1, eager)
    before = {k: v.clone() for k, v in eager.state_dict().items()}
    with torch.no_grad():
        for p in eager.parameters():
            p.zero_()
    opt = AdamW(eager.parameters(), lr=1e-2)
    assert restore_decoder_any_layout(mgr, eager, opt, strict=False) == 1
    for k, v in eager.state_dict().items():
        assert torch.equal(v, before[k]), k
    with pytest.raises(MissingKeysError):
        restore_decoder_any_layout(mgr, eager, opt)
    mgr.close()


def test_same_layout_keeps_native_path_and_read_state(tmp_path):
    pipe, popt = _trained(GPTForCausalLMPipe, factored=True)
    mgr = _manager(tmp_path, "native")
    mgr.save_training_state(2, pipe, popt)
    state, s = mgr.read_state()
    assert s == 2
    want = _state(pipe, popt)
    assert sorted(state) == sorted(want)
    for k, v in want.items():
        assert _same_bytes(state[k].numpy(), v.numpy()), k
    other, oopt = _trained(GPTForCausalLMPipe, factored=True, seed=8)
    assert restore_decoder_any_layout(mgr, other, oopt) == 2
    for k, v in _state(other, oopt).items():
        assert _same_bytes(v.numpy(), want[k].numpy()), k
    mgr.close()
