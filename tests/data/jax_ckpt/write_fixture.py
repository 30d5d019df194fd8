"""Write the JAX package's checkpoint fixture that the port reads.

    python tests/data/jax_ckpt/write_fixture.py [OUT_DIR]

A test helper, not part of the port: it runs the JAX package on the CPU
(``OUT_DIR`` defaults to this directory). A depth-2 ``GPTForCausalLMPipe``
(float32, hidden 16) takes two ``TrainStep``s under
``AdamW(factored=True)`` on seeded batches; then it writes

- ``root/``: a ``CheckpointManager`` root holding step 2, the training
  state (parameters and the factored moments) as
  ``save_training_state`` writes it;
- ``state.pdparams``: ``paddle.save`` of the model's ``state_dict`` plus
  ``extra.bf16``, a bfloat16 tensor, and ``extra.frozen``, a parameter
  that takes no gradient;
- ``expected.json``: the configuration, the batches' seeds, and the JAX
  package's loss of its next step (on the batch of seed ``NEXT_SEED``),
  as float32 hex and as a value.
"""
import json
import os
import shutil
import struct
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parents[3]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

CONFIG = dict(vocab_size=32, hidden_size=16, num_layers=2, num_heads=1,
              intermediate_size=32, max_seq_len=32, dropout=0.0,
              recompute=True)
BATCH, SEQ = 2, 16
LR = 1e-3
STEP_SEEDS = (0, 1)
NEXT_SEED = 2
INIT_SEED = 7


def batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, CONFIG["vocab_size"], (BATCH, SEQ)),
            rng.integers(0, CONFIG["vocab_size"], (BATCH, SEQ)))


def f32_hex(x):
    return struct.pack(">f", np.float32(x)).hex()


def write(out):
    import paddle_tpu as paddle
    from paddle_tpu.distributed.checkpoint import CheckpointManager
    from paddle_tpu.jit import TrainStep
    from paddle_tpu.models.gpt import GPTConfig, GPTForCausalLMPipe

    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    shutil.rmtree(out / "root", ignore_errors=True)
    paddle.seed(INIT_SEED)
    model = GPTForCausalLMPipe(GPTConfig(**CONFIG))
    opt = paddle.optimizer.AdamW(learning_rate=LR, factored=True,
                                 parameters=model.parameters())
    step = TrainStep(model, lambda a, b: model.loss(a, b), opt)

    def run(seed):
        ids, labels = batch(seed)
        return float(step(paddle.to_tensor(ids.astype(np.int32)),
                          paddle.to_tensor(labels)).numpy())

    losses = [run(s) for s in STEP_SEEDS]
    with CheckpointManager(str(out / "root")) as mgr:
        mgr.save_training_state(len(STEP_SEEDS), model, opt, train_step=step)
    state = dict(model.state_dict())
    rng = np.random.default_rng(3)
    state["extra.bf16"] = paddle.to_tensor(
        rng.standard_normal((3, 5)).astype(np.float32)).astype("bfloat16")
    frozen = paddle.create_parameter([4], "float32")
    frozen.stop_gradient = True
    state["extra.frozen"] = frozen
    paddle.save(state, str(out / "state.pdparams"))
    next_loss = run(NEXT_SEED)
    (out / "expected.json").write_text(json.dumps({
        "config": CONFIG, "batch": BATCH, "seq": SEQ, "lr": LR,
        "step_seeds": list(STEP_SEEDS), "next_seed": NEXT_SEED,
        "losses": losses, "next_loss": next_loss,
        "next_loss_hex": f32_hex(next_loss)}, indent=1) + "\n")


if __name__ == "__main__":
    write(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).parent)
