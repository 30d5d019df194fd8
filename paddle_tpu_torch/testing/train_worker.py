"""A small checkpointed, guarded training loop, run as a subprocess by the
chaos tests (``python -m paddle_tpu_torch.testing.train_worker``).

Each accepted step prints ``STEP <n> LOSS <float32 hex>`` (parsed by
``chaos.step_losses``; hex, so equal strings are equal bits). The loop is
the one ``bench.py --ckpt-dir --resume auto --guard`` runs, at a tiny
size on the CPU: a seeded MLP, ``AdamW`` under ``LinearWarmup(
CosineAnnealingDecay)`` with a global-norm clip, ``TrainStep``, an
optional ``StepGuard``, a ``CheckpointManager`` save after every
accepted step of the ``STEPS``, ``--resume auto`` from the newest good
committed step, and a ``PreemptionGuard`` that turns SIGTERM into a last
synchronous save (then ``PREEMPTED <n>`` and exit 0).
"""
from __future__ import annotations

import argparse
import contextlib
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ..distributed.checkpoint import training_state_dict
from ..distributed.checkpoint.manager import (CheckpointManager,
                                              PreemptionGuard)
from ..jit import TrainStep
from ..nn import ClipGradByGlobalNorm
from ..optimizer import AdamW
from ..optimizer.lr import CosineAnnealingDecay, LinearWarmup
from ..resilience import StepGuard
from . import chaos

STEPS = 8

def _batch(step):
    rng = np.random.default_rng(1000 + step)
    return (torch.from_numpy(rng.standard_normal((16, 8), np.float32)),
            torch.from_numpy(rng.standard_normal((16, 4), np.float32)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--async-save", action="store_true")
    ap.add_argument("--resume", choices=("none", "auto"), default="none")
    ap.add_argument("--guard", action="store_true")
    ap.add_argument("--nan-step", type=int, default=0,
                    help="inject NaN gradients at this TrainStep call")
    ap.add_argument("--nan-count", type=int, default=1)
    args = ap.parse_args(argv)

    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                                torch.nn.Linear(16, 4))
    sched = LinearWarmup(CosineAnnealingDecay(0.05, T_max=STEPS),
                         warmup_steps=2, start_lr=0.0, end_lr=0.05)
    opt = AdamW(model.named_parameters(), lr=sched, weight_decay=0.01,
                grad_clip=ClipGradByGlobalNorm(1.0),
                apply_decay_param_fun=lambda n: n.endswith("weight"))
    step = TrainStep(model, lambda x, y: F.mse_loss(model(x), y), opt)
    mgr = CheckpointManager(args.ckpt_dir, keep=3)
    start = 0
    if args.resume == "auto" and mgr.last_good_step() is not None:
        start = mgr.restore_training_state(model, opt)
        print(f"RESUMED {start}", flush=True)
    guard = StepGuard(step, manager=mgr, max_consecutive=2) \
        if args.guard else None
    inject = (chaos.inject_nonfinite(args.nan_step, count=args.nan_count)
              if args.nan_step else contextlib.nullcontext())
    with PreemptionGuard(mgr) as pre, inject:
        gstep = start + 1
        while gstep <= STEPS:
            sched.step(gstep)
            if guard is not None:
                out = guard(gstep, *_batch(gstep))
                if not out.accepted:
                    print(f"{out.action.upper()} {gstep}", flush=True)
                    gstep = out.next_step
                    continue
                loss = out.health.loss
            else:
                loss = step(*_batch(gstep)).item()
            print(f"STEP {gstep} LOSS "
                  f"{np.float32(loss).tobytes().hex()}", flush=True)
            if pre.checkpoint_and_stop(gstep, training_state_dict(model,
                                                                  opt)):
                print(f"PREEMPTED {gstep}", flush=True)
                break
            mgr.save_training_state(gstep, model, opt,
                                    async_save=args.async_save)
            gstep += 1
    mgr.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
