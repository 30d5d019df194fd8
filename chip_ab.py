#!/usr/bin/env python3
"""Compare a phase of two checkouts on one CUDA card.

    python3 chip_ab.py --parent DIR [--phase training|incubate|norm_call|
                                           layer_call|flash_call]
                       [--rounds 2] [--out results.json]

``DIR`` holds another checkout of the repository (for example the parent
commit, unpacked with ``git archive`` under ``build/``). Each turn runs one
phase of one checkout in a process of its own, in the order parent,
change, change, parent, repeated ``--rounds`` times, so both see the same
card, power limit and neighbours:

- ``training``: ``chip_smoke.phase_training()`` (GPT-3 1.3B, batch 3 x
  seq 2048, one warm-up and 5 timed steps, synchronised host clock): ms a
  step;
- ``incubate``: ``chip_smoke.phase_incubate()`` on LLaMA-7B in bf16 with
  seeded weights (the incubate decoder, 8 rows over dense caches): ms a
  token;
- ``norm_call``: the host's cost of one ``ops.kernels.rms_norm.rms_norm``
  call at the decode shape [8, 4096] bf16, 1,000 calls back to back
  ending in a synchronise, five times: µs a call under
  ``torch.inference_mode`` (the decoders), and with an input that
  requires grad (a training forward);
- ``flash_call``: the host's cost of one ``flash_attention`` forward and
  backward (``ops.kernels.flash_attention``) at [1, 128, 2, 64] bf16,
  causal, 200 calls back to back ending in a synchronise, five times: µs
  a call through the fused backward, and through the split pair (the
  router's scratch limit set to 0 bytes);
- ``layer_call``: the host's cost of one ``paddle.nn.Layer`` call inside
  another: a Layer whose forward calls 200 identity sublayers in turn on
  a [4, 4] Tensor on the card, 50 outer calls back to back, fifteen
  times: µs a sublayer call.

Prints each turn's times, then per side the turns' medians and the median
of all its samples.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

_HEAD = ("import sys, json, torch; sys.path.insert(0, '.'); "
         "torch.backends.cuda.matmul.allow_tf32 = False; "
         "import chip_smoke as cs; ")
CODE = {
    "training": _HEAD + (
        "r = cs.phase_training(); "
        "print('AB', json.dumps({'samples': r['step_ms'], "
        "'median': r['step_ms_median']}))"),
    "incubate": _HEAD + (
        "from paddle_tpu_torch.models.llama import llama_preset; "
        "m = cs._random_model(llama_preset('7b'), torch.bfloat16, 0); "
        "r = cs.phase_incubate(m); "
        "print('AB', json.dumps({'samples': r['ms_per_token_all'], "
        "'median': r['ms_per_token_median']}))"),
    "norm_call": _HEAD + """
import time, statistics
from paddle_tpu_torch.ops.kernels.rms_norm import rms_norm
x = torch.randn(8, 4096, device='cuda', dtype=torch.bfloat16)
w = torch.ones(4096, device='cuda', dtype=torch.bfloat16)
def us(a):
    for _ in range(100):
        rms_norm(a, w)
    torch.cuda.synchronize()
    out = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(1000):
            rms_norm(a, w)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out
with torch.inference_mode():
    inf = us(x)
grad = us(x.clone().requires_grad_())
print('AB', json.dumps({'samples': inf, 'grad_samples': grad,
                        'median': statistics.median(inf),
                        'grad_median': statistics.median(grad)}))
""",
    "flash_call": _HEAD + """
import time, statistics
from paddle_tpu_torch.ops.kernels import flash_attention as fa
g = torch.Generator(device='cuda').manual_seed(0)
q, k, v = (torch.randn(1, 128, 2, 64, device='cuda', dtype=torch.bfloat16,
                       generator=g).requires_grad_() for _ in range(3))
do = torch.randn(1, 128, 2, 64, device='cuda', dtype=torch.bfloat16,
                 generator=g)
def call():
    fa.flash_attention(q, k, v, causal=True).backward(do)
def us():
    for _ in range(50):
        call()
    torch.cuda.synchronize()
    out = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(200):
            call()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / 200 * 1e6)
    return out
fused = us()
fa.FUSED_DQ_SCRATCH_BYTES = 0
split = us()
print('AB', json.dumps({'samples': fused, 'split_samples': split,
                        'median': statistics.median(fused),
                        'split_median': statistics.median(split)}))
""",
    "layer_call": _HEAD + """
import time, statistics
import paddle_tpu_torch as paddle
class Leaf(paddle.nn.Layer):
    def forward(self, x):
        return x
class Tree(paddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.leaves = paddle.nn.LayerList([Leaf() for _ in range(200)])
    def forward(self, x):
        for leaf in self.leaves:
            x = leaf(x)
        return x
m = Tree()
x = paddle.to_tensor(torch.ones(4, 4, device='cuda'))
for _ in range(50):
    m(x)
out = []
for _ in range(15):
    t0 = time.perf_counter()
    for _ in range(50):
        m(x)
    out.append((time.perf_counter() - t0) / (50 * 200) * 1e6)
print('AB', json.dumps({'samples': out, 'median': statistics.median(out)}))
""",
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="a checkout of the commit to compare against")
    ap.add_argument("--phase", choices=sorted(CODE), default="training")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out")
    args = ap.parse_args()
    roots = {"parent": Path(args.parent).resolve(),
             "change": Path(__file__).resolve().parent}
    out = {"parent": [], "change": []}
    for tag in ("parent", "change", "change", "parent") * args.rounds:
        p = subprocess.run([sys.executable, "-c", CODE[args.phase]],
                           cwd=roots[tag],
                           capture_output=True, text=True)
        lines = [x for x in p.stdout.splitlines() if x.startswith("AB ")]
        if p.returncode or not lines:
            print(f"{tag}: exit {p.returncode}\n{p.stdout[-3000:]}\n"
                  f"{p.stderr[-3000:]}", file=sys.stderr)
            return 1
        turn = json.loads(lines[-1][3:])
        out[tag].append(turn)
        print(tag, json.dumps(turn), flush=True)
    for tag, turns in out.items():
        samples = [x for t in turns for x in t["samples"]]
        print(f"{tag}: turn medians {[t['median'] for t in turns]}; median "
              f"of all {len(samples)} samples "
              f"{statistics.median(samples)}", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
