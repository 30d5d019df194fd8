#!/usr/bin/env python3
"""Compare the config-4 training step of two checkouts on one CUDA card.

    python3 chip_ab.py --parent DIR [--rounds 2] [--out results.json]

``DIR`` holds another checkout of the repository (for example the parent
commit, unpacked with ``git archive`` under ``build/``). Each turn runs
``chip_smoke.phase_training()`` (GPT-3 1.3B, batch 3 x seq 2048, one
warm-up and 5 timed steps, synchronised host clock) of one checkout in a
process of its own, in the order parent, change, change, parent, repeated
``--rounds`` times, so both see the same card, power limit and
neighbours. Prints each turn's step times, then per side the turns'
medians and the median of all its timed steps.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

CODE = ("import sys, json, torch; sys.path.insert(0, '.'); "
        "torch.backends.cuda.matmul.allow_tf32 = False; "
        "import chip_smoke as cs; r = cs.phase_training(); "
        "print('AB', json.dumps({'step_ms': r['step_ms'], "
        "'median': r['step_ms_median']}))")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="a checkout of the commit to compare against")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out")
    args = ap.parse_args()
    roots = {"parent": Path(args.parent).resolve(),
             "change": Path(__file__).resolve().parent}
    out = {"parent": [], "change": []}
    for tag in ("parent", "change", "change", "parent") * args.rounds:
        p = subprocess.run([sys.executable, "-c", CODE], cwd=roots[tag],
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
        steps = [x for t in turns for x in t["step_ms"]]
        print(f"{tag}: turn medians {[t['median'] for t in turns]}; median "
              f"of all {len(steps)} steps {statistics.median(steps)}",
              flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
