"""Validate a ``CheckpointManager`` root offline, or diff two steps
(counterpart of ``tools/ckpt_inspect.py``). It reads the port's roots and
the JAX package's alike (their pickles through ``jax_pickle``, their
CRC32C through the native library), without importing JAX.

Usage::

    python -m paddle_tpu_torch.distributed.checkpoint.inspect ROOT
    python -m paddle_tpu_torch.distributed.checkpoint.inspect ROOT --step 42
    python -m paddle_tpu_torch.distributed.checkpoint.inspect ROOT --diff 40 42
    python -m paddle_tpu_torch.distributed.checkpoint.inspect ROOT --json

Validation goes one level below ``CheckpointManager.validate_step`` (the
COMMIT manifest, each file's size and checksum, the metadata's pickle):
every box the metadata records must be an entry of its payload file, and
every payload file it names must be in the manifest. The exit code is 1
when a committed step fails validation (2 for a missing root).
Uncommitted step directories are reported, not failed: readers ignore
them (in-flight saves or crash debris). A ``--step`` that is missing or
uncommitted fails.

Diff mode compares two committed steps key by key: added and removed
keys, shape and dtype changes, and content changes (a checksum of each
box's bytes; no tensor is assembled).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch


def _manager(root):
    from .manager import CheckpointManager

    return CheckpointManager(root)


def _load_step(step_dir):
    """``(metadata list, {filename: {"<key>|<offsets>": CPU tensor}})``
    of one step directory."""
    from . import _load_metadata, _read_payload

    metas = _load_metadata(step_dir)
    payloads = {fn: _read_payload(os.path.join(step_dir, fn))
                for fn in sorted(os.listdir(step_dir))
                if fn.endswith(".distcp")}
    return metas, payloads


def _completeness_problems(step_dir):
    """The metadata against the payload files, beyond the checksums (a
    payload of the port's is read as its index alone)."""
    from . import _load_metadata, _payload_keys

    problems = []
    try:
        metas = _load_metadata(step_dir)
        payloads = {fn: _payload_keys(os.path.join(step_dir, fn))
                    for fn in sorted(os.listdir(step_dir))
                    if fn.endswith(".distcp")}
    except Exception as e:
        return [f"unreadable metadata/payload: {e!r}"]
    for meta in metas:
        for idx, fn in meta.storage_metadata.items():
            payload = payloads.get(fn)
            if payload is None:
                problems.append(
                    f"{idx.tensor_key!r}: shard file {fn} missing")
                continue
            pkey = f"{idx.tensor_key}|{','.join(map(str, idx.global_offset))}"
            if pkey not in payload:
                problems.append(
                    f"{idx.tensor_key!r}: payload entry {pkey!r} missing "
                    f"from {fn}")
    return problems


def _check(mgr, step):
    problems = mgr.validate_step(step)
    return problems or _completeness_problems(mgr.step_dir(step))


def validate(root, step=None):
    """``[{step, committed, problems}]`` for every (or one) step."""
    mgr = _manager(root)
    if step is not None:
        return [{"step": step, "committed": mgr.is_committed(step),
                 "problems": _check(mgr, step)}]
    results = []
    for s in mgr.all_steps(committed_only=False):
        committed = mgr.is_committed(s)
        results.append({"step": s, "committed": committed,
                        "problems": _check(mgr, s) if committed else []})
    return results


def _digest(block):
    from . import checksum_bytes

    return checksum_bytes(
        block.contiguous().reshape(-1).view(torch.uint8).numpy())


def diff(root, step_a, step_b):
    """Per-key comparison of two steps: added, removed, changed,
    identical."""
    mgr = _manager(root)

    def _keys(step):
        metas, payloads = _load_step(mgr.step_dir(step))
        out = {}
        for meta in metas:
            for key, boxes in meta.state_dict_metadata.items():
                digest = []
                for m in boxes:
                    idx_key = f"{key}|{','.join(map(str, m.global_offset))}"
                    for payload in payloads.values():
                        block = payload.get(idx_key)
                        if block is not None:
                            digest.append((tuple(m.global_offset),
                                           _digest(block)))
                            break
                out[key] = {
                    "shape": tuple(meta.flat_mapping.get(key, ())),
                    "dtype": boxes[0].dtype if boxes else None,
                    "digest": tuple(sorted(digest)),
                }
        return out

    a, b = _keys(step_a), _keys(step_b)
    report = {"added": sorted(set(b) - set(a)),
              "removed": sorted(set(a) - set(b)),
              "changed": [], "identical": []}
    for key in sorted(set(a) & set(b)):
        if a[key]["shape"] != b[key]["shape"]:
            report["changed"].append(
                f"{key}: shape {a[key]['shape']} -> {b[key]['shape']}")
        elif a[key]["dtype"] != b[key]["dtype"]:
            report["changed"].append(
                f"{key}: dtype {a[key]['dtype']} -> {b[key]['dtype']}")
        elif a[key]["digest"] != b[key]["digest"]:
            report["changed"].append(f"{key}: content")
        else:
            report["identical"].append(key)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="validate/diff a crash-safe checkpoint root")
    ap.add_argument("root")
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--diff", nargs=2, type=int, metavar=("A", "B"))
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    if not os.path.isdir(args.root):
        print(f"ckpt_inspect: no such directory: {args.root}",
              file=sys.stderr)
        return 2

    if args.diff:
        report = diff(args.root, args.diff[0], args.diff[1])
        if args.json:
            print(json.dumps(report, indent=1))
        else:
            print(f"diff step {args.diff[0]} -> step {args.diff[1]}:")
            for k in ("added", "removed", "changed"):
                for item in report[k]:
                    print(f"  {k}: {item}")
            print(f"  identical: {len(report['identical'])} key(s)")
        return 0

    results = validate(args.root, step=args.step)
    if args.json:
        print(json.dumps(results, indent=1))
    else:
        if not results:
            print(f"{args.root}: no step directories")
        for r in results:
            if r["problems"]:
                print(f"step {r['step']}: "
                      f"{'CORRUPT' if r['committed'] else 'INVALID'}")
                for p in r["problems"]:
                    print(f"  - {p}")
            elif not r["committed"]:
                print(f"step {r['step']}: UNCOMMITTED "
                      f"(invisible to readers; in-flight or crash debris)")
            else:
                print(f"step {r['step']}: OK")
    return 1 if any(r["problems"] for r in results) else 0


if __name__ == "__main__":
    sys.exit(main())
