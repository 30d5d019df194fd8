"""Per-op device-time statistics from a ``torch.profiler`` run.

The port's counterpart of ``paddle_tpu/profiler/xplane.py``
(``device_op_stats``, ``summarize_families``, ``format_table`` and
``_classify``, :137-226). The reference decodes the XPlane protobuf that
``jax.profiler`` writes; the port reads the device events CUPTI gives
``torch.profiler``: the kernels, memcpys and memsets on the card, either
from a finished window's Kineto results or from the chrome trace JSON a
window was exported to. The rows and the table keep the reference's
format.

With no device event at all in a window that traced the CPU only, the
table is built from the CPU ops, as the reference falls back to XLA:CPU's
host plane (:179-186); each CPU op counts its self time (its duration
less that of the ops nested in it on its thread), so the table does not
count a nested op twice. A window that traced the card and holds no
device event raises :class:`NoDeviceEvents`: its CPU ops would read as a
plausible device table.
"""
from __future__ import annotations

import collections
import glob
import json
import os
import re

#: the port's kernel symbols (CUDA's names, as CUPTI reports them) ->
#: the name its wrapper counts launches under (``ops.kernels.LAUNCHES``).
#: The first match wins; the f32 and wide (192/256) backwards tell the
#: fused from the split dk/dv pass by their ``KDQ`` template argument.
PORT_KERNELS = (
    ("flash_fwd_wgmma", "flash_attention_fwd"),
    ("flash_bwd_dq_wgmma", "flash_attention_bwd_dq"),
    ("flash_bwd_dkv_wgmma", "flash_attention_bwd_dkv"),
    ("flash_bwd_wgmma", "flash_attention_bwd"),
    ("flash_bwd_wide_wgmma", None),
    ("flash_f32::fwd_kernel", "flash_attention_fwd"),
    ("flash_f32::dq_kernel", "flash_attention_bwd_dq"),
    ("flash_f32::bwd_kv_kernel", None),
    ("swiglu_down_wgmma", "swiglu_down"),
    ("swiglu_down_kernel", "swiglu_down"),
    ("add_rms_norm_kernel", "add_rms_norm"),
    ("rms_norm_kernel", "rms_norm"),
    ("paged_attention_int8_kernel", "paged_attention_int8"),
    ("paged_attention_kernel", "paged_attention"),
    ("decode_attention_kernel", "decode_attention"),
)
_KDQ = re.compile(r"<\s*\d+\s*,\s*(true|false)")

#: name fragments of library kernels, by family; the first match wins
_LIBRARY_FAMILIES = (
    ("nccl", ("nccl",)),
    ("conv", ("cudnn", "conv", "implicit_gemm", "winograd", "fft2d")),
    ("gemm", ("nvjet", "gemm", "gemv", "cutlass", "splitkreduce", "sm90_xmma",
              "cublas", "aten::mm", "aten::bmm", "aten::addmm",
              "aten::_int_mm", "aten::_scaled_mm")),
    ("copy", ("memcpy", "memset", "copy_kernel", "catarraybatchedcopy",
              "cat_", "index_", "gather", "scatter", "transpose")),
    ("reduction", ("reduce", "softmax", "norm", "sum", "mean", "amax",
                   "max_", "argmax", "cumsum", "scan")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "pointwise",
                     "fill", "where", "mul", "add", "exp", "cast", "relu",
                     "clamp", "silu", "sigmoid", "rsqrt", "pow")),
)


def port_kernel(name):
    """The launch-count name of the port's kernel ``name`` is an instance
    of (CUDA's demangled symbol), or None for any other kernel."""
    for sym, launch in PORT_KERNELS:
        if sym in name:
            if launch is not None:
                return launch
            m = _KDQ.search(name, name.index(sym))
            kdq = m is not None and m.group(1) == "true"
            return "flash_attention_bwd" if kdq else "flash_attention_bwd_dkv"
    return None


def _classify(op_name):
    """Bucket a CUDA kernel name (or a CPU op's) into a coarse family:
    ``port:<kernel>`` for the port's own kernels, then ``gemm`` (cuBLAS,
    CUTLASS), ``conv`` (cuDNN), ``copy``, ``reduction``, ``elementwise``,
    ``nccl``, or ``other``."""
    port = port_kernel(op_name)
    if port is not None:
        return "port:" + port
    n = op_name.lower()
    for fam, keys in _LIBRARY_FAMILIES:
        if any(k in n for k in keys):
            return fam
    return "other"


# --------------------------------------------------------------- sources
# an event is (name, kind, start_us, dur_us, tid), kind "device" or "cpu"

def events_from_kineto(prof):
    """The events of a finished ``torch.profiler.profile`` window: every
    device event that is not a user annotation, and every CPU op."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            continue
        if e.device_type() == DeviceType.CUDA:
            kind = "device"
        elif e.device_type() == DeviceType.CPU and not e.is_async():
            kind = "cpu"
        else:
            continue
        out.append((e.name(), kind, e.start_ns() / 1e3,
                    max(0, e.duration_ns()) / 1e3, e.start_thread_id()))
    return out


def events_from_chrome(trace):
    """The events of a chrome trace: a path (a ``.json`` file, or a
    directory whose newest ``*.json`` is read) or the loaded dict."""
    if not isinstance(trace, dict):
        path = trace
        if os.path.isdir(path):
            found = glob.glob(os.path.join(path, "**", "*.json"),
                              recursive=True)
            if not found:
                raise FileNotFoundError(f"no chrome trace under {path}")
            path = max(found, key=os.path.getmtime)
        with open(path) as f:
            trace = json.load(f)
    out = []
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            kind = "device"
        elif cat == "cpu_op":
            kind = "cpu"
        else:
            continue
        out.append((e.get("name", ""), kind, float(e.get("ts", 0.0)),
                    max(0.0, float(e.get("dur", 0.0))), e.get("tid", 0)))
    return out


def _self_times(cpu):
    """(name, self_us) of CPU ops: each op's duration less its children's
    on the same thread (ops nest as intervals)."""
    out = []
    by_tid = collections.defaultdict(list)
    for name, _, start, dur, tid in cpu:
        by_tid[tid].append((start, -dur, name))
    for evs in by_tid.values():
        evs.sort()
        stack = []          # [end, name, self_us]
        for start, ndur, name in evs:
            dur = -ndur
            while stack and stack[-1][0] <= start:
                e = stack.pop()
                out.append((e[1], e[2]))
            if stack:
                stack[-1][2] -= dur
            stack.append([start + dur, name, dur])
        out += [(e[1], e[2]) for e in stack]
    return out


class NoDeviceEvents(RuntimeError):
    """A window that traced the card recorded no device event."""


def device_op_stats(events, gpu=False):
    """Aggregate a window's device events into per-op totals.

    ``events`` as :func:`events_from_kineto` or :func:`events_from_chrome`
    give them (a path or a trace dict is read first); ``gpu`` says whether
    the window traced the card. Returns a list of dicts ``{name, calls,
    total_us, avg_us, family}``, sorted by total time descending. With no
    device event: from the CPU ops' self times when ``gpu`` is false, else
    :class:`NoDeviceEvents`."""
    if isinstance(events, (str, os.PathLike, dict)):
        events = events_from_chrome(events)
    dev = [(e[0], e[3]) for e in events if e[1] == "device"]
    if not dev and gpu:
        cpu = sum(1 for e in events if e[1] == "cpu")
        raise NoDeviceEvents(
            f"a window that traced the card holds {cpu} CPU ops and no "
            "device event; its table would be the CPU's")
    if not dev:
        dev = [(n, us) for n, us in _self_times(
            [e for e in events if e[1] == "cpu"])
            if not n.startswith("ProfilerStep#")]
    acc = collections.defaultdict(lambda: [0, 0.0])
    for name, us in dev:
        slot = acc[name]
        slot[0] += 1
        slot[1] += us
    rows = [{"name": k, "calls": c, "total_us": us,
             "avg_us": us / max(c, 1), "family": _classify(k)}
            for k, (c, us) in acc.items()]
    rows.sort(key=lambda r: -r["total_us"])
    return rows


def busy_us(events):
    """(union of the device events' intervals, span from the first
    device event's start to the last one's end), in µs."""
    spans = sorted((e[2], e[2] + e[3]) for e in events if e[1] == "device")
    union, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            union += e - s
            end = e
        elif e > end:
            union += e - end
            end = e
    span = (spans[-1][1] - spans[0][0]) if spans else 0.0
    return union, span


def summarize_families(rows):
    """Collapse an op table into per-family totals."""
    fam = collections.defaultdict(lambda: [0, 0.0])
    for r in rows:
        fam[r["family"]][0] += r["calls"]
        fam[r["family"]][1] += r["total_us"]
    out = [{"family": k, "calls": c, "total_us": us}
           for k, (c, us) in fam.items()]
    out.sort(key=lambda r: -r["total_us"])
    return out


def format_table(rows, limit=30):
    """Render the op table the way the reference's summary prints."""
    total = sum(r["total_us"] for r in rows) or 1.0
    lines = [f"{'op':<64} {'calls':>6} {'total_us':>12} {'avg_us':>10} {'%':>6}"]
    for r in rows[:limit]:
        lines.append(
            f"{r['name'][:64]:<64} {r['calls']:>6} {r['total_us']:>12.1f} "
            f"{r['avg_us']:>10.2f} {100 * r['total_us'] / total:>5.1f}%")
    return "\n".join(lines)
