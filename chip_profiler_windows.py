#!/usr/bin/env python3
"""How many of a short window's device events ``torch.profiler`` keeps as
a process ages, through the port's ``paddle.profiler.Profiler`` and
through a bare ``torch.profiler.profile``, on one CUDA card:

    python3 chip_profiler_windows.py

Four rounds, 40 s apart, in one process. Each round opens windows back
to back, each after a synchronise: over one ``istft`` of 32 × 30 s of
audio (Whisper's front end, as phase ``domains`` (d) runs it) in the
order port, bare, bare, port, and over 20 such calls port then bare.
A window's line gives the device events it kept (kernels, memcpys and
memsets, read by ``device_trace.events_from_kineto`` from either
profiler), the kernels the host launched in it, and the least time from
a kernel's launch (its ``cudaLaunchKernel``) to its start on the card as
the profiler reports them: a negative time means the card's timestamps,
converted to the host's clock, lie before the host's, and a window drops
the device events that fall before it opened. The last line prints the
card's name and power limit.
"""
import json
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from paddle_tpu_torch import profiler as pprof
from paddle_tpu_torch.profiler import device_trace

ROUNDS = 4
GAP_S = 40.0
ORDER = (("port", 1), ("bare", 1), ("bare", 1), ("port", 1),
         ("port", 20), ("bare", 20))


def _window(prof):
    """(device events kept, kernels launched, least launch-to-start µs)
    of a finished window."""
    raw = list(prof.profiler.kineto_results.events())
    kept = sum(1 for e in device_trace.events_from_kineto(prof)
               if e[1] == "device")
    launch = {e.correlation_id(): e.start_ns() for e in raw
              if e.device_type() == DeviceType.CPU
              and "LaunchKernel" in e.name()}
    lag = [e.start_ns() - launch[e.correlation_id()] for e in raw
           if e.device_type() == DeviceType.CUDA
           and e.correlation_id() in launch]
    return kept, len(launch), (min(lag) / 1e3 if lag else None)


def bare(fn, reps):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return _window(prof)


def port(fn, reps):
    got = []
    torch.cuda.synchronize()
    with pprof.Profiler(
            targets=[pprof.ProfilerTarget.CPU, pprof.ProfilerTarget.GPU],
            on_trace_ready=lambda p: got.append(_window(p._window_prof))):
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return got[0]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_profiler_windows.py: no CUDA device")
    x = torch.randn(32, 480000, device="cuda")
    win = torch.hann_window(400, device="cuda")
    spec = torch.stft(x, 400, 160, window=win, return_complex=True)

    def istft():
        return torch.istft(spec, 400, 160, window=win, length=480000)

    istft()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for rnd in range(ROUNDS):
        if rnd:
            time.sleep(GAP_S)
        t = time.perf_counter() - t0
        for name, reps in ORDER:
            kept, launched, lag = (port if name == "port" else bare)(
                istft, reps)
            print(json.dumps({"t_s": round(t, 1), "profiler": name,
                              "istft_calls": reps, "device_events": kept,
                              "kernels_launched": launched,
                              "least_launch_to_start_us": lag}),
                  flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
