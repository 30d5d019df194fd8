"""Recompile watchdog: a program built again, the silent perf killer.

Every program build of the port reports here as a (function,
signature) pair: each CUDA graph capture (the serving tick, the
speculative verify, the draft's proposal and catch-up), whose signature
is the captured row count and shapes, and each build of a kernel library
by nvcc, whose signature is the source. The watchdog keeps the set of
distinct signatures per function; when one function crosses the
threshold it emits a ``RecompileWarning`` naming the function and its
recent signatures — a varying python scalar or an unpadded dynamic shape
is almost always the cause.

Counts land in the shared registry as ``jit_recompiles_total{function}``
(the reference's name, so its report tools read the port's dumps) so
snapshots and Prometheus scrapes expose build churn even when the warning
threshold is never crossed; each build's wall seconds go to
``cuda_compile_seconds{event}`` (event ``graph_capture`` or
``kernel_build``), the port's counterpart of the reference's
``jax_compilation_seconds``.
"""
from __future__ import annotations

import os
import threading
import warnings


class RecompileWarning(UserWarning):
    """N distinct compilations observed for one traced function."""


DEFAULT_THRESHOLD = int(os.environ.get("PTPU_RECOMPILE_WARN", "5"))

_MAX_SIG_HISTORY = 8


class RecompileWatchdog:
    def __init__(self, registry, threshold=None):
        self._registry = registry
        self.threshold = (DEFAULT_THRESHOLD if threshold is None
                          else int(threshold))
        self._lock = threading.Lock()
        self._sigs = {}    # fn name -> set of distinct signatures
        self._recent = {}  # fn name -> last few signature reprs
        self._warned = set()
        self._counter = registry.counter(
            "jit_recompiles_total",
            "distinct jit compilations per traced function",
            labelnames=("function",))

    def configure(self, threshold):
        self.threshold = int(threshold)
        return self

    def record(self, fn_name, signature):
        """Report one jit-cache miss. `signature` must be hashable (the
        abstract shape/dtype/guard key the cache missed on)."""
        if not self._registry.enabled:
            return
        self._counter.inc(labels=(fn_name,))
        with self._lock:
            sigs = self._sigs.setdefault(fn_name, set())
            if signature in sigs:
                return  # same program recompiled (e.g. cache eviction):
                        # counted above, but not a NEW shape signature
            sigs.add(signature)
            recent = self._recent.setdefault(fn_name, [])
            recent.append(repr(signature))
            del recent[:-_MAX_SIG_HISTORY]
            n = len(sigs)
            should_warn = n >= self.threshold and fn_name not in self._warned
            if should_warn:
                self._warned.add(fn_name)
        if should_warn:
            warnings.warn(
                f"recompile watchdog: '{fn_name}' has compiled {n} distinct "
                f"programs (threshold {self.threshold}). Recompilation "
                "discards the cached program and stalls the device — "
                "common causes are shape-varying inputs (pad or bucket "
                "them) and python scalars mutated between calls. Recent "
                f"signatures: {recent[-3:]}",
                RecompileWarning, stacklevel=3)

    def stats(self):
        with self._lock:
            return {name: len(sigs) for name, sigs in self._sigs.items()}

    def reset(self):
        with self._lock:
            self._sigs.clear()
            self._recent.clear()
            self._warned.clear()


def compile_seconds_histogram(registry):
    """The histogram of program-build wall seconds by event."""
    return registry.histogram(
        "cuda_compile_seconds",
        "CUDA graph capture and kernel-library build wall time",
        labelnames=("event",))
