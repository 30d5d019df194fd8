"""Unique name generator (parity: python/paddle/utils/unique_name)."""
from __future__ import annotations

import collections
import contextlib

_counters = collections.defaultdict(int)


def generate(key):
    _counters[key] += 1
    return f"{key}_{_counters[key] - 1}"


@contextlib.contextmanager
def guard(new_generator=None):
    global _counters
    old = _counters
    _counters = collections.defaultdict(int)
    try:
        yield
    finally:
        _counters = old


def switch(new_generator=None):
    global _counters
    _counters = collections.defaultdict(int)
