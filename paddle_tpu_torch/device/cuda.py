"""paddle.device.cuda over ``torch.cuda`` (counterpart of
``paddle_tpu/device/cuda/__init__.py:22-90``, which answers for its TPU):
the device count, the caching allocator's memory counters,
``empty_cache`` and the device's properties. ``device`` is an index, a
``CUDAPlace`` or None (the current card)."""
from __future__ import annotations

import torch

from . import Event, Stream, current_stream, stream_guard, synchronize  # noqa: F401

__all__ = [
    "Stream", "Event", "current_stream", "synchronize", "device_count",
    "empty_cache", "max_memory_allocated", "max_memory_reserved",
    "memory_allocated", "memory_reserved", "stream_guard",
    "get_device_properties", "get_device_name", "get_device_capability",
    "reset_max_memory_allocated", "reset_max_memory_reserved",
]


def _index(device):
    if device is None:
        return None
    if hasattr(device, "get_device_id"):
        return device.get_device_id()
    if isinstance(device, str):
        return torch.device(device.replace("gpu", "cuda")).index
    return int(device)


def device_count():
    return torch.cuda.device_count()


def memory_allocated(device=None):
    return torch.cuda.memory_allocated(_index(device))


def max_memory_allocated(device=None):
    return torch.cuda.max_memory_allocated(_index(device))


def memory_reserved(device=None):
    return torch.cuda.memory_reserved(_index(device))


def max_memory_reserved(device=None):
    return torch.cuda.max_memory_reserved(_index(device))


def reset_max_memory_allocated(device=None):
    torch.cuda.reset_peak_memory_stats(_index(device))


def reset_max_memory_reserved(device=None):
    torch.cuda.reset_peak_memory_stats(_index(device))


def empty_cache():
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def get_device_properties(device=None):
    return torch.cuda.get_device_properties(_index(device) or 0)


def get_device_name(device=None):
    return torch.cuda.get_device_name(_index(device))


def get_device_capability(device=None):
    return torch.cuda.get_device_capability(_index(device))
