"""``paddle.audio`` (counterpart of ``paddle_tpu/audio/__init__.py``):
``functional`` (windows, mel filter banks, the DCT), ``features`` (the
feature ``Layer``s), wav IO and the seeded dataset stand-ins."""
from __future__ import annotations

from . import backends, datasets, features, functional  # noqa: F401
from .backends import info, load, save  # noqa: F401

__all__ = ["backends", "datasets", "features", "functional", "info", "load",
           "save"]
