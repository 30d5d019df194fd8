"""Incubate APIs of the port (counterpart of ``paddle_tpu/incubate``): the
fused decode ops under ``incubate.nn.functional``."""
from . import nn  # noqa: F401
