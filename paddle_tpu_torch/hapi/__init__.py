"""The high-level API (counterpart of ``paddle_tpu/hapi``): ``Model`` and
``summary``, and the callbacks."""
from .model import Model, summary  # noqa: F401
from . import callbacks  # noqa: F401
