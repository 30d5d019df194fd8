"""paddle.incubate.optimizer of the port: ``functional``, the
quasi-Newton minimizers."""
from . import functional  # noqa: F401
