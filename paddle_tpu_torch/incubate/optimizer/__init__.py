"""paddle.incubate.optimizer of the port: ``functional``, the
quasi-Newton minimizers, and ``LBFGS``, which graduated into
``paddle.optimizer`` (the reference re-exports it too)."""
from . import functional  # noqa: F401
from ...optimizer import LBFGS  # noqa: F401
