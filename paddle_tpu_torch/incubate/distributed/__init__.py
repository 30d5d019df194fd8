"""Distributed incubate APIs of the port (counterpart of
``paddle_tpu/incubate/distributed``): the MoE layer and ``fleet``'s
recompute wrappers."""
from . import fleet  # noqa: F401
