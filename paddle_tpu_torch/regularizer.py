"""``paddle.regularizer`` (counterpart of ``paddle_tpu/regularizer.py``)."""
from .optimizer.regularizer import L1Decay, L2Decay  # noqa: F401

__all__ = ["L1Decay", "L2Decay"]
