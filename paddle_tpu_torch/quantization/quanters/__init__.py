"""``paddle.quantization.quanters`` (counterpart of
``paddle_tpu/quantization/quanters/__init__.py``)."""
from .. import FakeQuanterWithAbsMax as FakeQuanterWithAbsMaxObserver  # noqa: F401

__all__ = ["FakeQuanterWithAbsMaxObserver"]
