"""``paddle.callbacks``: the hapi callbacks (counterpart of
``paddle_tpu/callbacks.py``)."""
from .hapi.callbacks import (  # noqa: F401
    Callback,
    EarlyStopping,
    LRScheduler,
    ModelCheckpoint,
    ProgBarLogger,
    ReduceLROnPlateau,
    VisualDL,
    WandbCallback,
)

__all__ = [
    "Callback", "ProgBarLogger", "ModelCheckpoint", "VisualDL",
    "LRScheduler", "EarlyStopping", "ReduceLROnPlateau", "WandbCallback",
]
