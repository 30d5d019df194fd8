"""The training step of the port (counterpart of ``paddle_tpu/jit``)."""
from .train_step import StepHealth, TrainStep

__all__ = ["StepHealth", "TrainStep"]
