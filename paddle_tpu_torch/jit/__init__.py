"""paddle.jit for the port (counterpart of ``paddle_tpu/jit``):
``TrainStep``, ``functional_call``, ``to_static`` over dynamo
(``to_static.py``) and the class-free artifact of ``save``/``load`` over
``torch.export`` (``artifact.py``)."""
from .artifact import TranslatedLayer, load, load_artifact, save
from .to_static import (StaticFunction, enable_to_static, functional_call,
                        ignore_module, not_to_static, set_code_level,
                        set_verbosity, to_static)
from .train_step import StepHealth, TrainStep

__all__ = ["StepHealth", "TrainStep", "functional_call", "to_static",
           "StaticFunction", "not_to_static", "enable_to_static",
           "ignore_module", "set_code_level", "set_verbosity", "save",
           "load", "load_artifact", "TranslatedLayer"]
