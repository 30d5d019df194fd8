"""Optimizers of the port (counterpart of ``paddle_tpu/optimizer``): the
base, the zoo, the LR schedulers (``optimizer.lr``) and the regularizers."""
from . import lr
from .optimizer import Adam, AdamW, Optimizer
from .regularizer import L1Decay, L2Decay
from .zoo import (ASGD, LBFGS, SGD, Adadelta, Adagrad, Adamax, Lamb,
                  Momentum, NAdam, RAdam, RMSProp, Rprop)

__all__ = [
    "Optimizer", "SGD", "Momentum", "Adagrad", "Adam", "AdamW", "Adamax",
    "RMSProp", "Adadelta", "Lamb", "NAdam", "RAdam", "ASGD", "Rprop",
    "LBFGS", "lr", "L1Decay", "L2Decay",
]
