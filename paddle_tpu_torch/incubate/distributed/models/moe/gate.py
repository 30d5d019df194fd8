"""The gate submodule (counterpart of
``paddle_tpu/incubate/distributed/models/moe/gate.py``): the gates, which
the port defines one level up."""
from . import BaseGate, GShardGate, NaiveGate, SwitchGate  # noqa: F401

__all__ = ["BaseGate", "GShardGate", "NaiveGate", "SwitchGate"]
