"""Global FLAGS registry (counterpart of ``paddle_tpu/utils/flags.py``;
Paddle's ``paddle/common/flags.h`` ``PD_DEFINE_*`` with the Python
``get_flags``/``set_flags``).

Flags are registered with type, default and help, and are set from the
environment (``FLAGS_name``) or by ``set_flags``. A hot path reads a flag
through its :class:`Flag` object (``define_flag`` returns it), one
attribute read: ``apply_op`` and ``TrainStep`` read ``check_nan_inf`` so.
"""
from __future__ import annotations

import os
import threading

_lock = threading.Lock()
_registry = {}


class Flag:
    __slots__ = ("name", "default", "value", "type", "help")

    def __init__(self, name, default, help=""):
        self.name = name
        self.default = default
        self.value = self._from_env(name, default)
        self.type = type(default)
        self.help = help

    @staticmethod
    def _from_env(name, default):
        env = os.environ.get(f"FLAGS_{name}")
        if env is None:
            return default
        if isinstance(default, bool):
            return env.lower() in ("1", "true", "yes")
        if isinstance(default, int):
            return int(env)
        if isinstance(default, float):
            return float(env)
        return env


def define_flag(name, default, help=""):
    with _lock:
        if name not in _registry:
            _registry[name] = Flag(name, default, help)
    return _registry[name]


def get_flags(flags):
    if isinstance(flags, str):
        flags = [flags]
    out = {}
    for f in flags:
        key = f[6:] if f.startswith("FLAGS_") else f
        if key in _registry:
            out[f] = _registry[key].value
        else:
            env = os.environ.get(f if f.startswith("FLAGS_") else f"FLAGS_{f}")
            out[f] = env
    return out


def set_flags(flags_dict):
    for k, v in flags_dict.items():
        key = k[6:] if k.startswith("FLAGS_") else k
        with _lock:
            if key not in _registry:
                _registry[key] = Flag(key, v)
            else:
                _registry[key].value = v


# core flags mirrored from paddle/common/flags.cc, with the reference's
# names and defaults (the port reads check_nan_inf; the others are records)
CHECK_NAN_INF = define_flag("check_nan_inf", False,
                            "check nan/inf after every op (debug)")
define_flag("benchmark", False, "synchronous timing mode")
define_flag("use_pallas_kernels", True,
            "use the hand-written kernels for the fused ops")
define_flag("allocator_strategy", "auto_growth",
            "memory allocator strategy (torch's caching allocator)")
define_flag("tpu_matmul_precision", "default", "matmul precision")
define_flag("spmd_rule_constraints", True,
            "insert per-op spmd-rule sharding constraints (embedding/"
            "attention/moe) when a hybrid mesh is active")
