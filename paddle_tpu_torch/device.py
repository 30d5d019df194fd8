"""Device resolution for the PyTorch port.

Every entry point of the port runs on the CUDA card unless its caller asks
for the CPU with ``device="cpu"``. There is no quiet fallback: asking for
CUDA (the default) where none is available raises, so a run can never
report CPU numbers under the card's name.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``. Raises ``RuntimeError`` when CUDA is asked
    for and missing, ``ValueError`` for device types the port does not
    run on."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"paddle_tpu_torch runs on cuda or cpu, got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions "
            "of its kernels on the CPU")
    return dev
