"""Hand-written Hopper kernels: build, load, route and count.

Counterpart of ``paddle_tpu/ops/pallas/__init__.py``, without its force
knob or interpret mode: the device of the tensors decides the route.

- A CUDA tensor goes to the kernel. If the kernel cannot be built or its
  launch is refused, the call raises; there is no fallback.
- A CPU tensor goes to the kernel's plain PyTorch version.
- Any other device raises.

CUDA C++ sources under ``csrc/`` are compiled by ``nvcc`` for ``sm_90a``
into ``build/kernels/lib<name>.so`` at the root of the checkout, at first
use, one ``nvcc`` per source, all started together (a source is rebuilt
when it or a shared ``csrc/*.cuh`` header is newer than its library).
Each library exposes a
plain C launcher loaded with ``ctypes``; pointers and the stream travel as
``c_void_p`` (declared in the launcher's ``argtypes``) and the launcher
returns ``cudaGetLastError()``, which the wrapper checks.

Each kernel wrapper adds one to ``LAUNCHES[name]`` where it launches the
kernel and nowhere else, so a run can show that its main path went through
the kernels.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

#: kernel name -> launches on CUDA tensors since the last reset
LAUNCHES = {"paged_attention": 0, "rms_norm": 0, "flash_attention_fwd": 0,
            "flash_attention_bwd": 0, "swiglu_down": 0,
            "paged_attention_int8": 0, "decode_attention": 0,
            "add_rms_norm": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0}

_libs: dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (run the plain version). Mixed or other devices raise."""
    types = {t.device.type for t in tensors}
    if types == {"cuda"}:
        return True
    if types == {"cpu"}:
        return False
    raise ValueError(f"kernel operands must all lie on cuda or all on cpu, "
                     f"got {sorted(types)}")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of paddle_tpu_torch "
                       "are built from source at first use")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def build(force: bool = False,
          ptxas_info: bool = False) -> tuple[float, dict[str, str]]:
    """Compile every ``csrc/*.cu`` that has no up-to-date library, one
    ``nvcc`` per source, in parallel. Returns the seconds it took and the
    compiler's output by source name; raises with that output when a
    build fails. ``ptxas_info`` asks ptxas for each kernel's registers,
    shared memory and spills."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    headers = max((h.stat().st_mtime for h in CSRC.glob("*.cuh")),
                  default=0.0)
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        out = _lib_path(src.stem)
        newest = max(src.stat().st_mtime, headers)
        if not force and out.exists() and out.stat().st_mtime >= newest:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas=-v"] if ptxas_info else []),
               "-o", str(tmp), str(src)]
        jobs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors, logs = [], {}
    for src, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        logs[src.name] = log
        if proc.returncode != 0:
            errors.append(f"{src.name}:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0, logs


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``lib<name>.so``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build()
        lib = ctypes.CDLL(str(_lib_path(name)))
        _libs[name] = lib
    return lib


def check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")


# Both return plain ints: every launcher declares its pointer and stream
# arguments as c_void_p, so ctypes passes them at full width, and a call
# builds no ctypes or torch.cuda.Stream objects.
def stream_handle(t: torch.Tensor) -> int:
    """The cudaStream_t of PyTorch's current stream on t's device."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()
