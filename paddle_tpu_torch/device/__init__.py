"""Device resolution and the Paddle ``Place`` surface for the port.

Every entry point of the port runs on the CUDA card unless its caller asks
for the CPU with ``device="cpu"``. There is no quiet fallback: asking for
CUDA (the default) where none is available raises, so a run can never
report CPU numbers under the card's name.

The Paddle surface (counterpart of ``paddle_tpu/device/__init__.py``)
keeps one current place per thread. It is not set at import: the first
tensor made without a place resolves it through :func:`resolve_device`
(the card), so ``import paddle_tpu_torch`` works where there is no card
and the first tensor raises there. ``set_device("cpu")`` asks for the
CPU. On the port the accelerator is CUDA: ``CUDAPlace`` is first class,
``TPUPlace``, ``XPUPlace`` and ``CustomPlace`` name the card for source
compatibility, as the reference's CUDA names name its TPU.
"""
from __future__ import annotations

import contextlib
import threading

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


class Place:
    device_type = "unknown"

    def __init__(self, device_id: int = 0):
        self._device_id = int(device_id)

    def get_device_id(self) -> int:
        return self._device_id

    def __repr__(self):
        return f"Place({self.device_type}:{self._device_id})"

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self._device_id == other._device_id)

    def __hash__(self):
        return hash((self.device_type, self._device_id))

    def is_gpu_place(self):
        return self.device_type == "gpu"

    def is_cpu_place(self):
        return self.device_type == "cpu"

    def is_tpu_place(self):
        return False

    def torch_device(self) -> torch.device:
        if self.is_cpu_place():
            return torch.device("cpu")
        return torch.device("cuda", self._device_id)


class CPUPlace(Place):
    device_type = "cpu"


class CUDAPlace(Place):
    device_type = "gpu"


class CUDAPinnedPlace(CPUPlace):
    pass


class TPUPlace(CUDAPlace):
    """Source compatibility: code written for the reference's TPU runs on
    the card."""


class XPUPlace(CUDAPlace):
    pass


class CustomPlace(CUDAPlace):
    def __init__(self, dev_type="gpu", device_id=0):
        super().__init__(device_id)


_state = threading.local()


def _place_of(device: torch.device) -> Place:
    if device.type == "cpu":
        return CPUPlace(0)
    return CUDAPlace(device.index or 0)


def set_device(device: str):
    """``paddle.device.set_device``: ``'gpu'``, ``'gpu:1'``, ``'cuda'``,
    ``'cpu'``; ``'tpu'``/``'xpu'`` name the card. Raises where the card is
    asked for and missing."""
    device = str(device)
    name = device.split(":")[0]
    idx = int(device.split(":")[1]) if ":" in device else 0
    dev = resolve_device("cpu" if name == "cpu" else f"cuda:{idx}")
    _state.place = _place_of(dev)
    _state.device = dev
    return get_device()


def _current_device() -> torch.device:
    """The torch device of the current place; the card at first use."""
    dev = getattr(_state, "device", None)
    if dev is None:
        dev = resolve_device(None)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        _state.device = dev
        _state.place = _place_of(dev)
    return dev


@contextlib.contextmanager
def _place_scope(dev: torch.device):
    """This thread's place is ``dev`` inside the block (the DataLoader's
    seam: a batch is built on the device its iterator captured, in
    whichever thread builds it)."""
    prev = (getattr(_state, "device", None), getattr(_state, "place", None))
    _state.device, _state.place = dev, _place_of(dev)
    try:
        yield
    finally:
        _state.device, _state.place = prev


def _current_place() -> Place:
    _current_device()
    return _state.place


def get_device() -> str:
    p = _current_place()
    return f"{p.device_type}:{p.get_device_id()}"


def to_torch_device(place) -> torch.device:
    """A ``Place``, a device string or a ``torch.device`` -> torch device."""
    if place is None:
        return _current_device()
    if isinstance(place, Place):
        return resolve_device(place.torch_device())
    if isinstance(place, str):
        name = place.split(":")[0]
        if name in ("gpu", "tpu", "xpu"):
            place = "cuda" + place[len(name):]
    return resolve_device(place)


def device_count() -> int:
    return torch.cuda.device_count()


cuda_device_count = device_count


def is_compiled_with_cuda() -> bool:
    return torch.version.cuda is not None


def is_compiled_with_rocm() -> bool:
    return False


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_tpu() -> bool:
    return False


def get_all_device_type():
    return ["cpu", "gpu"]


def get_available_device():
    return [f"gpu:{i}" for i in range(device_count())]


def get_cudnn_version():
    """cuDNN's version as torch reports it (an int such as 91002), None
    without cuDNN. The reference answers None on its TPU."""
    return torch.backends.cudnn.version()


class IPUPlace:
    """Named for source compatibility: the port runs on no IPU."""


def is_compiled_with_ipu():
    return False


def is_compiled_with_cinn():
    return False


def is_compiled_with_distribute():
    """Whether torch was built with ``torch.distributed``."""
    return torch.distributed.is_available()


def is_compiled_with_custom_device(device_type=None):
    return False


def get_all_custom_device_type():
    return []


def get_available_custom_device():
    return []


def synchronize(device=None):
    """Block until all queued work on the card completes."""
    if torch.cuda.is_available():
        torch.cuda.synchronize(device)


class Stream:
    """``paddle.device.Stream`` over ``torch.cuda.Stream``."""

    def __init__(self, device=None, priority=2):
        self.device = device
        self._stream = torch.cuda.Stream(priority=0 if priority >= 2 else -1)

    def synchronize(self):
        self._stream.synchronize()

    def wait_event(self, event):
        self._stream.wait_event(event._event)

    def wait_stream(self, stream):
        self._stream.wait_stream(stream._stream)

    def record_event(self, event=None):
        event = event or Event()
        event.record(self)
        return event

    def query(self):
        return self._stream.query()


class Event:
    """``paddle.device.Event`` over ``torch.cuda.Event``."""

    def __init__(self, device=None, enable_timing=False, blocking=False,
                 interprocess=False):
        self._event = torch.cuda.Event(enable_timing=enable_timing,
                                       blocking=blocking,
                                       interprocess=interprocess)

    def record(self, stream=None):
        self._event.record(None if stream is None else stream._stream)

    def query(self):
        return self._event.query()

    def synchronize(self):
        self._event.synchronize()

    def elapsed_time(self, end):
        return self._event.elapsed_time(end._event)


def current_stream(device=None):
    s = Stream.__new__(Stream)
    s.device = device
    s._stream = torch.cuda.current_stream(device)
    return s


def set_stream(stream):
    torch.cuda.set_stream(stream._stream)
    return stream


@contextlib.contextmanager
def stream_guard(stream):
    with torch.cuda.stream(stream._stream):
        yield


from . import cuda  # noqa: E402,F401
