"""``paddle.audio.backends`` (counterpart of
``paddle_tpu/audio/backends.py``): 16-bit PCM wav files through the
standard library's ``wave``."""
from __future__ import annotations

import wave

import numpy as np

__all__ = ["AudioInfo", "info", "load", "save", "list_available_backends",
           "get_current_backend", "set_backend"]


class AudioInfo:
    def __init__(self, sample_rate, num_samples, num_channels,
                 bits_per_sample):
        self.sample_rate = sample_rate
        self.num_samples = num_samples
        self.num_channels = num_channels
        self.bits_per_sample = bits_per_sample


def info(filepath):
    with wave.open(str(filepath), "rb") as w:
        return AudioInfo(w.getframerate(), w.getnframes(), w.getnchannels(),
                         w.getsampwidth() * 8)


def load(filepath, frame_offset=0, num_frames=-1, normalize=True,
         channels_first=True):
    """``(waveform, sample_rate)``: the waveform ``[channels, frames]`` (or
    transposed) on the current device, in [-1, 1) where ``normalize``."""
    from ..ops.creation import to_tensor

    with wave.open(str(filepath), "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        w.setpos(frame_offset)
        raw = w.readframes(n - frame_offset if num_frames < 0 else num_frames)
    data = np.frombuffer(raw, dtype=np.int16).reshape(-1, ch)
    if normalize:
        data = data.astype(np.float32) / 32768.0
    return to_tensor(np.ascontiguousarray(data.T if channels_first
                                          else data)), sr


def save(filepath, src, sample_rate, channels_first=True,
         bits_per_sample=16):
    arr = np.asarray(src.numpy() if hasattr(src, "numpy") else src)
    if channels_first:
        arr = arr.T
    if arr.dtype != np.int16:
        arr = np.clip(arr * 32768.0, -32768, 32767).astype(np.int16)
    with wave.open(str(filepath), "wb") as w:
        w.setnchannels(arr.shape[1] if arr.ndim > 1 else 1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(np.ascontiguousarray(arr).tobytes())


def list_available_backends():
    return ["wave"]


def get_current_backend():
    return "wave"


def set_backend(backend_name):
    pass
