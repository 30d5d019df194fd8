"""``paddle.signal``: ``frame``, ``overlap_add``, ``stft`` and ``istft``
(counterpart of ``paddle_tpu/signal.py``).

``frame`` is ``unfold``; the overlap-add of ``overlap_add`` and ``istft``
is one ``F.fold`` over all frames (the reference adds each frame in a
Python loop, two launches a frame on the card), and ``istft``'s window
envelope is the fold of the squared window. ``stft`` pads, frames,
windows and takes ``torch.fft.rfft`` (or ``fft``) of the frames, as the
reference composes it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .core.dispatch import apply_op

__all__ = ["frame", "overlap_add", "stft", "istft"]


def frame(x, frame_length, hop_length, axis=-1, name=None):
    """Overlapping frames. ``axis=-1``: ``[..., L] -> [..., frame_length,
    n]``; ``axis=0``: ``[L, ...] -> [n, frame_length, ...]``."""
    def _fr(a):
        out = a.movedim(axis, -1).unfold(-1, frame_length, hop_length)
        if axis == 0:
            return out.movedim((-2, -1), (0, 1))
        return out.transpose(-1, -2)

    return apply_op(_fr, x, _op_name="frame")


def _overlap_add(frames, hop):
    """``frames`` [..., fl, n] -> [..., (n - 1) * hop + fl], one fold."""
    fl, n = frames.shape[-2], frames.shape[-1]
    lead = frames.shape[:-2]
    out_len = (n - 1) * hop + fl
    out = F.fold(frames.reshape(-1, fl, n), output_size=(1, out_len),
                 kernel_size=(1, fl), stride=(1, hop))
    return out.reshape(tuple(lead) + (out_len,))


def overlap_add(x, hop_length, axis=-1, name=None):
    """Inverse of :func:`frame`. ``axis=-1``: input ``[..., frame_length,
    n]``; ``axis=0``: input ``[n, frame_length, ...]``."""
    def _oa(a):
        frames = a.movedim((0, 1), (-1, -2)) if axis == 0 else a
        out = _overlap_add(frames, hop_length)
        return out.movedim(-1, 0) if axis == 0 else out

    return apply_op(_oa, x, _op_name="overlap_add")


def _padded_window(w, wl, n_fft, dtype, device):
    if w is None:
        w = torch.ones(wl, dtype=dtype, device=device)
    if wl < n_fft:
        lpad = (n_fft - wl) // 2
        w = F.pad(w, (lpad, n_fft - wl - lpad))
    return w


def stft(x, n_fft, hop_length=None, win_length=None, window=None,
         center=True, pad_mode="reflect", normalized=False, onesided=True,
         name=None):
    """``[..., L]`` -> ``[..., freq, n_frames]`` complex."""
    hop = hop_length or n_fft // 4
    wl = win_length or n_fft

    def _stft(a, w):
        w = _padded_window(w, wl, n_fft, a.dtype, a.device)
        if center:
            pad = n_fft // 2
            lead = a.shape[:-1]
            a = F.pad(a.reshape(-1, 1, a.shape[-1]), (pad, pad),
                      mode=pad_mode).reshape(tuple(lead) + (-1,))
        frames = a.unfold(-1, n_fft, hop) * w              # [..., n, n_fft]
        spec = (torch.fft.rfft(frames, dim=-1) if onesided
                else torch.fft.fft(frames, dim=-1))
        if normalized:
            spec = spec / math.sqrt(n_fft)
        return spec.transpose(-1, -2)

    return apply_op(_stft, x, window, _op_name="stft")


def istft(x, n_fft, hop_length=None, win_length=None, window=None,
          center=True, normalized=False, onesided=True, length=None,
          return_complex=False, name=None):
    """``[..., freq, n_frames]`` -> ``[..., L]``: the inverse transform of
    each frame, windowed, overlap-added and divided by the window's
    squared envelope (floored at 1e-10)."""
    hop = hop_length or n_fft // 4
    wl = win_length or n_fft

    def _istft(spec, w):
        w = _padded_window(w, wl, n_fft, torch.float32, spec.device)
        frames = spec.transpose(-1, -2)                      # [..., n, freq]
        if normalized:
            frames = frames * math.sqrt(n_fft)
        t = (torch.fft.irfft(frames, n=n_fft, dim=-1) if onesided
             else torch.fft.ifft(frames, dim=-1).real)
        t = t * w
        n = t.shape[-2]
        out = _overlap_add(t.transpose(-1, -2), hop)
        wsum = _overlap_add((w * w)[:, None].expand(n_fft, n), hop)
        out = out / wsum.clamp_min(1e-10)
        if center:
            pad = n_fft // 2
            out = out[..., pad:out.shape[-1] - pad]
        if length is not None:
            out = out[..., :length]
        return out

    return apply_op(_istft, x, window, _op_name="istft")
