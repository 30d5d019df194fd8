"""``paddle.audio.functional`` (counterpart of
``paddle_tpu/audio/functional.py``): windows, the mel scale, the filter
bank, ``power_to_db`` and the DCT.

The windows, the filter bank and the DCT are computed in float64 numpy on
the host (the port's own copy of the reference's helpers) and land on the
current device as float32 Tensors.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.dispatch import apply_op

__all__ = ["get_window", "hz_to_mel", "mel_to_hz", "compute_fbank_matrix",
           "power_to_db", "create_dct", "fft_frequencies", "mel_frequencies"]


def _tensor(a):
    from ..ops.creation import to_tensor

    return to_tensor(np.asarray(a, np.float32))


def _window_array(window, win_length, fftbins=True):
    """The window as float64 numpy: ``hann``/``hanning``, ``hamming``,
    ``blackman`` (periodic where ``fftbins``), else ones."""
    n = win_length
    fns = {"hann": np.hanning, "hanning": np.hanning, "hamming": np.hamming,
           "blackman": np.blackman}
    if window not in fns:
        return np.ones(n)
    fn = fns[window]
    return fn(n + 1)[:-1] if fftbins else fn(n)


def get_window(window, win_length, fftbins=True, dtype="float32"):
    return _tensor(_window_array(window, win_length, fftbins))


def hz_to_mel(freq, htk=False):
    if htk:
        return 2595.0 * np.log10(1.0 + np.asarray(freq) / 700.0)
    f = np.asarray(freq, np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    f_log = np.maximum(f, min_log_hz)   # the log of the unselected arm
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(f_log / min_log_hz) / logstep, mels)


def mel_to_hz(mel, htk=False):
    if htk:
        return 700.0 * (10.0 ** (np.asarray(mel) / 2595.0) - 1.0)
    m = np.asarray(mel, np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def _fbank_array(sr, n_fft, n_mels=64, f_min=0.0, f_max=None, htk=False,
                norm="slaney"):
    """The triangular mel filters ``[n_mels, n_fft // 2 + 1]``, float64."""
    f_max = f_max or sr / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sr / 2.0, n_bins)
    mel_pts = np.linspace(hz_to_mel(f_min, htk), hz_to_mel(f_max, htk),
                          n_mels + 2)
    hz_pts = mel_to_hz(mel_pts, htk)
    fb = np.zeros((n_mels, n_bins))
    for m in range(n_mels):
        lo, c, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (fft_freqs - lo) / max(c - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - c, 1e-10)
        fb[m] = np.maximum(0, np.minimum(up, down))
    if norm == "slaney":
        fb *= (2.0 / (hz_pts[2:] - hz_pts[:-2]))[:, None]
    return fb


def compute_fbank_matrix(sr, n_fft, n_mels=64, f_min=0.0, f_max=None,
                         htk=False, norm="slaney", dtype="float32"):
    return _tensor(_fbank_array(sr, n_fft, n_mels, f_min, f_max, htk, norm))


def power_to_db(spect, ref_value=1.0, amin=1e-10, top_db=80.0):
    """``10 log10(max(amin, s) / ref)``, floored at the whole tensor's
    maximum less ``top_db`` where it is given."""
    def _p2db(s):
        log_spec = 10.0 * torch.log10(s.clamp_min(amin))
        log_spec = log_spec - 10.0 * math.log10(max(amin, ref_value))
        if top_db is not None:
            log_spec = torch.maximum(log_spec, log_spec.max() - top_db)
        return log_spec

    return apply_op(_p2db, spect, _op_name="power_to_db")


def _dct_array(n_mfcc, n_mels, norm="ortho"):
    """The DCT-II matrix ``[n_mels, n_mfcc]``, float64."""
    n = np.arange(n_mels)
    k = np.arange(n_mfcc)[:, None]
    dct = np.cos(math.pi / n_mels * (n + 0.5) * k)
    if norm == "ortho":
        dct[0] *= 1.0 / math.sqrt(2.0)
        dct *= math.sqrt(2.0 / n_mels)
    return dct.T


def create_dct(n_mfcc, n_mels, norm="ortho"):
    return _tensor(_dct_array(n_mfcc, n_mels, norm))


def fft_frequencies(sr, n_fft, dtype="float32"):
    from ..ops.creation import to_tensor

    return to_tensor(np.linspace(0, sr / 2, 1 + n_fft // 2).astype(dtype))


def mel_frequencies(n_mels=64, f_min=0.0, f_max=11025.0, htk=False,
                    dtype="float32"):
    from ..ops.creation import to_tensor

    mels = np.linspace(hz_to_mel(f_min, htk), hz_to_mel(f_max, htk), n_mels)
    return to_tensor(np.asarray([mel_to_hz(m, htk) for m in mels]
                                ).astype(dtype))
