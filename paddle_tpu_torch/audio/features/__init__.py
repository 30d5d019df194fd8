"""``paddle.audio.features`` (counterpart of
``paddle_tpu/audio/features/__init__.py``): ``Spectrogram``,
``MelSpectrogram``, ``LogMelSpectrogram`` and ``MFCC`` as ``Layer``s.

The window, the filter bank and the DCT are non-persistable buffers made
on the current device, and move with ``Layer.to``.
"""
from __future__ import annotations

import torch

from ...core.dispatch import apply_op
from ...nn.layer.layers import Layer
from .. import functional as AF

__all__ = ["Spectrogram", "MelSpectrogram", "LogMelSpectrogram", "MFCC"]


class Spectrogram(Layer):
    def __init__(self, n_fft=512, hop_length=None, win_length=None,
                 window="hann", power=2.0, center=True, pad_mode="reflect",
                 dtype="float32"):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length or n_fft // 4
        self.win_length = win_length or n_fft
        self.power = power
        self.center = center
        self.pad_mode = pad_mode
        self.register_buffer("window", AF.get_window(window, self.win_length),
                             persistable=False)

    def forward(self, x):
        from ... import signal

        spec = signal.stft(x, n_fft=self.n_fft, hop_length=self.hop_length,
                           win_length=self.win_length, window=self.window,
                           center=self.center, pad_mode=self.pad_mode)
        power = self.power
        return apply_op(lambda s: s.abs() if power == 1.0
                        else s.abs() ** power, spec, _op_name="spectrogram")


class MelSpectrogram(Layer):
    def __init__(self, sr=22050, n_fft=512, hop_length=None, win_length=None,
                 window="hann", power=2.0, center=True, pad_mode="reflect",
                 n_mels=64, f_min=50.0, f_max=None, htk=False, norm="slaney",
                 dtype="float32"):
        super().__init__()
        self.spectrogram = Spectrogram(n_fft, hop_length, win_length, window,
                                       power, center, pad_mode, dtype)
        self.register_buffer("fbank", AF.compute_fbank_matrix(
            sr=sr, n_fft=n_fft, n_mels=n_mels, f_min=f_min, f_max=f_max,
            htk=htk, norm=norm), persistable=False)

    def forward(self, x):
        return apply_op(lambda s, fb: torch.matmul(fb, s.float()).to(s.dtype),
                        self.spectrogram(x), self.fbank,
                        _op_name="mel_spectrogram")


class LogMelSpectrogram(Layer):
    def __init__(self, sr=22050, n_fft=512, hop_length=None, win_length=None,
                 window="hann", power=2.0, center=True, pad_mode="reflect",
                 n_mels=64, f_min=50.0, f_max=None, htk=False, norm="slaney",
                 ref_value=1.0, amin=1e-10, top_db=None, dtype="float32"):
        super().__init__()
        self.mel = MelSpectrogram(sr, n_fft, hop_length, win_length, window,
                                  power, center, pad_mode, n_mels, f_min,
                                  f_max, htk, norm, dtype)
        self.ref_value, self.amin, self.top_db = ref_value, amin, top_db

    def forward(self, x):
        return AF.power_to_db(self.mel(x), ref_value=self.ref_value,
                              amin=self.amin, top_db=self.top_db)


class MFCC(Layer):
    def __init__(self, sr=22050, n_mfcc=40, n_fft=512, hop_length=None,
                 win_length=None, window="hann", power=2.0, center=True,
                 pad_mode="reflect", n_mels=64, f_min=50.0, f_max=None,
                 htk=False, norm="slaney", ref_value=1.0, amin=1e-10,
                 top_db=None, dtype="float32"):
        super().__init__()
        self.logmel = LogMelSpectrogram(sr, n_fft, hop_length, win_length,
                                        window, power, center, pad_mode,
                                        n_mels, f_min, f_max, htk, norm,
                                        ref_value, amin, top_db, dtype)
        self.register_buffer("dct", AF.create_dct(n_mfcc, n_mels),
                             persistable=False)

    def forward(self, x):
        return apply_op(
            lambda s, d: torch.matmul(d.T, s.float()).to(s.dtype),
            self.logmel(x), self.dct, _op_name="mfcc")
