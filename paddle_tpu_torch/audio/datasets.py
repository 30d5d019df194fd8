"""``paddle.audio.datasets`` (counterpart of
``paddle_tpu/audio/datasets.py``): the reference's seeded stand-ins for
corpora that need a download."""
from __future__ import annotations

import numpy as np

from ..io import Dataset

__all__ = ["TESS", "ESC50"]


class TESS(Dataset):
    def __init__(self, mode="train", n_fold=5, split=1, feat_type="raw",
                 archive=None, **kw):
        rng = np.random.RandomState(0 if mode == "train" else 1)
        self.n = 64
        self.waves = [rng.randn(16000).astype(np.float32)
                      for _ in range(self.n)]
        self.labels = rng.randint(0, 7, (self.n,))

    def __getitem__(self, idx):
        return self.waves[idx], int(self.labels[idx])

    def __len__(self):
        return self.n


class ESC50(TESS):
    def __init__(self, mode="train", split=1, feat_type="raw", **kw):
        super().__init__(mode)
        self.labels = np.random.RandomState(2).randint(0, 50, (self.n,))
