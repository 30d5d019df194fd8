"""``paddle.text`` (counterpart of ``paddle_tpu/text/__init__.py``):
``viterbi_decode`` and ``ViterbiDecoder``, and the reference's seeded
stand-ins for the text corpora (a download is never made).

``viterbi_decode`` honours ``lengths``: past its own length a sequence's
score stops moving, its best path ends at its last real step, and its
path reads 0 at the padded steps (the reference ignores ``lengths`` and
decodes every sequence to the full width). ``include_bos_eos_tag`` is
accepted and not read, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dispatch import apply_op
from ..io import Dataset

__all__ = ["Imdb", "UCIHousing", "Conll05st", "Imikolov", "Movielens",
           "WMT14", "WMT16", "viterbi_decode", "ViterbiDecoder"]


class Imdb(Dataset):
    def __init__(self, data_file=None, mode="train", cutoff=150):
        rng = np.random.RandomState(0 if mode == "train" else 1)
        n = 256
        self.docs = [rng.randint(1, 5000, (rng.randint(20, 200),))
                     for _ in range(n)]
        self.labels = rng.randint(0, 2, (n,))

    def __getitem__(self, idx):
        return self.docs[idx], int(self.labels[idx])

    def __len__(self):
        return len(self.docs)


class UCIHousing(Dataset):
    def __init__(self, data_file=None, mode="train"):
        rng = np.random.RandomState(0 if mode == "train" else 1)
        n = 404 if mode == "train" else 102
        self.x = rng.randn(n, 13).astype(np.float32)
        w = rng.randn(13).astype(np.float32)
        self.y = (self.x @ w + 0.1 * rng.randn(n)).astype(np.float32)[:, None]

    def __getitem__(self, idx):
        return self.x[idx], self.y[idx]

    def __len__(self):
        return len(self.x)


def viterbi_decode(potentials, transition_params, lengths=None,
                   include_bos_eos_tag=True, name=None):
    """The best tag path of a linear-chain CRF: ``potentials`` [B, T, N],
    ``transition_params`` [N, N] (from, to), ``lengths`` [B] or None (all
    T). Returns ``(scores [B], path [B, T] int64)``."""
    def _vd(pot, trans, lens):
        b, t, _ = pot.shape
        steps = torch.arange(t, device=pot.device)
        if lens is None:
            live = torch.ones(b, t, dtype=torch.bool, device=pot.device)
        else:
            live = steps[None] < lens.to(pot.device)[:, None]
        score = pot[:, 0]
        keep = torch.arange(pot.shape[-1], device=pot.device).expand(
            b, -1)
        backs = []
        for i in range(1, t):
            cand = score[:, :, None] + trans[None]
            best, idx = cand.amax(dim=1), cand.argmax(dim=1)
            on = live[:, i, None]
            score = torch.where(on, best + pot[:, i], score)
            backs.append(torch.where(on, idx, keep))
        tag = score.argmax(-1)
        path = [tag]
        for idx in reversed(backs):
            tag = idx.gather(1, tag[:, None])[:, 0]
            path.append(tag)
        path = torch.stack(path[::-1], 1)
        return score.max(-1).values, torch.where(live, path, 0)

    return apply_op(_vd, potentials, transition_params, lengths,
                    _op_name="viterbi")


class Conll05st(Dataset):
    def __init__(self, data_file=None, mode="train", **kw):
        rng = np.random.RandomState(0 if mode == "train" else 1)
        self.samples = [
            tuple(rng.randint(0, 100, (rng.randint(5, 30),))
                  for _ in range(8)) + (rng.randint(0, 20, (30,)),)
            for _ in range(128)]

    def __getitem__(self, idx):
        return self.samples[idx]

    def __len__(self):
        return len(self.samples)


class Imikolov(Dataset):
    def __init__(self, data_file=None, data_type="NGRAM", window_size=5,
                 mode="train", min_word_freq=50, **kw):
        rng = np.random.RandomState(0 if mode == "train" else 1)
        self.window = window_size
        self.data = [rng.randint(1, 2000, (window_size,)) for _ in range(512)]

    def __getitem__(self, idx):
        return tuple(self.data[idx])

    def __len__(self):
        return len(self.data)


class Movielens(Dataset):
    def __init__(self, data_file=None, mode="train", **kw):
        rng = np.random.RandomState(0 if mode == "train" else 1)
        self.rows = [
            (rng.randint(1, 6000), rng.randint(0, 2), rng.randint(1, 8),
             rng.randint(0, 21), rng.randint(1, 4000),
             rng.randint(0, 19, (3,)), rng.randint(1, 6))
            for _ in range(256)]

    def __getitem__(self, idx):
        return self.rows[idx]

    def __len__(self):
        return len(self.rows)


class WMT14(Dataset):
    def __init__(self, data_file=None, mode="train", dict_size=30000, **kw):
        rng = np.random.RandomState(0 if mode == "train" else 1)
        self.pairs = [
            (rng.randint(1, dict_size, (rng.randint(5, 25),)),
             rng.randint(1, dict_size, (rng.randint(5, 25),)),
             rng.randint(1, dict_size, (rng.randint(5, 25),)))
            for _ in range(128)]

    def __getitem__(self, idx):
        return self.pairs[idx]

    def __len__(self):
        return len(self.pairs)


class WMT16(WMT14):
    def __init__(self, data_file=None, mode="train", src_dict_size=30000,
                 trg_dict_size=30000, lang="en", **kw):
        super().__init__(data_file, mode, max(src_dict_size, 2))


class ViterbiDecoder:
    """``viterbi_decode`` with the transitions held."""

    def __init__(self, transitions, include_bos_eos_tag=True, name=None):
        self.transitions = transitions
        self.include_bos_eos_tag = include_bos_eos_tag

    def __call__(self, potentials, lengths=None):
        return viterbi_decode(potentials, self.transitions, lengths,
                              self.include_bos_eos_tag)
