"""``paddle.metric`` (counterpart of ``paddle_tpu/metric/__init__.py``).

The metrics accumulate on the host in numpy, as the reference's do: each
``compute`` or ``update`` fetches its inputs once. ``accuracy`` returns a
float32 scalar Tensor on the current place.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor


def _np(x):
    if isinstance(x, Tensor):
        return x.numpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# numpy 2 renamed trapz to trapezoid
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


class Metric:
    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        pred_np = _np(pred)
        label_np = _np(label)
        idx = np.argsort(-pred_np, axis=-1)[..., : self.maxk]
        if label_np.ndim == pred_np.ndim and label_np.shape[-1] == 1:
            label_np = label_np[..., 0]
        correct = idx == label_np[..., None]
        return correct

    def update(self, correct, *args):
        correct = _np(correct) if not isinstance(correct, np.ndarray) else correct
        accs = []
        for k in self.topk:
            num_corr = correct[..., :k].any(axis=-1).sum()
            total = correct.shape[0] if correct.ndim > 1 else correct.shape[0]
            total = int(np.prod(correct.shape[:-1]))
            self.total[self.topk.index(k)] += int(num_corr)
            self.count[self.topk.index(k)] += total
            accs.append(num_corr / max(total, 1))
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _np(preds)
        labels = _np(labels)
        pred_pos = (preds > 0.5).astype(np.int64).reshape(-1)
        labels = labels.astype(np.int64).reshape(-1)
        self.tp += int(((pred_pos == 1) & (labels == 1)).sum())
        self.fp += int(((pred_pos == 1) & (labels == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        return self.tp / max(self.tp + self.fp, 1)

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _np(preds)
        labels = _np(labels)
        pred_pos = (preds > 0.5).astype(np.int64).reshape(-1)
        labels = labels.astype(np.int64).reshape(-1)
        self.tp += int(((pred_pos == 1) & (labels == 1)).sum())
        self.fn += int(((pred_pos == 0) & (labels == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        return self.tp / max(self.tp + self.fn, 1)

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self.num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _np(preds)
        labels = _np(labels).reshape(-1)
        if preds.ndim == 2:
            pos_prob = preds[:, 1]
        else:
            pos_prob = preds.reshape(-1)
        bins = np.clip(
            (pos_prob * self.num_thresholds).astype(np.int64), 0, self.num_thresholds
        )
        for b, l in zip(bins, labels):
            if l:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1, np.int64)
        self._stat_neg = np.zeros(self.num_thresholds + 1, np.int64)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # walk thresholds high→low accumulating trapezoids
        pos_cum = np.cumsum(self._stat_pos[::-1])
        neg_cum = np.cumsum(self._stat_neg[::-1])
        tpr = pos_cum / tot_pos
        fpr = neg_cum / tot_neg
        return float(_trapezoid(tpr, fpr))

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    pred_np = _np(input)
    label_np = _np(label)
    idx = np.argsort(-pred_np, axis=-1)[..., :k]
    if label_np.ndim == pred_np.ndim and label_np.shape[-1] == 1:
        label_np = label_np[..., 0]
    corr = (idx == label_np[..., None]).any(axis=-1).mean()
    from ..device import _current_device

    return Tensor(torch.tensor(np.float32(corr), device=_current_device()))
