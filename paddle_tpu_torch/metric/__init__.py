"""``paddle.metric`` (port of ``paddle_tpu/metric/__init__.py``): the
``Metric`` base, ``Accuracy`` (top-k), ``Precision``, ``Recall``, ``Auc`` and
``accuracy``. Host numpy arithmetic, as the reference's: tensors are read
back once per ``compute``/``update``, and the results ``compute`` and
``accuracy`` return are CPU tensors."""
from __future__ import annotations

import abc

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _to_np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


class Metric(abc.ABC):
    """reference metrics.py Metric: reset/update/accumulate/name contract,
    with compute() as the preprocessing hook Model.fit calls on (pred, label)."""

    def __init__(self):
        pass

    @abc.abstractmethod
    def reset(self):
        raise NotImplementedError

    @abc.abstractmethod
    def update(self, *args):
        raise NotImplementedError

    @abc.abstractmethod
    def accumulate(self):
        raise NotImplementedError

    @abc.abstractmethod
    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    """reference metrics.py Accuracy (top-k)."""

    def __init__(self, topk=(1,), name=None, *args, **kwargs):
        super().__init__()
        self.topk = topk if isinstance(topk, (tuple, list)) else (topk,)
        self.maxk = max(self.topk)
        self._init_name(name)
        self.reset()

    def _init_name(self, name):
        name = name or "acc"
        if self.maxk != 1:
            self._name = [f"{name}_top{k}" for k in self.topk]
        else:
            self._name = [name]

    def compute(self, pred, label, *args):
        pred = _to_np(pred)
        label = _to_np(label)
        pred_idx = np.argsort(-pred, axis=-1)[..., : self.maxk]
        if label.ndim == pred.ndim:
            if label.shape[-1] == pred.shape[-1] and label.shape[-1] > 1:
                label = np.argmax(label, axis=-1)  # one-hot → index
            else:
                label = label[..., 0]  # paddle [N,1] index convention
        correct = (pred_idx == label[..., None]).astype(np.float32)
        return torch.from_numpy(correct)

    def update(self, correct, *args):
        correct = _to_np(correct)
        num_samples = int(np.prod(correct.shape[:-1]))
        accs = []
        for k in self.topk:
            num_corrects = correct[..., :k].sum()
            accs.append(float(num_corrects) / max(num_samples, 1))
            self.total[self.topk.index(k)] += float(num_corrects)
            self.count[self.topk.index(k)] += num_samples
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        return self._name


class Precision(Metric):
    """Binary precision (reference metrics.py Precision)."""

    def __init__(self, name="precision", *args, **kwargs):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _to_np(preds)
        labels = _to_np(labels)
        pred_bin = (preds > 0.5).astype(np.int32).reshape(-1)
        labels = labels.reshape(-1).astype(np.int32)
        self.tp += int(np.sum((pred_bin == 1) & (labels == 1)))
        self.fp += int(np.sum((pred_bin == 1) & (labels == 0)))

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        ap = self.tp + self.fp
        return float(self.tp) / ap if ap != 0 else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    """Binary recall (reference metrics.py Recall)."""

    def __init__(self, name="recall", *args, **kwargs):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _to_np(preds)
        labels = _to_np(labels)
        pred_bin = (preds > 0.5).astype(np.int32).reshape(-1)
        labels = labels.reshape(-1).astype(np.int32)
        self.tp += int(np.sum((pred_bin == 1) & (labels == 1)))
        self.fn += int(np.sum((pred_bin == 0) & (labels == 1)))

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        recall = self.tp + self.fn
        return float(self.tp) / recall if recall != 0 else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC via thresholded confusion histogram (reference metrics.py Auc)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc",
                 *args, **kwargs):
        super().__init__()
        self._num_thresholds = num_thresholds
        self._curve = curve
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _to_np(preds)
        labels = _to_np(labels).reshape(-1)
        if preds.ndim == 2 and preds.shape[1] == 2:
            pos_prob = preds[:, 1]
        else:
            pos_prob = preds.reshape(-1)
        bins = np.minimum(
            (pos_prob * self._num_thresholds).astype(np.int64),
            self._num_thresholds - 1)
        for b, l in zip(bins, labels):
            if l:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def reset(self):
        self._stat_pos = np.zeros(self._num_thresholds, np.int64)
        self._stat_neg = np.zeros(self._num_thresholds, np.int64)

    @staticmethod
    def trapezoid_area(x1, x2, y1, y2):
        return abs(x1 - x2) * (y1 + y2) / 2.0

    def accumulate(self):
        tot_pos = 0.0
        tot_neg = 0.0
        auc = 0.0
        idx = self._num_thresholds - 1
        while idx >= 0:
            tot_pos_prev = tot_pos
            tot_neg_prev = tot_neg
            tot_pos += self._stat_pos[idx]
            tot_neg += self._stat_neg[idx]
            auc += self.trapezoid_area(tot_neg, tot_neg_prev, tot_pos,
                                       tot_pos_prev)
            idx -= 1
        return (auc / tot_pos / tot_neg
                if tot_pos > 0.0 and tot_neg > 0.0 else 0.0)

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Functional top-k accuracy (reference: paddle.metric.accuracy)."""
    pred = _to_np(input)
    lab = _to_np(label)
    idx = np.argsort(-pred, axis=-1)[..., :k]
    if lab.ndim == pred.ndim:
        if lab.shape[-1] == pred.shape[-1] and lab.shape[-1] > 1:
            lab = np.argmax(lab, axis=-1)  # one-hot
        else:
            lab = lab[..., 0]              # paddle [N,1] index convention
    corr = np.any(idx == lab[..., None], axis=-1)
    return torch.tensor(np.asarray(corr.mean(), np.float32))
