"""Classification evaluation: accuracy/precision/recall/F1 + confusion
matrix (counterpart of deeplearning4j_tpu/eval/evaluation.py).

The counts accumulate on the host in numpy: labels, predictions and masks
may be numpy arrays or tensors on any device (copied to the host once a
call), so `evaluate` hands the model's output over as it comes. Masked
time series as in the reference's evalTimeSeries; `stats()` prints the
JAX package's text.

Reference: eval/Evaluation.java, eval/ConfusionMatrix.java.
"""
from __future__ import annotations

import numpy as np

from ..device import host


class ConfusionMatrix:
    def __init__(self, n_classes):
        self.matrix = np.zeros((n_classes, n_classes), dtype=np.int64)

    def add(self, actual, predicted, count=1):
        self.matrix[actual, predicted] += count

    def get_count(self, actual, predicted):
        return int(self.matrix[actual, predicted])

    def __str__(self):
        return str(self.matrix)


class Evaluation:
    def __init__(self, n_classes=None, labels=None, top_n=1):
        """top_n > 1 also tracks top-N accuracy (reference: Evaluation.java
        topN constructor + topNAccuracy())."""
        self.n_classes = n_classes
        self.label_names = labels
        self.confusion = None
        self.top_n = int(top_n)
        self._top_n_correct = 0
        self._top_n_total = 0
        self._predictions = []  # Prediction meta (reference: eval/meta/)

    def _ensure(self, n):
        if self.confusion is None:
            self.n_classes = self.n_classes or n
            self.confusion = ConfusionMatrix(self.n_classes)

    def eval(self, labels, predictions, mask=None, record_meta_data=None):
        """labels/predictions: [batch, n_classes] probabilities/one-hot, or
        [batch, time, n_classes] with mask [batch, time]. record_meta_data:
        optional per-example metadata recorded onto Prediction objects for
        error introspection (reference: Evaluation.java eval(...,
        List<RecordMetaData>) + eval/meta/Prediction.java)."""
        labels = host(labels)
        predictions = host(predictions)
        mask = None if mask is None else host(mask)
        if labels.ndim == 3:
            b, t, c = labels.shape
            labels = labels.reshape(b * t, c)
            predictions = predictions.reshape(b * t, c)
            if mask is not None:
                m = np.asarray(mask).reshape(b * t) > 0
                labels, predictions = labels[m], predictions[m]
            record_meta_data = None  # per-example meta is 2-D only
        elif mask is not None:
            m = np.asarray(mask).reshape(-1) > 0
            labels, predictions = labels[m], predictions[m]
            if record_meta_data is not None:
                record_meta_data = [r for r, keep in zip(record_meta_data, m)
                                    if keep]
        self._ensure(labels.shape[-1])
        actual = np.argmax(labels, axis=-1)
        pred = np.argmax(predictions, axis=-1)
        np.add.at(self.confusion.matrix, (actual, pred), 1)
        if self.top_n > 1:
            k = min(self.top_n, predictions.shape[-1])
            topk = np.argpartition(-predictions, k - 1, axis=-1)[:, :k]
            self._top_n_correct += int(np.sum(topk == actual[:, None]))
            self._top_n_total += len(actual)
        if record_meta_data is not None:
            from .meta import Prediction
            for a, pr, meta in zip(actual, pred, record_meta_data):
                self._predictions.append(Prediction(a, pr, meta))

    def eval_time_series(self, labels, predictions, mask=None):
        self.eval(labels, predictions, mask)

    # ---- metrics ----------------------------------------------------------
    def _tp(self, i):
        return self.confusion.matrix[i, i]

    def _fp(self, i):
        return self.confusion.matrix[:, i].sum() - self._tp(i)

    def _fn(self, i):
        return self.confusion.matrix[i, :].sum() - self._tp(i)

    def accuracy(self):
        m = self.confusion.matrix
        total = m.sum()
        return float(np.trace(m) / total) if total else 0.0

    def precision(self, i=None):
        if i is not None:
            d = self._tp(i) + self._fp(i)
            return float(self._tp(i) / d) if d else 0.0
        vals = [self.precision(c) for c in range(self.n_classes)
                if (self.confusion.matrix[c, :].sum() + self.confusion.matrix[:, c].sum()) > 0]
        return float(np.mean(vals)) if vals else 0.0

    def recall(self, i=None):
        if i is not None:
            d = self._tp(i) + self._fn(i)
            return float(self._tp(i) / d) if d else 0.0
        vals = [self.recall(c) for c in range(self.n_classes)
                if self.confusion.matrix[c, :].sum() > 0]
        return float(np.mean(vals)) if vals else 0.0

    def f1(self, i=None):
        p, r = self.precision(i), self.recall(i)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def top_n_accuracy(self):
        """Fraction of examples whose true class is in the top-N predictions
        (reference: Evaluation.java topNAccuracy())."""
        if self.top_n <= 1:
            return self.accuracy()
        return (self._top_n_correct / self._top_n_total
                if self._top_n_total else 0.0)

    # ---- prediction-error introspection (reference: eval/meta/) -----------
    def get_prediction_errors(self):
        return [p for p in self._predictions if p.actual != p.predicted]

    def get_predictions_by_actual_class(self, i):
        return [p for p in self._predictions if p.actual == int(i)]

    def get_predictions_by_predicted_class(self, i):
        return [p for p in self._predictions if p.predicted == int(i)]

    def false_positive_rate(self, i):
        tn = self.confusion.matrix.sum() - self._tp(i) - self._fp(i) - self._fn(i)
        d = self._fp(i) + tn
        return float(self._fp(i) / d) if d else 0.0

    def stats(self):
        lines = [
            "========================= Evaluation =========================",
            f" Examples:  {int(self.confusion.matrix.sum())}",
            f" Accuracy:  {self.accuracy():.4f}",
            f" Precision: {self.precision():.4f}",
            f" Recall:    {self.recall():.4f}",
            f" F1 Score:  {self.f1():.4f}",
            "Confusion matrix (rows=actual, cols=predicted):",
            str(self.confusion),
        ]
        return "\n".join(lines)

    def merge(self, other):
        if other.confusion is not None:
            self._ensure(other.n_classes)
            self.confusion.matrix += other.confusion.matrix
        self._top_n_correct += other._top_n_correct
        self._top_n_total += other._top_n_total
        self._predictions.extend(other._predictions)
        return self
