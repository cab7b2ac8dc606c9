"""ROC / AUC evaluation (binary and multiclass, thresholded), and
regression metrics (counterpart of deeplearning4j_tpu/eval/roc.py; host
numpy over inputs that may be tensors on any device).

Reference: eval/ROC.java, eval/ROCMultiClass.java — threshold-stepped ROC
curve: `thresholdSteps` evenly spaced thresholds in [0,1]; at each threshold
count TP/FP/TN/FN, giving (fpr, tpr) points; AUC by trapezoidal integration.
Same contract here, vectorized over thresholds with numpy.
"""
from __future__ import annotations

import numpy as np

from ..device import host


class ROC:
    """Binary ROC. Labels may be single-column {0,1} or two-column one-hot
    (probability of class 1 taken from the last column), matching the
    reference's ROC.eval handling."""

    def __init__(self, threshold_steps=100):
        self.threshold_steps = int(threshold_steps)
        self._scores = []   # P(class=1)
        self._labels = []   # {0,1}

    def eval(self, labels, predictions, mask=None):
        labels = host(labels, np.float64)
        predictions = host(predictions, np.float64)
        mask = None if mask is None else host(mask)
        if labels.ndim == 3:  # time series: flatten [b,t,c] -> [b*t,c]
            labels = labels.reshape(-1, labels.shape[-1])
            predictions = predictions.reshape(-1, predictions.shape[-1])
            if mask is not None:
                m = np.asarray(mask).reshape(-1) > 0
                labels, predictions = labels[m], predictions[m]
        elif mask is not None:
            m = np.asarray(mask).reshape(-1) > 0
            labels, predictions = labels[m], predictions[m]
        if labels.ndim == 1:
            labels = labels[:, None]
        if predictions.ndim == 1:
            predictions = predictions[:, None]
        # column selection is per-array: a 2-column array is one-hot/softmax
        # (class-1 prob in the last column); a 1-column array is already the
        # {0,1} indicator / P(class 1)
        lab = labels[:, 1] if labels.shape[-1] == 2 else labels[:, 0]
        prob = predictions[:, 1] if predictions.shape[-1] == 2 else predictions[:, 0]
        self._labels.append(lab)
        self._scores.append(prob)

    eval_time_series = eval

    def _collected(self):
        if not self._labels:
            return np.zeros(0), np.zeros(0)
        return np.concatenate(self._labels), np.concatenate(self._scores)

    def get_roc_curve(self):
        """[(threshold, fpr, tpr)] over threshold_steps+1 thresholds."""
        lab, prob = self._collected()
        pos = lab > 0.5
        n_pos, n_neg = pos.sum(), (~pos).sum()
        out = []
        for k in range(self.threshold_steps + 1):
            t = k / self.threshold_steps
            pred_pos = prob >= t
            tp = np.sum(pred_pos & pos)
            fp = np.sum(pred_pos & ~pos)
            tpr = tp / n_pos if n_pos else 0.0
            fpr = fp / n_neg if n_neg else 0.0
            out.append((t, float(fpr), float(tpr)))
        return out

    def get_precision_recall_curve(self):
        lab, prob = self._collected()
        pos = lab > 0.5
        n_pos = pos.sum()
        out = []
        for k in range(self.threshold_steps + 1):
            t = k / self.threshold_steps
            pred_pos = prob >= t
            tp = np.sum(pred_pos & pos)
            fp = np.sum(pred_pos & ~pos)
            prec = tp / (tp + fp) if (tp + fp) else 1.0
            rec = tp / n_pos if n_pos else 0.0
            out.append((t, float(prec), float(rec)))
        return out

    def calculate_auc(self):
        """Trapezoidal AUC over the threshold-stepped curve (reference:
        ROC.calculateAUC)."""
        curve = self.get_roc_curve()
        pts = sorted((fpr, tpr) for _, fpr, tpr in curve)
        auc = 0.0
        for (x0, y0), (x1, y1) in zip(pts[:-1], pts[1:]):
            auc += (x1 - x0) * (y0 + y1) / 2.0
        return float(auc)

    def merge(self, other):
        self._labels.extend(other._labels)
        self._scores.extend(other._scores)
        return self


class ROCMultiClass:
    """One-vs-all ROC per class (reference: eval/ROCMultiClass.java)."""

    def __init__(self, threshold_steps=100):
        self.threshold_steps = int(threshold_steps)
        self._per_class = {}

    def eval(self, labels, predictions, mask=None):
        labels = host(labels, np.float64)
        predictions = host(predictions, np.float64)
        mask = None if mask is None else host(mask)
        if labels.ndim == 3:
            labels = labels.reshape(-1, labels.shape[-1])
            predictions = predictions.reshape(-1, predictions.shape[-1])
        if mask is not None:
            m = np.asarray(mask).reshape(-1) > 0
            labels, predictions = labels[m], predictions[m]
        n = labels.shape[-1]
        for c in range(n):
            roc = self._per_class.setdefault(c, ROC(self.threshold_steps))
            roc.eval(labels[:, c], predictions[:, c])

    eval_time_series = eval

    def calculate_auc(self, class_idx):
        return self._per_class[class_idx].calculate_auc()

    def calculate_average_auc(self):
        if not self._per_class:
            return 0.0
        return float(np.mean([r.calculate_auc() for r in self._per_class.values()]))

    def get_roc_curve(self, class_idx):
        return self._per_class[class_idx].get_roc_curve()

    def merge(self, other):
        for c, r in other._per_class.items():
            if c in self._per_class:
                self._per_class[c].merge(r)
            else:
                self._per_class[c] = r
        return self


class RegressionEvaluation:
    """Per-column regression metrics: MSE, MAE, RMSE, RSE, R^2, correlation
    (reference: eval/RegressionEvaluation.java)."""

    def __init__(self, n_columns=None, column_names=None):
        self.column_names = column_names
        self.n_columns = n_columns or (len(column_names) if column_names else None)
        self._labels = []
        self._preds = []

    def eval(self, labels, predictions, mask=None):
        labels = host(labels, np.float64)
        predictions = host(predictions, np.float64)
        mask = None if mask is None else host(mask)
        if labels.ndim == 3:
            labels = labels.reshape(-1, labels.shape[-1])
            predictions = predictions.reshape(-1, predictions.shape[-1])
            if mask is not None:
                m = np.asarray(mask).reshape(-1) > 0
                labels, predictions = labels[m], predictions[m]
        elif mask is not None:
            m = np.asarray(mask).reshape(-1) > 0
            labels, predictions = labels[m], predictions[m]
        if labels.ndim == 1:
            labels = labels[:, None]
            predictions = predictions[:, None]
        self.n_columns = self.n_columns or labels.shape[-1]
        self._labels.append(labels)
        self._preds.append(predictions)

    eval_time_series = eval

    def _col(self):
        return np.concatenate(self._labels), np.concatenate(self._preds)

    def mean_squared_error(self, col):
        y, p = self._col()
        return float(np.mean((y[:, col] - p[:, col]) ** 2))

    def mean_absolute_error(self, col):
        y, p = self._col()
        return float(np.mean(np.abs(y[:, col] - p[:, col])))

    def root_mean_squared_error(self, col):
        return float(np.sqrt(self.mean_squared_error(col)))

    def relative_squared_error(self, col):
        y, p = self._col()
        num = np.sum((y[:, col] - p[:, col]) ** 2)
        den = np.sum((y[:, col] - y[:, col].mean()) ** 2)
        return float(num / den) if den else float("inf")

    def r_squared(self, col):
        return 1.0 - self.relative_squared_error(col)

    def pearson_correlation(self, col):
        y, p = self._col()
        sy, sp = y[:, col].std(), p[:, col].std()
        if sy == 0 or sp == 0:
            return 0.0
        return float(np.corrcoef(y[:, col], p[:, col])[0, 1])

    def average_mean_squared_error(self):
        return float(np.mean([self.mean_squared_error(c) for c in range(self.n_columns)]))

    def average_mean_absolute_error(self):
        return float(np.mean([self.mean_absolute_error(c) for c in range(self.n_columns)]))

    def average_r_squared(self):
        return float(np.mean([self.r_squared(c) for c in range(self.n_columns)]))

    def stats(self):
        names = self.column_names or [f"col_{i}" for i in range(self.n_columns)]
        lines = ["column | MSE | MAE | RMSE | RSE | R^2 | corr"]
        for c, name in enumerate(names):
            lines.append(
                f"{name} | {self.mean_squared_error(c):.6g} | "
                f"{self.mean_absolute_error(c):.6g} | "
                f"{self.root_mean_squared_error(c):.6g} | "
                f"{self.relative_squared_error(c):.6g} | "
                f"{self.r_squared(c):.6g} | {self.pearson_correlation(c):.6g}")
        return "\n".join(lines)

    def merge(self, other):
        self._labels.extend(other._labels)
        self._preds.extend(other._preds)
        self.n_columns = self.n_columns or other.n_columns
        return self
