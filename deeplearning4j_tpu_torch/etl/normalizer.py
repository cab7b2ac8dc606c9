"""Streaming DataSet normalizers: fit / transform / revert / serialize
(counterpart of deeplearning4j_tpu/etl/normalizer.py).

The statistics are host-side numpy (float64 accumulators, float32
applied), so `to_json` gives the JAX package's text for the same data and
a normalizer crosses between the packages as its JSON. Feature batches
may be numpy arrays or tensors (copied to the host); the on-device
counterpart of `transform_features` is etl.device_transform's
`lower_normalizer`, which the serving batcher runs on the card.

Reference: nd4j's NormalizerStandardize / NormalizerMinMaxScaler (fit over a
DataSetIterator, transform DataSets in the training loop, revert predictions)
plus DataVec's NormalizerSerializer — the stats ride inside the
ModelSerializer zip (`normalizer.json`) so serving applies the IDENTICAL
preprocessing the model was trained with (serving/registry auto-applies it
on /predict).

Stats accumulate streaming — one pass over an iterator of arbitrarily many
batches — via Chan's parallel Welford merge, so fitting never materializes
the dataset. Stats are per-feature-element over the batch axis, which covers
flat tabular features and image/sequence tensors alike.
"""
from __future__ import annotations

import json

import numpy as np

from ..datasets.dataset import DataSet
from ..device import host

_NORMALIZERS = {}


def _register(cls):
    _NORMALIZERS[cls.kind] = cls
    return cls


class DataNormalizer:
    """fit/transform/revert contract (reference: org.nd4j.linalg.dataset.api
    .preprocessor.DataNormalization)."""

    kind = None

    def __init__(self, fit_labels=False):
        self.fit_labels = bool(fit_labels)

    # ---- fitting -----------------------------------------------------------
    def fit(self, data):
        """Accumulate stats over a DataSet or a DataSetIterator (streaming —
        the iterator is reset first and consumed once)."""
        if isinstance(data, DataSet):
            self._accumulate(host(data.features), labels=False)
            if self.fit_labels:
                self._accumulate(host(data.labels), labels=True)
            return self
        data.reset()
        for ds in data:
            self._accumulate(host(ds.features), labels=False)
            if self.fit_labels:
                self._accumulate(host(ds.labels), labels=True)
        return self

    def _accumulate(self, arr, labels=False):
        raise NotImplementedError

    # ---- applying ----------------------------------------------------------
    def transform(self, ds: DataSet) -> DataSet:
        """Normalized COPY of `ds` (masks pass through untouched)."""
        f = self._apply(host(ds.features, np.float32), labels=False)
        l = ds.labels
        if self.fit_labels and l is not None:
            l = self._apply(host(l, np.float32), labels=True)
        return DataSet(f, l, ds.features_mask, ds.labels_mask)

    __call__ = transform            # usable as an iterator `preprocessor`

    def transform_features(self, x):
        """Normalize a bare feature batch (the serving-side entry point)."""
        return self._apply(host(x, np.float32), labels=False)

    def revert(self, ds: DataSet) -> DataSet:
        f = self._unapply(host(ds.features, np.float32), labels=False)
        l = ds.labels
        if self.fit_labels and l is not None:
            l = self._unapply(host(l, np.float32), labels=True)
        return DataSet(f, l, ds.features_mask, ds.labels_mask)

    def revert_labels(self, y):
        """Un-normalize predicted labels (regression serving)."""
        if not self.fit_labels:
            return y
        return self._unapply(host(y, np.float32), labels=True)

    def _apply(self, arr, labels):
        raise NotImplementedError

    def _unapply(self, arr, labels):
        raise NotImplementedError

    # ---- device lowering ---------------------------------------------------
    def device_stats(self, labels=False):
        """(sub, div, scale, add) float32 affine stats such that
        `transform == (x - sub) / div * scale + add`, the contract
        etl.device_transform.lower_normalizer turns into torch ops on a
        device. Raises when not fitted, as transform() does."""
        raise NotImplementedError

    # ---- serialization -----------------------------------------------------
    def to_dict(self):
        raise NotImplementedError

    def to_json(self):
        return json.dumps(self.to_dict())

    @staticmethod
    def from_dict(d):
        cls = _NORMALIZERS.get(d.get("kind"))
        if cls is None:
            raise ValueError(f"unknown normalizer kind {d.get('kind')!r}")
        return cls._from_dict(d)

    @staticmethod
    def from_json(s):
        return DataNormalizer.from_dict(json.loads(s))


class _Welford:
    """Streaming mean/variance over the batch axis, merged batch-at-a-time
    with Chan's parallel update (numerically stable for many small batches)."""

    __slots__ = ("n", "mean", "m2")

    def __init__(self):
        self.n = 0
        self.mean = None
        self.m2 = None

    def update(self, arr):
        arr = np.asarray(arr, np.float64)
        nb = arr.shape[0]
        if nb == 0:
            return
        mb = arr.mean(axis=0)
        m2b = ((arr - mb) ** 2).sum(axis=0)
        if self.n == 0:
            self.n, self.mean, self.m2 = nb, mb, m2b
            return
        delta = mb - self.mean
        tot = self.n + nb
        self.mean = self.mean + delta * (nb / tot)
        self.m2 = self.m2 + m2b + delta ** 2 * (self.n * nb / tot)
        self.n = tot

    def std(self):
        var = self.m2 / max(self.n - 1, 1)
        return np.sqrt(np.maximum(var, 0.0))


@_register
class NormalizerStandardize(DataNormalizer):
    """Z-score: (x - mean) / std (reference: nd4j NormalizerStandardize)."""

    kind = "standardize"

    def __init__(self, fit_labels=False):
        super().__init__(fit_labels)
        self._feat = _Welford()
        self._lab = _Welford()

    def _accumulate(self, arr, labels=False):
        (self._lab if labels else self._feat).update(arr)

    def _stats(self, labels):
        w = self._lab if labels else self._feat
        if w.n == 0:
            raise RuntimeError("normalizer not fitted")
        std = w.std()
        return (w.mean.astype(np.float32),
                np.where(std == 0, 1.0, std).astype(np.float32))

    def _apply(self, arr, labels):
        mean, std = self._stats(labels)
        return ((arr - mean) / std).astype(np.float32)

    def _unapply(self, arr, labels):
        mean, std = self._stats(labels)
        return (arr * std + mean).astype(np.float32)

    def device_stats(self, labels=False):
        mean, std = self._stats(labels)
        one = np.float32(1.0)
        return mean, std, one, np.float32(0.0)

    @property
    def mean(self):
        return self._stats(False)[0]

    @property
    def std(self):
        return self._stats(False)[1]

    def to_dict(self):
        d = {"kind": self.kind, "fit_labels": self.fit_labels,
             "n": self._feat.n,
             "mean": np.asarray(self._feat.mean).tolist(),
             "std": np.asarray(self._feat.std()).tolist()}
        if self.fit_labels and self._lab.n:
            d["label_mean"] = np.asarray(self._lab.mean).tolist()
            d["label_std"] = np.asarray(self._lab.std()).tolist()
        return d

    @classmethod
    def _from_dict(cls, d):
        nz = cls(fit_labels=d.get("fit_labels", False))

        def load(w, mean, std, n):
            w.n = int(n)
            w.mean = np.asarray(mean, np.float64)
            # invert std(): m2 = std^2 * (n - 1); exact round-trip of the
            # serialized moments without storing m2 itself
            w.m2 = np.asarray(std, np.float64) ** 2 * max(w.n - 1, 1)
        load(nz._feat, d["mean"], d["std"], d.get("n", 2))
        if "label_mean" in d:
            load(nz._lab, d["label_mean"], d["label_std"], d.get("n", 2))
        return nz


@_register
class NormalizerMinMaxScaler(DataNormalizer):
    """Scale to [lo, hi] from streaming per-element min/max (reference: nd4j
    NormalizerMinMaxScaler)."""

    kind = "min_max"

    def __init__(self, lo=0.0, hi=1.0, fit_labels=False):
        super().__init__(fit_labels)
        self.lo, self.hi = float(lo), float(hi)
        self._min = {False: None, True: None}
        self._max = {False: None, True: None}

    def _accumulate(self, arr, labels=False):
        arr = np.asarray(arr, np.float64)
        if arr.shape[0] == 0:
            return
        mn, mx = arr.min(axis=0), arr.max(axis=0)
        if self._min[labels] is None:
            self._min[labels], self._max[labels] = mn, mx
        else:
            self._min[labels] = np.minimum(self._min[labels], mn)
            self._max[labels] = np.maximum(self._max[labels], mx)

    def _stats(self, labels):
        if self._min[labels] is None:
            raise RuntimeError("normalizer not fitted")
        mn = self._min[labels].astype(np.float32)
        span = (self._max[labels] - self._min[labels]).astype(np.float32)
        return mn, np.where(span == 0, 1.0, span)

    def _apply(self, arr, labels):
        mn, span = self._stats(labels)
        return ((arr - mn) / span * (self.hi - self.lo)
                + self.lo).astype(np.float32)

    def _unapply(self, arr, labels):
        mn, span = self._stats(labels)
        return ((arr - self.lo) / (self.hi - self.lo) * span
                + mn).astype(np.float32)

    def device_stats(self, labels=False):
        mn, span = self._stats(labels)
        return (mn, span, np.float32(self.hi - self.lo), np.float32(self.lo))

    def to_dict(self):
        d = {"kind": self.kind, "fit_labels": self.fit_labels,
             "lo": self.lo, "hi": self.hi,
             "min": np.asarray(self._min[False]).tolist(),
             "max": np.asarray(self._max[False]).tolist()}
        if self.fit_labels and self._min[True] is not None:
            d["label_min"] = np.asarray(self._min[True]).tolist()
            d["label_max"] = np.asarray(self._max[True]).tolist()
        return d

    @classmethod
    def _from_dict(cls, d):
        nz = cls(lo=d.get("lo", 0.0), hi=d.get("hi", 1.0),
                 fit_labels=d.get("fit_labels", False))
        nz._min[False] = np.asarray(d["min"], np.float64)
        nz._max[False] = np.asarray(d["max"], np.float64)
        if "label_min" in d:
            nz._min[True] = np.asarray(d["label_min"], np.float64)
            nz._max[True] = np.asarray(d["label_max"], np.float64)
        return nz
