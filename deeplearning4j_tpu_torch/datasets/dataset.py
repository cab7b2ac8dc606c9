"""DataSet / MultiDataSet containers (a numpy-only copy of
deeplearning4j_tpu/datasets/dataset.py:12-82, so the port imports nothing
of the JAX package).

Reference: nd4j's org.nd4j.linalg.dataset.DataSet / MultiDataSet
(features, labels, featuresMask, labelsMask).
"""
from __future__ import annotations

import numpy as np


class DataSet:
    def __init__(self, features, labels=None, features_mask=None, labels_mask=None):
        self.features = features
        self.labels = labels if labels is not None else features
        self.features_mask = features_mask
        self.labels_mask = labels_mask

    def num_examples(self):
        return int(np.shape(self.features)[0])

    def split_test_and_train(self, n_train):
        tr = DataSet(self.features[:n_train], self.labels[:n_train],
                     None if self.features_mask is None else self.features_mask[:n_train],
                     None if self.labels_mask is None else self.labels_mask[:n_train])
        te = DataSet(self.features[n_train:], self.labels[n_train:],
                     None if self.features_mask is None else self.features_mask[n_train:],
                     None if self.labels_mask is None else self.labels_mask[n_train:])
        return tr, te

    def shuffle(self, seed=None):
        rng = np.random.default_rng(seed)
        idx = rng.permutation(self.num_examples())
        self.features = np.asarray(self.features)[idx]
        self.labels = np.asarray(self.labels)[idx]
        if self.features_mask is not None:
            self.features_mask = np.asarray(self.features_mask)[idx]
        if self.labels_mask is not None:
            self.labels_mask = np.asarray(self.labels_mask)[idx]
        return self

    def batch_by(self, batch_size):
        n = self.num_examples()
        out = []
        for s in range(0, n, batch_size):
            e = min(s + batch_size, n)
            out.append(DataSet(
                self.features[s:e], self.labels[s:e],
                None if self.features_mask is None else self.features_mask[s:e],
                None if self.labels_mask is None else self.labels_mask[s:e]))
        return out

    def slice(self, start, end):
        sl = lambda a: None if a is None else a[start:end]
        return DataSet(self.features[start:end], self.labels[start:end],
                       sl(self.features_mask), sl(self.labels_mask))

    def copy(self):
        cp = lambda a: None if a is None else np.array(a)
        return DataSet(cp(self.features), cp(self.labels), cp(self.features_mask),
                       cp(self.labels_mask))


class MultiDataSet:
    """Multiple feature/label arrays for ComputationGraph
    (reference: org.nd4j.linalg.dataset.api.MultiDataSet)."""

    def __init__(self, features, labels, features_masks=None, labels_masks=None):
        self.features = list(features) if isinstance(features, (list, tuple)) else [features]
        self.labels = list(labels) if isinstance(labels, (list, tuple)) else [labels]
        self.features_masks = features_masks
        self.labels_masks = labels_masks

    def num_examples(self):
        return int(np.shape(self.features[0])[0])

    def slice(self, start, end):
        sl = lambda arrs: None if arrs is None else \
            [None if a is None else a[start:end] for a in arrs]
        return MultiDataSet([f[start:end] for f in self.features],
                            [l[start:end] for l in self.labels],
                            sl(self.features_masks), sl(self.labels_masks))
