"""Prediction-error introspection metadata (counterpart of
deeplearning4j_tpu/eval/meta.py).

Reference: eval/meta/ (RecordMetaData plumbing) + Evaluation.java's
getPredictionErrors()/getPredictionsByActualClass()/getPredictionByPredictedClass
— after evaluation, pull out WHICH examples were misclassified and as what,
for debugging datasets rather than just scoring them.
"""
from __future__ import annotations


class Prediction:
    """One recorded prediction (reference: eval/meta/Prediction.java)."""

    __slots__ = ("actual", "predicted", "record_meta")

    def __init__(self, actual, predicted, record_meta=None):
        self.actual = int(actual)
        self.predicted = int(predicted)
        self.record_meta = record_meta

    def __repr__(self):
        return (f"Prediction(actual={self.actual}, predicted={self.predicted}"
                f", meta={self.record_meta!r})")

    def __eq__(self, other):
        return (isinstance(other, Prediction)
                and self.actual == other.actual
                and self.predicted == other.predicted
                and self.record_meta == other.record_meta)
