"""Score calculators (counterpart of
deeplearning4j_tpu/earlystopping/scorecalc.py; reference: earlystopping/scorecalc/ —
DataSetLossCalculator.java and DataSetLossCalculatorCG.java; one class here
handles both MultiLayerNetwork and ComputationGraph)."""
from __future__ import annotations

from ..datasets.iterator.base import as_iterator


class ScoreCalculator:
    def calculate_score(self, model):
        raise NotImplementedError


class DataSetLossCalculator(ScoreCalculator):
    """Average loss over a validation iterator, optionally batch-size weighted
    (reference behavior: average=true): the model's `score(ds)` a batch,
    a float each, so the host waits for every batch's loss."""

    def __init__(self, iterator, average=True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, model):
        it = as_iterator(self.iterator)
        it.reset()
        total, n = 0.0, 0
        for ds in it:
            b = ds.num_examples()
            total += model.score(ds) * (b if self.average else 1.0)
            n += b if self.average else 1
        return total / n if n else float("nan")
