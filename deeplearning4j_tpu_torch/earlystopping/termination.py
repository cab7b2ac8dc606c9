"""Termination conditions (counterpart of
deeplearning4j_tpu/earlystopping/termination.py; reference: earlystopping/termination/ —
MaxEpochsTerminationCondition, BestScoreEpochTerminationCondition,
ScoreImprovementEpochTerminationCondition, MaxTimeIterationTerminationCondition,
MaxScoreIterationTerminationCondition, InvalidScoreIterationTerminationCondition).

Epoch conditions see (epoch, score); iteration conditions see the minibatch
score and wall-clock (the port's util/time_source clock, so a
ManualClock drives it in tests), checked every iteration.
"""
from __future__ import annotations

import math

from ..util.time_source import monotonic_s


class EpochTerminationCondition:
    def initialize(self):
        pass

    def terminate(self, epoch, score):
        raise NotImplementedError


class IterationTerminationCondition:
    def initialize(self):
        pass

    def terminate(self, score):
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    def __init__(self, max_epochs):
        self.max_epochs = int(max_epochs)

    def terminate(self, epoch, score):
        return epoch + 1 >= self.max_epochs

    def __repr__(self):
        return f"MaxEpochsTerminationCondition({self.max_epochs})"


class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    """Stop once score is at or below a target value."""

    def __init__(self, best_expected_score):
        self.best_expected_score = float(best_expected_score)

    def terminate(self, epoch, score):
        return score <= self.best_expected_score

    def __repr__(self):
        return f"BestScoreEpochTerminationCondition({self.best_expected_score})"


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop if no score improvement in maxEpochsWithNoImprovement epochs."""

    def __init__(self, max_epochs_with_no_improvement, min_improvement=0.0):
        self.max_epochs = int(max_epochs_with_no_improvement)
        self.min_improvement = float(min_improvement)
        self.best_score = None
        self.epochs_since = 0

    def initialize(self):
        self.best_score = None
        self.epochs_since = 0

    def terminate(self, epoch, score):
        if self.best_score is None or self.best_score - score > self.min_improvement:
            self.best_score = score if self.best_score is None else min(self.best_score, score)
            self.epochs_since = 0
            return False
        self.epochs_since += 1
        return self.epochs_since >= self.max_epochs

    def __repr__(self):
        return (f"ScoreImprovementEpochTerminationCondition({self.max_epochs}, "
                f"{self.min_improvement})")


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    """Wall-budget guard. Reads the injected util.time_source clock, so a
    ManualClock test can expire the budget without real sleeps."""

    def __init__(self, max_time_seconds):
        self.max_time_seconds = float(max_time_seconds)
        self._start = None

    def initialize(self):
        self._start = monotonic_s()

    def terminate(self, score):
        if self._start is None:
            self._start = monotonic_s()
        return monotonic_s() - self._start >= self.max_time_seconds

    def __repr__(self):
        return f"MaxTimeIterationTerminationCondition({self.max_time_seconds}s)"


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Terminate (as failure guard) if score exceeds a maximum — catches
    divergence."""

    def __init__(self, max_score):
        self.max_score = float(max_score)

    def terminate(self, score):
        return score > self.max_score

    def __repr__(self):
        return f"MaxScoreIterationTerminationCondition({self.max_score})"


class InvalidScoreIterationTerminationCondition(IterationTerminationCondition):
    def terminate(self, score):
        return math.isnan(score) or math.isinf(score)

    def __repr__(self):
        return "InvalidScoreIterationTerminationCondition()"
