"""Early-stopping configuration + result container (counterpart of
deeplearning4j_tpu/earlystopping/config.py).

Reference: earlystopping/EarlyStoppingConfiguration.java (builder with
epochTerminationConditions, iterationTerminationConditions, scoreCalculator,
modelSaver, evaluateEveryNEpochs, saveLastModel) and EarlyStoppingResult.java
(TerminationReason enum, termination details, scoreVsEpoch, best epoch/score).
"""
from __future__ import annotations

import enum


class TerminationReason(enum.Enum):
    ERROR = "Error"
    ITERATION_TERMINATION = "IterationTerminationCondition"
    EPOCH_TERMINATION = "EpochTerminationCondition"


class EarlyStoppingResult:
    def __init__(self, termination_reason, termination_details, score_vs_epoch,
                 best_model_epoch, best_model_score, total_epochs, best_model):
        self.termination_reason = termination_reason
        self.termination_details = termination_details
        self.score_vs_epoch = score_vs_epoch  # {epoch: score}
        self.best_model_epoch = best_model_epoch
        self.best_model_score = best_model_score
        self.total_epochs = total_epochs
        self.best_model = best_model

    def get_best_model(self):
        return self.best_model

    def __repr__(self):
        return (f"EarlyStoppingResult(reason={self.termination_reason}, "
                f"details={self.termination_details}, epochs={self.total_epochs}, "
                f"best_epoch={self.best_model_epoch}, best_score={self.best_model_score})")


class EarlyStoppingConfiguration:
    def __init__(self, *, epoch_termination_conditions=None,
                 iteration_termination_conditions=None, score_calculator=None,
                 model_saver=None, evaluate_every_n_epochs=1, save_last_model=False):
        self.epoch_termination_conditions = epoch_termination_conditions or []
        self.iteration_termination_conditions = iteration_termination_conditions or []
        self.score_calculator = score_calculator
        self.model_saver = model_saver
        self.evaluate_every_n_epochs = max(1, int(evaluate_every_n_epochs))
        self.save_last_model = save_last_model

    @staticmethod
    def builder():
        return _Builder()


class _Builder:
    def __init__(self):
        self._kw = {"epoch_termination_conditions": [],
                    "iteration_termination_conditions": []}

    def epoch_termination_conditions(self, *conds):
        self._kw["epoch_termination_conditions"].extend(conds)
        return self

    def iteration_termination_conditions(self, *conds):
        self._kw["iteration_termination_conditions"].extend(conds)
        return self

    def score_calculator(self, sc):
        self._kw["score_calculator"] = sc
        return self

    def model_saver(self, saver):
        self._kw["model_saver"] = saver
        return self

    def evaluate_every_n_epochs(self, n):
        self._kw["evaluate_every_n_epochs"] = n
        return self

    def save_last_model(self, b=True):
        self._kw["save_last_model"] = b
        return self

    def build(self):
        return EarlyStoppingConfiguration(**self._kw)
