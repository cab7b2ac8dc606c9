"""Early-stopping trainers (counterpart of
deeplearning4j_tpu/earlystopping/trainer.py).

Reference: earlystopping/trainer/BaseEarlyStoppingTrainer.java:76 fit() loop —
per epoch: fit all minibatches (checking iteration termination conditions each
iteration), every evaluateEveryNEpochs compute validation score, track best
model via saver, stop on any epoch condition. EarlyStoppingTrainer (MLN) and
EarlyStoppingGraphTrainer (ComputationGraph) share the loop; here one base
works for both model types since both expose fit_batch/score/clone.
"""
from __future__ import annotations

import math

from ..datasets.iterator.base import as_iterator
from .config import EarlyStoppingResult, TerminationReason
from .saver import InMemoryModelSaver


class BaseEarlyStoppingTrainer:
    def __init__(self, config, model, train_data, listener=None):
        self.config = config
        self.model = model
        self.train_data = train_data
        self.listener = listener
        if self.config.model_saver is None:
            self.config.model_saver = InMemoryModelSaver()

    def fit(self):
        cfg = self.config
        saver = cfg.model_saver
        if not cfg.epoch_termination_conditions and \
                not cfg.iteration_termination_conditions:
            raise ValueError(
                "EarlyStoppingConfiguration needs at least one termination "
                "condition (e.g. MaxEpochsTerminationCondition) — otherwise "
                "fit() would never return")
        for c in cfg.epoch_termination_conditions:
            c.initialize()
        for c in cfg.iteration_termination_conditions:
            c.initialize()

        score_vs_epoch = {}
        best_score, best_epoch = math.inf, -1
        epoch = 0
        it = as_iterator(self.train_data)
        while True:
            it.reset()
            for ds in it:
                self.model.fit_batch(ds)
                s = self.model.score_value
                for c in cfg.iteration_termination_conditions:
                    if c.terminate(s):
                        reason = TerminationReason.ITERATION_TERMINATION
                        if cfg.save_last_model:
                            saver.save_latest_model(self.model, s)
                        best = saver.get_best_model() or self.model
                        return EarlyStoppingResult(reason, repr(c), score_vs_epoch,
                                                   best_epoch, best_score, epoch + 1,
                                                   best)
            # epoch complete — evaluate
            if cfg.score_calculator is not None and \
                    epoch % cfg.evaluate_every_n_epochs == 0:
                score = cfg.score_calculator.calculate_score(self.model)
                score_vs_epoch[epoch] = score
                if score < best_score:
                    best_score, best_epoch = score, epoch
                    saver.save_best_model(self.model, score)
                if self.listener is not None:
                    self.listener(epoch, score, self.model)
            else:
                score = self.model.score_value
            if cfg.save_last_model:
                saver.save_latest_model(self.model, score)
            for c in cfg.epoch_termination_conditions:
                if c.terminate(epoch, score):
                    best = saver.get_best_model() or self.model
                    return EarlyStoppingResult(
                        TerminationReason.EPOCH_TERMINATION, repr(c), score_vs_epoch,
                        best_epoch if best_epoch >= 0 else epoch,
                        best_score if best_epoch >= 0 else score,
                        epoch + 1, best)
            epoch += 1


class EarlyStoppingTrainer(BaseEarlyStoppingTrainer):
    """(reference: earlystopping/trainer/EarlyStoppingTrainer.java)"""


class EarlyStoppingGraphTrainer(BaseEarlyStoppingTrainer):
    """(reference: earlystopping/trainer/EarlyStoppingGraphTrainer.java)"""


class EarlyStoppingParallelTrainer(BaseEarlyStoppingTrainer):
    """Early stopping over data-parallel training needs ParallelWrapper."""

    def __init__(self, config, model, train_data, workers=None, devices=None,
                 listener=None):
        raise NotImplementedError(
            "EarlyStoppingParallelTrainer needs ParallelWrapper, which is not "
            "ported yet (ROADMAP queue 1 item 11)")
