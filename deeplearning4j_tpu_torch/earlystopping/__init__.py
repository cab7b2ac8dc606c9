"""Early stopping (counterpart of deeplearning4j_tpu/earlystopping; reference: earlystopping/ package —
EarlyStoppingConfiguration.java, trainer/BaseEarlyStoppingTrainer.java:76 fit(),
termination/ conditions, scorecalc/DataSetLossCalculator, saver/).
"""
from .config import EarlyStoppingConfiguration, EarlyStoppingResult, TerminationReason
from .termination import (MaxEpochsTerminationCondition,
                          BestScoreEpochTerminationCondition,
                          ScoreImprovementEpochTerminationCondition,
                          MaxTimeIterationTerminationCondition,
                          MaxScoreIterationTerminationCondition,
                          InvalidScoreIterationTerminationCondition)
from .scorecalc import DataSetLossCalculator, ScoreCalculator
from .saver import InMemoryModelSaver, LocalFileModelSaver, LocalFileGraphSaver
from .trainer import (EarlyStoppingGraphTrainer,
                      EarlyStoppingParallelTrainer, EarlyStoppingTrainer)

__all__ = [
    "EarlyStoppingConfiguration", "EarlyStoppingResult", "TerminationReason",
    "MaxEpochsTerminationCondition", "BestScoreEpochTerminationCondition",
    "ScoreImprovementEpochTerminationCondition",
    "MaxTimeIterationTerminationCondition", "MaxScoreIterationTerminationCondition",
    "InvalidScoreIterationTerminationCondition",
    "DataSetLossCalculator", "ScoreCalculator",
    "InMemoryModelSaver", "LocalFileModelSaver", "LocalFileGraphSaver",
    "EarlyStoppingTrainer", "EarlyStoppingGraphTrainer",
    "EarlyStoppingParallelTrainer",
]
