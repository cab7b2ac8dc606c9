"""Evaluation suite (reference: deeplearning4j-nn eval/ package —
Evaluation.java, ConfusionMatrix.java, ROC.java, ROCMultiClass.java,
RegressionEvaluation.java, IEvaluation.java)."""
from .evaluation import Evaluation, ConfusionMatrix
from .roc import ROC, ROCMultiClass, RegressionEvaluation

__all__ = ["Evaluation", "ConfusionMatrix", "ROC", "ROCMultiClass",
           "RegressionEvaluation"]
