"""Admission errors and future helpers shared by the serving path
(counterpart of deeplearning4j_tpu/serving/admission.py; the /predict
admission queue comes with a later slice)."""
from __future__ import annotations

from concurrent.futures import InvalidStateError


def safe_set_result(future, result):
    """Complete a future, tolerating client-side cancellation."""
    try:
        future.set_result(result)
    except InvalidStateError:
        pass


def safe_set_exception(future, exc):
    try:
        future.set_exception(exc)
    except InvalidStateError:
        pass


class RejectedError(RuntimeError):
    """Request shed at admission (queue full or server draining): 429."""

    def __init__(self, msg, retry_after_s=1):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class DeadlineExceeded(RuntimeError):
    """Request expired before it could be served: 504."""
