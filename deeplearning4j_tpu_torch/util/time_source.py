"""Time sources (the port's copy of deeplearning4j_tpu/util/time_source.py
without the NTP source, which waits for a user).

Everything observability-facing (serving latencies, deadlines, registry
deploy times, metric exemplars) reads `now_s` / `monotonic_s`, so one
`TimeSourceProvider.set_instance(ManualClock())` makes a test run
deterministic."""
from __future__ import annotations

import os
import time


class TimeSource:
    def current_time_millis(self) -> int:
        raise NotImplementedError

    def monotonic(self) -> float:
        """Monotonic seconds for durations and deadlines."""
        return time.monotonic()


class SystemClockTimeSource(TimeSource):
    def current_time_millis(self):
        return int(time.time() * 1000)


class ManualClock(TimeSource):
    """Deterministic test clock: wall and monotonic time advance only
    through `advance()`."""

    def __init__(self, start_s=1_000_000.0):
        self._now = float(start_s)

    def advance(self, seconds):
        self._now += float(seconds)
        return self._now

    def current_time_millis(self):
        return int(self._now * 1000)

    def monotonic(self):
        return self._now


class TimeSourceProvider:
    """The process's time source: the system clock unless one is set.
    DL4J_TPU_TIMESOURCE=ntp names the JAX package's NTP source, which is
    not ported."""

    _instance = None

    @classmethod
    def get_instance(cls) -> TimeSource:
        if cls._instance is None:
            kind = os.environ.get("DL4J_TPU_TIMESOURCE", "system").lower()
            if kind == "ntp":
                raise NotImplementedError(
                    "the NTP time source is not ported yet (ROADMAP queue 1 "
                    "item 12)")
            cls._instance = SystemClockTimeSource()
        return cls._instance

    @classmethod
    def set_instance(cls, time_source):
        """Install a source (a ManualClock in tests); None falls back to
        the default on next use."""
        cls._instance = time_source


def now_s() -> float:
    """Wall-clock seconds (epoch) from the configured TimeSource."""
    return TimeSourceProvider.get_instance().current_time_millis() / 1000.0


def monotonic_s() -> float:
    """Monotonic seconds from the configured TimeSource (durations only)."""
    return TimeSourceProvider.get_instance().monotonic()
