"""Training listener SPI + stock listeners (counterpart of
deeplearning4j_tpu/optimize/listeners/__init__.py).

The models call them on the host: `on_epoch_start` / `on_epoch_end`
around each epoch of `fit`, then `record_batch_size` (where a listener
has it) and `iteration_done` after each `fit_batch`, and once per plan
after a K-step `fit_prepared` (K x B rows; on the card after the CUDA
graph's replay, so nothing of a listener runs inside the graph). A
listener that reads `model.score_value` makes the host wait for the step.
No listener of the port reads gradients: the hook that keeps them for
one (JAX `wants_gradients` / `last_gradients`) comes with
`TrainingHealthListener` and the stats listener, ROADMAP queue 1 item 12.

Reference: optimize/api/IterationListener.java, TrainingListener.java (epoch &
pass hooks), impls in optimize/listeners/: ScoreIterationListener,
PerformanceListener (samples/sec :99-102), CollectScoresIterationListener,
ParamAndGradientIterationListener, ComposableIterationListener.
"""
from __future__ import annotations

from ...util.time_source import monotonic_s


class IterationListener:
    """Hook called after every parameter update (reference:
    optimize/api/IterationListener.java)."""

    def iteration_done(self, model, iteration):
        pass

    def on_epoch_start(self, model):
        pass

    def on_epoch_end(self, model):
        pass


TrainingListener = IterationListener  # epoch hooks included above


class ScoreIterationListener(IterationListener):
    """(reference: optimize/listeners/ScoreIterationListener.java)"""

    def __init__(self, print_iterations=10, log_fn=print):
        self.print_iterations = max(1, int(print_iterations))
        self.log_fn = log_fn

    def iteration_done(self, model, iteration):
        if iteration % self.print_iterations == 0:
            self.log_fn(f"Score at iteration {iteration} is {model.score_value}")


class PerformanceListener(IterationListener):
    """Throughput reporting (reference:
    optimize/listeners/PerformanceListener.java:99-102 — samples/sec,
    batches/sec, iteration time)."""

    def __init__(self, frequency=1, report_batch=True, report_sample=True,
                 log_fn=print, registry=None):
        self.frequency = max(1, int(frequency))
        self.report_batch = report_batch
        self.report_sample = report_sample
        self.log_fn = log_fn
        self._last_time = None
        self._last_iter = 0
        self._samples_since = 0
        # None (not NaN) until the first measured interval: a snapshot
        # serialized before any measurement must emit null, never a bare
        # NaN token that JSON.parse rejects
        self.last_samples_per_sec = None
        self.last_batches_per_sec = None
        self.last_iteration_ms = None
        # central-registry mirror (telemetry.MetricsRegistry): the same
        # throughput numbers this listener logs become scrapeable gauges and
        # a latency histogram instead of private fields only
        self.registry = registry
        if registry is not None:
            self._reg_samples = registry.counter(
                "training_samples_total", "Example rows trained on")
            self._reg_iter_ms = registry.histogram(
                "training_iteration_ms", "Wall ms per training iteration")
            self._reg_sps = registry.gauge(
                "training_samples_per_sec", "Recent training throughput")

    def record_batch_size(self, n):
        self._samples_since += int(n)
        if self.registry is not None:
            self._reg_samples.inc(int(n))

    def iteration_done(self, model, iteration):
        now = monotonic_s()
        if self._last_time is None:
            self._last_time = now
            self._last_iter = iteration
            return
        if (iteration - self._last_iter) % self.frequency == 0:
            dt = now - self._last_time
            iters = iteration - self._last_iter
            if dt > 0 and iters > 0:
                self.last_batches_per_sec = iters / dt
                self.last_iteration_ms = 1000.0 * dt / iters
                if self._samples_since:
                    self.last_samples_per_sec = self._samples_since / dt
                if self.registry is not None:
                    self._reg_iter_ms.observe(self.last_iteration_ms)
                    if self._samples_since:
                        self._reg_sps.set(self.last_samples_per_sec)
                msg = (f"iteration {iteration}: {self.last_iteration_ms:.2f} ms/iter, "
                       f"{self.last_batches_per_sec:.2f} batches/sec")
                if self._samples_since:
                    msg += f", {self.last_samples_per_sec:.1f} samples/sec"
                self.log_fn(msg)
            self._last_time = now
            self._last_iter = iteration
            self._samples_since = 0


class CollectScoresIterationListener(IterationListener):
    """(reference: optimize/listeners/CollectScoresIterationListener.java)"""

    def __init__(self, frequency=1):
        self.frequency = max(1, int(frequency))
        self.scores = []  # list of (iteration, score)

    def iteration_done(self, model, iteration):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, model.score_value))


class ParamAndGradientIterationListener(IterationListener):
    """Collects parameter norm stats per iteration (reference:
    optimize/listeners/ParamAndGradientIterationListener.java)."""

    def __init__(self, frequency=1):
        import numpy as np
        self._np = np
        self.frequency = max(1, int(frequency))
        self.records = []

    def iteration_done(self, model, iteration):
        if iteration % self.frequency != 0:
            return
        np = self._np
        rec = {"iteration": iteration, "score": model.score_value}
        for name, p in model.param_table().items():
            a = p.detach().cpu().numpy()
            rec[f"{name}.mean_mag"] = float(np.mean(np.abs(a)))
        self.records.append(rec)


class ComposableIterationListener(IterationListener):
    """(reference: optimize/listeners/ComposableIterationListener.java)"""

    def __init__(self, *listeners):
        self.listeners = list(listeners)

    def iteration_done(self, model, iteration):
        for l in self.listeners:
            l.iteration_done(model, iteration)

    def on_epoch_start(self, model):
        for l in self.listeners:
            l.on_epoch_start(model)

    def on_epoch_end(self, model):
        for l in self.listeners:
            l.on_epoch_end(model)


class TrainingHealthListener:
    """The health listener needs telemetry/health.py and its spans."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "TrainingHealthListener needs telemetry/health.py, which is not "
            "ported yet (ROADMAP queue 1 item 12)")


def resolve_listeners(listeners):
    out = []
    for l in listeners:
        if isinstance(l, (list, tuple)):
            out.extend(resolve_listeners(l))
        elif l is not None:
            out.append(l)
    return out
