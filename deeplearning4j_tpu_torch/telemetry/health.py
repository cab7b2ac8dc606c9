"""Deep health: per-component probes aggregated into one liveness answer
(the port's copy of deeplearning4j_tpu/telemetry/health.py).

Components (the ETL pipelines here) register *probes* — zero-argument
callables returning one of

    "healthy" | "degraded" | "unhealthy"
    (status, {detail...})
    {"status": ..., detail...}

and `HealthMonitor.check()` aggregates them: overall status is the worst
component status, and the report carries per-component detail JSON.
`http_status` maps unhealthy -> 503, healthy/degraded -> 200.

A probe that *raises* is itself an unhealthy signal (the component's own
introspection is broken), never an error of the check. Status transitions
are logged through `logger.log(level, event, **fields)` when a logger is
given.
"""
from __future__ import annotations

import threading

from ..util.time_source import now_s

HEALTHY = "healthy"
DEGRADED = "degraded"
UNHEALTHY = "unhealthy"
_RANK = {HEALTHY: 0, DEGRADED: 1, UNHEALTHY: 2}


def _normalize(result):
    """Probe result -> {"status": str, **detail}."""
    if isinstance(result, str):
        status, detail = result, {}
    elif isinstance(result, dict):
        d = dict(result)
        status = d.pop("status", UNHEALTHY)
        detail = d
    elif isinstance(result, (tuple, list)) and len(result) == 2:
        status, detail = result[0], dict(result[1] or {})
    else:
        raise TypeError(f"bad probe result {result!r}")
    status = str(status).lower()
    if status == "ok":                 # tolerated legacy spelling
        status = HEALTHY
    if status not in _RANK:
        raise ValueError(f"unknown health status {status!r}")
    return {"status": status, **detail}


class _StaticProbe:
    """Backing store for `set_status` push-style components."""

    def __init__(self, status, detail):
        self.status = status
        self.detail = detail

    def __call__(self):
        return self.status, self.detail


class HealthMonitor:
    """Registry of component probes + worst-status aggregation."""

    def __init__(self, logger=None):
        self._probes = {}
        self._last = {}               # component -> last seen status
        self._lock = threading.Lock()
        self.logger = logger

    # ---- registration ------------------------------------------------------
    def register(self, component, probe):
        """Register (or replace) a pull-style probe for `component`."""
        if not callable(probe):
            raise TypeError("probe must be callable")
        with self._lock:
            self._probes[str(component)] = probe
        return probe

    def register_unique(self, component, probe):
        """Register under `component`, or `component-N` when taken — one
        atomic check-and-insert, so concurrently-built components sharing a
        base name (e.g. two pipelines named "etl") never clobber each
        other's probe. Returns the key actually used (pass to unregister)."""
        if not callable(probe):
            raise TypeError("probe must be callable")
        with self._lock:
            key, i = str(component), 1
            while key in self._probes:
                i += 1
                key = f"{component}-{i}"
            self._probes[key] = probe
            return key

    def set_status(self, component, status, **detail):
        """Push-style API: record a component's status directly (repeat
        calls update in place)."""
        status = _normalize(status)["status"]
        with self._lock:
            probe = self._probes.get(str(component))
            if isinstance(probe, _StaticProbe):
                probe.status, probe.detail = status, detail
            else:
                self._probes[str(component)] = _StaticProbe(status, detail)

    def unregister(self, component):
        with self._lock:
            self._probes.pop(str(component), None)
            self._last.pop(str(component), None)

    def components(self):
        with self._lock:
            return sorted(self._probes)

    # ---- reading -----------------------------------------------------------
    def check(self):
        """{"status": worst, "time", "components": {name: {...}}} — probes
        run outside the lock (a slow probe must not block registration)."""
        with self._lock:
            probes = dict(self._probes)
        components = {}
        for name in sorted(probes):
            try:
                components[name] = _normalize(probes[name]())
            except Exception as e:
                components[name] = {"status": UNHEALTHY,
                                    "error": f"{type(e).__name__}: {e}"}
        overall = HEALTHY
        for name, comp in components.items():
            if _RANK[comp["status"]] > _RANK[overall]:
                overall = comp["status"]
            self._log_transition(name, comp)
        return {"status": overall, "time": now_s(), "components": components}

    def _log_transition(self, name, comp):
        with self._lock:
            prev = self._last.get(name)
            self._last[name] = comp["status"]
        if self.logger is None or comp["status"] == prev:
            return
        level = {HEALTHY: "info", DEGRADED: "warning",
                 UNHEALTHY: "error"}[comp["status"]]
        self.logger.log(level, "health_transition", component=name,
                        status=comp["status"], previous=prev)

    @staticmethod
    def http_status(report):
        """HTTP code for a check() report: only unhealthy takes the replica
        out of rotation; degraded still serves (visible in the body)."""
        return 503 if report["status"] == UNHEALTHY else 200


# ---- process-default monitor ------------------------------------------------
_default_monitor = None
_default_lock = threading.Lock()


def get_monitor() -> HealthMonitor:
    """Process-default monitor (ETL pipelines, training listeners, and the
    UI server's /healthz all meet here unless given an explicit one)."""
    global _default_monitor
    with _default_lock:
        if _default_monitor is None:
            _default_monitor = HealthMonitor()
        return _default_monitor


def set_monitor(monitor) -> HealthMonitor:
    global _default_monitor
    with _default_lock:
        _default_monitor = monitor
    return monitor
