"""Versioned model registry (counterpart of
deeplearning4j_tpu/serving/registry.py: in-memory register/deploy and the
one-snapshot read the decode scheduler needs; zip loading, warm-up and
rollback come with later slices)."""
from __future__ import annotations

import threading
import time


class NoModelDeployed(RuntimeError):
    """Serving was asked for a model before any version was deployed: 503."""


class ModelVersion:
    def __init__(self, version, model):
        self.version = str(version)
        self.model = model
        self.loaded_at = time.time()
        self.deployed_at = None


class ModelRegistry:
    def __init__(self):
        self._versions = {}
        self._active = None
        self._lock = threading.Lock()

    def register(self, version, model):
        with self._lock:
            if str(version) in self._versions:
                raise ValueError(f"version {version!r} already registered")
            self._versions[str(version)] = ModelVersion(version, model)
        return str(version)

    def deploy(self, version):
        """Make `version` the serving model; returns the previous one."""
        version = str(version)
        with self._lock:
            if version not in self._versions:
                raise KeyError(f"unknown version {version!r}")
            prev, self._active = self._active, version
            self._versions[version].deployed_at = time.time()
            return prev

    def active_entry(self) -> ModelVersion:
        with self._lock:
            if self._active is None:
                raise NoModelDeployed("no model deployed")
            return self._versions[self._active]

    @property
    def active_version(self):
        with self._lock:
            return self._active
