"""Versioned model registry with atomic hot-swap (counterpart of
deeplearning4j_tpu/serving/registry.py).

A version is registered (an in-memory model, or a ModelSerializer zip
loaded with `load`), then `deploy`ed: the warm-up callable runs the NEW
model at every shape serving has seen BEFORE the pointer swaps, while the
old version keeps serving, and in-flight batches dispatched against the
old snapshot complete on it (the batcher reads one snapshot per batch).
`rollback` redeploys the previously active version the same way.

Persistence: `ModelRegistry(scan_dir=...)` loads every zip in the
directory at startup, on the card unless `device="cpu"` (version = file
stem; a zip that does not load goes into `scan_errors`, not up the
stack), and `deploy` of a name not registered yet falls back to
`<scan_dir>/<name>.zip`.

Preprocessing travels with the model: a zip's `normalizer.json` becomes
the version's `transform`, which the batcher applies to every feature
batch on the model's device before the forward (`transform_features_device`,
etl.device_transform's `lower_normalizer`) and, for a normalizer fitted
with `fit_labels`, reverts on the outputs (`revert_outputs`). Quantized
deploys wait for nn/quant.py (ROADMAP queue 1 item 10).
"""
from __future__ import annotations

import os
import threading

from ..etl.device_transform import lower_normalizer
from ..telemetry.registry import Counter
from ..util.model_serializer import ModelSerializer
from ..util.time_source import now_s


class NoModelDeployed(RuntimeError):
    """Serving was asked for a model before any version was deployed: 503."""


class ModelVersion:
    def __init__(self, version, model, path=None, fmt=None, transform=None):
        self.version = str(version)
        self.model = model
        self.path = str(path) if path is not None else None
        self.fmt = fmt                       # zip format.json, when file-backed
        self.transform = transform           # a fitted DataNormalizer or None
        # lowered once, on the model's device (the host for a model without
        # one): an unfitted normalizer fails here, at registration
        self._apply = None
        if transform is not None:
            self._apply, _ = lower_normalizer(
                transform, device=getattr(model, "device", "cpu"))
        self.loaded_at = now_s()
        self.deployed_at = None
        self.serve_count = Counter("serve_count")  # rows served by it

    def transform_features_device(self, x):
        """The version's normalizer as torch ops on the model's device: a
        float32 tensor there, for integer-typed requests too (identity
        without a normalizer)."""
        return x if self._apply is None else self._apply(x)

    def revert_outputs(self, y):
        """Outputs back in label units for a normalizer fitted with
        `fit_labels=True`; identity otherwise."""
        return y if self.transform is None else self.transform.revert_labels(y)

    def info(self, active_version=None):
        return {
            "version": self.version,
            "model_class": type(self.model).__name__,
            "path": self.path,
            "format": self.fmt,
            "normalizer": type(self.transform).__name__
            if self.transform is not None else None,
            "quantized": None,
            "parity": None,
            "loaded_at": self.loaded_at,
            "deployed_at": self.deployed_at,
            "serve_count": self.serve_count.get(),
            "active": self.version == active_version,
        }


class ModelRegistry:
    def __init__(self, scan_dir=None, device=None):
        self.device = device          # where loaded zips go (None: the card)
        self._versions = {}
        self._active = None           # version string
        self._history = []            # previously active versions
        self._lock = threading.Lock()
        self._deploy_lock = threading.Lock()  # serializes deploy/rollback
        self.scan_dir = str(scan_dir) if scan_dir is not None else None
        self.scan_errors = {}         # {filename: error} of directory scans
        if self.scan_dir is not None:
            self.scan()

    # ---- persistent directory ---------------------------------------------
    def scan(self):
        """Load every zip in `scan_dir` not registered yet (version = file
        stem, in sorted order); returns the newly registered versions. A
        zip that does not load is recorded in `scan_errors`."""
        if self.scan_dir is None:
            return []
        loaded = []
        for fname in sorted(os.listdir(self.scan_dir)):
            if not fname.endswith(".zip"):
                continue
            version = fname[:-len(".zip")]
            with self._lock:
                known = version in self._versions
            if not known:
                try:
                    self.load(version, os.path.join(self.scan_dir, fname))
                except Exception as e:
                    self.scan_errors[fname] = f"{type(e).__name__}: {e}"
                    continue
                self.scan_errors.pop(fname, None)
                loaded.append(version)
        return loaded

    def _scan_path(self, version):
        """<scan_dir>/<version>.zip when it exists, else None."""
        if self.scan_dir is None:
            return None
        p = os.path.join(self.scan_dir, f"{version}.zip")
        return p if os.path.isfile(p) else None

    # ---- registration -----------------------------------------------------
    def register(self, version, model, path=None, fmt=None, transform=None):
        with self._lock:
            if str(version) in self._versions:
                raise ValueError(f"version {version!r} already registered")
            self._versions[str(version)] = ModelVersion(version, model, path,
                                                        fmt, transform)
        return str(version)

    def unregister(self, version):
        """Remove a non-active version (a registration whose deploy
        warm-up failed, so the same /deploy can be retried)."""
        version = str(version)
        with self._lock:
            if version == self._active:
                raise ValueError(f"version {version!r} is active")
            self._versions.pop(version, None)
            self._history = [v for v in self._history if v != version]

    def load(self, version, path):
        """Restore a ModelSerializer zip (type-sniffed, without its updater
        state) on the registry's device and register it with its
        format.json and its fitted normalizer (applied to every batch
        this version serves)."""
        fmt = ModelSerializer.read_format(path)
        model = ModelSerializer.restore(path, load_updater=False,
                                        device=self.device)
        normalizer = ModelSerializer.restore_normalizer(path)
        return self.register(version, model, path=path, fmt=fmt,
                             transform=normalizer)

    # ---- serving-side reads ------------------------------------------------
    def active_entry(self) -> ModelVersion:
        """The active ModelVersion as ONE snapshot (what a batch dispatches
        against)."""
        with self._lock:
            if self._active is None:
                raise NoModelDeployed("no model deployed")
            return self._versions[self._active]

    @property
    def active_version(self):
        with self._lock:
            return self._active

    def count_served(self, version, n_rows):
        with self._lock:
            mv = self._versions.get(version)
        if mv is not None:
            mv.serve_count.add(n_rows)

    def versions(self):
        with self._lock:
            active = self._active
            return [mv.info(active) for mv in self._versions.values()]

    def get(self, version):
        with self._lock:
            return self._versions[str(version)]

    # ---- deploy / rollback -------------------------------------------------
    def deploy(self, version, warmup=None, quantize=None):
        """Make `version` the serving model; returns the previous one.
        `warmup(model)` runs BEFORE the swap (the old version serves until
        it completes). A version not registered but present as
        `<scan_dir>/<version>.zip` is loaded first. `quantize` (the JAX
        package's int8 deploy) is not ported yet."""
        if quantize:
            raise NotImplementedError(
                "quantized deploys are not ported yet (ROADMAP queue 1 item "
                "10: nn/quant.py)")
        version = str(version)
        with self._deploy_lock:
            with self._lock:
                known = version in self._versions
            if not known:
                spath = self._scan_path(version)
                if spath is not None:
                    try:
                        self.load(version, spath)
                    except ValueError:
                        pass    # a concurrent scan() registered it: fine
            with self._lock:
                if version not in self._versions:
                    raise KeyError(f"unknown version {version!r}")
                mv = self._versions[version]
            if warmup is not None:
                warmup(mv.model)
            with self._lock:
                if version not in self._versions:
                    raise KeyError(
                        f"version {version!r} was unregistered during deploy")
                prev = self._active
                if prev is not None and prev != version:
                    self._history.append(prev)
                self._active = version
                mv.deployed_at = now_s()
            return prev

    def rollback(self, warmup=None):
        """Redeploy the previously active version; returns it. State changes
        only after the warm-up succeeds, so a failed rollback can simply be
        retried."""
        with self._deploy_lock:
            with self._lock:
                if not self._history:
                    raise RuntimeError("no previous version to roll back to")
                prev = self._history[-1]
                mv = self._versions[prev]
            if warmup is not None:
                warmup(mv.model)
            with self._lock:
                if (not self._history or self._history[-1] != prev
                        or prev not in self._versions):
                    raise RuntimeError(
                        f"rollback target {prev!r} changed during warm-up")
                self._history.pop()
                self._active = prev
                mv.deployed_at = now_s()
            return prev
