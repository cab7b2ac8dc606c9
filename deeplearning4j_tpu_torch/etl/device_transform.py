"""Device-side ingest: a fitted TransformProcess + DataNormalizer as torch
ops on the device, so the host ships narrow bytes and the step does the
widening (counterpart of deeplearning4j_tpu/etl/device_transform.py).

The host sends raw uint8 / integer records; the cast, the normalization
and the one-hot run as the first ops of the training step. On the card a
K-step plan (nn/multistep.py) captures them into its CUDA graph with the
rest of the step, so the widened batch never crosses the link.

Three cooperating pieces:

- `lower_normalizer(nz, device=)` — a fitted `DataNormalizer`'s affine
  stats as `apply(x)` / `revert(y)` on `device` (the serving batcher runs
  the version's normalizer through it on the model's device).
- op lowerers — one torch re-expression per TransformProcess op class, on
  the device of its input (`FilterRows` is the exception: its output row
  count depends on the data, so it always runs in the host prefix).
- `DeviceIngest` — the composite: splits an op chain into the minimal host
  prefix (non-lowerable ops + categorical string->code encoding) and the
  maximal device suffix, packs the host-side columns into ONE narrow array
  for the wire, and exposes `apply_features` / `apply_labels` for a
  network's train step (`set_ingest`) or a `DevicePrefetcher`
  (`device_transform=`).

Parity contract (tests/test_torch_device_ingest.py): for any records batch,
`apply_features(prepare_host(records))` matches the host NumPy path
(`host_reference`) and the JAX package's lowering to float32 rounding.

Nothing here reads a device value on the host: the one-hot compares the
ids with `arange(N)` (an id outside [0, N) gives an all-zero row, as
`jax.nn.one_hot` does), so a CUDA graph can capture every lowerer.
"""
from __future__ import annotations

import numpy as np
import torch

from ..datasets.dataset import DataSet
from ..device import resolve_device
from .normalizer import DataNormalizer
from .schema import ColumnType
from .transform import (CategoricalToInteger, CategoricalToOneHot,
                        DerivedColumn, MinMaxNormalize, RemoveColumns,
                        RenameColumn, SequenceWindow, Standardize,
                        TransformProcess)


# ---------------------------------------------------------------------------
# normalizer lowering
# ---------------------------------------------------------------------------

class _Affine:
    """A fitted normalizer's float32 (sub, div, scale, add), kept on each
    device it is used on (made there by the first, eager call)."""

    def __init__(self, normalizer, labels):
        self._stats = [np.asarray(v, np.float32)
                       for v in normalizer.device_stats(labels=labels)]
        self._on = {}

    def on(self, device):
        stats = self._on.get(device)
        if stats is None:
            stats = [torch.as_tensor(v).to(device) for v in self._stats]
            # "cuda" and the "cuda:0" its tensors report are one device
            self._on[device] = self._on[stats[0].device] = stats
        return stats

    def apply(self, x):
        sub, div, scale, add = self.on(x.device)
        return (x.to(torch.float32) - sub) / div * scale + add

    def revert(self, y):
        sub, div, scale, add = self.on(y.device)
        return (y.to(torch.float32) - add) / scale * div + sub


def lower_normalizer(normalizer, labels=False, device=None):
    """(apply, revert) over a FITTED normalizer's float32 affine stats on
    `device` (the card unless the caller passes `device="cpu"`):
    `apply(x) = (x - sub) / div * scale + add` and its inverse,
    the host formulas in the same order, so host and device agree to
    float32 rounding. Each takes a numpy array or a tensor (moved to
    `device`, cast to float32) and returns a float32 tensor there."""
    device = resolve_device(device)
    affine = _Affine(normalizer, labels)
    affine.on(device)

    def f32(x):
        return torch.as_tensor(x).to(device, torch.float32)

    def apply(x):
        return affine.apply(f32(x))

    def revert(y):
        return affine.revert(f32(y))

    return apply, revert


# ---------------------------------------------------------------------------
# per-op lowerers: op -> fn({name: tensor}) -> {name: tensor}
#
# Each mirrors the NumPy `apply` of its TransformOp, with two deliberate
# differences: math runs in float32 (not float64 — parity is to f32
# tolerance), and the fns tolerate absent keys (label columns ship in a
# separate narrow array and never enter the device feature dict).
# ---------------------------------------------------------------------------

def one_hot(ids, n):
    """float32 one-hot of integer `ids` over `n` classes on their device;
    an id outside [0, n) gives an all-zero row (`jax.nn.one_hot`'s rule;
    `F.one_hot` would check the values on the host and raise)."""
    ids = ids.to(torch.int64)
    return (ids[..., None] == torch.arange(n, device=ids.device)).to(
        torch.float32)


def _lower_categorical_to_integer(op, schema):
    def fn(cols):
        out = dict(cols)
        if op.column in out:        # host already encoded strings -> codes
            out[op.column] = out[op.column].to(torch.int32)
        return out
    return fn


def _lower_categorical_to_one_hot(op, schema):
    cats = schema.column(op.column).categories
    names = [f"{op.column}[{c}]" for c in cats]

    def fn(cols):
        out = {}
        for c in schema.columns:
            if c.name == op.column:
                if op.column not in cols:
                    continue
                # float codes cast to int32 first, as the JAX lowering does
                eye = one_hot(cols[op.column].to(torch.int32), len(cats))
                for k, n in enumerate(names):
                    out[n] = eye[..., k]
            elif c.name in cols:
                out[c.name] = cols[c.name]
        return out
    return fn


def _lower_min_max(op, schema):
    span = (op.max - op.min) or 1.0

    def fn(cols):
        out = dict(cols)
        if op.column in out:
            x = out[op.column].to(torch.float32)
            out[op.column] = (x - op.min) / span * (op.hi - op.lo) + op.lo
        return out
    return fn


def _lower_standardize(op, schema):
    std = op.std or 1.0

    def fn(cols):
        out = dict(cols)
        if op.column in out:
            out[op.column] = (out[op.column].to(torch.float32)
                              - op.mean) / std
        return out
    return fn


def _lower_remove_columns(op, schema):
    def fn(cols):
        return {k: v for k, v in cols.items() if k not in op.columns}
    return fn


def _lower_rename_column(op, schema):
    def fn(cols):
        return {(op.new if k == op.old else k): v for k, v in cols.items()}
    return fn


_DERIVE = {"add": lambda a, b: a + b, "sub": lambda a, b: a - b,
           "mul": lambda a, b: a * b, "div": lambda a, b: a / b,
           "log": lambda a, _: torch.log(a), "abs": lambda a, _: torch.abs(a)}


def _lower_derived_column(op, schema):
    def fn(cols):
        out = dict(cols)
        a = cols[op.columns[0]].to(torch.float32)
        if op.fn in ("log", "abs"):
            out[op.name] = _DERIVE[op.fn](a, None)
        elif len(op.columns) >= 2:
            acc = a
            for c in op.columns[1:]:
                acc = _DERIVE[op.fn](acc, cols[c].to(torch.float32))
            out[op.name] = acc
        else:
            # the scalar rounded to float32 first, as jnp.float32(scalar)
            out[op.name] = _DERIVE[op.fn](
                a, float(np.float32(op.scalar)))
        return out
    return fn


def _lower_sequence_window(op, schema):
    def fn(cols):
        out = {}
        for k, v in cols.items():
            n = v.shape[0]
            if n >= op.size:
                starts = range(0, n - op.size + 1, op.stride)
                out[k] = torch.stack([v[s:s + op.size] for s in starts])
            else:
                out[k] = v.new_zeros((0, op.size) + tuple(v.shape[1:]))
        return out
    return fn


_LOWERERS = {
    CategoricalToInteger: _lower_categorical_to_integer,
    CategoricalToOneHot: _lower_categorical_to_one_hot,
    MinMaxNormalize: _lower_min_max,
    Standardize: _lower_standardize,
    RemoveColumns: _lower_remove_columns,
    RenameColumn: _lower_rename_column,
    DerivedColumn: _lower_derived_column,
    SequenceWindow: _lower_sequence_window,
}
# FilterRows is intentionally absent: its output row count depends on the
# data — it always runs in the host prefix (where dropping rows is a cheap
# boolean index).


def _op_touches(op, columns):
    """Does `op` read or write any of `columns`? Used to keep label columns
    out of the device suffix (labels ship as their own narrow array)."""
    cols = set(columns)
    if isinstance(op, SequenceWindow):
        return True                 # windows every column, labels included
    for attr in ("column", "old", "new", "name"):
        if getattr(op, attr, None) in cols:
            return True
    if cols & set(getattr(op, "columns", ()) or ()):
        return True
    return False


# ---------------------------------------------------------------------------
# the composite
# ---------------------------------------------------------------------------

class DeviceIngest:
    """Compile an ETL column chain into (host prefix, narrow wire, device
    suffix).

    Host side: `prepare_host(records)` runs only the non-lowerable prefix
    ops, encodes categorical strings to integer codes, and packs the
    surviving feature columns into ONE narrow array (`wire_dtype`), labels
    into another — the bytes that actually cross the host link.

    Device side: `apply_features(x)` / `apply_labels(y)` are torch
    functions doing decode/cast/one-hot/normalize on the device of their
    input; fuse them into a train step with `network.set_ingest(ingest)`
    or run them on their own (`jit_apply_features`, the name the JAX
    package gives its jitted copy, is the same function here).

    Without a `transform` this is the image idiom: uint8 pixels on the wire,
    the lowered normalizer (or the model's own scaler preprocessor) widening
    on the device. `one_hot_labels=N` ships integer class ids and expands
    them on the device — the label matrix never crosses the link.
    """

    def __init__(self, transform: TransformProcess | None = None,
                 normalizer: DataNormalizer | None = None,
                 label_columns=None, one_hot_labels=None, feature_dtype=None):
        self.transform = transform
        self.normalizer = normalizer
        self.label_columns = list(label_columns or [])
        self.one_hot_labels = int(one_hot_labels) if one_hot_labels else None
        if self.one_hot_labels and len(self.label_columns) > 1:
            raise ValueError("one_hot_labels needs exactly one label column")
        self._wire_override = feature_dtype
        self._norm_apply = self._norm_apply_labels = None
        if normalizer is not None:
            self._norm_apply = _Affine(normalizer, False).apply
            if normalizer.fit_labels:
                # host transform() normalizes labels iff fit_labels, with
                # the labels=True stats — mirror that exactly on device
                self._norm_apply_labels = _Affine(normalizer, True).apply
        self._compile_split()

    # ---- chain split -------------------------------------------------------
    def _compile_split(self):
        tp = self.transform
        if tp is None:
            self._host_ops, self._device_ops = [], []
            self._mid_schema = None
            self._feature_names = self._final_feature_names = None
            self.wire_dtype = None
            return
        ops = tp.ops
        split = len(ops)
        for i in reversed(range(len(ops))):
            if type(ops[i]) not in _LOWERERS:
                break
            if self.label_columns and _op_touches(ops[i], self.label_columns):
                break
            split = i
        self._split = split
        self._host_ops = ops[:split]
        self._device_ops = ops[split:]
        self._mid_schema = tp.schema_at(split)
        mid_names = self._mid_schema.names()
        missing = [c for c in self.label_columns if c not in mid_names]
        if missing:
            raise ValueError(
                f"label columns {missing} not present at the device-ingest "
                f"split (schema: {mid_names}); create them before any "
                f"device-lowerable op")
        self._feature_names = [n for n in mid_names
                               if n not in self.label_columns]
        final = tp.final_schema().names()
        self._final_feature_names = [n for n in final
                                     if n not in self.label_columns]
        # lowered device chain, one fn per suffix op, schemas pre-resolved
        self._lowered = [
            _LOWERERS[type(op)](op, tp.schema_at(split + i))
            for i, op in enumerate(self._device_ops)]
        self.wire_dtype = self._pick_wire_dtype()

    def _pick_wire_dtype(self):
        if self.transform is None:
            return None
        if self._wire_override is not None:
            return np.dtype(self._wire_override)
        kinds, vocab_max = set(), 0
        for n in self._feature_names:
            c = self._mid_schema.column(n)
            kinds.add(c.kind)
            if c.kind == ColumnType.CATEGORICAL:
                vocab_max = max(vocab_max, len(c.categories))
        if ColumnType.NUMERIC in kinds or ColumnType.STRING in kinds:
            return np.dtype(np.float32)     # half the float64 batch bytes
        if ColumnType.INTEGER in kinds:
            return np.dtype(np.int32)
        return np.dtype(np.uint8 if vocab_max <= 256 else np.int32)

    # ---- host side ---------------------------------------------------------
    def prepare_host(self, records) -> DataSet:
        """records -> narrow DataSet: host prefix ops + categorical encoding
        + packing, NO float widening (that is the device's job)."""
        if self.transform is None:
            raise ValueError("prepare_host needs a TransformProcess; for "
                             "array sources build narrow DataSets directly")
        batch = self.transform.initial_schema.to_batch(records)
        return self.prepare_host_batch(batch)

    def prepare_host_batch(self, batch) -> DataSet:
        """Vectorized entry point: a column batch from `Schema.to_batch`."""
        for i, op in enumerate(self._host_ops):
            batch = op.apply(batch, self.transform.schema_at(i))
        cols = {n: self._encode(n, batch[n]) for n in self._mid_schema.names()}
        x = np.stack([np.asarray(cols[n], self.wire_dtype)
                      for n in self._feature_names], axis=-1)
        y = self._pack_labels(cols)
        return DataSet(x, y)

    def _encode(self, name, values):
        col = self._mid_schema.column(name)
        if col.kind != ColumnType.CATEGORICAL:
            return values
        lut = {c: i for i, c in enumerate(col.categories)}
        return np.asarray([lut[v] for v in values], np.int32)

    def _pack_labels(self, cols):
        if not self.label_columns:
            return None                     # DataSet mirrors features
        if self.one_hot_labels:
            ids = np.asarray(cols[self.label_columns[0]])
            return ids.astype(np.uint8 if self.one_hot_labels <= 256
                              else np.int32)
        return np.stack([np.asarray(cols[n], np.float32)
                         for n in self.label_columns], axis=-1)

    def host_reference(self, records) -> DataSet:
        """The WIDE host path (full NumPy chain + host normalizer) — the
        parity oracle the device functions are tested against, and exactly
        what `ParallelPipelineExecutor` produces without device ingest."""
        tp = self.transform
        cols = tp.execute_batch(tp.initial_schema.to_batch(records))
        feats = np.stack([np.asarray(cols[n], np.float32)
                          for n in self._final_feature_names], axis=-1)
        if self.one_hot_labels:
            idx = np.asarray(cols[self.label_columns[0]], np.int64)
            labels = np.eye(self.one_hot_labels, dtype=np.float32)[idx]
        elif self.label_columns:
            labels = np.stack([np.asarray(cols[n], np.float32)
                               for n in self.label_columns], axis=-1)
        else:
            labels = feats
        ds = DataSet(feats, labels)
        if self.normalizer is not None:
            ds = self.normalizer.transform(ds)
        return ds

    # ---- device side -------------------------------------------------------
    def _apply_chain(self, x):
        """Unpack the narrow wire batch, run the lowered op suffix, stack in
        final-schema order — the transform chain WITHOUT the normalizer."""
        if self.transform is None:
            return x
        cols = {n: x[..., i] for i, n in enumerate(self._feature_names)}
        for fn in self._lowered:
            cols = fn(cols)
        return torch.stack([cols[n].to(torch.float32)
                            for n in self._final_feature_names], dim=-1)

    def apply_features(self, x):
        """Narrow wire batch -> float32 feature batch on x's device: unpack
        columns, run the lowered op suffix, stack in final-schema order,
        apply the lowered normalizer. Without a transform or a normalizer
        the batch comes back as it is (the model casts it)."""
        x = torch.as_tensor(x)
        x = self._apply_chain(x)
        if self._norm_apply is not None:
            x = self._norm_apply(x)
        return x

    def apply_labels(self, y):
        """Narrow label batch -> what the loss consumes (one-hot expansion
        happens here, on the device — the label matrix never crosses the
        wire). Mirrors the host path: labels see the transform chain (when
        they mirror features) and the normalizer's LABEL stats iff
        fit_labels — never the feature stats."""
        y = torch.as_tensor(y)
        if self.one_hot_labels:
            if y.dim() > 1 and y.shape[-1] == 1:
                y = y[..., 0]
            y = one_hot(y.to(torch.int32), self.one_hot_labels)
        elif not self.label_columns:
            y = self._apply_chain(y)        # mirrored features-as-labels
        if self._norm_apply_labels is not None:
            y = self._norm_apply_labels(y)
        return y

    # ---- the JAX package's standalone-jit names ---------------------------
    @property
    def jit_apply_features(self):
        """`apply_features` itself: there is no jit to make."""
        return self.apply_features

    @property
    def jit_apply_labels(self):
        """`apply_labels` itself: there is no jit to make."""
        return self.apply_labels

    # ---- accounting --------------------------------------------------------
    def bytes_per_row(self):
        """Wire bytes per record (features + labels)."""
        if self.transform is None:
            return None
        n = len(self._feature_names) * self.wire_dtype.itemsize
        if self.one_hot_labels:
            n += 1 if self.one_hot_labels <= 256 else 4
        elif self.label_columns:
            n += 4 * len(self.label_columns)
        return n

    def __repr__(self):
        host = [type(o).__name__ for o in self._host_ops] \
            if self.transform else []
        dev = [type(o).__name__ for o in self._device_ops] \
            if self.transform else []
        return (f"DeviceIngest(host={host}, device={dev}, "
                f"wire_dtype={self.wire_dtype}, "
                f"normalizer={type(self.normalizer).__name__ if self.normalizer else None})")
