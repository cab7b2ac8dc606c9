"""TransformProcess: declarative, chainable, JSON-serializable column ops
(the port's copy of deeplearning4j_tpu/etl/transform.py, numpy only).

Reference: DataVec's org.datavec.api.transform.TransformProcess — a Builder
over an input Schema accumulating ops (categoricalToInteger, oneHot,
normalize, filter, removeColumns, renameColumn, ...), serializable to JSON so
the identical preprocessing runs at training and at serving time. The JSON
is the JAX package's byte for byte, so a process written by either package
loads in the other.

Ops execute vectorized on column batches ({name: np.ndarray}, see
schema.Schema.to_batch): one NumPy pass per op per batch.

Every op implements:
  output_schema(schema) -> Schema   (static shape/type propagation)
  apply(batch, schema)  -> batch    (vectorized execution)
  to_dict() / from_dict(d)          (JSON round-trip via the op registry)
"""
from __future__ import annotations

import json

import numpy as np

from .schema import Column, ColumnType, Schema

_OP_REGISTRY = {}


def _register(cls):
    _OP_REGISTRY[cls.op_name] = cls
    return cls


class TransformOp:
    op_name = None

    def output_schema(self, schema: Schema) -> Schema:
        raise NotImplementedError

    def apply(self, batch, schema: Schema):
        raise NotImplementedError

    def to_dict(self):
        raise NotImplementedError

    @classmethod
    def from_dict(cls, d):
        kw = {k: v for k, v in d.items() if k != "op"}
        return cls(**kw)

    def __eq__(self, other):
        return type(other) is type(self) and other.to_dict() == self.to_dict()


@_register
class CategoricalToInteger(TransformOp):
    """Category string -> its index in the schema vocabulary (reference:
    TransformProcess.categoricalToInteger)."""

    op_name = "categorical_to_integer"

    def __init__(self, column):
        self.column = str(column)

    def output_schema(self, schema):
        cols = [Column(c.name, ColumnType.INTEGER) if c.name == self.column
                else c for c in schema.columns]
        if schema.column(self.column).kind != ColumnType.CATEGORICAL:
            raise ValueError(f"{self.column!r} is not categorical")
        return Schema(cols)

    def apply(self, batch, schema):
        cats = schema.column(self.column).categories
        lut = {c: i for i, c in enumerate(cats)}
        out = dict(batch)
        out[self.column] = np.asarray(
            [lut[v] for v in batch[self.column]], np.int64)
        return out

    def to_dict(self):
        return {"op": self.op_name, "column": self.column}


@_register
class CategoricalToOneHot(TransformOp):
    """Replace a categorical column with one numeric 0/1 column per category,
    named `col[cat]` (reference: TransformProcess.categoricalToOneHot)."""

    op_name = "categorical_to_one_hot"

    def __init__(self, column):
        self.column = str(column)

    def _names(self, schema):
        return [f"{self.column}[{c}]"
                for c in schema.column(self.column).categories]

    def output_schema(self, schema):
        cols = []
        for c in schema.columns:
            if c.name == self.column:
                cols.extend(Column(n, ColumnType.NUMERIC)
                            for n in self._names(schema))
            else:
                cols.append(c)
        return Schema(cols)

    def apply(self, batch, schema):
        cats = schema.column(self.column).categories
        lut = {c: i for i, c in enumerate(cats)}
        idx = np.asarray([lut[v] for v in batch[self.column]], np.int64)
        eye = np.eye(len(cats), dtype=np.float64)[idx]    # [n, n_cats]
        out = {}
        for c in schema.columns:
            if c.name == self.column:
                for k, n in enumerate(self._names(schema)):
                    out[n] = eye[:, k]
            else:
                out[c.name] = batch[c.name]
        return out

    def to_dict(self):
        return {"op": self.op_name, "column": self.column}


@_register
class MinMaxNormalize(TransformOp):
    """x -> (x - min) / (max - min) * (hi - lo) + lo (reference: DataVec
    Normalize.MinMax). Stats are explicit op parameters so the process is
    self-contained after JSON round-trip; fit them with a DataNormalizer or
    pass known bounds."""

    op_name = "min_max_normalize"

    def __init__(self, column, min, max, lo=0.0, hi=1.0):
        self.column = str(column)
        self.min, self.max = float(min), float(max)
        self.lo, self.hi = float(lo), float(hi)

    def output_schema(self, schema):
        schema.column(self.column)           # must exist
        return schema

    def apply(self, batch, schema):
        out = dict(batch)
        span = (self.max - self.min) or 1.0
        x = np.asarray(batch[self.column], np.float64)
        out[self.column] = (x - self.min) / span * (self.hi - self.lo) + self.lo
        return out

    def to_dict(self):
        return {"op": self.op_name, "column": self.column, "min": self.min,
                "max": self.max, "lo": self.lo, "hi": self.hi}


@_register
class Standardize(TransformOp):
    """x -> (x - mean) / std (reference: DataVec Normalize.Standardize)."""

    op_name = "standardize"

    def __init__(self, column, mean, std):
        self.column = str(column)
        self.mean, self.std = float(mean), float(std)

    def output_schema(self, schema):
        schema.column(self.column)
        return schema

    def apply(self, batch, schema):
        out = dict(batch)
        x = np.asarray(batch[self.column], np.float64)
        out[self.column] = (x - self.mean) / (self.std or 1.0)
        return out

    def to_dict(self):
        return {"op": self.op_name, "column": self.column,
                "mean": self.mean, "std": self.std}


_CONDITIONS = {
    "lt": lambda x, v: x < v,
    "le": lambda x, v: x <= v,
    "gt": lambda x, v: x > v,
    "ge": lambda x, v: x >= v,
    "eq": lambda x, v: x == v,
    "ne": lambda x, v: x != v,
    "in": lambda x, v: np.isin(x, list(v)),
}


@_register
class FilterRows(TransformOp):
    """REMOVE rows where `column <cond> value` holds (reference: DataVec
    TransformProcess.filter(ConditionFilter) — examples matching the
    condition are removed)."""

    op_name = "filter_rows"

    def __init__(self, column, cond, value):
        if cond not in _CONDITIONS:
            raise ValueError(f"unknown condition {cond!r} "
                             f"(one of {sorted(_CONDITIONS)})")
        self.column = str(column)
        self.cond = str(cond)
        self.value = value

    def output_schema(self, schema):
        schema.column(self.column)
        return schema

    def apply(self, batch, schema):
        drop = _CONDITIONS[self.cond](batch[self.column], self.value)
        keep = ~np.asarray(drop, bool)
        return {k: v[keep] for k, v in batch.items()}

    def to_dict(self):
        return {"op": self.op_name, "column": self.column, "cond": self.cond,
                "value": self.value}


@_register
class RemoveColumns(TransformOp):
    """(reference: TransformProcess.removeColumns)"""

    op_name = "remove_columns"

    def __init__(self, columns):
        self.columns = [str(c) for c in columns]

    def output_schema(self, schema):
        for c in self.columns:
            schema.column(c)
        return Schema([c for c in schema.columns
                       if c.name not in self.columns])

    def apply(self, batch, schema):
        return {k: v for k, v in batch.items() if k not in self.columns}

    def to_dict(self):
        return {"op": self.op_name, "columns": list(self.columns)}


@_register
class RenameColumn(TransformOp):
    """(reference: TransformProcess.renameColumn)"""

    op_name = "rename_column"

    def __init__(self, old, new):
        self.old, self.new = str(old), str(new)

    def output_schema(self, schema):
        src = schema.column(self.old)
        return Schema([Column(self.new, c.kind, c.categories)
                       if c.name == self.old else c for c in schema.columns])

    def apply(self, batch, schema):
        return {(self.new if k == self.old else k): v
                for k, v in batch.items()}

    def to_dict(self):
        return {"op": self.op_name, "old": self.old, "new": self.new}


_DERIVE = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
    "log": lambda a, _: np.log(a),
    "abs": lambda a, _: np.abs(a),
}


@_register
class DerivedColumn(TransformOp):
    """Append a numeric column computed from existing columns (the analog of
    DataVec's math ops / DoubleMathOp family). `columns` supplies the
    operands in order; `scalar` stands in for the second operand of a binary
    op when only one column is given; unary ops (`log`, `abs`) ignore it."""

    op_name = "derived_column"

    def __init__(self, name, fn, columns, scalar=None):
        if fn not in _DERIVE:
            raise ValueError(f"unknown derive fn {fn!r}")
        self.name = str(name)
        self.fn = str(fn)
        self.columns = [str(c) for c in columns]
        self.scalar = scalar
        if not self.columns:
            raise ValueError("derived_column needs at least one column")
        if (fn not in ("log", "abs") and len(self.columns) == 1
                and scalar is None):
            # fail at build time, not at batch N in a worker thread
            raise ValueError(
                f"binary derive fn {fn!r} with a single column needs a "
                f"`scalar` second operand")

    def output_schema(self, schema):
        for c in self.columns:
            schema.column(c)
        return Schema(schema.columns + [Column(self.name, ColumnType.NUMERIC)])

    def apply(self, batch, schema):
        out = dict(batch)
        a = np.asarray(batch[self.columns[0]], np.float64)
        if self.fn in ("log", "abs"):
            out[self.name] = _DERIVE[self.fn](a, None)
        elif len(self.columns) >= 2:
            acc = a
            for c in self.columns[1:]:
                acc = _DERIVE[self.fn](acc,
                                       np.asarray(batch[c], np.float64))
            out[self.name] = acc
        else:
            out[self.name] = _DERIVE[self.fn](a, float(self.scalar))
        return out

    def to_dict(self):
        return {"op": self.op_name, "name": self.name, "fn": self.fn,
                "columns": list(self.columns), "scalar": self.scalar}


@_register
class SequenceWindow(TransformOp):
    """Turn a stream of rows into overlapping windows: after this op each
    output row is a window of `size` consecutive input rows, every column
    value a length-`size` vector (reference: DataVec's sequence split /
    window ops, reshaped for vectorized execution). Downstream assembly
    stacks such columns into [batch, time, features] sequences for the
    recurrent layers. Windowing applies WITHIN each incoming batch, so feed
    it whole sequences (e.g. pipeline chunk_size = sequence length)."""

    op_name = "sequence_window"

    def __init__(self, size, stride=None):
        self.size = int(size)
        self.stride = int(stride) if stride is not None else self.size

    def output_schema(self, schema):
        for c in schema.columns:
            if c.kind not in (ColumnType.NUMERIC, ColumnType.INTEGER):
                raise ValueError(
                    f"sequence_window needs numeric columns; {c.name!r} is "
                    f"{c.kind} (convert categoricals first)")
        return schema

    def apply(self, batch, schema):
        out = {}
        for k, v in batch.items():
            n = len(v)
            starts = range(0, max(n - self.size + 1, 0), self.stride)
            out[k] = np.stack([v[s:s + self.size] for s in starts]) \
                if n >= self.size else np.empty((0, self.size), v.dtype)
        return out

    def to_dict(self):
        return {"op": self.op_name, "size": self.size, "stride": self.stride}


class TransformProcess:
    """Ordered op chain over an initial Schema (reference: DataVec
    TransformProcess). Build with the fluent Builder, execute vectorized on
    column batches or record lists, round-trip through JSON."""

    def __init__(self, initial_schema: Schema, ops=None):
        self.initial_schema = initial_schema
        self.ops = list(ops or [])
        # validate the whole chain eagerly (a bad op should fail at build
        # time, not at batch N in a worker thread) and cache each op's input
        # schema — execute_batch runs on the pipeline workers' hot path and
        # must not rebuild N Schema objects per batch
        self._schemas = [initial_schema]
        for op in self.ops:
            self._schemas.append(op.output_schema(self._schemas[-1]))

    # ---- builder -----------------------------------------------------------
    class Builder:
        def __init__(self, schema: Schema):
            self._schema = schema
            self._ops = []

        def _add(self, op):
            self._ops.append(op)
            return self

        def categorical_to_integer(self, column):
            return self._add(CategoricalToInteger(column))

        def categorical_to_one_hot(self, column):
            return self._add(CategoricalToOneHot(column))

        def min_max_normalize(self, column, min, max, lo=0.0, hi=1.0):
            return self._add(MinMaxNormalize(column, min, max, lo, hi))

        def standardize(self, column, mean, std):
            return self._add(Standardize(column, mean, std))

        def filter_rows(self, column, cond, value):
            return self._add(FilterRows(column, cond, value))

        def remove_columns(self, *columns):
            return self._add(RemoveColumns(columns))

        def rename_column(self, old, new):
            return self._add(RenameColumn(old, new))

        def derived_column(self, name, fn, columns, scalar=None):
            return self._add(DerivedColumn(name, fn, columns, scalar))

        def sequence_window(self, size, stride=None):
            return self._add(SequenceWindow(size, stride))

        def build(self):
            return TransformProcess(self._schema, self._ops)

    @staticmethod
    def builder(schema: Schema):
        return TransformProcess.Builder(schema)

    # ---- execution ---------------------------------------------------------
    def final_schema(self) -> Schema:
        return self._schemas[-1]

    def schema_at(self, i) -> Schema:
        """Schema ENTERING op i (schema_at(0) = initial, schema_at(len(ops))
        = final). The device-ingest compiler (etl.device_transform) uses this
        to split the chain into a host prefix and a torch-lowered device
        suffix without re-deriving schemas on the hot path."""
        return self._schemas[i]

    def execute_batch(self, batch):
        """Run the chain vectorized on a column batch; returns the final
        column batch (keys match final_schema().names())."""
        for op, s in zip(self.ops, self._schemas):
            batch = op.apply(batch, s)
        return batch

    def execute(self, records):
        """Record-list convenience: vectorize, run, de-vectorize."""
        batch = self.execute_batch(self.initial_schema.to_batch(records))
        return self.final_schema().to_records(batch)

    # ---- serialization -----------------------------------------------------
    def to_dict(self):
        return {"schema": self.initial_schema.to_dict(),
                "ops": [op.to_dict() for op in self.ops]}

    @staticmethod
    def from_dict(d):
        ops = []
        for od in d["ops"]:
            cls = _OP_REGISTRY.get(od.get("op"))
            if cls is None:
                raise ValueError(f"unknown transform op {od.get('op')!r}")
            ops.append(cls.from_dict(od))
        return TransformProcess(Schema.from_dict(d["schema"]), ops)

    def to_json(self):
        return json.dumps(self.to_dict())

    @staticmethod
    def from_json(s):
        return TransformProcess.from_dict(json.loads(s))

    def __eq__(self, other):
        return (isinstance(other, TransformProcess)
                and self.to_dict() == other.to_dict())
