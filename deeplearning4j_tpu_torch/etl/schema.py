"""Column schema over record streams (the port's copy of
deeplearning4j_tpu/etl/schema.py, numpy only).

Reference: DataVec's `Schema` (org.datavec.api.transform.schema.Schema —
ordered, typed column metadata with a fluent Builder).

A Schema names and types the columns of a record stream so TransformProcess
ops can be validated and executed vectorized: records (lists of scalars)
round-trip to a *column batch* — {column_name: np.ndarray} with one entry per
column — which is the representation every transform op works on. The JSON
is the JAX package's, key for key.
"""
from __future__ import annotations

import json

import numpy as np


class ColumnType:
    """(reference: org.datavec.api.transform.ColumnType)"""
    NUMERIC = "numeric"          # float-valued (DL4J Double/Float)
    INTEGER = "integer"
    CATEGORICAL = "categorical"  # closed string vocabulary
    STRING = "string"            # free-form text


class Column:
    __slots__ = ("name", "kind", "categories")

    def __init__(self, name, kind, categories=None):
        self.name = str(name)
        self.kind = str(kind)
        self.categories = list(categories) if categories is not None else None
        if self.kind == ColumnType.CATEGORICAL and not self.categories:
            raise ValueError(f"categorical column {name!r} needs categories")

    def to_dict(self):
        d = {"name": self.name, "type": self.kind}
        if self.categories is not None:
            d["categories"] = list(self.categories)
        return d

    @staticmethod
    def from_dict(d):
        return Column(d["name"], d["type"], d.get("categories"))

    def __eq__(self, other):
        return (isinstance(other, Column) and self.name == other.name
                and self.kind == other.kind
                and self.categories == other.categories)

    def __repr__(self):
        return f"Column({self.name!r}, {self.kind!r})"


class Schema:
    """Ordered, typed column metadata (reference: DataVec Schema)."""

    def __init__(self, columns):
        self.columns = list(columns)
        names = [c.name for c in self.columns]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate column names: {names}")

    # ---- builder (reference: Schema.Builder fluent API) --------------------
    class Builder:
        def __init__(self):
            self._cols = []

        def add_numeric(self, *names):
            for n in names:
                self._cols.append(Column(n, ColumnType.NUMERIC))
            return self

        add_double = add_numeric        # DL4J addColumnDouble spelling

        def add_integer(self, *names):
            for n in names:
                self._cols.append(Column(n, ColumnType.INTEGER))
            return self

        def add_categorical(self, name, categories):
            self._cols.append(Column(name, ColumnType.CATEGORICAL, categories))
            return self

        def add_string(self, *names):
            for n in names:
                self._cols.append(Column(n, ColumnType.STRING))
            return self

        def build(self):
            return Schema(self._cols)

    @staticmethod
    def builder():
        return Schema.Builder()

    # ---- introspection -----------------------------------------------------
    def names(self):
        return [c.name for c in self.columns]

    def column(self, name) -> Column:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(f"no column {name!r} in {self.names()}")

    def index_of(self, name):
        for i, c in enumerate(self.columns):
            if c.name == name:
                return i
        raise KeyError(f"no column {name!r} in {self.names()}")

    def has_column(self, name):
        return any(c.name == name for c in self.columns)

    def num_columns(self):
        return len(self.columns)

    # ---- records <-> column batch -----------------------------------------
    def to_batch(self, records):
        """Vectorize a list of records into {name: np.ndarray}. Numeric and
        integer columns become float64/int64 arrays; categorical and string
        columns become object arrays (transform ops map them to numbers)."""
        cols = {}
        n = len(records)
        for j, c in enumerate(self.columns):
            vals = [r[j] for r in records]
            if c.kind == ColumnType.NUMERIC:
                cols[c.name] = np.asarray(vals, np.float64)
            elif c.kind == ColumnType.INTEGER:
                cols[c.name] = np.asarray(vals, np.int64)
            else:
                cols[c.name] = np.asarray(vals, object)
            if cols[c.name].shape[:1] != (n,):
                raise ValueError(f"ragged column {c.name!r}")
        return cols

    def to_records(self, batch):
        """Inverse of to_batch for the CURRENT schema's column order."""
        names = self.names()
        n = len(batch[names[0]]) if names else 0
        out = []
        for i in range(n):
            out.append([batch[name][i].tolist()
                        if isinstance(batch[name][i], np.ndarray)
                        else batch[name][i] for name in names])
        return out

    # ---- serialization -----------------------------------------------------
    def to_dict(self):
        return {"columns": [c.to_dict() for c in self.columns]}

    @staticmethod
    def from_dict(d):
        return Schema([Column.from_dict(c) for c in d["columns"]])

    def to_json(self):
        return json.dumps(self.to_dict())

    @staticmethod
    def from_json(s):
        return Schema.from_dict(json.loads(s))

    def __eq__(self, other):
        return isinstance(other, Schema) and self.columns == other.columns

    def __repr__(self):
        return f"Schema({self.names()})"
