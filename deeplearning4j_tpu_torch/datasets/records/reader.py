"""Record readers: files -> records (lists of values) (the port's copy of
deeplearning4j_tpu/datasets/records/reader.py).

Reference: DataVec's RecordReader contract (next() -> List<Writable>) and
its sequence variant (sequenceRecord() -> List<List<...>>).

A record is a list of python scalars (float/int/str); a sequence record is a
list of records (time steps). Image records are numpy arrays. CSV is parsed
by the standard library's csv module: a numeric field becomes a float, any
other a stripped string, the values the JAX package's readers give.
"""
from __future__ import annotations

import csv
import os

import numpy as np


class RecordReader:
    """Record iteration contract (DataVec RecordReader)."""

    def has_next(self):
        raise NotImplementedError

    def next_record(self):
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError

    def __iter__(self):
        self.reset()
        return self

    def __next__(self):
        if not self.has_next():
            raise StopIteration
        return self.next_record()


class SequenceRecordReader(RecordReader):
    """Sequence variant: next_sequence() returns a list of time-step records."""

    def next_sequence(self):
        raise NotImplementedError


def _coerce(v):
    """CSV field → float if numeric else stripped string."""
    v = v.strip()
    try:
        return float(v)
    except ValueError:
        return v


class CSVRecordReader(RecordReader):
    """One record per CSV line (DataVec CSVRecordReader: skipNumLines,
    delimiter, quote-aware parsing)."""

    def __init__(self, skip_lines=0, delimiter=",", quotechar='"'):
        self.skip_lines = int(skip_lines)
        self.delimiter = delimiter
        self.quotechar = quotechar
        self._rows = None
        self._i = 0

    def initialize(self, path):
        with open(path, newline="") as f:
            rows = list(csv.reader(f, delimiter=self.delimiter,
                                   quotechar=self.quotechar))
        self._rows = [r for r in rows[self.skip_lines:] if r]
        self._i = 0
        return self

    def has_next(self):
        return self._rows is not None and self._i < len(self._rows)

    def next_record(self):
        row = self._rows[self._i]
        self._i += 1
        return [_coerce(v) for v in row]

    def reset(self):
        self._i = 0


class CSVSequenceRecordReader(SequenceRecordReader):
    """One CSV file per sequence (DataVec CSVSequenceRecordReader). Initialize
    with a list of file paths or a glob-matching directory; each file's rows
    are the sequence's time steps."""

    def __init__(self, skip_lines=0, delimiter=","):
        self.skip_lines = int(skip_lines)
        self.delimiter = delimiter
        self._files = []
        self._i = 0

    def initialize(self, paths):
        if isinstance(paths, (str, os.PathLike)):
            root = str(paths)
            self._files = sorted(
                os.path.join(root, f) for f in os.listdir(root)
                if f.lower().endswith(".csv"))
        else:
            self._files = [str(p) for p in paths]
        self._i = 0
        return self

    def has_next(self):
        return self._i < len(self._files)

    def next_sequence(self):
        path = self._files[self._i]
        self._i += 1
        reader = CSVRecordReader(self.skip_lines, self.delimiter)
        reader.initialize(path)
        return [reader.next_record() for _ in iter(
            lambda: reader.has_next() or None, None)]

    next_record = next_sequence

    def reset(self):
        self._i = 0


class ImageRecordReader(RecordReader):
    """Directory-of-class-subdirectories → (image array, label index) records
    (DataVec ImageRecordReader with ParentPathLabelGenerator). Decodes via
    PIL; output HWC float32 in [0, 1]."""

    EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".gif")

    def __init__(self, height=None, width=None, channels=3):
        self.height = height
        self.width = width
        self.channels = int(channels)
        self.labels = []
        self._items = []      # (path, label_idx)
        self._i = 0

    def initialize(self, root):
        root = str(root)
        self.labels = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
        self._items = []
        for li, lab in enumerate(self.labels):
            d = os.path.join(root, lab)
            for f in sorted(os.listdir(d)):
                if f.lower().endswith(self.EXTS):
                    self._items.append((os.path.join(d, f), li))
        self._i = 0
        return self

    def num_labels(self):
        return len(self.labels)

    def has_next(self):
        return self._i < len(self._items)

    def next_record(self):
        from PIL import Image
        path, label = self._items[self._i]
        self._i += 1
        img = Image.open(path)
        if self.channels == 1:
            img = img.convert("L")
        else:
            img = img.convert("RGB")
        if self.height and self.width:
            img = img.resize((self.width, self.height))
        arr = np.asarray(img, np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[..., None]
        return [arr, label]

    def reset(self):
        self._i = 0


class CollectionRecordReader(RecordReader):
    """Records from an in-memory collection (DataVec
    CollectionRecordReader) — test fixture and programmatic feeding."""

    def __init__(self, records):
        self._records = list(records)
        self._i = 0

    def has_next(self):
        return self._i < len(self._records)

    def next_record(self):
        r = self._records[self._i]
        self._i += 1
        return list(r)

    def reset(self):
        self._i = 0


class ListStringRecordReader(RecordReader):
    """Records from lists of strings (DataVec ListStringRecordReader)."""

    def __init__(self, data):
        self._data = [[_coerce(v) for v in row] for row in data]
        self._i = 0

    def has_next(self):
        return self._i < len(self._data)

    def next_record(self):
        r = self._data[self._i]
        self._i += 1
        return list(r)

    def reset(self):
        self._i = 0
