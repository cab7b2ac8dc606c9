"""MNIST fetcher + iterator (counterpart of
deeplearning4j_tpu/datasets/fetchers/mnist.py).

No download: the fetcher looks for local copies of the IDX files
(MNIST_DIR, ~/.deeplearning4j_tpu/mnist, ~/.cache/mnist, /data/mnist),
then the committed real-digit fixture tests/fixtures/mnist_real (1297
train / 500 test handwritten digits, 8x8 UCI digits upsampled to the
28x28 MNIST IDX layout), and only then falls back to a deterministic
synthetic digit set (class-conditional, so models still learn). The IDX
files are parsed on the host with `struct`; the iterator hands out numpy
batches, which a model moves to its device.

Reference: MnistDataFetcher.java, the IDX readers of datasets/mnist/ and
datasets/iterator/impl/MnistDataSetIterator.java.
"""
from __future__ import annotations

import gzip
import os
import struct
import warnings

import numpy as np

from ..dataset import DataSet
from ..iterator.base import DataSetIterator

_CACHE = {}
FIXTURE_DIR = os.path.normpath(os.path.join(
    os.path.dirname(__file__), os.pardir, os.pardir, os.pardir, "tests",
    "fixtures", "mnist_real"))


def _read_raw(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        return f.read()


def _read_idx_images(path):
    """[n, rows, cols] uint8 of an IDX3 image file (raw or gzipped)."""
    raw = _read_raw(path)
    magic, n, rows, cols = struct.unpack(">IIII", raw[:16])
    if magic != 2051:
        raise ValueError(f"{path}: bad IDX image magic {magic}")
    data = np.frombuffer(raw, dtype=np.uint8, count=n * rows * cols,
                         offset=16)
    return data.reshape(n, rows, cols)


def _read_idx_labels(path):
    """[n] uint8 of an IDX1 label file (raw or gzipped)."""
    raw = _read_raw(path)
    magic, n = struct.unpack(">II", raw[:8])
    if magic != 2049:
        raise ValueError(f"{path}: bad IDX label magic {magic}")
    return np.frombuffer(raw, dtype=np.uint8, count=n, offset=8)


def _find_mnist_files(train):
    """(images path, labels path) of the first candidate directory holding
    both files of the split, raw or gzipped; (None, None) if none does."""
    prefix = "train" if train else "t10k"
    candidates = [
        os.environ.get("MNIST_DIR"),
        os.path.expanduser("~/.deeplearning4j_tpu/mnist"),
        os.path.expanduser("~/.cache/mnist"),
        "/data/mnist",
        # full MNIST from any directory above wins; real beats synthetic
        FIXTURE_DIR,
    ]
    for d in candidates:
        if not d or not os.path.isdir(d):
            continue
        for suffix in ("", ".gz"):
            img = os.path.join(d, f"{prefix}-images-idx3-ubyte{suffix}")
            lab = os.path.join(d, f"{prefix}-labels-idx1-ubyte{suffix}")
            if os.path.exists(img) and os.path.exists(lab):
                return img, lab
    return None, None


def _synthetic_mnist(n, seed):
    """Deterministic class-conditional synthetic digits: a fixed random
    28x28 prototype per class plus noise."""
    rng = np.random.default_rng(seed)
    protos = np.random.default_rng(1234).random((10, 28, 28)).astype(
        np.float32)
    labels = rng.integers(0, 10, n)
    imgs = protos[labels] + 0.35 * rng.standard_normal(
        (n, 28, 28)).astype(np.float32)
    imgs = np.clip(imgs, 0.0, 1.0)
    return imgs.astype(np.float32), labels.astype(np.int64)


def load_mnist(train=True, num_examples=None):
    """(images [n, 28, 28] float32 in [0, 1], labels [n] int64)."""
    key = (train, num_examples)
    if key in _CACHE:
        return _CACHE[key]
    img_path, lab_path = _find_mnist_files(train)
    if img_path:
        imgs = _read_idx_images(img_path).astype(np.float32) / 255.0
        labels = _read_idx_labels(lab_path).astype(np.int64)
        if num_examples is not None and len(imgs) < num_examples:
            warnings.warn(
                f"MNIST source {os.path.dirname(img_path)} holds only "
                f"{len(imgs)} examples ({num_examples} requested); using all "
                f"{len(imgs)}", stacklevel=2)
    else:
        n = num_examples or (60000 if train else 10000)
        imgs, labels = _synthetic_mnist(n, seed=0 if train else 1)
    if num_examples is not None:
        imgs, labels = imgs[:num_examples], labels[:num_examples]
    _CACHE[key] = (imgs, labels)
    return imgs, labels


class MnistDataSetIterator(DataSetIterator):
    """NHWC image batches [b, 28, 28, 1] (flat [b, 784] with
    `flatten=True`) with one-hot labels [b, 10]; shuffled once with
    numpy's `default_rng(seed).permutation`, as the JAX package does."""

    def __init__(self, batch_size, train=True, num_examples=None,
                 flatten=False, shuffle=True, seed=123, binarize=False):
        self.batch_size = int(batch_size)
        self.flatten = flatten
        imgs, labels = load_mnist(train, num_examples)
        if binarize:
            imgs = (imgs > 0.5).astype(np.float32)
        if shuffle:
            idx = np.random.default_rng(seed).permutation(len(imgs))
            imgs, labels = imgs[idx], labels[idx]
        self._x = imgs.reshape(len(imgs), -1) if flatten else imgs[..., None]
        self._y = np.eye(10, dtype=np.float32)[labels]
        self._i = 0

    def next(self):
        s, e = self._i, min(self._i + self.batch_size, len(self._x))
        self._i = e
        return DataSet(self._x[s:e], self._y[s:e])

    def has_next(self):
        return self._i < len(self._x)

    def reset(self):
        self._i = 0

    def batch(self):
        return self.batch_size

    def total_examples(self):
        return len(self._x)
