"""Standard dataset fetchers/iterators beyond MNIST (counterpart of
deeplearning4j_tpu/datasets/fetchers/standard.py).

No download: each iterator reads a local copy first (an env var pointing
at the standard layout) and otherwise a deterministic synthetic surrogate
of the same shapes with class-conditional structure. CIFAR's binary
records are read on the host from CIFAR_DIR, ~/.deeplearning4j_tpu/cifar
or the committed real-photo fixture tests/fixtures/cifar_real (960 train
/ 240 test 32x32 photograph crops in the CIFAR record layout: real
pixels, not the CIFAR-10 classes).

Reference: datasets/iterator/impl/{IrisDataSetIterator,
CifarDataSetIterator, LFWDataSetIterator, CurvesDataSetIterator}.java.
"""
from __future__ import annotations

import gzip
import os
import sys
import warnings

import numpy as np

from ..dataset import DataSet
from ..iterator.base import DataSetIterator, ListDataSetIterator

CIFAR_FIXTURE_DIR = os.path.normpath(os.path.join(
    os.path.dirname(__file__), os.pardir, os.pardir, os.pardir, "tests",
    "fixtures", "cifar_real"))


class _ArrayIterator(DataSetIterator):
    """Batch iterator over in-memory arrays (`batch` is the batch size,
    an attribute here as in the JAX package)."""

    def __init__(self, x, y, batch_size):
        self._x, self._y = x, y
        self.batch = int(batch_size)
        self._i = 0

    def reset(self):
        self._i = 0
        return self

    def has_next(self):
        return self._i < len(self._x)

    def next(self, num=None):
        n = num or self.batch
        s = self._i
        self._i += n
        return DataSet(self._x[s:s + n], self._y[s:s + n])

    def total_examples(self):
        return len(self._x)

    def input_columns(self):
        return int(np.prod(self._x.shape[1:]))

    def total_outcomes(self):
        return self._y.shape[-1]

    def __iter__(self):
        while self.has_next():
            yield self.next()


def _synthetic_gaussian_classes(n, dims, n_classes, seed, spread=2.0):
    """Deterministic class-conditional Gaussian clusters."""
    rng = np.random.default_rng(seed)
    means = rng.normal(scale=spread, size=(n_classes,) + (
        dims if isinstance(dims, tuple) else (dims,)))
    ys = np.tile(np.arange(n_classes), n // n_classes + 1)[:n]
    x = means[ys] + rng.normal(scale=1.0, size=(n,) + means.shape[1:])
    y = np.eye(n_classes, dtype=np.float32)[ys]
    order = rng.permutation(n)
    return x[order].astype(np.float32), y[order]


class IrisDataSetIterator(_ArrayIterator):
    """150 x 4 features, 3 classes: a local `iris.data` CSV (IRIS_PATH)
    or 3 synthetic clusters of the same shape."""

    N, DIMS, CLASSES = 150, 4, 3

    def __init__(self, batch_size=150, num_examples=150):
        path = os.environ.get("IRIS_PATH")
        if path and os.path.exists(path):
            rows = []
            names = {}
            with open(path) as fh:
                for line in fh:
                    parts = line.strip().split(",")
                    if len(parts) != 5:
                        continue
                    lbl = names.setdefault(parts[4], len(names))
                    rows.append([float(v) for v in parts[:4]] + [lbl])
            arr = np.array(rows, np.float32)
            x = arr[:, :4]
            y = np.eye(self.CLASSES, dtype=np.float32)[arr[:, 4].astype(int)]
        else:
            x, y = _synthetic_gaussian_classes(self.N, self.DIMS,
                                               self.CLASSES, seed=4242)
        super().__init__(x[:num_examples], y[:num_examples], batch_size)


def _find_cifar_dir():
    """The first directory holding both CIFAR splits (data_batch_1.bin and
    test_batch.bin, raw or gzipped): CIFAR_DIR, the local cache, then the
    committed fixture; a directory with one split only is skipped with a
    warning (real train data beside a synthetic test split would publish
    a bogus accuracy)."""
    candidates = [
        os.environ.get("CIFAR_DIR"),
        os.path.expanduser("~/.deeplearning4j_tpu/cifar"),
        CIFAR_FIXTURE_DIR,
    ]

    def has(d, base):
        return any(os.path.exists(os.path.join(d, base + sfx))
                   for sfx in ("", ".gz"))

    for d in candidates:
        if not d or not os.path.isdir(d):
            continue
        if has(d, "data_batch_1.bin") and has(d, "test_batch.bin"):
            return d
        warnings.warn(f"CIFAR dir {d} is missing a split "
                      "(need data_batch_1.bin and test_batch.bin, raw or "
                      ".gz); skipping it", stacklevel=2)
    return None


def _read_cifar_records(path):
    """(images NHWC uint8, labels uint8) of a file of CIFAR records (one
    label byte, then 3072 bytes of R, G and B planes), raw or gzipped."""
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        raw = np.frombuffer(f.read(), np.uint8)
    recs = raw.reshape(-1, 3073)
    return recs[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), recs[:, 0]


def load_cifar(train=True, num_examples=None):
    """(images [n, 32, 32, 3] float32 in [0, 1], labels [n] int64, class
    names or None); deterministic synthetic data when no copy is found."""
    d = _find_cifar_dir()
    if d is not None:
        files = [f"data_batch_{i}.bin" for i in range(1, 6)] if train \
            else ["test_batch.bin"]
        xs, ys = [], []
        for f in files:
            for suffix in ("", ".gz"):
                p = os.path.join(d, f + suffix)
                if os.path.exists(p):
                    x, y = _read_cifar_records(p)
                    xs.append(x)
                    ys.append(y)
                    break
        if xs:
            names = None
            meta = os.path.join(d, "batches.meta.txt")
            if os.path.exists(meta):
                with open(meta) as f:
                    names = [l.strip() for l in f if l.strip()]
            x = (np.concatenate(xs) / 255.0).astype(np.float32)
            y = np.concatenate(ys).astype(np.int64)
            if num_examples is not None:
                x, y = x[:num_examples], y[:num_examples]
            return x, y, names
    n = num_examples or 1000
    rng = np.random.default_rng(777 if train else 778)
    ys_i = np.tile(np.arange(10), n // 10 + 1)[:n]
    base = rng.normal(size=(10, 32, 32, 3))
    x = base[ys_i] * 0.4 + rng.normal(scale=0.3, size=(n, 32, 32, 3))
    x = ((x - x.min()) / (x.max() - x.min())).astype(np.float32)
    return x, ys_i.astype(np.int64), None


def real32_gate_accuracy(epochs=10, seed=3, quantized_delta=False,
                         device=None):
    """The real-photo 32x32 accuracy gate (bench.py's `real32_test_acc`):
    `zoo.cifar_convnet` trained on the committed cifar_real crops with
    horizontal-flip augmentation, `epochs` passes of batches of 64 in one
    seeded order, then scored on the held-out crops. Returns the accuracy
    (None when only synthetic data is found); with `quantized_delta`,
    (accuracy, int8 accuracy), the latter None until quantization is
    ported (the failure is printed to stderr). `device`: the card unless
    "cpu"."""
    from ...zoo.models import cifar_convnet

    if _find_cifar_dir() is None:
        return None  # synthetic fallback: an accuracy would be bogus
    x, y, _ = load_cifar(train=True)
    xa = np.concatenate([x, x[:, :, ::-1]])      # horizontal flips
    ya = np.concatenate([y, y])
    order = np.random.default_rng(seed).permutation(len(xa))
    xa = xa[order]
    yh = np.eye(10, dtype=np.float32)[ya[order]]
    sets = [DataSet(xa[i:i + 64], yh[i:i + 64])
            for i in range(0, len(xa), 64)]
    net = cifar_convnet(device=device)
    net.init()
    net.fit(ListDataSetIterator(sets), epochs=epochs)
    xt, yt, _ = load_cifar(train=False)
    pred = net.output(xt).argmax(-1).cpu().numpy()
    acc = float((pred == yt).mean())
    if not quantized_delta:
        return acc
    acc_q = None
    try:
        net.quantize_weights("int8")
        pred_q = net.output(xt).argmax(-1).cpu().numpy()
        acc_q = float((pred_q == yt).mean())
    except Exception as e:
        # loud: a silent None would also silence the int8 delta's guard
        print(f"real32 int8 eval failed: {type(e).__name__}: {e}",
              file=sys.stderr)
    return acc, acc_q


class CifarDataSetIterator(_ArrayIterator):
    """32x32x3 images, labels one-hot to 10 columns whatever classes the
    data uses; `labels` holds the class names when the source has a
    batches.meta.txt."""

    H = W = 32
    C = 3
    CLASSES = 10

    def __init__(self, batch_size=32, num_examples=None, train=True,
                 shuffle=False, seed=123):
        x, ys, self.labels = load_cifar(train, num_examples)
        if shuffle:
            idx = np.random.default_rng(seed).permutation(len(x))
            x, ys = x[idx], ys[idx]
        y = np.eye(self.CLASSES, dtype=np.float32)[ys]
        super().__init__(x, y, batch_size)


class LFWDataSetIterator(_ArrayIterator):
    """Labelled faces, synthetic: `num_labels` identities at
    `image_size`."""

    def __init__(self, batch_size=16, num_examples=64, image_size=(64, 64),
                 num_labels=8):
        h, w = image_size
        rng = np.random.default_rng(999)
        ys_i = np.tile(np.arange(num_labels),
                       num_examples // num_labels + 1)[:num_examples]
        base = rng.normal(size=(num_labels, h, w, 3))
        x = base[ys_i] * 0.5 + rng.normal(scale=0.25,
                                          size=(num_examples, h, w, 3))
        x = ((x - x.min()) / (x.max() - x.min())).astype(np.float32)
        y = np.eye(num_labels, dtype=np.float32)[ys_i]
        super().__init__(x, y, batch_size)


class CurvesDataSetIterator(_ArrayIterator):
    """The 'curves' autoencoder set: deterministic 28x28 sine-curve
    rasters, labels equal to the features."""

    def __init__(self, batch_size=32, num_examples=256, size=28):
        rng = np.random.default_rng(1234)
        xs = np.zeros((num_examples, size * size), np.float32)
        t = np.linspace(0, 1, size)
        for i in range(num_examples):
            amp = rng.uniform(0.2, 0.45)
            freq = rng.uniform(0.5, 3.0)
            phase = rng.uniform(0, 2 * np.pi)
            curve = 0.5 + amp * np.sin(2 * np.pi * freq * t + phase)
            img = np.zeros((size, size), np.float32)
            rows = np.clip((curve * size).astype(int), 0, size - 1)
            img[rows, np.arange(size)] = 1.0
            xs[i] = img.ravel()
        super().__init__(xs, xs.copy(), batch_size)
