"""Durable single-file publish (the port's copy of the part of
deeplearning4j_tpu/util/fs.py:74-130 the model serializer uses).

`os.replace` alone is atomic in the namespace but not durable: the file's
data must be fsync'd before the rename and the parent directory after it,
or a crash can publish a name that points at a torn file. `atomic_write`
does both. The manifest and quarantine helpers of the JAX module, and its
fault-injection seam, come with their users."""
from __future__ import annotations

import os
import tempfile


def fsync_file(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path):
    """fsync a directory: makes its entries (renames, creates) durable."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_bytes(path, data, fsync=True):
    """Write `data` (bytes or str) to `path`, then flush and fsync. Not
    atomic: to publish an artifact use `atomic_write`."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    path = os.fspath(path)
    with open(path, "wb") as f:
        f.write(data)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    return path


def atomic_write(path, data, fsync=True):
    """Durably publish `data` at `path`: a temp file in the same directory,
    fsync, `os.replace`, fsync of the parent directory. A reader sees the
    old content or the new, never a mix."""
    path = os.fspath(path)
    parent = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".",
                               suffix=".tmp", dir=parent)
    os.close(fd)
    try:
        write_bytes(tmp, data, fsync=fsync)
        os.replace(tmp, path)
        if fsync:
            fsync_dir(parent)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path
