"""Device meshes (counterpart of deeplearning4j_tpu/parallel/sharding.py:
30-45).

A JAX `Mesh` is an array of devices held by one process, with named axes;
`shard_map` runs a per-shard body on each. The port's `Mesh` is the same
thing for torch: an object array of `torch.device`s shaped
`(n_data, n_model, n_seq)` and the axis names, which the port's
sequence-parallel ring (`parallel/ring_attention.py`) walks in one
process, moving each shard to its device with `.to()`.

A device may repeat. An n-shard ring then runs its n shards on one card
(`devices=[torch.device("cuda:0")] * n`), and the CPU tests run it on
`[torch.device("cpu")] * n`; moving a shard to the device it is on is no
copy. `ShardingRules` and the sharded train step come with the
process-group work (ROADMAP queue 1, parallel + elastic).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"


class Mesh:
    """Devices on named axes. `devices` is an object array of
    `torch.device`s, `axis_names` names its axes, and `shape[axis]` is the
    axis's size, as JAX's `mesh.shape` gives it."""

    def __init__(self, devices, axis_names):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d devices for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    def axis_devices(self, axis_name):
        """The devices along `axis_name`, at index 0 of every other axis."""
        index = [0] * self.devices.ndim
        index[self.axis_names.index(axis_name)] = slice(None)
        return list(self.devices[tuple(index)])


def make_mesh(n_data=None, n_model=1, n_seq=1, devices=None):
    """A Mesh with (data, model, seq) axes over `devices` (default: every
    visible CUDA device; with none visible this raises, it never falls
    back to the CPU). `n_data` defaults to what the other two leave. A
    device may appear more than once (the module docstring)."""
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n_total = len(devices)
    if n_data is None:
        n_data = n_total // (n_model * n_seq)
    if n_data * n_model * n_seq != n_total:
        raise ValueError(f"mesh {n_data}x{n_model}x{n_seq} != {n_total} "
                         "devices")
    arr = np.empty(n_total, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(n_data, n_model, n_seq),
                (DATA_AXIS, MODEL_AXIS, SEQ_AXIS))
