"""Parameter exchange between the JAX package and the port.

The JAX package's ModelSerializer writes a model's parameters into
`coefficients.bin` as numpy arrays under flat keys "layer/param"
(`"embed/W"`, `"b0_attn/Wq"`, ...; util/model_serializer.py:32-57). The
port's parameter tree `{layer: {param: tensor}}` has the same names, so:

- `params_from_jax(flat, device)` turns such a flat dict into the port's
  tree on `device` (pass it to `ComputationGraph.init(params=...)`);
- `params_to_flat(net)` is its inverse;
- `synthetic_params(shapes, seed)` makes weights from a seed with numpy
  alone, so that a run with no JAX (the card machine) and the CPU tests
  build identical models.
"""
from __future__ import annotations

import math
import zlib

import numpy as np
import torch

from ..device import resolve_device


def params_from_jax(flat, device=None):
    """{"layer/param": array} -> {layer: {param: float tensor}} on
    `device` (the card unless "cpu")."""
    dev = resolve_device(device)
    tree = {}
    for key, arr in flat.items():
        layer, _, name = key.partition("/")
        if not name or "/" in name:
            raise ValueError(f"not a flat 'layer/param' key: {key!r}")
        tree.setdefault(layer, {})[name] = torch.from_numpy(
            np.array(arr)).to(dev)
    return tree


def params_to_flat(net):
    """The port model's parameters as {"layer/param": numpy array}, copies
    (training updates the tensors in place)."""
    return {f"{layer}/{name}": t.detach().cpu().numpy().copy()
            for layer, ps in net.params.items() for name, t in ps.items()}


def synthetic_params(shapes, seed=0):
    """Float32 weights for {"layer/param": shape}, from numpy's PCG64
    uniforms only (stable across numpy versions). Each tensor draws from
    its own stream, seeded by (seed, crc32 of its key): 2-D kernels are
    xavier-uniform, a LayerNorm "gamma" is 1 + U(-0.1, 0.1), every other
    vector U(-0.02, 0.02)."""
    out = {}
    for key, shape in shapes.items():
        shape = tuple(int(s) for s in shape)
        rng = np.random.default_rng([int(seed), zlib.crc32(key.encode())])
        u = rng.random(shape) * 2.0 - 1.0               # U(-1, 1), float64
        if len(shape) == 2:
            w = u * math.sqrt(6.0 / (shape[0] + shape[1]))
        elif key.rsplit("/", 1)[-1] == "gamma":
            w = 1.0 + 0.1 * u
        else:
            w = 0.02 * u
        out[key] = w.astype(np.float32)
    return out
