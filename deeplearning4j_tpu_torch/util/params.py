"""Parameter and layer-state exchange between the JAX package and the port.

The JAX package's ModelSerializer writes a model's parameters into
`coefficients.bin` as numpy arrays under flat keys "layer/param"
(`"embed/W"`, `"b0_attn/Wq"`, ...; util/model_serializer.py:32-57). The
port's parameter tree `{layer: {param: tensor}}` has the same names, and
so has its layer-state tree (`net.states`: batch norm's `"mean"` and
`"var"` by layer name, as in the JAX package's `net.states`), so:

- `params_from_jax(tree, device)` turns such a flat dict, or a nested
  `{layer: {key: array}}` tree such as the JAX `net.states`, into the
  port's tree on `device` (pass it to `init(params=..., states=...)` of
  a ComputationGraph or a MultiLayerNetwork). One more level of nesting
  is taken: GravesBidirectionalLSTM's parameters are `{"fwd": {...},
  "bwd": {...}}` in the JAX package, flattened by its serializer to
  `"3/fwd/W"`; the port keeps them as keys "fwd/W" of the layer's dict;
- `params_to_flat(net)` and `states_to_flat(net)` are its inverse (a
  nested key comes back as "3/fwd/W");
- `synthetic_params(shapes, seed)` and `synthetic_states(shapes, seed)`
  make weights and running statistics from a seed with numpy alone, so
  that a run with no JAX (the card machine) and the CPU tests build
  identical models;
- `embeddings_from_jax(tables, device)` carries the embedding models'
  tables across: the lookup table's syn0 / syn1 / syn1neg (with
  ParagraphVectors' label rows), GloVe's W / Wc / b / bc and their
  AdaGrad accumulators, DeepWalk's syn0 / syn1. Every model of the
  port's `nlp` and `graphlib` takes the dict as `initial_tables`.
"""
from __future__ import annotations

import math
import zlib
from collections.abc import Mapping

import numpy as np
import torch

from ..device import resolve_device


def params_from_jax(tree, device=None):
    """{"layer/key": array} or {layer: {key: array}} -> {layer: {key: float
    tensor}} on `device` (the card unless "cpu"); a key may nest once
    ("layer/sub/key", or {layer: {sub: {key: array}}}), which becomes the
    layer's key "sub/key". A layer with an empty dict (a stateless layer
    of the JAX `net.states`) keeps its empty dict."""
    dev = resolve_device(device)
    tensor = lambda a: torch.from_numpy(np.array(a)).to(dev)
    out = {}
    for key, arr in tree.items():
        if isinstance(arr, Mapping):
            out[key] = {}
            for name, a in arr.items():
                if isinstance(a, Mapping):
                    out[key].update({f"{name}/{k}": tensor(v)
                                     for k, v in a.items()})
                else:
                    out[key][name] = tensor(a)
            continue
        layer, _, name = key.partition("/")
        if not name or name.count("/") > 1 or "" in name.split("/"):
            raise ValueError(f"not a 'layer/param' or 'layer/sub/param' "
                             f"key: {key!r}")
        out.setdefault(layer, {})[name] = tensor(arr)
    return out


def _to_flat(tree):
    return {f"{layer}/{name}": t.detach().cpu().numpy().copy()
            for layer, ts in tree.items() for name, t in ts.items()}


def params_to_flat(net):
    """The port model's parameters as {"layer/param": numpy array}, copies
    (training updates the tensors in place)."""
    return _to_flat(net.params)


def states_to_flat(net):
    """The port model's layer states as {"layer/key": numpy array}."""
    return _to_flat(net.states)


def _uniform(key, shape, seed):
    """U(-1, 1) float64 of `shape` from the stream (seed, crc32 of key)."""
    rng = np.random.default_rng([int(seed), zlib.crc32(key.encode())])
    return rng.random(shape) * 2.0 - 1.0


def synthetic_params(shapes, seed=0):
    """Float32 weights for {"layer/param": shape} (a model's
    `param_shapes()`, nested keys "layer/sub/param" included), from
    numpy's PCG64
    uniforms only (stable across numpy versions). Each tensor draws from
    its own stream, seeded by (seed, crc32 of its key): 2-D kernels are
    xavier-uniform, 4-D HWIO convolution kernels He-uniform (U(-a, a), a =
    sqrt(6 / (kh·kw·I))), a "gamma" is 1 + U(-0.1, 0.1), every other
    vector U(-0.02, 0.02)."""
    out = {}
    for key, shape in shapes.items():
        shape = tuple(int(s) for s in shape)
        u = _uniform(key, shape, seed)
        if len(shape) == 2:
            w = u * math.sqrt(6.0 / (shape[0] + shape[1]))
        elif len(shape) == 4:
            w = u * math.sqrt(6.0 / (shape[0] * shape[1] * shape[2]))
        elif key.rsplit("/", 1)[-1] == "gamma":
            w = 1.0 + 0.1 * u
        else:
            w = 0.02 * u
        out[key] = w.astype(np.float32)
    return out


def synthetic_states(shapes, seed=0):
    """Float32 running statistics for {"layer/key": shape} (a model's
    `state_shapes()`), from the same per-key streams as
    `synthetic_params`: a "var" is 1 + U(-0.1, 0.1), a "mean" (and any
    other state) U(-0.02, 0.02)."""
    out = {}
    for key, shape in shapes.items():
        u = _uniform(key, tuple(int(s) for s in shape), seed)
        w = 1.0 + 0.1 * u if key.rsplit("/", 1)[-1] == "var" else 0.02 * u
        out[key] = w.astype(np.float32)
    return out


EMBEDDING_TABLES = ("syn0", "syn1", "syn1neg", "labels",
                    "W", "Wc", "b", "bc", "hW", "hWc", "hb", "hbc")


def embeddings_from_jax(tables, device=None):
    """{name: numpy array} of an embedding model of the JAX package ->
    {name: tensor} on `device` (the card unless "cpu"), each in its
    array's own dtype. Names: "syn0", "syn1", "syn1neg" (an
    InMemoryLookupTable's, or DeepWalk's syn0 / syn1), "labels"
    (ParagraphVectors' label rows, which the JAX package keeps in syn0
    after the vocab rows: given apart, they are appended to "syn0"), and
    GloVe's "W", "Wc", "b", "bc", "hW", "hWc", "hb", "hbc"."""
    dev = resolve_device(device)
    bad = sorted(set(tables) - set(EMBEDDING_TABLES))
    if bad:
        raise ValueError(f"not an embedding table: {bad}")
    arrays = {k: np.array(v) for k, v in tables.items()}
    if "labels" in arrays:
        arrays["syn0"] = np.concatenate([arrays["syn0"],
                                         arrays.pop("labels")])
    return {k: torch.from_numpy(a).to(dev) for k, a in arrays.items()}
