"""Model checkpointing: the JAX package's zip, read and written by the port
(counterpart of deeplearning4j_tpu/util/model_serializer.py).

Entries, as the JAX package writes them:

- `format.json`: model class, dtype, framework, version;
- `configuration.json`: the config's `to_json()` (the same text for the
  same builder calls in both packages);
- `coefficients.bin`: an .npz of the parameters under flat keys
  "layer/param" ("/" spelled `__SLASH__`: an npz key cannot hold it);
- `state.bin`: the layer states (batch norm's running statistics) the
  same way, written whenever the model has layers (the JAX rule
  `if model.states:`);
- `updaterState.bin`: the optimizer state as `leaf0`, `leaf1`, ... in the
  order of `jax.tree_util.tree_leaves` of the optax state
  (nn/updaters.py `opt_state_leaves`);
- `normalizer.json`: a fitted etl normalizer's `to_json()`, when one was
  written with the model (`write_model(normalizer=)`, `add_normalizer`;
  read back by `restore_normalizer`, and by the serving registry, which
  applies it on /predict).

Every entry carries the fixed 1980-01-01 timestamp, so the same state
writes the same entries; `np.savez` stamps its inner members itself, so
two zips compare by entry names, configuration text and arrays, not by
bytes. A key the zip lacks keeps the value the model was initialized
with; optimizer state of another shape is skipped, as in the JAX package.

Refused: a dtype other than float32.
"""
from __future__ import annotations

import io
import json
import zipfile

import numpy as np
import torch

CONFIG_ENTRY = "configuration.json"
COEFFICIENTS_ENTRY = "coefficients.bin"
UPDATER_ENTRY = "updaterState.bin"
FORMAT_ENTRY = "format.json"
STATE_ENTRY = "state.bin"
NORMALIZER_ENTRY = "normalizer.json"


def _flatten_tree(tree, prefix=""):
    """{"layer/key": numpy array} of a {layer: {key: tensor}} tree, keys in
    sorted order at every level."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten_tree(tree[k], f"{prefix}{k}/"))
    elif tree is not None:
        out[prefix[:-1]] = (tree.detach().cpu().numpy()
                            if isinstance(tree, torch.Tensor)
                            else np.asarray(tree))
    return out


def _tree_to_npz_bytes(tree):
    buf = io.BytesIO()
    np.savez(buf, **{k.replace("/", "__SLASH__"): v
                     for k, v in _flatten_tree(tree).items()})
    return buf.getvalue()


def _npz_bytes_to_flat(data):
    npz = np.load(io.BytesIO(data))
    return {k.replace("__SLASH__", "/"): npz[k] for k in npz.files}


def _writestr(zf, name, data):
    """A zip entry with a fixed DOS timestamp and 0600 permissions."""
    info = zipfile.ZipInfo(name, date_time=(1980, 1, 1, 0, 0, 0))
    info.compress_type = zipfile.ZIP_DEFLATED
    info.external_attr = 0o600 << 16
    zf.writestr(info, data)


def _load_into(tree, flat):
    """Copy `flat`'s arrays into the matching tensors of `tree`, in place
    (the optimizer holds these tensors); a key `flat` lacks keeps its
    value."""
    with torch.no_grad():
        for layer, ps in tree.items():
            for key, t in ps.items():
                a = flat.get(f"{layer}/{key}")
                if a is None:
                    continue
                if tuple(a.shape) != tuple(t.shape):
                    raise ValueError(f"{layer}/{key}: shape {a.shape} in the "
                                     f"zip, {tuple(t.shape)} in the model")
                t.copy_(torch.from_numpy(np.asarray(a)))


def _check_readable(zf):
    if FORMAT_ENTRY in zf.namelist():
        dtype = json.loads(zf.read(FORMAT_ENTRY).decode()).get("dtype")
        if dtype not in (None, "float32"):
            raise NotImplementedError(
                f"dtype {dtype!r} is not ported yet (ROADMAP queue 1 item 6: "
                "nn core); the port takes float32")


class ModelSerializer:
    @staticmethod
    def write_model(model, path, save_updater=True, normalizer=None):
        """Write `model` (a MultiLayerNetwork or a ComputationGraph) to
        `path`, a filesystem path published durably (util.fs.atomic_write)
        or a file object written directly; `normalizer`, a fitted etl
        normalizer, rides along as `normalizer.json`."""
        from ..nn.graph.graph import ComputationGraph
        from ..nn.updaters import opt_state_leaves
        target = path if hasattr(path, "write") else io.BytesIO()
        with zipfile.ZipFile(target, "w", zipfile.ZIP_DEFLATED) as zf:
            _writestr(zf, FORMAT_ENTRY, json.dumps({
                "model_class": ("ComputationGraph"
                                if isinstance(model, ComputationGraph)
                                else "MultiLayerNetwork"),
                "dtype": str(model.conf.dtype),
                "framework": "deeplearning4j-tpu",
                "version": 1,
            }))
            _writestr(zf, CONFIG_ENTRY, model.conf.to_json())
            _writestr(zf, COEFFICIENTS_ENTRY,
                      _tree_to_npz_bytes(model.params))
            if model.states:
                _writestr(zf, STATE_ENTRY, _tree_to_npz_bytes(model.states))
            if save_updater and model._optimizer is not None:
                buf = io.BytesIO()
                np.savez(buf, **{f"leaf{i}": a for i, a in
                                 enumerate(opt_state_leaves(model))})
                _writestr(zf, UPDATER_ENTRY, buf.getvalue())
            if normalizer is not None:
                _writestr(zf, NORMALIZER_ENTRY, normalizer.to_json())
        if target is not path:
            from .fs import atomic_write
            atomic_write(path, target.getvalue())
        return path

    @staticmethod
    def add_normalizer(path, normalizer):
        """Add or replace the normalizer entry of a zip: the archive is
        rebuilt in memory and published through util.fs.atomic_write (a
        zip opened for append would hold the entry twice)."""
        from .fs import atomic_write
        with zipfile.ZipFile(path, "r") as zf:
            entries = [(n, zf.read(n)) for n in zf.namelist()
                       if n != NORMALIZER_ENTRY]
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
            for n, data in entries:
                _writestr(zf, n, data)
            _writestr(zf, NORMALIZER_ENTRY, normalizer.to_json())
        atomic_write(path, buf.getvalue())
        return path

    @staticmethod
    def restore_normalizer(path):
        """The zip's fitted normalizer, or None when it has none."""
        from ..etl.normalizer import DataNormalizer
        with zipfile.ZipFile(path, "r") as zf:
            if NORMALIZER_ENTRY not in zf.namelist():
                return None
            return DataNormalizer.from_json(
                zf.read(NORMALIZER_ENTRY).decode())

    @staticmethod
    def restore_multi_layer_network(path, load_updater=True, device=None):
        """The MultiLayerNetwork of a zip, on the card unless `device` is
        "cpu"."""
        from ..nn.conf.configuration import MultiLayerConfiguration
        from ..nn.multilayer.network import MultiLayerNetwork
        with zipfile.ZipFile(path, "r") as zf:
            _check_readable(zf)
            conf = MultiLayerConfiguration.from_json(
                zf.read(CONFIG_ENTRY).decode())
            net = MultiLayerNetwork(conf, device=device).init()
            ModelSerializer._restore_into(net, zf, load_updater)
        return net

    @staticmethod
    def restore_computation_graph(path, load_updater=True, device=None):
        """The ComputationGraph of a zip, on the card unless `device` is
        "cpu"."""
        from ..nn.conf.graph_configuration import \
            ComputationGraphConfiguration
        from ..nn.graph.graph import ComputationGraph
        with zipfile.ZipFile(path, "r") as zf:
            _check_readable(zf)
            conf = ComputationGraphConfiguration.from_json(
                zf.read(CONFIG_ENTRY).decode())
            net = ComputationGraph(conf, device=device).init()
            ModelSerializer._restore_into(net, zf, load_updater)
        return net

    @staticmethod
    def _restore_into(net, zf, load_updater):
        from ..nn.updaters import load_opt_state_leaves
        _load_into(net.params,
                   _npz_bytes_to_flat(zf.read(COEFFICIENTS_ENTRY)))
        names = set(zf.namelist())
        if STATE_ENTRY in names:
            _load_into(net.states,
                       _npz_bytes_to_flat(zf.read(STATE_ENTRY)))
        if load_updater and UPDATER_ENTRY in names:
            npz = np.load(io.BytesIO(zf.read(UPDATER_ENTRY)))
            load_opt_state_leaves(net, [npz[f"leaf{i}"]
                                        for i in range(len(npz.files))])

    @staticmethod
    def read_format(path):
        """The zip's format.json (model class, dtype, version) without
        reading any weights."""
        with zipfile.ZipFile(path, "r") as zf:
            if FORMAT_ENTRY in zf.namelist():
                return json.loads(zf.read(FORMAT_ENTRY).decode())
            return {"model_class": None, "framework": "unknown"}

    @staticmethod
    def restore(path, load_updater=True, device=None):
        """Sniff the model type (format.json, else the configuration's
        format string) and restore it."""
        with zipfile.ZipFile(path, "r") as zf:
            if FORMAT_ENTRY in zf.namelist():
                cls = json.loads(zf.read(FORMAT_ENTRY).decode()).get(
                    "model_class")
            else:
                cfg = json.loads(zf.read(CONFIG_ENTRY).decode())
                cls = ("ComputationGraph"
                       if "ComputationGraph" in cfg.get("format", "")
                       else "MultiLayerNetwork")
        if cls == "ComputationGraph":
            return ModelSerializer.restore_computation_graph(
                path, load_updater, device)
        return ModelSerializer.restore_multi_layer_network(
            path, load_updater, device)


class ModelGuesser:
    @staticmethod
    def load_model_guess(path, device=None):
        return ModelSerializer.restore(path, device=device)
