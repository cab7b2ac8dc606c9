"""ComputationGraph: DAG model, inference forward and generation
(counterpart of deeplearning4j_tpu/nn/graph/graph.py; `fit` arrives with
the training slice).

Vertices run in topological order on tensors of the model's device. The
parameters are `{layer name: {key: tensor}}`, the JAX package's tree, so
they cross between the packages by name (util/params.py)."""
from __future__ import annotations

import torch

from ...device import resolve_device
from ..conf.graph_configuration import ComputationGraphConfiguration
from ..layers import base as _base

_DTYPES = {"float32": torch.float32}


class ComputationGraph:
    def __init__(self, conf: ComputationGraphConfiguration, device=None):
        self.conf = conf
        self.order = conf.topo_sort()
        self.layers = {name: _base.create_layer(conf.vertices[name].layer_conf)
                       for name in self.order
                       if conf.vertices[name].kind == "layer"}
        if conf.dtype not in _DTYPES:
            raise NotImplementedError(f"dtype {conf.dtype!r} is not ported")
        if conf.compute_dtype not in (None, conf.dtype):
            raise NotImplementedError(
                "mixed-precision compute is not ported yet (ROADMAP queue 1)")
        self._dtype = _DTYPES[conf.dtype]
        self.device = resolve_device(device)
        self.params = None
        self._decode_engine = None

    # ------------------------------------------------------------------ init
    def param_shapes(self):
        """{"layer/key": shape} of every parameter, the flat keys the JAX
        package's serializer writes."""
        return {f"{name}/{key}": tuple(shape)
                for name, layer in self.layers.items()
                for key, (shape, _) in layer.param_specs().items()}

    def init(self, params=None, device=None):
        """Create the parameters on the model's device (or `device`).
        `params`: optional `{layer: {key: array}}` to load instead of the
        seeded init (numpy arrays or tensors, cast to the model dtype)."""
        if device is not None:
            self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator().manual_seed(int(self.conf.seed))
            self.params = {name: layer.init(gen, self._dtype, self.device)
                           for name, layer in self.layers.items()}
            return self
        loaded = {}
        for name, layer in self.layers.items():
            src = params[name]
            loaded[name] = {}
            for key, (shape, _) in layer.param_specs().items():
                t = torch.as_tensor(src[key]).to(self.device, self._dtype)
                if tuple(t.shape) != tuple(shape):
                    raise ValueError(f"{name}/{key}: shape {tuple(t.shape)}, "
                                     f"expected {tuple(shape)}")
                loaded[name][key] = t
        self.params = loaded
        self._decode_engine = None
        return self

    # -------------------------------------------------------------- forward
    def _forward(self, params, inputs, masks=None):
        """Activations of every vertex, masks flowing as in the JAX
        package (a vertex passes on its first input's mask)."""
        conf = self.conf
        acts, out_masks = {}, {}
        in_masks = masks or [None] * len(conf.network_inputs)
        for name, x, m in zip(conf.network_inputs, inputs, in_masks):
            acts[name] = x
            out_masks[name] = m
        for name in self.order:
            spec = conf.vertices[name]
            if spec.kind == "input":
                continue
            xs = [acts[i] for i in spec.inputs]
            ms = [out_masks.get(i) for i in spec.inputs]
            if spec.kind == "layer":
                acts[name], out_masks[name] = self.layers[name].forward(
                    params[name], xs[0], mask=ms[0])
            else:
                acts[name] = spec.vertex_conf.apply(xs)
                out_masks[name] = next((m for m in ms if m is not None), None)
        return acts

    def output(self, *inputs, mask=None):
        """Inference forward. `mask` is a [batch, time] validity mask for
        the first network input. Returns the output tensor (a list for
        several outputs) on the model's device."""
        if self.params is None:
            self.init()
        with torch.inference_mode():
            xs = [torch.as_tensor(x).to(self.device, self._dtype)
                  for x in inputs]
            masks = None
            if mask is not None:
                masks = [torch.as_tensor(mask).to(self.device, self._dtype)]
                masks += [None] * (len(xs) - 1)
            acts = self._forward(self.params, xs, masks)
            outs = [acts[o] for o in self.conf.network_outputs]
        return outs[0] if len(outs) == 1 else outs

    # ------------------------------------------------------------- generate
    def generate(self, prompt_ids, max_new_tokens=20, stop_id=None,
                 max_len=None, sampler=None):
        """KV-cache autoregressive decode through decode.DecodeEngine (one
        slot): greedy by default, token-for-token what re-running `output`
        on the growing sequence gives. The engine is cached on the model;
        `max_len` sizes its cache (default: prompt + new tokens, rounded
        up to a power of two)."""
        from ...decode.engine import DecodeEngine, bucket_for_len
        n = len(list(prompt_ids))
        need = n + int(max_new_tokens) + 1
        eng = self._decode_engine
        if eng is None or eng.capacity < need:
            cap = int(max_len) if max_len is not None \
                else bucket_for_len(need, 1 << 30)
            eng = self._decode_engine = DecodeEngine(self, slots=1,
                                                     max_len=cap)
        return eng.generate(prompt_ids, max_new_tokens, stop_id=stop_id,
                            sampler=sampler)
