"""ComputationGraph: DAG model, inference forward, training and generation
(counterpart of deeplearning4j_tpu/nn/graph/graph.py).

Vertices run in topological order on tensors of the model's device. The
parameters are `{layer name: {key: tensor}}`, the JAX package's tree, so
they cross between the packages by name (util/params.py).

Training: `fit` takes one optimizer step per minibatch. The JAX package
jits `value_and_grad` of `_loss` plus the optax update into one
executable; here the step runs eagerly: the loss on leaf copies of the
parameters (`detach`, sharing storage), `torch.autograd.grad` for the
gradients (attention's backward in the hand-written kernels when
`use_pallas=True`), gradient normalization, then the per-layer optimizer
updates the parameters IN PLACE. A cached decode engine reads the
parameters live, so `generate` after `fit` sees the trained weights.

Mixed precision (`compute_dtype="bfloat16"`, JAX graph.py:169-191): the
parameters stay float32 masters. The loss and `output` cast every
non-output layer's parameters and the float inputs to bf16 with `.to()`,
which autograd differentiates, so the gradients reach the masters in
float32 and the optimizer state stays float32. Network output layers keep
float32 parameters, and the features fed to their score are cast back to
float32: the loss runs in full precision. Masks are not cast, so where a
float32 mask multiplies a bf16 activation the result is float32 from
there on, as in JAX (`base.matmul` promotes as JAX does). The decode
engine serves the float32 masters, as the JAX engine does."""
from __future__ import annotations

import torch

from ...datasets.dataset import DataSet, MultiDataSet
from ...device import resolve_device
from ..conf.graph_configuration import ComputationGraphConfiguration
from ..layers import base as _base
from ..updaters import (PerLayerOptimizer, apply_gradient_normalization,
                        layer_transform)

_DTYPES = {"float32": torch.float32}
_COMPUTE_DTYPES = {"bfloat16": torch.bfloat16}


class ComputationGraph:
    def __init__(self, conf: ComputationGraphConfiguration, device=None):
        self.conf = conf
        self.order = conf.topo_sort()
        self.layers = {name: _base.create_layer(conf.vertices[name].layer_conf)
                       for name in self.order
                       if conf.vertices[name].kind == "layer"}
        if conf.dtype not in _DTYPES:
            raise NotImplementedError(f"dtype {conf.dtype!r} is not ported")
        if conf.compute_dtype not in (None, conf.dtype, *_COMPUTE_DTYPES):
            raise NotImplementedError(
                f"compute_dtype {conf.compute_dtype!r} is not ported; the "
                f"port computes in {sorted(_COMPUTE_DTYPES)} or the model "
                "dtype")
        self._dtype = _DTYPES[conf.dtype]
        self.device = resolve_device(device)
        self.params = None
        self._optimizer = None
        self._decode_engine = None
        self.iteration_count = 0
        self.epoch_count = 0
        self._score = float("nan")
        # output vertices no other vertex reads: the loss replaces their
        # forward with their score
        consumed = {i for s in conf.vertices.values() for i in s.inputs}
        self._loss_only = set(conf.network_outputs) - consumed

    @property
    def score_value(self):
        """Most recent minibatch score; kept on the device by `fit_batch`
        and read back on first access."""
        if not isinstance(self._score, float):
            self._score = float(self._score)
        return self._score

    # ------------------------------------------------------------------ init
    def param_shapes(self):
        """{"layer/key": shape} of every parameter, the flat keys the JAX
        package's serializer writes."""
        return {f"{name}/{key}": tuple(shape)
                for name, layer in self.layers.items()
                for key, (shape, _) in layer.param_specs().items()}

    def init(self, params=None, device=None):
        """Create the parameters on the model's device (or `device`) and
        the per-layer optimizer state. `params`: optional `{layer: {key:
        array}}` to load instead of the seeded init (numpy arrays or
        tensors, copied and cast to the model dtype)."""
        if device is not None:
            self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator().manual_seed(int(self.conf.seed))
            self.params = {name: layer.init(gen, self._dtype, self.device)
                           for name, layer in self.layers.items()}
        else:
            loaded = {}
            for name, layer in self.layers.items():
                src = params[name]
                loaded[name] = {}
                for key, (shape, _) in layer.param_specs().items():
                    # a copy: training updates the parameters in place
                    t = torch.as_tensor(src[key]).to(self.device, self._dtype,
                                                     copy=True)
                    if tuple(t.shape) != tuple(shape):
                        raise ValueError(f"{name}/{key}: shape "
                                         f"{tuple(t.shape)}, expected "
                                         f"{tuple(shape)}")
                    loaded[name][key] = t
            self.params = loaded
        self._build_updater()
        self._decode_engine = None
        return self

    def _build_updater(self):
        updaters = {name: layer_transform(self.conf.vertices[name].layer_conf)
                    for name in self.params}
        self._optimizer = PerLayerOptimizer(updaters, self.params)

    # -------------------------------------------------------------- forward
    def _forward(self, params, inputs, masks=None, *, train=False,
                 skip=()):
        """(activations, masks) of every vertex but those in `skip`, masks
        flowing as in the JAX package (a vertex passes on its first
        input's mask)."""
        conf = self.conf
        acts, out_masks = {}, {}
        in_masks = masks or [None] * len(conf.network_inputs)
        for name, x, m in zip(conf.network_inputs, inputs, in_masks):
            acts[name] = x
            out_masks[name] = m
        for name in self.order:
            spec = conf.vertices[name]
            if spec.kind == "input" or name in skip:
                continue
            xs = [acts[i] for i in spec.inputs]
            ms = [out_masks.get(i) for i in spec.inputs]
            if spec.kind == "layer":
                acts[name], out_masks[name] = self.layers[name].forward(
                    params[name], xs[0], train=train, mask=ms[0])
            else:
                acts[name] = spec.vertex_conf.apply(xs)
                out_masks[name] = next((m for m in ms if m is not None), None)
        return acts, out_masks

    def _to_model(self, x):
        """A tensor on the model's device in the model dtype."""
        return torch.as_tensor(x).to(self.device, self._dtype)

    def _to_models(self, arrs):
        """`_to_model` over a list (None entries and None kept)."""
        return None if arrs is None else \
            [None if a is None else self._to_model(a) for a in arrs]

    def output(self, *inputs, mask=None):
        """Inference forward (in the compute dtype, if one is set). `mask`
        is a [batch, time] validity mask for the first network input.
        Returns the output tensor (a list for several outputs) on the
        model's device, in the model dtype."""
        if self.params is None:
            self.init()
        with torch.inference_mode():
            params, xs = self._cast_for_compute(
                self.params, [self._to_model(x) for x in inputs])
            masks = None
            if mask is not None:
                masks = [self._to_model(mask)] + [None] * (len(xs) - 1)
            acts, _ = self._forward(params, xs, masks)
            outs = [acts[o].to(self._dtype)
                    for o in self.conf.network_outputs]
        return outs[0] if len(outs) == 1 else outs

    # ------------------------------------------------------- mixed precision
    def _compute_dtype(self):
        """The compute dtype when it differs from the model dtype, else
        None."""
        cd = self.conf.compute_dtype
        return None if cd in (None, self.conf.dtype) else _COMPUTE_DTYPES[cd]

    def _cast_for_compute(self, params, inputs):
        """bf16 compute for all non-output layers: their parameters and the
        float (and uint8) inputs cast with `.to()`; network output layers
        keep the parameter dtype so their loss runs in full precision (JAX
        graph.py:175-191). Integer inputs are not cast."""
        cd = self._compute_dtype()
        if cd is None:
            return params, inputs
        outs = set(self.conf.network_outputs)

        def cast(a):
            if isinstance(a, torch.Tensor) and (a.is_floating_point()
                                                or a.dtype == torch.uint8):
                return a.to(cd)
            return a
        params = {name: (ps if name in outs
                         else {k: cast(v) for k, v in ps.items()})
                  for name, ps in params.items()}
        return params, [cast(x) for x in inputs]

    # ---------------------------------------------------------------- loss
    def _loss(self, params, inputs, labels, *, train, masks=None,
              label_masks=None):
        """Scalar score: every output layer's loss on the features feeding
        it (its forward is replaced by its score), plus l1/l2. Under a
        compute dtype the forward runs on the cast parameters and the
        features reach the loss in the model dtype."""
        conf = self.conf
        params, inputs = self._cast_for_compute(params, inputs)
        acts, out_masks = self._forward(params, inputs, masks, train=train,
                                        skip=self._loss_only)
        total = 0.0
        lm = label_masks or [None] * len(conf.network_outputs)
        for out_name, y, mlab in zip(conf.network_outputs, labels, lm):
            spec = conf.vertices[out_name]
            layer = self.layers[out_name]
            if not layer.is_output_layer():
                raise ValueError(f"Network output '{out_name}' is not an "
                                 "output layer")
            feats = acts[spec.inputs[0]]
            if self._compute_dtype() is not None:
                feats = feats.to(self._dtype)   # loss in full precision
            mask = mlab if mlab is not None else out_masks.get(spec.inputs[0])
            total = total + layer.score(params[out_name], feats, y, mask,
                                        train)
        return total + self._reg_score(params)

    def _reg_score(self, params):
        total = 0.0
        for name, p in params.items():
            lc = self.conf.vertices[name].layer_conf
            l1, l2 = lc.l1 or 0.0, lc.l2 or 0.0
            l1b, l2b = lc.l1_bias or 0.0, lc.l2_bias or 0.0
            if not (l1 or l2 or l1b or l2b):
                continue
            for k, v in p.items():
                is_w = not (k.endswith("b") or k in ("gamma", "beta"))
                a, b = (l1, l2) if is_w else (l1b, l2b)
                if a:
                    total = total + a * torch.sum(torch.abs(v))
                if b:
                    total = total + 0.5 * b * torch.sum(v * v)
        return total

    def _normalize_grads(self, grads):
        out = {}
        for name, g in grads.items():
            lc = self.conf.vertices[name].layer_conf
            if lc.gradient_normalization and g:
                g = apply_gradient_normalization(
                    g, lc.gradient_normalization,
                    lc.gradient_normalization_threshold or 1.0)
            out[name] = g
        return out

    def _value_and_grad(self, inputs, labels, masks, label_masks, *, train):
        """(score tensor, grads {layer: {key: tensor}}) at the current
        parameters."""
        leaves = {name: {k: t.detach().requires_grad_()
                         for k, t in ps.items()}
                  for name, ps in self.params.items()}
        flat = [t for ps in leaves.values() for t in ps.values()]
        with torch.enable_grad():
            score = self._loss(leaves, inputs, labels, train=train,
                               masks=masks, label_masks=label_masks)
            gs = iter(torch.autograd.grad(score, flat, allow_unused=True))
        grads = {}
        for name, ps in leaves.items():
            grads[name] = {}
            for k, t in ps.items():
                g = next(gs)
                grads[name][k] = torch.zeros_like(t) if g is None else g
        return score.detach(), grads

    # ---------------------------------------------------------------- train
    def fit(self, data, labels=None, epochs=1, steps_per_execution=1,
            prefetch=None, ingest=None):
        """Train on `data`: a DataSet, a MultiDataSet, a list of them, or
        features with `labels` — one optimizer step per minibatch, `epochs`
        times over."""
        if int(steps_per_execution) > 1:
            raise NotImplementedError(
                "steps_per_execution > 1 is not ported yet (ROADMAP queue 1: "
                "K-step loop, remat)")
        if prefetch:
            raise NotImplementedError(
                "prefetch is not ported yet (ROADMAP queue 1: persistence, "
                "data)")
        if ingest is not None:
            raise NotImplementedError(
                "device-side ingest is not ported yet (ROADMAP queue 1: "
                "persistence, data)")
        if labels is not None:
            data = MultiDataSet(data, labels)
        items = [data] if isinstance(data, (DataSet, MultiDataSet)) \
            else data
        for _ in range(int(epochs)):
            for ds in items:
                self.fit_batch(ds)
            self.epoch_count += 1
        return self

    def _check_trainable(self):
        conf = self.conf
        if conf.optimization_algo != "sgd":
            raise NotImplementedError(
                f"optimization_algo {conf.optimization_algo!r}: the flat "
                "solvers are not ported yet (ROADMAP queue 1: nn core)")
        if conf.backprop_type != "standard":
            raise NotImplementedError(
                "truncated BPTT is not ported yet (ROADMAP queue 1: "
                "recurrent, char-RNN)")
        if conf.remat is not None:
            raise NotImplementedError(
                "remat is not ported yet (ROADMAP queue 1: K-step loop, "
                "remat)")

    def _prep_batch(self, ds):
        """(inputs, labels, masks, label masks) lists of tensors on the
        model's device."""
        if isinstance(ds, DataSet):
            ds = MultiDataSet(
                [ds.features], [ds.labels],
                None if ds.features_mask is None else [ds.features_mask],
                None if ds.labels_mask is None else [ds.labels_mask])
        return (self._to_models(ds.features), self._to_models(ds.labels),
                self._to_models(ds.features_masks),
                self._to_models(ds.labels_masks))

    def fit_batch(self, ds):
        """One optimizer step on one DataSet / MultiDataSet."""
        if self.params is None:
            self.init()
        self._check_trainable()
        inputs, labels, masks, lmasks = self._prep_batch(ds)
        score, grads = self._value_and_grad(inputs, labels, masks, lmasks,
                                            train=True)
        self._optimizer.step(self._normalize_grads(grads))
        self._score = score
        self.iteration_count += 1

    def score(self, ds):
        """The loss on one DataSet / MultiDataSet at inference (no
        dropout), as a float. Masks are not applied, as in the JAX
        package's `score`."""
        if isinstance(ds, DataSet):
            ds = MultiDataSet([ds.features], [ds.labels])
        with torch.no_grad():
            s = self._loss(self.params, self._to_models(ds.features),
                           self._to_models(ds.labels), train=False)
        return float(s)

    def compute_gradient_and_score(self, inputs, labels, masks=None,
                                   label_masks=None):
        """(grads {layer: {key: tensor}}, score float) of the loss at
        inference (no dropout). `inputs`/`labels`: an array or a list of
        them; masks: lists aligned with the inputs / outputs."""
        listed = lambda a: list(a) if isinstance(a, (list, tuple)) else [a]
        score, grads = self._value_and_grad(
            self._to_models(listed(inputs)), self._to_models(listed(labels)),
            self._to_models(masks), self._to_models(label_masks),
            train=False)
        return grads, float(score)

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
