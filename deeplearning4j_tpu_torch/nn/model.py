"""What the port's two models share (ComputationGraph and
MultiLayerNetwork): parameters and layer states by layer name on the
model's device, the per-layer optimizers, mixed precision, one training
step's gradients and update, `fit` / `fit_batch` with their listeners and
the flat solvers, `evaluate`, `clone` and `generate`.

A model keeps `self.layer_confs` and `self.named_layers`, {layer name:
conf} and {layer name: layer}, the names its parameter tree uses (a
graph's vertex names; a MultiLayerNetwork's "0", "1", ...). The
parameters are `{layer: {key: tensor}}`, the JAX package's tree, and so
is the layer state (`states`: batch norm's running mean and variance; an
empty dict for a stateless layer), so both cross between the packages by
name (util/params.py).

A training step runs eagerly (the JAX package jits `value_and_grad` of
its loss plus the optax update into one executable): the loss on leaf
copies of the parameters (`detach`, sharing storage),
`torch.autograd.grad` for the gradients, gradient normalization, then
the per-layer optimizer updates the parameters IN PLACE, and the new
layer states of the forward that gave the loss are written into the
state tensors, in place, once per step. Nothing in a step reads a device
value on the host, so a CUDA graph can capture it (nn/multistep.py).

Mixed precision (`compute_dtype="bfloat16"`): the parameters stay
float32 masters. The loss and `output` cast every non-output layer's
parameters and the float (and uint8) inputs to bf16 with `.to()` (the
layer states stay float32), which autograd differentiates, so the
gradients reach the masters in float32 and the optimizer state stays
float32. Output layers keep float32 parameters, and the features fed to
their score are cast back to float32: the loss runs in full precision.

Device-side ingest (`set_ingest(DeviceIngest(...))` or `fit(ingest=)`,
etl/device_transform.py): batches keep their wire dtypes (uint8 pixels,
integer class ids) from `_prep_batch` into the step, whose first ops are
the ingest's `apply_features` / `apply_labels` (each model's
`_apply_ingest`), so under a K-step plan the widening runs inside the
captured graph. Training paths only: `output`, `score` and the flat
solvers take preprocessed tensors. `fit(prefetch=N)` wraps the data in
an etl.DevicePrefetcher of depth N on the model's device and closes it on
the way out, also on error (JAX graph.py:338-395).

Listeners (optimize/listeners) run on the host: `on_epoch_start` /
`on_epoch_end` around each epoch of `fit`, `record_batch_size` and
`iteration_done` after each `fit_batch` (JAX graph.py:466-469,
network.py:549-553) and after each K-step plan (nn/multistep.py). An
`optimization_algo` other than "sgd" trains each minibatch with one flat
solver per model (optimize/solvers; JAX graph.py:445-452,
network.py:526-536), batch by batch: no K-step plan is made for it."""
from __future__ import annotations

import torch

from ..datasets.iterator.base import as_iterator
from ..device import resolve_device
from .layers import base as _base
from .multistep import MultiStepTrainable
from .updaters import (PerLayerOptimizer, apply_gradient_normalization,
                       layer_transform)

_DTYPES = {"float32": torch.float32}
_COMPUTE_DTYPES = {"bfloat16": torch.bfloat16}


def is_weight_key(key):
    """Whether l1/l2 take a parameter as a weight (else as a bias; JAX
    network.py:35-36); a nested key ("fwd/RW") by its last part."""
    k = key.rsplit("/", 1)[-1]
    return not (k.endswith("b")
                or k in ("gamma", "beta", "centers", "mean", "var"))


class TrainableModel(MultiStepTrainable):
    def _setup(self, conf, named_layers, layer_confs, device):
        if conf.dtype not in _DTYPES:
            raise NotImplementedError(f"dtype {conf.dtype!r} is not ported")
        if conf.compute_dtype not in (None, conf.dtype, *_COMPUTE_DTYPES):
            raise NotImplementedError(
                f"compute_dtype {conf.compute_dtype!r} is not ported; the "
                f"port computes in {sorted(_COMPUTE_DTYPES)} or the model "
                "dtype")
        self.conf = conf
        self.named_layers = named_layers
        self.layer_confs = layer_confs
        self._dtype = _DTYPES[conf.dtype]
        self.device = resolve_device(device)
        self.params = None
        self.states = None
        self._optimizer = None
        self.iteration_count = 0
        self.epoch_count = 0
        self._score = float("nan")
        self.last_scores = None
        self._dropout = _base.DropoutStream(conf.seed, self.device,
                                            named_layers)
        self._decode_engine = None
        self.listeners = []
        self._flat_solver = None
        self._ingest = None
        # captured K-step graphs (nn/multistep.py) are of one epoch; `fit`
        # keeps one plan for each batch signature
        self._graph_epoch = 0
        self._plans = {}
        self._graph_pool = None
        self._capture_stream = None

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
                for name, layer in self.named_layers.items()
                for key, (shape, _) in layer.param_specs().items()}

    def state_shapes(self):
        """{"layer/key": shape} of every layer-state tensor."""
        return {f"{name}/{key}": tuple(shape)
                for name, layer in self.named_layers.items()
                for key, (shape, _) in layer.state_specs().items()}

    def init(self, params=None, states=None, device=None):
        """Create the parameters and layer states on the model's device (or
        `device`) and the per-layer optimizer state. Every layer's `init`
        gives both, as in the JAX package; `params` / `states`: optional
        `{layer: {key: array}}` trees loaded in their place (numpy arrays
        or tensors, copied and cast to the model dtype; a layer without
        state may be left out of `states`)."""
        if device is not None:
            self.device = resolve_device(device)
            if self._dropout.device != self.device:
                self._dropout = _base.DropoutStream(
                    self.conf.seed, self.device, self.named_layers)
                self._capture_stream = None
        gen = torch.Generator().manual_seed(int(self.conf.seed))
        fresh = {name: layer.init(gen, self._dtype, self.device)
                 for name, layer in self.named_layers.items()}
        self.params = ({name: p for name, (p, _) in fresh.items()}
                       if params is None else self._load(params,
                                                         "param_specs"))
        self.states = ({name: s for name, (_, s) in fresh.items()}
                       if states is None else self._load(states,
                                                         "state_specs"))
        self._build_updater()
        self._plans = {}
        self._decode_engine = None
        self._on_init()
        return self

    def _on_init(self):
        """What a model drops when its parameters are made anew."""

    def _load(self, tree, specs):
        """Copies of `tree`'s tensors on the model's device in the model
        dtype, checked against each layer's `specs` (a copy: training
        updates the parameters in place)."""
        loaded = {}
        for name, layer in self.named_layers.items():
            loaded[name] = {}
            for key, (shape, _) in getattr(layer, specs)().items():
                t = torch.as_tensor(tree[name][key]).to(
                    self.device, self._dtype, copy=True)
                if tuple(t.shape) != tuple(shape):
                    raise ValueError(f"{name}/{key}: shape {tuple(t.shape)},"
                                     f" expected {tuple(shape)}")
                loaded[name][key] = t
        return loaded

    def _build_updater(self):
        """New per-layer optimizers over the current parameters; every
        captured K-step graph goes stale."""
        updaters = {name: layer_transform(self.layer_confs[name])
                    for name in self.params}
        self._optimizer = PerLayerOptimizer(updaters, self.params)
        self._graph_epoch += 1

    def _to_model(self, x):
        """A tensor on the model's device in the model dtype."""
        return torch.as_tensor(x).to(self.device, self._dtype)

    def _to_models(self, arrs):
        """`_to_model` over a list (None entries and None kept)."""
        return None if arrs is None else \
            [None if a is None else self._to_model(a) for a in arrs]

    def _to_device(self, x):
        """A tensor on the model's device in its own dtype (a wire batch
        under an ingest: uint8 pixels, integer ids)."""
        return torch.as_tensor(x).to(self.device)

    # --------------------------------------------------------- device ingest
    def set_ingest(self, ingest):
        """Fuse a device-side ingest (etl.device_transform.DeviceIngest, or
        any object with `apply_features` / `apply_labels` on tensors) into
        the training step: batches then ship narrow (uint8 pixels, integer
        ids) and the widening runs as the step's first ops, inside a
        K-step plan's captured graph. Training paths only; `output`,
        `score` and the solvers keep consuming preprocessed tensors. A
        new ingest drops every kept plan and makes captured graphs stale
        (their steps widen otherwise); the same one keeps them."""
        if ingest is not self._ingest:
            self._ingest = ingest
            self._plans = {}
            self._graph_epoch += 1
        return self

    def _cast_label(self, y):
        """A label head in the model dtype (the cast `_prep_batch` makes
        without an ingest)."""
        return y if y.dtype == self._dtype else y.to(self._dtype)

    # ------------------------------------------------------- mixed precision
    def _compute_dtype(self):
        """The compute dtype when it differs from the model dtype, else
        None."""
        cd = self.conf.compute_dtype
        return None if cd in (None, self.conf.dtype) else _COMPUTE_DTYPES[cd]

    def _cast(self, a):
        """A float (or uint8) tensor in the compute dtype; anything else
        (integer ids, None) as it is."""
        if isinstance(a, torch.Tensor) and (a.is_floating_point()
                                            or a.dtype == torch.uint8):
            return a.to(self._compute_dtype())
        return a

    def _cast_params(self, params, keep):
        """The parameters in the compute dtype, but those of the layers
        named in `keep` (the output layers)."""
        return {name: (ps if name in keep
                       else {k: self._cast(v) for k, v in ps.items()})
                for name, ps in params.items()}

    # ------------------------------------------------------------- training
    def _reg_score(self, params):
        """The l1/l2 terms of every layer's conf (JAX network.py:225-246)."""
        total = 0.0
        for name, p in params.items():
            lc = self.layer_confs[name]
            l1, l2 = lc.l1 or 0.0, lc.l2 or 0.0
            l1b, l2b = lc.l1_bias or 0.0, lc.l2_bias or 0.0
            if not (l1 or l2 or l1b or l2b):
                continue
            for k, v in p.items():
                a, b = (l1, l2) if is_weight_key(k) else (l1b, l2b)
                if a:
                    total = total + a * torch.sum(torch.abs(v))
                if b:
                    total = total + 0.5 * b * torch.sum(v * v)
        return total

    def _normalize_grads(self, grads):
        out = {}
        for name, g in grads.items():
            lc = self.layer_confs[name]
            if lc.gradient_normalization and g:
                g = apply_gradient_normalization(
                    g, lc.gradient_normalization,
                    lc.gradient_normalization_threshold or 1.0)
            out[name] = g
        return out

    def _grads_of(self, loss, carries=None):
        """(score tensor, grads {layer: {key: tensor}}, new states
        detached) of `loss`, a function of a parameter tree giving (score,
        new states), at leaf copies of the current parameters; a parameter
        the score does not reach gets a zero gradient. `carries`, the
        recurrent carries `loss` replaced by its final ones, are detached
        in place: no gradient crosses to the next window (JAX
        network.py:573-575)."""
        leaves = {name: {k: t.detach().requires_grad_()
                         for k, t in ps.items()}
                  for name, ps in self.params.items()}
        flat = [t for ps in leaves.values() for t in ps.values()]
        with torch.enable_grad():
            score, states = loss(leaves)
            gs = iter(torch.autograd.grad(score, flat, allow_unused=True))
        grads = {}
        for name, ps in leaves.items():
            grads[name] = {}
            for k, t in ps.items():
                g = next(gs)
                grads[name][k] = torch.zeros_like(t) if g is None else g
        if carries is not None:
            for name, hc in carries.items():
                carries[name] = tuple(t.detach() for t in hc)
        states = {name: {k: t.detach() for k, t in s.items()}
                  for name, s in states.items()}
        return score.detach(), grads, states

    def _apply(self, grads, states):
        """The optimizer's update of the parameters and the new layer
        states written, both in place."""
        self._optimizer.step(self._normalize_grads(grads))
        with torch.no_grad():
            for name, s in states.items():
                for key, t in s.items():
                    if t is not self.states[name][key]:
                        self.states[name][key].copy_(t)

    def _zero_carries(self, batch):
        """{layer: zero (h, c)} of the recurrent layers that carry state
        (the bidirectional LSTM has none)."""
        return {name: layer.init_carry(batch, self._dtype, self.device)
                for name, layer in self.named_layers.items()
                if hasattr(layer, "init_carry")}

    def fit_batch(self, ds):
        """One minibatch: one optimizer step (one a window under truncated
        BPTT), or one flat-solver step; then the listeners."""
        if self.params is None:
            self.init()
        if self.conf.optimization_algo != "sgd":
            batch = self._prep_batch(ds, wide=True)
            self._solver().optimize(*batch)
        else:
            batch = self._prep_batch(ds)
            step = self._tbptt_step if self._tbptt_batch(batch) else \
                self._train_step
            self._score = step(*batch)
        self.iteration_count += 1
        first = batch[0][0] if isinstance(batch[0], list) else batch[0]
        self._iteration_done(first.shape[0])

    def _solver(self):
        """The model's flat solver, made on first use (JAX
        network.py:530-534)."""
        if self._flat_solver is None:
            from ..optimize.solvers import make_solver
            self._flat_solver = make_solver(
                self.conf.optimization_algo, self,
                line_search_iterations=self.conf
                .max_num_line_search_iterations)
        return self._flat_solver

    def _iteration_done(self, rows):
        """`record_batch_size(rows)` and `iteration_done` on every
        listener."""
        for listener in self.listeners:
            if hasattr(listener, "record_batch_size"):
                listener.record_batch_size(rows)
            listener.iteration_done(self, self.iteration_count)

    def set_listeners(self, *listeners):
        """Replace the listeners (lists flattened, None dropped)."""
        from ..optimize.listeners import resolve_listeners
        self.listeners = resolve_listeners(listeners)
        return self

    def add_listener(self, listener):
        self.listeners.append(listener)
        return self

    def _iterator(self, data):
        """`fit`'s data as an iterator (datasets/iterator/base.py
        `as_iterator`)."""
        return as_iterator(data)

    def fit(self, data, labels=None, epochs=1, steps_per_execution=1,
            prefetch=None, ingest=None):
        """Train on `data`: a DataSet, a MultiDataSet, a list or tuple of
        them, an iterator with `reset` and `__iter__` (reset at the start
        of every epoch), or features with `labels` — one `fit_batch` a
        minibatch, `epochs` times over, the listeners' epoch hooks around
        each epoch. Anything else raises TypeError, as `as_iterator` does:
        a one-shot iterable would train its first epoch only.
        `steps_per_execution=K` runs full groups of K minibatches as one
        K-step plan each (nn/multistep.py `_fit_grouped`), a ragged tail
        and a group that cannot run as one batch by batch.
        `prefetch=N` stages the batches on the model's device N deep from
        a worker thread (etl.DevicePrefetcher), closed when `fit` returns
        or raises; `ingest=` is `set_ingest(ingest)` first."""
        K = max(1, int(steps_per_execution))
        if ingest is not None:
            self.set_ingest(ingest)
        if labels is not None:
            data = self._dataset(data, labels)
        items = self._iterator(data)
        wrapped = None
        if prefetch:
            from ..etl.prefetch import DevicePrefetcher
            items = wrapped = DevicePrefetcher(
                items, queue_size=int(prefetch), device=self.device)
        try:
            for _ in range(int(epochs)):
                for listener in self.listeners:
                    listener.on_epoch_start(self)
                items.reset()
                if K > 1:
                    self._fit_grouped(items, K)
                else:
                    for ds in items:
                        self.fit_batch(ds)
                for listener in self.listeners:
                    listener.on_epoch_end(self)
                self.epoch_count += 1
        except BaseException:
            if wrapped is not None:
                try:
                    wrapped.close()
                except Exception:
                    pass        # the training error is the one to raise
            raise
        if wrapped is not None:
            wrapped.close()     # stop the fit-owned prefetch thread
        return self

    # ------------------------------------------------------------- evaluate
    def evaluate(self, iterator, top_n=1):
        """An `Evaluation` of `output(ds.features)` (no feature mask)
        against each batch's labels under its labels mask, as the JAX
        package evaluates (graph.py:638-650, network.py:789-801);
        `top_n > 1` also tracks top-N accuracy."""
        from ..eval.evaluation import Evaluation
        e = Evaluation(top_n=top_n)
        it = as_iterator(iterator)
        it.reset()
        for ds in it:
            e.eval(ds.labels, self.output(ds.features), ds.labels_mask)
        return e

    # ---------------------------------------------------------------- copies
    def param_table(self):
        """{"layer_key": tensor} of every parameter."""
        return {f"{name}_{k}": v for name, ps in self.params.items()
                for k, v in ps.items()}

    def clone(self):
        """A new model of the same configuration on the same device, with
        copies of the parameters and layer states (fresh optimizer
        state, as in the JAX package)."""
        net = type(self)(self.conf, device=self.device)
        if self.params is not None:
            net.init(params=self.params, states=self.states)
        return net

    def quantize_weights(self, dtype="int8"):
        raise NotImplementedError(
            "int8 serving weights are not ported yet (ROADMAP queue 1 item "
            "10: nn/quant.py)")

    # ------------------------------------------------------------- generate
    def generate(self, prompt_ids, max_new_tokens=20, stop_id=None,
                 max_len=None, sampler=None):
        """KV-cache autoregressive decode through decode.DecodeEngine (one
        slot; JAX nn/multistep.py:110-135): greedy by default,
        token-for-token what re-running `output` on the growing sequence
        gives; `sampler` (a decode.SamplerConfig) samples instead. The
        engine is cached on the model and made anew when its capacity is
        short; `max_len` sizes its cache (default: prompt + new tokens,
        rounded up to a power of two). A MultiLayerNetwork or a
        single-input, single-output graph; a layer without per-token
        semantics raises decode.DecodeUnsupported."""
        from ..decode.engine import DecodeEngine, bucket_for_len
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
