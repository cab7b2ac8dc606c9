"""ComputationGraph: DAG model, inference forward, training and generation
(counterpart of deeplearning4j_tpu/nn/graph/graph.py).

Vertices run in topological order on tensors of the model's device, a
layer behind its input preprocessor where it has one. Parameters, layer
states, the training step and mixed precision are the port's shared
model's (nn/model.py): a forward in training mode gives each layer's new
state, which `fit_batch` writes into the state tensors; inference
(`output`, `score`, `compute_gradient_and_score`) reads the states and
leaves them as they are.

Training: `fit` takes one optimizer step per minibatch (attention's
backward in the hand-written kernels when `use_pallas=True`), updating
the parameters IN PLACE. A cached decode engine reads the parameters
live, so `generate` (nn/model.py) after `fit` sees the trained weights.
Under truncated BPTT a batch whose 3-D inputs are longer than
`tbptt_fwd_length` trains window by window (`_tbptt_step`, JAX
graph.py:471-502): every time-distributed input, label and mask is cut
into windows of that length (the last may be shorter), other inputs go
whole to every window, one optimizer step a window, the recurrent
layers' carries passed on detached (no gradient crosses a window); the
batch's score is the mean of its windows'. As in the JAX package such a
batch runs batch by batch under `steps_per_execution`.
`fit(steps_per_execution=K)`, `prepare_steps` and `fit_prepared` run K
steps a call (nn/multistep.py: on the card one CUDA graph of the K
steps); with `conf.remat` the training forward is checkpointed under the
named policy (nn/remat.py), layer by layer; a dropout rate above 0 draws
its masks from the model's `DropoutStream` (nn/layers/base.py), one
generator per layer, in training. Listeners, the flat solvers,
`evaluate` and `clone` are the shared model's (nn/model.py).

Mixed precision (`compute_dtype="bfloat16"`, JAX graph.py:169-191):
network output layers keep float32 parameters. Masks are not cast, so
where a float32 mask multiplies a bf16 activation the result is float32
from there on, as in JAX (`base.matmul` promotes as JAX does). The decode
engine serves the float32 masters, as the JAX engine does."""
from __future__ import annotations

import torch

from ...datasets.dataset import DataSet, MultiDataSet
from ...datasets.iterator.base import ListDataSetIterator, as_iterator
from ..conf.graph_configuration import ComputationGraphConfiguration
from ..conf.preprocessors import apply_preprocessor
from ..layers import base as _base
from ..model import TrainableModel
from ..remat import maybe_checkpoint


class ComputationGraph(TrainableModel):
    def __init__(self, conf: ComputationGraphConfiguration, device=None):
        self.order = conf.topo_sort()
        self.layers = {name: _base.create_layer(conf.vertices[name].layer_conf)
                       for name in self.order
                       if conf.vertices[name].kind == "layer"}
        self._setup(conf, self.layers,
                    {name: conf.vertices[name].layer_conf
                     for name in self.layers}, device)
        # output vertices no other vertex reads: the loss replaces their
        # forward with their score
        consumed = {i for s in conf.vertices.values() for i in s.inputs}
        self._loss_only = set(conf.network_outputs) - consumed

    @staticmethod
    def _dataset(features, labels):
        return MultiDataSet(features, labels)

    def _iterator(self, data):
        """A (Multi)DataSet is one batch and a list or tuple a list of
        batches (JAX graph.py:358-366)."""
        if isinstance(data, (DataSet, MultiDataSet)):
            return ListDataSetIterator([data])
        if isinstance(data, (list, tuple)):
            return ListDataSetIterator(list(data))
        return as_iterator(data)

    # -------------------------------------------------------------- forward
    def _forward(self, params, states, inputs, masks=None, *, train=False,
                 rng=None, remat=None, skip=(), carries=None):
        """(activations, new states, masks) of every vertex but those in
        `skip`, masks flowing as in the JAX package (a vertex passes on
        its first input's mask; a preprocessor reshapes the mask with the
        activation); `rng`: the model's `DropoutStream` in a training
        forward; `remat`: the checkpoint policy each layer's forward runs
        under; `carries`: {layer: (h, c)} of the recurrent layers that
        carry state, their initial carries, replaced by their final
        ones."""
        conf = self.conf
        acts, out_masks = {}, {}
        new_states = dict(states)
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
                x, m = apply_preprocessor(spec.preprocessor, xs[0], ms[0])
                draws = None if rng is None else rng.layer(name)
                forward = maybe_checkpoint(self.layers[name].forward, remat,
                                           draws)
                kw = {}
                if carries is not None and name in carries:
                    kw = {"initial_state": carries[name],
                          "return_state": True}
                out = forward(params[name], states[name], x, train=train,
                              rng=draws, mask=m, **kw)
                acts[name], new_states[name], out_masks[name] = out[:3]
                if kw:
                    carries[name] = out[3]
            else:
                acts[name] = spec.vertex_conf.apply(xs)
                out_masks[name] = next((m for m in ms if m is not None), None)
        return acts, new_states, out_masks

    def output(self, *inputs, train=False, mask=None):
        """Inference forward (in the compute dtype, if one is set). `mask`
        is a [batch, time] validity mask for the first network input.
        Returns the output tensor (a list for several outputs) on the
        model's device, in the model dtype. `train` is taken for the JAX
        package's signature (graph.py:507) and, as there, changes
        nothing: `output` draws no dropout and reads the running
        statistics."""
        if self.params is None:
            self.init()
        with torch.inference_mode():
            params, xs = self._cast_for_compute(
                self.params, [self._to_model(x) for x in inputs])
            masks = None
            if mask is not None:
                masks = [self._to_model(mask)] + [None] * (len(xs) - 1)
            acts, _, _ = self._forward(params, self.states, xs, masks)
            outs = [acts[o].to(self._dtype)
                    for o in self.conf.network_outputs]
        return outs[0] if len(outs) == 1 else outs

    def _cast_for_compute(self, params, inputs):
        """bf16 compute for all non-output layers: their parameters and the
        float (and uint8) inputs cast with `.to()`; network output layers
        keep the parameter dtype so their loss runs in full precision (JAX
        graph.py:175-191). Integer inputs are not cast, nor are the layer
        states."""
        if self._compute_dtype() is None:
            return params, inputs
        return (self._cast_params(params, set(self.conf.network_outputs)),
                [self._cast(x) for x in inputs])

    # ---------------------------------------------------------------- loss
    def _loss(self, params, states, inputs, labels, *, train, masks=None,
              label_masks=None, carries=None, dropout=True):
        """(scalar score, new states): every output layer's loss on the
        features feeding it, behind its preprocessor (its forward is
        replaced by its score), plus l1/l2. Under a compute dtype the
        forward runs on the cast parameters and the features reach the
        loss in the model dtype. In training, dropout draws from the
        model's stream and, under `conf.remat`, each layer's forward and
        each output layer's score is checkpointed on its own. (JAX
        graph.py:204-213 checkpoints the whole forward, and XLA schedules
        its recompute into the backward; torch recomputes a region whole
        when the backward first reaches it, so one region over the forward
        would hold every activation again at once: on ResNet-50 it left
        the peak where it was.) `carries` as in `_forward`; `dropout=False`
        trains without dropout (the flat solvers' state pass)."""
        conf = self.conf
        params, inputs = self._cast_for_compute(params, inputs)
        rng = self._dropout if train and dropout else None
        remat = conf.remat if train else None
        acts, new_states, out_masks = self._forward(
            params, states, inputs, masks, train=train, rng=rng, remat=remat,
            skip=self._loss_only, carries=carries)
        total = 0.0
        lm = label_masks or [None] * len(conf.network_outputs)
        for out_name, y, mlab in zip(conf.network_outputs, labels, lm):
            spec = conf.vertices[out_name]
            layer = self.layers[out_name]
            if not layer.is_output_layer():
                raise ValueError(f"Network output '{out_name}' is not an "
                                 "output layer")
            fmask = out_masks.get(spec.inputs[0])
            # the score takes the mask as it was (JAX graph.py:222-232)
            feats, _ = apply_preprocessor(spec.preprocessor,
                                          acts[spec.inputs[0]], fmask)
            if self._compute_dtype() is not None:
                feats = feats.to(self._dtype)   # loss in full precision
            mask = mlab if mlab is not None else fmask
            draws = None if rng is None else rng.layer(out_name)
            score = maybe_checkpoint(layer.score, remat, draws)
            total = total + score(params[out_name], feats, y, mask, train,
                                  draws)
        return total + self._reg_score(params), new_states

    def _value_and_grad(self, inputs, labels, masks, label_masks, *, train,
                        carries=None):
        """(score tensor, grads {layer: {key: tensor}}, new states
        detached) at the current parameters and states; `carries` as in
        `_forward`, the final ones detached."""
        def loss(leaves):
            return self._loss(leaves, self.states, inputs, labels,
                              train=train, masks=masks,
                              label_masks=label_masks, carries=carries)
        return self._grads_of(loss, carries)

    # ---------------------------------------------------------------- train
    def _windows(self, prepped):
        """1, or None for a batch that trains in truncated-BPTT windows:
        the graph runs such batches one by one (JAX graph.py:431-434)."""
        return None if self._tbptt_length(prepped[0]) else 1

    def _tbptt_length(self, inputs):
        """The sequence length a batch trains in windows of
        `tbptt_fwd_length`, or 0 when it trains in one step."""
        T = max((x.shape[1] for x in inputs if x.dim() == 3), default=0)
        tbptt = (self.conf.backprop_type == "truncated_bptt"
                 and T > self.conf.tbptt_fwd_length)
        return T if tbptt else 0

    def _tbptt_batch(self, batch):
        return bool(self._tbptt_length(batch[0]))

    def _prep_batch(self, ds, wide=False):
        """(inputs, labels, masks, label masks) lists of tensors on the
        model's device, in the model dtype; under an ingest (and not
        `wide`: the solvers' batches) the first input and every label
        head keep their wire dtypes (JAX graph.py:400-416), which the
        step's `_apply_ingest` widens."""
        if isinstance(ds, DataSet):
            ds = MultiDataSet(
                [ds.features], [ds.labels],
                None if ds.features_mask is None else [ds.features_mask],
                None if ds.labels_mask is None else [ds.labels_mask])
        raw = self._ingest is not None and not wide
        inputs = [self._to_device(x) if raw and i == 0 else self._to_model(x)
                  for i, x in enumerate(ds.features)]
        labels = [self._to_device(y) if raw else self._to_model(y)
                  for y in ds.labels]
        return (inputs, labels, self._to_models(ds.features_masks),
                self._to_models(ds.labels_masks))

    def _apply_ingest(self, inputs, labels):
        """The ingest's widening at the top of a training step (JAX
        graph.py:286-298): the first input through `apply_features`, not
        cast (the compute cast comes after, as for any input); the first
        label through `apply_labels`; every label head to the model
        dtype."""
        ing = self._ingest
        if ing is None:
            return inputs, labels
        inputs = [ing.apply_features(inputs[0])] + list(inputs[1:])
        labels = [self._cast_label(ing.apply_labels(y) if i == 0 else y)
                  for i, y in enumerate(labels)]
        return inputs, labels

    def _train_step(self, inputs, labels, masks, lmasks):
        """One training step on prepared tensors: the loss and its
        gradients, the optimizer's update of the parameters and the new
        layer states, both in place; returns the score tensor."""
        inputs, labels = self._apply_ingest(inputs, labels)
        score, grads, states = self._value_and_grad(
            inputs, labels, masks, lmasks, train=True)
        self._apply(grads, states)
        return score

    def _tbptt_step(self, inputs, labels, masks, lmasks):
        """Truncated BPTT over the graph: one step a window of
        `tbptt_fwd_length` (the last may be shorter), carries detached
        between windows; returns the mean of the windows' scores."""
        inputs, labels = self._apply_ingest(inputs, labels)
        T, L = self._tbptt_length(inputs), self.conf.tbptt_fwd_length
        carries = self._zero_carries(inputs[0].shape[0])

        def cut(arrs, s):
            return None if arrs is None else [
                None if a is None else
                (a[:, s:s + L] if a.dim() >= 2 and a.shape[1] == T else a)
                for a in arrs]
        scores = []
        for s in range(0, T, L):
            score, grads, states = self._value_and_grad(
                [x[:, s:s + L] if x.dim() == 3 and x.shape[1] == T else x
                 for x in inputs],
                [y[:, s:s + L] if y.dim() == 3 and y.shape[1] == T else y
                 for y in labels],
                cut(masks, s), cut(lmasks, s), train=True, carries=carries)
            self._apply(grads, states)
            scores.append(score)
        return torch.stack(scores).mean()

    def score(self, ds):
        """The loss on one DataSet / MultiDataSet at inference (no
        dropout), as a float. Masks are not applied, as in the JAX
        package's `score`."""
        if isinstance(ds, DataSet):
            ds = MultiDataSet([ds.features], [ds.labels])
        with torch.no_grad():
            s, _ = self._loss(self.params, self.states,
                              self._to_models(ds.features),
                              self._to_models(ds.labels), train=False)
        return float(s)

    def compute_gradient_and_score(self, inputs, labels, masks=None,
                                   label_masks=None):
        """(grads {layer: {key: tensor}}, score float) of the loss at
        inference (no dropout). `inputs`/`labels`: an array or a list of
        them; masks: lists aligned with the inputs / outputs."""
        listed = lambda a: list(a) if isinstance(a, (list, tuple)) else [a]
        score, grads, _ = self._value_and_grad(
            self._to_models(listed(inputs)), self._to_models(listed(labels)),
            self._to_models(masks), self._to_models(label_masks),
            train=False)
        return grads, float(score)
