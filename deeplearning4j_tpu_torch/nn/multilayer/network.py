"""MultiLayerNetwork: the sequential stack of layers (counterpart of
deeplearning4j_tpu/nn/multilayer/network.py).

Layer i's parameters and state are `params[str(i)]` / `states[str(i)]`,
the JAX package's keys; the input preprocessor of layer i
(`conf.input_preprocessors[i]`, inserted by `ListBuilder.build`) runs in
front of it. Parameters, layer states, the training step and mixed
precision are the port's shared model's (nn/model.py): the step runs
eagerly, the per-layer optimizers update the parameters IN PLACE, and
under `compute_dtype="bfloat16"` every layer but the last computes in
bf16 while the output layer and the loss stay float32.

Training: `fit_batch` takes one optimizer step a batch, or under
truncated BPTT (`conf.backprop_type == "truncated_bptt"`) and a sequence
longer than `tbptt_fwd_length`, one a window of that length
(`_tbptt_step`, JAX network.py:557-583): the last window may be shorter;
the recurrent layers start from zero carries and pass their final (h, c)
on to the next window detached, so no gradient crosses a window; the
batch's score is the mean of its windows'. `fit(steps_per_execution=K)`
and `prepare_steps` / `fit_prepared` run K batches as one plan
(nn/multistep.py; on the card one CUDA graph), TBPTT batches included
when the window tiles the sequence. Streaming inference
(`rnn_time_step`) keeps each recurrent layer's carry between calls. The
bidirectional LSTM has no carry, so neither TBPTT nor `rnn_time_step`
passes it one (JAX network.py:585-590).

`generate` (nn/model.py) decodes through decode.DecodeEngine: the
recurrent layers carry (h, c) in the cache's slot rows; the
bidirectional LSTM and input preprocessors raise DecodeUnsupported.

Listeners, the flat solvers, `evaluate` and `clone` are the shared
model's (nn/model.py). Not ported yet, raising NotImplementedError with
its ROADMAP item: `pretrain` / `pretrain_layer`."""
from __future__ import annotations

import numpy as np
import torch

from ...datasets.dataset import DataSet
from ..conf.configuration import BackpropType, MultiLayerConfiguration
from ..conf.preprocessors import apply_preprocessor
from ..layers import base as _base
from ..model import TrainableModel
from ..remat import maybe_checkpoint


class MultiLayerNetwork(TrainableModel):
    def __init__(self, conf: MultiLayerConfiguration, device=None):
        self.layers = [_base.create_layer(lc) for lc in conf.layers]
        self._setup(conf, {str(i): l for i, l in enumerate(self.layers)},
                    {str(i): lc for i, lc in enumerate(conf.layers)},
                    device)
        self._out = str(len(self.layers) - 1)
        self._rnn_state = {}

    def _on_init(self):
        self._rnn_state = {}

    @staticmethod
    def _dataset(features, labels):
        return DataSet(features, labels)

    # -------------------------------------------------------------- forward
    def _forward(self, params, states, x, mask=None, *, train=False,
                 rng=None, remat=None, to_layer=None, carries=None,
                 collect=None):
        """(activations, new states, mask) of layers [0, to_layer) (all by
        default), each behind its preprocessor; `rng`: the model's
        `DropoutStream` in a training forward; `remat`: the checkpoint
        policy each layer's forward runs under; `carries`: {layer: (h,
        c)} of the recurrent layers that carry state, their initial
        carries, replaced by their final ones; `collect`: a list each
        layer's activations are appended to."""
        n = len(self.layers) if to_layer is None else to_layer
        pres = self.conf.input_preprocessors
        new_states = dict(states)
        for i in range(n):
            name = str(i)
            x, mask = apply_preprocessor(pres.get(i), x, mask)
            draws = None if rng is None else rng.layer(name)
            forward = maybe_checkpoint(self.layers[i].forward, remat, draws)
            kw = {}
            if carries is not None and name in carries:
                kw = {"initial_state": carries[name], "return_state": True}
            out = forward(params[name], states[name], x, train=train,
                          rng=draws, mask=mask, **kw)
            x, new_states[name], mask = out[:3]
            if kw:
                carries[name] = out[3]
            if collect is not None:
                collect.append(x)
        return x, new_states, mask

    def _cast_for_compute(self, params, x):
        """bf16 compute for every layer but the output layer, whose
        parameters stay in the model dtype (JAX network.py:169-186)."""
        if self._compute_dtype() is None:
            return params, x
        return self._cast_params(params, {self._out}), self._cast(x)

    # ------------------------------------------------------------- loss
    def _loss(self, params, states, x, y, *, train, mask=None,
              label_mask=None, carries=None, dropout=True):
        """(scalar score, new states): the output layer's loss on the
        features feeding it, behind its preprocessor, plus l1/l2; the
        label mask, or else the features' mask, masks the loss. In
        training, dropout draws from the model's stream (unless `dropout`
        is False: the flat solvers' state pass) and, under `conf.remat`,
        each layer's forward and the score is checkpointed on its own (as
        the graph does, `ComputationGraph._loss`)."""
        n = len(self.layers) - 1
        params, x = self._cast_for_compute(params, x)
        rng = self._dropout if train and dropout else None
        remat = self.conf.remat if train else None
        feats, new_states, fmask = self._forward(
            params, states, x, mask, train=train, rng=rng, remat=remat,
            to_layer=n, carries=carries)
        feats, fmask = apply_preprocessor(
            self.conf.input_preprocessors.get(n), feats, fmask)
        if self._compute_dtype() is not None:
            feats = feats.to(self._dtype)   # loss in full precision
        layer = self.layers[n]
        if not layer.is_output_layer():
            raise ValueError("Last layer is not an output/loss layer")
        draws = None if rng is None else rng.layer(self._out)
        score = maybe_checkpoint(layer.score, remat, draws)(
            params[self._out], feats, y,
            label_mask if label_mask is not None else fmask, train, draws)
        return score + self._reg_score(params), new_states

    def _value_and_grad(self, x, y, mask, label_mask, *, train,
                        carries=None):
        """(score tensor, grads {layer: {key: tensor}}, new states
        detached) at the current parameters and states; `carries` as in
        `_forward`, the final ones detached."""
        def loss(leaves):
            return self._loss(leaves, self.states, x, y, train=train,
                              mask=mask, label_mask=label_mask,
                              carries=carries)
        return self._grads_of(loss, carries)

    # ---------------------------------------------------------------- train
    def _prep_batch(self, ds, wide=False):
        """(x, y, mask, label mask) tensors on the model's device (None
        for an absent mask) in the model dtype; under an ingest (and not
        `wide`: `score`'s and the solvers' batches) x and y keep their
        wire dtypes (JAX network.py:389-403), which the step's
        `_apply_ingest` widens."""
        to = lambda a: None if a is None else self._to_model(a)
        raw = self._to_device if self._ingest is not None and not wide \
            else to
        return (raw(ds.features), raw(ds.labels), to(ds.features_mask),
                to(ds.labels_mask))

    def _apply_ingest(self, x, y):
        """The ingest's widening at the top of a training step (JAX
        network.py:274-289): features through `apply_features`, then to
        the model dtype unless they are signed integers (embedding ids);
        labels through `apply_labels`, then to the model dtype."""
        ing = self._ingest
        if ing is None:
            return x, y
        x = ing.apply_features(x)
        signed_int = not (x.is_floating_point() or x.is_complex()) \
            and x.is_signed()
        if not signed_int and x.dtype != self._dtype:
            x = x.to(self._dtype)
        return x, self._cast_label(ing.apply_labels(y))

    def _tbptt(self, x):
        """Whether a batch of features `x` trains in windows."""
        return (self.conf.backprop_type == BackpropType.TRUNCATED_BPTT
                and x.dim() == 3 and x.shape[1] > self.conf.tbptt_fwd_length)

    def _tbptt_batch(self, batch):
        return self._tbptt(batch[0])

    def _windows(self, prepped):
        """A prepared batch's optimizer steps in a plan: 1, W = T / L
        windows under truncated BPTT, or None (batch by batch) where L
        does not tile T (JAX network.py:414-426)."""
        x, L = prepped[0], self.conf.tbptt_fwd_length
        if not self._tbptt(x):
            return 1
        return x.shape[1] // L if x.shape[1] % L == 0 else None

    def _train_step(self, x, y, mask, lmask):
        """One training step on prepared tensors: the loss and its
        gradients, the optimizer's update of the parameters and the new
        layer states, both in place; returns the score tensor."""
        x, y = self._apply_ingest(x, y)
        score, grads, states = self._value_and_grad(x, y, mask, lmask,
                                                    train=True)
        self._apply(grads, states)
        return score

    def _tbptt_step(self, x, y, mask, lmask):
        """One batch under truncated BPTT: a training step a window of
        `tbptt_fwd_length` steps (the last may be shorter), from zero
        carries, each window's final carries detached into the next;
        returns the mean of the windows' scores."""
        x, y = self._apply_ingest(x, y)
        T, L = x.shape[1], self.conf.tbptt_fwd_length
        carries = self._zero_carries(x.shape[0])
        cut = lambda a, s: None if a is None else a[:, s:s + L]
        scores = []
        for s in range(0, T, L):
            score, grads, states = self._value_and_grad(
                cut(x, s), cut(y, s) if y.dim() == 3 else y, cut(mask, s),
                cut(lmask, s), train=True, carries=carries)
            self._apply(grads, states)
            scores.append(score)
        return torch.stack(scores).mean()

    # ------------------------------------------------------------ inference
    def output(self, x, train=False, mask=None):
        """The full forward in the compute dtype (if one is set), returned
        in the model dtype. `train=True` runs the layers in training mode
        (batch norm on the batch's statistics, which are not kept) without
        dropout; `mask`: [batch, time] validity of a sequence input."""
        if self.params is None:
            self.init()
        with torch.inference_mode():
            params, xx = self._cast_for_compute(self.params,
                                                self._to_model(x))
            out, _, _ = self._forward(
                params, self.states, xx,
                None if mask is None else self._to_model(mask),
                train=bool(train))
        return out.to(self._dtype)

    def feed_forward(self, x, train=False):
        """Every layer's activations, in order (model dtype, no cast)."""
        acts = []
        with torch.inference_mode():
            self._forward(self.params, self.states, self._to_model(x),
                          train=train, collect=acts)
        return acts

    def feed_forward_to_layer(self, layer_idx, x, train=False):
        """The activations of layer `layer_idx` (the layers up to it run)."""
        with torch.inference_mode():
            out, _, _ = self._forward(self.params, self.states,
                                      self._to_model(x), train=train,
                                      to_layer=layer_idx + 1)
        return out

    def score(self, ds_or_x, labels=None, train=False):
        """The mean loss (with l1/l2) on a DataSet, its masks applied, or
        on features and `labels`, as a float; no dropout."""
        ds = ds_or_x if labels is None else DataSet(ds_or_x, labels)
        x, y, mask, lmask = self._prep_batch(ds, wide=True)
        with torch.no_grad():
            s, _ = self._loss(self.params, self.states, x, y, train=train,
                              mask=mask, label_mask=lmask)
        return float(s)

    def compute_gradient_and_score(self, x, y, mask=None, label_mask=None):
        """(grads {layer: {key: tensor}}, score float) of the loss at
        inference (no dropout)."""
        to = lambda a: None if a is None else self._to_model(a)
        score, grads, _ = self._value_and_grad(
            to(x), to(y), to(mask), to(label_mask), train=False)
        return grads, float(score)

    # ------------------------------------------------------- rnn streaming
    def rnn_time_step(self, x):
        """Stateful streaming inference: `x` [b, t, f] (or one step [b,
        f]) continues from the carries the last call left (zero at first
        and after `rnn_clear_previous_state`); returns the outputs ([b,
        n_out] for one step given as [b, f])."""
        x = self._to_model(x)
        squeeze = x.dim() == 2
        if squeeze:
            x = x[:, None, :]
        carries = dict(self._rnn_state or self._zero_carries(x.shape[0]))
        with torch.no_grad():
            out, _, _ = self._forward(self.params, self.states, x,
                                      carries=carries)
        self._rnn_state = carries
        return out[:, -1] if squeeze and out.dim() == 3 else out

    def rnn_clear_previous_state(self):
        self._rnn_state = {}

    def rnn_get_previous_state(self, layer_idx):
        return self._rnn_state.get(str(layer_idx))

    def rnn_set_previous_state(self, layer_idx, state):
        self._rnn_state[str(layer_idx)] = state

    # -------------------------------------------------------------- params
    def num_params(self):
        return sum(t.numel() for ps in self.params.values()
                   for t in ps.values())

    def _ordered(self):
        """Every parameter tensor in (layer, sorted key) order."""
        return [self.params[str(i)][k] for i in range(len(self.layers))
                for k in sorted(self.params[str(i)])]

    def get_flat_params(self):
        """The parameters as one float numpy vector in (layer, sorted key)
        order, as the JAX package flattens them."""
        ts = self._ordered()
        if not ts:
            return np.zeros((0,), np.float32)
        return np.concatenate([t.detach().cpu().numpy().ravel()
                               for t in ts])

    def set_flat_params(self, flat):
        """Write a `get_flat_params` vector into the parameters, in
        place."""
        flat = torch.as_tensor(np.asarray(flat))
        off = 0
        with torch.no_grad():
            for t in self._ordered():
                t.copy_(flat[off:off + t.numel()].reshape(t.shape))
                off += t.numel()
        return self

    def set_params(self, params):
        """Write a {layer: {key: array}} tree into the parameters, in place
        (the optimizers keep updating the same tensors)."""
        loaded = self._load(params, "param_specs")
        with torch.no_grad():
            for name, ps in loaded.items():
                for k, t in ps.items():
                    self.params[name][k].copy_(t)
        return self

    # ------------------------------------------------------ not yet ported
    def pretrain(self, data, epochs=1):
        raise NotImplementedError(
            "layerwise pretraining is not ported yet (ROADMAP queue 1: nn "
            "core, the remaining layer impls)")

    pretrain_layer = pretrain
