"""Updaters (optimizers) and gradient normalization (counterpart of
deeplearning4j_tpu/nn/updaters.py; Sgd and Adam with the fixed learning
rate — the other updaters and schedules are ROADMAP queue 1, nn core).

The JAX package lowers each updater to an optax transformation. Here each
updater builds a `torch.optim` optimizer over one layer's tensors and
updates them IN PLACE (the JAX package returns new arrays).
`torch.optim.Adam` is optax's Adam: both moments bias-corrected and eps
added to the corrected sqrt(v); the two differ only in rounding
(torch divides sqrt(v) by sqrt(1 - b2^t), optax takes sqrt(v / (1 -
b2^t))). `PerLayerOptimizer` is `per_layer_transform`: one optimizer per
layer, each stepping only its layer's tensors.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


def make_schedule(base_lr, policy=None, decay_rate=None, power=None,
                  steps=None, schedule_map=None):
    """Schedule fn step -> lr. Only the fixed policy is ported."""
    if policy is None or policy in ("none", "fixed"):
        return lambda step: base_lr
    raise NotImplementedError(
        f"learning-rate policy {policy!r} is not ported yet (ROADMAP "
        "queue 1: nn core); the fixed policy is")


@dataclass
class BaseUpdater:
    learning_rate: float = 1e-1
    lr_policy: str | None = None
    lr_policy_decay_rate: float | None = None
    lr_policy_power: float | None = None
    lr_policy_steps: float | None = None
    lr_schedule_map: dict | None = None

    def schedule(self):
        return make_schedule(self.learning_rate, self.lr_policy,
                             self.lr_policy_decay_rate, self.lr_policy_power,
                             self.lr_policy_steps, self.lr_schedule_map)

    def optimizer(self, tensors):
        """A torch optimizer over `tensors` (leaf tensors, updated in
        place)."""
        raise NotImplementedError


@dataclass
class Sgd(BaseUpdater):
    def optimizer(self, tensors):
        return torch.optim.SGD(tensors, lr=self.schedule()(0))


@dataclass
class Adam(BaseUpdater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def optimizer(self, tensors):
        return torch.optim.Adam(tensors, lr=self.schedule()(0),
                                betas=(self.beta1, self.beta2),
                                eps=self.epsilon)


def layer_transform(layer_conf):
    """The updater of one layer conf: its own, or the reference's default
    plain Sgd(0.1) when none is set."""
    return layer_conf.updater if layer_conf.updater is not None \
        else Sgd(learning_rate=0.1)


class PerLayerOptimizer:
    """One optimizer per layer (`per_layer_transform`): `step(grads)`
    updates params[name] in place from grads[name] with layer `name`'s
    updater, at the learning rate its schedule gives this step."""

    def __init__(self, updaters: dict, params: dict):
        self._layers = {}
        for name, ps in params.items():
            if ps:
                upd = updaters[name]
                self._layers[name] = (upd.schedule(), dict(ps),
                                      upd.optimizer(list(ps.values())))
        self.count = 0

    def step(self, grads: dict):
        for name, g in grads.items():
            if name not in self._layers:
                continue
            sched, tensors, opt = self._layers[name]
            lr = sched(self.count)
            for group in opt.param_groups:
                group["lr"] = lr
            for key, t in tensors.items():
                t.grad = g[key]
            opt.step()
            for t in tensors.values():
                t.grad = None
        self.count += 1


class GradientNormalization:
    NONE = "none"
    RENORMALIZE_L2_PER_LAYER = "renormalize_l2_per_layer"
    RENORMALIZE_L2_PER_PARAM_TYPE = "renormalize_l2_per_param_type"
    CLIP_ELEMENTWISE_ABSOLUTE_VALUE = "clip_elementwise_absolute_value"
    CLIP_L2_PER_LAYER = "clip_l2_per_layer"
    CLIP_L2_PER_PARAM_TYPE = "clip_l2_per_param_type"


def _sq(g):
    return torch.sum(g * g)


def apply_gradient_normalization(layer_grads: dict, mode: str,
                                 threshold: float = 1.0):
    """Gradient normalization of one layer's {param name: grad} dict."""
    gn = GradientNormalization
    if mode in (None, gn.NONE):
        return layer_grads
    if mode == gn.RENORMALIZE_L2_PER_LAYER:
        total = torch.sqrt(sum(_sq(g) for g in layer_grads.values()) + 1e-12)
        return {k: g / total for k, g in layer_grads.items()}
    if mode == gn.RENORMALIZE_L2_PER_PARAM_TYPE:
        return {k: g / torch.sqrt(_sq(g) + 1e-12)
                for k, g in layer_grads.items()}
    if mode == gn.CLIP_ELEMENTWISE_ABSOLUTE_VALUE:
        return {k: torch.clamp(g, -threshold, threshold)
                for k, g in layer_grads.items()}
    if mode == gn.CLIP_L2_PER_LAYER:
        total = torch.sqrt(sum(_sq(g) for g in layer_grads.values()) + 1e-12)
        scale = torch.clamp(threshold / total, max=1.0)
        return {k: g * scale for k, g in layer_grads.items()}
    if mode == gn.CLIP_L2_PER_PARAM_TYPE:
        return {k: g * torch.clamp(threshold / torch.sqrt(_sq(g) + 1e-12),
                                   max=1.0)
                for k, g in layer_grads.items()}
    raise ValueError(f"Unknown gradient normalization mode '{mode}'")
