"""Updaters (optimizers) and gradient normalization (counterpart of
deeplearning4j_tpu/nn/updaters.py; Sgd, Nesterovs and Adam with the fixed
learning rate — the other updaters and schedules are ROADMAP queue 1, nn
core).

The JAX package lowers each updater to an optax transformation. Here each
updater builds a `torch.optim` optimizer over one layer's tensors and
updates them IN PLACE (the JAX package returns new arrays).
`torch.optim.Adam` is optax's Adam: both moments bias-corrected and eps
added to the corrected sqrt(v); the two differ only in rounding
(torch divides sqrt(v) by sqrt(1 - b2^t), optax takes sqrt(v / (1 -
b2^t))). `torch.optim.SGD(momentum=m, nesterov=True, dampening=0)` is
optax's `sgd(nesterov=True)`: both start the momentum buffer at the first
gradient g and step by g + m * buffer. `PerLayerOptimizer` is
`per_layer_transform`: one optimizer per layer, each stepping only its
layer's tensors.

Serde: `to_dict` / `updater_from_dict` are the JAX package's
(updaters.py:67-98); an updater type the port lacks raises
NotImplementedError. `opt_state_leaves` / `load_opt_state_leaves` carry
the optimizer state across as the JAX package's ModelSerializer stores it
in `updaterState.bin`: the leaves of the optax state in
`jax.tree_util.tree_leaves` order (see `opt_state_leaves`).
"""
from __future__ import annotations

from dataclasses import asdict, dataclass

import numpy as np
import torch

_UPDATER_REGISTRY: dict = {}

# registered by the JAX package, not ported yet
_UNPORTED_UPDATERS = ("AdaMax", "AdaDelta", "AdaGrad", "RmsProp", "NoOp")


def register_updater(cls):
    _UPDATER_REGISTRY[cls.__name__] = cls
    return cls


def updater_from_dict(d):
    d = dict(d)
    t = d.pop("type")
    if t in _UNPORTED_UPDATERS:
        raise NotImplementedError(
            f"updater {t} is not ported yet (ROADMAP queue 1 item 6: nn "
            "core)")
    return _UPDATER_REGISTRY[t](**d)


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

    def to_dict(self):
        d = {k: v for k, v in asdict(self).items() if v is not None}
        d["type"] = type(self).__name__
        return d


@register_updater
@dataclass
class Sgd(BaseUpdater):
    def optimizer(self, tensors):
        return torch.optim.SGD(tensors, lr=self.schedule()(0))


@register_updater
@dataclass
class Nesterovs(BaseUpdater):
    """SGD with Nesterov momentum."""
    momentum: float = 0.9
    momentum_schedule: dict | None = None

    def optimizer(self, tensors):
        if self.momentum_schedule:
            raise NotImplementedError(
                "momentum schedules are not ported yet (ROADMAP queue 1: nn "
                "core); a fixed momentum is")
        return torch.optim.SGD(tensors, lr=self.schedule()(0),
                               momentum=self.momentum, nesterov=True,
                               dampening=0.0)


@register_updater
@dataclass
class Adam(BaseUpdater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def optimizer(self, tensors):
        """On the card the optimizer is built capturable (its step count
        a device tensor, the bias corrections computed on the device), so
        an eager step and a CUDA graph's replay of it run one arithmetic;
        on the host it is the plain `torch.optim.Adam`."""
        return torch.optim.Adam(tensors, lr=self.schedule()(0),
                                betas=(self.beta1, self.beta2),
                                eps=self.epsilon,
                                capturable=tensors[0].is_cuda)


def layer_transform(layer_conf):
    """The updater of one layer conf: its own, or the reference's default
    plain Sgd(0.1) when none is set."""
    return layer_conf.updater if layer_conf.updater is not None \
        else Sgd(learning_rate=0.1)


class PerLayerOptimizer:
    """One optimizer per layer (`per_layer_transform`): `step(grads)`
    updates params[name] in place from grads[name] with layer `name`'s
    updater, at the learning rate its schedule gives this step. `count`
    is the number of steps taken: `step` adds one, and a CUDA graph that
    replays n captured steps adds n (nn/multistep.py)."""

    def __init__(self, updaters: dict, params: dict):
        self._layers = {}
        # every layer's rate and momentum fixed: only then can a CUDA
        # graph capture a step (it keeps the rate it was captured with)
        self.fixed = True
        for name, ps in params.items():
            if ps:
                upd = updaters[name]
                self._layers[name] = (upd.schedule(), dict(ps),
                                      upd.optimizer(list(ps.values())))
                self.fixed &= upd.lr_policy in (None, "none", "fixed") \
                    and not getattr(upd, "momentum_schedule", None)
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


def _layer_leaf_plan(net):
    """[(layer name, updater, sorted param keys)] in the order of the
    optax state's leaves: `per_layer_transform`'s state is a dict keyed by
    layer name, which `tree_leaves` walks in sorted string order ("10"
    before "2"); a layer's params are walked in sorted key order. A layer
    without an updater (optax.sgd at a fixed float rate) holds no
    leaves."""
    plan = []
    for name in sorted(net.params):
        upd = net.layer_confs[name].updater
        if upd is None:
            continue
        if not isinstance(upd, (Sgd, Nesterovs, Adam)):
            raise NotImplementedError(
                f"updater {type(upd).__name__}'s state is not ported yet "
                "(ROADMAP queue 1 item 6: nn core)")
        if isinstance(upd, Nesterovs) and upd.momentum_schedule:
            raise NotImplementedError(
                "the state of a momentum schedule (optax inject_hyperparams) "
                "is not ported yet (ROADMAP queue 1 item 6: nn core)")
        plan.append((name, upd, sorted(net.params[name])))
    return plan


def opt_state_leaves(net):
    """The model's optimizer state as the leaves of the JAX package's optax
    state, in `jax.tree_util.tree_leaves` order (numpy arrays; the
    `leaf{i}` entries of `updaterState.bin`). Per layer, in
    `_layer_leaf_plan` order:

    - Sgd: `ScaleByScheduleState(count)`;
    - Nesterovs: `TraceState(trace)` (one leaf per param: torch's momentum
      buffer, zeros before the first step), then the schedule's count;
    - Adam: `ScaleByAdamState(count, mu, nu)` (torch's step, exp_avg and
      exp_avg_sq per param; zeros before the first step), then the
      schedule's count.

    A count is an int32 scalar. A layer without params keeps its counts
    (optax steps every layer); the port's optimizer count stands in for
    them there and for every schedule count."""
    opt = net._optimizer
    steps = np.asarray(opt.count, np.int32)
    leaves = []
    for name, upd, keys in _layer_leaf_plan(net):
        entry = opt._layers.get(name)
        states = [entry[2].state.get(net.params[name][k], {}) if entry
                  else {} for k in keys]

        def buf(st, key, k):
            t = st.get(key)
            return (np.zeros(tuple(net.params[name][k].shape), np.float32)
                    if t is None else t.detach().cpu().numpy().copy())

        if isinstance(upd, Adam):
            count = next((int(st["step"]) for st in states if "step" in st),
                         int(opt.count) if not keys else 0)
            leaves.append(np.asarray(count, np.int32))
            leaves += [buf(st, "exp_avg", k) for st, k in zip(states, keys)]
            leaves += [buf(st, "exp_avg_sq", k)
                       for st, k in zip(states, keys)]
        elif isinstance(upd, Nesterovs):
            leaves += [buf(st, "momentum_buffer", k)
                       for st, k in zip(states, keys)]
        leaves.append(steps.copy())
    return leaves


def load_opt_state_leaves(net, leaves):
    """Write `opt_state_leaves`-ordered leaves (a JAX optax state's
    `tree_leaves`) into the model's per-layer torch optimizers. Returns
    False, changing nothing, when their number is not the model's (the
    JAX serializer then keeps the fresh state, model_serializer.py:
    208-212). A zero count leaves a layer's state empty (as before its
    first step); captured K-step graphs go stale."""
    plan = _layer_leaf_plan(net)
    want = sum(1 + (2 * len(keys) + 1 if isinstance(upd, Adam) else
                    len(keys) if isinstance(upd, Nesterovs) else 0)
               for _, upd, keys in plan)
    if len(leaves) != want:
        return False
    opt = net._optimizer
    it = iter(leaves)
    counts = []
    for name, upd, keys in plan:
        entry = opt._layers.get(name)
        tensors = [net.params[name][k] for k in keys]
        if isinstance(upd, Adam):
            count = int(np.asarray(next(it)))
            mus = [next(it) for _ in keys]
            nus = [next(it) for _ in keys]
            for t, mu, nu in zip(tensors, mus, nus):
                entry[2].state.pop(t, None)
                if count:
                    cap = entry[2].defaults.get("capturable", False)
                    entry[2].state[t] = {
                        "step": torch.tensor(
                            float(count), dtype=torch.float32,
                            device=t.device if cap else "cpu"),
                        "exp_avg": torch.as_tensor(np.asarray(mu)).to(t),
                        "exp_avg_sq": torch.as_tensor(np.asarray(nu)).to(t)}
        elif isinstance(upd, Nesterovs):
            traces = [next(it) for _ in keys]
            for t, tr in zip(tensors, traces):
                entry[2].state.pop(t, None)
                entry[2].state[t] = {"momentum_buffer":
                                     torch.as_tensor(np.asarray(tr)).to(t)}
        counts.append(int(np.asarray(next(it))))
    opt.count = max(counts, default=opt.count)
    net._graph_epoch += 1
    return True


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
