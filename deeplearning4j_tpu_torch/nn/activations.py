"""Activation functions looked up by name (counterpart of
deeplearning4j_tpu/nn/activations.py; the names the ported layers use)."""
from __future__ import annotations

import torch

_REGISTRY: dict = {}


def register_activation(name):
    def deco(fn):
        _REGISTRY[name.lower()] = fn
        return fn
    return deco


def get_activation(name):
    """Resolve an activation by name (case-insensitive) or pass a callable
    through."""
    if callable(name):
        return name
    key = str(name).lower()
    if key not in _REGISTRY:
        raise ValueError(f"Unknown activation '{name}'. Known: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key]


@register_activation("identity")
@register_activation("linear")
def identity(x):
    return x


@register_activation("relu")
def relu(x):
    return torch.relu(x)


@register_activation("tanh")
def tanh(x):
    return torch.tanh(x)


@register_activation("sigmoid")
def sigmoid(x):
    return torch.sigmoid(x)


@register_activation("softmax")
def softmax(x):
    return torch.softmax(x, dim=-1)
