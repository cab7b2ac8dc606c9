"""ActivationLayer (counterpart of deeplearning4j_tpu/nn/layers/misc.py;
DropoutLayer comes with training-time dropout)."""
from __future__ import annotations

from .base import BaseLayerModule, register_impl


@register_impl("ActivationLayer")
class ActivationLayerModule(BaseLayerModule):
    def forward(self, params, state, x, *, train=False, mask=None):
        return self.activation_fn()(x), state, mask
