"""ActivationLayer and DropoutLayer (counterpart of
deeplearning4j_tpu/nn/layers/misc.py)."""
from __future__ import annotations

from .base import BaseLayerModule, register_impl, apply_dropout


@register_impl("ActivationLayer")
class ActivationLayerModule(BaseLayerModule):
    def forward(self, params, state, x, *, train=False, rng=None,
                mask=None):
        return self.activation_fn()(x), state, mask


@register_impl("DropoutLayer")
class DropoutLayerModule(BaseLayerModule):
    """Dropout as a layer of its own: the layer's `dropout` rate on its
    input in training, the input itself at inference."""

    def forward(self, params, state, x, *, train=False, rng=None,
                mask=None):
        return apply_dropout(x, self.conf.dropout, train, rng), state, mask
