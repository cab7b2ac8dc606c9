"""Dense and per-timestep output layers (counterpart of
deeplearning4j_tpu/nn/layers/feedforward.py). Kernels are stored
[n_in, n_out] and applied as `x @ W + b`, the JAX package's layout; the
products stay `torch.matmul` (`base.matmul`, with the JAX type
promotion), as the JAX package left them to XLA. An
output layer also scores: its loss on the features feeding it."""
from __future__ import annotations

from ..losses import get_loss
from .base import BaseLayerModule, register_impl, apply_dropout, matmul


class _DenseCore(BaseLayerModule):
    def param_specs(self):
        n_in, n_out = int(self.conf.n_in), int(self.conf.n_out)
        return {"W": ((n_in, n_out), "weight"), "b": ((n_out,), "bias")}

    def preoutput(self, params, x):
        return matmul(x, params["W"]) + params["b"]

    def forward(self, params, x, *, train=False, mask=None):
        x = apply_dropout(x, self.conf.dropout, train)
        return self.activation_fn()(self.preoutput(params, x)), mask


@register_impl("DenseLayer")
class DenseLayerModule(_DenseCore):
    pass


class BaseOutputLayerModule(_DenseCore):
    """Dense + integrated loss (reference: BaseOutputLayer.java)."""

    def is_output_layer(self):
        return True

    def loss_fn(self):
        return get_loss(self.conf.loss)

    def score(self, params, x, labels, mask=None, train=False):
        x = apply_dropout(x, self.conf.dropout, train)
        z = self.preoutput(params, x)
        return self.loss_fn()(labels, z, self.conf.activation, mask)


@register_impl("RnnOutputLayer")
class RnnOutputLayerModule(BaseOutputLayerModule):
    """Dense projection + activation per timestep on [b, t, f]; the loss
    runs on the [b*t] positions with a per-position mask."""

    def forward(self, params, x, *, train=False, mask=None):
        return self.activation_fn()(self.preoutput(params, x)), mask

    def score(self, params, x, labels, mask=None, train=False):
        z = self.preoutput(params, x)
        b, t = z.shape[0], z.shape[1]
        m2 = mask.reshape(b * t) if mask is not None else None
        return self.loss_fn()(labels.reshape(b * t, -1), z.reshape(b * t, -1),
                              self.conf.activation, m2)
