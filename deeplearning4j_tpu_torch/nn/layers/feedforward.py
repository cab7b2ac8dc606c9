"""Dense and per-timestep output layers, forward only (counterpart of
deeplearning4j_tpu/nn/layers/feedforward.py). Kernels are stored
[n_in, n_out] and applied as `x @ W + b`, the JAX package's layout; the
products stay `torch.matmul`, as the JAX package left them to XLA."""
from __future__ import annotations

from .base import BaseLayerModule, register_impl, apply_dropout


class _DenseCore(BaseLayerModule):
    def param_specs(self):
        n_in, n_out = int(self.conf.n_in), int(self.conf.n_out)
        return {"W": ((n_in, n_out), "weight"), "b": ((n_out,), "bias")}

    def preoutput(self, params, x):
        return x @ params["W"] + params["b"]

    def forward(self, params, x, *, train=False, mask=None):
        x = apply_dropout(x, self.conf.dropout, train)
        return self.activation_fn()(self.preoutput(params, x)), mask


@register_impl("DenseLayer")
class DenseLayerModule(_DenseCore):
    pass


@register_impl("RnnOutputLayer")
class RnnOutputLayerModule(_DenseCore):
    """Dense projection + activation per timestep on [b, t, f]; the loss
    half waits for the training slice."""

    def forward(self, params, x, *, train=False, mask=None):
        return self.activation_fn()(self.preoutput(params, x)), mask
