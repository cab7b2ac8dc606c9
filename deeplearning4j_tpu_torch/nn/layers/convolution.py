"""Normalization layers (counterpart of
deeplearning4j_tpu/nn/layers/convolution.py; LayerNormalization only)."""
from __future__ import annotations

import torch

from .base import BaseLayerModule, register_impl


@register_impl("LayerNormalization")
class LayerNormalizationModule(BaseLayerModule):
    """Layer norm over the last axis: biased variance, eps inside
    rsqrt(var + eps), as in the JAX package."""

    def param_specs(self):
        n = int(self.conf.n_in)
        return {"gamma": ((n,), "ones"), "beta": ((n,), "zeros")}

    def forward(self, params, x, *, train=False, mask=None):
        mu = x.mean(dim=-1, keepdim=True)
        var = torch.square(x - mu).mean(dim=-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + self.conf.eps)
        y = y * params["gamma"] + params["beta"]
        return self.activation_fn()(y), mask
