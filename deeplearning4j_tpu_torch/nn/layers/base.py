"""Runtime layer SPI (counterpart of deeplearning4j_tpu/nn/layers/base.py).

A layer is a plain object holding its config. Parameters live outside it,
in a `{name: tensor}` dict per layer, so the port's parameter tree has the
same keys as the JAX package's and crosses over by name
(util/params.py). `forward(params, x, mask=...)` returns
`(activations, mask)`; masks are [batch, time] validity."""
from __future__ import annotations

import torch

from ..activations import get_activation
from ...device import bf16_product, resolve_device
from ..weights import init_weights

LAYER_IMPL_REGISTRY: dict = {}


def register_impl(conf_cls_name):
    def deco(cls):
        LAYER_IMPL_REGISTRY[conf_cls_name] = cls
        return cls
    return deco


def create_layer(conf):
    cls = LAYER_IMPL_REGISTRY.get(type(conf).__name__)
    if cls is None:
        raise ValueError(f"No runtime implementation for layer config "
                         f"{type(conf).__name__}")
    return cls(conf)


def apply_dropout(x, rate, train):
    """Dropout on the layer input: a no-op at inference and at rate 0.
    A rate above 0 during training raises: training-time dropout (with
    injected masks for the parity tests) is not ported yet."""
    if not train or rate is None or rate <= 0.0:
        return x
    raise NotImplementedError(
        "training-time dropout is not ported yet (ROADMAP queue 1: "
        "training-time dropout)")


def matmul(x, w):
    """x @ w with the JAX package's type promotion: a bfloat16 operand
    meeting a float32 one is widened to float32 first (torch's matmul
    takes one type). This is where a masked bf16 batch, promoted to f32 by
    the attention layer's mask, meets the next layer's bf16 kernels. A
    bf16 product rounds once (`device.bf16_product`)."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return bf16_product(torch.matmul, x, w)


class BaseLayerModule:
    """One instantiated layer: parameter shapes, init and forward."""

    def __init__(self, conf):
        self.conf = conf

    def param_specs(self):
        """{key: (shape, kind)} with kind "weight" (xavier, fan from the
        shape), "bias" (bias_init), "ones" or "zeros"."""
        raise NotImplementedError

    def init(self, generator, dtype=torch.float32, device=None):
        """Fresh parameters on `device` (the card unless "cpu")."""
        device = resolve_device(device)
        params = {}
        for key, (shape, kind) in self.param_specs().items():
            if kind == "weight":
                params[key] = init_weights(
                    generator, shape, self.conf.weight_init, fan_in=shape[0],
                    fan_out=shape[1], dtype=dtype, device=device)
            elif kind == "bias":
                params[key] = torch.full(shape, float(self.conf.bias_init
                                                      or 0.0),
                                         dtype=dtype, device=device)
            elif kind == "ones":
                params[key] = torch.ones(shape, dtype=dtype, device=device)
            else:
                params[key] = torch.zeros(shape, dtype=dtype, device=device)
        return params

    def forward(self, params, x, *, train=False, mask=None):
        raise NotImplementedError

    def is_output_layer(self):
        return False

    def activation_fn(self):
        return get_activation(self.conf.activation or "identity")
