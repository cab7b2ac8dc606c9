"""Runtime layer SPI (counterpart of deeplearning4j_tpu/nn/layers/base.py).

A layer is a plain object holding its config. Parameters live outside it,
in a `{name: tensor}` dict per layer, and so does its state (the
non-trainable variables, such as batch norm's running mean and
variance), so the port's trees have the same keys as the JAX package's and
cross over by name (util/params.py). `init` gives `(params, state)`;
`forward(params, state, x, train=..., mask=...)` returns `(activations,
new_state, mask)`, a stateless layer its empty state unchanged; masks are
[batch, time] validity."""
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
        """{key: (shape, kind)} with kind "weight" (the conf's weight init,
        fans from the shape: [n_in, n_out] or an HWIO kernel's kh·kw·I and
        kh·kw·O), "bias" (bias_init), "ones", "zeros" or a float fill."""
        return {}

    def state_specs(self):
        """{key: (shape, kind)} of the layer state, kinds as for
        parameters; stateless layers have none."""
        return {}

    def make(self, specs, generator, dtype, device):
        """{key: tensor} on `device` for {key: (shape, kind)} specs."""
        out = {}
        for key, (shape, kind) in specs.items():
            if kind == "weight":
                fan_in, fan_out = shape[0], shape[1]
                if len(shape) == 4:
                    fan_in = shape[0] * shape[1] * shape[2]
                    fan_out = shape[0] * shape[1] * shape[3]
                out[key] = init_weights(
                    generator, shape, self.conf.weight_init, fan_in=fan_in,
                    fan_out=fan_out, dtype=dtype, device=device)
                continue
            fill = {"bias": float(self.conf.bias_init or 0.0), "ones": 1.0,
                    "zeros": 0.0}.get(kind, kind)
            out[key] = torch.full(shape, float(fill), dtype=dtype,
                                  device=device)
        return out

    def init(self, generator, dtype=torch.float32, device=None):
        """Fresh (params, state) on `device` (the card unless "cpu")."""
        device = resolve_device(device)
        return (self.make(self.param_specs(), generator, dtype, device),
                self.make(self.state_specs(), generator, dtype, device))

    def forward(self, params, state, x, *, train=False, mask=None):
        """(activations, new state, mask)."""
        raise NotImplementedError

    def is_output_layer(self):
        return False

    def activation_fn(self):
        return get_activation(self.conf.activation or "identity")
