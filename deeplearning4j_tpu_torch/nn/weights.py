"""Weight initialization (counterpart of deeplearning4j_tpu/nn/weights.py).

Draws come from an explicit `torch.Generator`; they never match JAX's
threefry stream, so weights cross between the packages through
`util/params.py`, not through init."""
from __future__ import annotations

import math

import torch

from ..device import resolve_device


class WeightInit:
    XAVIER = "xavier"
    XAVIER_LEGACY = "xavier_legacy"
    RELU = "relu"
    RELU_UNIFORM = "relu_uniform"
    UNIFORM = "uniform"


def init_weights(generator, shape, scheme=WeightInit.XAVIER, fan_in=None,
                 fan_out=None, dtype=torch.float32, device=None):
    """Xavier-normal weights, N(0, 2 / (fan_in + fan_out)); "relu" is
    N(0, 2 / fan_in), "relu_uniform" U(-a, a) with a = sqrt(6 / fan_in)
    and "uniform" U(-a, a) with a = 1 / sqrt(fan_in). The draw runs on
    the host generator and the result moves to `device` (the card unless
    the caller passes "cpu")."""
    shape = tuple(int(s) for s in shape)
    if fan_in is None or fan_out is None:
        fan_out_d, fan_in_d = shape if len(shape) == 2 else (shape[0],) * 2
        fan_in = fan_in if fan_in is not None else fan_in_d
        fan_out = fan_out if fan_out is not None else fan_out_d
    fan_in, fan_out = max(float(fan_in), 1.0), max(float(fan_out), 1.0)
    s = str(scheme).lower()
    if s in (WeightInit.XAVIER, WeightInit.XAVIER_LEGACY):
        w = torch.randn(shape, generator=generator, dtype=dtype) \
            * math.sqrt(2.0 / (fan_in + fan_out))
    elif s == WeightInit.RELU:
        w = torch.randn(shape, generator=generator, dtype=dtype) \
            * math.sqrt(2.0 / fan_in)
    elif s == WeightInit.RELU_UNIFORM:
        a = math.sqrt(6.0 / fan_in)
        w = torch.rand(shape, generator=generator, dtype=dtype) * (2 * a) - a
    elif s == WeightInit.UNIFORM:
        a = 1.0 / math.sqrt(fan_in)
        w = torch.rand(shape, generator=generator, dtype=dtype) * (2 * a) - a
    elif s == "distribution":
        raise NotImplementedError(
            "weight init 'distribution' (the conf's `dist`) is not ported "
            "yet (ROADMAP queue 1 item 6: nn core)")
    else:
        raise NotImplementedError(
            f"weight init {scheme!r} is not ported yet (ROADMAP queue 1)")
    return w.to(resolve_device(device))
