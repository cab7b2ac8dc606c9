"""Convolution family and normalization layers (counterpart of
deeplearning4j_tpu/nn/layers/convolution.py): Conv2D, Subsampling
(pooling), ZeroPadding, LocalResponseNormalization, BatchNormalization,
GlobalPooling and LayerNormalization.

Layout as in the JAX package: NHWC activations, HWIO kernels, so
parameters cross between the packages by name and shape. A convolution
views its NHWC input as NCHW (`permute(0, 3, 1, 2)`, no copy: an NCHW
tensor in channels_last memory, which cuDNN's NHWC kernels take) and its
kernel as OIHW (`permute(3, 2, 0, 1)`, which `F.conv2d` copies once a
call). The JAX package runs these layers on XLA's own lowerings
(`lax.conv_general_dilated`, `lax.reduce_window`), so nothing here is a
hand kernel: they run on torch's convolution, pooling and elementwise
ops. XLA's "SAME" padding puts the odd pixel after, so "same" pads
explicitly: `total // 2` before, the rest after (torch's own "same"
refuses strides above 1)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...device import bf16_product
from .base import BaseLayerModule, register_impl, apply_dropout


def _pair(v):
    return int(v[0]), int(v[1])


def same_pads(size, kernel, stride, dilation=1):
    """(before, after) padding of XLA's "SAME" on one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (kernel - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def _window_pads(conf, x, dilation=(1, 1)):
    """(top, bottom, left, right) padding of a window layer on NHWC x."""
    kh, kw = _pair(conf.kernel_size)
    if conf.convolution_mode == "same":
        sh, sw = _pair(conf.stride)
        return (*same_pads(x.shape[1], kh, sh, dilation[0]),
                *same_pads(x.shape[2], kw, sw, dilation[1]))
    ph, pw = _pair(conf.padding)
    return ph, ph, pw, pw


def _pad_nhwc(x, pads, value=0.0):
    top, bottom, left, right = pads
    if not any(pads):
        return x
    return F.pad(x, (0, 0, left, right, top, bottom), value=value)


@register_impl("ConvolutionLayer")
class ConvolutionLayerModule(BaseLayerModule):
    def param_specs(self):
        c = self.conf
        kh, kw = _pair(c.kernel_size)
        specs = {"W": ((kh, kw, int(c.n_in), int(c.n_out)), "weight")}
        if c.has_bias:
            specs["b"] = ((int(c.n_out),), "bias")
        return specs

    def preoutput(self, params, x):
        c = self.conf
        w = params["W"]
        if x.dtype != w.dtype:
            dt = torch.promote_types(x.dtype, w.dtype)
            x, w = x.to(dt), w.to(dt)
        dilation = _pair(c.dilation)
        top, bottom, left, right = _window_pads(c, x, dilation)
        if (top, left) == (bottom, right):
            padding = (top, left)
        else:
            x, padding = _pad_nhwc(x, (top, bottom, left, right)), (0, 0)

        def conv(a, b):
            return F.conv2d(a.permute(0, 3, 1, 2), b.permute(3, 2, 0, 1),
                            stride=_pair(c.stride), padding=padding,
                            dilation=dilation).permute(0, 2, 3, 1)
        z = bf16_product(conv, x, w)
        if "b" in params:
            z = z + params["b"]
        return z

    def forward(self, params, state, x, *, train=False, rng=None,
                mask=None):
        x = apply_dropout(x, self.conf.dropout, train, rng)
        return self.activation_fn()(self.preoutput(params, x)), state, mask


@register_impl("SubsamplingLayer")
class SubsamplingLayerModule(BaseLayerModule):
    """max pads with -inf; avg sums the window, zero pads included, and
    divides by kh·kw; sum; pnorm (Σ|x|^p)^(1/p)."""

    def forward(self, params, state, x, *, train=False, rng=None,
                mask=None):
        c = self.conf
        kernel, stride = _pair(c.kernel_size), _pair(c.stride)
        pads = _window_pads(c, x)
        pt = c.pooling_type
        if pt == "max":
            xn = _pad_nhwc(x, pads, float("-inf")).permute(0, 3, 1, 2)
            y = F.max_pool2d(xn, kernel, stride)
        elif pt in ("avg", "sum", "pnorm"):
            if pt == "pnorm":
                p = float(c.pnorm)
                x = torch.abs(x) ** p
            xn = _pad_nhwc(x, pads).permute(0, 3, 1, 2)
            y = F.avg_pool2d(xn, kernel, stride, divisor_override=1)
            if pt == "avg":
                y = y / (kernel[0] * kernel[1])
            elif pt == "pnorm":
                y = y ** (1.0 / p)
        else:
            raise ValueError(f"Unknown pooling type {pt}")
        return y.permute(0, 2, 3, 1), state, mask


@register_impl("ZeroPaddingLayer")
class ZeroPaddingLayerModule(BaseLayerModule):
    def forward(self, params, state, x, *, train=False, rng=None,
                mask=None):
        c = self.conf
        return (_pad_nhwc(x, (c.pad_top, c.pad_bottom, c.pad_left,
                              c.pad_right)), state, mask)


@register_impl("LocalResponseNormalization")
class LocalResponseNormalizationModule(BaseLayerModule):
    """Cross-channel LRN on NHWC: x / (k + alpha · Σ x²)^beta, the sum over
    a window of n channels padded (n // 2, n − 1 − n // 2)."""

    def forward(self, params, state, x, *, train=False, rng=None,
                mask=None):
        c = self.conf
        n = int(c.n)
        half = n // 2
        sq = F.pad(x * x, (half, n - 1 - half))
        win = sq.unfold(-1, n, 1).sum(dim=-1)
        return x / (c.k + c.alpha * win) ** c.beta, state, mask


@register_impl("LayerNormalization")
class LayerNormalizationModule(BaseLayerModule):
    """Layer norm over the last axis: biased variance, eps inside
    rsqrt(var + eps), as in the JAX package."""

    def param_specs(self):
        n = int(self.conf.n_in)
        return {"gamma": ((n,), "ones"), "beta": ((n,), "zeros")}

    def forward(self, params, state, x, *, train=False, rng=None,
                mask=None):
        mu = x.mean(dim=-1, keepdim=True)
        var = torch.square(x - mu).mean(dim=-1, keepdim=True)
        # JAX adds eps as a weakly typed scalar: it takes var's type first
        eps = float(torch.tensor(self.conf.eps, dtype=var.dtype))
        y = (x - mu) * torch.rsqrt(var + eps)
        y = y * params["gamma"] + params["beta"]
        return self.activation_fn()(y), state, mask


@register_impl("BatchNormalization")
class BatchNormalizationModule(BaseLayerModule):
    """Batch norm over the channel (last) axis of NHWC or the feature axis
    of [b, f], the running mean and variance in the layer state
    (`decay · old + (1 − decay) · batch`, the batch variance biased).

    The statistics accumulate in the state's type (float32 under bf16
    compute) and the per-element normalization `x · scale + shift` runs in
    the input's type, scale and shift computed in the state's type and
    cast. Full precision takes the two-pass variance mean((x − mean)²);
    mixed precision the one-pass shifted variance E[(x − μ₀)²] − (mean −
    μ₀)², clamped at 0, with μ₀ the mean (no gradient) of the strided
    subsample x[:, ::max(1, H // 8), ::max(1, W // 8)], as the JAX package
    computes them. Not `F.batch_norm`: it updates the running variance with
    the unbiased variance and normalizes bf16 input in float32."""

    def param_specs(self):
        c = self.conf
        if c.lock_gamma_beta:
            return {}
        n = int(c.n_in)
        return {"gamma": ((n,), float(c.gamma)),
                "beta": ((n,), float(c.beta))}

    def state_specs(self):
        n = int(self.conf.n_in)
        return {"mean": ((n,), "zeros"), "var": ((n,), "ones")}

    def forward(self, params, state, x, *, train=False, rng=None,
                mask=None):
        c = self.conf
        axes = tuple(range(x.dim() - 1))
        in_dt, stat_dt = x.dtype, state["mean"].dtype
        if train:
            mean = torch.mean(x, dim=axes, dtype=stat_dt)
            if in_dt == stat_dt:
                var = torch.mean(torch.square(x - mean), dim=axes)
            else:
                sub = x[(slice(None),) + tuple(
                    slice(None, None, max(1, x.shape[a] // 8))
                    for a in range(1, x.dim() - 1))].detach()
                mu0 = torch.mean(sub, dim=axes, dtype=stat_dt)
                d = x.to(stat_dt) - mu0
                ex2c = torch.mean(torch.square(d), dim=axes)
                var = torch.clamp(ex2c - torch.square(mean - mu0), min=0.0)
            decay = c.decay
            new_state = {"mean": decay * state["mean"] + (1 - decay) * mean,
                         "var": decay * state["var"] + (1 - decay) * var}
        else:
            mean, var = state["mean"], state["var"]
            new_state = state
        inv = torch.rsqrt(var + c.eps)
        if "gamma" in params:
            scale = params["gamma"].to(stat_dt) * inv
            shift = params["beta"].to(stat_dt) - mean * scale
        else:
            scale = c.gamma * inv
            shift = c.beta - mean * scale
        y = x * scale.to(in_dt) + shift.to(in_dt)
        return self.activation_fn()(y), new_state, mask


@register_impl("GlobalPoolingLayer")
class GlobalPoolingLayerModule(BaseLayerModule):
    """Pooling over time ([b, t, f] -> [b, f], with the [b, t] mask when
    one is given) or over space ([b, h, w, c] -> [b, c]); the mask ends
    here."""

    def forward(self, params, state, x, *, train=False, rng=None,
                mask=None):
        c = self.conf
        pt = c.pooling_type
        p = float(c.pnorm)
        if x.dim() == 3:
            if mask is not None:
                m = mask[:, :, None].to(x.dtype)
                if pt == "max":
                    y = torch.where(m > 0, x, float("-inf")).amax(dim=1)
                elif pt == "sum":
                    y = torch.sum(x * m, dim=1)
                elif pt == "avg":
                    y = torch.sum(x * m, dim=1) / torch.clamp(
                        torch.sum(m, dim=1), min=1.0)
                elif pt == "pnorm":
                    y = torch.sum((torch.abs(x) * m) ** p, dim=1) ** (1.0 / p)
                else:
                    raise ValueError(pt)
                return y, state, None
            axis = (1,)
        elif x.dim() == 4:
            axis = (1, 2)
        else:
            raise ValueError("GlobalPooling expects rank-3 or rank-4 input, "
                             f"got {tuple(x.shape)}")
        if pt == "max":
            y = x.amax(dim=axis)
        elif pt == "avg":
            # a low-precision mean sums in float32 and rounds once, as jnp's
            y = torch.mean(x, dim=axis, dtype=torch.promote_types(
                x.dtype, torch.float32)).to(x.dtype)
        elif pt == "sum":
            y = torch.sum(x, dim=axis)
        elif pt == "pnorm":
            y = torch.sum(torch.abs(x) ** p, dim=axis) ** (1.0 / p)
        else:
            raise ValueError(pt)
        return y, state, None
