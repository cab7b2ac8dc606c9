"""Loss functions with mask support (counterpart of
deeplearning4j_tpu/nn/losses.py; `LossMCXENT` only — the other losses are
ROADMAP queue 1, nn core).

A loss is a function (labels, preoutput, activation, mask) -> scalar mean
score. Gradients come from torch autograd of the activation + loss
composition, as the JAX package takes them from jax.grad.
"""
from __future__ import annotations

import torch

from .activations import get_activation

_EPS = 1e-10

_REGISTRY: dict = {}


def register_loss(name):
    def deco(cls):
        _REGISTRY[name.upper()] = cls
        return cls
    return deco


def get_loss(name):
    """A loss instance by name (case-insensitive), or the instance given."""
    if isinstance(name, BaseLoss):
        return name
    key = str(name).upper()
    if key not in _REGISTRY:
        raise ValueError(f"Unknown loss '{name}'. Known: {sorted(_REGISTRY)}"
                         " (the JAX package's other losses are ROADMAP "
                         "queue 1, nn core)")
    return _REGISTRY[key]()


def _masked_score(per_elem, mask):
    """per_elem: [batch, features...] element-wise loss; returns the mean
    over the batch of the summed feature loss, honouring an optional
    [batch]- or element-shaped mask (the JAX package's `_masked_score`
    with its summed features, the only form the ported losses use)."""
    b = per_elem.shape[0]
    flat = per_elem.reshape(b, -1)
    if mask is None:
        return flat.sum(dim=-1).mean()
    mask = torch.as_tensor(mask, device=per_elem.device).to(per_elem.dtype)
    if mask.dim() == 1:
        return (flat.sum(dim=-1) * mask).sum() / torch.clamp(mask.sum(),
                                                             min=1.0)
    if mask.dim() >= 2 and tuple(mask.shape) == tuple(per_elem.shape[:-1]):
        # per-position mask (e.g. [b, t] over [b, t, c]): average over the
        # active positions, matching the RnnOutputLayer reshape semantics
        pos = per_elem.sum(dim=-1)
        return (pos * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    bmask = (torch.broadcast_to(mask.reshape(b, -1), flat.shape)
             if mask.numel() != flat.numel() else mask.reshape(b, -1))
    # number of active examples = rows with any active element
    row_active = bmask.amax(dim=-1)
    return (flat * bmask).sum() / torch.clamp(row_active.sum(), min=1.0)


class BaseLoss:
    """Loss SPI: score(labels, preoutput, activation, mask) -> scalar."""

    def score(self, labels, preoutput, activation="identity", mask=None):
        raise NotImplementedError

    def __call__(self, labels, preoutput, activation="identity", mask=None):
        return self.score(labels, preoutput, activation, mask)


@register_loss("MCXENT")
@register_loss("NEGATIVELOGLIKELIHOOD")
class LossMCXENT(BaseLoss):
    """Multi-class cross entropy. With the softmax activation the
    composition is computed through log_softmax, for stability."""

    def score(self, labels, preoutput, activation="softmax", mask=None):
        act_name = activation if isinstance(activation, str) \
            else getattr(activation, "__name__", "")
        if str(act_name).lower() == "softmax":
            logp = torch.log_softmax(preoutput, dim=-1)
        else:
            out = get_activation(activation)(preoutput)
            logp = torch.log(torch.clamp(out, min=_EPS))
        return _masked_score(-labels * logp, mask)
