"""A fitted normalizer as torch ops on a device (the `lower_normalizer`
part of deeplearning4j_tpu/etl/device_transform.py; its TransformProcess
lowering and DeviceIngest wait for the rest of etl, ROADMAP queue 1 item
9).

The serving batcher runs the version's normalizer through it on the
model's device, so /predict ships the request's bytes as they are and the
widening affine runs on the card, not as a host numpy pass.
"""
from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.device import resolve_device


def lower_normalizer(normalizer, labels=False, device=None):
    """(apply, revert) over a FITTED normalizer's float32 affine stats on
    `device` (the card unless the caller passes `device="cpu"`):
    `apply(x) = (x - sub) / div * scale + add` and its inverse,
    the host formulas in the same order, so host and device agree to
    float32 rounding. Each takes a numpy array or a tensor (moved to
    `device`, cast to float32) and returns a float32 tensor there."""
    device = resolve_device(device)
    sub, div, scale, add = (torch.as_tensor(v, dtype=torch.float32).to(device)
                            for v in normalizer.device_stats(labels=labels))

    def f32(x):
        return torch.as_tensor(x).to(device, torch.float32)

    def apply(x):
        return (f32(x) - sub) / div * scale + add

    def revert(y):
        return (f32(y) - add) / scale * div + sub

    return apply, revert
