"""Device placement: the card by default, the host only when asked."""
from __future__ import annotations

import torch


def resolve_device(device=None):
    """`torch.device` for an entry point's `device` argument.

    None means the CUDA card. Asking for the card (explicitly or by
    default) without one visible raises instead of running on the host:
    a caller that wants the CPU says `device="cpu"`."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible to torch; pass device='cpu' to run "
            "on the host")
    return dev
