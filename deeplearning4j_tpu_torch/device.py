"""Device placement: the card by default, the host only when asked; and
how a bf16 product rounds on each."""
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


def bf16_product(fn, a, b):
    """fn(a, b) for a product `fn` (a matmul or an einsum) such that bf16
    operands accumulate in float32 and round once, as XLA's and cuBLAS's
    bf16 products do. On the card that is the native bf16 kernel; on the
    host, where torch's bf16 kernel rounds otherwise, fn runs on the
    float32 operands and its result is rounded after."""
    if a.dtype == b.dtype == torch.bfloat16 and a.device.type == "cpu":
        return fn(a.float(), b.float()).to(torch.bfloat16)
    return fn(a, b)
