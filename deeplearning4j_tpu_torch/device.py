"""Device placement: the card by default, the host only when asked; how
a bf16 product rounds on each; and a tensor's way back to the host."""
from __future__ import annotations

import numpy as np
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
    """fn(a, b) for a product `fn` (a matmul, an einsum or a convolution)
    such that bf16 operands accumulate in float32 and round once, as XLA's,
    cuBLAS's and cuDNN's bf16 products do. On the card that is the native
    bf16 kernel; on the host, where torch's bf16 kernels round otherwise,
    fn runs on the float32 operands and its result is rounded after."""
    if a.dtype == b.dtype == torch.bfloat16 and a.device.type == "cpu":
        return fn(a.float(), b.float()).to(torch.bfloat16)
    return fn(a, b)


def host(a, dtype=None):
    """A numpy array of `a` (a tensor is detached and copied to the host),
    in `dtype` if one is given."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a) if dtype is None else np.asarray(a, dtype)
