"""Attention kernels for Hopper, the port of
deeplearning4j_tpu/kernels/flash_attention.py.

Two entry points, each a wrapper around a hand-written CUDA kernel with
its plain PyTorch version beside it:

- `flash_attention` -> `csrc/flash_fwd.cu`, replacing the TPU kernel
  `_flash_kernel` (flash_attention.py:84-143, `pl.pallas_call` at :206) as
  `flash_attention` (:512) runs it: the decode prefill's causal, key-masked
  attention. Plain version: `flash_attention_plain`.
- `flash_decode` -> `csrc/flash_decode.cu`, replacing `_flash_kernel` as
  `flash_decode` (:604-645) runs it: one query per cache slot against a
  [slots, capacity, heads, head_dim] cache masked by `lengths`. Plain
  version: `flash_decode_plain`, the twin of `_decode_reference`
  (:587-601).

What bounds each kernel on the card and what its design does about it is
noted at the top of its source. A wrapper runs the plain version only for
a tensor on the CPU, as the tests do. For a CUDA tensor it launches the
kernel or raises: a failed build or launch never falls back. Each wrapper
counts its launches in `.launches`, a plain integer raised by one where
the kernel launches and nowhere else.

Layouts are the JAX package's: [batch, time, heads, head_dim], float32
(the serving path runs in the param dtype). Head dims 16, 32, 64 and 128
are compiled; any other raises. There is no tile-divisibility rule and no
fallback: ragged lengths are masked inside the kernels.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..parallel.ring_attention import attention_reference
from . import build

HEAD_DIMS = (16, 32, 64, 128)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FWD_ARGTYPES = ([_P] * 6 + [_I] * 5 + [_L] * 9
                 + [_I, ctypes.c_float, _P])
_DECODE_ARGTYPES = ([_P] * 6 + [_I] * 4 + [_L] * 8
                    + [ctypes.c_float, _P])
DECODE_CHUNK = 32   # keys per warp in csrc/flash_decode.cu (CHUNK)


def _on_host(t):
    return t.device.type == "cpu"


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _check_attention_operands(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4 or t.dtype != torch.float32:
            raise ValueError(f"{name} must be a 4-D float32 tensor, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a dense head dim (stride 1)")
    if k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[3]} not compiled; the kernels "
                         f"take {HEAD_DIMS}")
    if q.shape[1] < 1 or k.shape[1] < 1:
        raise ValueError("empty sequence")


# ------------------------------------------------------------- prefill
def flash_attention_plain(q, k, v, *, causal=False, scale=None,
                          key_mask=None, return_lse=False):
    """Materializing softmax attention with the kernel's semantics
    (`parallel.ring_attention.attention_reference` in float32): masked
    scores at the finite NEG_INF, causal on positions, key_mask [B, Tk]
    (> 0 valid) shared by the heads. Returns out [B, Tq, H, D] and, with
    `return_lse`, the per-row log-sum-exp [B, H, Tq] (f32)."""
    res = attention_reference(q.float(), k.float(), v.float(), causal=causal,
                              scale=scale, key_mask=key_mask,
                              return_lse=return_lse)
    if return_lse:
        return res[0].to(q.dtype), res[1]
    return res.to(q.dtype)


def flash_attention(q, k, v, *, causal=False, scale=None, key_mask=None,
                    return_lse=False):
    """Flash attention on [batch, time, heads, head_dim] tensors: the
    `flash_fwd` kernel for CUDA tensors, `flash_attention_plain` for CPU
    tensors. key_mask: optional [batch, Tk] (or broadcastable) key
    validity. Returns out [B, Tq, H, D], plus lse [B, H, Tq] f32 with
    `return_lse`."""
    if _on_host(q):
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     key_mask=key_mask,
                                     return_lse=return_lse)
    fn = build.kernel_function("flash_fwd", "flash_fwd_f32", _FWD_ARGTYPES)
    _check_attention_operands(q, k, v)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if B * H > 65535:
        raise ValueError(f"batch*heads {B * H} exceeds the grid's 65535")
    scale = float(1.0 / math.sqrt(D)) if scale is None else float(scale)
    km = None
    if key_mask is not None:
        km = torch.broadcast_to(
            torch.as_tensor(key_mask, device=q.device), (B, Tk)).to(
                torch.float32).contiguous()
    out = torch.empty((B, Tq, H, D), dtype=torch.float32, device=q.device)
    lse = (torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             None if km is None else km.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(),
             B, H, Tq, Tk, D,
             q.stride(0), q.stride(1), q.stride(2),
             k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2),
             int(bool(causal)), scale, _stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError_t {err}")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


# -------------------------------------------------------------- decode
def flash_decode_plain(q, k, v, lengths, *, scale=None):
    """Masked one-query attention materializing the [S, H, 1, C] score row
    (the twin of `_decode_reference`): `flash_attention_plain` with the
    key mask `position < lengths`. A slot with lengths <= 0 gets the
    uniform average over its cache."""
    C = k.shape[1]
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=q.device)
    valid = torch.arange(C, device=q.device)[None, :] < lengths[:, None]
    return flash_attention_plain(q, k, v, scale=scale, key_mask=valid)


def flash_decode(q, k, v, lengths, *, scale=None):
    """Decode attention: q [slots, 1, heads, head_dim] (the current token,
    its k/v already in the cache at lengths-1), k/v [slots, capacity,
    heads, head_dim], lengths [slots] valid entries per slot. The
    `flash_decode` kernel for CUDA tensors, `flash_decode_plain` for CPU
    tensors. Returns [slots, 1, heads, head_dim]."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"flash_decode takes one query per slot, got q "
                         f"{tuple(q.shape)}")
    if _on_host(q):
        return flash_decode_plain(q, k, v, lengths, scale=scale)
    fn = build.kernel_function("flash_decode", "flash_decode_f32",
                               _DECODE_ARGTYPES)
    _check_attention_operands(q, k, v)
    S, _, H, D = q.shape
    C = k.shape[1]
    if S > 65535:
        raise ValueError(f"{S} slots exceed the grid's 65535")
    scale = float(1.0 / math.sqrt(D)) if scale is None else float(scale)
    lengths = torch.as_tensor(lengths, dtype=torch.int32,
                              device=q.device).contiguous()
    if lengths.shape != (S,):
        raise ValueError(f"lengths must be [{S}], got "
                         f"{tuple(lengths.shape)}")
    out = torch.empty((S, 1, H, D), dtype=torch.float32, device=q.device)
    # per-chunk partials (acc, max, sum) the kernel's merge pass reads
    work = torch.empty((S * H * -(-C // DECODE_CHUNK) * (D + 2),),
                       dtype=torch.float32, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
             out.data_ptr(), work.data_ptr(), S, H, C, D,
             q.stride(0), q.stride(2),
             k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2),
             scale, _stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed: cudaError_t {err}")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def launch_counts():
    """{kernel name: launches} of every hand kernel."""
    return {"flash_fwd": flash_attention.launches,
            "flash_decode": flash_decode.launches}


def reset_launch_counts():
    flash_attention.launches = 0
    flash_decode.launches = 0
