"""Plain and blockwise attention on [batch, time, heads, head_dim] tensors
(counterpart of deeplearning4j_tpu/parallel/ring_attention.py:29-116).

These are the `use_pallas=False` path of `SelfAttentionLayerModule.attend`.
They compute in q's dtype, as the JAX functions do: under bf16 compute the
scores, the running max, sum and output are bf16, and the default scale
is 1 / sqrt(D) rounded as JAX forms it (`_default_scale`). Ring attention
and its shard_map plumbing come with a later slice."""
from __future__ import annotations

import functools
import math

import torch

from ..device import bf16_product

NEG_INF = -1e30


def _default_scale(D, dtype):
    """`1.0 / jnp.sqrt(D).astype(q.dtype)` (JAX :34, :93): the root in
    float32 (float64 stays float64), cast to q's dtype, and its reciprocal
    in that dtype. Exact for the power-of-two roots (D = 16, 64, ...)."""
    root = torch.tensor(math.sqrt(D),
                        dtype=torch.promote_types(dtype, torch.float32))
    return float(1.0 / root.to(dtype))


def widen(t):
    """t in float32 when it is narrower (float64 stays float64)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def contract(equation, a, b):
    """`torch.einsum(equation, a, b)`, a bf16 product rounded once
    (`device.bf16_product`)."""
    return bf16_product(functools.partial(torch.einsum, equation), a, b)


def masked_scores(q, k, *, causal=False, scale=None, key_mask=None):
    """Scaled scores [batch, heads, Tq, Tk] with masked entries at the
    finite NEG_INF: key_mask (optional [batch, Tk] or broadcastable, > 0
    valid) and, with `causal`, key positions past the query's (positions
    from 0 on both sides)."""
    B, Tq, D = q.shape[0], q.shape[1], q.shape[3]
    Tk = k.shape[1]
    scale = scale if scale is not None else _default_scale(D, q.dtype)
    s = contract("bqhd,bkhd->bhqk", q, k) * scale
    if key_mask is not None:
        km = torch.broadcast_to(torch.as_tensor(key_mask, device=q.device),
                                (B, Tk))
        s = torch.where(km[:, None, None, :] > 0, s,
                        torch.full_like(s, NEG_INF))
    if causal:
        qpos = torch.arange(Tq, device=q.device)[:, None]
        kpos = torch.arange(Tk, device=q.device)[None, :]
        s = s.masked_fill((kpos > qpos)[None, None], NEG_INF)
    return s


def attention_reference(q, k, v, *, causal=False, scale=None, key_mask=None,
                        return_lse=False):
    """Plain softmax attention. key_mask: optional [batch, Tk] (or
    broadcastable) validity of key positions (> 0 valid). With
    `return_lse`, also the per-row log-sum-exp [batch, heads, Tq]."""
    s = masked_scores(q, k, causal=causal, scale=scale, key_mask=key_mask)
    p = torch.softmax(s, dim=-1)
    out = contract("bhqk,bkhd->bqhd", p, v)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def blockwise_attention(q, k, v, *, block_size=256, causal=False,
                        scale=None, key_mask=None):
    """Online-softmax scan over key blocks, the same arithmetic as the JAX
    package's `lax.scan` version, written as a Python loop over blocks."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    block_size = min(block_size, Tk)
    if Tk % block_size:
        raise ValueError("block_size must evenly divide the key length")
    scale = scale if scale is not None else _default_scale(D, q.dtype)
    if key_mask is not None:
        key_mask = torch.broadcast_to(key_mask, (B, Tk))
    qpos = torch.arange(Tq, device=q.device)
    o = torch.zeros((B, H, Tq, D), dtype=q.dtype, device=q.device)
    m = torch.full((B, H, Tq), NEG_INF, dtype=q.dtype, device=q.device)
    l = torch.zeros((B, H, Tq), dtype=q.dtype, device=q.device)
    for k_off in range(0, Tk, block_size):
        kb = k[:, k_off:k_off + block_size]
        vb = v[:, k_off:k_off + block_size]
        s = contract("bqhd,bkhd->bhqk", q, kb) * scale
        if causal:
            kpos = k_off + torch.arange(kb.shape[1], device=q.device)
            s = s.masked_fill((kpos[None, :] > qpos[:, None])[None, None],
                              NEG_INF)
        if key_mask is not None:
            km = key_mask[:, k_off:k_off + block_size]
            s = torch.where(km[:, None, None, :] > 0, s,
                            torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        # the probabilities as the JAX package's compiled scan has them
        # under bf16: exp in float32, its row sum taken before rounding,
        # and p rounded to q's dtype for the product with V
        p = torch.exp(widen(s - m_new[..., None]))
        l = l * corr + p.sum(dim=-1).to(q.dtype)
        o = o * corr[..., None] + contract("bhqk,bkhd->bhqd",
                                           p.to(q.dtype), vb)
        m = m_new
    out = o / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 2, 1, 3)
