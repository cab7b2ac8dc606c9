"""Plain, blockwise and ring attention on [batch, time, heads, head_dim]
tensors (counterpart of deeplearning4j_tpu/parallel/ring_attention.py).

`attention_reference` and `blockwise_attention` are the `use_pallas=False`
path of `SelfAttentionLayerModule.attend`. They compute in q's dtype, as
the JAX functions do: under bf16 compute the scores, the running max, sum
and output are bf16, and the default scale is 1 / sqrt(D) rounded as JAX
forms it (`_default_scale`).

`ring_attention` is sequence-parallel attention over a mesh's `seq` axis
(`parallel/sharding.py`): time splits into n shards, shard i on the i-th
device of that axis, and K, V (and the key mask) travel around the ring
while each shard's queries fold in every visiting shard. The JAX ring is
one program that `shard_map` runs on every device of its mesh, rotating
with `ppermute`; here one process walks the shards in turn and a rotation
moves each K/V shard from device i to device (i + 1) mod n with `.to()`,
which autograd differentiates like any op (no copy when a device repeats,
as it does for an n-shard ring on one card).
"""
from __future__ import annotations

import functools
import math

import torch

from ..device import bf16_product
from .sharding import SEQ_AXIS

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


def masked_scores(q, k, *, causal=False, scale=None, key_mask=None,
                  q_offset=0, k_offset=0):
    """Scaled scores [batch, heads, Tq, Tk] with masked entries at the
    finite NEG_INF: key_mask (optional [batch, Tk] or broadcastable, > 0
    valid) and, with `causal`, key positions past the query's (global
    positions: query row i at q_offset + i, key j at k_offset + j)."""
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
        qpos = q_offset + torch.arange(Tq, device=q.device)[:, None]
        kpos = k_offset + torch.arange(Tk, device=q.device)[None, :]
        s = s.masked_fill((kpos > qpos)[None, None], NEG_INF)
    return s


def attention_reference(q, k, v, *, causal=False, scale=None, key_mask=None,
                        return_lse=False, q_offset=0, k_offset=0):
    """Plain softmax attention. key_mask: optional [batch, Tk] (or
    broadcastable) validity of key positions (> 0 valid); the causal mask
    at the global positions of `masked_scores`. With `return_lse`, also
    the per-row log-sum-exp [batch, heads, Tq]."""
    s = masked_scores(q, k, causal=causal, scale=scale, key_mask=key_mask,
                      q_offset=q_offset, k_offset=k_offset)
    p = torch.softmax(s, dim=-1)
    out = contract("bhqk,bkhd->bqhd", p, v)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def _causal_mask_fn(qpos):
    """Scores mask: key positions after the query's global position
    (`qpos`, [Tq]) get NEG_INF (shared by the blockwise scan and the ring's
    einsum body; JAX :46-53)."""
    def mask_fn(s, k_off):
        kpos = k_off + torch.arange(s.shape[-1], device=s.device)
        return s.masked_fill((kpos[None, :] > qpos[:, None])[None, None],
                             NEG_INF)
    return mask_fn


def _block_update(carry, kb, vb, k_off, km, q, scale, mask_fn=None):
    """Online-softmax accumulation of one K/V block (keys from global
    position k_off on; km an optional [B, Tb] key-validity mask) into
    (o [B, H, Tq, D], m, l [B, H, Tq]), all in q's dtype (JAX :56-78). A
    fully masked block is harmless: once a later block brings a real max,
    exp(m - m_new) zeroes its partials."""
    o, m, l = carry
    s = contract("bqhd,bkhd->bhqk", q, kb) * scale
    if mask_fn is not None:
        s = mask_fn(s, k_off)
    if km is not None:
        s = torch.where(km[:, None, None, :] > 0, s,
                        torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1))
    corr = torch.exp(m - m_new)
    # the probabilities as the JAX package's compiled scan has them under
    # bf16: exp in float32, its row sum taken before rounding, and p
    # rounded to q's dtype for the product with V
    p = torch.exp(widen(s - m_new[..., None]))
    l = l * corr + p.sum(dim=-1).to(q.dtype)
    o = o * corr[..., None] + contract("bhqk,bkhd->bhqd", p.to(q.dtype), vb)
    return o, m_new, l


def _zero_carry(q):
    """(o, m, l) of an empty scan: zeros, NEG_INF, zeros in q's dtype."""
    B, Tq, H, D = q.shape
    return (torch.zeros((B, H, Tq, D), dtype=q.dtype, device=q.device),
            torch.full((B, H, Tq), NEG_INF, dtype=q.dtype, device=q.device),
            torch.zeros((B, H, Tq), dtype=q.dtype, device=q.device))


def _finish(carry):
    """[B, Tq, H, D] output of a scan's (o, m, l)."""
    o, _, l = carry
    return (o / torch.clamp(l[..., None], min=1e-30)).permute(0, 2, 1, 3)


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
    mask_fn = (_causal_mask_fn(torch.arange(Tq, device=q.device))
               if causal else None)
    carry = _zero_carry(q)
    for k_off in range(0, Tk, block_size):
        km = None if key_mask is None \
            else key_mask[:, k_off:k_off + block_size]
        carry = _block_update(carry, k[:, k_off:k_off + block_size],
                              v[:, k_off:k_off + block_size], k_off, km, q,
                              scale, mask_fn)
    return _finish(carry)


# ------------------------------------------------------------------ ring
def _lse_merge(o, lse, out_r, lse_r):
    """Fold one shard's normalized (out_r, lse_r) into the float32 (o, lse)
    carry by log-sum-exp, with the reference's 1e-30 clamps (JAX
    :194-200)."""
    m_new = torch.maximum(lse, lse_r)
    w_acc = torch.exp(lse - m_new)
    w_r = torch.exp(lse_r - m_new)
    tw = lambda w: w.transpose(1, 2)[..., None]         # -> B, Tq, H, 1
    w = torch.clamp(w_acc + w_r, min=1e-30)
    o = (o * tw(w_acc) + out_r.to(torch.float32) * tw(w_r)) / tw(w)
    return o, m_new + torch.log(w)


def _ring_flash(qs, ks, vs, kms, causal, scale):
    """The ring's flash path (JAX :160-206): `flash_attention_lse` on each
    visiting shard, the shard's global key offset driving the causal mask,
    and the per-shard (out, lse) merged in float32. A strictly-future
    shard (src > my, causal) is all masked: it gives zeros and NEG_INF
    without a launch. One shard is `flash_attention` alone."""
    from ..kernels.flash_attention import flash_attention, flash_attention_lse
    n = len(qs)
    if n == 1:
        return [flash_attention(qs[0], ks[0], vs[0], causal=causal,
                                scale=scale, key_mask=kms[0])]
    B, Tq, H, _ = qs[0].shape
    o = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
         for q in qs]
    lse = [torch.full((B, H, Tq), NEG_INF, dtype=torch.float32,
                      device=q.device) for q in qs]
    kr, vr, kmr = ks, vs, kms
    for r in range(n):
        for my, q in enumerate(qs):
            src = (my - r) % n              # where kr[my] started
            if causal and src > my:
                out_r = torch.zeros_like(q)
                lse_r = torch.full_like(lse[my], NEG_INF)
            else:
                out_r, lse_r = flash_attention_lse(
                    q, kr[my], vr[my], causal=causal, scale=scale,
                    key_mask=kmr[my], q_offset=my * Tq if causal else None,
                    k_offset=src * Tq if causal else None)
            o[my], lse[my] = _lse_merge(o[my], lse[my], out_r, lse_r)
        if r < n - 1:
            kr, vr, kmr = _rotate(kr), _rotate(vr), _rotate(kmr)
    return [x.to(q.dtype) for x, q in zip(o, qs)]


def _ring_einsum(qs, ks, vs, kms, causal, scale):
    """The ring's einsum path (JAX :208-232): `_block_update` on each
    visiting shard at its global key offset, (o, m, l) in q's dtype."""
    n = len(qs)
    B, Tq, H, D = qs[0].shape
    scale = scale if scale is not None else _default_scale(D, qs[0].dtype)
    carry = [_zero_carry(q) for q in qs]
    mask_fn = [_causal_mask_fn(my * Tq + torch.arange(Tq, device=q.device))
               if causal else None for my, q in enumerate(qs)]
    kr, vr, kmr = ks, vs, kms
    for r in range(n):
        for my, q in enumerate(qs):
            src = (my - r) % n
            carry[my] = _block_update(carry[my], kr[my], vr[my], src * Tq,
                                      kmr[my], q, scale, mask_fn[my])
        if r < n - 1:
            kr, vr, kmr = _rotate(kr), _rotate(vr), _rotate(kmr)
    return [_finish(c) for c in carry]


def _rotate(shards):
    """Shard i moves to the device of shard i + 1 (mod n), the ring's
    `ppermute` (JAX :149-154); a list of None stays as it is."""
    if shards[0] is None:
        return shards
    n = len(shards)
    return [shards[(i - 1) % n].to(shards[i].device) for i in range(n)]


def ring_attention(q, k, v, mesh, *, causal=False, scale=None,
                   axis_name=SEQ_AXIS, key_mask=None, use_flash=None):
    """Sequence-parallel attention over `mesh`'s `axis_name` ring (JAX
    :235-275): time splits into n = mesh.shape[axis_name] shards, shard i
    on the i-th device of that axis (index 0 on the others), and the K/V
    shards (with the key mask, [batch, time] key validity broadcast to
    [B, T] in q's dtype) rotate around the ring. Returns the output
    [B, T, H, D] concatenated along time on q's device.

    use_flash (default: `can_flash` of the per-shard shape) runs
    `flash_attention_lse` on each visiting shard, the kernels on the card
    and their plain versions on the CPU, and merges (out, lse) in float32;
    use_flash=False runs the einsum block update, in q's dtype."""
    from ..kernels.flash_attention import can_flash
    n = mesh.shape[axis_name]
    B, T, H, D = q.shape
    if T % n:
        raise ValueError(f"time {T} does not split into {n} shards")
    Tq = T // n
    if use_flash is None:
        use_flash = can_flash(Tq, Tq, D)
    devices = mesh.axis_devices(axis_name)

    def shard(x):
        return [x[:, i * Tq:(i + 1) * Tq].to(d) for i, d in enumerate(devices)]

    kms = [None] * n
    if key_mask is not None:
        km = torch.as_tensor(key_mask, device=q.device).to(q.dtype)
        kms = shard(torch.broadcast_to(km, (B, T)))
    body = _ring_flash if use_flash else _ring_einsum
    outs = body(shard(q), shard(k), shard(v), kms, causal, scale)
    return torch.cat([o.to(q.device) for o in outs], dim=1)
