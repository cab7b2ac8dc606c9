"""Attention kernels for Hopper, the port of
deeplearning4j_tpu/kernels/flash_attention.py.

Five hand-written CUDA kernels, each behind a wrapper with its plain
PyTorch version beside it:

- `flash_attention` -> `csrc/flash_fwd.cu`, replacing the TPU kernel
  `_flash_kernel` (flash_attention.py:84-143, `pl.pallas_call` at :206) as
  `flash_attention` (:512) runs it: causal, key-masked attention for the
  decode prefill and, with its log-sum-exp, the training forward. Plain
  version: `flash_attention_plain`.
- `flash_bwd_dq` -> `csrc/flash_bwd.cu` (`flash_bwd_dq_f32`), replacing
  `_bwd_dq_kernel` (:226-273, `pallas_call` :366); plain version
  `flash_bwd_dq_plain`.
- `flash_bwd_dkv` -> `csrc/flash_bwd.cu` (`flash_bwd_dkv_f32`), replacing
  `_bwd_dkv_kernel` (:276-330, `pallas_call` :388); plain version
  `flash_bwd_dkv_plain`.
- `flash_decode` -> `csrc/flash_decode.cu`, replacing `_flash_kernel` as
  `flash_decode` (:604-645) runs it: one query per cache slot against a
  [slots, capacity, heads, head_dim] cache masked by `lengths`. Plain
  version: `flash_decode_plain`, the twin of `_decode_reference`
  (:587-601).
- `flash_decode_paged` -> `csrc/flash_decode_paged.cu`, replacing
  `_flash_kernel` as `flash_decode_paged` (:648-682) runs it: the same
  decode attention over a [num_blocks, block_size, heads, head_dim] pool,
  reading each slot's keys through its row of an int32 block table inside
  the kernel (the reference gathers the pool first). Plain version:
  `flash_decode_paged_plain`, the gather followed by `flash_decode_plain`.

The gradient: under grad mode, with an input that requires grad,
`flash_attention` runs `FlashAttentionFunction`, the counterpart of the
JAX package's `custom_vjp` (:430-450). Its forward asks `flash_fwd` for
the LSE (the JAX `need_lse`), its backward is `flash_attention_bwd`:
delta = rowsum(dO o O) as a torch reduction, then the dq and the dk/dv
kernels. This holds on the CPU too, where the plain versions run inside
the Function. Without a gradient (serving, `inference_mode`) no LSE is
written.

What bounds each kernel on the card and what its design does about it is
noted at the top of its source. A wrapper runs the plain version only for
a tensor on the CPU, as the tests do. For a CUDA tensor it launches the
kernel or raises: a failed build or launch never falls back. Each wrapper
counts its launches in `.launches`, a plain integer raised by one where
the kernel launches and nowhere else.

Layouts are the JAX package's: [batch, time, heads, head_dim], float32;
lse and delta are [batch, heads, Tq] float32. Head dims 16, 32, 64 and
128 are compiled; any other raises. There is no tile-divisibility rule and
no fallback: ragged lengths are masked inside the kernels.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..parallel.ring_attention import attention_reference, masked_scores
from . import build

HEAD_DIMS = (16, 32, 64, 128)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FWD_ARGTYPES = ([_P] * 6 + [_I] * 5 + [_L] * 9
                 + [_I, ctypes.c_float, _P])
_DECODE_ARGTYPES = ([_P] * 6 + [_I] * 4 + [_L] * 8
                    + [ctypes.c_float, _P])
_DECODE_PAGED_ARGTYPES = ([_P] * 7 + [_I] * 5 + [_L] * 8
                          + [ctypes.c_float, _P])
_BWD_DQ_ARGTYPES = [_P] * 8 + [_I] * 5 + [_L] * 12 + [_I, ctypes.c_float, _P]
_BWD_DKV_ARGTYPES = [_P] * 9 + [_I] * 5 + [_L] * 12 + [_I, ctypes.c_float, _P]
DECODE_CHUNK = 32   # keys per warp in csrc/flash_decode.cu (CHUNK)


def _on_host(t):
    return t.device.type == "cpu"


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _scale(scale, D):
    return float(1.0 / math.sqrt(D)) if scale is None else float(scale)


def _check_f32_operands(q, **others):
    """q and each named tensor: 4-D float32 on q's device, head dim
    dense."""
    for name, t in (("q", q), *others.items()):
        if t.dim() != 4 or t.dtype != torch.float32:
            raise ValueError(f"{name} must be a 4-D float32 tensor, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a dense head dim (stride 1)")


def _lengths_operand(lengths, S, device):
    """`lengths` as the dense int32 [S] tensor the decode kernels read."""
    lengths = torch.as_tensor(lengths, dtype=torch.int32,
                              device=device).contiguous()
    if lengths.shape != (S,):
        raise ValueError(f"lengths must be [{S}], got "
                         f"{tuple(lengths.shape)}")
    return lengths


def _check_attention_operands(q, k, v):
    _check_f32_operands(q, k=k, v=v)
    if k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[3]} not compiled; the kernels "
                         f"take {HEAD_DIMS}")
    if q.shape[1] < 1 or k.shape[1] < 1:
        raise ValueError("empty sequence")


def _check_bh_grid(q):
    """flash_fwd and flash_bwd put batch*heads on the grid's y axis."""
    if q.shape[0] * q.shape[2] > 65535:
        raise ValueError(f"batch*heads {q.shape[0] * q.shape[2]} exceeds "
                         "the grid's 65535")


def _prep_key_mask(key_mask, B, Tk, device):
    """[B, Tk] float32 contiguous key validity, or None."""
    if key_mask is None:
        return None
    return torch.broadcast_to(torch.as_tensor(key_mask, device=device),
                              (B, Tk)).to(torch.float32).contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def _bhd_strides(t):
    return t.stride(0), t.stride(1), t.stride(2)


# ------------------------------------------------------------- forward
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


def _flash_forward(q, k, v, causal, scale, key_mask, return_lse):
    """The forward wrapper: `flash_fwd` for CUDA tensors, the plain
    version for CPU tensors; writes the LSE only with `return_lse`."""
    if _on_host(q):
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     key_mask=key_mask,
                                     return_lse=return_lse)
    fn = build.kernel_function("flash_fwd", "flash_fwd_f32", _FWD_ARGTYPES)
    _check_attention_operands(q, k, v)
    _check_bh_grid(q)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    km = _prep_key_mask(key_mask, B, Tk, q.device)
    out = torch.empty((B, Tq, H, D), dtype=torch.float32, device=q.device)
    lse = (torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(km),
             out.data_ptr(), _ptr(lse), B, H, Tq, Tk, D,
             *_bhd_strides(q), *_bhd_strides(k), *_bhd_strides(v),
             int(bool(causal)), _scale(scale, D), _stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError_t {err}")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


class FlashAttentionFunction(torch.autograd.Function):
    """Attention with its hand-written backward: the counterpart of the
    JAX package's `_flash` custom_vjp (:430-450). Forward: `flash_fwd`
    with the LSE. Saves q, k, v, the key mask, out and lse; backward runs
    `flash_attention_bwd`. The mask gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, causal, scale):
        out, lse = _flash_forward(q, k, v, causal, scale, key_mask, True)
        ctx.save_for_backward(q, k, v, key_mask, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g,
                                         causal=ctx.causal, scale=ctx.scale,
                                         key_mask=key_mask)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal=False, scale=None, key_mask=None,
                    return_lse=False):
    """Flash attention on [batch, time, heads, head_dim] tensors: the
    `flash_fwd` kernel for CUDA tensors, `flash_attention_plain` for CPU
    tensors. key_mask: optional [batch, Tk] (or broadcastable) key
    validity. Returns out [B, Tq, H, D], plus lse [B, H, Tq] f32 with
    `return_lse`.

    Under grad mode, with an input that requires grad, the call goes
    through `FlashAttentionFunction`, whose backward runs the dq and dk/dv
    kernels (the plain versions on the CPU)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if return_lse:
            raise NotImplementedError(
                "the gradient of the LSE output is not ported yet (ROADMAP "
                "queue 1: flash_attention_lse + ring attention)")
        km = _prep_key_mask(key_mask, q.shape[0], k.shape[1], q.device)
        return FlashAttentionFunction.apply(q, k, v, km, bool(causal),
                                            _scale(scale, q.shape[3]))
    return _flash_forward(q, k, v, causal, scale, key_mask, return_lse)


flash_attention.launches = 0


# ------------------------------------------------------------ backward
def _bwd_probs(q, k, v, g, lse, delta, causal, scale, key_mask):
    """The TPU backward kernels' recompute: p = exp(s - lse) from the
    masked scores, ds = p (dO.v - delta) scale. Both [B, H, Tq, Tk]."""
    s = masked_scores(q, k, causal=causal, scale=scale, key_mask=key_mask)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", g, v)
    return p, p * (dp - delta[..., None]) * _scale(scale, q.shape[3])


def attention_delta(out, g):
    """delta = rowsum(dO o O), [B, H, Tq]: the row contraction the JAX
    package forms outside its backward kernels (:342-349)."""
    return torch.einsum("bqhd,bqhd->bhq", g, out)


def flash_bwd_dq_plain(q, k, v, g, lse, delta, *, causal=False, scale=None,
                       key_mask=None):
    """dq [B, Tq, H, D] from the recomputed ds: sum over keys of ds.K."""
    _, ds = _bwd_probs(q, k, v, g, lse, delta, causal, scale, key_mask)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k)


def flash_bwd_dkv_plain(q, k, v, g, lse, delta, *, causal=False, scale=None,
                        key_mask=None):
    """(dk, dv) [B, Tk, H, D]: sums over queries of ds^T.Q and p^T.dO."""
    p, ds = _bwd_probs(q, k, v, g, lse, delta, causal, scale, key_mask)
    return (torch.einsum("bhqk,bqhd->bkhd", ds, q),
            torch.einsum("bhqk,bqhd->bkhd", p, g))


def flash_attention_bwd_plain(q, k, v, out, lse, g, *, causal=False,
                              scale=None, key_mask=None):
    """(dq, dk, dv) of attention given the forward's out and lse [B, H,
    Tq] and the output cotangent g: the plain version of both backward
    kernels, with their recompute (p from lse, delta from out) and the
    forward's masking at the finite NEG_INF."""
    delta = attention_delta(out, g)
    p, ds = _bwd_probs(q, k, v, g, lse, delta, causal, scale, key_mask)
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k),
            torch.einsum("bhqk,bqhd->bkhd", ds, q),
            torch.einsum("bhqk,bqhd->bkhd", p, g))


def _bwd_operands(q, k, v, g, lse, delta, key_mask):
    """Checks shared by the two backward launches; returns (g, lse, delta,
    key mask) in the layouts the kernels read."""
    _check_attention_operands(q, k, v)
    _check_bh_grid(q)
    B, Tq, H, _ = q.shape
    if g.shape != q.shape or g.dtype != torch.float32 \
            or g.device != q.device:
        raise ValueError(f"dO must be float32 {tuple(q.shape)} on "
                         f"{q.device}, got {tuple(g.shape)} {g.dtype}")
    if g.stride(-1) != 1:           # e.g. an expanded cotangent: stride 0
        g = g.contiguous()
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (B, H, Tq) or t.dtype != torch.float32 \
                or t.device != q.device:
            raise ValueError(f"{name} must be float32 {(B, H, Tq)} on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype}")
    return (g, lse.contiguous(), delta.contiguous(),
            _prep_key_mask(key_mask, B, k.shape[1], q.device))


def flash_bwd_dq(q, k, v, g, lse, delta, *, causal=False, scale=None,
                 key_mask=None):
    """dq [B, Tq, H, D]: the `flash_bwd_dq` kernel for CUDA tensors,
    `flash_bwd_dq_plain` for CPU tensors. g is dO; lse and delta are
    [B, H, Tq] float32."""
    if _on_host(q):
        return flash_bwd_dq_plain(q, k, v, g, lse, delta, causal=causal,
                                  scale=scale, key_mask=key_mask)
    fn = build.kernel_function("flash_bwd", "flash_bwd_dq_f32",
                               _BWD_DQ_ARGTYPES)
    g, lse, delta, km = _bwd_operands(q, k, v, g, lse, delta, key_mask)
    B, Tq, H, D = q.shape
    dq = torch.empty((B, Tq, H, D), dtype=torch.float32, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), _ptr(km), dq.data_ptr(),
             B, H, Tq, k.shape[1], D,
             *_bhd_strides(q), *_bhd_strides(k), *_bhd_strides(v),
             *_bhd_strides(g), int(bool(causal)), _scale(scale, D),
             _stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash_bwd_dq launch failed: cudaError_t {err}")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, g, lse, delta, *, causal=False, scale=None,
                  key_mask=None):
    """(dk, dv) [B, Tk, H, D]: the `flash_bwd_dkv` kernel for CUDA
    tensors, `flash_bwd_dkv_plain` for CPU tensors."""
    if _on_host(q):
        return flash_bwd_dkv_plain(q, k, v, g, lse, delta, causal=causal,
                                   scale=scale, key_mask=key_mask)
    fn = build.kernel_function("flash_bwd", "flash_bwd_dkv_f32",
                               _BWD_DKV_ARGTYPES)
    g, lse, delta, km = _bwd_operands(q, k, v, g, lse, delta, key_mask)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    dk = torch.empty((B, Tk, H, D), dtype=torch.float32, device=q.device)
    dv = torch.empty((B, Tk, H, D), dtype=torch.float32, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), _ptr(km), dk.data_ptr(),
             dv.data_ptr(), B, H, Tq, Tk, D,
             *_bhd_strides(q), *_bhd_strides(k), *_bhd_strides(v),
             *_bhd_strides(g), int(bool(causal)), _scale(scale, D),
             _stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash_bwd_dkv launch failed: cudaError_t {err}")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, out, lse, g, *, causal=False, scale=None,
                        key_mask=None):
    """(dq, dk, dv) given the forward's out and lse and the cotangent g:
    `flash_attention_bwd_plain` for CPU tensors; for CUDA tensors delta
    as a torch reduction, then the dq and dk/dv kernels."""
    if _on_host(q):
        return flash_attention_bwd_plain(q, k, v, out, lse, g, causal=causal,
                                         scale=scale, key_mask=key_mask)
    delta = attention_delta(out, g)
    kw = dict(causal=causal, scale=scale, key_mask=key_mask)
    dq = flash_bwd_dq(q, k, v, g, lse, delta, **kw)
    dk, dv = flash_bwd_dkv(q, k, v, g, lse, delta, **kw)
    return dq, dk, dv


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
    lengths = _lengths_operand(lengths, S, q.device)
    out = torch.empty((S, 1, H, D), dtype=torch.float32, device=q.device)
    # per-chunk partials (acc, max, sum) the kernel's merge pass reads
    work = torch.empty((S * H * -(-C // DECODE_CHUNK) * (D + 2),),
                       dtype=torch.float32, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
             out.data_ptr(), work.data_ptr(), S, H, C, D,
             q.stride(0), q.stride(2),
             k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2),
             _scale(scale, D), _stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed: cudaError_t {err}")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def flash_decode_paged_plain(q, k_pool, v_pool, block_table, lengths, *,
                             scale=None):
    """The reference's paged decode (:675-682) in torch: gather
    `pool[table]`, reshape to [S, max_blocks * bs, H, D], then
    `flash_decode_plain`."""
    S = q.shape[0]
    _, bs, H, D = k_pool.shape
    table = torch.as_tensor(block_table, device=k_pool.device).long()
    nb = table.shape[1]
    k = k_pool[table].reshape(S, nb * bs, H, D)
    v = v_pool[table].reshape(S, nb * bs, H, D)
    return flash_decode_plain(q, k, v, lengths, scale=scale)


def _check_paged_operands(q, k_pool, v_pool, block_table, lengths):
    """Checks of the paged launch; returns (table, lengths) as the dense
    int32 tensors the kernel reads."""
    _check_f32_operands(q, k_pool=k_pool, v_pool=v_pool)
    S, _, H, D = q.shape
    if k_pool.shape != v_pool.shape or k_pool.shape[2:] != (H, D):
        raise ValueError(f"pools k {tuple(k_pool.shape)} / v "
                         f"{tuple(v_pool.shape)} do not match q heads and "
                         f"head dim {(H, D)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not compiled; the kernels take "
                         f"{HEAD_DIMS}")
    bs = k_pool.shape[1]
    if bs < 1 or bs & (bs - 1):
        raise ValueError(f"block size {bs} is not a power of two")
    if not isinstance(block_table, torch.Tensor) \
            or block_table.dtype != torch.int32 \
            or block_table.device != q.device or block_table.dim() != 2 \
            or block_table.shape[0] != S or block_table.shape[1] < 1:
        raise ValueError(
            f"block_table must be an int32 [{S}, max_blocks] tensor on "
            f"{q.device}, got {getattr(block_table, 'shape', None)} "
            f"{getattr(block_table, 'dtype', type(block_table))}")
    return block_table.contiguous(), _lengths_operand(lengths, S, q.device)


def flash_decode_paged(q, k_pool, v_pool, block_table, lengths, *,
                       scale=None):
    """Decode attention through a paged KV pool (decode/paged.py): q
    [slots, 1, heads, head_dim], pools [num_blocks, block_size, heads,
    head_dim] (block 0 is scratch), block_table int32 [slots, max_blocks]
    (logical block j of slot s is pool block table[s, j]), lengths [slots].
    The `flash_decode_paged` kernel, which reads K/V through the table, for
    CUDA tensors; `flash_decode_paged_plain` for CPU tensors. Returns
    [slots, 1, heads, head_dim]."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"flash_decode_paged takes one query per slot, got "
                         f"q {tuple(q.shape)}")
    if _on_host(q):
        return flash_decode_paged_plain(q, k_pool, v_pool, block_table,
                                        lengths, scale=scale)
    fn = build.kernel_function("flash_decode_paged", "flash_decode_paged_f32",
                               _DECODE_PAGED_ARGTYPES)
    table, lengths = _check_paged_operands(q, k_pool, v_pool, block_table,
                                           lengths)
    S, _, H, D = q.shape
    bs = k_pool.shape[1]
    MB = table.shape[1]
    out = torch.empty((S, 1, H, D), dtype=torch.float32, device=q.device)
    # per-chunk partials (acc, max, sum) over the logical capacity MB * bs
    work = torch.empty((S * H * -(-(MB * bs) // DECODE_CHUNK) * (D + 2),),
                       dtype=torch.float32, device=q.device)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             work.data_ptr(), S, H, MB, bs, D, q.stride(0), q.stride(2),
             *_bhd_strides(k_pool), *_bhd_strides(v_pool),
             _scale(scale, D), _stream(q.device))
    if err != 0:
        raise RuntimeError(
            f"flash_decode_paged launch failed: cudaError_t {err}")
    flash_decode_paged.launches += 1
    return out


flash_decode_paged.launches = 0

_COUNTED = {"flash_fwd": flash_attention, "flash_decode": flash_decode,
            "flash_decode_paged": flash_decode_paged,
            "flash_bwd_dq": flash_bwd_dq, "flash_bwd_dkv": flash_bwd_dkv}


def launch_counts():
    """{kernel name: launches} of every hand kernel."""
    return {name: fn.launches for name, fn in _COUNTED.items()}


def reset_launch_counts():
    for fn in _COUNTED.values():
        fn.launches = 0
