"""Attention kernels for Hopper, the port of
deeplearning4j_tpu/kernels/flash_attention.py.

Eight hand-written CUDA kernels, each behind a wrapper with its plain
PyTorch version beside it:

- `flash_attention` -> `csrc/flash_fwd.cu` (`flash_fwd_f32`; at head
  dim 64 on the tensor cores, each float32 product as three TF32
  products) for float32 and `csrc/flash_fwd_bf16.cu` (`flash_fwd_bf16`,
  tensor cores) for bfloat16, replacing the TPU kernel `_flash_kernel`
  (flash_attention.py:84-143, `pl.pallas_call` at :206) as
  `flash_attention` (:512) runs it:
  causal, key-masked attention for the decode prefill and, with its
  log-sum-exp, the training forward; and as `flash_attention_lse` (:555)
  runs it on the ring, with the causal mask at global positions (query
  row i at q_offset + i, key j at k_offset + j). Plain version:
  `flash_attention_plain`.
- `flash_bwd_dq` -> `csrc/flash_bwd.cu` (`flash_bwd_dq_f32`; at head
  dim 64 on the tensor cores, each float32 product as three TF32
  products) and `csrc/flash_bwd_bf16.cu` (`flash_bwd_dq_bf16`), replacing
  `_bwd_dq_kernel` (:226-273, `pallas_call` :366); plain version
  `flash_bwd_dq_plain`.
- `flash_bwd_dkv` -> `csrc/flash_bwd.cu` (`flash_bwd_dkv_f32`, likewise)
  and `csrc/flash_bwd_bf16.cu` (`flash_bwd_dkv_bf16`), replacing
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

Types, as the TPU kernels have them: q, k, v (and dO) are all float32 or
all bfloat16, and the attention entries dispatch on that type (mixed or
other types raise); out, dq, dk and dv come back in the operands' type;
the LSE, delta and the key mask are float32. The plain versions compute
in float32 (float64 stays float64) and round to the operands' type once
at the end, as the TPU kernels do. The decode kernels take float32.

The gradient: under grad mode, with an input that requires grad,
`flash_attention` and `flash_attention_lse` run
`FlashAttentionLSEFunction`, the counterpart of the JAX package's
custom_vjps `_flash` (:430-450) and `_flash_lse` (:453-480). Its forward
asks the forward kernel for the LSE (the JAX `need_lse`); out and lse are
both outputs. Its backward is `flash_attention_bwd`: delta = rowsum(dO o
O) - g_lse (the LSE's cotangent, :342-348; 0 when only out is used) in
float32 as a torch reduction, then the dq and the dk/dv kernels. This
holds on the CPU too, where the plain versions run inside the Function.
Without a gradient (serving, `inference_mode`) no LSE is written unless
asked for.

Causal offsets: a row whose global position comes before every key's
sees no key. The kernels and the plain versions give it what the TPU
kernel gives a row whose every block it skips: out exactly 0 and lse
NEG_INF + log(1e-30); in the backward its dq row is 0 and it has no share
in dk or dv. A row that the key mask alone empties is not a contract.

What bounds each kernel on the card and what its design does about it is
noted at the top of its source. A wrapper runs the plain version only for
a tensor on the CPU, as the tests do. For a CUDA tensor it launches the
kernel or raises: a failed build or launch never falls back. Each launch
adds one to its kernel's count in `launch_counts()`, where the kernel
launches and nowhere else.

Layouts are the JAX package's: [batch, time, heads, head_dim]; lse and
delta are [batch, heads, Tq]. Head dims 16, 32, 64 and 128 are compiled;
any other raises. There is no tile-divisibility rule and no fallback:
ragged lengths are masked inside the kernels.
"""
from __future__ import annotations

import contextlib
import ctypes
import math

import torch

from ..parallel.ring_attention import (NEG_INF, attention_reference,
                                       masked_scores, widen)
from . import build

HEAD_DIMS = (16, 32, 64, 128)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# ... causal, q_offset, k_offset, scale, stream
_FWD_ARGTYPES = ([_P] * 6 + [_I] * 5 + [_L] * 9
                 + [_I] * 3 + [ctypes.c_float, _P])
_DECODE_ARGTYPES = ([_P] * 6 + [_I] * 4 + [_L] * 8
                    + [ctypes.c_float, _P])
_DECODE_PAGED_ARGTYPES = ([_P] * 7 + [_I] * 5 + [_L] * 8
                          + [ctypes.c_float, _P])
_BWD_DQ_ARGTYPES = ([_P] * 8 + [_I] * 5 + [_L] * 12
                    + [_I] * 3 + [ctypes.c_float, _P])
_BWD_DKV_ARGTYPES = ([_P] * 9 + [_I] * 5 + [_L] * 12
                     + [_I] * 3 + [ctypes.c_float, _P])
# the LSE of a row that sees no key: m = NEG_INF, l clamped to 1e-30
NO_KEY_LSE = NEG_INF + math.log(1e-30)
DECODE_CHUNK = 32   # keys per warp in csrc/flash_decode.cu (CHUNK)
_ATTENTION_DTYPES = (torch.float32, torch.bfloat16)

# each attention kernel's C argument types and, by operand type, its
# (library, C entry); launches are counted under the entry's name without
# "_f32"
_ATTENTION_ENTRIES = {
    "flash_fwd": (_FWD_ARGTYPES, {
        torch.float32: ("flash_fwd", "flash_fwd_f32"),
        torch.bfloat16: ("flash_fwd_bf16", "flash_fwd_bf16")}),
    "flash_bwd_dq": (_BWD_DQ_ARGTYPES, {
        torch.float32: ("flash_bwd", "flash_bwd_dq_f32"),
        torch.bfloat16: ("flash_bwd_bf16", "flash_bwd_dq_bf16")}),
    "flash_bwd_dkv": (_BWD_DKV_ARGTYPES, {
        torch.float32: ("flash_bwd", "flash_bwd_dkv_f32"),
        torch.bfloat16: ("flash_bwd_bf16", "flash_bwd_dkv_bf16")}),
}
_launches = dict.fromkeys(
    ("flash_fwd", "flash_fwd_bf16", "flash_decode", "flash_decode_paged",
     "flash_bwd_dq", "flash_bwd_dq_bf16", "flash_bwd_dkv",
     "flash_bwd_dkv_bf16"), 0)


def _on_host(t):
    return t.device.type == "cpu"


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _launch(fn, name, device, *args):
    """Call the C entry `fn` with `args` and the current stream of
    `device`, that device current (a ring's shards may sit on several
    cards); raise on a launch error, else count the launch under `name`."""
    with (torch.cuda.device(device) if device.type == "cuda"
          else contextlib.nullcontext()):
        err = fn(*args, _stream(device))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    _launches[name] += 1


def _scale(scale, D):
    return float(1.0 / math.sqrt(D)) if scale is None else float(scale)


def can_flash(Tq, Tk, D):
    """Whether the kernels take these shapes: any lengths (ragged edges
    are masked inside them), head dims in HEAD_DIMS. The counterpart of
    the JAX `can_flash` (:685), which had Mosaic's tiling to satisfy."""
    return Tq >= 1 and Tk >= 1 and D in HEAD_DIMS


def _offset(x):
    """A causal position offset (None, a Python int or a 0-d integer
    tensor) as a Python int, read on the host."""
    if x is None:
        return 0
    if isinstance(x, torch.Tensor):
        if x.dim() != 0 or x.dtype.is_floating_point or x.is_complex():
            raise ValueError(f"an offset must be a 0-d integer tensor, got "
                             f"{tuple(x.shape)} {x.dtype}")
        return int(x.item())
    return int(x)


def _no_key_rows(Tq, causal, q_offset, k_offset, device):
    """[Tq] bool: the rows whose global position comes before every
    key's under the causal mask (q_offset + i < k_offset); None when there
    are none."""
    if not causal or q_offset >= k_offset:
        return None
    return torch.arange(Tq, device=device) + q_offset < k_offset


def _check_operands(q, dtypes=(torch.float32,), **others):
    """q and each named tensor: 4-D, of one type among `dtypes` (q's), on
    q's device, head dim dense."""
    names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
    for name, t in (("q", q), *others.items()):
        if t.dim() != 4 or t.dtype not in dtypes:
            raise ValueError(f"{name} must be a 4-D {names} tensor, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}: the "
                             "operands must share one type")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a dense head dim (stride 1)")


def _aligned(t):
    """An operand whose rows do not all start on 16-byte boundaries (data
    pointer and (b, t, h) strides: the bf16 kernels' vector loads, the
    TMA maps of the bf16 and f32 tensor-core kernels) as a dense copy;
    anything else as it is."""
    if t.data_ptr() % 16 or any(s * t.element_size() % 16
                                for s in t.stride()[:3]):
        return t.clone(memory_format=torch.contiguous_format)
    return t


def _entry(kernel, dtype):
    """(bound C function, launch-count name) of `kernel` for `dtype`."""
    argtypes, by_dtype = _ATTENTION_ENTRIES[kernel]
    lib, symbol = by_dtype[dtype]
    return (build.kernel_function(lib, symbol, argtypes),
            symbol.removesuffix("_f32"))


def _lengths_operand(lengths, S, device):
    """`lengths` as the dense int32 [S] tensor the decode kernels read."""
    lengths = torch.as_tensor(lengths, dtype=torch.int32,
                              device=device).contiguous()
    if lengths.shape != (S,):
        raise ValueError(f"lengths must be [{S}], got "
                         f"{tuple(lengths.shape)}")
    return lengths


def _check_attention_operands(q, k, v, dtypes=(torch.float32,)):
    _check_operands(q, dtypes, k=k, v=v)
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
    """The CUDA-core kernels (the forward and the backward pair at the
    head dims without a Hopper kernel) put batch*heads on the grid's y
    axis, at most 65535. The Hopper kernels put it on x, with the q or key
    tiles on y; the one limit holds for every head dim all the same, so a
    shape that runs at one head dim runs at every other."""
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
                          key_mask=None, return_lse=False, q_offset=0,
                          k_offset=0):
    """Materializing softmax attention with the kernel's semantics
    (`parallel.ring_attention.attention_reference` in float32, at the
    kernel's scale): masked scores at the finite NEG_INF, causal on global
    positions (query row i at q_offset + i, key j at k_offset + j),
    key_mask [B, Tk] (> 0 valid) shared by the heads. A row that sees no
    key under the causal mask gets out 0 and lse NO_KEY_LSE (the softmax
    would average it uniformly). Returns out [B, Tq, H, D] in q's type
    and, with `return_lse`, the per-row log-sum-exp [B, H, Tq] (f32)."""
    q_offset, k_offset = _offset(q_offset), _offset(k_offset)
    out, lse = attention_reference(
        widen(q), widen(k), widen(v), causal=causal,
        scale=_scale(scale, q.shape[3]), key_mask=key_mask, return_lse=True,
        q_offset=q_offset, k_offset=k_offset)
    none = _no_key_rows(q.shape[1], causal, q_offset, k_offset, q.device)
    if none is not None:
        out = out.masked_fill(none[None, :, None, None], 0.0)
        lse = lse.masked_fill(none, NO_KEY_LSE)
    if return_lse:
        return out.to(q.dtype), lse
    return out.to(q.dtype)


def _flash_forward(q, k, v, causal, scale, key_mask, return_lse,
                   q_offset=0, k_offset=0):
    """The forward wrapper: `flash_fwd` (f32) or `flash_fwd_bf16` for
    CUDA tensors, the plain version for CPU tensors; writes the LSE only
    with `return_lse`. The offsets are Python ints."""
    if _on_host(q):
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     key_mask=key_mask,
                                     return_lse=return_lse,
                                     q_offset=q_offset, k_offset=k_offset)
    _check_attention_operands(q, k, v, _ATTENTION_DTYPES)
    fn, name = _entry("flash_fwd", q.dtype)
    _check_bh_grid(q)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    km = _prep_key_mask(key_mask, B, Tk, q.device)
    out = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    _launch(fn, name, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _ptr(km), out.data_ptr(), _ptr(lse), B, H, Tq, Tk, D,
            *_bhd_strides(q), *_bhd_strides(k), *_bhd_strides(v),
            int(bool(causal)), q_offset, k_offset, _scale(scale, D))
    return (out, lse) if return_lse else out


class FlashAttentionLSEFunction(torch.autograd.Function):
    """Attention with its hand-written backward, out and its LSE both
    differentiable outputs: the counterpart of the JAX package's
    `_flash_lse` custom_vjp (:453-480), and of `_flash` (:430-450) when
    only out is used. Forward: the forward kernel with the LSE at the
    given causal offsets. Saves q, k, v (in their type), the key mask and
    both outputs; backward takes (g_out, g_lse), either of which may be
    None (zeros), and runs `flash_attention_bwd` with g_lse folded into
    delta; the gradients come back in the operands' type, the mask gets
    none."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, causal, scale, q_offset, k_offset):
        ctx.set_materialize_grads(False)
        out, lse = _flash_forward(q, k, v, causal, scale, key_mask, True,
                                  q_offset, k_offset)
        ctx.save_for_backward(q, k, v, key_mask, out, lse)
        ctx.kw = dict(causal=causal, scale=scale, q_offset=q_offset,
                      k_offset=k_offset)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, key_mask, out, lse = ctx.saved_tensors
        if g_out is None and g_lse is None:
            return (None,) * 8
        if g_out is None:
            g_out = torch.zeros_like(out)
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g_out,
                                         key_mask=key_mask, g_lse=g_lse,
                                         **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def _wants_grad(*ts):
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def flash_attention(q, k, v, *, causal=False, scale=None, key_mask=None,
                    return_lse=False):
    """Flash attention on [batch, time, heads, head_dim] tensors, all
    float32 or all bfloat16: the forward kernel for CUDA tensors,
    `flash_attention_plain` for CPU tensors. key_mask: optional [batch, Tk]
    (or broadcastable) key validity. Returns out [B, Tq, H, D] in q's
    type, plus lse [B, H, Tq] f32 with `return_lse`.

    Under grad mode, with an input that requires grad, the call goes
    through `FlashAttentionLSEFunction`, whose backward runs the dq and
    dk/dv kernels (the plain versions on the CPU)."""
    if return_lse or _wants_grad(q, k, v):
        res = flash_attention_lse(q, k, v, causal=causal, scale=scale,
                                  key_mask=key_mask)
        return res if return_lse else res[0]
    return _flash_forward(q, k, v, causal, scale, key_mask, False)


def flash_attention_lse(q, k, v, *, causal=False, scale=None, key_mask=None,
                        q_offset=None, k_offset=None):
    """Flash attention that also returns the per-row log-sum-exp, so that
    partial results over disjoint key shards merge exactly (the ring's
    per-step update): the counterpart of the JAX `flash_attention_lse`
    (:555-584) without the TPU block sizes. Returns (out [B, Tq, H, D] in
    q's type, lse [B, H, Tq] float32).

    q_offset / k_offset: global positions of q[0] and k[0] for the causal
    mask (None = 0; Python ints or 0-d integer tensors, read on the host);
    without `causal` they do nothing. Under grad mode, with an input that
    requires grad, runs `FlashAttentionLSEFunction`: gradients flow from
    both outputs."""
    q_offset, k_offset = _offset(q_offset), _offset(k_offset)
    if _wants_grad(q, k, v):
        km = _prep_key_mask(key_mask, q.shape[0], k.shape[1], q.device)
        return FlashAttentionLSEFunction.apply(
            q, k, v, km, bool(causal), _scale(scale, q.shape[3]), q_offset,
            k_offset)
    return _flash_forward(q, k, v, causal, scale, key_mask, True, q_offset,
                          k_offset)


# ------------------------------------------------------------ backward
def _bwd_probs(q, k, v, g, lse, delta, causal, scale, key_mask, q_offset,
               k_offset):
    """The TPU backward kernels' recompute, in float32 from upcast
    operands: p = exp(s - lse) from the masked scores, ds = p (dO.v -
    delta) scale. Both [B, H, Tq, Tk]; a row that sees no key under the
    causal mask has p = 0 (exp(s - lse) would read 1 there)."""
    scale = _scale(scale, q.shape[3])
    q_offset, k_offset = _offset(q_offset), _offset(k_offset)
    s = masked_scores(widen(q), widen(k), causal=causal, scale=scale,
                      key_mask=key_mask, q_offset=q_offset,
                      k_offset=k_offset)
    p = torch.exp(s - lse[..., None])
    none = _no_key_rows(q.shape[1], causal, q_offset, k_offset, q.device)
    if none is not None:
        p = p.masked_fill(none[None, None, :, None], 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", widen(g), widen(v))
    return p, p * (dp - delta[..., None]) * scale


def attention_delta(out, g):
    """delta = rowsum(dO o O), [B, H, Tq] float32 from the upcast operands:
    the row contraction the JAX package forms outside its backward kernels
    (:342-349)."""
    return torch.einsum("bqhd,bqhd->bhq", widen(g), widen(out))


def flash_bwd_dq_plain(q, k, v, g, lse, delta, *, causal=False, scale=None,
                       key_mask=None, q_offset=0, k_offset=0):
    """dq [B, Tq, H, D] in q's type from the recomputed ds: sum over keys
    of ds.K."""
    _, ds = _bwd_probs(q, k, v, g, lse, delta, causal, scale, key_mask,
                       q_offset, k_offset)
    return torch.einsum("bhqk,bkhd->bqhd", ds, widen(k)).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, g, lse, delta, *, causal=False, scale=None,
                        key_mask=None, q_offset=0, k_offset=0):
    """(dk, dv) [B, Tk, H, D] in k's and v's type: sums over queries of
    ds^T.Q and p^T.dO."""
    p, ds = _bwd_probs(q, k, v, g, lse, delta, causal, scale, key_mask,
                       q_offset, k_offset)
    return (torch.einsum("bhqk,bqhd->bkhd", ds, widen(q)).to(k.dtype),
            torch.einsum("bhqk,bqhd->bkhd", p, widen(g)).to(v.dtype))


def _delta(out, g, g_lse=None):
    """delta with the LSE's cotangent folded in: rowsum(dO o O) - g_lse
    (:342-348); g_lse None means zeros."""
    delta = attention_delta(out, g)
    return delta if g_lse is None else delta - widen(g_lse)


def flash_attention_bwd_plain(q, k, v, out, lse, g, *, causal=False,
                              scale=None, key_mask=None, q_offset=0,
                              k_offset=0, g_lse=None):
    """(dq, dk, dv) of attention given the forward's out and lse [B, H,
    Tq] and the cotangents g of out and g_lse of lse: the plain version of
    both backward kernels, with their recompute (p from lse, delta from
    out and g_lse) and the forward's masking."""
    delta = _delta(out, g, g_lse)
    p, ds = _bwd_probs(q, k, v, g, lse, delta, causal, scale, key_mask,
                       q_offset, k_offset)
    return (torch.einsum("bhqk,bkhd->bqhd", ds, widen(k)).to(q.dtype),
            torch.einsum("bhqk,bqhd->bkhd", ds, widen(q)).to(k.dtype),
            torch.einsum("bhqk,bqhd->bkhd", p, widen(g)).to(v.dtype))


def _bwd_operands(q, k, v, g, lse, delta, key_mask):
    """Checks shared by the two backward launches; returns (q, k, v, g,
    lse, delta, key mask) in the layouts the kernels read."""
    _check_attention_operands(q, k, v, _ATTENTION_DTYPES)
    _check_bh_grid(q)
    B, Tq, H, _ = q.shape
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(f"dO must be {q.dtype} {tuple(q.shape)} on "
                         f"{q.device}, got {tuple(g.shape)} {g.dtype}")
    if g.stride(-1) != 1:           # e.g. an expanded cotangent: stride 0
        g = g.contiguous()
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (B, H, Tq) or t.dtype != torch.float32 \
                or t.device != q.device:
            raise ValueError(f"{name} must be float32 {(B, H, Tq)} on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype}")
    return (_aligned(q), _aligned(k), _aligned(v), _aligned(g),
            lse.contiguous(), delta.contiguous(),
            _prep_key_mask(key_mask, B, k.shape[1], q.device))


def flash_bwd_dq(q, k, v, g, lse, delta, *, causal=False, scale=None,
                 key_mask=None, q_offset=0, k_offset=0):
    """dq [B, Tq, H, D] in q's type: the dq kernel (f32 or bf16) for CUDA
    tensors, `flash_bwd_dq_plain` for CPU tensors. g is dO; lse and delta
    are [B, H, Tq] float32."""
    q_offset, k_offset = _offset(q_offset), _offset(k_offset)
    if _on_host(q):
        return flash_bwd_dq_plain(q, k, v, g, lse, delta, causal=causal,
                                  scale=scale, key_mask=key_mask,
                                  q_offset=q_offset, k_offset=k_offset)
    q, k, v, g, lse, delta, km = _bwd_operands(q, k, v, g, lse, delta,
                                               key_mask)
    fn, name = _entry("flash_bwd_dq", q.dtype)
    B, Tq, H, D = q.shape
    dq = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    _launch(fn, name, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            g.data_ptr(), lse.data_ptr(), delta.data_ptr(), _ptr(km),
            dq.data_ptr(), B, H, Tq, k.shape[1], D,
            *_bhd_strides(q), *_bhd_strides(k), *_bhd_strides(v),
            *_bhd_strides(g), int(bool(causal)), q_offset, k_offset,
            _scale(scale, D))
    return dq


def flash_bwd_dkv(q, k, v, g, lse, delta, *, causal=False, scale=None,
                  key_mask=None, q_offset=0, k_offset=0):
    """(dk, dv) [B, Tk, H, D] in k's type: the dk/dv kernel (f32 or bf16)
    for CUDA tensors, `flash_bwd_dkv_plain` for CPU tensors."""
    q_offset, k_offset = _offset(q_offset), _offset(k_offset)
    if _on_host(q):
        return flash_bwd_dkv_plain(q, k, v, g, lse, delta, causal=causal,
                                   scale=scale, key_mask=key_mask,
                                   q_offset=q_offset, k_offset=k_offset)
    q, k, v, g, lse, delta, km = _bwd_operands(q, k, v, g, lse, delta,
                                               key_mask)
    fn, name = _entry("flash_bwd_dkv", q.dtype)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    dk = torch.empty((B, Tk, H, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, Tk, H, D), dtype=v.dtype, device=q.device)
    _launch(fn, name, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            g.data_ptr(), lse.data_ptr(), delta.data_ptr(), _ptr(km),
            dk.data_ptr(), dv.data_ptr(), B, H, Tq, Tk, D,
            *_bhd_strides(q), *_bhd_strides(k), *_bhd_strides(v),
            *_bhd_strides(g), int(bool(causal)), q_offset, k_offset,
            _scale(scale, D))
    return dk, dv


def flash_attention_bwd(q, k, v, out, lse, g, *, causal=False, scale=None,
                        key_mask=None, q_offset=0, k_offset=0, g_lse=None):
    """(dq, dk, dv) given the forward's out and lse and the cotangents g
    (of out) and g_lse (of lse, None = zeros): `flash_attention_bwd_plain`
    for CPU tensors; for CUDA tensors delta = rowsum(dO o O) - g_lse as a
    float32 torch reduction, then the dq and dk/dv kernels."""
    kw = dict(causal=causal, scale=scale, key_mask=key_mask,
              q_offset=q_offset, k_offset=k_offset)
    if _on_host(q):
        return flash_attention_bwd_plain(q, k, v, out, lse, g, g_lse=g_lse,
                                         **kw)
    delta = _delta(out, g, g_lse)
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
    _launch(fn, "flash_decode", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            work.data_ptr(), S, H, C, D, q.stride(0), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), _scale(scale, D))
    return out


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
    _check_operands(q, k_pool=k_pool, v_pool=v_pool)
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
    _launch(fn, "flash_decode_paged", q.device, q.data_ptr(),
            k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), work.data_ptr(), S, H, MB,
            bs, D, q.stride(0), q.stride(2), *_bhd_strides(k_pool),
            *_bhd_strides(v_pool), _scale(scale, D))
    return out


def launch_counts():
    """{kernel name: launches} of every hand kernel (the bf16 entries under
    their own names)."""
    return dict(_launches)


def reset_launch_counts():
    for name in _launches:
        _launches[name] = 0
