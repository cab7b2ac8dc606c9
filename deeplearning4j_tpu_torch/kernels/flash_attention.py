"""Attention kernels for Hopper, the port of
deeplearning4j_tpu/kernels/flash_attention.py.

Fourteen hand-written CUDA kernels, each behind a wrapper with its plain
PyTorch version beside it:

- `flash_attention` -> `csrc/flash_fwd.cu` (`flash_fwd_f32`; on the
  tensor cores, each float32 product as three TF32 products) for float32
  and `csrc/flash_fwd_bf16.cu` (`flash_fwd_bf16`, tensor cores) for
  bfloat16, both on tensor maps of the true D at every head dim up to
  256, replacing the TPU kernel `_flash_kernel`
  (flash_attention.py:84-143, `pl.pallas_call` at :206) as
  `flash_attention` (:512) runs it:
  causal, key-masked attention for the decode prefill and, with its
  log-sum-exp, the training forward; and as `flash_attention_lse` (:555)
  runs it on the ring, with the causal mask at global positions (query
  row i at q_offset + i, key j at k_offset + j). Plain version:
  `flash_attention_plain`.
- `flash_bwd_dq` -> `csrc/flash_bwd.cu` (`flash_bwd_dq_f32`; on the
  tensor cores at every width, each float32 product as three TF32
  products) and `csrc/flash_bwd_bf16.cu` (`flash_bwd_dq_bf16`; `wgmma` +
  TMA at every width, at head dims 8 to 32 on 64B-swizzled 32-column
  tiles), both on tensor maps of the true D at every head dim up to 256,
  replacing `_bwd_dq_kernel` (:226-273, `pallas_call` :366); plain
  version `flash_bwd_dq_plain`.
- `flash_bwd_dkv` -> `csrc/flash_bwd.cu` (`flash_bwd_dkv_f32`, likewise)
  and `csrc/flash_bwd_bf16.cu` (`flash_bwd_dkv_bf16`, likewise), replacing
  `_bwd_dkv_kernel` (:276-330, `pallas_call` :388); plain version
  `flash_bwd_dkv_plain`.
- `flash_decode` -> `csrc/flash_decode.cu`, replacing `_flash_kernel` as
  `flash_decode` (:604-645) runs it: one query per cache slot against a
  [slots, capacity, heads, head_dim] float32 cache masked by `lengths`.
  Plain version: `flash_decode_plain`, the twin of `_decode_reference`
  (:587-601).
- `flash_decode_paged` -> `csrc/flash_decode_paged.cu`, replacing
  `_flash_kernel` as `flash_decode_paged` (:648-682) runs it: the same
  decode attention over a float32 [num_blocks, block_size, heads,
  head_dim] pool of power-of-two blocks, reading each slot's keys through
  its row of an int32 block table inside the kernel (the reference
  gathers the pool first). Plain version: `flash_decode_paged_plain`, the
  gather followed by `flash_decode_plain`. Any other pool is gathered
  through the table first, as the reference does, and decoded as a slab.
- Head dims above 256: `csrc/flash_wide.cu`, the forward
  (`flash_wide_fwd`), dq (`flash_wide_dq`) and dk/dv (`flash_wide_dkv`),
  each in float32 and bfloat16 (`_bf16`), the head dim a runtime value;
  the same plain versions.

Types, as the TPU kernels have them: q, k, v (and dO) are all float32,
all bfloat16 or all float16, and every entry dispatches on that type
(mixed or other types raise); out, dq, dk and dv come back in the
operands' type; the LSE, delta and the key mask are float32. The plain
versions compute in float32 (float64 stays float64) and round to the
operands' type once at the end, as the TPU kernels do. On a CUDA tensor:
- float32: the float32 kernels.
- bfloat16: the bfloat16 attention kernels. The decode entries run the
  bfloat16 forward under the key mask `position < lengths`, the
  reference's own route (its `flash_decode` runs its forward kernel,
  :604-645), counted under `<entry>_bf16` in `route_counts()`.
- float16: the operands upcast to float32 in the wrapper, the float32
  kernels, the results (out, dq, dk, dv) cast back to float16: the TPU
  kernels' own arithmetic (any float operand upcast on entry, :106-108,
  f32 sums, the output in q's type, :140). Counted under `<entry>_f16`.

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
noted at the top of its source. A wrapper runs the plain version for a
tensor on the CPU, as the tests do. For a CUDA tensor it chooses by head
dim D, by the reference's rule (`_plan`, :492-502: its kernel runs every
D % 8 == 0, and only D % 8 != 0 goes to its plain path), stated once in
`kernel_head_dim`:

- D % 8 == 0, D <= 256: a hand kernel, which the C entry runs at the
  compiled width for D (`hopper::compiled_width`: 32 for D = 8 to 32,
  else the next of 64, 128 and 256). Every attention entry, the forward
  and the backward pair in f32 and bf16, reads the caller's q, k, v (and
  dO) through tensor maps D columns wide (TMA fills the columns past D
  with zeros, which add nothing to a score) at the true D's scale, 1 /
  sqrt(D), and writes out, dq, dk and dv dense and D columns wide: no
  entry pads or slices, and a call is one kernel. The decode kernels
  take the runtime D and guard their columns (padding the cache would
  copy it on every step).
- D % 8 == 0, D > 256: the wide kernels of `csrc/flash_wide.cu`
  (forward with or without the LSE, dq, dk/dv; float32 and bfloat16), the
  head dim a runtime value, nothing padded. Such a call counts one
  `<kernel>_wide` in `route_counts()` and its launch under the wide
  entry's name (`flash_wide_fwd`, `flash_wide_dq`, `flash_wide_dkv`, with
  `_bf16` for bf16 operands). The decode entries run the wide forward at
  such a D as the reference's decode runs its forward kernel: a key mask
  `position < lengths` (`flash_decode` :604-645), over the pool gathered
  through the block table first for the paged entry (`jnp.take`,
  :648-682), counted under `flash_decode_wide` / `flash_decode_paged_wide`.
- D % 8 != 0: the plain version, the reference's choice, counted under
  `<kernel>_plain_by_shape` in `route_counts()`.

Otherwise a CUDA tensor launches the kernel or raises: a failed build or
launch never falls back. Each launch adds one to its kernel's count in
`launch_counts()`, where the kernel launches and nowhere else. Every
attention kernel takes batch * heads and its tiles on a one-dimensional
grid (up to 2^31 - 1 blocks), so any batch and head count is one launch.

Layouts are the JAX package's: [batch, time, heads, head_dim]; lse and
delta are [batch, heads, Tq]. There is no tile-divisibility rule:
ragged lengths are masked inside the kernels.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import threading

import torch

from ..parallel.ring_attention import (NEG_INF, attention_reference,
                                       masked_scores, widen)
from . import build

# the head-dim classes `kernel_head_dim` rounds up to (the C entries run
# every class up to 32 on the width-32 kernels, `hopper::compiled_width`);
# past the last a head dim runs at its own width on the wide kernels
HEAD_DIMS = (16, 32, 64, 128, 256)
WIDEST_COMPILED = HEAD_DIMS[-1]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# ... causal, q_offset, k_offset, scale, stream
_FWD_ARGTYPES = ([_P] * 6 + [_I] * 5 + [_L] * 9
                 + [_I] * 3 + [ctypes.c_float, _P])
# ... S, H, C, D, n (CTAs per (slot, head)), strides, scale, stream
_DECODE_ARGTYPES = ([_P] * 5 + [_I] * 5 + [_L] * 8
                    + [ctypes.c_float, _P])
_DECODE_PAGED_ARGTYPES = ([_P] * 6 + [_I] * 6 + [_L] * 8
                          + [ctypes.c_float, _P])
_BWD_DQ_ARGTYPES = ([_P] * 8 + [_I] * 5 + [_L] * 12
                    + [_I] * 3 + [ctypes.c_float, _P])
_BWD_DKV_ARGTYPES = ([_P] * 9 + [_I] * 5 + [_L] * 12
                     + [_I] * 3 + [ctypes.c_float, _P])
# the LSE of a row that sees no key: m = NEG_INF, l clamped to 1e-30
NO_KEY_LSE = NEG_INF + math.log(1e-30)
DECODE_UNIT = 32    # keys of a unit: a decode CTA's range is whole units
DECODE_ROUND = 64   # keys of one 16-key step of each of a CTA's 4 warps
DECODE_MAX_SPLIT = 8    # CTAs per (slot, head): the portable cluster size
_ATTENTION_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

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
# the wide entries (csrc/flash_wide.cu) by attention kernel
_WIDE_SYMBOLS = {"flash_fwd": "flash_wide_fwd", "flash_bwd_dq": "flash_wide_dq",
                 "flash_bwd_dkv": "flash_wide_dkv"}
_ATTENTION_NAMES = ("flash_fwd", "flash_fwd_bf16", "flash_bwd_dq",
                    "flash_bwd_dq_bf16", "flash_bwd_dkv", "flash_bwd_dkv_bf16")
_launches = dict.fromkeys(
    ("flash_fwd", "flash_fwd_bf16", "flash_decode", "flash_decode_paged",
     "flash_bwd_dq", "flash_bwd_dq_bf16", "flash_bwd_dkv",
     "flash_bwd_dkv_bf16", "flash_wide_fwd", "flash_wide_fwd_bf16",
     "flash_wide_dq", "flash_wide_dq_bf16", "flash_wide_dkv",
     "flash_wide_dkv_bf16"), 0)
_ENTRY_ROUTES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                 "flash_decode", "flash_decode_paged")
# calls a CUDA tensor made at a head dim the wide kernels take and at one
# the reference runs plainly; float16 calls (upcast), bfloat16 decode
# calls (the bf16 forward) and paged calls whose pool the paged kernel
# cannot read (gathered first)
_routes = dict.fromkeys(
    [f"{k}_wide" for k in _ATTENTION_NAMES
       + ("flash_decode", "flash_decode_paged")]
    + [f"{k}_plain_by_shape" for k in _ENTRY_ROUTES]
    + [f"{k}_f16" for k in _ENTRY_ROUTES]
    + ["flash_decode_bf16", "flash_decode_paged_bf16",
       "flash_decode_paged_gather"], 0)


# the counts are bumped from every thread that runs a model (the /predict
# batcher and the decode scheduler may run one model at once)
_COUNT_LOCK = threading.Lock()


def _bump(counts, key, n=1):
    with _COUNT_LOCK:
        counts[key] += n


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
    _bump(_launches, name)


def _scale(scale, D):
    return float(1.0 / math.sqrt(D)) if scale is None else float(scale)


def kernel_head_dim(D):
    """The width a kernel runs head dim D at, by the reference's rule
    (`_plan` :492-502 runs its kernel for every D % 8 == 0): the next of
    HEAD_DIMS up to WIDEST_COMPILED, D itself above it (the wide kernels'
    runtime width); None for D % 8 != 0, which the reference routes to its
    plain path. Up to WIDEST_COMPILED every attention entry runs its
    kernel on the true D's memory; the C entries pick the compiled width
    themselves (`hopper::compiled_width`)."""
    if D < 1 or D % 8:
        return None
    if D > WIDEST_COMPILED:
        return D
    return next(w for w in HEAD_DIMS if w >= D)


def can_flash(Tq, Tk, D):
    """Whether the kernels take these shapes: any lengths (ragged edges
    are masked inside them), every head dim D % 8 == 0, as the JAX
    `can_flash` (:685) gives in interpret mode (on the TPU it had Mosaic's
    tiling of the lengths to satisfy)."""
    return Tq >= 1 and Tk >= 1 and D >= 1 and D % 8 == 0


def _plain_by_shape(kernel):
    _bump(_routes, f"{kernel}_plain_by_shape")


def _ptr(t):
    return None if t is None else t.data_ptr()


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


def _entry(kernel, dtype, Dp, route=None):
    """(bound C function, launch-count name) of `kernel` for `dtype` at
    width Dp: above WIDEST_COMPILED the wide entry, the call counted under
    `<route>_wide` (by default the kernel's own launch name)."""
    argtypes, by_dtype = _ATTENTION_ENTRIES[kernel]
    lib, symbol = by_dtype[dtype]
    if Dp > WIDEST_COMPILED:
        _bump(_routes, f"{route or symbol.removesuffix('_f32')}_wide")
        lib = "flash_wide"
        symbol = _WIDE_SYMBOLS[kernel] + (
            "_bf16" if dtype == torch.bfloat16 else "_f32")
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
    if q.shape[1] < 1 or k.shape[1] < 1:
        raise ValueError("empty sequence")


def _prep_key_mask(key_mask, B, Tk, device):
    """[B, Tk] float32 contiguous key validity, or None."""
    if key_mask is None:
        return None
    return torch.broadcast_to(torch.as_tensor(key_mask, device=device),
                              (B, Tk)).to(torch.float32).contiguous()


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


def _upcast_f16(kernel, *ts):
    """float16 operands `ts` as float32 (a new tensor each), the call
    counted under `<kernel>_f16`."""
    _bump(_routes, f"{kernel}_f16")
    return tuple(t.float() for t in ts)


def _flash_forward(q, k, v, causal, scale, key_mask, return_lse,
                   q_offset=0, k_offset=0):
    """The forward wrapper: `flash_fwd` (f32; float16 operands upcast, at
    their true head dim too) or `flash_fwd_bf16` for CUDA tensors at a
    head dim `kernel_head_dim` takes (`_forward_launch`; the wide kernel
    above WIDEST_COMPILED), the plain version for CPU tensors and for the
    head dims the reference runs plainly; writes the LSE only with
    `return_lse`. The offsets are Python ints."""
    plain = functools.partial(
        flash_attention_plain, q, k, v, causal=causal, scale=scale,
        key_mask=key_mask, return_lse=return_lse, q_offset=q_offset,
        k_offset=k_offset)
    if _on_host(q):
        return plain()
    _check_attention_operands(q, k, v, _ATTENTION_DTYPES)
    Dp = kernel_head_dim(q.shape[3])
    if Dp is None:
        _plain_by_shape("flash_fwd")
        return plain()
    if q.dtype == torch.float16:
        res = _forward_launch(*_upcast_f16("flash_fwd", q, k, v), causal,
                              scale, key_mask, return_lse, q_offset,
                              k_offset, Dp)
        return (res[0].half(), res[1]) if return_lse else res.half()
    return _forward_launch(q, k, v, causal, scale, key_mask, return_lse,
                           q_offset, k_offset, Dp)


def _forward_launch(q, k, v, causal, scale, key_mask, return_lse, q_offset,
                    k_offset, Dp, route=None):
    """One launch of the forward kernel for head dim D at width Dp (see
    `_entry` for `route`) on checked CUDA operands: the caller's q, k and
    v (a dense copy only where `_aligned` needs one) at their own D, which
    the C entries read through tensor maps D columns wide; returns out
    [B, Tq, H, D] as the kernel wrote it (and the LSE)."""
    B, Tq, H, D = q.shape
    fn, name = _entry("flash_fwd", q.dtype, Dp, route)
    scale = _scale(scale, D)
    q, k, v = map(_aligned, (q, k, v))
    Tk = k.shape[1]
    km = _prep_key_mask(key_mask, B, Tk, q.device)
    out = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    _launch(fn, name, q.device, *map(_ptr, (q, k, v, km, out, lse)), B, H,
            Tq, Tk, D, *_bhd_strides(q), *_bhd_strides(k),
            *_bhd_strides(v), int(bool(causal)), q_offset, k_offset, scale)
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
    """Checks shared by the two backward launches (after `_bwd_route`'s);
    returns (q, k, v, g, lse, delta, key mask) in the layouts the kernels
    read: q, k, v and g the caller's own tensors at their own head dim
    where their rows suit the kernels (`_aligned`), which read them through
    tensor maps D columns wide."""
    B, Tq, H, D = q.shape
    if g.stride(-1) != 1:           # e.g. an expanded cotangent: stride 0
        g = g.contiguous()
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (B, H, Tq) or t.dtype != torch.float32 \
                or t.device != q.device:
            raise ValueError(f"{name} must be float32 {(B, H, Tq)} on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype}")
    return (*map(_aligned, (q, k, v, g)), lse.contiguous(), delta.contiguous(),
            _prep_key_mask(key_mask, B, k.shape[1], q.device))


def _bwd_rest(q, k, v, g, causal, q_offset, k_offset, scale):
    """The backward entries' arguments after B and H."""
    return (q.shape[1], k.shape[1], q.shape[3], *_bhd_strides(q),
            *_bhd_strides(k),
            *_bhd_strides(v), *_bhd_strides(g), int(bool(causal)), q_offset,
            k_offset, scale)


def _bwd_route(kernel, q, k, v, g):
    """The compiled width the backward kernel `kernel` runs q's head dim
    at, or None (counted) where the reference runs its plain path; checks
    the operands and dO first."""
    _check_attention_operands(q, k, v, _ATTENTION_DTYPES)
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(f"dO must be {q.dtype} {tuple(q.shape)} on "
                         f"{q.device}, got {tuple(g.shape)} {g.dtype}")
    Dp = kernel_head_dim(q.shape[3])
    if Dp is None:
        _plain_by_shape(kernel)
    return Dp


def flash_bwd_dq(q, k, v, g, lse, delta, *, causal=False, scale=None,
                 key_mask=None, q_offset=0, k_offset=0):
    """dq [B, Tq, H, D] in q's type: the dq kernel (f32 or bf16; float16
    operands upcast) for CUDA tensors, `flash_bwd_dq_plain` for CPU
    tensors. g is dO; lse and delta are [B, H, Tq] float32. Either kernel
    reads q, k, v and dO at their own head dim and writes dq at it."""
    q_offset, k_offset = _offset(q_offset), _offset(k_offset)
    kw = dict(causal=causal, scale=scale, key_mask=key_mask,
              q_offset=q_offset, k_offset=k_offset)
    if _on_host(q):
        return flash_bwd_dq_plain(q, k, v, g, lse, delta, **kw)
    Dp = _bwd_route("flash_bwd_dq", q, k, v, g)
    if Dp is None:
        return flash_bwd_dq_plain(q, k, v, g, lse, delta, **kw)
    if q.dtype == torch.float16:
        return flash_bwd_dq(*_upcast_f16("flash_bwd_dq", q, k, v, g), lse,
                            delta, **kw).half()
    B, Tq, H, D = q.shape
    scale = _scale(scale, D)
    q, k, v, g, lse, delta, km = _bwd_operands(q, k, v, g, lse, delta,
                                               key_mask)
    fn, name = _entry("flash_bwd_dq", q.dtype, Dp)
    dq = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    _launch(fn, name, q.device, *map(_ptr, (q, k, v, g, lse, delta, km, dq)),
            B, H, *_bwd_rest(q, k, v, g, causal, q_offset, k_offset, scale))
    return dq


def flash_bwd_dkv(q, k, v, g, lse, delta, *, causal=False, scale=None,
                  key_mask=None, q_offset=0, k_offset=0):
    """(dk, dv) [B, Tk, H, D] in k's type: the dk/dv kernel (f32 or bf16;
    float16 operands upcast) for CUDA tensors, `flash_bwd_dkv_plain` for
    CPU tensors. As `flash_bwd_dq`, either kernel at the operands' own
    head dim."""
    q_offset, k_offset = _offset(q_offset), _offset(k_offset)
    kw = dict(causal=causal, scale=scale, key_mask=key_mask,
              q_offset=q_offset, k_offset=k_offset)
    if _on_host(q):
        return flash_bwd_dkv_plain(q, k, v, g, lse, delta, **kw)
    Dp = _bwd_route("flash_bwd_dkv", q, k, v, g)
    if Dp is None:
        return flash_bwd_dkv_plain(q, k, v, g, lse, delta, **kw)
    if q.dtype == torch.float16:
        dk, dv = flash_bwd_dkv(*_upcast_f16("flash_bwd_dkv", q, k, v, g),
                               lse, delta, **kw)
        return dk.half(), dv.half()
    B, Tq, H, D = q.shape
    scale = _scale(scale, D)
    q, k, v, g, lse, delta, km = _bwd_operands(q, k, v, g, lse, delta,
                                               key_mask)
    fn, name = _entry("flash_bwd_dkv", q.dtype, Dp)
    Tk = k.shape[1]
    dk = torch.empty((B, Tk, H, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, Tk, H, D), dtype=v.dtype, device=q.device)
    _launch(fn, name, q.device,
            *map(_ptr, (q, k, v, g, lse, delta, km, dk, dv)), B, H,
            *_bwd_rest(q, k, v, g, causal, q_offset, k_offset, scale))
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
@functools.cache
def _sm_count(index):
    """The SM count of CUDA device `index`, read once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_split(pairs, keys, unit, sms):
    """CTAs per (slot, head) of the decode kernels (the cluster size) for
    `pairs` (slot, head) pairs over a capacity of `keys` keys in units of
    `unit`: the largest n of 1, 2, 4 and 8 at which the pairs * n CTAs
    still fit one wave of `sms` SMs and each CTA has a whole unit and
    DECODE_ROUND keys of the capacity; at least 2 where the capacity
    holds two such shares, so that on a grid of more than a wave the
    longest slots' CTAs, which end the grid, take half as long. Measured
    on the H100 (PERF.md, section 6): at the serving step 4 beat 1, 2 and
    8; at S=64 slots of up to 4096 keys, H=8, 2 beat 1 (paged 0.214 ->
    0.187 ms)."""
    cap = min(-(-keys // unit), max(1, keys // DECODE_ROUND))
    n = 2 if cap >= 2 else 1
    while n < DECODE_MAX_SPLIT and 2 * n <= cap and pairs * 2 * n <= sms:
        n *= 2
    return n


def decode_cta_keys(kmax, n, rank, unit=DECODE_UNIT):
    """[lo, hi) keys of CTA `rank` of a (slot, head)'s n, over its kmax
    valid keys: whole units of `unit` keys (DECODE_UNIT; the paged kernel
    max(DECODE_UNIT, block size), so whole pool blocks), shared out as
    evenly as integers allow. The decode kernels' split
    (csrc/decode_common.cuh `cta_range`)."""
    units = -(-kmax // unit)
    lo = rank * units // n * unit
    return lo, max(lo, min((rank + 1) * units // n * unit, kmax))


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
    heads, head_dim], lengths [slots] valid entries per slot. For CUDA
    tensors the route of `_decode` (float32: the `flash_decode` kernel);
    `flash_decode_plain` for CPU tensors. Returns [slots, 1, heads,
    head_dim] in q's type."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"flash_decode takes one query per slot, got q "
                         f"{tuple(q.shape)}")
    if _on_host(q):
        return flash_decode_plain(q, k, v, lengths, scale=scale)
    _check_attention_operands(q, k, v, _ATTENTION_DTYPES)
    if kernel_head_dim(q.shape[3]) is None:
        _plain_by_shape("flash_decode")
        return flash_decode_plain(q, k, v, lengths, scale=scale)
    return _decode(q, k, v, _lengths_operand(lengths, q.shape[0], q.device),
                   scale, "flash_decode")


def _decode(q, k, v, lengths, scale, route):
    """Decode attention on checked CUDA operands over a [S, C] cache (the
    paged entry's gathered through its table) at a head dim a kernel
    takes, `route` the entry's name in `route_counts()`:
    - float16: counted `<route>_f16`; the operands upcast to float32, the
      float32 route below, the output cast back to float16.
    - bfloat16: counted `<route>_bf16`; the bf16 forward kernel under the
      key mask `position < lengths`, as the reference's `flash_decode`
      (:604-645) runs its forward kernel, at `kernel_head_dim(D)` on the
      cache's own memory (`_forward_launch`; the wide kernel above
      WIDEST_COMPILED).
    - float32 above WIDEST_COMPILED: the wide forward likewise, counted
      `<route>_wide`.
    - float32: the `flash_decode` kernel, one launch."""
    if q.dtype == torch.float16:
        return _decode(*_upcast_f16(route, q, k, v), lengths, scale,
                       route).half()
    S, _, H, D = q.shape
    C = k.shape[1]
    Dp = kernel_head_dim(D)
    if q.dtype == torch.bfloat16 or Dp > WIDEST_COMPILED:
        if q.dtype == torch.bfloat16:
            _bump(_routes, f"{route}_bf16")
        valid = torch.arange(C, device=q.device)[None, :] < lengths[:, None]
        return _forward_launch(q, k, v, False, scale, valid, False, 0, 0, Dp,
                               route)
    fn = build.kernel_function("flash_decode", "flash_decode_f32",
                               _DECODE_ARGTYPES)
    # the kernel loads rows as vectors: rows 16-byte aligned (a cache the
    # engine allocates always is; another is copied dense first)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty((S, 1, H, D), dtype=torch.float32, device=q.device)
    n = decode_split(S * H, C, DECODE_UNIT, _sm_count(q.device.index))
    _launch(fn, "flash_decode", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), lengths.data_ptr(), out.data_ptr(), S, H, C, D, n,
            q.stride(0), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
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
    """Checks of the paged entry; returns (table, lengths) as the dense
    int32 tensors the kernel reads."""
    _check_operands(q, _ATTENTION_DTYPES, k_pool=k_pool, v_pool=v_pool)
    S, _, H, D = q.shape
    if k_pool.shape != v_pool.shape or k_pool.shape[2:] != (H, D) \
            or k_pool.shape[1] < 1:
        raise ValueError(f"pools k {tuple(k_pool.shape)} / v "
                         f"{tuple(v_pool.shape)} do not match q heads and "
                         f"head dim {(H, D)}")
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
    For CUDA tensors: float32 pools of power-of-two blocks at a compiled
    width run the `flash_decode_paged` kernel, which reads K/V through the
    table; any other pool is gathered through the table first, as the
    reference does (:675-682), and decoded by `_decode` (float32 blocks of
    another size counted under `flash_decode_paged_gather`).
    `flash_decode_paged_plain` for CPU tensors. Returns [slots, 1, heads,
    head_dim] in q's type."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"flash_decode_paged takes one query per slot, got "
                         f"q {tuple(q.shape)}")
    plain = functools.partial(flash_decode_paged_plain, q, k_pool, v_pool,
                              block_table, lengths, scale=scale)
    if _on_host(q):
        return plain()
    table, lengths = _check_paged_operands(q, k_pool, v_pool, block_table,
                                           lengths)
    S, _, H, D = q.shape
    Dp = kernel_head_dim(D)
    if Dp is None:
        _plain_by_shape("flash_decode_paged")
        return plain()
    MB, bs = table.shape[1], k_pool.shape[1]
    if q.dtype != torch.float32 or Dp > WIDEST_COMPILED or bs & (bs - 1):
        # the reference gathers the pool through the table first (:675-682)
        if q.dtype == torch.float32 and Dp <= WIDEST_COMPILED:
            _bump(_routes, "flash_decode_paged_gather")
        idx = table.long()
        k = k_pool[idx].reshape(S, MB * bs, H, D)
        v = v_pool[idx].reshape(S, MB * bs, H, D)
        return _decode(q, k, v, lengths, scale, "flash_decode_paged")
    fn = build.kernel_function("flash_decode_paged", "flash_decode_paged_f32",
                               _DECODE_PAGED_ARGTYPES)
    q, k_pool, v_pool = _aligned(q), _aligned(k_pool), _aligned(v_pool)
    out = torch.empty((S, 1, H, D), dtype=torch.float32, device=q.device)
    n = decode_split(S * H, MB * bs, max(DECODE_UNIT, bs),
                     _sm_count(q.device.index))
    _launch(fn, "flash_decode_paged", q.device, q.data_ptr(),
            k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), S, H, MB, bs, D, n,
            q.stride(0), q.stride(2), *_bhd_strides(k_pool),
            *_bhd_strides(v_pool), _scale(scale, D))
    return out


def launch_counts():
    """{kernel name: launches} of every hand kernel (the bf16 entries under
    their own names)."""
    return dict(_launches)


def route_counts():
    """{"<kernel>_wide": calls at a head dim above WIDEST_COMPILED
    (no entry pads: every head dim up to it runs on its own memory),
    "<entry>_plain_by_shape":
    calls run plainly because the reference does, "<entry>_f16": float16
    calls (upcast), "flash_decode[_paged]_bf16": bfloat16 decode calls
    (the bf16 forward), "flash_decode_paged_gather": float32 paged calls
    on blocks of a size that is not a power of two} of CUDA tensors; reset
    with the launch counts."""
    return dict(_routes)


def graph_counts(since=None):
    """Every kernel's launches and every route's calls so far, in one
    dict (the two sets of names are disjoint); with `since`, an earlier
    such dict, what was added after it. A CUDA graph's capture records
    launches without running them: the caller takes the capture's counts
    out and adds them back at each replay (`add_graph_counts`), so that
    `launch_counts()` stays the number of launches the card ran."""
    now = {**_launches, **_routes}
    if since is None:
        return now
    return {k: n - since.get(k, 0) for k, n in now.items()
            if n != since.get(k, 0)}


def add_graph_counts(counts, times=1):
    """Add `times` x `counts` (a `graph_counts(since)` dict) to the
    launch and route counts."""
    for k, n in counts.items():
        _bump(_launches if k in _launches else _routes, k, n * int(times))


def reset_launch_counts():
    with _COUNT_LOCK:
        for counts in (_launches, _routes):
            for name in counts:
                counts[name] = 0
