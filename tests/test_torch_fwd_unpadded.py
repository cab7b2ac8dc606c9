"""The attention forward at every padded head dim, on the CPU.

The C entries flash_fwd_f32 (csrc/flash_fwd.cu) and flash_fwd_bf16
(csrc/flash_fwd_bf16.cu) take the true head dim D, every D % 8 == 0 from
8 to 256, and run it at the next compiled width DP
(`hopper::compiled_width`: 32 for D = 8..32, else the next of 64, 128 and
256) on the caller's own memory:

- q, k and v through tensor maps D columns wide. A tile of DP columns
  lands as DP / BOX boxes (float32: BOX = 32 columns, the 128B swizzle;
  bf16: 32 with the 64B swizzle at DP = 32, else 64 with the 128B one),
  every box issued and counted whole in the mbarrier's expected bytes;
  TMA fills each element past column D (and past row T) with zeros, a box
  that starts at or past D included (float32 at width 128: the box at
  column 96 for D = 72..96; at width 256 the boxes from column 160 on for
  D = 136; bf16 at width 256: the box at 192 for D = 136..192).
- out written dense [B, Tq, H, D]: each accumulator box at column col0 of
  head h, batch b, writes rows below Tq at base (b Tq H + h) D, row stride
  H D, and min(box, D - col0) columns, none where col0 >= D (float32:
  boxes of one P V product, 32 or 64 columns, and all 256 at width 256;
  bf16: 32 at width 32, else 64). The LSE is written [B, H, Tq] as before.

The wrapper therefore makes no pad copy and no slice copy for the forward,
through `flash_attention`, `flash_attention_lse`, the autograd forward and
the decode entries' bf16 route. The kernels cannot run here, so this file
holds three things:

1. The wrapper, with the CUDA route stubbed by tests/test_torch_head_dims
   .py's emulated entries (each reads exactly the memory an entry is given
   and refuses the head dims the C switch refuses), against the JAX
   package: `flash_attention` without and with the LSE on float32 and
   bf16 operands against the JAX `flash_attention` / `flash_attention_lse`
   with its Pallas kernel in interpret mode, as its own tests run it, at
   the port's bars (float32: FWD_TOL; bf16: BF16_OUT_TOL, BF16_LSE_TOL of
   test_torch_bwd_bf16_unpadded.py, chip_smoke.py's).
2. The wrapper's contract: the entries receive the true D, the caller's
   own q, k and v (pointers and strides) and write the `out` that comes
   back, [B, Tq, H, D] and dense; no `_pad_head` or `_unpad` call and no
   `_padded` route on the forward, for float32, bf16 and float16 (upcast)
   operands, under autograd and on the bf16 decode route.
3. A model of the kernels' memory traffic: what TMA leaves in each box of
   a map D columns wide, the blocks' online softmax over those tiles in
   float32 (P rounded to bf16 for its product in the bf16 kernels), and
   the clipped stores into a D-wide dense out prefilled with a sentinel:
   every element written once, every element of another head left as it
   was, the result within the bars of `flash_attention_plain`.
"""
import importlib
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.kernels.flash_attention import (
    flash_attention as jax_flash_attention,
    flash_attention_lse as jax_flash_attention_lse)

from test_torch_bwd_bf16_unpadded import (BF16_LSE_TOL, BF16_OUT_TOL,
                                          PADDED, _bf16_pair, _key_mask,
                                          compiled_width, store_box)
from test_torch_head_dims import (FWD_TOL, calls,  # noqa: F401
                                  _true_d_refuses, spy_padding)

fa = importlib.import_module("deeplearning4j_tpu_torch.kernels.flash_attention")

torch.set_num_threads(1)

F16_TOL = dict(rtol=1e-3, atol=1e-3)        # test_torch_decode_dtypes.py's
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
BQ = 64             # q rows of a consumer warpgroup
NEG_INF = -1e30


def _pair(rng, shape, dtype):
    """Normal values as (JAX array, torch tensor) of `dtype` (float32 or
    bfloat16), equal bit for bit."""
    if dtype == "bfloat16":
        return _bf16_pair(rng, shape)
    x = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _f32(x):
    return torch.from_numpy(np.asarray(x).astype(np.float32))


def _close(got, want, dtype, what):
    """got within the port's bar for `dtype` of want (both as float32)."""
    got, want = got.float(), want.float()
    if dtype == "bfloat16":
        tol = BF16_LSE_TOL if what == "lse" else BF16_OUT_TOL
        err = float((got - want).abs().max())
        assert err <= tol, (what, err)
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), err_msg=what,
                                   **FWD_TOL)


def _spy_padding(monkeypatch):
    """The padding calls from here on (test_torch_head_dims.py's
    `spy_padding`: the wrapper holds no padding helper, and each
    `torch.nn.functional.pad` call is recorded)."""
    return spy_padding(monkeypatch)


def _entry(dtype):
    return "flash_fwd_bf16" if dtype == "bfloat16" else "flash_fwd_f32"


# ------------------------------------------------------ 1. against JAX
# (B, Tq, Tk, H, causal, valid key lengths)
JAX_CASES = {
    "causal, ragged key mask": (2, 13, 13, 2, True, [13, 7]),
    "Tq != Tk, not causal, key mask": (2, 11, 19, 2, False, [19, 5]),
}


@pytest.mark.parametrize("lse", [False, True], ids=["out", "out and lse"])
@pytest.mark.parametrize("case", JAX_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", PADDED)
def test_forward_at_padded_head_dims_matches_jax(calls, D, dtype, case,
                                                 lse):
    """`flash_attention` at a head dim no kernel is compiled at, without
    and with the LSE: out (and the LSE) within the port's bars of the JAX
    `flash_attention` (`flash_attention_lse`) through its Pallas kernel;
    one forward entry call at the true D, out [B, Tq, H, D] as the entry
    wrote it, no padded route."""
    B, Tq, Tk, H, causal, valid = JAX_CASES[case]
    rng = np.random.default_rng(D + 5 * causal)
    jq, q = _pair(rng, (B, Tq, H, D), dtype)
    (jk, k), (jv, v) = (_pair(rng, (B, Tk, H, D), dtype) for _ in range(2))
    km = _key_mask(B, Tk, valid)
    kw = dict(causal=causal, key_mask=jnp.asarray(km), interpret=True)
    if lse:
        want, want_lse = jax_flash_attention_lse(jq, jk, jv, **kw)
        got, got_lse = fa.flash_attention(q, k, v, causal=causal,
                                          key_mask=torch.from_numpy(km),
                                          return_lse=True)
        _close(got_lse, _f32(want_lse), dtype, "lse")
    else:
        want = jax_flash_attention(jq, jk, jv, **kw)
        got = fa.flash_attention(q, k, v, causal=causal,
                                 key_mask=torch.from_numpy(km))
    assert got.dtype == DTYPES[dtype] and got.shape == (B, Tq, H, D)
    _close(got, _f32(want), dtype, "out")
    (symbol, args), = calls
    assert symbol == _entry(dtype) and args[10] == D
    assert args[4] == got.data_ptr() and got.is_contiguous()
    assert (args[5] is None) == (not lse)
    assert not any(fa.route_counts().values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offsets", [(0, 512), (1024, 1024)])
def test_lse_entry_at_head_dim_136_matches_jax(calls, offsets, dtype):
    """`flash_attention_lse` at D=136 (compiled width 256: each tile's
    boxes past column 160 in float32, the box at 192 in bf16, lie wholly
    past D) under causal offsets: out and lse within the port's bars of
    the JAX `flash_attention_lse` (Pallas, interpret mode, 64-row blocks,
    so that none holds both rows with keys and rows without); at offsets
    0/512 rows 0..511 see no key: out exactly 0, lse <= -1e29."""
    B, T, H, D = 1, 576, 2, 136
    q_off, k_off = offsets
    rng = np.random.default_rng(136 + q_off)
    (jq, q), (jk, k), (jv, v) = (_pair(rng, (B, T, H, D), dtype)
                                 for _ in range(3))
    want, want_lse = jax_flash_attention_lse(
        jq, jk, jv, causal=True, q_offset=q_off, k_offset=k_off, block_q=64,
        block_k=64, interpret=True)
    out, lse = fa.flash_attention_lse(q, k, v, causal=True, q_offset=q_off,
                                      k_offset=k_off)
    none = torch.arange(T) + q_off < k_off
    _close(out, _f32(want), dtype, "out")
    _close(lse[:, :, ~none], _f32(want_lse)[:, :, ~none], dtype, "lse")
    if bool(none.any()):
        assert (out[:, none] == 0).all()
        assert (lse[:, :, none] <= -1e29).all()
    (symbol, args), = calls
    assert symbol == _entry(dtype) and args[10] == D
    assert args[:3] == tuple(t.data_ptr() for t in (q, k, v))
    assert not any(fa.route_counts().values())


# ------------------------------------------- 2. the wrapper's contract
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("D", PADDED)
def test_forward_entries_take_the_callers_memory(calls, monkeypatch, D,
                                                 dtype):
    """`flash_attention` with and without the LSE on q, k and v that are
    views of one fused [B, T, 3, H, D] projection (strided, rows 16-byte
    aligned): no `_pad_head` and no `_unpad` call; the entries receive
    the true D and, for float32 and bf16, the caller's own pointers and
    strides (no `_aligned` copy) and the `out` that comes back, [B, Tq,
    H, D] and dense; float16 runs the float32 entry on upcast copies at
    the true D, counted `flash_fwd_f16`. Each result within its bar of
    the plain version."""
    seen = _spy_padding(monkeypatch)
    B, T, H = 2, 9, 3
    rng = np.random.default_rng(D)
    qkv = torch.from_numpy(rng.normal(size=(B, T, 3, H, D)).astype(
        np.float32)).to(DTYPES[dtype])
    q, k, v = qkv.unbind(2)
    km = torch.from_numpy(_key_mask(B, T, [9, 4]))
    out, lse = fa.flash_attention(q, k, v, causal=True, key_mask=km,
                                  return_lse=True)
    out2 = fa.flash_attention(q, k, v, key_mask=km)
    assert seen == []
    for got, causal in ((out, True), (out2, False)):
        want = fa.flash_attention_plain(q, k, v, causal=causal, key_mask=km)
        assert got.dtype == q.dtype and got.shape == (B, T, H, D)
        assert got.is_contiguous()
        if dtype == "float16":
            np.testing.assert_allclose(got.float().numpy(),
                                       want.float().numpy(), **F16_TOL)
        else:
            _close(got, want, dtype, "out")
    assert [s for s, _ in calls] == [_entry(dtype)] * 2
    for (_, args), got in zip(calls, (out, out2)):
        assert args[10] == D
        if dtype != "float16":
            assert args[:3] == tuple(t.data_ptr() for t in (q, k, v))
            assert args[11:20] == (*q.stride()[:3], *k.stride()[:3],
                                   *v.stride()[:3])
            assert args[4] == got.data_ptr()
    routes = {n: c for n, c in fa.route_counts().items() if c}
    assert routes == ({"flash_fwd_f16": 2} if dtype == "float16" else {})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [24, 80, 136])
def test_the_autograd_forward_reads_the_true_head_dim(calls, monkeypatch, D,
                                                      dtype):
    """Under grad mode `flash_attention` runs FlashAttentionLSEFunction,
    whose forward asks the entry for the LSE at the true D with no pad or
    slice; its backward likewise: both pairs, f32 and bf16, read the true
    D, with no pad and no route counted."""
    seen = _spy_padding(monkeypatch)
    rng = np.random.default_rng(D)
    q, k, v, g = (_pair(rng, (2, 10, 2, D), dtype)[1] for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = fa.flash_attention(q, k, v, causal=True)
    (symbol, args), = calls
    assert symbol == _entry(dtype) and args[10] == D
    assert args[5] is not None and args[4] == out.data_ptr()
    assert seen == [] and not any(fa.route_counts().values())
    out.backward(g)
    assert seen == []
    assert [c[0] for c in calls[1:]] == [
        f"flash_bwd_{k}_{'f32' if dtype == 'float32' else 'bf16'}"
        for k in ("dq", "dkv")]
    assert [args[12 + (s.startswith("flash_bwd_dkv"))]
            for s, args in calls[1:]] == [D, D]
    assert not any(fa.route_counts().values())


def test_bf16_decode_route_reads_the_cache_at_head_dim_48(calls,
                                                          monkeypatch):
    """Both decode entries on bf16 operands at D=48 run the bf16 forward
    under the key mask position < lengths at the true D: the slab entry
    on the cache's own memory, the paged one on the pool gathered through
    the table (as the reference gathers it); no pad or slice; within
    BF16_OUT_TOL of the plain versions; counted `<entry>_bf16` only."""
    seen = _spy_padding(monkeypatch)
    S, C, H, D, bs = 3, 48, 2, 48, 16
    rng = np.random.default_rng(48)
    q = _bf16_pair(rng, (S, 1, H, D))[1]
    k, v = (_bf16_pair(rng, (S, C, H, D))[1] for _ in range(2))
    lengths = torch.tensor([48, 7, 1], dtype=torch.int32)
    out = fa.flash_decode(q, k, v, lengths)
    _close(out, fa.flash_decode_plain(q, k, v, lengths), "bfloat16", "out")
    (symbol, args), = calls
    assert symbol == "flash_fwd_bf16" and args[10] == D
    assert args[:3] == tuple(t.data_ptr() for t in (q, k, v))
    assert args[4] == out.data_ptr() and out.shape == (S, 1, H, D)
    pool_k, pool_v = (_bf16_pair(rng, (1 + S * C // bs, bs, H, D))[1]
                      for _ in range(2))
    table = (1 + torch.randperm(S * C // bs, generator=torch.Generator()
                                .manual_seed(0))).reshape(S, C // bs).to(
        torch.int32)
    paged = fa.flash_decode_paged(q, pool_k, pool_v, table, lengths)
    _close(paged, fa.flash_decode_paged_plain(q, pool_k, pool_v, table,
                                              lengths), "bfloat16", "out")
    assert [s for s, _ in calls] == ["flash_fwd_bf16"] * 2
    assert calls[1][1][10] == D and calls[1][1][4] == paged.data_ptr()
    assert seen == []
    assert {n: c for n, c in fa.route_counts().items() if c} == {
        "flash_decode_bf16": 1, "flash_decode_paged_bf16": 1}


@pytest.mark.parametrize("D", [4, 7, 264])
def test_the_emulated_forward_entries_refuse_what_the_switch_refuses(
        calls, D):
    """A wrapper that sent a forward entry a head dim outside 8..256 or
    off the multiples of 8 would fail here: the emulated entries refuse it
    (cudaErrorInvalidValue) as the C switch does, and `_launch` raises."""
    assert _true_d_refuses(D)
    z = torch.zeros((1, 4, 1, D))
    args = (*(fa._ptr(t) for t in (z, z, z, None, z, None)), 1, 1, 4, 4, D,
            *(0,) * 9, 0, 0, 0, 1.0)
    for symbol in ("flash_fwd_f32", "flash_fwd_bf16"):
        entry = fa.build.kernel_function("flash_fwd", symbol,
                                         fa._FWD_ARGTYPES)
        with pytest.raises(RuntimeError, match="cudaError_t 1"):
            fa._launch(entry, symbol, torch.device("cpu"), *args)
    assert not any(fa.launch_counts().values())


# ------------------------------------------ 3. the kernels' memory traffic
def box_cols(DP, dtype):
    """Columns of one TMA box: float32 32 (128 bytes, the 128B swizzle);
    bf16 32 at width 32 (the 64B swizzle), else 64."""
    return 32 if dtype == torch.float32 or DP == 32 else 64


def acc_cols(DP, dtype):
    """Columns of one stored accumulator box: float32 those of one P V
    product (min(DP, 64)) up to width 128 and all 256 at width 256; bf16
    32 at width 32, else 64."""
    if dtype == torch.float32:
        return 256 if DP == 256 else min(DP, 64)
    return 32 if DP == 32 else 64


def key_tile(DP, dtype):
    """Keys of a walked tile: 32 in the float32 kernels above width 64,
    else 64."""
    return 32 if dtype == torch.float32 and DP > 64 else 64


def tma_tile(x, b, h, row0, rows, DP):
    """[rows, DP] float32: what TMA lands for one operand tile of x
    [B, T, H, D] (a map D columns wide, T rows) at rows row0.., box by
    box, each element past column D or row T zero; and the column of each
    box that lies wholly past D. Each box counts its whole bytes toward
    the mbarrier, whatever it holds."""
    _, T, _, D = x.shape
    box = box_cols(DP, x.dtype)
    tile = torch.zeros((rows, DP))
    counted, past = [], []
    for c0 in range(0, DP, box):
        counted.append(rows * box * x.element_size())
        if c0 >= D:
            past.append(c0)
        hi = min(c0 + box, D)
        n = max(0, min(rows, T - row0))
        if hi > c0 and n:
            tile[:n, c0:hi] = x[b, row0:row0 + n, h, c0:hi].float()
    assert sum(counted) == rows * DP * x.element_size()    # the expect_tx
    assert (tile[:, D:] == 0).all()
    return tile, past


def model_forward(q, k, v, km, causal, q_off, k_off, flat, writes, lse,
                  heads=None):
    """Every block of the forward kernel at q's compiled width: 64 q rows
    a consumer, key tiles of `key_tile` keys up to the causal limit, the
    online softmax in float32 over the landed (zero-filled) tiles (m from
    the finite -1e30, a key-masked score -1e30, an edge or causal one
    -inf; P rounded to bf16 for P V in the bf16 kernels), out = O /
    max(l, 1e-30) stored box by box clipped to D, lse = m + log(max(l,
    1e-30)) for rows below Tq. `heads`: the (b, h) pairs to run (default
    all). Returns the columns of the boxes that lay wholly past D."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    DP = compiled_width(D)
    BK, OB = key_tile(DP, q.dtype), acc_cols(DP, q.dtype)
    scale = 1 / math.sqrt(D)
    past = set()
    for b, h in heads or [(b, h) for b in range(B) for h in range(H)]:
        for q0 in range(0, Tq, BQ):
            Q, p0 = tma_tile(q, b, h, q0, BQ, DP)
            past.update(p0)
            rows = torch.arange(q0, q0 + BQ)
            k_end = (min(Tk, max(0, min(Tq, q0 + BQ) + q_off - k_off))
                     if causal else Tk)
            m = torch.full((BQ,), NEG_INF)
            l = torch.zeros(BQ)
            O = torch.zeros((BQ, DP))
            for k0 in range(0, k_end, BK):
                K, pk = tma_tile(k, b, h, k0, BK, DP)
                V, pv = tma_tile(v, b, h, k0, BK, DP)
                past.update(pk + pv)
                keys = torch.arange(k0, k0 + BK)
                x = (Q @ K.T) * scale
                if km is not None:
                    ok = km[b, keys.clamp(max=Tk - 1)] > 0
                    x = torch.where(ok[None, :], x, torch.tensor(NEG_INF))
                x = torch.where((keys < Tk)[None, :], x, -math.inf)
                if causal:
                    x = torch.where(keys[None, :] + k_off
                                    <= rows[:, None] + q_off, x, -math.inf)
                m_new = torch.maximum(m, x.max(1).values)
                corr = torch.exp(m - m_new)
                p = torch.exp(x - m_new[:, None])
                l = l * corr + p.sum(1)
                if q.dtype == torch.bfloat16:
                    p = p.to(torch.bfloat16).float()
                O = O * corr[:, None] + p @ V
                m = m_new
            l = l.clamp_min(1e-30)
            out = O / l[:, None]
            for c0 in range(0, DP, OB):
                store_box(flat, q.shape, b, h, q0, c0, out[:, c0:c0 + OB],
                          writes)
            inside = rows < Tq
            lse[b, h, rows[inside]] = (m + torch.log(l))[inside]
    return sorted(past)


SENTINEL = {torch.float32: torch.finfo(torch.float32).max,
            torch.bfloat16: torch.finfo(torch.bfloat16).max}

# (B, Tq, Tk, H, causal, valid key lengths, (q_off, k_off))
MODEL_CASES = {
    "causal, ragged key mask": (2, 70, 70, 2, True, [70, 41], (0, 0)),
    "Tq != Tk, not causal, key mask": (1, 37, 75, 2, False, [75], (0, 0)),
    "causal offsets, rows without keys": (1, 72, 72, 1, True, None,
                                          (0, 40)),
}
MODEL_DIMS = [8, 16, 24, 32, 40, 56, 64, 72, 96, 120, 128, 136, 200, 248,
              256]


def _model_inputs(D, case, dtype, seed):
    B, Tq, Tk, H, causal, valid, offs = MODEL_CASES[case]
    rng = np.random.default_rng(seed)
    q = _pair(rng, (B, Tq, H, D), dtype)[1]
    k, v = (_pair(rng, (B, Tk, H, D), dtype)[1] for _ in range(2))
    km = None if valid is None else torch.from_numpy(
        _key_mask(B, Tk, valid))
    return q, k, v, km, causal, offs


def _wholly_past(D, dtype):
    """The columns of the boxes of a tile at D's compiled width that lie
    wholly past D."""
    DP = compiled_width(D)
    return [c0 for c0 in range(0, DP, box_cols(DP, dtype)) if c0 >= D]


@pytest.mark.parametrize("case", MODEL_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", MODEL_DIMS)
def test_zero_filled_tiles_and_clipped_stores_give_the_plain_forward(
        D, dtype, case):
    """The model of the forward kernels on maps D columns wide and stores
    clipped to D: out (rounded once to the operands' type) and the LSE
    within the port's bars of `flash_attention_plain`; every element of
    the dense [B, Tq, H, D] out written exactly once (no store past D or
    past Tq, none lost); rows that see no key: out 0, lse <= -1e29; the
    boxes that lay wholly past D are the ones the compiled width has
    there (float32 width 128 at D = 72..96: column 96; width 256 at
    D = 136: 160, 192 and 224; bf16 width 256 at D = 136..192: 192)."""
    q, k, v, km, causal, (q_off, k_off) = _model_inputs(D, case, dtype, D)
    kw = dict(causal=causal, key_mask=km, q_offset=q_off, k_offset=k_off)
    want, want_lse = fa.flash_attention_plain(q, k, v, return_lse=True,
                                              **kw)
    B, Tq, H, _ = q.shape
    flat = torch.full((q.numel(),), SENTINEL[q.dtype], dtype=q.dtype)
    writes = torch.zeros(q.numel(), dtype=torch.int32)
    lse = torch.full((B, H, Tq), math.nan)
    past = model_forward(q, k, v, km, causal, q_off, k_off, flat, writes,
                         lse)
    assert past == _wholly_past(D, q.dtype)
    assert (writes == 1).all()
    got = flat.view(q.shape)
    none = torch.arange(Tq) + q_off < k_off
    _close(got, want, dtype, "out")
    _close(lse[:, :, ~none], want_lse[:, :, ~none], dtype, "lse")
    if causal and bool(none.any()):
        assert (got[:, none] == 0).all() and (lse[:, :, none] <= -1e29).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [8, 24, 48, 80, 136, 200])
def test_one_head_leaves_every_other_head_as_it_was(D, dtype):
    """The blocks of one (batch, head) store into the dense out only that
    head's rows below Tq and columns below D: with the buffer prefilled
    with a sentinel, every element of the other heads and the other batch
    entry keeps it; each element of the head is written once."""
    q, k, v, km, _, _ = _model_inputs(D, "causal, ragged key mask", dtype,
                                      D + 1)
    B, Tq, H, _ = q.shape
    mine = torch.zeros((B, Tq, H, D), dtype=torch.bool)
    mine[1, :, 0] = True
    flat = torch.full((q.numel(),), SENTINEL[q.dtype], dtype=q.dtype)
    writes = torch.zeros(q.numel(), dtype=torch.int32)
    model_forward(q, k, v, km, True, 0, 0, flat, writes,
                  torch.zeros((B, H, Tq)), heads=[(1, 0)])
    assert (flat.view(mine.shape)[~mine] == SENTINEL[q.dtype]).all()
    assert (writes.view(mine.shape)[mine] == 1).all()
    assert (writes.view(mine.shape)[~mine] == 0).all()
