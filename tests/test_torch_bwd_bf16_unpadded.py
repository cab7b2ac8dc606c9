"""The bf16 attention backward at every padded head dim, on the CPU.

The C entries flash_bwd_dq_bf16 and flash_bwd_dkv_bf16
(csrc/flash_bwd_bf16.cu) take the true head dim D, every D % 8 == 0 from
8 to 256, and run it at the next compiled width DP (32 for D = 8..32,
else the next of 64, 128 and 256) on the caller's own memory:

- q, k, v and dO through tensor maps D columns wide. A tile of DP
  columns lands as DP / BOX boxes (BOX = 32 columns with the 64B swizzle
  at DP = 32, else 64 with the 128B swizzle), every box issued and counted
  whole in the mbarrier's expected bytes; TMA fills each element past
  column D (and past row T) with zeros, a box that starts at or past D
  included (D = 136: the box at columns 192..255).
- dq, dk and dv written dense [B, T, H, D]: the accumulator box at column
  col0 of head h, batch b, writes rows below T at base (b T H + h) D, row
  stride H D, and min(BOX, D - col0) columns, none where col0 >= D.

The wrapper therefore makes no pad copy and no slice copy for these two
kernels. The kernels cannot run here, so this file holds two things:

1. The wrapper, with the CUDA route stubbed by tests/test_torch_head_dims
   .py's emulated entries (each reads exactly the memory an entry is given
   and refuses the head dims the C switch refuses), against the JAX
   package: `flash_attention` forward + backward and `flash_attention_lse`
   in bf16 against `jax.vjp` of the JAX `flash_attention` /
   `flash_attention_lse` with its Pallas kernels in interpret mode (f32
   arithmetic on upcast tiles, one rounding to bf16), at chip_smoke.py's
   bf16 bars; and the entries' arguments: the true D, the caller's q, k, v
   and dO, no padding helper or pad call, no `_padded` route.
2. A model of the kernels' memory traffic: what TMA leaves in each box
   of a map D columns wide, the blocks' sums over those tiles in float32
   (the kernels' walks and ownership), and the clipped stores into a
   D-wide dense output prefilled with a sentinel: every element written
   once, every element of another head left as it was, the result within
   the bf16 bar of `flash_bwd_dq_plain` / `flash_bwd_dkv_plain`.
"""
import importlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.kernels.flash_attention import (
    flash_attention as jax_flash_attention,
    flash_attention_lse as jax_flash_attention_lse)

from test_torch_head_dims import (calls, _true_d_refuses,  # noqa: F401
                                  spy_padding)

fa = importlib.import_module("deeplearning4j_tpu_torch.kernels.flash_attention")

torch.set_num_threads(1)

BF16_OUT_TOL = 1.6e-2                           # chip_smoke.py's
BF16_LSE_TOL = 1e-3
BF16_GRAD_TOL = dict(rel=2e-2, of_max=1e-2)
PADDED = [8, 24, 40, 48, 80, 96, 136, 200, 248]
OWN = 64            # owned rows of a block (dq: q rows; dk/dv: keys)
BK = 64             # walked keys of a dq tile


def _bar_share(a, b):
    """The worst share of BF16_GRAD_TOL that a takes against b, in f32."""
    a, b = a.float(), b.float()
    bar = BF16_GRAD_TOL["rel"] * b.abs() \
        + BF16_GRAD_TOL["of_max"] * b.abs().max()
    return float(((a - b).abs() / bar.clamp_min(1e-30)).max())


def _bf16_pair(rng, shape):
    """A float32 normal array and the same values as a bf16 tensor, equal
    bit for bit to jnp.asarray(x, jnp.bfloat16)."""
    x = rng.normal(size=shape).astype(np.float32)
    t = torch.from_numpy(x).to(torch.bfloat16)
    j = jnp.asarray(x, jnp.bfloat16)
    assert np.array_equal(np.asarray(j).view(np.uint16),
                          t.view(torch.int16).numpy().view(np.uint16))
    return j, t


def _key_mask(B, Tk, valid):
    if valid is None:
        return None
    return (np.arange(Tk)[None, :] < np.asarray(valid)[:, None]).astype(
        np.float32)


# ------------------------------------------------------ 1. against JAX
# (B, Tq, Tk, H, causal, valid key lengths)
JAX_CASES = {
    "causal, ragged key mask": (2, 13, 13, 2, True, [13, 7]),
    "Tq != Tk, not causal, key mask": (2, 11, 19, 2, False, [19, 5]),
}


@pytest.mark.parametrize("case", JAX_CASES)
@pytest.mark.parametrize("D", PADDED)
def test_bf16_gradients_at_padded_head_dims_match_jax(calls, D, case):
    """`flash_attention` forward + backward on bf16 operands at a head dim
    no kernel is compiled at: out within BF16_OUT_TOL and dq, dk, dv
    within BF16_GRAD_TOL of JAX's bf16 `jax.vjp` through its Pallas
    kernels; the forward, dq and dk/dv entries all get the true D, and no
    call counts a padded route."""
    B, Tq, Tk, H, causal, valid = JAX_CASES[case]
    rng = np.random.default_rng(D + 7 * causal)
    (jq, tq), (jg, tg) = (_bf16_pair(rng, (B, Tq, H, D)) for _ in range(2))
    (jk, tk), (jv, tv) = (_bf16_pair(rng, (B, Tk, H, D)) for _ in range(2))
    km = _key_mask(B, Tk, valid)
    jkm = None if km is None else jnp.asarray(km)
    out_j, vjp = jax.vjp(
        lambda a, b, c: jax_flash_attention(a, b, c, causal=causal,
                                            key_mask=jkm, interpret=True),
        jq, jk, jv)
    want = [torch.from_numpy(np.asarray(x).astype(np.float32))
            for x in vjp(jg)]
    q, k, v = (t.clone().requires_grad_() for t in (tq, tk, tv))
    out = fa.flash_attention(q, k, v, causal=causal,
                             key_mask=None if km is None
                             else torch.from_numpy(km))
    out.backward(tg)
    err = float((out.detach().float()
                 - torch.from_numpy(np.asarray(out_j).astype(np.float32)))
                .abs().max())
    assert err <= BF16_OUT_TOL, err
    for gname, a, b in zip(("dq", "dk", "dv"), (q.grad, k.grad, v.grad),
                           want):
        assert a.dtype == torch.bfloat16 and tuple(a.shape) == tuple(b.shape)
        assert _bar_share(a, b) <= 1.0, (gname, _bar_share(a, b))
    if km is not None:              # a masked key's dk and dv rows: 0
        dead = torch.from_numpy(km) == 0
        assert (k.grad[dead] == 0).all() and (v.grad[dead] == 0).all()
    assert [c[0] for c in calls] == ["flash_fwd_bf16", "flash_bwd_dq_bf16",
                                     "flash_bwd_dkv_bf16"]
    assert [args[10] for _, args in calls[:1]] == [D]      # the forward's D
    assert [args[12] for _, args in calls[1:2]] == [D]     # dq's D
    assert [args[13] for _, args in calls[2:]] == [D]      # dk/dv's D
    assert not any(fa.route_counts().values())


@pytest.mark.parametrize("D", PADDED)
def test_bf16_backward_entries_take_the_callers_memory(calls, monkeypatch,
                                                       D):
    """`flash_bwd_dq` / `flash_bwd_dkv` on bf16 operands: no padding
    helper and no `torch.nn.functional.pad` call; the entries receive the true D, the caller's
    own q, k, v and dO (dense, so no `_aligned` copy) with their strides,
    and dq, dk, dv come back as the entries wrote them, [B, T, H, D]
    dense; equal to the plain versions within BF16_GRAD_TOL."""
    seen = spy_padding(monkeypatch)
    rng = np.random.default_rng(D)
    B, Tq, Tk, H = 2, 9, 14, 3
    q, g = (_bf16_pair(rng, (B, Tq, H, D))[1] for _ in range(2))
    k, v = (_bf16_pair(rng, (B, Tk, H, D))[1] for _ in range(2))
    km = torch.from_numpy(_key_mask(B, Tk, [14, 6]))
    kw = dict(causal=False, key_mask=km)
    out, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    delta = fa.attention_delta(out, g)
    dq = fa.flash_bwd_dq(q, k, v, g, lse, delta, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, g, lse, delta, **kw)
    assert seen == []
    want = (fa.flash_bwd_dq_plain(q, k, v, g, lse, delta, **kw),
            *fa.flash_bwd_dkv_plain(q, k, v, g, lse, delta, **kw))
    for symbol, args in calls:
        at = 12 if symbol.startswith("flash_bwd_dq") else 13
        assert args[at] == D, symbol
        assert args[:4] == tuple(t.data_ptr() for t in (q, k, v, g)), symbol
        assert args[at + 1:at + 13] == (*q.stride()[:3], *k.stride()[:3],
                                        *v.stride()[:3], *g.stride()[:3])
    assert [c[0] for c in calls] == ["flash_bwd_dq_bf16",
                                     "flash_bwd_dkv_bf16"]
    assert calls[0][1][7] == dq.data_ptr()
    assert calls[1][1][7:9] == (dk.data_ptr(), dv.data_ptr())
    for a, b in zip((dq, dk, dv), want):
        assert a.shape == b.shape and a.is_contiguous()
        assert _bar_share(a, b) <= 1.0
    assert not any(fa.route_counts().values())


@pytest.mark.parametrize("D", [7, 4, 264])
def test_the_emulated_entries_refuse_what_the_switch_refuses(calls, D):
    """A wrapper that sent the bf16 pair a head dim outside 8..256 or off
    the multiples of 8 would fail here: the emulated entries refuse it
    (cudaErrorInvalidValue) as the C switch does, and `_launch` raises."""
    assert _true_d_refuses(D)
    z = torch.zeros((1, 4, 1, D), dtype=torch.bfloat16)
    rows = torch.zeros((1, 1, 4))
    ptrs = [fa._ptr(t) for t in (z, z, z, z, rows, rows, None, z)]
    for symbol in ("flash_bwd_dq_bf16", "flash_bwd_dkv_bf16"):
        n = len(ptrs) + (symbol == "flash_bwd_dkv_bf16")
        entry = fa.build.kernel_function("flash_bwd_bf16", symbol,
                                         [None] * (n + 22))
        args = (*ptrs, *ptrs[7:n - 1], 1, 1, 4, 4, D, *(0,) * 12, 0, 0, 0,
                1.0)
        with pytest.raises(RuntimeError, match="cudaError_t 1"):
            fa._launch(entry, symbol, torch.device("cpu"), *args)
    assert not any(fa.launch_counts().values())


@pytest.mark.parametrize("offsets", [(0, 512), (1024, 1024)])
def test_lse_entry_at_head_dim_136_matches_jax(calls, offsets):
    """`flash_attention_lse` at D=136 (compiled width 256: each tile's box
    at columns 192..255 lies wholly past D) under causal offsets, with an
    LSE cotangent: out, lse and the bf16 gradients against JAX's
    `flash_attention_lse` (Pallas, interpret mode); at offsets 0/512 rows
    0..511 see no key: out 0, lse <= -1e29, dq rows exactly 0. JAX runs
    64-row blocks, so that none holds both rows with keys and rows
    without (its kernel skips a block whose rows see no key, and gives
    such rows 0 only there)."""
    B, T, H, D = 1, 576, 2, 136
    q_off, k_off = offsets
    rng = np.random.default_rng(136 + q_off)
    (jq, tq), (jk, tk), (jv, tv), (jg, tg) = (
        _bf16_pair(rng, (B, T, H, D)) for _ in range(4))
    g_lse = rng.normal(size=(B, H, T)).astype(np.float32)
    (out_j, lse_j), vjp = jax.vjp(
        lambda a, b, c: jax_flash_attention_lse(
            a, b, c, causal=True, q_offset=q_off, k_offset=k_off,
            block_q=64, block_k=64, interpret=True), jq, jk, jv)
    want = [torch.from_numpy(np.asarray(x).astype(np.float32))
            for x in vjp((jg, jnp.asarray(g_lse)))]
    q, k, v = (t.clone().requires_grad_() for t in (tq, tk, tv))
    out, lse = fa.flash_attention_lse(q, k, v, causal=True, q_offset=q_off,
                                      k_offset=k_off)
    torch.autograd.backward((out, lse), (tg, torch.from_numpy(g_lse)))
    none = torch.arange(T) + q_off < k_off
    lse_j = torch.from_numpy(np.asarray(lse_j).astype(np.float32))
    keyed = ~none
    assert float((out.detach().float() - torch.from_numpy(
        np.asarray(out_j).astype(np.float32))).abs().max()) <= BF16_OUT_TOL
    assert float((lse.detach() - lse_j)[:, :, keyed].abs().max()) \
        <= BF16_LSE_TOL
    for gname, a, b in zip(("dq", "dk", "dv"), (q.grad, k.grad, v.grad),
                           want):
        assert _bar_share(a, b) <= 1.0, (gname, _bar_share(a, b))
    if bool(none.any()):
        assert (out.detach()[:, none] == 0).all()
        assert (lse.detach()[:, :, none] <= -1e29).all()
        assert (q.grad[:, none] == 0).all()
    assert [args[10] for s, args in calls if s == "flash_fwd_bf16"] == [D]
    assert [args[12] for s, args in calls if s == "flash_bwd_dq_bf16"] == [D]
    assert [args[13] for s, args in calls if s == "flash_bwd_dkv_bf16"] == [D]
    assert not any(fa.route_counts().values())


# ------------------------------------------ 2. the kernels' memory traffic
def compiled_width(D):
    """The C entries' switch (`hopper::compiled_width` in csrc/hopper_bf16.cuh):
    the width head dim D runs at, or 0 where the entries refuse D."""
    if D < 8 or D > 256 or D % 8:
        return 0
    return 32 if D <= 32 else 64 if D <= 64 else 128 if D <= 128 else 256


def box_cols(DP):
    """Columns of one TMA box (and of one accumulator box): 32 with the
    64B swizzle at width 32, 64 with the 128B swizzle above."""
    return 32 if DP == 32 else 64


def out_boxes(DP):
    """Accumulator boxes a block holds (the rest of the width goes to
    other blocks of the same owned tile): one 32-column box at width 32,
    every 64-column box up to 128, two of the four at 256."""
    return 1 if DP == 32 else 2 if DP == 256 else DP // 64


def kv_bq(DP):
    """q rows of a dk/dv walked tile: 64, 32 at widths above 64."""
    return 32 if DP > 64 else 64


def tma_tile(x, b, h, row0, rows, DP):
    """[rows, DP] float32: what TMA lands for one operand tile of x
    [B, T, H, D] (a map D columns wide, T rows) at rows row0.., box by
    box, each element past column D or row T zero; and the bytes each box
    counts toward the mbarrier, whole whatever it holds."""
    _, T, _, D = x.shape
    tile = torch.zeros((rows, DP))
    counted = []
    for c0 in range(0, DP, box_cols(DP)):
        counted.append(rows * box_cols(DP) * 2)
        hi = min(c0 + box_cols(DP), D)      # c0 >= D: the box stays zeros
        n = max(0, min(rows, T - row0))
        if hi > c0 and n:
            tile[:n, c0:hi] = x[b, row0:row0 + n, h, c0:hi].float()
    assert sum(counted) == rows * DP * 2    # the tile's expect_tx
    return tile


def store_box(flat, shape, b, h, row0, col0, acc, writes):
    """The clipped store of one accumulator box [rows, BOX] into a dense
    [B, T, H, D] output seen as the flat buffer the kernel writes: base
    (b T H + h) D, row stride H D, rows below T, min(BOX, D - col0)
    columns (none at or past D); counts each element written."""
    B, T, H, D = shape
    cols = min(acc.shape[1], D - col0)
    n = max(0, min(acc.shape[0], T - row0))
    if cols <= 0 or n == 0:
        return
    base = (b * T * H + h) * D
    r = torch.arange(row0, row0 + n)[:, None]
    c = torch.arange(col0, col0 + cols)[None, :]
    at = base + r * (H * D) + c
    assert int(at.min()) >= 0 and int(at.max()) < B * T * H * D
    flat[at.reshape(-1)] = acc[:n, :cols].reshape(-1).to(flat.dtype)
    writes[at.reshape(-1)] += 1


def _probs(s, dp, lse, delta, ok, scale):
    p = torch.where(ok, torch.exp(s * scale - lse), torch.zeros(()))
    return p, p * (dp - delta) * scale


def model_dq(q, k, v, g, lse, delta, km, causal, q_off, k_off, scale, flat,
             writes, heads=None):
    """Every dq block of the kernels at q's compiled width: a block owns
    64 q rows and out_boxes(DP) accumulator boxes, walks key tiles of 64
    up to the causal limit, sums over the landed (zero-filled) tiles in
    float32 and stores its boxes clipped to D. `heads`: the (b, h) pairs
    to run (default all)."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    DP, BOX = compiled_width(D), box_cols(compiled_width(D))
    NO = out_boxes(DP)
    for b, h in heads or [(b, h) for b in range(B) for h in range(H)]:
        for q0 in range(0, Tq, OWN):
            k_end = (min(Tk, max(0, min(Tq, q0 + OWN) + q_off - k_off))
                     if causal else Tk)
            Q = tma_tile(q, b, h, q0, OWN, DP)
            O = tma_tile(g, b, h, q0, OWN, DP)
            rows = torch.arange(q0, q0 + OWN)
            inside = rows < Tq
            ls = torch.where(inside, lse[b, h, rows.clamp(max=Tq - 1)], 0.)
            dl = torch.where(inside, delta[b, h, rows.clamp(max=Tq - 1)], 0.)
            for nb0 in range(0, DP // BOX, NO):
                acc = torch.zeros((OWN, NO * BOX))
                for k0 in range(0, k_end, BK):
                    K = tma_tile(k, b, h, k0, BK, DP)
                    V = tma_tile(v, b, h, k0, BK, DP)
                    keys = torch.arange(k0, k0 + BK)
                    ok = inside[:, None] & (keys < Tk)[None, :]
                    if km is not None:
                        ok &= (km[b, keys.clamp(max=Tk - 1)] > 0)[None, :]
                    if causal:
                        ok &= (keys[None, :] + k_off
                               <= rows[:, None] + q_off)
                    _, ds = _probs(Q @ K.T, O @ V.T, ls[:, None],
                                   dl[:, None], ok, scale)
                    acc += ds @ K[:, nb0 * BOX:(nb0 + NO) * BOX]
                for nb in range(NO):
                    store_box(flat, q.shape, b, h, q0, (nb0 + nb) * BOX,
                              acc[:, nb * BOX:(nb + 1) * BOX], writes)


def model_dkv(q, k, v, g, lse, delta, km, causal, q_off, k_off, scale,
              flats, writes, heads=None):
    """Every dk/dv block: a block owns 64 keys and out_boxes(DP) boxes of
    dK and dV, walks q tiles of kv_bq(DP) rows from the first that sees an
    owned key, zeroes a masked key's rows at the end and stores its boxes
    clipped to D."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    DP, BOX = compiled_width(D), box_cols(compiled_width(D))
    NO, BQ = out_boxes(DP), kv_bq(DP)
    for b, h in heads or [(b, h) for b in range(B) for h in range(H)]:
        for k0 in range(0, Tk, OWN):
            q_start = (max(0, int((k0 + k_off - q_off) / BQ) * BQ)
                       if causal else 0)
            K = tma_tile(k, b, h, k0, OWN, DP)
            V = tma_tile(v, b, h, k0, OWN, DP)
            keys = torch.arange(k0, k0 + OWN)
            for nb0 in range(0, DP // BOX, NO):
                dk_acc = torch.zeros((OWN, NO * BOX))
                dv_acc = torch.zeros((OWN, NO * BOX))
                for q0 in range(q_start, Tq, BQ):
                    Qt = tma_tile(q, b, h, q0, BQ, DP)
                    Ot = tma_tile(g, b, h, q0, BQ, DP)
                    rows = torch.arange(q0, q0 + BQ)
                    inside = rows < Tq
                    at = rows.clamp(max=Tq - 1)
                    ok = inside[None, :].expand(OWN, BQ).clone()
                    if causal:
                        ok &= (keys[:, None] + k_off
                               <= rows[None, :] + q_off)
                    p, ds = _probs(K @ Qt.T, V @ Ot.T,
                                   torch.where(inside, lse[b, h, at], 0.),
                                   torch.where(inside, delta[b, h, at], 0.),
                                   ok, scale)
                    cols = slice(nb0 * BOX, (nb0 + NO) * BOX)
                    dv_acc += p @ Ot[:, cols]
                    dk_acc += ds @ Qt[:, cols]
                if km is not None:
                    dead = ~(km[b, keys.clamp(max=Tk - 1)] > 0)
                    dk_acc[dead] = 0.0
                    dv_acc[dead] = 0.0
                for flat, w, acc in ((flats[0], writes[0], dk_acc),
                                     (flats[1], writes[1], dv_acc)):
                    for nb in range(NO):
                        store_box(flat, k.shape, b, h, k0,
                                  (nb0 + nb) * BOX,
                                  acc[:, nb * BOX:(nb + 1) * BOX], w)


SENTINEL = torch.finfo(torch.bfloat16).max

# (B, Tq, Tk, H, causal, valid key lengths, (q_off, k_off))
MODEL_CASES = {
    "causal, ragged key mask": (2, 70, 70, 2, True, [70, 41], (0, 0)),
    "Tq != Tk, not causal, key mask": (1, 37, 75, 2, False, [75], (0, 0)),
    "causal offsets, rows without keys": (1, 72, 72, 1, True, None,
                                          (0, 40)),
}


def _model_inputs(D, case, seed):
    B, Tq, Tk, H, causal, valid, offs = MODEL_CASES[case]
    rng = np.random.default_rng(seed)
    q, g = (_bf16_pair(rng, (B, Tq, H, D))[1] for _ in range(2))
    k, v = (_bf16_pair(rng, (B, Tk, H, D))[1] for _ in range(2))
    km = None if valid is None else torch.from_numpy(
        _key_mask(B, Tk, valid))
    return q, k, v, g, km, causal, offs


@pytest.mark.parametrize("case", MODEL_CASES)
@pytest.mark.parametrize("D", [8, 16, 24, 32, 40, 56, 64, 72, 96, 120, 128,
                               136, 200, 248, 256])
def test_zero_filled_tiles_and_clipped_stores_give_the_plain_gradients(
        D, case):
    """The model of the kernels on maps D columns wide and stores clipped
    to D: dq, dk and dv (bf16, rounded once) within BF16_GRAD_TOL of the
    plain versions; every element of the dense [B, T, H, D] outputs
    written exactly once (no store past D or past T, none lost); a masked
    key's dk and dv rows exactly 0; rows that see no key, dq 0."""
    q, k, v, g, km, causal, (q_off, k_off) = _model_inputs(D, case, D)
    kw = dict(causal=causal, key_mask=km, q_offset=q_off, k_offset=k_off)
    out, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    delta = fa.attention_delta(out, g)
    want = (fa.flash_bwd_dq_plain(q, k, v, g, lse, delta, **kw),
            *fa.flash_bwd_dkv_plain(q, k, v, g, lse, delta, **kw))
    scale = 1 / math.sqrt(D)
    flats = [torch.full((t.numel(),), SENTINEL, dtype=torch.bfloat16)
             for t in (q, k, v)]
    writes = [torch.zeros(t.numel(), dtype=torch.int32) for t in (q, k, v)]
    model_dq(q, k, v, g, lse, delta, km, causal, q_off, k_off, scale,
             flats[0], writes[0])
    model_dkv(q, k, v, g, lse, delta, km, causal, q_off, k_off, scale,
              flats[1:], writes[1:])
    for gname, flat, w, b in zip(("dq", "dk", "dv"), flats, writes, want):
        assert (w == 1).all(), gname
        assert _bar_share(flat.view(b.shape), b) <= 1.0, gname
    if km is not None:
        dead = km == 0
        for flat in flats[1:]:
            assert (flat.view(k.shape)[dead] == 0).all()
    none = torch.arange(q.shape[1]) + q_off < k_off
    if causal and bool(none.any()):
        assert (flats[0].view(q.shape)[:, none] == 0).all()


@pytest.mark.parametrize("D", [8, 24, 48, 80, 136, 200])
def test_one_head_leaves_every_other_head_as_it_was(D):
    """The blocks of one (batch, head) store into the dense output only
    that head's rows below T and columns below D: with the buffer
    prefilled with a sentinel, every element of the other heads and the
    other batch entry keeps it; each element of the head is written once."""
    q, k, v, g, km, causal, offs = _model_inputs(
        D, "causal, ragged key mask", D + 1)
    out, lse = fa.flash_attention_plain(q, k, v, return_lse=True,
                                        causal=True, key_mask=km)
    delta = fa.attention_delta(out, g)
    B, T, H, _ = q.shape
    mine = torch.zeros((B, T, H, D), dtype=torch.bool)
    mine[1, :, 0] = True
    flats = [torch.full((q.numel(),), SENTINEL, dtype=torch.bfloat16)
             for _ in range(3)]
    writes = [torch.zeros(q.numel(), dtype=torch.int32) for _ in range(3)]
    args = (q, k, v, g, lse, delta, km, True, 0, 0, 1 / math.sqrt(D))
    model_dq(*args, flats[0], writes[0], heads=[(1, 0)])
    model_dkv(*args, flats[1:], writes[1:], heads=[(1, 0)])
    for flat, w in zip(flats, writes):
        assert (flat.view(mine.shape)[~mine] == SENTINEL).all()
        assert (w.view(mine.shape)[mine] == 1).all()
        assert (w.view(mine.shape)[~mine] == 0).all()


@pytest.mark.parametrize("D", range(0, 272, 4))
def test_the_switch_takes_every_multiple_of_8_up_to_256(D):
    """The C switch runs D at max(32, kernel_head_dim(D)) for every D % 8
    == 0 from 8 to 256 (D = 8 and 16 on the width-32 kernels) and refuses
    the rest, as the emulated entries do; a tile past D keeps whole boxes
    (a box wholly past D: D = 136..192 at width 256, the last box)."""
    DP = compiled_width(D)
    assert (DP == 0) == _true_d_refuses(D)
    if DP:
        assert DP == max(32, fa.kernel_head_dim(D))
        starts = range(0, DP, box_cols(DP))
        assert len(starts) * box_cols(DP) == DP
        past = [c0 for c0 in starts if c0 >= D]
        assert past == ([192] if 136 <= D <= 192 else [])
