"""The plan and the numerics of the bfloat16 backward pair above head dim 256.

`csrc/flash_wide.cu` `flash_wide_bwd_bf16_sm90` (the entries
flash_wide_dq_bf16 and flash_wide_dkv_bf16) gives each block 64 owned
rows and one box of up to NB = 256 output columns, boxes from column 0
with a ragged last one; the block recomputes S (and dP) over the whole
head dim in 64-column chunks (one bf16 TMA box each), walked in order,
each summed into one running float32 accumulator. P and dS are rounded
to bf16 in registers (the register-A operand of the gradient product),
the box operand is the walked tile's bf16 rows, and each box's gradient
sums tile by tile in float32, rounded to bf16 once when it is stored.

The kernel cannot run here, so this file pins what it follows: the box
plan (every column in one box, every chunk walked once per tile), the
score passes per head dim, and the arithmetic emulated block by block in
the kernel's order of sums with its roundings, held against the port's
plain backward under chip_smoke.py's bf16 gradient bar (BF16_GRAD_TOL:
|k - p| <= 2e-2 |p| + 1e-2 max|p|) at every wide head dim chip_smoke.py
runs, causal and with a ragged key mask. The emulation lives here only;
no path of the port uses it.
"""
import importlib

import numpy as np
import pytest
import torch

fa = importlib.import_module("deeplearning4j_tpu_torch.kernels.flash_attention")

torch.set_num_threads(1)

BF16_GRAD_TOL = dict(rel=2e-2, of_max=1e-2)     # chip_smoke.py's
NB = 256            # output columns of a box (WideBwdBf16::NB)
DC = 64             # head-dim columns of a chunk: one bf16 TMA box
TILE = 64           # owned rows of a block, walked rows of a tile
WIDE_HEAD_DIMS = (264, 320, 512, 1024)   # chip_smoke.py's


def boxes(D):
    """[(c0, columns)] of the output boxes: NB wide from column 0, the last
    one ragged."""
    return [(c0, min(NB, D - c0)) for c0 in range(0, D, NB)]


def chunks(D):
    """[(c0, columns)] of one tile's walk: every 64-column chunk in order,
    the last one ragged (TMA zero-fills past D)."""
    return [(c0, min(DC, D - c0)) for c0 in range(0, D, DC)]


@pytest.mark.parametrize("D", [d for d in range(264, 1025, 8)])
def test_boxes_tile_the_head_dim_and_every_chunk_is_walked_once(D):
    plan = boxes(D)
    assert plan[0][0] == 0 and sum(cols for _, cols in plan) == D
    assert all(c0 + cols == nxt for (c0, cols), (nxt, _) in zip(plan,
                                                                plan[1:]))
    assert all(cols == NB for _, cols in plan[:-1])
    assert all(0 < cols <= NB and cols % 8 == 0 for _, cols in plan)
    walk = chunks(D)
    assert [c0 for c0, _ in walk] == list(range(0, D, DC))
    assert sum(cols for _, cols in walk) == D
    for c0, cols in plan:
        # a box's n64 products: its TMA boxes, each starting below D
        n_prod = -(-cols // 64)
        assert all(c0 + 64 * i < D for i in range(n_prod))
        assert 64 * n_prod >= cols


def test_score_passes_per_head_dim():
    """One pass of S (and dP) over D per box: 2, 2, 2 and 4 at chip_smoke's
    wide head dims, against 3, 3, 4 and 8 in the f32 pair's 128-column
    boxes and 5, 5, 8 and 16 in the CUDA-core pair's 64-column ones; the
    operations per unmasked pair, dq 4*D*n + 2*D and dk/dv (dK and dV
    blocks apart) 6*D*n + 4*D: 10*D and 16*D at D = 512."""
    assert [len(boxes(D)) for D in WIDE_HEAD_DIMS] == [2, 2, 2, 4]
    assert [-(-D // 128) for D in WIDE_HEAD_DIMS] == [3, 3, 4, 8]
    assert [-(-D // 64) for D in WIDE_HEAD_DIMS] == [5, 5, 8, 16]
    n = len(boxes(512))
    assert (4 * n + 2, 6 * n + 4) == (10, 16)


def bf16(x):
    """x rounded to bf16 (nearest even), back in float32."""
    return x.to(torch.bfloat16).float()


def _tiles(x, T):
    """x [B, T, H, D] cut into 64-row tiles, the last zero-filled (as TMA
    lands it)."""
    pad = -T % TILE
    x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
    return [x[:, i:i + TILE] for i in range(0, T + pad, TILE)]


def emulated_backward(q, k, v, g, lse, delta, *, causal, key_mask):
    """(dq, dk, dv) in bf16, block by block as the kernel sums and rounds
    them; q, k, v, g bf16."""
    q, k, v, g = (t.float() for t in (q, k, v, g))
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = 1.0 / np.sqrt(D)
    log2e = 1.4426950408889634
    visible = torch.ones((Tq, Tk), dtype=torch.bool)
    if causal:
        visible = torch.arange(Tk)[None, :] <= torch.arange(Tq)[:, None]
    # S and dP chunk by chunk into one running f32 sum (bf16 x bf16
    # products are exact in f32)
    s = torch.zeros((B, H, Tq, Tk))
    dp = torch.zeros((B, H, Tq, Tk))
    for c0, cols in chunks(D):
        sl = slice(c0, c0 + cols)
        s = s + torch.einsum("bqhd,bkhd->bhqk", q[..., sl], k[..., sl])
        dp = dp + torch.einsum("bqhd,bkhd->bhqk", g[..., sl], v[..., sl])
    x2 = s * (scale * log2e) - lse[..., None] * log2e
    if key_mask is not None:
        live = (key_mask > 0)[:, None, None, :]
        x2 = torch.where(live, x2, -1e30 * log2e - lse[..., None] * log2e)
    p = torch.where(visible, torch.exp2(x2), torch.zeros_like(x2))
    ds = p * (dp - delta[..., None]) * scale
    # the register-A operands, rounded to bf16
    p16, ds16 = bf16(p), bf16(ds)
    dq, dk, dv = (torch.zeros_like(x) for x in (q, k, v))
    for c0, cols in boxes(D):
        box = slice(c0, c0 + cols)
        # each box's gradient product summed tile by tile over the walked
        # side, in f32
        for k0, kt in zip(range(0, Tk, TILE), _tiles(k[..., box], Tk)):
            n = min(TILE, Tk - k0)
            part = torch.nn.functional.pad(ds16[..., k0:k0 + n],
                                           (0, TILE - n))
            dq[..., box] += torch.einsum("bhqk,bkhd->bqhd", part, kt)
        for q0, (qt, gt) in zip(range(0, Tq, TILE),
                                zip(_tiles(q[..., box], Tq),
                                    _tiles(g[..., box], Tq))):
            n = min(TILE, Tq - q0)
            pad = (0, 0, 0, TILE - n)
            dk[..., box] += torch.einsum("bhqk,bqhd->bkhd",
                                         torch.nn.functional.pad(
                                             ds16[..., q0:q0 + n, :], pad),
                                         qt)
            dv[..., box] += torch.einsum("bhqk,bqhd->bkhd",
                                         torch.nn.functional.pad(
                                             p16[..., q0:q0 + n, :], pad),
                                         gt)
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


def _bar_share(a, b):
    """The worst share of BF16_GRAD_TOL that a takes against b, in f32."""
    a, b = a.float(), b.float()
    bar = BF16_GRAD_TOL["rel"] * b.abs() \
        + BF16_GRAD_TOL["of_max"] * b.abs().max()
    return float(((a - b).abs() / bar.clamp_min(1e-30)).max())


def _case(D, valid):
    B, T, H = 2, 100, 2
    rng = np.random.default_rng(D)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(B, T, H, D))
                                   .astype(np.float32)).to(torch.bfloat16)
                  for _ in range(4))
    km = None
    if valid is not None:
        km = (torch.arange(T)[None, :]
              < torch.as_tensor(valid)[:, None]).to(torch.float32)
    kw = dict(causal=True, key_mask=km)
    out, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    delta = fa.attention_delta(out, g)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, g, **kw)
    got = emulated_backward(q, k, v, g, lse, delta, **kw)
    return want, got, km


@pytest.mark.parametrize("D", WIDE_HEAD_DIMS)
@pytest.mark.parametrize("valid", [None, [100, 61]])
def test_the_kernels_sums_and_roundings_meet_the_bf16_bar(D, valid):
    want, got, km = _case(D, valid)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a.float()).all()
        assert _bar_share(a, b) <= 1.0, (name, _bar_share(a, b))
    if km is not None:          # a masked key's dk and dv rows: exactly 0
        dead = km == 0
        assert (got[1][dead] == 0).all() and (got[2][dead] == 0).all()
