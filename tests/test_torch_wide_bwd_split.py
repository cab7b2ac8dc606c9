"""The plan and the numerics of the float32 backward pair above head dim 256.

`csrc/flash_wide.cu` `flash_wide_bwd_sm90` (the entries flash_wide_dq_f32
and flash_wide_dkv_f32) gives each block 64 owned rows and one box of up
to 128 output columns, boxes from column 0 with a ragged last one; the
block recomputes S (and dP) over the whole head dim in 32-column chunks
(one TMA box each), walking each tile's chunks from the one after its
box, so that the box's own chunks come last and the splitters can write
the transposed box operand from them as they pass. Every product is
three TF32 products of split operands (hi = rna_tf32(x), lo =
rna_tf32(x - hi); a_lo.b_hi + a_hi.b_lo + a_hi.b_hi).

The kernel cannot run here, so this file pins what it follows: the box
plan and the chunk walk (every chunk once per tile, the box's last, its
rows of the transposed box inside it), the score passes per head dim,
and the arithmetic, emulated block by block in the kernel's order of
sums (S and dP summed chunk by chunk in each box's walk order, p and ds
from them, each box's gradient product summed tile by tile), held
against the port's plain versions under chip_smoke.py's float32 backward
bar (BWD_TOL, allclose rtol 2e-4 / atol 2e-5) at every wide head dim
chip_smoke.py runs, D = 1024 included; one TF32 product per f32 product
misses that bar. The emulation lives here only; no path of the port uses
it.
"""
import importlib

import numpy as np
import pytest
import torch

fa = importlib.import_module("deeplearning4j_tpu_torch.kernels.flash_attention")

torch.set_num_threads(1)

BWD_TOL = dict(rtol=2e-4, atol=2e-5)
NB = 128            # output columns of a box (WideBwd::NB)
DC = 32             # head-dim columns of a chunk: one f32 TMA box
TILE = 64           # owned rows of a block, walked rows of a tile
WIDE_HEAD_DIMS = (264, 320, 512, 1024)   # chip_smoke.py's


def boxes(D):
    """[(c0, columns)] of the output boxes: NB wide from column 0, the last
    one ragged."""
    return [(c0, min(NB, D - c0)) for c0 in range(0, D, NB)]


def walk(D, c0, cols):
    """The chunk order of one tile's walk for the box at c0: chunk
    cb + nbc first, wrapping round, the box's own nbc chunks last."""
    n_dc, cb, nbc = -(-D // DC), c0 // DC, -(-cols // DC)
    return [(cb + nbc + i) % n_dc for i in range(n_dc)]


@pytest.mark.parametrize("D", [d for d in range(264, 1025, 8)])
def test_boxes_tile_the_head_dim_and_each_walk_ends_on_its_box(D):
    plan = boxes(D)
    assert plan[0][0] == 0 and sum(cols for _, cols in plan) == D
    assert all(c0 + cols == nxt for (c0, cols), (nxt, _) in zip(plan,
                                                                plan[1:]))
    assert all(cols == NB for _, cols in plan[:-1])
    assert all(0 < cols <= NB and cols % 8 == 0 for _, cols in plan)
    n_dc = -(-D // DC)
    for c0, cols in plan:
        order = walk(D, c0, cols)
        assert sorted(order) == list(range(n_dc))        # each chunk once
        nbc = -(-cols // DC)
        own = order[n_dc - nbc:]                         # the box's, last
        assert own == list(range(c0 // DC, c0 // DC + nbc))
        # the box's chunks fill its rows of the transposed box [NB, 64]
        rows = [DC * (c - c0 // DC) + r for c in own for r in range(DC)]
        assert rows == list(range(DC * nbc)) and DC * nbc <= NB
        assert DC * nbc >= cols


def test_score_passes_per_head_dim():
    """One pass of S (and dP) over D per box: 3, 3, 4 and 8 at chip_smoke's
    wide head dims, against 5, 5, 8 and 16 with 64-column boxes."""
    assert [len(boxes(D)) for D in WIDE_HEAD_DIMS] == [3, 3, 4, 8]
    assert [-(-D // 64) for D in WIDE_HEAD_DIMS] == [5, 5, 8, 16]


def tf32(x):
    """x rounded to TF32 as the kernel's integer add and mask (the bits of
    `cvt.rna.tf32.f32`)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def product(eq, a, b, terms):
    """einsum(eq, a, b) with each scalar product as TF32: one product of
    the rounded operands (terms=1) or the three-product split, small terms
    first (terms=3)."""
    if terms == 1:
        return torch.einsum(eq, tf32(a), tf32(b))
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def _tiles(x, T):
    """x [B, T, H, D] cut into 64-row tiles, the last zero-filled (as TMA
    lands it)."""
    pad = -T % TILE
    x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
    return [x[:, i:i + TILE] for i in range(0, T + pad, TILE)]


def emulated_backward(q, k, v, g, lse, delta, *, causal, key_mask, terms):
    """(dq, dk, dv) block by block as the kernel sums them."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = 1.0 / np.sqrt(D)
    visible = torch.ones((Tq, Tk), dtype=torch.bool)
    if causal:
        visible = torch.arange(Tk)[None, :] <= torch.arange(Tq)[:, None]
    if key_mask is not None:
        live = (key_mask > 0)[:, None, None, :]
    dq, dk, dv = (torch.zeros_like(x) for x in (q, k, v))
    for c0, cols in boxes(D):
        order = walk(D, c0, cols)
        # S and dP chunk by chunk in the walk's order
        s = torch.zeros((B, H, Tq, Tk))
        dp = torch.zeros((B, H, Tq, Tk))
        for c in order:
            sl = slice(DC * c, min(D, DC * (c + 1)))
            s = s + product("bqhd,bkhd->bhqk", q[..., sl], k[..., sl], terms)
            dp = dp + product("bqhd,bkhd->bhqk", g[..., sl], v[..., sl],
                              terms)
        x = s * scale
        if key_mask is not None:
            x = torch.where(live, x, torch.full_like(x, -1e30))
        p = torch.where(visible, torch.exp(x - lse[..., None]),
                        torch.zeros_like(x))
        ds = p * (dp - delta[..., None]) * scale
        box = slice(c0, c0 + cols)
        # each gradient product summed tile by tile over the walked side
        for k0, kt in zip(range(0, Tk, TILE), _tiles(k[..., box], Tk)):
            n = min(TILE, Tk - k0)
            part = torch.nn.functional.pad(ds[..., k0:k0 + n],
                                           (0, TILE - n))
            dq[..., box] += product("bhqk,bkhd->bqhd", part, kt, terms)
        for q0, (qt, gt) in zip(range(0, Tq, TILE),
                                zip(_tiles(q[..., box], Tq),
                                    _tiles(g[..., box], Tq))):
            n = min(TILE, Tq - q0)
            pad = (0, 0, 0, TILE - n)
            dk[..., box] += product("bhqk,bqhd->bkhd", torch.nn.functional.pad(
                ds[..., q0:q0 + n, :], pad), qt, terms)
            dv[..., box] += product("bhqk,bqhd->bkhd", torch.nn.functional.pad(
                p[..., q0:q0 + n, :], pad), gt, terms)
    return dq, dk, dv


def _case(D, valid):
    B, T, H = 2, 100, 2
    rng = np.random.default_rng(D)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(B, T, H, D))
                                   .astype(np.float32)) for _ in range(4))
    km = None
    if valid is not None:
        km = (torch.arange(T)[None, :]
              < torch.as_tensor(valid)[:, None]).to(torch.float32)
    kw = dict(causal=True, key_mask=km)
    out, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    delta = fa.attention_delta(out, g)
    want = (fa.flash_bwd_dq_plain(q, k, v, g, lse, delta, **kw),
            *fa.flash_bwd_dkv_plain(q, k, v, g, lse, delta, **kw))
    emulate = lambda terms: emulated_backward(q, k, v, g, lse, delta,
                                              terms=terms, **kw)
    return want, emulate, km


@pytest.mark.parametrize("D", WIDE_HEAD_DIMS)
@pytest.mark.parametrize("valid", [None, [100, 61]])
def test_three_tf32_products_meet_the_float32_bar(D, valid):
    want, emulate, km = _case(D, valid)
    got = emulate(3)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(a).all()
        assert torch.allclose(a, b, **BWD_TOL), \
            (name, float((a - b).abs().max()))
    if km is not None:          # a masked key's dk and dv rows: exactly 0
        dead = km == 0
        assert (got[1][dead] == 0).all() and (got[2][dead] == 0).all()


def test_one_tf32_product_misses_the_float32_bar():
    want, emulate, _ = _case(1024, None)
    assert not any(torch.allclose(a, b, **BWD_TOL)
                   for a, b in zip(emulate(1), want))
