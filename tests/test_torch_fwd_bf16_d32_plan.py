"""The plan and the numerics of the bfloat16 attention forward at D = 32.

`csrc/flash_fwd_bf16.cu` `flash_fwd_bf16_d32` (the C entry flash_fwd_bf16
at compiled width 32: D = 32, 24, 16 and 8, its tensor maps D columns
wide, so that TMA zero-fills each 32-column box past column D)
gives each block one warpgroup and 64 q rows. The block walks key tiles of
BK = 64 keys up to the causal limit (`k_end`, global positions
q_off + i, k_off + j). K and V tiles stream through a ring of NS stages:
tile j lands in stage j % NS, its K and its V each on their own mbarrier,
waited for at parity (j // NS) % 2, and stage j % NS is refilled with tile
j + NS once the block has consumed tile j; the key mask of tile j sits in
slot j % 2. Every tile is one TMA box of 32 bf16 columns with the 64B
swizzle. S = Q K^T is two k16 products read through K-major descriptors;
O += P V four k16 products, P from registers, V read MN-major at n = 32.
A full pair (no ragged key edge, no masked key, every row past the
causal limit) takes p = 2^(fma(s, scale log2e, -m log2e)) with the
tile's max taken from the raw scores; any other pair scales, masks (the
key mask at the finite -1e30, the edge and the causal limit at -inf) and
takes 2^((x - m) log2e). The running max m starts at -1e30 in natural
units; l sums the f32 p; P is rounded to bf16 for its product, O sums in
f32, out = O / max(l, 1e-30) is rounded to bf16 once, lse = m + log(l).

The kernel cannot run here, so this file pins what it follows: the walk,
the full-pair classification, the ring's stages, phases and key-mask
slots, the shared-memory layout, the 64B-swizzle addressing at the
layout's tile bases (the model of what TMA writes and the descriptors
read is the backward plan's, `test_torch_bwd_bf16_d32_plan`), and the
arithmetic emulated tile by tile in the kernel's order of sums with its
roundings, held against the port's `flash_attention_plain` at
chip_smoke.py's bf16 bars (out BF16_OUT_TOL = 1.6e-2, LSE BF16_LSE_TOL =
1e-3, max abs) at D = 32, 16, 24 and 8: causal with a ragged key mask,
not causal at Tq != Tk, Tq = 1 (the bf16 decode route), and causal
offsets with rows that see no key (out 0, LSE <= -1e29); and against the
JAX package's `flash_attention` / `flash_attention_lse` on bf16 inputs,
its Pallas kernel in interpret mode as its own tests run it, at a small
T. The emulation lives here only; no path of the port uses it.
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

import test_torch_bwd_bf16_d32_plan as bwd_plan

fa = importlib.import_module("deeplearning4j_tpu_torch.kernels.flash_attention")

torch.set_num_threads(1)

BF16_OUT_TOL = 1.6e-2       # chip_smoke.py's bars
BF16_LSE_TOL = 1e-3
DK = bwd_plan.DK            # 32: the kernel's head dim, one 64-byte row
BQ = 64                     # q rows of a block
BK = 64                     # keys of a tile
NS = 3                      # ring stages
TILE = BK * DK * 2          # one K or V tile: 4 KB
NEG_INF = -1e30
LOG2E = np.float32(1.4426950408889634)


# ------------------------------------------------------------------ plan
def k_tiles(q0, Tq, Tk, causal, q_off=0, k_off=0):
    """The first key of each tile the block of q rows q0.. walks, in order
    (the kernel's k_end and n_tiles)."""
    k_end = (min(Tk, max(0, min(Tq, q0 + BQ) + q_off - k_off)) if causal
             else Tk)
    return list(range(0, k_end, BK))


def full_pair(q0, k0, Tq, Tk, causal, q_off=0, k_off=0, masked=False):
    """The kernel's fast-path test of one (q tile, key tile) pair."""
    return (k0 + BK <= Tk and not masked
            and (not causal or k0 + BK - 1 + k_off <= q0 + q_off))


PLAN_CASES = {  # (Tq, Tk, causal, q_off, k_off)
    **bwd_plan.PLAN_CASES,
    "Tq=1 Tk=128, the bf16 decode route": (1, 128, False, 0, 0),
    "Tq=1 Tk=100 causal at offsets 99/0": (1, 100, True, 99, 0),
    "Tq=24 causal, bench_decode_paged's prefill": (24, 24, True, 0, 0),
}


@pytest.mark.parametrize("name", PLAN_CASES)
def test_a_block_walks_every_key_tile_up_to_the_causal_limit_once(name):
    Tq, Tk, causal, q_off, k_off = PLAN_CASES[name]
    vis = bwd_plan.visible(Tq, Tk, causal, q_off, k_off)
    for q0 in range(0, Tq, BQ):
        tiles = k_tiles(q0, Tq, Tk, causal, q_off, k_off)
        seen = [k for k in range(Tk) if bool(vis[q0:q0 + BQ, k].any())]
        if not seen:            # every row sees no key: out 0, no tile
            assert tiles == []
            continue
        assert tiles == list(range(0, tiles[-1] + 1, BK))   # each once
        assert tiles[-1] <= seen[-1] < tiles[-1] + BK       # none past
    # the walk of the backward's dq blocks, whose tiles are the same
    dq = bwd_plan.walk("dq", Tq, Tk, causal, q_off, k_off)
    assert dq == {q0: k_tiles(q0, Tq, Tk, causal, q_off, k_off)
                  for q0 in range(0, Tq, BQ)}


@pytest.mark.parametrize("name", PLAN_CASES)
def test_a_full_pair_needs_no_mask(name):
    """Every pair the kernel takes as full has every (row, key) in range
    and visible, so skipping the tests changes nothing; a causal T=512
    grid has 28 full pairs to take (8 q tiles, i of them below tile i's
    diagonal)."""
    Tq, Tk, causal, q_off, k_off = PLAN_CASES[name]
    vis = bwd_plan.visible(Tq, Tk, causal, q_off, k_off)
    n_full = 0
    for q0 in range(0, Tq, BQ):
        for k0 in k_tiles(q0, Tq, Tk, causal, q_off, k_off):
            if not full_pair(q0, k0, Tq, Tk, causal, q_off, k_off):
                continue
            n_full += 1
            assert k0 + BK <= Tk
            assert bool(vis[q0:q0 + BQ, k0:k0 + BK].all())
    if name == "causal T=512":
        assert n_full == 28


def test_a_masked_key_an_edge_or_the_diagonal_takes_the_masked_path():
    assert full_pair(128, 0, 512, 512, True)
    assert not full_pair(128, 0, 512, 512, True, masked=True)
    assert not full_pair(128, 128, 512, 512, True)           # diagonal
    assert not full_pair(0, 64, 100, 100, False)             # ragged edge
    assert full_pair(0, 0, 37, 64, False)
    assert full_pair(0, 0, 1, 200, True, 99, 0)     # Tq=1 at position 99
    assert not full_pair(0, 64, 1, 200, True, 99, 0)         # causal limit


@pytest.mark.parametrize("ns", [NS, 2])
@pytest.mark.parametrize("n_tiles", [1, 2, 3, 4, 7, 64])
def test_k_and_v_barriers_follow_the_ring(ns, n_tiles):
    """K and V of tile j land in stage j % NS, each on its own barrier,
    and both barriers complete one phase a load, as the backward's walked
    tiles do: its ring model gives every wait its tile, stage and parity."""
    waits = bwd_plan.ring(n_tiles, ns)
    assert waits == [(j, j % ns, (j // ns) & 1) for j in range(n_tiles)]


@pytest.mark.parametrize("n_tiles", [1, 2, 3, 64])
def test_key_mask_slots_are_never_written_while_read(n_tiles):
    """Tile j's key mask sits in slot j % 2: slot 0 written before the
    first barrier, slot (j + 1) % 2 written after tile j's products and
    published by the barrier that ends tile j. Between two barriers no
    slot is both read and written."""
    slot = {0: 0}               # slot -> tile whose mask it holds
    for j in range(n_tiles):
        # between the barrier that ended tile j - 1 and the one ending j
        reads = {j % 2}
        assert slot[j % 2] == j
        writes = {(j + 1) % 2} if j + 1 < n_tiles else set()
        assert not reads & writes
        for w in writes:
            slot[w] = j + 1


def test_the_shared_memory_layout():
    """Q, NS stages of K and of V, 1 + 2 NS mbarriers, two key-mask slots:
    every tile 1024-aligned (the 64B swizzle repeats every 512 bytes), 29
    KB a block, so at least 7 blocks fit an SM's 228 KB."""
    q, k = 0, BQ * DK * 2
    v = k + NS * TILE
    bar = v + NS * TILE
    km = bar + 8 * (1 + 2 * NS)
    total = km + 4 * 2 * BK
    assert [q, k, v, bar] == [0, 4096, 16384, 28672]
    assert all(x % 1024 == 0 for x in [q, k, v] + [k + i * TILE
                                                   for i in range(NS)])
    assert total == 29240
    assert 228 * 1024 // (total + 1024) >= 7


def test_tma_lands_every_element_of_a_32_and_16_column_box_once():
    """At D = 32 the box is the row; at D = 16 the map is 16 columns wide
    and TMA writes zeros into columns 16-31 of the 32-column box. Either
    way every byte of the 64-row tile is written exactly once."""
    for D in (32, 16):
        data = [bwd_plan.tma_offset(r, c) for r in range(BK)
                for c in range(D)]
        zeros = [bwd_plan.tma_offset(r, c) for r in range(BK)
                 for c in range(D, DK)]
        assert sorted(data + zeros) == list(range(0, BK * DK * 2, 2))
        assert len(set(data)) == BK * D


def _tile_bases():
    return {"Q": 0, **{f"K{s}": BQ * DK * 2 + s * TILE for s in range(NS)},
            **{f"V{s}": BQ * DK * 2 + (NS + s) * TILE for s in range(NS)}}


@pytest.mark.parametrize("tile", list(_tile_bases()))
def test_descriptors_read_each_tile_at_its_place_in_the_layout(tile):
    """S = Q K^T reads Q and each K stage K-major (`desc_k_major_sw64`,
    slice kk at kk * 32 bytes), O += P V each V stage MN-major
    (`desc_mn_major_sw64(Vt, 64, kk)`, slice kk at kk * 1024 bytes, n =
    32): with the descriptors' start at the tile's base in shared memory,
    each read lands on the element TMA put there, over every element."""
    base = _tile_bases()[tile]
    want = {}
    for kk in range(DK // 16):
        if tile.startswith("V"):
            break
        d = bwd_plan.desc(base + kk * 32, 16, bwd_plan.ATOM)
        for (m, k), a in bwd_plan.k_major_reads(d, BK).items():
            want[a] = (m, 16 * kk + k)
            assert a == base + bwd_plan.tma_offset(m, 16 * kk + k)
    for kk in range(BK // 16):
        if not tile.startswith("V"):
            break
        d = bwd_plan.desc(base + kk * 16 * DK * 2, BK * DK * 2,
                          bwd_plan.ATOM)
        for (k, c), a in bwd_plan.mn_major_reads(d).items():
            want[a] = (16 * kk + k, c)
            assert a == base + bwd_plan.tma_offset(16 * kk + k, c)
    assert sorted(want) == list(range(base, base + BK * DK * 2, 2))


def test_a_tile_base_off_the_swizzle_period_misreads():
    """A K stage 256 bytes off its place (the 64B swizzle's period is 512)
    reads other elements: the 1024-aligned layout is what makes it
    right."""
    base = BQ * DK * 2 + 256
    d = bwd_plan.desc(base, 16, bwd_plan.ATOM)
    assert any(a != base + bwd_plan.tma_offset(m, k)
               for (m, k), a in bwd_plan.k_major_reads(d, BK).items())


# --------------------------------------------------------------- numerics
def _f32(x):
    return x.to(torch.float32)


def _fma_exp2(s, a, b):
    """2^(fmaf(s, a, -b)) in f32: the product and the sum rounded once."""
    return torch.exp2((s.double() * float(a) - b.double()).float())


def emulated_forward(q, k, v, *, causal, key_mask, q_off=0, k_off=0):
    """(out bf16 [B, Tq, H, D], lse f32 [B, H, Tq]) as flash_fwd_bf16_d32
    computes them: q, k, v bf16, zero-padded to 32 columns at the true D's
    scale (TMA's zero fill past D),
    tile by tile on the kernel's walk, its online softmax in f32, P
    rounded to bf16 for P V, O summed in f32, out rounded once."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = np.float32(1.0 / math.sqrt(D))
    scale2 = scale * LOG2E
    qp, kp, vp = (torch.nn.functional.pad(_f32(t), (0, DK - D))
                  .permute(0, 2, 1, 3) for t in (q, k, v))
    keys_ok = (torch.ones((B, Tk), dtype=torch.bool) if key_mask is None
               else key_mask > 0)
    out = torch.zeros((B, H, Tq, DK))
    lse = torch.zeros((B, H, Tq))
    for q0 in range(0, Tq, BQ):
        Q = bwd_plan._rows(qp, q0, BQ)
        rows = torch.arange(q0, q0 + BQ)[:, None]
        m = torch.full((B, H, BQ, 1), NEG_INF)
        l = torch.zeros((B, H, BQ, 1))
        o = torch.zeros((B, H, BQ, DK))
        for k0 in k_tiles(q0, Tq, Tk, causal, q_off, k_off):
            K, V = bwd_plan._rows(kp, k0, BK), bwd_plan._rows(vp, k0, BK)
            keys = torch.arange(k0, k0 + BK)[None, :]
            km = torch.nn.functional.pad(keys_ok[:, k0:k0 + BK],
                                         (0, BK - min(BK, Tk - k0)),
                                         value=True)
            # two k16 slices; bf16 products are exact in f32
            s = sum(torch.einsum("bhmd,bhnd->bhmn", Q[..., sl], K[..., sl])
                    for sl in (slice(0, 16), slice(16, 32)))
            if full_pair(q0, k0, Tq, Tk, causal, q_off, k_off,
                         masked=not bool(km.all())):
                raw = s if scale >= 0 else -s
                mx = raw.amax(-1, keepdim=True) * abs(scale)
                m_new = torch.maximum(m, mx)
                p = _fma_exp2(s, scale2, m_new * LOG2E)
            else:
                x = s * scale
                x = torch.where(km[:, None, None, :], x,
                                torch.full((), NEG_INF))
                hidden = keys >= Tk
                if causal:
                    hidden = hidden | (keys + k_off > rows + q_off)
                x = torch.where(hidden[None, None], torch.full((), -math.inf),
                                x)
                m_new = torch.maximum(m, x.amax(-1, keepdim=True))
                p = torch.exp2((x - m_new) * LOG2E)
            corr = torch.exp2((m - m_new) * LOG2E)
            m = m_new
            l = l * corr + p.sum(-1, keepdim=True)
            o = o * corr + torch.einsum("bhqk,bhkd->bhqd", bwd_plan.bf16(p),
                                        V)
        l = l.clamp_min(1e-30)
        n = min(BQ, Tq - q0)
        out[:, :, q0:q0 + n] = (o / l)[:, :, :n]
        lse[:, :, q0:q0 + n] = (m + torch.log(l))[:, :, :n, 0]
    return (out.permute(0, 2, 1, 3)[..., :D].to(torch.bfloat16), lse)


# (B, Tq, Tk, H, D, causal, valid key lengths or None, (q_off, k_off))
CASES = {
    "D=32 causal B=2 T=300 H=2": (2, 300, 300, 2, 32, True, None, (0, 0)),
    "D=32 causal, ragged key mask": (2, 200, 200, 2, 32, True, [200, 137],
                                     (0, 0)),
    "D=32 not causal Tq=37 Tk=53, key mask": (2, 37, 53, 2, 32, False,
                                              [53, 20], (0, 0)),
    "D=32 Tq=1, key mask (the decode route)": (3, 1, 128, 2, 32, False,
                                               [25, 128, 1], (0, 0)),
    "D=32 diagonal 256/256": (1, 192, 192, 2, 32, True, None, (256, 256)),
    "D=32 past 256/0": (1, 128, 128, 2, 32, True, None, (256, 0)),
    "D=32 offsets 0/96, rows without keys": (1, 256, 256, 2, 32, True,
                                             None, (0, 96)),
    "D=32 prefill L=24, key mask": (1, 24, 24, 4, 32, True, [24], (0, 0)),
    "D=16 causal, ragged key mask": (2, 200, 200, 2, 16, True, [200, 137],
                                     (0, 0)),
    "D=16 not causal Tq=37 Tk=53, key mask": (2, 37, 53, 2, 16, False,
                                              [53, 20], (0, 0)),
    "D=16 Tq=1, key mask": (2, 1, 70, 2, 16, False, [70, 9], (0, 0)),
    "D=16 offsets 0/96, rows without keys": (1, 192, 192, 2, 16, True,
                                             None, (0, 96)),
    "D=24 (padded) causal, ragged key mask": (2, 200, 200, 2, 24, True,
                                              [200, 137], (0, 0)),
    "D=24 (padded) not causal Tq=37 Tk=53": (2, 37, 53, 2, 24, False,
                                             [53, 20], (0, 0)),
    "D=8 (padded) causal, ragged key mask": (2, 200, 200, 2, 8, True,
                                             [200, 137], (0, 0)),
    "D=8 (padded) Tq=1, key mask": (2, 1, 64, 2, 8, False, [64, 30],
                                    (0, 0)),
}


def _inputs(name, seed=7):
    """Seeded bf16 operands of one case (numpy normals rounded to bf16)
    and its key mask."""
    B, Tq, Tk, H, D, causal, valid, offs = CASES[name]
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(B, Tq, H, D)).astype(
        np.float32)).to(torch.bfloat16)
    k, v = (torch.from_numpy(rng.normal(size=(B, Tk, H, D)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    km = None
    if valid is not None:
        km = (torch.arange(Tk)[None, :]
              < torch.as_tensor(valid)[:, None]).to(torch.float32)
    return q, k, v, km


def _emulated_and_plain(name, seed):
    B, Tq, Tk, H, D, causal, valid, (q_off, k_off) = CASES[name]
    q, k, v, km = _inputs(name, seed)
    want = fa.flash_attention_plain(q, k, v, causal=causal, key_mask=km,
                                    return_lse=True, q_offset=q_off,
                                    k_offset=k_off)
    got = emulated_forward(q, k, v, causal=causal, key_mask=km, q_off=q_off,
                           k_off=k_off)
    return got, want


@pytest.mark.parametrize("seed", [7, 11])
@pytest.mark.parametrize("name", CASES)
def test_the_kernels_sums_and_roundings_meet_the_bf16_bars(name, seed):
    B, Tq, Tk, H, D, causal, valid, (q_off, k_off) = CASES[name]
    (out, lse), (want, want_lse) = _emulated_and_plain(name, seed)
    assert out.dtype == torch.bfloat16 and out.shape == want.shape
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    err = float((out.float() - want.float()).abs().max())
    lse_err = float((lse - want_lse).abs().max())
    assert err <= BF16_OUT_TOL, err
    assert lse_err <= BF16_LSE_TOL, lse_err
    none = torch.arange(Tq) + q_off < k_off
    if causal and bool(none.any()):     # a row that sees no key
        assert (out[:, none] == 0).all()
        assert (lse[:, :, none] <= -1e29).all()


@pytest.mark.parametrize("wrong", ["every pair full", "no last tile"])
def test_a_wrong_classification_or_walk_misses_the_bar(wrong):
    """The emulation follows `full_pair` and `k_tiles`: taking the
    diagonal and ragged pairs as full (their hidden keys weighted like the
    rest), or dropping each block's last key tile, breaks the output, so
    both tests above matter."""
    global full_pair, k_tiles
    real_full, real_walk = full_pair, k_tiles
    try:
        if wrong == "every pair full":
            full_pair = lambda *a, **k: True
        else:
            k_tiles = lambda *a, **k: real_walk(*a, **k)[:-1]
        (out, _), (want, _) = _emulated_and_plain(
            "D=32 causal, ragged key mask", 7)
    finally:
        full_pair, k_tiles = real_full, real_walk
    assert float((out.float() - want.float()).abs().max()) > BF16_OUT_TOL


# the JAX package's Pallas kernel, interpret mode, block 16, bf16 operands:
# (B, T, H, D, causal, key mask valid lengths, offsets or None for
# `flash_attention`)
JAX_CASES = {
    "flash_attention D=32 causal, key mask": (2, 64, 2, 32, True, [64, 51],
                                              None),
    "flash_attention D=16 not causal, key mask": (1, 48, 2, 16, False, [33],
                                                  None),
    "flash_attention D=24 causal": (1, 48, 2, 24, True, None, None),
    "flash_attention D=8 causal": (1, 32, 2, 8, True, None, None),
    "flash_attention_lse D=32 diagonal 32/32": (1, 64, 2, 32, True, None,
                                                (32, 32)),
    "flash_attention_lse D=32 offsets 0/32": (1, 64, 2, 32, True, None,
                                              (0, 32)),
}


@pytest.mark.parametrize("name", JAX_CASES)
def test_emulation_matches_the_jax_bf16_forward(name):
    """JAX's bf16 out (f32 arithmetic on the upcast tiles, one rounding to
    bf16) and f32 LSE through its Pallas kernel, against the emulation on
    the same bits: within BF16_OUT_TOL and BF16_LSE_TOL (the emulation's P
    rounded to bf16 for its product); rows that see no key: out 0 on both
    sides, LSE <= -1e29."""
    B, T, H, D, causal, valid, offs = JAX_CASES[name]
    rng = np.random.default_rng(23)
    arrs = [rng.normal(size=(B, T, H, D)).astype(np.float32)
            for _ in range(3)]
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrs)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    for j, t in zip((jq, jk, jv), (tq, tk, tv)):
        assert np.array_equal(np.asarray(j).view(np.uint16),
                              t.view(torch.int16).numpy().view(np.uint16))
    km = None
    if valid is not None:
        km = (np.arange(T)[None, :] < np.asarray(valid)[:, None]).astype(
            np.float32)
    jkm = None if km is None else jnp.asarray(km)
    q_off, k_off = offs or (0, 0)
    blocks = dict(block_q=16, block_k=16, interpret=True)
    if offs is None:
        jout = jax_flash_attention(jq, jk, jv, causal=causal, key_mask=jkm,
                                   **blocks)
        jlse = None
    else:
        jout, jlse = jax_flash_attention_lse(
            jq, jk, jv, causal=causal, key_mask=jkm, q_offset=q_off,
            k_offset=k_off, **blocks)
    assert jout.dtype == jnp.bfloat16
    tkm = None if km is None else torch.from_numpy(km)
    out, lse = emulated_forward(tq, tk, tv, causal=causal, key_mask=tkm,
                                q_off=q_off, k_off=k_off)
    want = torch.from_numpy(np.asarray(jout).astype(np.float32))
    assert float((out.float() - want).abs().max()) <= BF16_OUT_TOL
    if jlse is not None:
        want_lse = torch.from_numpy(np.asarray(jlse).astype(np.float32))
        want_lse = want_lse.reshape(lse.shape)
        lse_err = (lse - want_lse).abs()
        seen = want_lse > -1e29
        assert float(lse_err[seen].max()) <= BF16_LSE_TOL
        assert bool((lse[~seen] <= -1e29).all())
    none = np.arange(T) + q_off < k_off
    if causal and none.any():
        assert (want[:, none] == 0).all() and (out[:, none] == 0).all()
