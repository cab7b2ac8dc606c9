"""The plan and the numerics of the float32 attention forward at head dim 256.

`csrc/flash_fwd.cu` `flash_fwd_f32_d256` (the C entry flash_fwd_f32 at
compiled width 256: every D % 8 == 0 from 136 to 256, its tensor maps D
columns wide, so that TMA zero-fills each 32-column box past column D,
and its stores D columns wide) gives each block 64 query rows and all 256
output columns. It walks the key tiles of 32 keys up to the causal limit,
each once. For each tile it sums S = Q K^T over the head dim in 32-column
chunks, in order, into one float32 accumulator, each k8 slice of a chunk
as three TF32 products of split operands (lo.hi, hi.lo, hi.hi). Then the
online softmax: a full tile pair (no ragged edge, no masked key, under the
causal limit) takes p = 2^(s scale log2e - m log2e) as one fused step,
any other tile scales, masks and tests each score. P is split into TF32
hi and lo one k8 slice at a time, its columns in register-A order, against
a V^T whose 8-key groups are in `k_slot` order, and O += P V as three TF32
products per slice.

A grid of fewer q tiles than the card has SMs runs as clusters of two
blocks per q tile: rank 0 walks the first half of the tile's key tiles,
rank 1 the rest, each with its own running max, sum and O, and rank 0
merges the two (m the larger, each partial weighted by 2^((m_r - m)
log2e)).

The kernel cannot run here, so this file pins what it follows: the walk
(every tile once per q tile, over one block or split between the two
ranks, the chunks in order), the `k_slot` order of P's slices, and the
arithmetic emulated in the kernel's order of sums (walked whole and
split),
with TF32 rounded to nearest (ties away) by integer operations on a
float32 view. The emulation is held against the port's
`flash_attention_plain` at chip_smoke.py's forward bar (TOL, max abs 1e-4
on out and LSE) at D = 256 and, zero-filled past D as TMA fills them, at
D = 136 and 192, causal, with a ragged key mask, under causal offsets and
with rows that see no key; and against the JAX package's
`flash_attention` / `flash_attention_lse` with its Pallas kernel in
interpret mode, as its own tests run it, at a small T. One TF32 product
per f32 product, and a V^T in plain key order, miss the bar. The
emulation lives here only; no path of the port uses it.
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

fa = importlib.import_module("deeplearning4j_tpu_torch.kernels.flash_attention")

torch.set_num_threads(1)

TOL = 1e-4          # chip_smoke.py's forward bar (out and LSE)
DP = 256            # the kernel's head dim (D256::D)
BQ = 64             # query rows of a block
BK = 32             # keys of a walked tile
DC = 32             # head-dim columns of a chunk (one f32 TMA box)
LOG2E = 1.4426950408889634
NEG_INF = -1e30


def tf32(x):
    """x rounded to TF32, nearest with ties away from zero (hopper_f32.cuh
    `tf32_round`: add half a unit of the 13 dropped bits, clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def product(eq, a, b, terms):
    """einsum(eq, a, b) over one k8 slice with each scalar product as TF32:
    one product of the rounded operands, or the split's three, small terms
    first, each added to the running sum by the caller's order."""
    if terms == 1:
        return [torch.einsum(eq, tf32(a), tf32(b))]
    (ah, al), (bh, bl) = split(a), split(b)
    return [torch.einsum(eq, al, bh), torch.einsum(eq, ah, bl),
            torch.einsum(eq, ah, bh)]


def k_slot(c):
    """hopper_f32.cuh `k_slot`: the k position, inside its 8-block, of the
    V^T column that the splitters write for key c of the block."""
    return (c >> 1) | ((c & 1) << 2)


def a_fragment_k(c):
    """The k position at which `acc_to_a_tf32` puts accumulator column c of
    an 8-column block (a thread's columns 2t and 2t + 1 go to k = t and
    t + 4 of its register-A fragment)."""
    t, odd = divmod(c, 2)
    return t + 4 * odd


def walk(Tq, Tk, causal, q_off, k_off, split=1):
    """{(q0, rank): [(tile, chunk), ...]}: each block's order of work per
    q tile of 64 rows (the kernel's k_end, n_all, t0 and n_tiles)."""
    shift = q_off - k_off
    plan = {}
    for q0 in range(0, Tq, BQ):
        k_end = (min(Tk, max(0, min(Tq, q0 + BQ) + shift)) if causal
                 else Tk)
        n_all = -(-k_end // BK)
        half = (n_all + 1) // 2
        for rank in range(split):
            t0 = half if rank == 1 else 0
            n = n_all if split == 1 else half if rank == 0 else n_all - half
            plan[(q0, rank)] = [(t0 + j, c) for j in range(n)
                                for c in range(DP // DC)]
    return plan


def merge(parts):
    """Rank 0's merge of the ranks' (m, l, o): m the larger, each partial
    weighted by 2^((m_r - m) log2e) (a partial that saw no key weighs 0
    beside one that did)."""
    if len(parts) == 1:
        return parts[0]
    (m0, l0, o0), (m1, l1, o1) = parts
    mm = torch.maximum(m0, m1)
    w0 = torch.exp2((m0 - mm) * np.float32(LOG2E))
    w1 = torch.exp2((m1 - mm) * np.float32(LOG2E))
    return (mm, l0 * w0 + l1 * w1,
            o0 * w0[..., None] + o1 * w1[..., None])


def emulated_forward(q, k, v, *, causal, key_mask, q_off, k_off, terms=3,
                     b_order=None, split=1):
    """(out [B, Tq, H, D], lse [B, H, Tq]) as flash_fwd_f32_d256 computes
    them: q, k, v zero-filled to 256 columns (TMA's fill past D) at the
    true D's scale, block by block and tile by tile on the kernel's walk
    (with `split` = 2, two blocks per q tile, merged). `b_order` replaces
    V^T's `k_slot` order (a wrong one must miss the bar)."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    q, k, v = (torch.nn.functional.pad(t, (0, DP - D)) for t in (q, k, v))
    a_order = torch.tensor([8 * (c // 8) + a_fragment_k(c % 8)
                            for c in range(BK)])
    if b_order is None:
        b_order = [8 * (c // 8) + k_slot(c % 8) for c in range(BK)]
    b_order = torch.tensor(b_order)
    out = torch.zeros((B, Tq, H, DP))
    lse = torch.zeros((B, H, Tq))
    plan = walk(Tq, Tk, causal, q_off, k_off, split)
    for q0 in range(0, Tq, BQ):
        rows = slice(q0, min(Tq, q0 + BQ))
        qb = q[:, rows]
        m, l, o = merge([block(qb, k, v, q0, plan[(q0, rank)], causal,
                               key_mask, q_off, k_off, terms, scale,
                               a_order, b_order) for rank in range(split)])
        lc = l.clamp_min(1e-30)
        out[:, rows] = (o / lc[..., None]).permute(0, 2, 1, 3)
        lse[..., rows] = m + torch.log(lc)
    return out[..., :D], lse


def block(qb, k, v, q0, items, causal, key_mask, q_off, k_off, terms,
          scale, a_order, b_order):
    """One block's (m, l, o) over its walk `items` of the q tile at q0:
    S chunk by chunk, the online softmax, O += P V tile by tile."""
    B, n, H, _ = qb.shape
    Tk = k.shape[1]
    scale2 = np.float32(scale * LOG2E)
    qpos = q_off + q0 + torch.arange(n)[:, None]
    m = torch.full((B, H, n), NEG_INF)
    l = torch.zeros((B, H, n))
    o = torch.zeros((B, H, n, DP))
    tiles = sorted({j for j, _ in items})
    for j in tiles:
        k0 = j * BK
        nk = min(BK, Tk - k0)
        kt, vt = (torch.nn.functional.pad(x[:, k0:k0 + nk],
                                          (0, 0, 0, 0, 0, BK - nk))
                  for x in (k, v))
        # S over the head dim, chunk by chunk, slice by slice, term by
        # term into one running sum
        s = torch.zeros((B, H, n, BK))
        for jj, c in items:
            if jj != j:
                continue
            for kk in range(DC // 8):
                cols = slice(DC * c + 8 * kk, DC * c + 8 * kk + 8)
                for part in product("bqhd,bkhd->bhqk", qb[..., cols],
                                    kt[..., cols], terms):
                    s = s + part
        kmask = torch.ones((B, BK))
        if key_mask is not None:
            kmask = torch.nn.functional.pad(key_mask[:, k0:k0 + nk],
                                            (0, BK - nk), value=1.0)
        kpos = k0 + torch.arange(BK)[None, :]
        full_pair = (k0 + BK <= Tk and bool((kmask > 0).all())
                     and (not causal
                          or k0 + BK - 1 + k_off <= q0 + q_off))
        if full_pair:
            mx = s.amax(-1) * np.float32(scale)
        else:
            x = s * np.float32(scale)
            x = torch.where(kmask[:, None, None, :] > 0, x,
                            torch.full_like(x, NEG_INF))
            visible = kpos < Tk
            if causal:
                visible = visible & (k_off + kpos <= qpos)
            x = torch.where(visible, x, torch.full_like(x, -math.inf))
            mx = x.amax(-1)
        m_new = torch.maximum(m, mx)
        corr = torch.exp2((m - m_new) * np.float32(LOG2E))
        l = l * corr
        m = m_new
        ml = m * np.float32(LOG2E)
        if full_pair:
            # one fused multiply-add: rounded once
            p = torch.exp2((s.double() * float(scale2)
                            - ml.double()[..., None]).float())
        else:
            p = torch.exp2((x - m[..., None]) * np.float32(LOG2E))
        l = l + p.sum(-1)
        o = o * corr[..., None]
        # P's columns as register-A k positions, V^T [D, keys] in
        # b_order; one product per k8 slice and term
        a = torch.empty_like(p)
        a[..., a_order] = p
        vtt = torch.empty((B, H, DP, BK))
        vtt[..., b_order] = vt.permute(0, 2, 3, 1)
        for kk in range(BK // 8):
            sl = slice(8 * kk, 8 * kk + 8)
            for part in product("bhqk,bhdk->bhqd", a[..., sl],
                                vtt[..., sl], terms):
                o = o + part
    return m, l, o


# (B, Tq, Tk, H, D, causal, key mask valid lengths, (q_off, k_off))
CASES = {
    "D=256 causal B=2 T=150 H=1": (2, 150, 150, 1, 256, True, None, (0, 0)),
    "D=256 causal, ragged key mask": (2, 150, 150, 1, 256, True, [150, 93],
                                      (0, 0)),
    "D=192 (padded) causal, ragged key mask": (2, 150, 150, 1, 192, True,
                                               [150, 93], (0, 0)),
    "D=136 (padded) causal": (1, 100, 100, 2, 136, True, None, (0, 0)),
    "D=256 Tq=37 Tk=53 not causal, key mask": (2, 37, 53, 2, 256, False,
                                               [53, 20], (0, 0)),
    "D=256 diagonal offsets 64/64, key mask": (1, 128, 128, 1, 256, True,
                                               [101], (64, 64)),
    "D=256 past offsets 128/0": (1, 96, 96, 1, 256, True, None, (128, 0)),
    "D=256 offsets 0/96, rows without keys": (1, 192, 192, 1, 256, True,
                                              None, (0, 96)),
}


def _inputs(name, seed=3):
    B, Tq, Tk, H, D, causal, valid, (q_off, k_off) = CASES[name]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Tq, H, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, Tk, H, D)).astype(np.float32)
            for _ in range(2))
    km = None
    if valid is not None:
        km = (np.arange(Tk)[None, :] < np.asarray(valid)[:, None]).astype(
            np.float32)
    kw = dict(causal=causal, q_off=q_off, k_off=k_off)
    return q, k, v, km, kw


def _run(name, split=1, **over):
    q, k, v, km, kw = _inputs(name)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tkm = None if km is None else torch.from_numpy(km)
    want = fa.flash_attention_plain(tq, tk, tv, causal=kw["causal"],
                                    key_mask=tkm, return_lse=True,
                                    q_offset=kw["q_off"],
                                    k_offset=kw["k_off"])
    got = emulated_forward(tq, tk, tv, key_mask=tkm, split=split, **kw,
                           **over)
    return want, got, kw


def _err(a, b):
    return float((a - b).abs().max())


@pytest.mark.parametrize("split", [1, 2])
@pytest.mark.parametrize("name", CASES)
def test_walk_takes_every_key_tile_once_and_the_chunks_in_order(name, split):
    B, Tq, Tk, H, D, causal, valid, (q_off, k_off) = CASES[name]
    plan = walk(Tq, Tk, causal, q_off, k_off, split)
    for q0 in range(0, Tq, BQ):
        last_row = q_off + min(Tq, q0 + BQ) - 1      # the q tile's last row
        k_end = (min(Tk, max(0, last_row + 1 - k_off)) if causal else Tk)
        per_rank = [[j for j, c in plan[(q0, r)] if c == 0]
                    for r in range(split)]
        tiles = [j for ts in per_rank for j in ts]
        assert tiles == list(range(-(-k_end // BK)))  # each tile once
        if split == 2:      # rank 0 the first half, rank 1 the rest
            assert len(per_rank[0]) - len(per_rank[1]) in (0, 1)
        for r in range(split):
            for j in per_rank[r]:
                assert [c for jj, c in plan[(q0, r)] if jj == j] == \
                    list(range(DP // DC))
        # every key some row of the q tile sees lies in a walked tile, and
        # the last walked tile holds a key it sees
        assert len(tiles) * BK >= k_end
        if tiles:
            assert tiles[-1] * BK < k_end


def test_each_slot_and_phase_is_handed_over_in_order():
    """Chunk c of tile j sits in slot c and completes the slot's j-th
    phase; the consumer's waits, taken in walk order, see each slot's
    phases 0, 1, 0, 1, ... and the V tile's phases in tile order."""
    items = walk(512, 512, True, 0, 0)[(448, 0)]
    by_slot = {}
    for j, c in items:
        by_slot.setdefault(c, []).append(j & 1)
    assert sorted(by_slot) == list(range(DP // DC))
    for phases in by_slot.values():
        assert phases == [j & 1 for j in range(len(phases))]
    assert len(items) == (512 // BK) * (DP // DC)


def test_k_slot_is_the_a_fragment_order_of_p():
    assert [k_slot(c) for c in range(8)] == [a_fragment_k(c)
                                             for c in range(8)]
    assert sorted(k_slot(c) for c in range(8)) == list(range(8))


def test_full_tile_pairs_take_the_fast_path_where_the_kernel_does():
    """The causal walk of block 64..127 at T = 128: tiles 0 and 1 are full
    pairs (every row sees every key), tiles 2 and 3 are not; a masked key
    takes a tile off the fast path."""
    full = lambda k0, q0, masked=False, Tk=128: (
        k0 + BK <= Tk and not masked and k0 + BK - 1 <= q0)
    assert [full(32 * j, 64) for j in range(4)] == [True, True, False,
                                                    False]
    assert not full(0, 64, masked=True)
    assert not full(96, 0, Tk=120)


@pytest.mark.parametrize("split", [1, 2])
@pytest.mark.parametrize("name", CASES)
def test_three_tf32_products_meet_the_forward_bar(name, split):
    (out_ref, lse_ref), (out, lse), kw = _run(name, split)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert _err(out, out_ref) <= TOL, _err(out, out_ref)
    assert _err(lse, lse_ref) <= TOL, _err(lse, lse_ref)
    if kw["causal"]:
        none = torch.arange(out.shape[1]) + kw["q_off"] < kw["k_off"]
        if bool(none.any()):
            # a row that sees no key: out exactly 0, lse NO_KEY_LSE
            assert (out[:, none] == 0).all()
            assert (lse[..., none] == torch.tensor(
                fa.NO_KEY_LSE, dtype=torch.float32)).all()
            assert (lse[..., none] <= -1e29).all()


@pytest.mark.parametrize("name", ["D=256 causal B=2 T=150 H=1",
                                  "D=192 (padded) causal, ragged key mask"])
def test_one_tf32_product_misses_the_forward_bar(name):
    (out_ref, lse_ref), (out, lse), _ = _run(name, terms=1)
    assert max(_err(out, out_ref), _err(lse, lse_ref)) > TOL


def test_merge_weighs_a_partial_without_keys_zero():
    """Rank 0's merge: a rank that saw no key of a row (m = -1e30, l = 0,
    O = 0) leaves the other's (m, l, O) as they are; two such ranks leave
    the row at m = -1e30, l = 0, O = 0 (out 0, lse NO_KEY_LSE)."""
    rng = np.random.default_rng(2)
    m0 = torch.from_numpy(rng.normal(size=(1, 1, 4)).astype(np.float32))
    l0 = torch.from_numpy(rng.random((1, 1, 4)).astype(np.float32)) + 1
    o0 = torch.from_numpy(rng.normal(size=(1, 1, 4, 8)).astype(np.float32))
    empty = (torch.full_like(m0, NEG_INF), torch.zeros_like(l0),
             torch.zeros_like(o0))
    for parts in ([(m0, l0, o0), empty], [empty, (m0, l0, o0)]):
        m, l, o = merge(parts)
        assert torch.equal(m, m0) and torch.equal(l, l0)
        assert torch.equal(o, o0)
    m, l, o = merge([empty, empty])
    assert (m == NEG_INF).all() and (l == 0).all() and (o == 0).all()


def test_v_t_in_plain_key_order_misses_the_forward_bar():
    """P's slices in register-A order against a V^T in plain key order: the
    `k_slot` permutation is what makes the product right."""
    (out_ref, _), (out, _), _ = _run("D=256 causal B=2 T=150 H=1",
                                     b_order=list(range(BK)))
    assert _err(out, out_ref) > 100 * TOL


# the JAX package's Pallas kernel, interpret mode, block 16: (B, T, H, D,
# causal, key mask valid lengths, offsets or None for `flash_attention`)
JAX_CASES = {
    "flash_attention D=256 causal, key mask": (1, 64, 1, 256, True, [51],
                                               None),
    "flash_attention D=192 causal": (1, 48, 2, 192, True, None, None),
    "flash_attention_lse D=256 diagonal 32/32": (1, 64, 1, 256, True, None,
                                                 (32, 32)),
    "flash_attention_lse D=256 offsets 0/32": (1, 64, 1, 256, True, None,
                                               (0, 32)),
}


@pytest.mark.parametrize("name", JAX_CASES)
def test_emulation_matches_the_jax_kernel(name):
    B, T, H, D, causal, valid, offs = JAX_CASES[name]
    rng = np.random.default_rng(11)
    q, k, v = (rng.normal(size=(B, T, H, D)).astype(np.float32)
               for _ in range(3))
    km = None
    if valid is not None:
        km = (np.arange(T)[None, :] < np.asarray(valid)[:, None]).astype(
            np.float32)
    jkm = None if km is None else jnp.asarray(km)
    blocks = dict(block_q=16, block_k=16, interpret=True)
    if offs is None:
        want = np.asarray(jax_flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            key_mask=jkm, **blocks))
        want_lse = None
        offs = (0, 0)
    else:
        want, want_lse = (np.asarray(x) for x in jax_flash_attention_lse(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            key_mask=jkm, q_offset=offs[0], k_offset=offs[1], **blocks))
    out, lse = emulated_forward(
        *map(torch.from_numpy, (q, k, v)), causal=causal,
        key_mask=None if km is None else torch.from_numpy(km),
        q_off=offs[0], k_off=offs[1], split=2)
    assert np.abs(out.numpy() - want).max() <= TOL
    if want_lse is not None:
        assert np.abs(lse.numpy() - want_lse).max() <= TOL
        none = np.arange(T) + offs[0] < offs[1]
        if none.any():
            assert (want[:, none] == 0).all() and (out.numpy()[:, none]
                                                   == 0).all()
