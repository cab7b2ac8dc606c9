"""The plan and the numerics of the float32 attention backward at D = 32.

`csrc/flash_bwd.cu` `flash_bwd_dq_f32_sm90<32, CLIP>` and
`flash_bwd_dkv_f32_sm90<32, CLIP>` (the C entries flash_bwd_dq_f32 and
flash_bwd_dkv_f32 at every D % 8 == 0 up to 32: D = 8, 16 and 24 read
tensor maps D columns wide, so TMA zero-fills the rest of each 32-column
box) give each block one warpgroup and 64 owned rows, two blocks an SM. A
dq block owns q rows and walks key tiles of 64 keys up to the causal
limit; a dk/dv block owns keys and walks q tiles of 64 rows from the
first one that sees an owned key (none: it writes zeros). The walked
tiles stream through a ring of 2 stages: tile j lands in stage j % 2, is
waited for at parity (j // 2) % 2, and stage j % 2 takes tile j + 2 once
tile j is consumed by every warp. A tile is one TMA box of 32 float32
columns with the 128B swizzle: the 16-byte chunk c of row r lands at
chunk c ^ (r % 8), in atoms of 8 rows, 1024 bytes (`hopper::sw128`
addresses the same places). Every f32 product is three TF32 `wgmma`
products of split operands, lo.hi + hi.lo + hi.hi (hi = TF32 of x
rounded to nearest, ties away; lo = TF32 of x - hi):

- the owned operands (dq: Q and dO; dk/dv: K and V) stay as landed and
  each tile reads this thread's register-A fragments of them, (row g,
  k t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of each k8 slice, and
  splits them in registers; the walked tile is split in shared memory,
  hi in place and lo beside it, and read through K-major descriptors:
  S = Q K^T and dP = dO V^T (S^T = K Q^T and dP^T = V dO^T), 4 k8
  slices x 3 terms each, the first product overwriting the sum;
- the gradient products take dS (P^T, dS^T) split in registers from the
  score accumulator, column 2t of each 8-column group at k = t and
  2t + 1 at k = t + 4, against the transposed split tile (K^T; dO^T,
  Q^T), [32 head-dim rows][64 walked rows] in two boxes of 32 rows, the
  walked rows of each 8-group in `k_slot` order: 8 k8 slices x 3 terms,
  summed into the accumulator across the walk;
- a full tile pair (dq: no ragged key edge, no masked key in the tile,
  every row past the causal limit; dk/dv: no masked key among the
  block's keys and the tile's first row sees the last owned key) takes
  p = 2^(fma(s, scale log2e, -lse log2e)) with no test; elsewhere a
  masked key's x is the finite -1e30 and a key past the edge or the
  causal limit weighs exactly 0; ds = p (dp - delta) scale;
- the stores write rows below T and D columns of a dense [B, T, H, D]
  output (no atomics).

The kernels cannot run here, so this file pins what they follow: the
walks, the fast-path classification, the ring's stages and phases, the
128B-swizzle addressing of a 32-float box (what TMA lands against the
fragment reads, the descriptors and the transposed tile's writes), the
`k_slot` permutation, and the three-TF32-product arithmetic emulated
block by block in the kernels' order of sums, held against the port's
`flash_bwd_dq_plain` / `flash_bwd_dkv_plain` at chip_smoke.py's float32
backward bar (BWD_TOL: allclose rtol 2e-4, atol 2e-5) at D = 32, 24, 16
and 8: causal, with a ragged key mask, not causal at Tq != Tk, under
causal offsets with rows that see no key (dq rows 0), a masked key's dK
and dV rows exactly 0; and against the JAX package's `flash_attention` /
`flash_attention_lse` gradients with its Pallas kernels in interpret
mode, as its own tests run them, at a small T. The emulation lives here
only; no path of the port uses it.
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

fa = importlib.import_module("deeplearning4j_tpu_torch.kernels.flash_attention")

torch.set_num_threads(1)

BWD_TOL = dict(rtol=2e-4, atol=2e-5)   # chip_smoke.py's backward bar
DK = 32             # the kernels' width: one 128-byte box a row
OWN = 64            # owned rows of a block
BN = 64             # walked rows of a tile
STAGES = 2          # ring stages
ROW_BYTES = 4 * DK  # 128
ATOM = 8 * ROW_BYTES    # 1024: the 128B-swizzle atom
LOG2E = 1.4426950408889634
NEG_INF2 = np.float32(-1e30) * np.float32(LOG2E)


# ------------------------------------------------------------------ plan
def walk(role, Tq, Tk, causal, q_off=0, k_off=0):
    """{own0: [w0, ...]}: the first walked row of each tile each block
    walks, in order (the kernels' k_end / q_start and n_tiles). dq owns q
    rows and walks keys; dk/dv owns keys and walks q rows."""
    plan = {}
    for own0 in range(0, Tq if role == "dq" else Tk, OWN):
        if role == "dq":
            k_end = (min(Tk, max(0, min(Tq, own0 + OWN) + q_off - k_off))
                     if causal else Tk)
            plan[own0] = list(range(0, k_end, BN))
        else:
            # C's division truncates toward zero; max(0, .) covers both
            start = (max(0, int((own0 + k_off - q_off) / BN) * BN)
                     if causal else 0)
            plan[own0] = list(range(start, Tq, BN)) if start < Tq else []
    return plan


def full_pair(role, own0, w0, Tq, Tk, causal, q_off=0, k_off=0,
              masked=False):
    """The kernels' fast-path test of one (owned, walked) tile pair; dq:
    `masked`, a masked key in the walked tile; dk/dv: among the block's
    own keys."""
    if role == "dq":
        return (w0 + BN <= Tk and not masked
                and (not causal or w0 + BN - 1 + k_off <= own0 + q_off))
    return not masked and (not causal or own0 + OWN - 1 + k_off
                           <= w0 + q_off)


def visible(Tq, Tk, causal, q_off=0, k_off=0):
    if not causal:
        return torch.ones((Tq, Tk), dtype=torch.bool)
    return (torch.arange(Tk)[None, :] + k_off
            <= torch.arange(Tq)[:, None] + q_off)


PLAN_CASES = {  # (Tq, Tk, causal, q_off, k_off)
    "causal T=512": (512, 512, True, 0, 0),
    "causal T=200": (200, 200, True, 0, 0),
    "not causal Tq=37 Tk=53": (37, 53, False, 0, 0),
    "diagonal 1024/1024": (256, 256, True, 1024, 1024),
    "past 1024/0": (256, 256, True, 1024, 0),
    "offsets 0/512, rows without keys": (1024, 1024, True, 0, 512),
    "offsets 0/100": (300, 300, True, 0, 100),
    "causal T=128 (the model's)": (128, 128, True, 0, 0),
    "causal T=16 (a quarter of a tile)": (16, 16, True, 0, 0),
    "not causal T=512": (512, 512, False, 0, 0),
}


@pytest.mark.parametrize("name", PLAN_CASES)
def test_dq_walks_every_key_tile_up_to_the_causal_limit_once(name):
    Tq, Tk, causal, q_off, k_off = PLAN_CASES[name]
    vis = visible(Tq, Tk, causal, q_off, k_off)
    for own0, tiles in walk("dq", Tq, Tk, causal, q_off, k_off).items():
        rows = vis[own0:own0 + OWN]
        seen = [k for k in range(Tk) if bool(rows[:, k].any())]
        if not seen:
            assert tiles == []
            continue
        assert tiles == list(range(0, tiles[-1] + 1, BN))   # each once
        assert tiles[-1] <= seen[-1] < tiles[-1] + BN       # no tile past


@pytest.mark.parametrize("name", PLAN_CASES)
def test_dk_dv_walk_every_q_tile_from_the_first_that_sees_a_key(name):
    Tq, Tk, causal, q_off, k_off = PLAN_CASES[name]
    vis = visible(Tq, Tk, causal, q_off, k_off)
    for own0, tiles in walk("dkv", Tq, Tk, causal, q_off, k_off).items():
        rows = [i for i in range(Tq)
                if bool(vis[i, own0:own0 + OWN].any())]
        if not rows:
            # the block writes zeros: whatever it walks, no row sees a key
            assert not any(bool(vis[w0:w0 + BN, own0:own0 + OWN].any())
                           for w0 in tiles)
            continue
        assert tiles[0] == rows[0] // BN * BN
        assert tiles == list(range(tiles[0], Tq, BN))     # each once


@pytest.mark.parametrize("role", ["dq", "dkv"])
@pytest.mark.parametrize("name", PLAN_CASES)
def test_a_full_pair_needs_no_mask(role, name):
    """Every pair the kernels take as full has every (row, key) visible;
    dq's also every key in range (dk/dv's rows past Tq are zero-filled
    and add exactly 0: their dO and Q rows are 0); a causal T=512 grid
    has full pairs to take."""
    Tq, Tk, causal, q_off, k_off = PLAN_CASES[name]
    vis = visible(Tq, Tk, causal, q_off, k_off)
    n_full = 0
    for own0, tiles in walk(role, Tq, Tk, causal, q_off, k_off).items():
        for w0 in tiles:
            if not full_pair(role, own0, w0, Tq, Tk, causal, q_off, k_off):
                continue
            n_full += 1
            q0, k0, nq, nk = ((own0, w0, OWN, BN) if role == "dq"
                              else (w0, own0, BN, OWN))
            if role == "dq":
                assert k0 + nk <= Tk
            assert bool(vis[q0:q0 + nq, k0:k0 + nk].all())
    if name == "causal T=512":
        assert n_full == 28


def test_a_masked_key_takes_the_masked_path():
    assert full_pair("dq", 128, 0, 512, 512, True)
    assert not full_pair("dq", 128, 0, 512, 512, True, masked=True)
    assert not full_pair("dq", 0, 64, 100, 100, False)    # ragged edge
    assert full_pair("dkv", 0, 64, 512, 512, True)
    assert not full_pair("dkv", 0, 64, 512, 512, True, masked=True)
    assert not full_pair("dkv", 64, 64, 512, 512, True)   # the diagonal


def ring(n_tiles, ns=STAGES):
    """[(tile, stage, parity)] in the order the warpgroup waits: a model
    of the kernels' mbarriers. Each stage's barrier completes one phase per
    load; the load of tile j + ns into stage j % ns is issued only after
    tile j is consumed."""
    phase = [0] * ns            # completed phases of each stage's barrier
    loaded = {}                 # stage -> tile in it
    waits = []
    for s in range(min(ns, n_tiles)):
        loaded[s] = s
        phase[s] += 1
    for j in range(n_tiles):
        st, parity = j % ns, (j // ns) & 1
        # try_wait.parity(p) returns once the phase of parity p completed:
        # the barrier has completed exactly j // ns + 1 phases
        assert phase[st] == j // ns + 1
        assert (phase[st] - 1) & 1 == parity
        assert loaded[st] == j
        waits.append((j, st, parity))
        if j + ns < n_tiles:        # consumed: refill the stage
            loaded[st] = j + ns
            phase[st] += 1
    return waits


@pytest.mark.parametrize("n_tiles", [1, 2, 3, 4, 7, 8, 64])
def test_ring_stages_and_phases(n_tiles):
    waits = ring(n_tiles)
    assert [w[0] for w in waits] == list(range(n_tiles))
    assert [w[1] for w in waits] == [j % STAGES for j in range(n_tiles)]
    # every stage alternates its parity from wait to wait
    for s in range(STAGES):
        par = [p for _, st, p in waits if st == s]
        assert par == [i & 1 for i in range(len(par))]


def test_two_blocks_fit_an_sm():
    """The layouts at D = 32 (DqLayout, DkvLayout: 8 KB tiles, the owned
    operands as landed, no lo tiles for them; two mbarrier words per
    barrier, a [2][64] key mask or two [2][64] row values): each block
    fits a block's limit and two fit the SM with their alignment slack and
    the system's 1 KB each; with the D=64 layout's lo tiles of the owned
    operands dk/dv would not."""
    tile = 4 * OWN * DK
    bars = 4 * 2 * (1 + STAGES)
    dq = 10 * tile + bars + 4 * STAGES * 64
    dkv = 12 * tile + bars + 2 * 4 * STAGES * 64
    for nbytes in (dq, dkv):
        assert nbytes + 1024 <= 232448
        assert 2 * (nbytes + 1024 + 1024) <= 233472
    assert 2 * (dkv + 2 * tile + 1024 + 1024) > 233472


# ------------------------------------------------------ 128B swizzle model
def tma_offset(r, c, rows=OWN):
    """Byte offset in a [rows][32n] f32 tile (n boxes of `rows` rows) of
    element (r, c) as TMA lands it with CU_TENSOR_MAP_SWIZZLE_128B (tile
    base 1024-aligned): box c // 32, its 16-byte chunk (c % 32) // 4 of
    row r at chunk ((c % 32) // 4) ^ (r % 8)."""
    cc = c % 32
    return ((c // 32) * rows * ROW_BYTES + r * ROW_BYTES
            + (((cc // 4) ^ (r % 8)) * 16) + (cc % 4) * 4)


def sw128(rows, r, c):
    """hopper_f32.cuh `sw128`: the float index of element (r, c)."""
    kc = c & 31
    return ((c >> 5) * rows * 32 + r * 32
            + ((((kc >> 2) ^ (r & 7)) << 2) | (kc & 3)))


def swizzle128(addr):
    """The 128B swizzle on a byte address: bits 4-6 xor bits 7-9."""
    return addr ^ (((addr >> 7) & 7) << 4)


def desc_k_major_f32(rows, kk):
    """(start, sbo) bytes of `desc_k_major_f32(tile, rows, kk)` for a tile
    at offset 0: slice kk starts kk // 4 boxes and (kk % 4) 32 bytes in;
    the next 8 rows are one atom on."""
    return (kk // 4) * rows * ROW_BYTES + (kk % 4) * 32, ATOM


def k_major_reads(rows, kk):
    """{(m, k): byte offset} that the K-major descriptor of k8 slice kk of
    a tile of `rows` rows (M or N) reads: row m at (m // 8) SBO + (m % 8)
    128 bytes, k at 4 k bytes from the start, the swizzle applied to the
    address."""
    start, sbo = desc_k_major_f32(rows, kk)
    return {(m, k): swizzle128(start + (m // 8) * sbo
                               + (m % 8) * ROW_BYTES + 4 * k)
            for m in range(rows) for k in range(8)}


def k_slot(c):
    """hopper_f32.cuh `k_slot`: the k position, inside its 8-block, at
    which the transposed tile holds walked row c."""
    return (c >> 1) | ((c & 1) << 2)


def a_fragment_k(c):
    """The k position at which `acc_to_a_tf32` puts accumulator column c
    of an 8-column block (a thread's columns 2t and 2t + 1 go to k = t and
    t + 4)."""
    t, odd = divmod(c, 2)
    return t + 4 * odd


def test_tma_lands_every_element_of_a_box_once_where_sw128_says():
    for rows in (32, 64):
        offs = {tma_offset(r, c, rows) for r in range(rows)
                for c in range(DK)}
        assert offs == set(range(0, rows * ROW_BYTES, 4))
        assert all(4 * sw128(rows, r, c) == tma_offset(r, c, rows)
                   for r in range(rows) for c in range(2 * DK))
    # the swizzle repeats every atom and keeps a chunk in its row
    assert all(tma_offset(r + 8, c) == tma_offset(r, c) + ATOM
               for r in range(56) for c in range(DK))
    assert all(tma_offset(r, c) // ROW_BYTES == r
               for r in range(64) for c in range(DK))


def test_the_owned_fragments_are_the_a_operand_in_natural_k_order():
    """`owned_fragments` reads sw128(64, rt + 8 (i & 1), 8 kk + t + 4 (i
    >> 1)) of the landed owned box: for every thread and k8 slice, a0..a3
    are A's (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of its
    warp's 16 rows, k = the landed column - 8 kk."""
    landed = {}
    for r in range(OWN):
        for c in range(DK):
            landed[tma_offset(r, c) // 4] = (r, c)
    for tid in range(128):
        w, lane = divmod(tid, 32)
        g, t = divmod(lane, 4)
        rt = 16 * w + g
        for kk in range(DK // 8):
            got = [landed[sw128(64, rt + 8 * (i & 1),
                                8 * kk + t + 4 * (i >> 1))]
                   for i in range(4)]
            want = [(rt, 8 * kk + t), (rt + 8, 8 * kk + t),
                    (rt, 8 * kk + t + 4), (rt + 8, 8 * kk + t + 4)]
            assert got == want


@pytest.mark.parametrize("rows", [OWN, DK])
def test_k_major_slices_read_every_element_once_at_its_place(rows):
    """S = Q K^T, dP = dO V^T (dk/dv: S^T = K Q^T, dP^T = V dO^T): B is the
    walked tile as landed, 64 rows, one box; the gradient products' B is
    the transposed tile, 32 rows a box, two boxes."""
    n_boxes = DK // 32 if rows == OWN else BN // 32
    seen = []
    for kk in range(4 * n_boxes):
        reads = k_major_reads(rows, kk)
        assert all(reads[(m, k)] == tma_offset(m, 8 * kk + k, rows)
                   for m in range(rows) for k in range(8))
        seen += reads.values()
    assert sorted(seen) == list(range(0, n_boxes * rows * ROW_BYTES, 4))


def split_tile_writes(R=BN, C=DK):
    """{(x row, x column): transposed float index} of hopper_f32.cuh
    `split_tile<PLAIN, TRANSPOSE, R, C>` over its 128 threads and warp
    steps: the chunk (box, c) of row r read at its swizzled place, element
    i written at sw128(C, 32 box + 4 c + i, (r & ~7) | k_slot(r & 7))."""
    halves = R // 32
    steps = C // 32 * 8 * halves // 4
    writes = {}
    for tid in range(128):
        warp, lane = divmod(tid, 32)
        for m in range(steps):
            u = warp * steps + m
            box, c = u // (8 * halves), (u // halves) & 7
            r = 32 * (u % halves) + lane
            at = box * R * 32 + r * 32 + ((c ^ (r & 7)) << 2)
            assert at == sw128(R, r, 32 * box + 4 * c)
            col = (r & ~7) | k_slot(r & 7)
            for i in range(4):
                key = (r, 32 * box + 4 * c + i)
                assert key not in writes
                writes[key] = sw128(C, 32 * box + 4 * c + i, col)
    return writes


def test_the_transposed_tile_is_written_once_and_read_in_k_slot_order():
    """Each element of a landed 64 x 32 walked tile is split once; its
    transposed place, read by the gradient products' K-major descriptor
    (32 rows a box) at slice kk, position k, holds walked row 8 kk +
    k_slot^-1(k): the row whose dS (P^T, dS^T) column the register-A
    fragment holds at that k."""
    writes = split_tile_writes()
    assert len(writes) == BN * DK
    assert sorted(writes.values()) == list(range(BN * DK))
    at = {4 * v: key for key, v in writes.items()}
    for kk in range(BN // 8):
        reads = k_major_reads(DK, kk)
        for (n, k), addr in reads.items():
            r, d = at[addr]
            assert d == n                       # B^T row n: head-dim column
            assert r == 8 * kk + next(c for c in range(8)
                                      if k_slot(c) == k)
            assert k_slot(r % 8) == a_fragment_k(r % 8) == k


# --------------------------------------------------------------- numerics
def tf32(x):
    """x rounded to TF32, nearest with ties away from zero (hopper_f32.cuh
    `tf32_round`: add half a unit of the 13 dropped bits, clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def slice_products(eq, a, b, terms):
    """einsum(eq, a, b) over one k8 slice with each scalar product as TF32:
    one product of the rounded operands, or the split's three, small terms
    first. Products of TF32 halves are exact in float32."""
    if terms == 1:
        return [torch.einsum(eq, tf32(a), tf32(b))]
    (ah, al), (bh, bl) = split(a), split(b)
    return [torch.einsum(eq, al, bh), torch.einsum(eq, ah, bl),
            torch.einsum(eq, ah, bh)]


def score(a, b, terms):
    """a b^T over the 32 columns: a [..., 64, 32] the owned operand split in
    registers, b [..., 64, 32] the walked tile split in shared memory; k8
    slice by slice, term by term, the first product overwriting the sum."""
    total = None
    for kk in range(DK // 8):
        cols = slice(8 * kk, 8 * kk + 8)
        for x in slice_products("...md,...nd->...mn", a[..., cols],
                                b[..., cols], terms):
            total = x if total is None else total + x
    return total


def grad_product(acc, x, w, terms, b_order):
    """acc + x w over the 64 walked rows: x [..., 64, 64] (dS, P^T or dS^T,
    its columns in register-A order), w [..., 64, 32] (the walked tile) as
    B^T [32, 64] with walked row r at column b_order[r]; one product per
    k8 slice and term, into the accumulator."""
    a_order = torch.tensor([8 * (c // 8) + a_fragment_k(c % 8)
                            for c in range(BN)])
    a = torch.empty_like(x)
    a[..., a_order] = x
    bt = torch.empty(w.shape[:-2] + (w.shape[-1], BN))
    bt[..., torch.as_tensor(b_order)] = w.transpose(-1, -2)
    for kk in range(BN // 8):
        sl = slice(8 * kk, 8 * kk + 8)
        for part in slice_products("...mk,...dk->...md", a[..., sl],
                                   bt[..., sl], terms):
            acc = acc + part
    return acc


K_SLOT_ORDER = [8 * (r // 8) + k_slot(r % 8) for r in range(BN)]


def _rows(x, r0, n):
    """Rows r0 .. r0 + n - 1 of x [B, H, T, 32], zero past T (TMA's zero
    fill)."""
    T = x.shape[2]
    part = x[:, :, r0:min(T, r0 + n)]
    return torch.nn.functional.pad(part, (0, 0, 0, n - part.shape[2]))


def _vec(x, r0, n):
    """x[..., r0:r0 + n] of a [..., T] tensor, 0 past T."""
    part = x[..., r0:min(x.shape[-1], r0 + n)]
    return torch.nn.functional.pad(part, (0, n - part.shape[-1]))


def _exp2_fma(s, scale2, l2):
    """2^(fmaf(s, scale2, -l2)): the product and the sum rounded once."""
    return torch.exp2((s.double() * float(scale2) - l2.double()).float())


def emulated_backward(q, k, v, g, lse, delta, *, causal, key_mask, q_off=0,
                      k_off=0, terms=3, b_order=K_SLOT_ORDER):
    """(dq, dk, dv) float32 as flash_bwd_dq_f32_sm90<32> and
    flash_bwd_dkv_f32_sm90<32> compute them: q, k, v, dO float32 [B, T,
    H, D] zero-filled to 32 columns (TMA past the true D), at the true D's
    scale, block by block on the kernels' walks."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = np.float32(1.0 / math.sqrt(D))
    scale2 = scale * np.float32(LOG2E)
    qp, kp, vp, gp = (torch.nn.functional.pad(t.float(), (0, DK - D))
                      .permute(0, 2, 1, 3) for t in (q, k, v, g))
    lse2 = lse * np.float32(LOG2E)
    keys_ok = (torch.ones((B, Tk), dtype=torch.bool) if key_mask is None
               else key_mask > 0)
    dq = torch.zeros((B, H, Tq, DK))
    dk = torch.zeros((B, H, Tk, DK))
    dv = torch.zeros((B, H, Tk, DK))

    for q0, tiles in walk("dq", Tq, Tk, causal, q_off, k_off).items():
        Q, G = _rows(qp, q0, OWN), _rows(gp, q0, OWN)
        l2 = _vec(lse2, q0, OWN)[..., None]
        dl = _vec(delta, q0, OWN)[..., None]
        rows = torch.arange(q0, q0 + OWN)[:, None]
        acc = torch.zeros((B, H, OWN, DK))
        for k0 in tiles:
            K, V = _rows(kp, k0, BN), _rows(vp, k0, BN)
            keys = torch.arange(k0, k0 + BN)[None, :]
            # the key mask (1 past the ragged edge: the edge has its test)
            km = torch.nn.functional.pad(keys_ok[:, k0:k0 + BN],
                                         (0, BN - min(BN, Tk - k0)),
                                         value=True)[:, None, None, :]
            s, dp = score(Q, K, terms), score(G, V, terms)
            if full_pair("dq", q0, k0, Tq, Tk, causal, q_off, k_off,
                         masked=not bool(km.all())):
                p = _exp2_fma(s, scale2, l2)
            else:
                x2 = torch.where(km, (s.double() * float(scale2)
                                      - l2.double()).float(),
                                 NEG_INF2 - l2)
                seen = (keys < Tk) & (~torch.as_tensor(causal)
                                      | (keys + k_off <= rows + q_off))
                p = torch.where(seen, torch.exp2(x2), torch.zeros(()))
            ds = p * (dp - dl) * scale
            acc = grad_product(acc, ds, K, terms, b_order)
        dq[:, :, q0:q0 + OWN] = acc[:, :, :min(OWN, Tq - q0)]

    for k0, tiles in walk("dkv", Tq, Tk, causal, q_off, k_off).items():
        K, V = _rows(kp, k0, OWN), _rows(vp, k0, OWN)
        n = min(OWN, Tk - k0)
        kvalid = torch.nn.functional.pad(keys_ok[:, k0:k0 + n],
                                         (0, OWN - n))[:, None, :, None]
        masked = not bool(keys_ok[:, k0:k0 + n].all())
        keys = torch.arange(k0, k0 + OWN)[:, None]
        dk_acc = torch.zeros((B, H, OWN, DK))
        dv_acc = torch.zeros((B, H, OWN, DK))
        for q0 in tiles:
            Q, G = _rows(qp, q0, BN), _rows(gp, q0, BN)
            l2 = _vec(lse2, q0, BN)[..., None, :]
            dl = _vec(delta, q0, BN)[..., None, :]
            cols = torch.arange(q0, q0 + BN)[None, :]
            st, dpt = score(K, Q, terms), score(V, G, terms)
            if full_pair("dkv", k0, q0, Tq, Tk, causal, q_off, k_off,
                         masked=masked):
                p = _exp2_fma(st, scale2, l2)
            else:
                x2 = torch.where(kvalid, (st.double() * float(scale2)
                                          - l2.double()).float(),
                                 NEG_INF2 - l2)
                seen = (cols < Tq) & (~torch.as_tensor(causal)
                                      | (keys + k_off <= cols + q_off))
                p = torch.where(seen, torch.exp2(x2), torch.zeros(()))
            dst = p * (dpt - dl) * scale
            dv_acc = grad_product(dv_acc, p, G, terms, b_order)
            dk_acc = grad_product(dk_acc, dst, Q, terms, b_order)
        dk[:, :, k0:k0 + n] = dk_acc[:, :, :n]
        dv[:, :, k0:k0 + n] = dv_acc[:, :, :n]
    # the clipped stores: D columns of dense [B, T, H, D] outputs
    return tuple(t.permute(0, 2, 1, 3)[..., :D].contiguous()
                 for t in (dq, dk, dv))


# (B, Tq, Tk, H, D, causal, valid key lengths or None, (q_off, k_off))
CASES = {
    "D=32 causal B=2 T=300 H=2": (2, 300, 300, 2, 32, True, None, (0, 0)),
    "D=32 causal, ragged key mask": (2, 200, 200, 2, 32, True, [200, 137],
                                     (0, 0)),
    "D=32 not causal Tq=37 Tk=53, key mask": (2, 37, 53, 2, 32, False,
                                              [53, 20], (0, 0)),
    "D=32 diagonal 256/256": (1, 192, 192, 2, 32, True, None, (256, 256)),
    "D=32 past 256/0": (1, 128, 128, 2, 32, True, None, (256, 0)),
    "D=32 offsets 0/96, rows without keys": (1, 256, 256, 2, 32, True,
                                             None, (0, 96)),
    "D=32 causal T=16 (a quarter of a tile)": (3, 16, 16, 2, 32, True,
                                               None, (0, 0)),
    "D=24 causal, ragged key mask": (2, 200, 200, 2, 24, True, [200, 137],
                                     (0, 0)),
    "D=24 not causal Tq=37 Tk=53": (2, 37, 53, 2, 24, False, [53, 20],
                                    (0, 0)),
    "D=16 causal B=2 T=200 H=2": (2, 200, 200, 2, 16, True, None, (0, 0)),
    "D=16 not causal Tq=37 Tk=53, key mask": (2, 37, 53, 2, 16, False,
                                              [53, 20], (0, 0)),
    "D=8 causal, ragged key mask": (2, 200, 200, 2, 8, True, [200, 137],
                                    (0, 0)),
}


def _inputs(name, seed=7):
    """Seeded float32 operands of one case (numpy normals), the key mask,
    and an LSE cotangent under offsets (folded into delta, as the
    ring's)."""
    B, Tq, Tk, H, D, causal, valid, offs = CASES[name]
    rng = np.random.default_rng(seed)
    q, g = (torch.from_numpy(rng.normal(size=(B, Tq, H, D)).astype(
        np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(B, Tk, H, D)).astype(
        np.float32)) for _ in range(2))
    km = None
    if valid is not None:
        km = (torch.arange(Tk)[None, :]
              < torch.as_tensor(valid)[:, None]).to(torch.float32)
    g_lse = None
    if offs != (0, 0):
        g_lse = torch.from_numpy(rng.normal(size=(B, H, Tq)).astype(
            np.float32))
    return q, k, v, g, km, g_lse


def _plain_and_emulation(name, seed=7, **over):
    """The plain versions' gradients and the emulation's on the same
    operands, and the key mask."""
    B, Tq, Tk, H, D, causal, valid, (q_off, k_off) = CASES[name]
    q, k, v, g, km, g_lse = _inputs(name, seed)
    kw = dict(causal=causal, key_mask=km, q_offset=q_off, k_offset=k_off)
    out, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    delta = fa.attention_delta(out, g)
    if g_lse is not None:
        delta = delta - g_lse
    want = (fa.flash_bwd_dq_plain(q, k, v, g, lse, delta, **kw),
            *fa.flash_bwd_dkv_plain(q, k, v, g, lse, delta, **kw))
    got = emulated_backward(q, k, v, g, lse, delta, causal=causal,
                            key_mask=km, q_off=q_off, k_off=k_off, **over)
    return want, got, km


def _err(a, b):
    return float((a - b).abs().max())


@pytest.mark.parametrize("seed", [7, 11])
@pytest.mark.parametrize("name", CASES)
def test_three_tf32_products_meet_the_backward_bar(name, seed):
    want, got, km = _plain_and_emulation(name, seed)
    for gname, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape, gname
        assert torch.isfinite(a).all(), gname
        assert torch.allclose(a, b, **BWD_TOL), (gname, _err(a, b))
    if km is not None:          # a masked key's dK and dV rows: exactly 0
        dead = km == 0
        assert (got[1][dead] == 0).all() and (got[2][dead] == 0).all()
    B, Tq, Tk, H, D, causal, valid, (q_off, k_off) = CASES[name]
    none = torch.arange(Tq) + q_off < k_off
    if causal and bool(none.any()):     # a row that sees no key: dq row 0
        assert (got[0][:, none] == 0).all()


@pytest.mark.parametrize("name", ["D=32 causal B=2 T=300 H=2",
                                  "D=16 causal B=2 T=200 H=2"])
def test_one_tf32_product_misses_the_backward_bar(name):
    want, got, _ = _plain_and_emulation(name, terms=1)
    assert not all(torch.allclose(a, b, **BWD_TOL)
                   for a, b in zip(got, want))


def test_b_t_in_plain_key_order_misses_the_backward_bar():
    """dS, P^T and dS^T in register-A order against K^T, dO^T and Q^T in
    plain walked-row order: the `k_slot` permutation is what makes each
    gradient product right."""
    want, got, _ = _plain_and_emulation("D=32 causal B=2 T=300 H=2",
                                        b_order=list(range(BN)))
    for gname, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _err(a, b) > 100 * BWD_TOL["atol"], gname


def test_a_wrong_walk_misses_the_bar():
    """The emulation follows `walk`: dropping a dq block's last key tile
    (the diagonal one) breaks the gradients, so the walks above matter."""
    real = walk
    try:
        globals()["walk"] = lambda role, *a: {
            o: (t[:-1] if role == "dq" else t)
            for o, t in real(role, *a).items()}
        want, got, _ = _plain_and_emulation("D=32 causal B=2 T=300 H=2")
    finally:
        globals()["walk"] = real
    assert not torch.allclose(got[0], want[0], **BWD_TOL)


# the JAX package's Pallas kernels, interpret mode, block 16: (B, T, H, D,
# causal, key mask valid lengths, offsets or None for `flash_attention`)
JAX_CASES = {
    "flash_attention D=32 causal, key mask": (1, 64, 2, 32, True, [51],
                                              None),
    "flash_attention D=24 causal": (1, 48, 2, 24, True, None, None),
    "flash_attention D=16 not causal, key mask": (1, 40, 2, 16, False, [33],
                                                  None),
    "flash_attention D=8 causal": (2, 48, 1, 8, True, None, None),
    "flash_attention_lse D=32 diagonal 32/32": (1, 64, 2, 32, True, None,
                                                (32, 32)),
    "flash_attention_lse D=32 offsets 0/32": (1, 64, 2, 32, True, None,
                                              (0, 32)),
}


@pytest.mark.parametrize("name", JAX_CASES)
def test_emulation_matches_the_jax_gradients(name):
    """JAX's gradients by `jax.vjp` through its custom_vjp and Pallas
    kernels, for seeded cotangents of out (and of the LSE, through the LSE
    entry), against the emulation fed the port's plain forward and the
    same cotangents, within BWD_TOL."""
    B, T, H, D, causal, valid, offs = JAX_CASES[name]
    rng = np.random.default_rng(17)
    q, k, v, g = (rng.normal(size=(B, T, H, D)).astype(np.float32)
                  for _ in range(4))
    g_lse = rng.normal(size=(B, H, T)).astype(np.float32)
    km = None
    if valid is not None:
        km = (np.arange(T)[None, :] < np.asarray(valid)[:, None]).astype(
            np.float32)
    jkm = None if km is None else jnp.asarray(km)
    q_off, k_off = offs or (0, 0)
    blocks = dict(block_q=16, block_k=16, interpret=True)
    if offs is None:
        f = lambda a, b, c: jax_flash_attention(a, b, c, causal=causal,
                                                key_mask=jkm, **blocks)
        cot = jnp.asarray(g)
    else:
        f = lambda a, b, c: jax_flash_attention_lse(
            a, b, c, causal=causal, key_mask=jkm, q_offset=q_off,
            k_offset=k_off, **blocks)
        cot = (jnp.asarray(g), jnp.asarray(g_lse))
    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(x) for x in vjp(cot)]
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    tkm = None if km is None else torch.from_numpy(km)
    kw = dict(causal=causal, key_mask=tkm, q_offset=q_off, k_offset=k_off)
    out, lse = fa.flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    delta = fa.attention_delta(out, tg)
    if offs is not None:
        delta = delta - torch.from_numpy(g_lse)
    got = emulated_backward(tq, tk, tv, tg, lse, delta, causal=causal,
                            key_mask=tkm, q_off=q_off, k_off=k_off)
    for gname, a, b in zip(("dq", "dk", "dv"), got, want):
        assert np.allclose(a.numpy(), b, **BWD_TOL), (
            gname, float(np.abs(a.numpy() - b).max()))
    none = np.arange(T) + q_off < k_off
    if none.any():
        assert (want[0][:, none] == 0).all()
        assert (got[0].numpy()[:, none] == 0).all()
