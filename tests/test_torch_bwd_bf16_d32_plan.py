"""The plan and the numerics of the bfloat16 attention backward at D = 32.

`csrc/flash_bwd_bf16.cu` `flash_bwd_dq_bf16_d32` and
`flash_bwd_dkv_bf16_d32` (the C entries flash_bwd_dq_bf16 and
flash_bwd_dkv_bf16 at D = 32, so also at D = 24, whose operands the
wrapper zero-pads to 32, and at D = 16, whose tensor maps are 16 columns
wide so that TMA zero-fills the other half of each 32-column box) give
each block one warpgroup and 64 owned rows. A dq block owns q rows and
walks key tiles of BN = 64 keys up to the causal limit; a dk/dv block
owns keys and walks q tiles of BN rows from the first one that sees an
owned key (none: it writes zeros). The walked tiles stream through a
ring of NS stages: tile j lands in stage j % NS and is waited for at
parity (j // NS) % 2, and stage j % NS is refilled with tile j + NS once
tile j is consumed. Every tile is one TMA box of 32 bf16 columns with the
64B swizzle: the 16-byte chunk c of row r lands at chunk c ^ ((r // 2) %
4), in atoms of 8 rows, 512 bytes. S and dP (S^T and dP^T) are two k16
products read through K-major descriptors (slice kk at kk * 32 bytes,
SBO 512); the gradient products read the walked tile MN-major (k16 slice
kk at kk * 1024 bytes, SBO 512) at n = 32. A full tile pair (dq: no
ragged key edge, no masked key, every row past the causal limit; dk/dv:
the tile's first row sees the last owned key) takes p = 2^(fma(s, scale
log2e, -lse log2e)) with no test; ds = p fma(dp, scale, -delta scale). P
and dS are rounded to bf16 for the gradient products, which sum tile by
tile in f32; dq, dk and dv are rounded to bf16 once.

The kernels cannot run here, so this file pins what they follow: the
walks, the fast-path classification, the ring's slots and phases, the
64B-swizzle addressing (a model of what TMA writes against the
descriptors as the kernels compute them), and the arithmetic emulated
block by block in the kernels' order of sums with their roundings, held
against the port's `flash_bwd_dq_plain` / `flash_bwd_dkv_plain` at
chip_smoke.py's bf16 gradient bar (BF16_GRAD_TOL: |k - p| <= 2e-2 |p| +
1e-2 max|p|) at D = 32, 24 and 16: causal, with a ragged key mask, not
causal at Tq != Tk, under causal offsets with rows that see no key (dq
rows 0), a masked key's dK and dV rows exactly 0; and against the JAX
package's `flash_attention` / `flash_attention_lse` bf16 gradients with
its Pallas kernels in interpret mode, as its own tests run them, at a
small T. The emulation lives here only; no path of the port uses it.
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

BF16_GRAD_TOL = dict(rel=2e-2, of_max=1e-2)     # chip_smoke.py's
DK = 32             # the kernels' head dim (D32): one 64-byte row a box
OWN = 64            # owned rows of a block
BN = 64             # walked rows of a tile
NS = 3              # ring stages
ROW_BYTES = 2 * DK  # 64
ATOM = 8 * ROW_BYTES    # 512: the 64B-swizzle atom
LOG2E = 1.4426950408889634


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
    """The kernels' fast-path test of one (owned, walked) tile pair."""
    if role == "dq":
        return (w0 + BN <= Tk and not masked
                and (not causal or w0 + BN - 1 + k_off <= own0 + q_off))
    return not causal or own0 + OWN - 1 + k_off <= w0 + q_off


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
    "causal T=2": (2, 2, True, 0, 0),
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
    """Every pair the kernels take as full has every (row, key) in range
    and visible; a causal T=512 grid has full pairs to take."""
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
            if role == "dq":        # dq: no key past Tk either
                assert k0 + nk <= Tk
            assert bool(vis[q0:q0 + nq, k0:k0 + nk].all())
    if name == "causal T=512":
        assert n_full == 28


def test_a_masked_key_takes_the_masked_path():
    assert full_pair("dq", 128, 0, 512, 512, True)
    assert not full_pair("dq", 128, 0, 512, 512, True, masked=True)
    assert not full_pair("dq", 0, 64, 100, 100, False)    # ragged edge
    assert full_pair("dkv", 0, 64, 512, 512, True)
    assert not full_pair("dkv", 64, 64, 512, 512, True)


def ring(n_tiles, NS):
    """[(tile, stage, parity)] in the order the warpgroup waits: a model
    of the kernels' mbarriers. Each stage's barrier completes one phase per
    load; the load of tile j + NS into stage j % NS is issued only after
    tile j is consumed."""
    phase = [0] * NS            # completed phases of each stage's barrier
    loaded = {}                 # stage -> tile in it
    waits = []
    for s in range(min(NS, n_tiles)):
        loaded[s] = s
        phase[s] += 1
    for j in range(n_tiles):
        st, parity = j % NS, (j // NS) & 1
        # try_wait.parity(p) returns once the phase of parity p completed:
        # the barrier has completed exactly j // NS + 1 phases
        assert phase[st] == j // NS + 1
        assert (phase[st] - 1) & 1 == parity
        assert loaded[st] == j
        waits.append((j, st, parity))
        if j + NS < n_tiles:        # consumed: refill the stage
            loaded[st] = j + NS
            phase[st] += 1
    return waits


@pytest.mark.parametrize("NS", [NS, 2, 4])
@pytest.mark.parametrize("n_tiles", [1, 2, 3, 4, 7, 64])
def test_ring_slots_and_phases(NS, n_tiles):
    waits = ring(n_tiles, NS)
    assert [w[0] for w in waits] == list(range(n_tiles))
    # every stage alternates its parity from wait to wait
    for s in range(NS):
        par = [p for _, st, p in waits if st == s]
        assert par == [i & 1 for i in range(len(par))]


# ------------------------------------------------------- 64B swizzle model
def tma_offset(r, c):
    """Byte offset in a [rows][32] tile of element (r, c) as TMA lands it
    with CU_TENSOR_MAP_SWIZZLE_64B (tile base 512-aligned): the 16-byte
    chunk c // 8 of row r at chunk (c // 8) ^ ((r // 2) % 4)."""
    return r * ROW_BYTES + (((c // 8) ^ ((r // 2) % 4)) * 16) + (c % 8) * 2


def swizzle64(addr):
    """The 64B swizzle on a byte address: bits 4-5 xor bits 7-8."""
    return addr ^ (((addr >> 7) & 3) << 4)


def desc(start, lbo, sbo, layout=2):
    """hopper_bf16.cuh's descriptor bits (fields in 16-byte units)."""
    return ((start & 0x3FFFF) >> 4) | ((lbo >> 4) & 0x3FFF) << 16 | \
        (sbo >> 4) << 32 | layout << 62


def fields(d):
    return dict(start=(d & 0x3FFF) << 4, lbo=((d >> 16) & 0x3FFF) << 4,
                sbo=((d >> 32) & 0x3FFF) << 4, layout=d >> 62)


def desc_k_major_sw64(kk):
    """`desc_k_major_sw64(tile, kk)` for a tile at offset 0."""
    return desc(kk * 32, 16, ATOM)


def desc_mn_major_sw64(rows, kk):
    """`desc_mn_major_sw64(tile, rows, kk)` for a tile at offset 0."""
    return desc(kk * 16 * DK * 2, rows * DK * 2, ATOM)


def k_major_reads(d, rows):
    """{(m, k): byte offset} that a K-major 64B-swizzled descriptor reads
    for an operand of `rows` rows (M or N) and one k16 slice: row m at
    (m // 8) SBO + (m % 8) 64 bytes, k at 2 k bytes from the start, the
    swizzle applied to the address."""
    f = fields(d)
    assert f["layout"] == 2
    return {(m, k): swizzle64(f["start"] + (m // 8) * f["sbo"]
                              + (m % 8) * ROW_BYTES + 2 * k)
            for m in range(rows) for k in range(16)}


def mn_major_reads(d, n=DK):
    """{(k, n): byte offset} that an MN-major 64B-swizzled descriptor reads
    for one k16 slice and n columns: k row (k // 8) SBO + (k % 8) 64 bytes,
    32 columns of 2 bytes, the next 32 columns LBO on."""
    f = fields(d)
    assert f["layout"] == 2
    return {(k, c): swizzle64(f["start"] + (k // 8) * f["sbo"]
                              + (k % 8) * ROW_BYTES + (c // 32) * f["lbo"]
                              + (c % 32) * 2)
            for k in range(16) for c in range(n)}


def test_tma_lands_every_element_of_a_tile_once():
    rows = 128
    offs = {tma_offset(r, c) for r in range(rows) for c in range(DK)}
    assert offs == set(range(0, rows * ROW_BYTES, 2))
    # an element's chunk stays in its own row, the swizzle repeats every
    # atom
    assert all(tma_offset(r, c) // ROW_BYTES == r
               for r in range(rows) for c in range(DK))
    assert all(tma_offset(r + 8, c) == tma_offset(r, c) + ATOM
               for r in range(rows - 8) for c in range(DK))


def test_descriptor_fields_round_trip():
    for kk in range(2):
        f = fields(desc_k_major_sw64(kk))
        assert f == dict(start=32 * kk, lbo=16, sbo=512, layout=2)
        f = fields(desc_mn_major_sw64(BN, kk))
        assert f == dict(start=1024 * kk, lbo=BN * 64, sbo=512, layout=2)


@pytest.mark.parametrize("rows", [32, 64])
def test_k_major_slices_read_every_element_once_at_its_place(rows):
    """S = Q K^T and the dk/dv S^T = K Q^T: both operands K-major, the
    owned or the walked 64 rows (the probe's B: 32)."""
    seen = []
    for kk in range(DK // 16):
        reads = k_major_reads(desc_k_major_sw64(kk), rows)
        assert all(reads[(m, k)] == tma_offset(m, 16 * kk + k)
                   for m in range(rows) for k in range(16))
        seen += reads.values()
    assert sorted(seen) == list(range(0, rows * ROW_BYTES, 2))


@pytest.mark.parametrize("rows", [32, 64])
def test_mn_major_slices_read_every_element_once_at_its_place(rows):
    """dQ += dS K, dV += P^T dO, dK += dS^T Q: B is the walked tile read
    MN-major, k16 slice kk (rows 16kk..16kk+15) x n32 (every column)."""
    seen = []
    for kk in range(rows // 16):
        reads = mn_major_reads(desc_mn_major_sw64(rows, kk))
        assert all(reads[(k, c)] == tma_offset(16 * kk + k, c)
                   for k in range(16) for c in range(DK))
        seen += reads.values()
    assert sorted(seen) == list(range(0, rows * ROW_BYTES, 2))


def test_the_128b_constants_misread_a_64b_tile():
    """The 128B design's SBO (1024) or a swizzle left off read other
    elements: the 64B constants are what makes the reads right."""
    wrong_sbo = desc(0, 16, 1024)
    assert any(v != tma_offset(m, k) for (m, k), v in
               k_major_reads(wrong_sbo, 64).items())
    plain = {(m, k): (m // 8) * ATOM + (m % 8) * ROW_BYTES + 2 * k
             for m in range(64) for k in range(16)}
    assert any(v != tma_offset(m, k) for (m, k), v in plain.items())


# --------------------------------------------------------------- numerics
def bf16(x):
    """x rounded to bf16 (nearest even), back in float32."""
    return x.to(torch.bfloat16).float()


def _rows(x, r0, n):
    """Rows r0 .. r0 + n - 1 of x [B, H, T, D], zero past T (TMA's zero
    fill)."""
    part = x[:, :, r0:r0 + n]
    return torch.nn.functional.pad(part, (0, 0, 0, n - part.shape[2]))


def _vec(x, r0, n):
    """x[..., r0:r0 + n] of a [..., T] tensor, 0 past T."""
    part = x[..., r0:r0 + n]
    return torch.nn.functional.pad(part, (0, n - part.shape[-1]))


def _exp2_fma(s, scale2, l2):
    """2^(fmaf(s, scale2, -l2)): the product and the sum rounded once."""
    return torch.exp2((s.double() * float(scale2) - l2.double()).float())


def _ds(p, dp, scale, dls):
    """p * fmaf(dp, scale, -delta * scale)."""
    return p * (dp.double() * float(scale) - dls.double()).float()


def emulated_backward(q, k, v, g, lse, delta, *, causal, key_mask, q_off=0,
                      k_off=0):
    """(dq, dk, dv) in bf16 as flash_bwd_dq_bf16_d32 and
    flash_bwd_dkv_bf16_d32 compute them: q, k, v, dO bf16 [B, T, H, D],
    zero-padded to 32 columns at the true D's scale (the wrapper's pad at
    D = 24, TMA's zero fill at D = 16), block by block on the kernels'
    walks, the gradient products summed tile by tile in f32."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = np.float32(1.0 / math.sqrt(D))
    scale2 = scale * np.float32(LOG2E)
    qp, kp, vp, gp = (torch.nn.functional.pad(t.float(), (0, DK - D))
                      .permute(0, 2, 1, 3) for t in (q, k, v, g))
    lse2 = lse * np.float32(LOG2E)
    dls = delta * scale
    keys_ok = (torch.ones((B, Tk), dtype=torch.bool) if key_mask is None
               else key_mask > 0)
    dq = torch.zeros((B, H, Tq, DK))
    dk = torch.zeros((B, H, Tk, DK))
    dv = torch.zeros((B, H, Tk, DK))

    def scores(a, b):       # two k16 slices, bf16 products exact in f32
        return sum(torch.einsum("bhmd,bhnd->bhmn", a[..., sl], b[..., sl])
                   for sl in (slice(0, 16), slice(16, 32)))

    for q0, tiles in walk("dq", Tq, Tk, causal, q_off, k_off).items():
        Q, G = _rows(qp, q0, OWN), _rows(gp, q0, OWN)
        l2 = _vec(lse2, q0, OWN)[..., None]
        d2 = _vec(dls, q0, OWN)[..., None]
        rows = torch.arange(q0, q0 + OWN)[:, None]
        acc = torch.zeros((B, H, OWN, DK))
        for k0 in tiles:
            K, V = _rows(kp, k0, BN), _rows(vp, k0, BN)
            keys = torch.arange(k0, k0 + BN)[None, :]
            km = torch.nn.functional.pad(keys_ok[:, k0:k0 + BN],
                                         (0, BN - min(BN, Tk - k0)),
                                         value=True)
            s, dp = scores(Q, K), scores(G, V)
            p = _exp2_fma(s, scale2, l2)
            if not full_pair("dq", q0, k0, Tq, Tk, causal, q_off, k_off,
                             masked=not bool(km.all())):
                ok = (keys < Tk) & (~torch.as_tensor(causal)
                                    | (keys + k_off <= rows + q_off))
                ok = ok[None, None] & km[:, None, None, :]
                p = torch.where(ok, p, torch.zeros(()))
            ds = _ds(p, dp, scale, d2)
            acc = acc + torch.einsum("bhqk,bhkd->bhqd", bf16(ds), K)
        dq[:, :, q0:q0 + OWN] = acc[:, :, :min(OWN, Tq - q0)]

    for k0, tiles in walk("dkv", Tq, Tk, causal, q_off, k_off).items():
        K, V = _rows(kp, k0, OWN), _rows(vp, k0, OWN)
        keys = torch.arange(k0, k0 + OWN)[:, None]
        dk_acc = torch.zeros((B, H, OWN, DK))
        dv_acc = torch.zeros((B, H, OWN, DK))
        for q0 in tiles:
            Q, G = _rows(qp, q0, BN), _rows(gp, q0, BN)
            l2 = _vec(lse2, q0, BN)[..., None, :]
            d2 = _vec(dls, q0, BN)[..., None, :]
            cols = torch.arange(q0, q0 + BN)[None, :]
            st, dpt = scores(K, Q), scores(V, G)
            p = _exp2_fma(st, scale2, l2)
            if not full_pair("dkv", k0, q0, Tq, Tk, causal, q_off, k_off):
                ok = (cols < Tq) & (~torch.as_tensor(causal)
                                    | (keys + k_off <= cols + q_off))
                p = torch.where(ok, p, torch.zeros(()))
            dst = _ds(p, dpt, scale, d2)
            dv_acc = dv_acc + torch.einsum("bhkq,bhqd->bhkd", bf16(p), G)
            dk_acc = dk_acc + torch.einsum("bhkq,bhqd->bhkd", bf16(dst), Q)
        n = min(OWN, Tk - k0)
        dead = ~keys_ok[:, k0:k0 + n][:, None, :, None]   # zeroed at the end
        dk[:, :, k0:k0 + n] = dk_acc[:, :, :n].masked_fill(dead, 0.0)
        dv[:, :, k0:k0 + n] = dv_acc[:, :, :n].masked_fill(dead, 0.0)
    return tuple(t.permute(0, 2, 1, 3)[..., :D].to(torch.bfloat16)
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
    "D=32 causal T=2": (2, 2, 2, 4, 32, True, None, (0, 0)),
    "D=24 (padded) causal, ragged key mask": (2, 200, 200, 2, 24, True,
                                              [200, 137], (0, 0)),
    "D=24 (padded) not causal Tq=37 Tk=53": (2, 37, 53, 2, 24, False,
                                             [53, 20], (0, 0)),
    "D=16 causal, ragged key mask": (2, 200, 200, 2, 16, True, [200, 137],
                                     (0, 0)),
    "D=16 not causal Tq=37 Tk=53, key mask": (2, 37, 53, 2, 16, False,
                                              [53, 20], (0, 0)),
}


def _inputs(name, seed=7):
    """Seeded bf16 operands of one case (numpy normals rounded to bf16),
    the key mask, and an LSE cotangent under offsets (folded into delta,
    as the ring's)."""
    B, Tq, Tk, H, D, causal, valid, offs = CASES[name]
    rng = np.random.default_rng(seed)
    q, g = (torch.from_numpy(rng.normal(size=(B, Tq, H, D)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(B, Tk, H, D)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    km = None
    if valid is not None:
        km = (torch.arange(Tk)[None, :]
              < torch.as_tensor(valid)[:, None]).to(torch.float32)
    g_lse = None
    if offs != (0, 0):
        g_lse = torch.from_numpy(rng.normal(size=(B, H, Tq)).astype(
            np.float32))
    return q, k, v, g, km, g_lse


def _bar_share(a, b):
    """The worst share of BF16_GRAD_TOL that a takes against b, in f32."""
    a, b = a.float(), b.float()
    bar = BF16_GRAD_TOL["rel"] * b.abs() \
        + BF16_GRAD_TOL["of_max"] * b.abs().max()
    return float(((a - b).abs() / bar.clamp_min(1e-30)).max())


@pytest.mark.parametrize("seed", [7, 11])
@pytest.mark.parametrize("name", CASES)
def test_the_kernels_sums_and_roundings_meet_the_bf16_bar(name, seed):
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
                            key_mask=km, q_off=q_off, k_off=k_off)
    for gname, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape, gname
        assert torch.isfinite(a.float()).all(), gname
        assert _bar_share(a, b) <= 1.0, (gname, _bar_share(a, b))
    if km is not None:          # a masked key's dK and dV rows: exactly 0
        dead = km == 0
        assert (got[1][dead] == 0).all() and (got[2][dead] == 0).all()
    none = torch.arange(Tq) + q_off < k_off
    if causal and bool(none.any()):     # a row that sees no key: dq row 0
        assert (got[0][:, none] == 0).all()


def test_a_wrong_walk_misses_the_bar():
    """The emulation follows `walk`: dropping a dq block's last key tile
    (the diagonal one) breaks the gradients, so the walks above matter."""
    name = "D=32 causal B=2 T=300 H=2"
    B, Tq, Tk, H, D, causal, valid, offs = CASES[name]
    q, k, v, g, km, _ = _inputs(name)
    out, lse = fa.flash_attention_plain(q, k, v, return_lse=True,
                                        causal=True)
    delta = fa.attention_delta(out, g)
    want = fa.flash_bwd_dq_plain(q, k, v, g, lse, delta, causal=True)
    real = walk
    try:
        globals()["walk"] = lambda role, *a: {
            o: (t[:-1] if role == "dq" else t)
            for o, t in real(role, *a).items()}
        got = emulated_backward(q, k, v, g, lse, delta, causal=True,
                                key_mask=None)
    finally:
        globals()["walk"] = real
    assert _bar_share(got[0], want) > 1.0


# the JAX package's Pallas kernels, interpret mode, block 16, bf16
# operands: (B, T, H, D, causal, key mask valid lengths, offsets or None
# for `flash_attention`)
JAX_CASES = {
    "flash_attention D=32 causal, key mask": (1, 64, 2, 32, True, [51],
                                              None),
    "flash_attention D=24 causal": (1, 48, 2, 24, True, None, None),
    "flash_attention D=16 not causal, key mask": (1, 40, 2, 16, False, [33],
                                                  None),
    "flash_attention_lse D=32 diagonal 32/32": (1, 64, 2, 32, True, None,
                                                (32, 32)),
    "flash_attention_lse D=32 offsets 0/32": (1, 64, 2, 32, True, None,
                                              (0, 32)),
}


@pytest.mark.parametrize("name", JAX_CASES)
def test_emulation_matches_the_jax_bf16_gradients(name):
    """JAX's bf16 gradients by `jax.vjp` through its custom_vjp and Pallas
    kernels (f32 arithmetic on the upcast tiles, one rounding to bf16), for
    seeded cotangents of out (and of the LSE, through the LSE entry),
    against the emulation fed the port's plain forward and the same
    cotangents: within BF16_GRAD_TOL, the emulation's P and dS rounded to
    bf16 for their products."""
    B, T, H, D, causal, valid, offs = JAX_CASES[name]
    rng = np.random.default_rng(21)
    arrs = [rng.normal(size=(B, T, H, D)).astype(np.float32)
            for _ in range(4)]
    g_lse = rng.normal(size=(B, H, T)).astype(np.float32)
    jq, jk, jv, jg = (jnp.asarray(a, jnp.bfloat16) for a in arrs)
    tq, tk, tv, tg = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    for j, t in zip((jq, jk, jv, jg), (tq, tk, tv, tg)):
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
        f = lambda a, b, c: jax_flash_attention(a, b, c, causal=causal,
                                                key_mask=jkm, **blocks)
        cot = jg
    else:
        f = lambda a, b, c: jax_flash_attention_lse(
            a, b, c, causal=causal, key_mask=jkm, q_offset=q_off,
            k_offset=k_off, **blocks)
        cot = (jg, jnp.asarray(g_lse))
    _, vjp = jax.vjp(f, jq, jk, jv)
    want = [torch.from_numpy(np.asarray(x).astype(np.float32))
            for x in vjp(cot)]
    tkm = None if km is None else torch.from_numpy(km)
    kw = dict(causal=causal, key_mask=tkm, q_offset=q_off, k_offset=k_off)
    out, lse = fa.flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    delta = fa.attention_delta(out, tg)
    if offs is not None:
        delta = delta - torch.from_numpy(g_lse)
    got = emulated_backward(tq, tk, tv, tg, lse, delta, causal=causal,
                            key_mask=tkm, q_off=q_off, k_off=k_off)
    for gname, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _bar_share(a, b) <= 1.0, (gname, _bar_share(a, b))
    none = np.arange(T) + q_off < k_off
    if none.any():
        assert (want[0][:, none] == 0).all()
        assert (got[0][:, none] == 0).all()
