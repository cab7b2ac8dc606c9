"""The plan and numerics of the float32 attention backward at D = 128 and 256.

`csrc/flash_bwd.cu` `flash_bwd_f32_ws<D>` (the C entries flash_bwd_dq_f32
and flash_bwd_dkv_f32 at D = 256, and so every D % 8 == 0 from 136 to 248,
whose operands the wrapper zero-pads to 256; and at D = 128, so also every
D % 8 == 0 from 72 to 120, zero-padded to 128) gives each block 64 owned
rows and all D output columns, one m64nD accumulator. A dq block owns
q rows and walks the key tiles of 32 keys up to the causal limit. The
dk/dv grid pairs, in a cluster, a dK block and a dV block of the same 64
keys; both walk the q tiles of 32 rows from the first one that sees an
owned key (none: they write zeros), the dV block computing S^T and
handing P^T to the dK block, which computes dP^T. A walked tile is 16
ring items of one 32-column chunk each: first the eight chunks of the
score pass (dq, dK: B2 = V or dO, for dP; dV: B1 = Q, for S), then the
box operand's eight (dq: B1 = K, for S; dK: B1 = Q; dV: B2 = dO), which
the splitters also transpose into B^T ([256][32], each 8-row group in
`k_slot` order). At D = 128 a ring item is 64 columns (two chunks under
one mbarrier), so a walked tile is 4 items; dq's owned operands are split
once at load, its score products reading both operands from shared
memory; and one block per 64 keys computes both dK and dV
(`flash_bwd_dkv_f32_d128`: S^T over Q's items, dP^T over dO's, both
transposed into Q^T and dO^T, P^T and dS^T in registers), with no P^T
hand-over. The order of sums is the same. S and dP are summed over D chunk
by chunk, in order, each
k8 slice as three TF32 products of split operands (lo.hi, hi.lo, hi.hi),
each chunk's 12 products into an accumulator of their own, added to the
total in f32. Then p (a full tile pair as one fused step,
any other tile with its masks), ds, and the gradient product: dS, P^T or
dS^T split into register A against B^T, the first tile's product
overwriting the accumulator. dq at D = 256, and the other blocks on a grid
of fewer blocks than the card has SMs, run two ranks per owned tile: rank
0 walks the first half of the tiles, rank 1 the rest, and rank 0 adds
rank 1's accumulator to its own.

The kernel cannot run here, so this file pins what it follows: the walks,
the chunk order over D and the ring's slots, the `k_slot` order of dS,
P^T and dS^T against K^T, dO^T and Q^T, and the arithmetic emulated in
the kernel's order of sums (walked whole and split), TF32 rounded to
nearest (ties away) by integer operations on a float32 view. The
emulation is held against the port's `flash_bwd_dq_plain` /
`flash_bwd_dkv_plain` at chip_smoke.py's BWD_TOL (allclose rtol 2e-4,
atol 2e-5) at D = 256 and, zero-padded, at D = 136 and 192, and at D = 128
and, zero-padded, at D = 80 and 96: causal, with
a ragged key mask, not causal at Tq != Tk, under causal offsets and with
rows that see no key (dq rows 0), a masked key's dK and dV rows exactly 0;
and against the JAX package's `flash_attention` / `flash_attention_lse`
gradients with its Pallas kernel in interpret mode, as its own tests run
it, at a small T. One TF32 product per f32 product, and a B^T in plain
key order, miss the bar. The emulation lives here only; no path of the
port uses it.
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
DP = 256            # the wider kernel's head dim (BwdWs<256>::D)
BO = 64             # owned rows of a block
BW = 32             # walked rows of a tile
DC = 32             # head-dim columns of a chunk (one f32 TMA box)
NC = DP // DC       # chunks of the head dim
NS = 4              # ring slots
STEPS = 2 * NC      # ring items per walked tile
DQ_RANKS = 2        # at D = 256 a dq block's walk is always split in two
# columns of a ring item (BwdWs<D>::IC, DkvD128::IC) and the ring slots
ITEM_COLS = {128: 64, 256: 32}
D128_DQ_SLOTS, D128_DQ_LAG = 4, 2   # BwdWs<128, true>: NS, LAG
D128_DKV_SLOTS = 6                  # DkvD128::NS
LOG2E = 1.4426950408889634
NEG_INF = -1e30
NEG_INF2 = np.float32(NEG_INF) * np.float32(LOG2E)   # the key mask's x, log2


def tf32(x):
    """x rounded to TF32, nearest with ties away from zero (hopper_f32.cuh
    `tf32_round`: add half a unit of the 13 dropped bits, clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def slice_product(eq, a, b, terms):
    """einsum(eq, a, b) over one k8 slice with each scalar product as TF32:
    one product of the rounded operands, or the split's three, small terms
    first, each added to the running sum by the caller."""
    if terms == 1:
        return [torch.einsum(eq, tf32(a), tf32(b))]
    (ah, al), (bh, bl) = split(a), split(b)
    return [torch.einsum(eq, al, bh), torch.einsum(eq, ah, bl),
            torch.einsum(eq, ah, bh)]


def k_slot(c):
    """hopper_f32.cuh `k_slot`: the k position, inside its 8-block, of the
    B^T column that the splitters write for walked row c."""
    return (c >> 1) | ((c & 1) << 2)


def a_fragment_k(c):
    """The k position at which the register-A split puts accumulator column
    c of an 8-column block (a thread's columns 2t and 2t + 1 go to k = t
    and t + 4)."""
    t, odd = divmod(c, 2)
    return t + 4 * odd


def width(D):
    """The kernel's head dim for a true head dim D (the wrapper zero-pads
    72..120 to 128 and 136..248 to 256)."""
    return 128 if D <= 128 else 256


# ------------------------------------------------------------------ plan
def halves(n, n_split):
    """The walked tiles 0 .. n - 1 of each rank: all on one block, or rank
    0 the first half (rounded up), rank 1 the rest."""
    if n_split == 1:
        return [list(range(n))]
    half = (n + 1) // 2
    return [list(range(half)), list(range(half, n))]


def walk(role, Tq, Tk, causal, q_off, k_off, n_split=1):
    """{(own0, rank): [w0, ...]}: the first walked row of each tile each
    block walks, in its order (the kernel's walk0, n_all, t0, n_tiles).
    dq owns q rows and walks keys; dk and dv own keys and walk q rows."""
    shift = q_off - k_off
    plan = {}
    for own0 in range(0, Tq if role == "dq" else Tk, BO):
        if role == "dq":
            walk0 = 0
            k_end = (min(Tk, max(0, min(Tq, own0 + BO) + shift)) if causal
                     else Tk)
            n_all = -(-k_end // BW)
        else:
            walk0 = max(0, own0 - shift) // BW * BW if causal else 0
            n_all = -(-(Tq - walk0) // BW) if walk0 < Tq else 0
        for rank, tiles in enumerate(halves(n_all, n_split)):
            plan[(own0, rank)] = [walk0 + BW * j for j in tiles]
    return plan


def items(role, dp=DP):
    """A walked tile's ring items (operand, item): the score pass's items
    first, then the box operand's, which the splitters transpose into B^T
    (dq: K, also the operand of S; dK: Q; dV: dO). Item i of an operand
    holds its chunks `chunks(i, dp)`: at D = 256 one chunk an item (16
    items), at D = 128 two (4 items). At D = 128 one block computes dK and
    dV: Q's items (S^T, and Q^T for dK), then dO's (dP^T, and dO^T for
    dV)."""
    first, second = ("B1", "B2") if role == "dv" else ("B2", "B1")
    if dp == 128 and role != "dq":
        first, second = "B1", "B2"
    n = dp // ITEM_COLS[dp]
    return [(first, i) for i in range(n)] + [(second, i) for i in range(n)]


def chunks(i, dp=DP):
    """The 32-column chunks of item i, in the order their sums run."""
    per = ITEM_COLS[dp] // DC
    return list(range(per * i, per * i + per))


# --------------------------------------------------------------- numerics
def score(a, b, terms):
    """a b^T over the head dim as the kernel sums it: a [..., M, D] (the
    owned operand: at D = 256 split in registers, at 128 split at load),
    b [..., N, D] (the walked one, split by the splitters), chunk by chunk
    in order, k8 slice by slice, term by term, each chunk's 12 products
    into a sum of their own, added to the total."""
    total = None
    for c in range(a.shape[-1] // DC):
        part = None
        for kk in range(DC // 8):
            cols = slice(DC * c + 8 * kk, DC * c + 8 * kk + 8)
            for x in slice_product("...md,...nd->...mn", a[..., cols],
                                   b[..., cols], terms):
                part = x if part is None else part + x
        total = part if total is None else total + part
    return total


def grad_product(acc, x, w, terms, b_order):
    """acc (+)= x w over the 32 walked rows: x [..., 64, 32] (dS, P^T or
    dS^T, columns in register-A order), w [..., 32, D] (the walked tile
    of the box operand) as B^T [D, 32] with row r at column b_order[r];
    one product per k8 slice and term, the first tile's overwriting acc."""
    a_order = torch.tensor([8 * (c // 8) + a_fragment_k(c % 8)
                            for c in range(BW)])
    a = torch.empty_like(x)
    a[..., a_order] = x
    bt = torch.empty(w.shape[:-2] + (w.shape[-1], BW))
    bt[..., torch.as_tensor(b_order)] = w.transpose(-1, -2)
    for kk in range(BW // 8):
        sl = slice(8 * kk, 8 * kk + 8)
        for part in slice_product("...mk,...dk->...md", a[..., sl],
                                  bt[..., sl], terms):
            acc = part if acc is None else acc + part
    return acc


def _rows(x, r0, n):
    """Rows r0 .. r0 + n - 1 of x [B, H, T, D], zero past T (TMA's zero
    fill)."""
    T = x.shape[2]
    part = x[:, :, r0:min(T, r0 + n)]
    return torch.nn.functional.pad(part, (0, 0, 0, n - part.shape[2]))


def _vec(x, r0, n, fill):
    """x[..., r0:r0 + n] of a [..., T] tensor, `fill` past T."""
    T = x.shape[-1]
    part = x[..., r0:min(T, r0 + n)]
    return torch.nn.functional.pad(part, (0, n - part.shape[-1]),
                                   value=fill)


def _exp2_fma(s, scale2, l2):
    """2^(fmaf(s, scale2, -l2)): the product and the sum rounded once."""
    return torch.exp2((s.double() * float(scale2) - l2.double()).float())


def emulated_backward(q, k, v, g, lse, delta, *, causal, key_mask, q_off=0,
                      k_off=0, terms=3, b_order=None, n_split=1):
    """(dq, dk, dv) as flash_bwd_f32_ws computes them: the operands
    zero-padded to the kernel's width (128 or 256 columns) at the true D's
    scale, block by block and tile by tile on the kernel's walks (dq at
    D = 256 always, and the other blocks with n_split = 2, two ranks per
    owned tile, rank 1's accumulator added to rank 0's). `b_order`
    replaces B^T's `k_slot` order (a wrong one must miss the bar)."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    kd = width(D)
    dq_ranks = DQ_RANKS if kd == 256 else n_split
    scale = np.float32(1.0 / math.sqrt(D))
    scale2 = scale * np.float32(LOG2E)
    shift = q_off - k_off
    if b_order is None:
        b_order = [8 * (c // 8) + k_slot(c % 8) for c in range(BW)]
    qp, kp, vp, gp = (torch.nn.functional.pad(t, (0, kd - D))
                      .permute(0, 2, 1, 3) for t in (q, k, v, g))
    lse2 = lse * np.float32(LOG2E)
    km = (torch.ones((B, Tk)) if key_mask is None else key_mask)[:, None]
    outs = {}
    # dq: rows own0.., lse log2e and delta per row, key validity per key
    dq = torch.zeros((B, H, Tq, kd))
    for (own0, rank), tiles in walk("dq", Tq, Tk, causal, q_off, k_off,
                                    dq_ranks).items():
        r = own0 + torch.arange(BO)[:, None]
        rv = _vec(lse2, own0, BO, 0.0)[..., None]
        rd = _vec(delta, own0, BO, 0.0)[..., None]
        a1, a2 = _rows(qp, own0, BO), _rows(gp, own0, BO)
        acc = None
        for w0 in tiles:
            b1, b2 = _rows(kp, w0, BW), _rows(vp, w0, BW)
            dp = score(a2, b2, terms)
            s = score(a1, b1, terms)
            kpos = w0 + torch.arange(BW)[None, :]
            cv = _vec(km, w0, BW, 1.0)[..., None, :]     # [B, 1, 1, BW]
            full = (cv > 0).all(-1, keepdim=True) & (w0 + BW <= Tk) & (
                not causal or w0 + BW - 1 + k_off <= own0 + q_off)
            x2 = torch.where(cv > 0, (s.double() * float(scale2)
                                      - rv.double()).float(), NEG_INF2 - rv)
            seen = (kpos < Tk) & (~torch.tensor(causal) | (kpos <= r + shift))
            p = torch.where(full, _exp2_fma(s, scale2, rv),
                            torch.where(seen, torch.exp2(x2),
                                        torch.zeros_like(x2)))
            ds = p * (dp - rd) * scale
            acc = grad_product(acc, ds, b1, terms, b_order)
        outs[(own0, rank)] = acc
    for own0 in range(0, Tq, BO):
        parts = [outs[(own0, rank)] for rank in range(dq_ranks)
                 if outs[(own0, rank)] is not None]
        n = min(BO, Tq - own0)
        if parts:
            total = parts[0] if len(parts) == 1 else parts[0] + parts[1]
            dq[:, :, own0:own0 + n] = total[:, :, :n]
    # dk, dv: keys own0.., key validity per key, lse log2e and delta per q
    # row; the dV block's P^T is the dK block's (one cluster, one S^T)
    dk = torch.zeros((B, H, Tk, kd))
    dv = torch.zeros((B, H, Tk, kd))
    kvalid = (km[:, 0] > 0).float()
    outs = {}
    plan = walk("dk", Tq, Tk, causal, q_off, k_off, n_split)
    assert plan == walk("dv", Tq, Tk, causal, q_off, k_off, n_split)
    for (own0, rank), tiles in plan.items():
        r = own0 + torch.arange(BO)[:, None]
        rv = _vec(kvalid, own0, BO, 0.0)[:, None, :, None]
        # a masked key among each warp's 16 rows (past Tk: not counted)
        in_t = (r < Tk)[None, None]
        masked = (in_t & ~(rv > 0)).reshape(B, 1, BO // 16, 16, 1)
        warp_masked = masked.any(3, keepdim=True).expand(
            B, 1, BO // 16, 16, 1).reshape(B, 1, BO, 1)
        a1, a2 = _rows(kp, own0, BO), _rows(vp, own0, BO)
        acc_k = acc_v = None
        for w0 in tiles:
            b1, b2 = _rows(qp, w0, BW), _rows(gp, w0, BW)
            s = score(a1, b1, terms)              # the dV block's
            qpos = w0 + torch.arange(BW)[None, :]
            l2 = _vec(lse2, w0, BW, 0.0)[..., None, :]
            full = ~warp_masked & (
                not causal or own0 + BO - 1 + k_off <= w0 + q_off)
            x2 = torch.where(rv > 0, (s.double() * float(scale2)
                                      - l2.double()).float(), NEG_INF2 - l2)
            seen = (qpos < Tq) & (~torch.tensor(causal) | (r - shift <= qpos))
            p = torch.where(full, _exp2_fma(s, scale2, l2),
                            torch.where(seen, torch.exp2(x2),
                                        torch.zeros_like(x2)))
            dp = score(a2, b2, terms)             # the dK block's
            dl = _vec(delta, w0, BW, 0.0)[..., None, :]
            acc_k = grad_product(acc_k, p * (dp - dl) * scale, b1, terms,
                                 b_order)
            acc_v = grad_product(acc_v, p, b2, terms, b_order)
        outs[(own0, rank)] = (acc_k, acc_v)
    for own0 in range(0, Tk, BO):
        n = min(BO, Tk - own0)
        for kind, out in enumerate((dk, dv)):
            parts = [outs[(own0, rank)][kind] for rank in range(n_split)
                     if outs[(own0, rank)][kind] is not None]
            if parts:
                total = parts[0] if len(parts) == 1 else parts[0] + parts[1]
                out[:, :, own0:own0 + n] = total[:, :, :n]
    return tuple(x.permute(0, 2, 1, 3)[..., :D].contiguous()
                 for x in (dq, dk, dv))


# ------------------------------------------------------------------ cases
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
    "D=128 causal B=2 T=150 H=2": (2, 150, 150, 2, 128, True, None, (0, 0)),
    "D=128 causal, ragged key mask": (2, 150, 150, 2, 128, True, [150, 93],
                                      (0, 0)),
    "D=96 (padded) causal, ragged key mask": (2, 150, 150, 2, 96, True,
                                              [150, 93], (0, 0)),
    "D=80 (padded) causal": (1, 100, 100, 2, 80, True, None, (0, 0)),
    "D=128 Tq=37 Tk=53 not causal, key mask": (2, 37, 53, 2, 128, False,
                                               [53, 20], (0, 0)),
    "D=128 diagonal offsets 64/64, key mask": (1, 128, 128, 2, 128, True,
                                               [101], (64, 64)),
    "D=128 past offsets 128/0": (1, 96, 96, 2, 128, True, None, (128, 0)),
    "D=128 offsets 0/96, rows without keys": (1, 192, 192, 2, 128, True,
                                              None, (0, 96)),
}


def _inputs(name, seed=5):
    """Seeded numpy operands of one case: q, k, v, dO, the key mask, and
    an LSE cotangent under offsets (folded into delta, as the ring's)."""
    B, Tq, Tk, H, D, causal, valid, offs = CASES[name]
    rng = np.random.default_rng(seed)
    q, g = (rng.normal(size=(B, Tq, H, D)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.normal(size=(B, Tk, H, D)).astype(np.float32)
            for _ in range(2))
    km = None
    if valid is not None:
        km = (np.arange(Tk)[None, :] < np.asarray(valid)[:, None]).astype(
            np.float32)
    g_lse = None
    if offs != (0, 0):
        g_lse = rng.normal(size=(B, H, Tq)).astype(np.float32)
    return q, k, v, g, km, g_lse


def _plain_and_emulation(name, **over):
    """(the plain versions' (dq, dk, dv), the emulation's, the key mask)."""
    B, Tq, Tk, H, D, causal, valid, (q_off, k_off) = CASES[name]
    q, k, v, g, km, g_lse = map(
        lambda a: None if a is None else torch.from_numpy(a),
        _inputs(name))
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


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("n_split", [1, 2])
@pytest.mark.parametrize("name", CASES)
def test_dq_walks_every_key_tile_up_to_the_causal_limit_once(name, n_split):
    B, Tq, Tk, H, D, causal, valid, (q_off, k_off) = CASES[name]
    plan = walk("dq", Tq, Tk, causal, q_off, k_off, n_split)
    for own0 in range(0, Tq, BO):
        last_row = q_off + min(Tq, own0 + BO) - 1      # the tile's last row
        k_end = (min(Tk, max(0, last_row + 1 - k_off)) if causal else Tk)
        per_rank = [plan[(own0, r)] for r in range(n_split)]
        tiles = [w for ts in per_rank for w in ts]
        assert tiles == list(range(0, k_end, BW))      # each tile once
        if n_split == 2:    # rank 0 the first half, rank 1 the rest
            assert len(per_rank[0]) - len(per_rank[1]) in (0, 1)
        # every key a row of the tile sees lies in a walked tile
        assert len(tiles) * BW >= k_end


@pytest.mark.parametrize("n_split", [1, 2])
@pytest.mark.parametrize("name", CASES)
def test_dk_dv_walk_every_q_tile_from_the_first_that_sees_a_key(name,
                                                                n_split):
    B, Tq, Tk, H, D, causal, valid, (q_off, k_off) = CASES[name]
    for role in ("dk", "dv"):
        plan = walk(role, Tq, Tk, causal, q_off, k_off, n_split)
        for own0 in range(0, Tk, BO):
            tiles = [w for r in range(n_split) for w in plan[(own0, r)]]
            # the q rows that see at least one owned key
            rows = [i for i in range(Tq)
                    if not causal or q_off + i >= k_off + own0]
            if not rows:
                assert tiles == []          # the block writes zeros
                continue
            assert tiles[0] == rows[0] // BW * BW
            assert tiles == list(range(tiles[0], Tq, BW))   # each once
            # no row before the walk sees an owned key
            assert all(i >= tiles[0] for i in rows)


def test_a_d128_tile_is_four_items_of_two_chunks():
    """At D = 128 an item is two 32-column TMA boxes under one mbarrier.
    dq takes dP's two items (B2 = V), then S's (B1 = K), which the
    splitters also transpose into K^T. The dk/dv block takes S^T's two
    (B1 = Q), then dP^T's (B2 = dO), and every item is also transposed:
    Q's into Q^T (for dK), dO's into dO^T (for dV). The chunks of each
    operand's items, in item order, are the head dim's four in order (the
    order of the chunk sums), and each B^T row is filled once."""
    dp = 128
    for role in ("dq", "dk", "dv"):
        its = items(role, dp)
        assert len(its) == 4
        order = ["B2", "B2", "B1", "B1"] if role == "dq" else [
            "B1", "B1", "B2", "B2"]
        assert [op for op, _ in its] == order
        for half in (its[:2], its[2:]):
            assert [c for _, i in half for c in chunks(i, dp)] == [
                0, 1, 2, 3]
            rows = [DC * c + r for _, i in half for c in chunks(i, dp)
                    for r in range(DC)]
            assert rows == list(range(dp))
    # an item's hi (or lo) is 8 KB. dq: Q and dO split whole (hi, lo), a
    # ring of 4, K^T; dk/dv: K and V as landed, a ring of 6, Q^T and dO^T
    item = BW * ITEM_COLS[dp] * 4
    own = BO * dp * 4
    bt = 2 * dp * BW * 4                        # a B^T's hi and lo
    small = 2 * 2 * BW * 4 + 2 * BO * 4         # column and row values
    dq_bytes = 4 * own + D128_DQ_SLOTS * 2 * item + bt + small + 8 * 20
    dkv_bytes = (2 * own + D128_DKV_SLOTS * 2 * item + 2 * bt
                 + 2 * 2 * BW * 4 + BO * 4 + 8 * (3 + 3 * D128_DKV_SLOTS))
    assert max(dq_bytes, dkv_bytes) + 1024 <= 232448
    # another slot would not fit beside either
    assert dkv_bytes + 2 * item + 1024 > 232448
    assert dq_bytes + 2 * item + 1024 > 232448


def test_a_tile_is_sixteen_items_the_box_operands_last():
    """dq and dK: dP's eight chunks (B2 = V, dO), then the box operand's
    (B1 = K, also S's; Q); dV: S's eight (B1 = Q), then dO's (B2). Each
    operand's chunks in order over D, each B^T row filled once."""
    for role in ("dq", "dk", "dv"):
        its = items(role)
        assert len(its) == STEPS
        box = "B2" if role == "dv" else "B1"
        assert [op for op, _ in its] == [next(o for o in ("B1", "B2")
                                              if o != box)] * NC + [box] * NC
        assert [c for _, c in its[:NC]] == list(range(NC))
        assert [c for _, c in its[NC:]] == list(range(NC))
        rows = [DC * c + r for _, c in its[NC:] for r in range(DC)]
        assert rows == list(range(DP))


def _slots_in_order(role, n_slots, lag, steps):
    n_items = 6 * steps
    by_slot = {}
    for u in range(n_items):
        by_slot.setdefault(u % n_slots, []).append((u // n_slots) & 1)
    for phases in by_slot.values():
        assert phases == [i & 1 for i in range(len(phases))]
    # every item is loaded once: the first NS up front, each later one at
    # the splitters' step u = item - NS + LAG, after item - NS's release
    loaded = list(range(min(n_slots, n_items)))
    for u in range(n_items):
        v = u - lag
        if v >= 0 and v + n_slots < n_items:
            loaded.append(v + n_slots)
    assert loaded == list(range(n_items))
    assert 0 < lag < n_slots
    # the consumer reads every item of a dq tile, a dk/dv tile's score
    # items; the column values of tile j, written at its first item into
    # buffer j % 2, are rewritten for tile j + 2 only after the splitters'
    # wait on tile j's gradient product (`btempty`, at tile j + 1's first
    # box item), so the consumer has read them
    read = [i for i in range(steps) if role == "dq" or i < steps // 2]
    assert read == list(range(steps if role == "dq" else steps // 2))
    for j in range(2, 6):
        box_wait = (j - 1) * steps + steps // 2    # waits btempty(j - 2)
        assert box_wait < j * steps


def test_d128_dq_slots_and_phases_are_handed_over_in_order():
    """D = 128 dq: 4 items a tile through a ring of 4 slots, LAG 2, with
    the hand-overs of the D = 256 kernel."""
    _slots_in_order("dq", D128_DQ_SLOTS, D128_DQ_LAG, len(items("dq", 128)))


@pytest.mark.parametrize("n_tiles", [1, 2, 3, 7])
def test_d128_dkv_ring_refills_each_tile_after_its_transposes(n_tiles):
    """D = 128 dk/dv (`flash_bwd_dkv_f32_d128`): item u sits in slot u %
    6 and completes that slot's (u // 6)-th phases. The splitters split a
    tile's 4 items (ready), wait for the tile before's gradient products
    (`btempty`), transpose all 4 (each slot's empty takes the consumer's
    128 arrivals and the splitters' 128), mark Q^T and dO^T whole
    (`btfull`), then reload each of the tile's slots with the item 6 on,
    once both sides are done with it. So every item is loaded once, each
    before the splitters wait for it, into a slot whose item before is
    done."""
    ns, steps = D128_DKV_SLOTS, 4
    n_items = n_tiles * steps
    loaded = list(range(min(ns, n_items)))      # issued up front
    waits = []
    for j in range(n_tiles):
        for i in range(steps):                  # the split phase
            u = j * steps + i
            assert u in loaded                  # its TMA was issued
            waits.append(u)
        for i in range(steps):                  # the refill after it
            u = j * steps + i
            if u + ns < n_items:
                # slot u % ns: item u done on both sides, u + ns goes in
                assert (u + ns) % ns == u % ns
                loaded.append(u + ns)
    assert sorted(loaded) == list(range(n_items))
    assert len(loaded) == len(set(loaded))
    assert waits == list(range(n_items))
    # the phases each slot's waits see: 0, 1, 0, 1, ...
    by_slot = {}
    for u in range(n_items):
        by_slot.setdefault(u % ns, []).append((u // ns) & 1)
    assert all(p == [k & 1 for k in range(len(p))] for p in by_slot.values())
    # a tile's items fit the ring whole, so its transposes find them all
    assert steps <= ns


@pytest.mark.parametrize("role,n_slots,lag", [("dq", 4, 2), ("dk", 10, 4),
                                               ("dv", 10, 4)])
def test_each_slot_and_phase_is_handed_over_in_order(role, n_slots, lag):
    """Item u of a block's walk sits in slot u % NS (dq 4 slots, dk/dv 10)
    and completes that slot's (u // NS)-th phase of full, ready and empty,
    so waits taken in walk order see each slot's phases 0, 1, 0, 1, ...;
    slot u % NS is refilled with item u + NS once item u is consumed, which
    the splitters wait for LAG items later (NS - LAG items of TMA ahead).
    dk/dv: the consumer reads only a tile's score chunks, the splitters
    release the box chunks themselves and mark B^T whole with the tile's
    last one (`btfull`); B^T is rewritten only after the consumer's
    gradient product (`btempty`)."""
    _slots_in_order(role, n_slots, lag, STEPS)


def test_k_slot_is_the_a_fragment_order_of_ds_and_p():
    assert [k_slot(c) for c in range(8)] == [a_fragment_k(c)
                                             for c in range(8)]
    assert sorted(k_slot(c) for c in range(8)) == list(range(8))


def test_full_tile_pairs_take_the_fast_path_where_the_kernel_does():
    """dq: key tile w0 of the block at own0 is full when every row sees
    every key; dk/dv: q tile w0 of the keys at own0 is full when its first
    row sees the last owned key."""
    dq_full = lambda w0, own0, Tk=512: w0 + BW <= Tk and w0 + BW - 1 <= own0
    assert [dq_full(32 * j, 64) for j in range(4)] == [True, True, False,
                                                       False]
    assert not dq_full(96, 128, Tk=120)
    dkv_full = lambda own0, w0: own0 + BO - 1 <= w0
    assert [dkv_full(64, 32 * j) for j in range(2, 6)] == [False, False,
                                                          True, True]


@pytest.mark.parametrize("n_split", [1, 2])
@pytest.mark.parametrize("name", CASES)
def test_three_tf32_products_meet_the_backward_bar(name, n_split):
    want, got, km = _plain_and_emulation(name, n_split=n_split)
    for gname, a, b in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(a).all(), gname
        assert torch.allclose(a, b, **BWD_TOL), (gname, _err(a, b))
    if km is not None:          # a masked key's dK and dV rows: exactly 0
        dead = km == 0
        assert (got[1][dead] == 0).all() and (got[2][dead] == 0).all()
    B, Tq, Tk, H, D, causal, valid, (q_off, k_off) = CASES[name]
    none = torch.arange(Tq) + q_off < k_off
    if causal and bool(none.any()):     # a row that sees no key: dq row 0
        assert (got[0][:, none] == 0).all()


@pytest.mark.parametrize("name", ["D=256 causal B=2 T=150 H=1",
                                  "D=192 (padded) causal, ragged key mask",
                                  "D=128 causal B=2 T=150 H=2",
                                  "D=96 (padded) causal, ragged key mask"])
def test_one_tf32_product_misses_the_backward_bar(name):
    want, got, _ = _plain_and_emulation(name, terms=1)
    assert not all(torch.allclose(a, b, **BWD_TOL)
                   for a, b in zip(got, want))


def test_b_t_in_plain_key_order_misses_the_backward_bar():
    """dS, P^T and dS^T in register-A order against a K^T, dO^T and Q^T in
    plain walked-row order: the `k_slot` permutation is what makes each
    gradient product right."""
    want, got, _ = _plain_and_emulation("D=256 causal B=2 T=150 H=1",
                                        b_order=list(range(BW)))
    for gname, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _err(a, b) > 100 * BWD_TOL["atol"], gname


def test_b_t_in_plain_key_order_misses_the_backward_bar_at_d128():
    want, got, _ = _plain_and_emulation("D=128 causal B=2 T=150 H=2",
                                        b_order=list(range(BW)))
    for gname, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _err(a, b) > 100 * BWD_TOL["atol"], gname


# the JAX package's Pallas kernels, interpret mode, block 16: (B, T, H, D,
# causal, key mask valid lengths, offsets or None for `flash_attention`)
JAX_CASES = {
    "flash_attention D=256 causal, key mask": (1, 64, 1, 256, True, [51],
                                               None),
    "flash_attention D=192 causal": (1, 48, 2, 192, True, None, None),
    "flash_attention_lse D=256 diagonal 32/32": (1, 64, 1, 256, True, None,
                                                 (32, 32)),
    "flash_attention_lse D=256 offsets 0/32": (1, 64, 1, 256, True, None,
                                               (0, 32)),
    "flash_attention D=128 causal, key mask": (1, 64, 2, 128, True, [51],
                                               None),
    "flash_attention D=80 causal": (1, 48, 2, 80, True, None, None),
    "flash_attention_lse D=128 diagonal 32/32": (1, 64, 2, 128, True, None,
                                                 (32, 32)),
    "flash_attention_lse D=128 offsets 0/32": (1, 64, 2, 128, True, None,
                                               (0, 32)),
}


@pytest.mark.parametrize("name", JAX_CASES)
def test_emulation_matches_the_jax_gradients(name):
    """JAX's gradients by `jax.vjp` through its custom_vjp and Pallas
    kernels, for seeded cotangents of out (and of the LSE, through the LSE
    entry), against the emulation fed the port's plain forward and the
    same cotangents."""
    B, T, H, D, causal, valid, offs = JAX_CASES[name]
    rng = np.random.default_rng(13)
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
                            key_mask=tkm, q_off=q_off, k_off=k_off,
                            n_split=2)
    for gname, a, b in zip(("dq", "dk", "dv"), got, want):
        assert np.allclose(a.numpy(), b, **BWD_TOL), (
            gname, float(np.abs(a.numpy() - b).max()))
    none = np.arange(T) + q_off < k_off
    if none.any():
        assert (want[0][:, none] == 0).all()
        assert (got[0].numpy()[:, none] == 0).all()
