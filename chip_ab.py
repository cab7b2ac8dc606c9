#!/usr/bin/env python3
"""A/B of the attention kernels between two checkouts on one GPU.

    python3 chip_ab.py run ROOT LABEL [f32|decode|wide|rank]   # one turn
    python3 chip_ab.py summary LOG...         # table of the turns
    python3 chip_ab.py sweep ROOT LABEL       # decode at each cluster size

`run` imports ROOT's own `chip_smoke.py` and port package (ROOT first on
sys.path), builds ROOT's kernels (phase 1: ptxas's report), and runs one
set of cases through ROOT's own case functions. By default the bf16
kernels: phase 2's `_bf16_case` at the train case (bitwise twice), with a
ragged key mask, at Tq=37 Tk=53 (D=64, 16, 128), B=4 T=4096 H=8, B=2
T=4096 H=8 D=128 and B=2 T=200 H=4 D=128 with a ragged key mask, then
phase 7's `_lse_case` on the ring's bf16 shard (diagonal and past, each
with and without a ragged key mask, and offsets 0/512). With `f32`, the
float32 kernels: phase 2's `_fwd_case` at the prefill shapes (B=1 L=16,
64, 256 H=4, a ragged key mask), at the train case with the LSE and at
B=4 T=4096 H=8; the backward pair's `_bwd_case` at the train case
(bitwise twice), with a ragged key mask, at Tq=37 Tk=53 (D=64, 16, 128)
and B=4 T=4096 H=8; then phase 7's `_lse_case` on the float32 shard
(B=1 T=1024 H=4, the same five offset and mask cases; it times the
forward too). With `decode`, the two decode kernels: phase 2's
`_decode_case` at the serving step (S=8 C=256 H=4 D=64), with a length
0, at S=64 C=4096 H=8 and at bench_decode_paged's shape (S=4 C=128 H=4
D=32), and `_paged_case` at the served step (block size 16, 16 blocks a
slot), at block sizes 8 and 64, at S=64 with 256 blocks of 16 and at
bench_decode_paged's shape; a checkout whose case functions time the
decode grid's launch floor and count the kernels a call launches adds
them to each record. With `wide`, the forward above head dim 256 in
float32 and bfloat16 (`_forward_case` below, the same measurement on
either checkout, through ROOT's `flash_attention`): the D=320 model's
training shape (B=4 T=128 H=2, causal, with the LSE), B=2 T=200 H=4
causal with a ragged key mask at D=264, 320, 512 and 1024, and the long
causal shapes with the LSE, B=2 T=4096 H=4 D=512 and B=1 T=4096 H=4
D=1024; then phase 2b's `_wide_decode_case` (the f32 decode step through
the wide forward, S=8 C=256 H=4 D=320, slab and paged with blocks of
16). With `rank`, the kernels no PR has redesigned yet, once each at the
train case (B=16 T=512 causal, H so that H * D = 256): phase 2's
`_fwd_case` at D=256, `_bwd_case` at D=16, 32, 128 and 256,
`_bf16_case` at D=16 and 32, and both at the long wide case B=2 T=4096
H=4 D=512. Inputs come from fixed seeds,
so both checkouts see the same tensors, and every gate of those
functions holds in each turn. It prints one line `{"ab": LABEL, "cases":
[...]}` with each kernel's device time (the profiler's, per call),
CUDA-event time, operation count, bounds, error and SDPA's device time on
the same inputs. The bounds are recomputed here from the operation count
and the bytes, so that two checkouts whose chip_smoke.py count them
against other peaks compare alike: `bound_ms` against the tensor cores
(bf16 989 TFLOP/s; f32 165, three TF32 products per f32 product) and,
for f32, `simt_bound_ms` against the CUDA cores' 67 TFLOP/s. A record
from a chip_smoke.py that does not give `ops` has it from its
`ops_bound_ms` and that checkout's own peak.

`sweep` runs the `decode` cases of ROOT once with the wrappers' split
plan (`decode_split`) replaced, for that process only, by each fixed n
of 1, 2, 4 and 8, then once with the plan, and prints one line
`{"sweep": LABEL, "cases": [...]}` with each case's device time per n
(every gate of the case functions holds at each n).

Run each turn in its own process, on one card, in the order parent,
change, change, parent: the card's clocks drift within a call, so each
side gets an early and a late turn, and the spread of the parent's two
turns is the noise a difference must beat. `summary` reads the `{"ab":
...}` lines of the logs and prints, per kernel and case, each side's
turns, the parent's own spread, the change/parent ratio, each side's
TFLOP/s and share of `bound_ms` (from its mean device time and the
case's own `ops`; f32 also the share of the CUDA-core bound), SDPA's
mean device time over all turns, the change/SDPA ratio, and each side's
mean `kernel_ms` (CUDA events around the wrapper: device time plus the
host's launch cost).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

# (label, B, Tq, Tk, H, D, causal, valid key lengths or None, repeat)
PHASE2 = [
    ("train B=16 T=512 H=4 D=64", 16, 512, 512, 4, 64, True, None, True),
    ("train, ragged key mask", 16, 512, 512, 4, 64, True,
     [512 - 29 * b for b in range(16)], False),
    ("Tq=37 Tk=53 D=64", 2, 37, 53, 4, 64, False, [53, 20], False),
    ("Tq=37 Tk=53 D=16", 2, 37, 53, 4, 16, False, [53, 20], False),
    ("Tq=37 Tk=53 D=128", 2, 37, 53, 4, 128, False, [53, 20], False),
    ("B=4 T=4096 H=8", 4, 4096, 4096, 8, 64, True, None, False),
    ("B=2 T=4096 H=8 D=128", 2, 4096, 4096, 8, 128, True, None, False),
    ("B=2 T=200 H=4 D=128, ragged key mask", 2, 200, 200, 4, 128, True,
     [200, 137], False),
]
# float32 backward pair: (label, B, Tq, Tk, H, D, causal, valid, repeat)
PHASE2_F32 = [
    ("train B=16 T=512 H=4 D=64", 16, 512, 512, 4, 64, True, None, True),
    ("train, ragged key mask", 16, 512, 512, 4, 64, True,
     [512 - 29 * b for b in range(16)], False),
    ("Tq=37 Tk=53 D=64", 2, 37, 53, 4, 64, False, [53, 20], False),
    ("Tq=37 Tk=53 D=16", 2, 37, 53, 4, 16, False, [53, 20], False),
    ("Tq=37 Tk=53 D=128", 2, 37, 53, 4, 128, False, [53, 20], False),
    ("B=4 T=4096 H=8", 4, 4096, 4096, 8, 64, True, None, False),
]
# float32 forward: (label, B, T, H, D, valid key lengths or None, lse)
FWD_F32 = [
    ("prefill L=16", 1, 16, 4, 64, [13], False),
    ("prefill L=64", 1, 64, 4, 64, [49], False),
    ("prefill L=256", 1, 256, 4, 64, [193], False),
    ("train B=16 T=512 H=4 D=64", 16, 512, 4, 64, None, True),
    ("T=4096", 4, 4096, 8, 64, None, False),
    # the other widths: bench_decode_paged's prefill (bench.py:724-748,
    # d_model 128 over 4 heads, 24-token prompts), the train case and a
    # long shape at D=32 and 128, and D=16
    ("bench_decode_paged prefill B=1 L=24 H=4 D=32", 1, 24, 4, 32, [24],
     False),
    ("train B=16 T=512 H=8 D=32", 16, 512, 8, 32, None, True),
    ("train B=16 T=512 H=2 D=128", 16, 512, 2, 128, None, True),
    ("B=4 T=4096 H=8 D=32", 4, 4096, 8, 32, None, False),
    ("B=2 T=4096 H=8 D=128", 2, 4096, 8, 128, None, False),
    ("B=16 T=512 H=16 D=16", 16, 512, 16, 16, None, True),
]
# decode: ("slab", label, S, C, H, D, lengths) or ("paged", label, S, bs,
# nb, H, D, lengths)
_STEP = [1, 17, 100, 256, 3, 64, 200, 255]
_BIG = [1, 4096] + [int(x) for x in
                    np.random.default_rng(0).integers(1, 4097, size=64)[2:]]
DECODE = [
    ("slab", "step S=8 C=256", 8, 256, 4, 64, _STEP),
    ("slab", "lengths with 0", 4, 256, 4, 64, [0, 1, 256, 37]),
    ("slab", "S=64 C=4096", 64, 4096, 8, 64, _BIG),
    ("slab", "bench_decode_paged shape", 4, 128, 4, 32, [25, 48, 37, 30]),
    ("paged", "step S=8 bs=16 nb=16", 8, 16, 16, 4, 64, _STEP),
    ("paged", "bs=8 S=4 nb=32", 4, 8, 32, 4, 64, [0, 1, 256, 37]),
    ("paged", "bs=64 S=4 nb=4", 4, 64, 4, 4, 64, [0, 1, 256, 37]),
    ("paged", "S=64 nb=256 bs=16 H=8", 64, 16, 256, 8, 64, _BIG),
    ("paged", "bench_decode_paged shape", 4, 16, 8, 4, 32, [25, 48, 37, 30]),
]
# the wide forward: (label, B, T, H, D, valid key lengths or None, lse),
# causal
WIDE_FWD = [
    ("D=320 train B=4 T=128 H=2", 4, 128, 2, 320, None, True),
    *((f"D={D} B=2 T=200 H=4, ragged key mask", 2, 200, 4, D, [200, 137],
       False) for D in (264, 320, 512, 1024)),
    ("B=2 T=4096 H=4 D=512", 2, 4096, 4, 512, None, True),
    ("B=1 T=4096 H=4 D=1024", 1, 4096, 4, 1024, None, True),
]
# the f32 decode step through the wide forward: (label, S, H, D, block
# size or None for the slab)
WIDE_DECODE = [("decode step S=8 C=256 H=4 D=320", 8, 4, 320, None),
               ("paged decode step S=8 C=256 H=4 D=320 bs=16", 8, 4, 320,
                16)]
# the kernels not yet redesigned, at the train case with H * D = 256:
# (case function, D); and the wide pair at the long case
RANK = [("fwd", 256), *(("bwd", D) for D in (16, 32, 128, 256)),
        *(("bf16", D) for D in (16, 32))]
RANK_WIDE = ("B=2 T=4096 H=4 D=512", 2, 4096, 4, 512)
SHARD = dict(B=4, T=1024, H=8, D=64)
SHARD_F32 = dict(B=1, T=1024, H=4, D=64)
PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12    # dense bf16 tensor cores
PEAK_F32_TC_FLOPS = 495e12 / 3   # three TF32 products per f32 product
PEAK_F32_FLOPS = 67e12      # f32 on the CUDA cores


def _bounds(rec, cs):
    """The A/B fields of one chip_smoke record: its operation count (from
    `ops`, else from `ops_bound_ms` and the peak of the checkout `cs` that
    computed it) and both bounds recomputed from it and the bytes."""
    bf16 = rec["name"].endswith("_bf16")
    ops = rec.get("ops")
    if ops is None:
        ops = rec["ops_bound_ms"] * 1e-3 * (
            cs.PEAK_BF16_FLOPS if bf16 else cs.PEAK_F32_FLOPS)
    out = {"ops": ops, "bytes_bound_ms": rec["bytes_bound_ms"],
           "bound_ms": max(rec["bytes_bound_ms"], ops / (
               PEAK_BF16_FLOPS if bf16 else PEAK_F32_TC_FLOPS) * 1e3)}
    if not bf16:
        out["simt_bound_ms"] = max(rec["bytes_bound_ms"],
                                   ops / PEAK_F32_FLOPS * 1e3)
    return out


def _forward_case(cs, label, dtype, B, T, H, D, valid, lse, gen):
    """The forward alone (causal, key mask from `valid`, the LSE when
    `lse`) through ROOT's `flash_attention`, held to ROOT's bars against
    its plain version (f32: TOL on out and LSE; bf16: BF16_OUT_TOL,
    BF16_LSE_TOL), timed beside the plain version and SDPA on the same
    inputs (TF32 off: phase_card). Returns the record."""
    import torch
    from deeplearning4j_tpu_torch.kernels import (flash_attention,
                                                  flash_attention_plain)
    bf16 = dtype == torch.bfloat16
    q, k, v = (torch.randn((B, T, H, D), generator=gen).to(cs.DEVICE, dtype)
               for _ in range(3))
    km = cs._key_mask(B, T, valid)
    kw = dict(causal=True, key_mask=km, return_lse=lse)
    run = lambda: flash_attention(q, k, v, **kw)
    plain = lambda: flash_attention_plain(q, k, v, **kw)
    got, want = (r if lse else (r,) for r in (run(), plain()))
    torch.cuda.synchronize()
    name = "flash_fwd_bf16" if bf16 else "flash_fwd"
    out_tol, lse_tol = ((cs.BF16_OUT_TOL, cs.BF16_LSE_TOL) if bf16
                        else (cs.TOL, cs.TOL))
    err = float((got[0].float() - want[0].float()).abs().max())
    cs.check(got[0].dtype == dtype and bool(torch.isfinite(
        got[0].float()).all()) and err <= out_tol,
             f"{name} {label}: {got[0].dtype}, max abs err {err}")
    if lse:
        lse_err = float((got[1] - want[1]).abs().max())
        cs.check(lse_err <= lse_tol, f"{name} {label}: lse max abs err "
                                     f"{lse_err}")
    sq, sk, sv = (t.transpose(1, 2) for t in (q, k, v))
    mask = None if km is None else (km > 0)[:, None, None, :] & torch.ones(
        (T, T), dtype=torch.bool, device=q.device).tril()
    library = lambda: torch.nn.functional.scaled_dot_product_attention(
        sq, sk, sv, is_causal=mask is None, attn_mask=mask)
    size = 2 if bf16 else 4
    nbytes = size * 4 * B * T * H * D + 4 * (
        (B * H * T if lse else 0) + (B * T if km is not None else 0))
    pairs = cs._valid_pairs(B, T, T, H, True, km)
    return cs.rate_fields({
        "name": cs.kernel_name(name, D), "case": label,
        "shape": [B, T, T, H, D], "lse": lse, "key_mask": km is not None,
        "max_abs_err": err, "ms": cs.median_ms(run),
        "plain_ms": cs.median_ms(plain), "library_ms": cs.median_ms(library),
        **cs.bound(nbytes, 4 * D * pairs, bf16=bf16),
        "device_ms": cs.device_ms(run), "plain_device_ms": cs.device_ms(plain),
        "library_device_ms": cs.device_ms(library)})


def _wide(cs):
    import torch
    gen = torch.Generator().manual_seed(8)
    recs = [_forward_case(cs, lab, dtype, B, T, H, D, valid, lse, gen)
            for dtype in (torch.float32, torch.bfloat16)
            for lab, B, T, H, D, valid, lse in WIDE_FWD]
    recs += [cs._wide_decode_case(lab, S, H, D, cs.STEP_LENGTHS, gen, bs=bs)
             for lab, S, H, D, bs in WIDE_DECODE]
    return recs


def _rank(cs):
    import torch
    gen = torch.Generator().manual_seed(9)
    recs = []
    for case, D in RANK:
        H = 256 // D
        lab = f"train B=16 T=512 H={H} D={D}"
        if case == "fwd":
            recs.append(cs._fwd_case(lab, 16, 512, H, D, None, gen,
                                     lse=True))
        else:
            fn = cs._bwd_case if case == "bwd" else cs._bf16_case
            recs += fn(lab, 16, 512, 512, H, D, True, None, gen)
    lab, B, T, H, D = RANK_WIDE
    for fn in (cs._bwd_case, cs._bf16_case):
        recs += fn(lab, B, T, T, H, D, True, None, gen)
    return recs


def run(root, label, dtype="bf16"):
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    import torch
    import deeplearning4j_tpu_torch as port
    for mod in (cs, port):
        if root not in Path(mod.__file__).resolve().parents:
            raise SystemExit(f"{mod.__name__} imported from "
                             f"{mod.__file__}, not from {root}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is visible")
    cs.phase_card()
    if dtype in ("wide", "rank"):
        _print_turn(label, root, (_wide if dtype == "wide" else _rank)(cs),
                    cs)
        return
    if dtype == "decode":
        gen = torch.Generator().manual_seed(5)
        recs = [cs._decode_case(*c[1:], gen) if c[0] == "slab"
                else cs._paged_case(*c[1:], gen) for c in DECODE]
        _print_turn(label, root, recs, cs)
        return
    f32 = dtype == "f32"
    recs = []
    if f32:
        gen = torch.Generator().manual_seed(3)
        for lab, B, T, H, D, valid, lse in FWD_F32:
            recs.append(cs._fwd_case(lab, B, T, H, D, valid, gen, lse=lse))
    gen = torch.Generator().manual_seed(0 if f32 else 1)
    for lab, B, Tq, Tk, H, D, causal, valid, repeat in (
            PHASE2_F32 if f32 else PHASE2):
        case = cs._bwd_case if f32 else cs._bf16_case
        recs += case(lab, B, Tq, Tk, H, D, causal, valid, gen, repeat=repeat)
    gen = torch.Generator().manual_seed(2)
    shard = SHARD_F32 if f32 else SHARD
    B, T, H, D = shard["B"], shard["T"], shard["H"], shard["D"]
    dt = torch.float32 if f32 else torch.bfloat16
    ragged = [T - 97 * (b + 1) for b in range(B)]
    for lab, offs in (("diagonal", (T, T)), ("past", (T, 0))):
        for valid in (None, ragged):
            recs += cs._lse_case(
                "lse " + lab + (", ragged key mask" if valid else ""),
                dt, B, T, H, D, offs, valid, gen)
    recs += cs._lse_case("lse rows without keys", dt, B, T, H, D,
                         (0, T // 2), None, gen)
    _print_turn(label, root, recs, cs)


def _print_turn(label, root, recs, cs):
    print(json.dumps({"ab": label, "root": str(root), "cases": [
        {**{k: r.get(k) for k in ("name", "case", "device_ms", "ms",
                                  "max_abs_err", "library_device_ms",
                                  "kernels_per_call", "ctas_per_pair",
                                  "launch_floor_device_ms")},
         **_bounds(r, cs)}
        for r in recs]}))


def sweep(root, label):
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    import importlib
    import chip_smoke as cs
    import torch
    fa = importlib.import_module(
        "deeplearning4j_tpu_torch.kernels.flash_attention")
    if root not in Path(fa.__file__).resolve().parents:
        raise SystemExit(f"{fa.__file__} is not under {root}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is visible")
    cs.phase_card()
    plan = fa.decode_split
    times = {}
    for n in (1, 2, 4, 8, None):
        fa.decode_split = plan if n is None else (lambda *a, n=n: n)
        gen = torch.Generator().manual_seed(5)
        for c in DECODE:
            rec = (cs._decode_case(*c[1:], gen) if c[0] == "slab"
                   else cs._paged_case(*c[1:], gen))
            times.setdefault((rec["name"], rec["case"]), {})[
                "plan" if n is None else f"n={n}"] = rec["device_ms"]
    fa.decode_split = plan
    print(json.dumps({"sweep": label, "root": str(root), "cases": [
        {"name": k[0], "case": k[1], **v} for k, v in times.items()]}))


def summary(logs):
    turns = []
    for path in logs:
        for line in Path(path).read_text().splitlines():
            if line.startswith('{"ab"'):
                turns.append(json.loads(line))
    sides, walls, cases, libs = {}, {}, {}, {}
    for t in turns:
        for c in t["cases"]:
            key = (c["name"], c["case"])
            sides.setdefault(key, {}).setdefault(t["ab"], []).append(
                c["device_ms"])
            walls.setdefault(key, {}).setdefault(t["ab"], []).append(
                c.get("ms"))
            cases[key] = c
            libs.setdefault(key, []).append(c.get("library_device_ms"))
    labels = list(dict.fromkeys(t["ab"] for t in turns))
    if len(labels) != 2:
        raise SystemExit(f"expected two labels, got {labels}")
    base, new = labels
    print(f"{'kernel':<20}{'case':<30}{base + ' runs':>22}{new + ' runs':>22}"
          f"{base + ' spread':>14}{'ratio':>8}{'TFLOP/s':>16}{'of bound':>14}"
          f"{'of CUDA-core bound':>20}{'SDPA':>9}{'/SDPA':>7}"
          f"{'kernel_ms':>18}")
    rows = []
    for (name, case), by in sides.items():
        a, b = by.get(base, []), by.get(new, [])
        if not a or not b or None in a + b:
            continue
        ma, mb = sum(a) / len(a), sum(b) / len(b)
        spread = (max(a) - min(a)) / ma
        c = cases[(name, case)]
        row = {"name": name, "case": case, base: a, new: b,
               "spread": spread, "ratio": mb / ma}
        wall = {x: [w for w in walls[(name, case)].get(x, []) if w is not None]
                for x in (base, new)}
        if all(wall.values()):
            row["kernel_ms"] = {x: sum(w) / len(w) for x, w in wall.items()}
        means = ((base, ma), (new, mb))
        if c.get("ops") is not None:
            row["tflops"] = {x: c["ops"] / (t * 1e-3) / 1e12
                             for x, t in means}
        if c.get("bound_ms"):
            row["bound_share"] = {x: c["bound_ms"] / t for x, t in means}
        if c.get("simt_bound_ms"):
            row["simt_bound_share"] = {x: c["simt_bound_ms"] / t
                                       for x, t in means}
        lib = [x for x in libs.get((name, case), []) if x is not None]
        row["sdpa_device_ms"] = sum(lib) / len(lib) if lib else None
        row["vs_sdpa"] = mb / row["sdpa_device_ms"] if lib else None
        rows.append(row)
        pair = lambda d, n: (" / ".join(f"{d[x]:.{n}f}" for x in (base, new))
                             if d else "-")
        sdpa = (f"{row['sdpa_device_ms']:>9.4f}{row['vs_sdpa']:>7.2f}"
                if lib else f"{'-':>9}{'-':>7}")
        print(f"{name:<20}{case:<30}"
              f"{' / '.join(f'{x:.4f}' for x in a):>22}"
              f"{' / '.join(f'{x:.4f}' for x in b):>22}"
              f"{spread:>14.3f}{mb / ma:>8.3f}"
              f"{pair(row.get('tflops'), 0):>16}"
              f"{pair(row.get('bound_share'), 3):>14}"
              f"{pair(row.get('simt_bound_share'), 3):>20}{sdpa}"
              f"{pair(row.get('kernel_ms'), 4):>18}")
    print(json.dumps({"ab_summary": rows}))


if __name__ == "__main__":
    if len(sys.argv) in (4, 5) and sys.argv[1] == "run" \
            and sys.argv[4:] in ([], ["f32"], ["bf16"], ["decode"],
                                 ["wide"], ["rank"]):
        run(*sys.argv[2:])
    elif len(sys.argv) >= 3 and sys.argv[1] == "summary":
        summary(sys.argv[2:])
    elif len(sys.argv) == 4 and sys.argv[1] == "sweep":
        sweep(*sys.argv[2:])
    else:
        raise SystemExit(__doc__)
