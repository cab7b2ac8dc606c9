#!/usr/bin/env python3
"""A/B of the bf16 attention kernels between two checkouts on one GPU.

    python3 chip_ab.py run ROOT LABEL    # one turn: ROOT's kernels
    python3 chip_ab.py summary LOG...    # table of the turns' device times

`run` imports ROOT's own `chip_smoke.py` and port package (ROOT first on
sys.path), builds ROOT's kernels (phase 1: ptxas's report), and runs the
bf16 cases through ROOT's own case functions: phase 2's `_bf16_case` at
the train case (bitwise twice), with a ragged key mask, at Tq=37 Tk=53
(D=64, 16, 128), B=4 T=4096 H=8, B=2 T=4096 H=8 D=128 and B=2 T=200 H=4
D=128 with a ragged key mask, then phase 7's
`_lse_case` on the ring's bf16 shard (diagonal and past, each with and
without a ragged key mask, and offsets 0/512). Inputs come from the seeds
chip_smoke.py uses (1 and 2), so both checkouts see the same tensors, and
every gate of those functions holds in each turn. It prints one line
`{"ab": LABEL, "cases": [...]}` with each kernel's device time (the
profiler's, per call), CUDA-event time, bound, error and SDPA's device
time on the same inputs.

Run each turn in its own process, on one card, in the order parent,
change, change, parent: the card's clocks drift within a call, so each
side gets an early and a late turn, and the spread of the parent's two
turns is the noise a difference must beat. `summary` reads the `{"ab":
...}` lines of the logs and prints, per kernel and case, each side's
turns, the parent's own spread, the change/parent ratio, each side's
TFLOP/s and share of `bound_ms` (from its mean device time and the
case's operations at 989 TFLOP/s), SDPA's mean device time over all
turns, the change/SDPA ratio, and each side's mean `kernel_ms` (CUDA
events around the wrapper: device time plus the host's launch cost).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

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
SHARD = dict(B=4, T=1024, H=8, D=64)
PEAK_TFLOPS = 989.0         # H100 SXM dense bf16 tensor cores


def run(root, label):
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
    recs = []
    gen = torch.Generator().manual_seed(1)
    for lab, B, Tq, Tk, H, D, causal, valid, repeat in PHASE2:
        recs += cs._bf16_case(lab, B, Tq, Tk, H, D, causal, valid, gen,
                              repeat=repeat)
    gen = torch.Generator().manual_seed(2)
    B, T, H, D = SHARD["B"], SHARD["T"], SHARD["H"], SHARD["D"]
    ragged = [T - 97 * (b + 1) for b in range(B)]
    for lab, offs in (("diagonal", (T, T)), ("past", (T, 0))):
        for valid in (None, ragged):
            recs += cs._lse_case(
                "lse " + lab + (", ragged key mask" if valid else ""),
                torch.bfloat16, B, T, H, D, offs, valid, gen)
    recs += cs._lse_case("lse rows without keys", torch.bfloat16, B, T, H,
                         D, (0, T // 2), None, gen)
    print(json.dumps({"ab": label, "root": str(root), "cases": [
        {k: r.get(k) for k in ("name", "case", "device_ms", "ms",
                               "bound_ms", "ops_bound_ms", "max_abs_err",
                               "library_device_ms")}
        for r in recs]}))


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
          f"{'SDPA':>9}{'/SDPA':>7}{'kernel_ms':>18}")
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
        if c.get("ops_bound_ms") is not None and c.get("bound_ms"):
            row["tflops"] = {x: c["ops_bound_ms"] * PEAK_TFLOPS / t
                             for x, t in ((base, ma), (new, mb))}
            row["bound_share"] = {x: c["bound_ms"] / t
                                  for x, t in ((base, ma), (new, mb))}
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
              f"{pair(row.get('bound_share'), 3):>14}{sdpa}"
              f"{pair(row.get('kernel_ms'), 4):>18}")
    print(json.dumps({"ab_summary": rows}))


if __name__ == "__main__":
    if len(sys.argv) >= 4 and sys.argv[1] == "run":
        run(sys.argv[2], sys.argv[3])
    elif len(sys.argv) >= 3 and sys.argv[1] == "summary":
        summary(sys.argv[2:])
    else:
        raise SystemExit(__doc__)
