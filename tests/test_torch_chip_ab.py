"""The port's A/B driver (chip_ab.py) and the kernel builder's cache key.

chip_ab.py runs only on a card (each turn builds and times one checkout's
kernels); here its summary is checked on synthetic turns, its bounds on
synthetic records, and `run` must refuse without a card. `build.py`
names each library by a hash of its source and every shared header, so
an edit of any header (csrc/*.cuh) must rebuild every library.
"""
import json
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_ab  # noqa: E402
from deeplearning4j_tpu_torch.kernels import build  # noqa: E402


def _turn(path, label, times):
    cases = [{"name": n, "case": c, "device_ms": t, "ms": t and 2 * t,
              "bound_ms": 0.01, "max_abs_err": 0.0}
             for (n, c), t in times.items()]
    path.write_text("noise line\n" + json.dumps({"ab": label,
                                                 "cases": cases}) + "\n")
    return str(path)


def test_summary_reports_each_side_spread_and_ratio(tmp_path, capsys):
    key, other = ("flash_bwd_dq_bf16", "train"), ("flash_bwd_dkv_bf16", "x")
    logs = [_turn(tmp_path / "p1.log", "parent", {key: 0.050, other: 1.0}),
            _turn(tmp_path / "c1.log", "change", {key: 0.020, other: 0.5}),
            _turn(tmp_path / "c2.log", "change", {key: 0.022, other: None}),
            _turn(tmp_path / "p2.log", "parent", {key: 0.046, other: 1.0})]
    chip_ab.summary(logs)
    out = capsys.readouterr().out.strip().splitlines()
    rows = json.loads(out[-1])["ab_summary"]
    # a case with a turn that recorded no device time is left out
    assert [(r["name"], r["case"]) for r in rows] == [key]
    row = rows[0]
    assert row["parent"] == [0.050, 0.046]
    assert row["change"] == [0.020, 0.022]
    assert row["spread"] == pytest.approx(0.004 / 0.048)
    assert row["ratio"] == pytest.approx(0.021 / 0.048)


def test_summary_reports_rates_sdpa_and_wall_time(tmp_path, capsys):
    """TFLOP/s (the record's own operation count) and share of the bound
    from each side's mean device time, SDPA's mean device time over the
    turns that timed it, and each side's mean wall time around the
    wrapper."""
    def turn(name, label, dev, wall, lib):
        case = {"name": "flash_fwd_bf16", "case": "train", "device_ms": dev,
                "ms": wall, "ops": 0.002e-3 * 989e12, "bound_ms": 0.005,
                "max_abs_err": 0.0, "library_device_ms": lib}
        path = tmp_path / name
        path.write_text(json.dumps({"ab": label, "cases": [case]}) + "\n")
        return str(path)
    chip_ab.summary([turn("p1", "parent", 0.030, 0.10, 0.014),
                     turn("c1", "change", 0.010, 0.12, None),
                     turn("c2", "change", 0.010, 0.14, 0.016),
                     turn("p2", "parent", 0.034, 0.10, 0.015)])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "ab_summary"][0]
    assert row["tflops"]["change"] == pytest.approx(0.002 * 989 / 0.010)
    assert row["tflops"]["parent"] == pytest.approx(0.002 * 989 / 0.032)
    assert row["bound_share"]["change"] == pytest.approx(0.5)
    assert "simt_bound_share" not in row       # bf16: no CUDA-core bound
    assert row["sdpa_device_ms"] == pytest.approx(0.015)
    assert row["vs_sdpa"] == pytest.approx(0.010 / 0.015)
    assert row["kernel_ms"] == pytest.approx({"parent": 0.10,
                                              "change": 0.13})


def test_f32_records_get_both_bounds_and_their_rates(tmp_path, capsys):
    """An f32 record's bounds are recomputed from its operations and bytes
    (165 TFLOP/s on the tensor cores, 67 on the CUDA cores), also for a
    checkout whose records give only `ops_bound_ms` at its own f32 peak;
    the summary's TFLOP/s is operations over each side's mean device time,
    and its shares are each bound over that time."""
    ops = 6 * 64 * 1_000_000                    # dq: 6*D per pair
    cs = SimpleNamespace(PEAK_F32_FLOPS=67e12, PEAK_BF16_FLOPS=989e12)
    new = {"name": "flash_bwd_dq", "ops": ops, "bytes_bound_ms": 1e-4,
           "ops_bound_ms": ops / 165e9}
    old = {"name": "flash_bwd_dq", "bytes_bound_ms": 1e-4,
           "ops_bound_ms": ops / 67e9}
    want = {"ops": ops, "bytes_bound_ms": 1e-4,
            "bound_ms": ops / (495e12 / 3) * 1e3,
            "simt_bound_ms": ops / 67e12 * 1e3}
    for rec in (new, old):
        assert chip_ab._bounds(rec, cs) == pytest.approx(want)
    # bytes bound a small case on both
    tiny = chip_ab._bounds({"name": "flash_bwd_dkv", "ops": 8e6,
                            "bytes_bound_ms": 0.01}, cs)
    assert tiny["bound_ms"] == tiny["simt_bound_ms"] == 0.01

    def turn(path, label, dev):
        case = {"name": "flash_bwd_dq", "case": "train", "device_ms": dev,
                "ms": 2 * dev, "max_abs_err": 0.0, **want}
        path.write_text(json.dumps({"ab": label, "cases": [case]}) + "\n")
        return str(path)
    chip_ab.summary([turn(tmp_path / "p1", "parent", 0.21),
                     turn(tmp_path / "c1", "change", 0.07),
                     turn(tmp_path / "c2", "change", 0.09),
                     turn(tmp_path / "p2", "parent", 0.23)])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "ab_summary"][0]
    assert row["tflops"]["parent"] == pytest.approx(ops / 0.22e-3 / 1e12)
    assert row["tflops"]["change"] == pytest.approx(ops / 0.08e-3 / 1e12)
    assert row["bound_share"]["change"] == pytest.approx(
        want["bound_ms"] / 0.08)
    assert row["simt_bound_share"]["parent"] == pytest.approx(
        want["simt_bound_ms"] / 0.22)


def test_f32_turn_times_the_forward_at_the_path_shapes():
    """`run ROOT LABEL f32` times the float32 forward where the port's
    paths run it: serving's prefill buckets (one prompt, a ragged key
    mask), the training forward with its LSE, and the long causal shape;
    the shard's forward comes with `_lse_case`."""
    cases = {c[0]: c[1:] for c in chip_ab.FWD_F32}
    for L in (16, 64, 256):
        B, T, H, D, valid, lse = cases[f"prefill L={L}"]
        assert (B, T, H, D, lse) == (1, L, 4, 64, False)
        assert 0 < valid[0] < L
    assert cases["train B=16 T=512 H=4 D=64"] == (16, 512, 4, 64, None,
                                                  True)
    assert cases["T=4096"] == (4, 4096, 8, 64, None, False)


def test_decode_turn_runs_the_path_shapes_of_both_decode_kernels():
    """`run ROOT LABEL decode` times both decode kernels at chip_smoke's
    shapes, with the same lengths: the serving step (slab and paged, block
    size 16), a length 0, block sizes 8 and 64, S=64 C=4096 H=8 (the long
    case's lengths from np.random.default_rng(0), first 1 and C) and
    bench_decode_paged's model and cache (bench.py:724-748)."""
    import numpy as np
    import chip_smoke
    cases = {(c[0], c[1]): c[2:] for c in chip_ab.DECODE}
    step = chip_smoke.STEP_LENGTHS
    assert cases[("slab", "step S=8 C=256")] == (8, 256, 4, 64, step)
    assert cases[("paged", chip_smoke.PAGED_STEP_CASE)] == (8, 16, 16, 4,
                                                            64, step)
    big = np.random.default_rng(0).integers(1, 4097, size=64)
    big[0], big[1] = 1, 4096
    assert cases[("slab", "S=64 C=4096")] == (64, 4096, 8, 64,
                                              [int(x) for x in big])
    assert cases[("paged", "S=64 nb=256 bs=16 H=8")][-1] == \
        [int(x) for x in big]
    b = chip_smoke.BENCH_PAGED
    assert cases[("slab", "bench_decode_paged shape")] == (
        b["S"], b["C"], b["H"], b["D"], b["lengths"])
    assert cases[("paged", "bench_decode_paged shape")] == (
        b["S"], b["bs"], b["C"] // b["bs"], b["H"], b["D"], b["lengths"])
    assert {c[1] for c in chip_ab.DECODE if c[0] == "paged"} >= {
        "bs=8 S=4 nb=32", "bs=64 S=4 nb=4"}


def test_wide_turn_times_the_wide_forward_at_the_path_and_long_shapes():
    """`run ROOT LABEL wide` times the forward above head dim 256 where
    the D=320 model runs it (its training shape with the LSE; the f32
    decode step, slab and paged with blocks of 16), at chip_smoke's ragged
    cases, and at two long causal shapes of 137.5 GFLOP each (4 * D per
    unmasked pair)."""
    import chip_smoke
    cases = {c[0]: c[1:] for c in chip_ab.WIDE_FWD}
    assert cases["D=320 train B=4 T=128 H=2"] == (
        chip_smoke.WIDE_BATCH, chip_smoke.WIDE_SEQ, 2, 320, None, True)
    for D in chip_smoke.WIDE_HEAD_DIMS:
        assert cases[f"D={D} B=2 T=200 H=4, ragged key mask"] == (
            2, 200, 4, D, [200, 137], False)
    for label, D in (("B=2 T=4096 H=4 D=512", 512),
                     ("B=1 T=4096 H=4 D=1024", 1024)):
        B, T, H, d, valid, lse = cases[label]
        assert (d, valid, lse) == (D, None, True)
        assert 4 * D * B * H * T * (T + 1) // 2 == pytest.approx(137.5e9,
                                                                 rel=1e-3)
    assert [(S, H, D, bs) for _, S, H, D, bs in chip_ab.WIDE_DECODE] == [
        (8, 4, 320, None), (8, 4, 320, 16)]


def test_wide_bwd_turn_times_the_f32_pair_at_the_wide_forward_shapes():
    """`run ROOT LABEL wide_bwd` times the float32 pair above head dim 256
    at the shapes of the `wide` set: the D=320 model's training shape,
    chip_smoke's ragged cases and two long causal shapes of 206 GFLOP (dq,
    6 * D per unmasked pair) and 275 GFLOP (dk/dv, 8 * D) each."""
    import chip_smoke
    cases = {c[0]: c[1:] for c in chip_ab.WIDE_BWD}
    assert list(cases) == [c[0] for c in chip_ab.WIDE_FWD]
    assert cases["D=320 train B=4 T=128 H=2"] == (
        chip_smoke.WIDE_BATCH, chip_smoke.WIDE_SEQ, 2, 320, None)
    for D in chip_smoke.WIDE_HEAD_DIMS:
        assert cases[f"D={D} B=2 T=200 H=4, ragged key mask"] == (
            2, 200, 4, D, [200, 137])
    for label, D in (("B=2 T=4096 H=4 D=512", 512),
                     ("B=1 T=4096 H=4 D=1024", 1024)):
        B, T, H, d, valid = cases[label]
        assert (d, valid) == (D, None)
        pairs = B * H * T * (T + 1) // 2
        assert 6 * D * pairs == pytest.approx(206.2e9, rel=1e-3)
        assert 8 * D * pairs == pytest.approx(274.9e9, rel=1e-3)


def test_wide_bwd_bf16_turn_times_the_bf16_kernels_at_the_same_shapes():
    """`run ROOT LABEL wide_bwd_bf16` runs `_bf16_case` (the bf16 forward,
    then the pair) at each shape of the `wide_bwd` set, causal, with its
    key mask, and no other case function."""
    calls = []
    cs = SimpleNamespace(
        _bwd_case=lambda *a, **k: pytest.fail("the f32 pair"),
        _bf16_case=lambda *a, **k: calls.append(a[:8]) or [{"case": a[0]}])
    recs = chip_ab._wide_bwd(cs, bf16=True)
    assert calls == [(lab, B, T, T, H, D, True, valid)
                     for lab, B, T, H, D, valid in chip_ab.WIDE_BWD]
    assert [r["case"] for r in recs] == [c[0] for c in chip_ab.WIDE_BWD]


def test_rank_turn_takes_each_kernel_not_yet_redesigned_once(capsys):
    """`run ROOT LABEL rank` times each kernel no PR has redesigned yet:
    none is left (the f32 pair at D=32, and D=8 to 24 on it, was the last
    on its first design; `d32_bwd_f32` times it now), so RANK is empty and
    the turn says so and times nothing: no forward, no pair, nothing
    wide."""
    assert chip_ab.RANK == []
    assert not hasattr(chip_ab, "RANK_WIDE")
    cs = SimpleNamespace(
        _fwd_case=lambda *a, **k: pytest.fail("the f32 forward"),
        _bwd_case=lambda *a, **k: pytest.fail("the f32 pair"),
        _bf16_case=lambda *a, **k: pytest.fail("the bf16 kernels"))
    assert chip_ab._rank(cs) == []
    assert "nothing to time" in capsys.readouterr().out


def test_d256_turn_takes_chip_smokes_d256_cases_and_a_long_one():
    """`run ROOT LABEL d256` times the f32 forward at head dim 256 at every
    case chip_smoke.py holds it to (D256_CASES, then the D256_LSE shard
    under each of D256_LSE_OFFSETS through `flash_attention_lse`) and at
    the long causal B=2 T=4096 H=4 with the LSE (0.4166 ms of operations
    at 165 TFLOP/s), each through `_forward_case` in the set's order."""
    import chip_smoke
    B, T, H, D = chip_smoke.D256_LSE
    want = [(*c[:9], None) for c in chip_smoke.D256_CASES]
    want += [(lab, B, T, T, H, D, True, None, True, offs)
             for lab, offs in chip_smoke.D256_LSE_OFFSETS]
    long = ("D=256 long B=2 T=4096 H=4", 2, 4096, 4096, 4, 256, True, None,
            True, None)
    assert [c for c in chip_ab.D256 if c[0] != long[0]] == want
    assert long in chip_ab.D256
    assert chip_ab.D256[0][0] == "D=256 train B=16 T=512 H=1"
    assert 4 * 256 * 2 * 4 * 4096 * 4097 // 2 / (495e12 / 3) * 1e3 == \
        pytest.approx(0.4166, rel=1e-3)
    calls = []

    def case(cs, label, dtype, B, Tq, H, D, valid, lse, gen, Tk=None,
             causal=True, offsets=None):
        calls.append((label, B, Tq, Tk, H, D, causal, valid, lse, offsets))
        return {"case": label}
    orig = chip_ab._forward_case
    chip_ab._forward_case = case
    try:
        recs = chip_ab._d256(SimpleNamespace())
    finally:
        chip_ab._forward_case = orig
    assert calls == chip_ab.D256
    assert [r["case"] for r in recs] == [c[0] for c in chip_ab.D256]


def test_d256_bwd_turn_takes_the_pair_at_chip_smokes_d256_shapes():
    """`run ROOT LABEL d256_bwd` times the f32 pair at head dim 256 through
    `_bwd_case`, causal unless named: the train case B=16 T=512 H=1 first
    (bitwise twice more), B=2 T=200 H=4 with a ragged key mask at D=256 and
    D=192, Tq=37 Tk=53 not causal with a key mask, the D=256 model's
    training shape B=4 T=128 H=2, chip_smoke's B=8 T=512 H=4 case with its
    ragged key mask (a dk/dv grid over one wave), the long B=2 T=4096 H=4
    (dq 0.625 ms and dk/dv 0.833 ms of operations at 165 TFLOP/s); then
    `_lse_case` on chip_smoke's D256_LSE shard under each of
    D256_LSE_OFFSETS (diagonal, past, rows without keys), in that order."""
    import chip_smoke
    by = {c[0]: c[1:] for c in chip_ab.D256_BWD}
    assert chip_ab.D256_BWD[0][0] == "D=256 train B=16 T=512 H=1"
    assert by["D=256 train B=16 T=512 H=1"] == (16, 512, 512, 1, 256, True,
                                                None, True)
    for D in (256, 192):
        assert by[f"D={D} B=2 T=200 H=4, ragged key mask"] == (
            2, 200, 200, 4, D, True, [200, 137], False)
    assert by["D=256 Tq=37 Tk=53, key mask"] == (2, 37, 53, 4, 256, False,
                                                 [53, 20], False)
    assert by["D=256 model B=4 T=128 H=2"] == (
        chip_smoke.WIDE_BATCH, chip_smoke.WIDE_SEQ, chip_smoke.WIDE_SEQ,
        chip_smoke.D256_MODEL["n_heads"],
        chip_smoke.D256_MODEL["d_model"] // chip_smoke.D256_MODEL["n_heads"],
        True, None, False)
    full = "D=256 B=8 T=512 H=4, ragged key mask"
    assert by[full] == (8, 512, 512, 4, 256, True, chip_smoke.D256_FULL_VALID,
                        False)
    assert (*by[full][:7], True, False) in [c[1:] for c in
                                            chip_smoke.D256_CASES]
    # dk/dv: a dK and a dV block per 64-key tile, over the 132 SMs
    assert 512 // 64 * 2 * 8 * 4 > 132
    assert len(set(chip_smoke.D256_FULL_VALID)) == 8 > 1
    B, T, Tk, H, D, causal, valid, _ = by["D=256 long B=2 T=4096 H=4"]
    assert (B, T, Tk, H, D, causal, valid) == (2, 4096, 4096, 4, 256, True,
                                               None)
    pairs = B * H * T * (T + 1) // 2
    assert 6 * D * pairs / (495e12 / 3) * 1e3 == pytest.approx(0.625,
                                                                rel=1e-3)
    assert 8 * D * pairs / (495e12 / 3) * 1e3 == pytest.approx(0.833,
                                                                rel=1e-3)
    assert [c[0] for c in chip_smoke.D256_LSE_OFFSETS] == [
        "D=256 diagonal", "D=256 past", "D=256 rows without keys"]
    calls = []
    cs = SimpleNamespace(
        D256_LSE=chip_smoke.D256_LSE,
        D256_LSE_OFFSETS=chip_smoke.D256_LSE_OFFSETS,
        _fwd_case=lambda *a, **k: pytest.fail("the forward case"),
        _bwd_case=lambda *a, **k: calls.append(
            ("bwd", *a[:8], k["repeat"])) or [{"case": a[0]}],
        _lse_case=lambda *a, **k: calls.append(("lse", *a[:7])) or [
            {"case": a[0]}])
    import torch
    recs = chip_ab._d256_bwd(cs)
    B, T, H, D = chip_smoke.D256_LSE
    assert calls == [("bwd", *c) for c in chip_ab.D256_BWD] + [
        ("lse", lab, torch.float32, B, T, H, D, offs)
        for lab, offs in chip_smoke.D256_LSE_OFFSETS]
    assert [r["case"] for r in recs] == [c[1] for c in calls]


def test_d128_bwd_turn_takes_the_pair_at_chip_smokes_d128_shapes():
    """`run ROOT LABEL d128_bwd` times the f32 pair at head dim 128 through
    `_bwd_case`: every case of chip_smoke's D128_CASES in its order (the
    train case B=16 T=512 H=2 first, bitwise twice more; the padded D=96
    and 80), then the D=128 model's training shape B=4 T=128 H=2 and the
    long B=2 T=4096 H=8 (dq 0.6249 ms and dk/dv 0.8332 ms of operations at
    165 TFLOP/s); then `_lse_case` on chip_smoke's D128_LSE shard under
    each of its D128_LSE_OFFSETS, from chip_ab's own copy (a parent
    checkout's chip_smoke.py has none)."""
    import chip_smoke
    import torch
    smoke = [tuple(c) for c in chip_smoke.D128_CASES]
    assert [c for c in chip_ab.D128_BWD if c in smoke] == smoke
    assert chip_ab.D128_BWD[0] == smoke[0] == (
        "D=128 train B=16 T=512 H=2", 16, 512, 512, 2, 128, True, None,
        True)
    assert {c[5] for c in smoke} == {128, 96, 80}
    by = {c[0]: c[1:] for c in chip_ab.D128_BWD}
    conf = chip_smoke.D128_MODEL
    assert by["D=128 model B=4 T=128 H=2"] == (
        chip_smoke.WIDE_BATCH, chip_smoke.WIDE_SEQ, chip_smoke.WIDE_SEQ,
        conf["n_heads"], conf["d_model"] // conf["n_heads"], True, None,
        False)
    B, T, Tk, H, D, causal, valid, _ = by["D=128 long B=2 T=4096 H=8"]
    pairs = B * H * T * (T + 1) // 2
    assert 6 * D * pairs / (495e12 / 3) * 1e3 == pytest.approx(0.6249,
                                                                rel=1e-3)
    assert 8 * D * pairs / (495e12 / 3) * 1e3 == pytest.approx(0.8332,
                                                                rel=1e-3)
    # B=8 T=512 H=4: dq 256 blocks, dk/dv 512, both over 132 SMs
    assert 512 // 64 * 8 * 4 > 132
    assert chip_ab.D128_LSE == chip_smoke.D128_LSE
    assert chip_ab.D128_LSE_OFFSETS == chip_smoke.D128_LSE_OFFSETS
    calls = []
    cs = SimpleNamespace(
        _fwd_case=lambda *a, **k: pytest.fail("the forward case"),
        _bwd_case=lambda *a, **k: calls.append(
            ("bwd", *a[:8], k["repeat"])) or [{"case": a[0]}],
        _lse_case=lambda *a, **k: calls.append(("lse", *a[:7])) or [
            {"case": a[0]}])
    recs = chip_ab._d128_bwd(cs)
    B, T, H, D = chip_ab.D128_LSE
    assert calls == [("bwd", *c) for c in chip_ab.D128_BWD] + [
        ("lse", lab, torch.float32, B, T, H, D, offs)
        for lab, offs in chip_ab.D128_LSE_OFFSETS]
    assert [r["case"] for r in recs] == [c[1] for c in calls]


def test_d32_bwd_bf16_turn_takes_the_pair_at_chip_smokes_d32_shapes():
    """`run ROOT LABEL d32_bwd_bf16` times the bf16 pair at head dim 32
    through `_bf16_case` (the forward with the LSE, then dq and dk/dv, each
    its own record): every case of chip_smoke's D32_BF16_CASES in its
    order (the train case B=16 T=512 H=8 first, bitwise twice more; D=24
    padded; D=16 on the same kernels; bench_decode_paged's model's
    training shape B=4 T=128 H=4, bitwise twice more; the long B=4 T=4096
    H=8: dq 0.0521 ms and dk/dv 0.0695 ms of operations at 989 TFLOP/s),
    then chip_smoke's head-count cases at D=32 (B=16385 H=4 T=16 and
    65536 heads at T=2); then `_lse_case` in
    bf16 on chip_smoke's D32_LSE shard under each of its D32_LSE_OFFSETS,
    from chip_ab's own copy (a parent checkout's chip_smoke.py has
    none)."""
    import chip_smoke
    import torch
    smoke = [tuple(c) for c in chip_smoke.D32_BF16_CASES]
    assert [c for c in chip_ab.D32_BWD_BF16 if c in smoke] == smoke
    assert chip_ab.D32_BWD_BF16[0] == smoke[0] == (
        "D=32 train B=16 T=512 H=8", 16, 512, 512, 8, 32, True, None, True)
    assert {c[5] for c in smoke} == {32, 24, 16}
    assert chip_ab.D32_BWD_BF16[len(smoke):] == [
        ("D=32 B=16385 H=4 T=16", 16385, 16, 16, 4, 32, True, None, False),
        ("D=32 B=1 H=65536 T=2", 1, 2, 2, 65536, 32, True, None, False)]
    by = {c[0]: c[1:] for c in chip_ab.D32_BWD_BF16}
    conf = chip_smoke.BENCH_PAGED_MODEL
    assert by["D=32 model B=4 T=128 H=4"] == (
        chip_smoke.WIDE_BATCH, chip_smoke.WIDE_SEQ, chip_smoke.WIDE_SEQ,
        conf["n_heads"], conf["d_model"] // conf["n_heads"], True, None,
        True)
    B, T, Tk, H, D, causal, valid, _ = by["D=32 long B=4 T=4096 H=8"]
    pairs = B * H * T * (T + 1) // 2
    assert 6 * D * pairs / 989e12 * 1e3 == pytest.approx(0.0521, rel=1e-3)
    assert 8 * D * pairs / 989e12 * 1e3 == pytest.approx(0.0695, rel=1e-3)
    assert chip_ab.D32_LSE == chip_smoke.D32_LSE
    assert chip_ab.D32_LSE_OFFSETS == chip_smoke.D32_LSE_OFFSETS
    calls = []
    cs = SimpleNamespace(
        _bwd_case=lambda *a, **k: pytest.fail("the f32 pair"),
        _bf16_case=lambda *a, **k: calls.append(
            ("bf16", *a[:8], k["repeat"])) or [{"case": a[0]}],
        _lse_case=lambda *a, **k: calls.append(("lse", *a[:7])) or [
            {"case": a[0]}])
    recs = chip_ab._d32_bwd_bf16(cs)
    B, T, H, D = chip_ab.D32_LSE
    assert calls == [("bf16", *c) for c in chip_ab.D32_BWD_BF16] + [
        ("lse", lab, torch.bfloat16, B, T, H, D, offs)
        for lab, offs in chip_ab.D32_LSE_OFFSETS]
    assert [r["case"] for r in recs] == [c[1] for c in calls]


def test_d32_fwd_bf16_turn_takes_the_forward_at_chip_smokes_d32_shapes():
    """`run ROOT LABEL d32_fwd_bf16` times the bf16 forward at head dim 32
    alone through `_forward_case` in bf16, causal with the LSE unless
    named, in this order: the train case at D=32 (H=8) and at D=16 (H=16),
    the long B=4 T=4096 H=8 (0.0348 ms of operations at 989 TFLOP/s, 0.064
    ms of `ex2` at 16 a clock per SM on 132 SMs at 1.98 GHz), B=2 T=200 H=4
    with a ragged key mask at D=32, 24, 16 and 8, Tq=37 Tk=53 not causal
    with a key mask at D=32 and 16, chip_smoke's B=8 T=512 H=4 ragged case,
    bench_decode_paged's model's training shape B=4 T=128 H=4, the
    head-count cases (B=16385 H=4 T=16, 65536 heads at T=2), its prefill
    B=1 L=24 H=4 with a key mask and no LSE (chip_smoke's D32_PREFILL), and
    `flash_attention_lse` on the D32_LSE shard under each of
    D32_LSE_OFFSETS (diagonal, past, rows without keys)."""
    import chip_smoke
    import torch
    conf = chip_smoke.BENCH_PAGED_MODEL
    lab, B, L, H, D, valid = chip_smoke.D32_PREFILL
    Bl, Tl, Hl, Dl = chip_smoke.D32_LSE
    want = [
        ("D=32 train B=16 T=512 H=8", 16, 512, 512, 8, 32, True, None, True,
         None),
        ("D=16 train B=16 T=512 H=16", 16, 512, 512, 16, 16, True, None,
         True, None),
        ("D=32 long B=4 T=4096 H=8", 4, 4096, 4096, 8, 32, True, None, True,
         None),
        *((f"D={d} B=2 T=200 H=4, ragged key mask", 2, 200, 200, 4, d, True,
           [200, 137], True, None) for d in (32, 24, 16, 8)),
        *((f"D={d} Tq=37 Tk=53, key mask", 2, 37, 53, 4, d, False, [53, 20],
           True, None) for d in (32, 16)),
        ("D=32 B=8 T=512 H=4, ragged key mask", 8, 512, 512, 4, 32, True,
         chip_smoke.D256_FULL_VALID, True, None),
        ("D=32 model B=4 T=128 H=4", chip_smoke.WIDE_BATCH,
         chip_smoke.WIDE_SEQ, chip_smoke.WIDE_SEQ, conf["n_heads"],
         conf["d_model"] // conf["n_heads"], True, None, True, None),
        ("D=32 B=16385 H=4 T=16", 16385, 16, 16, 4, 32, True, None, True,
         None),
        ("D=32 B=1 H=65536 T=2", 1, 2, 2, 65536, 32, True, None, True, None),
        (lab, B, L, L, H, D, True, valid, False, None),
        *((name, Bl, Tl, Tl, Hl, Dl, True, None, True, offs)
          for name, offs in chip_smoke.D32_LSE_OFFSETS)]
    assert chip_ab.D32_FWD_BF16 == want
    assert (B, L, H, D, valid) == (1, 24, 4, 32, [24])
    # the train, ragged, Tq=37 and model shapes are chip_smoke's own
    smoke = {c[0]: c[1:8] for c in chip_smoke.D32_BF16_CASES}
    for c in want:
        if c[0] in smoke:
            assert c[1:8] == smoke[c[0]], c[0]
    assert sum(c[0] in smoke for c in want) == 9
    pairs = 4 * 8 * 4096 * 4097 // 2
    assert 4 * 32 * pairs / 989e12 * 1e3 == pytest.approx(0.03475, rel=1e-3)
    assert pairs / (16 * 132 * 1.98e9) * 1e3 == pytest.approx(0.0642,
                                                              rel=1e-3)
    calls = []

    def case(cs, label, dtype, B, Tq, H, D, valid, lse, gen, Tk=None,
             causal=True, offsets=None):
        assert dtype == torch.bfloat16
        calls.append((label, B, Tq, Tk, H, D, causal, valid, lse, offsets))
        return {"case": label}
    orig = chip_ab._forward_case
    chip_ab._forward_case = case
    try:
        recs = chip_ab._d32_fwd_bf16(SimpleNamespace())
    finally:
        chip_ab._forward_case = orig
    assert calls == want
    assert [r["case"] for r in recs] == [c[0] for c in want]


def test_padded_fwd_turn_takes_both_forwards_beside_their_compiled_widths():
    """`run ROOT LABEL padded_fwd` times the float32 and the bf16 forward
    through `_forward_case`, in this order: B=2 T=200 H=4 causal with a
    ragged key mask, with and without the LSE, at every padded head dim of
    chip_smoke's PADDED_FWD_CASES, at D=48, 80 and 192 and at each
    compiled width (32, 64, 128, 256), head dims ascending; the long
    B=4 T=4096 H=8 with the LSE at D=96 (chip_smoke's) and 128; then
    `flash_attention_lse` in float32 at B=1 T=1024 H=2 on the diagonal,
    past and 0/512 offsets at D=136 and 256; then the bf16 decode route at
    the serving step, slab and paged on blocks of 16, at D=48 and 64
    (`_bf16_decode_case`)."""
    import chip_smoke
    import torch
    dims = (8, 24, 32, 40, 48, 56, 64, 72, 80, 96, 120, 128, 136, 192, 200,
            248, 256)
    want = [*((f"D={d} B=2 T=200 H=4, ragged key mask"
               + (", LSE" if lse else ""), dt, 2, 200, 200, 4, d,
               [200, 137], lse, None)
              for dt in (torch.float32, torch.bfloat16) for d in dims
              for lse in (True, False)),
            *((f"D={d} long B=4 T=4096 H=8, LSE", dt, 4, 4096, 4096, 8, d,
               None, True, None)
              for dt in (torch.float32, torch.bfloat16) for d in (96, 128)),
            *((f"D={d} {name}", torch.float32, 1, 1024, 1024, 2, d, None,
               True, offs) for d in (136, 256)
              for name, offs in (("diagonal", (1024, 1024)),
                                 ("past", (1024, 0)),
                                 ("rows without keys", (0, 512))))]
    # every case of chip_smoke's PADDED_FWD_CASES is among them
    smoke = {(c[0], c[1]): c[2:10] for c in chip_smoke.PADDED_FWD_CASES}
    mine = {(c[0], str(c[1]).replace("torch.", "")):
            (c[2], c[3], c[4], c[5], c[6], c[7], c[8], False)
            for c in want}
    for key, shape in smoke.items():
        assert mine[key][:7] == shape[:7], key
    assert len(smoke) == 42
    calls, decodes = [], []

    def case(cs, label, dtype, B, Tq, H, D, valid, lse, gen, Tk=None,
             causal=True, offsets=None):
        assert causal
        calls.append((label, dtype, B, Tq, Tk or Tq, H, D, valid, lse,
                      offsets))
        return {"case": label}

    def decode(cs, label, S, C, H, D, lengths, bs, gen):
        assert lengths == chip_smoke.STEP_LENGTHS
        decodes.append((label, S, C, H, D, bs))
        return {"case": label}
    orig = chip_ab._forward_case, chip_ab._bf16_decode_case
    chip_ab._forward_case, chip_ab._bf16_decode_case = case, decode
    try:
        recs = chip_ab._padded_fwd(SimpleNamespace())
    finally:
        chip_ab._forward_case, chip_ab._bf16_decode_case = orig
    assert calls == want
    assert decodes == [("step S=8 C=256 D=48", 8, 256, 4, 48, None),
                       ("step S=8 C=256 D=48 bs=16", 8, 256, 4, 48, 16),
                       ("step S=8 C=256 D=64", 8, 256, 4, 64, None),
                       ("step S=8 C=256 D=64 bs=16", 8, 256, 4, 64, 16)]
    assert len(recs) == len(want) + 4


def _bwd_turn_calls(monkeypatch, run_set):
    """The `_bwd_case` calls, `_entry_calls` calls and `_lse_case` calls a
    backward set makes on a stub checkout, and its records."""
    import torch
    cases, entry, lse = [], [], []

    def bwd_case(label, B, Tq, Tk, H, D, causal, valid, gen, repeat=False):
        cases.append((label, B, Tq, Tk, H, D, causal, valid, repeat))
        return [{"name": "flash_bwd_dq", "case": label},
                {"name": "flash_bwd_dkv", "case": label}]

    def entry_calls(cs, dtype, B, Tq, Tk, H, D, causal, valid, gen):
        assert dtype == torch.float32
        entry.append((B, Tq, Tk, H, D, causal, valid))
        return {"flash_bwd_dq": {"kernels_per_call": 1, "peak_mib": 1.0},
                "flash_bwd_dkv": {"kernels_per_call": 1, "peak_mib": 2.0}}

    def lse_case(label, dtype, B, T, H, D, offs, valid, gen):
        assert dtype == torch.float32 and valid is None
        lse.append((label, B, T, H, D, offs))
        return [{"case": label}]
    monkeypatch.setattr(chip_ab, "_entry_calls", entry_calls)
    recs = run_set(SimpleNamespace(_bwd_case=bwd_case, _lse_case=lse_case))
    return cases, entry, lse, recs


def test_d32_bwd_f32_turn_takes_chip_smokes_d32_f32_cases(monkeypatch):
    """`run ROOT LABEL d32_bwd_f32` times the f32 pair through `_bwd_case`
    at chip_smoke's D32_F32_CASES, in order (the train case at D=32 and
    D=16 with H * D = 256, D=24 and 8 ragged, Tq=37 Tk=53, the model's
    shape, the long case, the head-count case), each record with its
    entry's kernels a call and peak MiB (`_entry_calls` at the same
    shape); then `_lse_case` in float32 on D32_LSE under each of
    D32_LSE_OFFSETS."""
    import chip_smoke
    assert chip_ab.D32_BWD_F32 == chip_smoke.D32_F32_CASES
    conf = chip_smoke.BENCH_PAGED_MODEL
    model = [c for c in chip_ab.D32_BWD_F32 if "model" in c[0]]
    assert [c[1:6] for c in model] == [(
        chip_smoke.WIDE_BATCH, chip_smoke.WIDE_SEQ, chip_smoke.WIDE_SEQ,
        conf["n_heads"], conf["d_model"] // conf["n_heads"])]
    train = [c for c in chip_ab.D32_BWD_F32 if "train" in c[0]]
    assert [c[4] * c[5] for c in train] == [256, 256]
    assert [c[5] for c in chip_ab.D32_BWD_F32] == [32, 16, 24, 8, 32, 32, 32,
                                                   32]
    cases, entry, lse, recs = _bwd_turn_calls(monkeypatch,
                                              chip_ab._d32_bwd_f32)
    assert cases == chip_ab.D32_BWD_F32
    assert entry == [c[1:8] for c in chip_ab.D32_BWD_F32]
    Bl, Tl, Hl, Dl = chip_smoke.D32_LSE
    assert lse == [(lab, Bl, Tl, Hl, Dl, offs)
                   for lab, offs in chip_smoke.D32_LSE_OFFSETS]
    assert [r.get("kernels_per_call") for r in recs[:2]] == [1, 1]
    assert [r.get("peak_mib") for r in recs[:2]] == [1.0, 2.0]
    assert len(recs) == 2 * len(cases) + len(lse)


def test_padded_bwd_f32_turn_takes_each_padded_dim_beside_its_width(
        monkeypatch):
    """`run ROOT LABEL padded_bwd_f32` times the f32 pair through
    `_bwd_case` at B=2 T=200 H=4 causal with a ragged key mask at every
    padded head dim of PADDED_BWD_BF16, at D=48, 80 and 192 and at each
    compiled width (32, 64, 128, 256), head dims ascending, then the long
    B=4 T=4096 H=8 at D=96 (bitwise twice more) beside D=128, each with
    `_entry_calls`; then `flash_attention_lse` in float32 at B=1 T=1024
    H=2 on the diagonal, past and 0/512 offsets at D=136 and 256."""
    dims = (8, 24, 32, 40, 48, 56, 64, 72, 80, 96, 120, 128, 136, 192, 200,
            248, 256)
    want = [*((f"D={d} B=2 T=200 H=4, ragged key mask", 2, 200, 200, 4, d,
               True, [200, 137], False) for d in dims),
            ("D=96 long B=4 T=4096 H=8", 4, 4096, 4096, 8, 96, True, None,
             True),
            ("D=128 long B=4 T=4096 H=8", 4, 4096, 4096, 8, 128, True, None,
             False)]
    assert chip_ab.PADDED_BWD_F32 == want
    # every padded head dim of the bf16 set is among them
    bf16 = {c[5] for c in chip_ab.PADDED_BWD_BF16}
    assert bf16 <= {c[5] for c in want}
    cases, entry, lse, recs = _bwd_turn_calls(monkeypatch,
                                              chip_ab._padded_bwd_f32)
    assert cases == want
    assert entry == [c[1:8] for c in want]
    assert lse == [(f"D={d} {name}", 1, 1024, 2, d, offs) for d in (136, 256)
                   for name, offs in (("diagonal", (1024, 1024)),
                                      ("past", (1024, 0)),
                                      ("rows without keys", (0, 512)))]
    assert len(recs) == 2 * len(want) + 6


@pytest.mark.parametrize("dtype", ["wide", "wide_bwd", "wide_bwd_bf16",
                                   "d256", "d256_bwd", "rank", "d128_bwd",
                                   "d32_bwd_bf16", "d32_fwd_bf16",
                                   "padded_bwd_bf16", "padded_fwd",
                                   "d32_bwd_f32", "padded_bwd_f32"])
def test_wide_and_rank_turns_refuse_without_a_card(dtype):
    res = subprocess.run([sys.executable, str(ROOT / "chip_ab.py"), "run",
                          str(ROOT), "change", dtype], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert res.returncode != 0
    assert '{"ab"' not in res.stdout


def test_summary_of_f32_forward_records(tmp_path, capsys):
    """A float32 forward record gets both f32 bounds from its operations
    (4*D per pair) and bytes, and the summary its ratio, rates, shares of
    both bounds and its ratio to SDPA's forward."""
    ops = 4 * 64 * 2_000_000
    cs = SimpleNamespace(PEAK_F32_FLOPS=67e12, PEAK_BF16_FLOPS=989e12)
    bounds = chip_ab._bounds({"name": "flash_fwd", "ops": ops,
                              "bytes_bound_ms": 1e-4}, cs)
    assert bounds["bound_ms"] == pytest.approx(ops / (495e12 / 3) * 1e3)
    assert bounds["simt_bound_ms"] == pytest.approx(ops / 67e12 * 1e3)

    def turn(path, label, dev, lib):
        case = {"name": "flash_fwd", "case": "train B=16 T=512 H=4 D=64",
                "device_ms": dev, "ms": 2 * dev, "max_abs_err": 0.0,
                "library_device_ms": lib, **bounds}
        path.write_text(json.dumps({"ab": label, "cases": [case]}) + "\n")
        return str(path)
    chip_ab.summary([turn(tmp_path / "p1", "parent", 0.16, 0.115),
                     turn(tmp_path / "c1", "change", 0.05, 0.117),
                     turn(tmp_path / "c2", "change", 0.07, 0.113),
                     turn(tmp_path / "p2", "parent", 0.17, 0.115)])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "ab_summary"][0]
    assert row["ratio"] == pytest.approx(0.06 / 0.165)
    assert row["tflops"]["change"] == pytest.approx(ops / 0.06e-3 / 1e12)
    assert row["bound_share"]["change"] == pytest.approx(
        bounds["bound_ms"] / 0.06)
    assert row["simt_bound_share"]["parent"] == pytest.approx(
        bounds["simt_bound_ms"] / 0.165)
    assert row["sdpa_device_ms"] == pytest.approx(0.115)
    assert row["vs_sdpa"] == pytest.approx(0.06 / 0.115)


def test_summary_needs_exactly_two_sides(tmp_path):
    key = ("flash_bwd_dq_bf16", "train")
    logs = [_turn(tmp_path / f"{n}.log", n, {key: 0.05})
            for n in ("a", "b", "c")]
    with pytest.raises(SystemExit):
        chip_ab.summary(logs)


def test_run_refuses_without_a_card():
    res = subprocess.run([sys.executable, str(ROOT / "chip_ab.py"), "run",
                          str(ROOT), "change"], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert res.returncode != 0
    assert '{"ab"' not in res.stdout


@pytest.mark.parametrize("mode,args,line", [
    ("run", ["change", "decode"], '{"ab"'), ("sweep", ["change"], '{"sweep"')])
def test_decode_turn_and_sweep_refuse_without_a_card(mode, args, line):
    res = subprocess.run([sys.executable, str(ROOT / "chip_ab.py"), mode,
                          str(ROOT), *args], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert res.returncode != 0
    assert line not in res.stdout


def test_ungated_turn_refuses_without_a_card_and_records_failed_gates(
        capsys):
    """`run ROOT LABEL SET --no-gates` refuses without a card like every
    turn; its line carries the gates that failed, and a gated turn's line
    has no such key."""
    res = subprocess.run([sys.executable, str(ROOT / "chip_ab.py"), "run",
                          str(ROOT), "change", "d128_bwd", "--no-gates"],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(ROOT))
    assert res.returncode != 0
    assert '{"ab"' not in res.stdout
    rec = {"name": "flash_bwd_dq", "case": "c", "device_ms": 1.0,
           "ms": 2.0, "ops": 6e9, "bytes_bound_ms": 0.001}
    chip_ab._print_turn("x", ROOT, [rec], SimpleNamespace(), ["dq: not "
                                                             "allclose"])
    chip_ab._print_turn("y", ROOT, [rec], SimpleNamespace())
    first, second = (json.loads(line) for line in
                     capsys.readouterr().out.splitlines())
    assert first["gates_failed"] == ["dq: not allclose"]
    assert "gates_failed" not in second


@pytest.mark.parametrize("header", sorted(
    p.name for p in build.CSRC.glob("*.cuh")))
@pytest.mark.parametrize("name", build.SOURCES)
def test_library_name_hashes_the_hopper_header(name, header, tmp_path,
                                               monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build.library_path(name)
    path = csrc / header
    path.write_text(path.read_text() + "\n// edited\n")
    assert build.library_path(name) != before
