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


def test_rank_turn_takes_each_kernel_not_yet_redesigned_once():
    """`run ROOT LABEL rank` times the f32 forward at D=256, the f32 pair
    at D=16, 32, 128 and 256 and the bf16 kernels at D=16 and 32 at the
    train case with H * D = 256, and the wide pair at the long D=512
    case."""
    assert chip_ab.RANK == [("fwd", 256), ("bwd", 16), ("bwd", 32),
                            ("bwd", 128), ("bwd", 256), ("bf16", 16),
                            ("bf16", 32)]
    assert all(256 % D == 0 for _, D in chip_ab.RANK)
    assert chip_ab.RANK_WIDE == ("B=2 T=4096 H=4 D=512", 2, 4096, 4, 512)


@pytest.mark.parametrize("dtype", ["wide", "rank"])
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
