"""The port's A/B driver (chip_ab.py) and the kernel builder's cache key.

chip_ab.py runs only on a card (each turn builds and times one checkout's
kernels); here its summary is checked on synthetic turns, and `run` must
refuse without a card. The builder names each library by a hash of its
source and every shared header, so an edit of the Hopper header
(csrc/hopper_bf16.cuh) must rebuild every library.
"""
import json
import shutil
import subprocess
import sys
from pathlib import Path

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
    """TFLOP/s and share of the bound from each side's mean device time
    (operations at 989 TFLOP/s), SDPA's mean device time over the turns
    that timed it, and each side's mean wall time around the wrapper."""
    def turn(name, label, dev, wall, lib):
        case = {"name": "flash_fwd_bf16", "case": "train", "device_ms": dev,
                "ms": wall, "bound_ms": 0.005, "ops_bound_ms": 0.002,
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
    assert row["sdpa_device_ms"] == pytest.approx(0.015)
    assert row["vs_sdpa"] == pytest.approx(0.010 / 0.015)
    assert row["kernel_ms"] == pytest.approx({"parent": 0.10,
                                              "change": 0.13})


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


@pytest.mark.parametrize("name", build.SOURCES)
def test_library_name_hashes_the_hopper_header(name, tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build.library_path(name)
    header = csrc / "hopper_bf16.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert build.library_path(name) != before
