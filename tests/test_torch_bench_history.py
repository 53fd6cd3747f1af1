"""The port's bench trajectory (``paddle_tpu_torch.obs.bench_history``):
the schema, ``record`` / ``check`` under the tolerance bands (the cases
of ``tests/test_obs_fleet.py::TestBenchTrajectory`` and the basis rows
of ``tests/test_perf.py``), the refusal of a ``tpu-peak`` run (the
port's ``MFU_BASES`` are ``gpu-peak`` and ``cpu-fallback``), and a
``default_path()`` that is the port's own file, never the JAX package's
``BENCH_TRAJECTORY.json``.  Every trajectory here is written under
``tmp_path``."""

import json
import os

import pytest

from paddle_tpu.obs import bench_history as ref_history
from paddle_tpu_torch import cli
from paddle_tpu_torch.obs import bench_history
from paddle_tpu_torch.obs.ledger import LEDGER_FORMAT
from paddle_tpu_torch.obs.perf import MFU_BASES

DECODE = {"tokens_per_sec": 200.0, "tokens_per_sec_ratio": 2.5,
          "ttft_p99_ms": 250.0, "lost_requests": 0}


def test_record_check_roundtrip_and_degradation(tmp_path):
    path = str(tmp_path / "traj.json")
    bench_history.record("decode", DECODE, path=path, baseline=True)
    bench_history.record("decode", dict(DECODE), path=path)
    report = bench_history.check(path)
    assert report["ok"], report
    assert report["benches"]["decode"]["comparisons"]
    # a degraded newest run regresses past the band: check fails
    bench_history.record("decode", dict(DECODE, tokens_per_sec=50.0),
                         path=path)
    report = bench_history.check(path)
    assert not report["ok"]
    (reg,) = report["benches"]["decode"]["regressions"]
    assert reg["metric"] == "tokens_per_sec"
    assert reg["bound"] == pytest.approx(200.0 * (1 - 0.30))
    # --dry ignores the regression but still gates the schema
    assert bench_history.check(path, dry=True)["ok"]


def test_bands_by_direction():
    judge = bench_history._judge
    assert judge("higher", 0.30, 100.0, 70.0) == (True, 70.0)
    assert not judge("higher", 0.30, 100.0, 69.9)[0]
    assert judge("lower", 0.75, 100.0, 175.0) == (True, 175.0)
    assert not judge("lower", 0.75, 100.0, 175.1)[0]
    assert judge("max_abs", 0.0, 0.0, 0.0) == (True, 0.0)
    assert not judge("max_abs", 0.0, 0.0, 1.0)[0]
    # a negative baseline loosens, never tightens
    assert judge("higher", 0.35, -2.0, -2.0)[0]


def test_baseline_flag_wins_over_first_run(tmp_path):
    path = str(tmp_path / "traj.json")
    bench_history.record("decode", {"tokens_per_sec": 500.0}, path=path)
    bench_history.record("decode", {"tokens_per_sec": 200.0}, path=path,
                         baseline=True)
    bench_history.record("decode", {"tokens_per_sec": 190.0}, path=path)
    # vs the FLAGGED baseline (200) this passes; vs the first run (500)
    # it would have failed
    assert bench_history.check(path)["ok"]


def test_schema_gate_catches_malformation(tmp_path):
    path = tmp_path / "traj.json"
    path.write_text(json.dumps(
        {"format": 1, "runs": [{"bench": "decode",
                                "time_unix": "yesterday",
                                "metrics": {"x": "fast"}}]}))
    report = bench_history.check(str(path))
    assert not report["ok"]
    text = "\n".join(report["problems"])
    assert "time_unix" in text and "'x'" in text
    path.write_text("[1, 2]")
    assert not bench_history.check(str(path), dry=True)["ok"]
    # a ledger pointer of an unreadable ledger format is refused
    run = {"bench": "decode", "time_unix": 1.0, "metrics": {"a": 1.0},
           "ledger": {"path": "runs/x", "format": LEDGER_FORMAT + 1}}
    assert any("ledger.format" in p for p in
               bench_history.validate_trajectory({"format": 1,
                                                  "runs": [run]}))


def test_tpu_peak_runs_are_refused(tmp_path):
    assert MFU_BASES == ("gpu-peak", "cpu-fallback")
    path = str(tmp_path / "traj.json")
    with pytest.raises(ValueError, match="mfu_basis"):
        bench_history.record("train_transformer", {"mfu": 0.4}, path=path,
                             mfu_basis="tpu-peak")
    assert not os.path.exists(path)
    # a trajectory holding one (the JAX package records such runs) fails
    # the port's schema
    ref_history.record("train_transformer", {"mfu": 0.4}, path=path,
                       mfu_basis="tpu-peak")
    report = bench_history.check(path)
    assert not report["ok"]
    assert any("mfu_basis" in p for p in report["problems"])


def test_refuses_cross_basis_comparison(tmp_path):
    path = str(tmp_path / "traj.json")
    bench_history.record("train_transformer", {"mfu": 0.40}, path=path,
                         baseline=True, mfu_basis="gpu-peak")
    bench_history.record("train_transformer", {"mfu": 0.41}, path=path,
                         mfu_basis="cpu-fallback")
    report = bench_history.check(path)
    assert not report["ok"]
    b = report["benches"]["train_transformer"]
    assert b["basis_mismatch"] == {"baseline": "gpu-peak",
                                   "newest": "cpu-fallback"}
    # same basis: judged under the bands
    bench_history.record("train_transformer", {"mfu": 0.39}, path=path,
                         mfu_basis="gpu-peak")
    assert bench_history.check(path)["ok"]


def test_default_path_is_the_ports_own_file():
    path = bench_history.default_path()
    assert os.path.basename(path) == "BENCH_TRAJECTORY_TORCH.json"
    assert path != ref_history.default_path()
    assert os.path.dirname(path) == os.path.dirname(
        ref_history.default_path())


def test_missing_trajectory_cannot_be_read(tmp_path):
    path = str(tmp_path / "none.json")
    report = bench_history.check(path)
    assert not report["ok"]
    assert "cannot read trajectory" in report["problems"][0]
    assert cli.main(["bench", "check", "--trajectory", path]) == 1


def test_summary_extraction_and_the_recording_flags(tmp_path):
    """``record_from_args`` (the bench scripts' shared tail): no-op
    without ``--record-trajectory``; else the bench's headline metrics,
    extracted from its summary, appended."""
    import argparse
    parser = argparse.ArgumentParser()
    bench_history.add_record_args(parser)
    summary = {"datapipe": {"samples_per_sec": 1234.5}, "speedup": 2.5}
    args = parser.parse_args([])
    assert bench_history.record_from_args("datapipe", summary, args,
                                          source="x") is None
    path = str(tmp_path / "t.json")
    args = parser.parse_args(["--record-trajectory", path,
                              "--record-baseline"])
    entry = bench_history.record_from_args("datapipe", summary, args,
                                           source="summary.json",
                                           mfu_basis="gpu-peak")
    assert entry["metrics"] == {"samples_per_sec": 1234.5, "speedup": 2.5}
    assert entry["baseline"] is True
    assert bench_history.load_trajectory(path)["runs"] == [entry]
    with pytest.raises(ValueError, match="no trajectory extraction"):
        bench_history.summary_metrics("nope", {})


def test_trajectory_format_is_the_reference_format(tmp_path):
    """A trajectory either package records (on a shared basis) checks
    the same in the other."""
    path = str(tmp_path / "traj.json")
    ref_history.record("decode", DECODE, path=path, baseline=True)
    bench_history.record("decode", dict(DECODE, tokens_per_sec=120.0),
                         path=path)
    got, want = bench_history.check(path), ref_history.check(path)
    assert got["ok"] is want["ok"] is False
    assert got["benches"] == want["benches"]
