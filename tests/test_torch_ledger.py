"""The port's run ledger (``paddle_tpu_torch.obs.ledger``), the 20 cases
of ``tests/test_ledger.py``: row/spec schemas, atomic segment rotation,
torn-tail crash recovery, the exactly-once resume cursor (in-process and
through a kill -> restore drill of ``run_pipeline`` in subprocesses),
drift-rule episodes, the flight recorder's ``ledger_tail`` and the
readers.  Across the packages: a ledger directory either package writes
reads in the other (rows, digests, a resume cursor), and a fetched
tensor (bfloat16 too) gives the row's loss."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import torch

from paddle_tpu.obs import ledger as ref_ledger
from paddle_tpu.profiler import RuntimeMetrics as RefMetrics
from paddle_tpu_torch.obs.ledger import (DriftWatch, EXAMPLE_DRIFT_SPEC,
                                         LEDGER_FORMAT, ROW_FIELDS,
                                         RunLedger, read_rows, summarize,
                                         tail_rows, validate_header,
                                         validate_row, validate_spec)
from paddle_tpu_torch.profiler import RuntimeMetrics


def _mk(tmp_path, **kw):
    kw.setdefault("metrics", RuntimeMetrics())
    kw.setdefault("install", False)
    return RunLedger(str(tmp_path / "ledger"), **kw)


class TestSchemas:
    def test_good_row_is_clean(self):
        assert validate_row({"step": 3, "time_unix": 1.5,
                             "loss": 0.25, "mfu": None}) == []

    def test_row_rejections(self):
        assert validate_row({"time_unix": 1.0})          # no step
        assert validate_row({"step": -1, "time_unix": 1.0})
        assert validate_row({"step": True, "time_unix": 1.0})
        assert validate_row({"step": 1, "time_unix": float("nan")})
        assert validate_row({"step": 1, "time_unix": 1.0,
                             "loss": "0.5"})             # non-number
        assert validate_row({"step": 1, "time_unix": 1.0,
                             "bogus_field": 1.0})        # unknown key

    def test_header_round_trip(self):
        assert validate_header({"ledger_format": LEDGER_FORMAT,
                                "segment": 0, "rows_before": 0}) == []
        assert validate_header({"ledger_format": 99, "segment": 0,
                                "rows_before": 0})
        assert validate_header({"segment": 0, "rows_before": 0})

    def test_example_drift_spec_is_valid(self):
        assert validate_spec(EXAMPLE_DRIFT_SPEC) == []

    def test_drift_spec_rejections(self):
        assert validate_spec({"version": 1, "rules": []})
        assert validate_spec({"version": 2, "rules": [
            {"name": "r", "kind": "ceiling", "field": "loss", "max": 1}]})
        assert validate_spec({"version": 1, "rules": [
            {"name": "r", "kind": "nope", "field": "loss"}]})
        assert validate_spec({"version": 1, "rules": [
            {"name": "r", "kind": "spike", "field": "loss",
             "factor": 0.5}]})  # factor must exceed 1
        assert validate_spec({"version": 1, "rules": [
            {"name": "r", "kind": "ceiling", "field": "loss", "max": 1},
            {"name": "r", "kind": "floor", "field": "loss",
             "min": 0}]})       # duplicate names
        with pytest.raises(ValueError):
            DriftWatch({"version": 1, "rules": []})

    def test_append_sanitizes_non_finite_to_null(self, tmp_path):
        led = _mk(tmp_path, flush_every=1)
        led.append({"step": 0, "time_unix": 1.0,
                    "loss": float("nan"), "grad_norm": float("inf")})
        led.close()
        (row,) = read_rows(led.dirname)
        assert row["loss"] is None and row["grad_norm"] is None

    def test_append_rejects_unknown_fields(self, tmp_path):
        led = _mk(tmp_path)
        with pytest.raises(ValueError):
            led.append({"step": 0, "time_unix": 1.0, "sneaky": 1})
        led.close()


class TestRotationAndRecovery:
    def test_rotation_seals_segments(self, tmp_path):
        led = _mk(tmp_path, rotate_rows=4, flush_every=1)
        for i in range(10):
            led.note_step(loss=float(i))
        led.close()
        names = sorted(os.listdir(led.dirname))
        sealed = [n for n in names if n.endswith(".jsonl")]
        opens = [n for n in names if n.endswith(".open")]
        assert len(sealed) == 2 and len(opens) == 1
        # headers carry the cumulative row offset
        with open(os.path.join(led.dirname, sealed[1])) as f:
            hdr = json.loads(f.readline())
        assert hdr["rows_before"] == 4
        rows = read_rows(led.dirname)
        assert [r["step"] for r in rows] == list(range(10))
        assert led._metrics.counter("ledger.rotations") == 2

    def test_reopen_resumes_numbering(self, tmp_path):
        led = _mk(tmp_path, rotate_rows=4, flush_every=1)
        for i in range(6):
            led.note_step(loss=float(i))
        led.close()
        led2 = _mk(tmp_path, rotate_rows=4, flush_every=1)
        assert led2.rows_total == 6 and led2.last_step == 5
        led2.note_step(loss=9.0)
        led2.close()
        assert [r["step"] for r in read_rows(led2.dirname)] == \
            list(range(7))

    def test_torn_tail_is_truncated_on_reopen(self, tmp_path):
        led = _mk(tmp_path, flush_every=1)
        for i in range(5):
            led.note_step(loss=float(i))
        led.close()
        # simulate a crash mid-write: a torn half-row at the tail
        open_seg = [n for n in os.listdir(led.dirname)
                    if n.endswith(".open")][0]
        with open(os.path.join(led.dirname, open_seg), "ab") as f:
            f.write(b'{"step": 5, "time_un')
        led2 = _mk(tmp_path, flush_every=1)
        assert led2.rows_total == 5
        led2.note_step(loss=5.0)   # appends cleanly after the cut
        led2.close()
        assert [r["step"] for r in read_rows(led2.dirname)] == \
            list(range(6))

    def test_readers(self, tmp_path):
        led = _mk(tmp_path, rotate_rows=3, flush_every=1)
        for i in range(7):
            led.note_step(loss=float(i))
        led.close()
        assert [r["step"] for r in tail_rows(led.dirname, 2)] == [5, 6]
        s = summarize(led.dirname)
        assert s["rows"] == 7 and s["last_step"] == 6
        assert s["fields"]["loss"]["max"] == 6.0
        with pytest.raises(ValueError):
            read_rows(str(tmp_path / "missing"))


class TestResumeCursor:
    def test_rewind_to_cursor_drops_exact_rows(self, tmp_path):
        led = _mk(tmp_path, rotate_rows=3, flush_every=1)
        for i in range(5):
            led.note_step(loss=float(i))
        cursor = led.state_dict()
        assert cursor == {"format": LEDGER_FORMAT, "rows_total": 5,
                          "last_step": 4}
        for i in range(5, 9):
            led.note_step(loss=float(i))
        led.load_state_dict(cursor)          # the restore path
        assert led.rows_total == 5 and led.last_step == 4
        led.note_step(loss=50.0)             # resumes at step 5
        led.close()
        rows = read_rows(led.dirname)
        assert [r["step"] for r in rows] == list(range(6))
        assert rows[-1]["loss"] == 50.0
        assert led._metrics.counter("ledger.rewound_rows") == 4

    def test_rewind_across_sealed_segment_boundary(self, tmp_path):
        led = _mk(tmp_path, rotate_rows=3, flush_every=1)
        for i in range(3):
            led.note_step(loss=float(i))
        cursor = led.state_dict()            # exactly one sealed segment
        for i in range(3, 8):
            led.note_step(loss=float(i))
        led.load_state_dict(cursor)
        led.note_step(loss=3.5)
        led.close()
        rows = read_rows(led.dirname)
        assert [r["step"] for r in rows] == [0, 1, 2, 3]
        assert rows[-1]["loss"] == 3.5

    def test_bad_sidecars_raise(self, tmp_path):
        led = _mk(tmp_path, flush_every=1)
        led.note_step(loss=1.0)
        with pytest.raises(ValueError):
            led.load_state_dict({"format": 99, "rows_total": 1})
        with pytest.raises(ValueError):
            led.load_state_dict({"format": LEDGER_FORMAT,
                                 "rows_total": 5})  # history lost
        with pytest.raises(ValueError):
            led.load_state_dict({"format": LEDGER_FORMAT,
                                 "rows_total": -1})
        led.close()


class TestDrift:
    def _spec(self, sustained=2):
        return {"version": 1, "sustained": sustained, "rules": [
            {"name": "loss-spike", "kind": "spike", "field": "loss",
             "factor": 4.0, "warmup": 3, "ema_beta": 0.5},
            {"name": "grad-explosion", "kind": "ceiling",
             "field": "grad_norm", "max": 100.0}]}

    def test_spike_fires_after_warmup_only(self):
        m = RuntimeMetrics()
        watch = DriftWatch(self._spec(), metrics=m)
        # a huge first value during warmup must NOT breach
        assert watch.evaluate({"step": 0, "loss": 100.0}) == []
        for i in range(1, 4):
            assert watch.evaluate({"step": i, "loss": 1.0}) == []
        got = watch.evaluate({"step": 4, "loss": 1000.0})
        assert got == ["loss-spike"]
        assert m.counter("ledger.drift_breaches") == 1
        # a spike must not drag the EMA up: the next spike still trips
        assert watch.evaluate({"step": 5, "loss": 1000.0}) == \
            ["loss-spike"]

    def test_sustained_breach_posts_one_postmortem_per_episode(
            self, tmp_path, monkeypatch):
        pm_dir = tmp_path / "pm"
        pm_dir.mkdir()
        monkeypatch.setenv("PADDLE_TPU_POSTMORTEM", str(pm_dir))
        m = RuntimeMetrics()
        watch = DriftWatch(self._spec(sustained=2), metrics=m)
        for step in range(4):          # 4 consecutive ceiling breaches
            watch.evaluate({"step": step, "grad_norm": 1e6})
        assert m.counter("ledger.drift_postmortems") == 1
        (pm,) = os.listdir(pm_dir)
        body = json.loads((pm_dir / pm).read_text())
        assert "grad-explosion" in body["reason"]
        assert body["extra"]["breach"]["field"] == "grad_norm"
        # recovery re-arms the episode
        watch.evaluate({"step": 4, "grad_norm": 0.1})
        for step in range(5, 7):
            watch.evaluate({"step": step, "grad_norm": 1e6})
        assert m.counter("ledger.drift_postmortems") == 2

    def test_ledger_evaluates_drift_on_append(self, tmp_path):
        m = RuntimeMetrics()
        led = RunLedger(str(tmp_path / "led"), flush_every=1,
                        drift_spec=self._spec(), metrics=m,
                        install=False)
        led.append({"step": 0, "time_unix": 1.0, "grad_norm": 1e6})
        led.close()
        assert m.counter("ledger.drift_breaches") == 1

    def test_postmortems_embed_ledger_tail(self, tmp_path, monkeypatch):
        from paddle_tpu_torch.obs import flight
        monkeypatch.setenv("PADDLE_TPU_POSTMORTEM",
                           str(tmp_path / "pm.json"))
        led = RunLedger(str(tmp_path / "led"), flush_every=1,
                        metrics=RuntimeMetrics(), install=True)
        for i in range(3):
            led.note_step(loss=float(i))
        path = flight.write_postmortem(reason="test")
        led.close()
        body = json.loads(open(path).read())
        assert [r["step"] for r in body["ledger_tail"]] == [0, 1, 2]


class TestCheckpointSidecar:
    def _model(self):
        import paddle_tpu_torch as pt
        main, startup = pt.Program(), pt.Program()
        main.random_seed = startup.random_seed = 3
        with pt.program_guard(main, startup):
            x = pt.layers.data("x", shape=[3], dtype="float32")
            y = pt.layers.data("y", shape=[1], dtype="float32")
            pred = pt.layers.fc(x, 1)
            loss = pt.layers.reduce_mean(
                pt.layers.square_error_cost(pred, y))
            pt.optimizer.SGD(learning_rate=0.01).minimize(loss)
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup)
        return exe, main, loss

    def _feed(self, i):
        return {"x": np.full((2, 3), i, np.float32),
                "y": np.full((2, 1), float(i), np.float32)}

    def test_restore_rewinds_ledger_with_params(self, tmp_path):
        from paddle_tpu_torch.fault import CheckpointManager
        from paddle_tpu_torch.fault.checkpoint import LEDGER_STATE_NAME
        exe, main, loss = self._model()
        led = _mk(tmp_path, flush_every=1)
        mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=3,
                                executor=exe, main_program=main,
                                ledger=led)
        for step in (1, 2):
            exe.run(main, feed=self._feed(step),
                    fetch_list=[loss.name])
            led.note_step(step=step, loss=float(step))
            mgr.save(step)
        assert os.path.exists(
            os.path.join(mgr.path(2), LEDGER_STATE_NAME))
        # the run continues past the checkpoint, then dies and restores
        for step in (3, 4):
            led.note_step(step=step, loss=float(step))
        assert mgr.restore_latest() == 2
        assert led.rows_total == 2 and led.last_step == 2
        led.note_step(step=3, loss=30.0)
        led.close()
        rows = read_rows(led.dirname)
        assert [r["step"] for r in rows] == [1, 2, 3]
        assert rows[-1]["loss"] == 30.0


# ---------------------------------------------------------------------------
# kill -> restore drill: the ledger must resume its append with no
# duplicated and no missing step rows
# ---------------------------------------------------------------------------

LEDGER_TRAINER = r'''
"""run_pipeline trainer for the ledger kill-and-resume drill: every
applied batch appends one ledger row BEFORE the checkpoint commits, so
a restore rewinds the ledger to exactly the committed step."""
import argparse

import numpy as np

import paddle_tpu_torch as fluid
import paddle_tpu_torch.datapipe as dp
from paddle_tpu_torch import layers
from paddle_tpu_torch.fault import CheckpointManager
from paddle_tpu_torch.obs.ledger import RunLedger

ap = argparse.ArgumentParser()
ap.add_argument("--ckpt", required=True)
ap.add_argument("--ledger", required=True)
ap.add_argument("--steps", type=int, required=True)
args = ap.parse_args()

main, startup = fluid.Program(), fluid.Program()
main.random_seed = startup.random_seed = 11
with fluid.program_guard(main, startup):
    x = layers.data("x", shape=[4], dtype="float32")
    y = layers.data("y", shape=[1], dtype="float32")
    pred = layers.fc(x, 1, param_attr="w", bias_attr="b")
    loss = layers.reduce_mean(layers.square_error_cost(pred, y))
    fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)

exe = fluid.Executor(fluid.CPUPlace())
exe.run(startup)

samples = [{"x": np.full((4,), i, np.float32),
            "y": np.array([float(i)], np.float32)} for i in range(64)]
pipe = dp.InMemorySource(samples).batch(4, drop_last=True)
ledger = RunLedger(args.ledger, rotate_rows=3, flush_every=1)
mgr = CheckpointManager(args.ckpt, keep=3, executor=exe,
                        main_program=main, datapipe=pipe,
                        ledger=ledger)
start = mgr.restore_latest() or 0

done = start
def on_step(step, fetches):
    global done
    done += 1
    mgr.save(done)

exe.run_pipeline(main, pipe, fetch_list=[loss],
                 max_steps=args.steps - start, on_step=on_step,
                 ledger=ledger)
ledger.close()
'''


@pytest.mark.chaos
class TestKillAndResumeLedger:
    def _run(self, trainer, ckpt, led, steps, chaos_spec=None,
             expect_rc=0):
        repo_root = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))
        env = dict(os.environ)
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get(
            "PYTHONPATH", "")
        env.pop("PADDLE_TPU_CHAOS", None)
        if chaos_spec:
            env["PADDLE_TPU_CHAOS"] = chaos_spec
        r = subprocess.run(
            [sys.executable, str(trainer), "--ckpt", str(ckpt),
             "--ledger", str(led), "--steps", str(steps)],
            cwd=repo_root, env=env, capture_output=True, text=True,
            timeout=300)
        assert r.returncode == expect_rc, (r.returncode, r.stderr[-2000:])
        return r

    def test_killed_run_resumes_without_dup_or_gap(self, tmp_path):
        from paddle_tpu_torch.fault import chaos
        trainer = tmp_path / "trainer.py"
        trainer.write_text(LEDGER_TRAINER)
        steps = 10
        ckpt, led = tmp_path / "ckpt", tmp_path / "ledger"

        # hard-killed mid-run: 5 steps committed with their ledger
        # sidecars, the kill lands before batch 6 applies
        self._run(trainer, ckpt, led, steps,
                  chaos_spec="train.step=kill@5",
                  expect_rc=chaos.KILL_EXIT_CODE)
        # resume: restore_latest rewinds the ledger to the committed
        # cursor, then the loop appends the remaining steps
        self._run(trainer, ckpt, led, steps)
        rows = read_rows(str(led))
        got = [r["step"] for r in rows]
        assert got == sorted(set(got)), f"duplicated rows: {got}"
        assert got == list(range(steps)), got
        assert all(r["loss"] is not None for r in rows)


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def _write(mod, metrics, dirname, steps, rotate_rows=3):
    led = mod.RunLedger(str(dirname), rotate_rows=rotate_rows,
                        flush_every=1, metrics=metrics, install=False)
    for i in range(steps):
        led.note_step(loss=float(i) / 2, stall_seconds=0.001 * i)
    cursor = led.state_dict()
    led.close()
    return cursor


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ledger_directory_reads_in_the_other_package(tmp_path, writer):
    import paddle_tpu_torch.obs.ledger as port_ledger
    mods = {"port": (port_ledger, RuntimeMetrics),
            "jax": (ref_ledger, RefMetrics)}
    wmod, wmet = mods[writer]
    rmod, rmet = mods["jax" if writer == "port" else "port"]
    d = tmp_path / "ledger"
    cursor = _write(wmod, wmet(), d, 7)
    rows = rmod.read_rows(str(d))
    assert rows == wmod.read_rows(str(d))
    assert [r["step"] for r in rows] == list(range(7))
    assert rmod.summarize(str(d)) == wmod.summarize(str(d))
    assert rmod.tail_rows(str(d), 2) == rows[-2:]
    # the other package reopens it, rewinds to the writer's cursor and
    # appends: one series
    led = rmod.RunLedger(str(d), rotate_rows=3, flush_every=1,
                         metrics=rmet(), install=False)
    assert (led.rows_total, led.last_step) == (7, 6)
    led.note_step(loss=99.0)
    led.load_state_dict(cursor)
    led.note_step(loss=7.5)
    led.close()
    rows = wmod.read_rows(str(d))
    assert [r["step"] for r in rows] == list(range(8))
    assert rows[-1]["loss"] == 7.5


def test_note_step_reads_a_fetched_tensor(tmp_path):
    led = _mk(tmp_path, flush_every=1)
    led.note_step(fetch_names=["loss", "acc"],
                  fetches=[torch.tensor(0.75, dtype=torch.bfloat16),
                           torch.tensor(1.0)])
    led.note_step(fetch_names=["ids", "loss"],
                  fetches=[torch.arange(3), torch.tensor([2.5])])
    led.note_step(fetch_names=["loss"],
                  fetches=[torch.tensor(float("nan"))])
    led.close()
    assert [r["loss"] for r in read_rows(led.dirname)] == [0.75, 2.5, None]
