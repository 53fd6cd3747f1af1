"""The port's input pipeline (``paddle_tpu_torch.datapipe``) and
``Executor.run_pipeline`` against the JAX package's.

- The 28 cases of ``tests/test_datapipe.py`` on the port: sources and
  sharding, the stages, prefetch (onto the CPU here: ``device="cpu"``),
  mid-epoch state, metrics and failpoints, ``run_pipeline``, the
  checkpoint sidecar and the kill -> resume drill in subprocesses.
- The ``run_pipeline`` cases of ``tests/test_sentinel.py`` (the ladder
  drill, restart renumbering, no manager) and the crash-during-rollback
  drill of ``tests/test_fault_injection.py``.
- Across the packages: one seeded pipeline yields identical batches; a
  mid-epoch ``state_dict`` either package writes continues identically
  in the other; ``run_pipeline`` on a 2 + 2 layer, d_model 64
  Transformer from one transplanted state gives the JAX package's
  losses to ``LOSS_RTOL`` (float32 sums in other orders).
- ``DevicePrefetch`` without CUDA raises unless given the CPU.

The card's cases (stream ordering under a delayed copy,
``record_stream``, the census) are in ``tests/test_torch_cuda.py``."""

import json
import os
import pickle
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu.datapipe as rdp
import paddle_tpu_torch as pt
import paddle_tpu_torch.datapipe as dp
from paddle_tpu.fault import CheckpointManager as RefManager
from paddle_tpu.fault import Sentinel as RefSentinel
from paddle_tpu.fault import chaos as ref_chaos
from paddle_tpu.framework import unique_name_scope as jax_names
from paddle_tpu.models import transformer as JT
from paddle_tpu_torch import profiler
from paddle_tpu_torch.convert import persistable_names, scope_from_numpy
from paddle_tpu_torch.fault import (CheckpointManager, NumericalFault,
                                    Sentinel, chaos)
from paddle_tpu_torch.framework import unique_name_scope as torch_names
from paddle_tpu_torch.models import transformer as TT

LOSS_RTOL = 1e-5
CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_failpoints():
    chaos.clear()
    ref_chaos.clear()
    yield
    chaos.clear()
    ref_chaos.clear()


def id_samples(n):
    return [{"x": np.full((3,), i, np.float32),
             "y": np.array([i], np.int64)} for i in range(n)]


def ids_of(batches):
    return [np.asarray(b["y"])[:, 0].tolist() for b in batches]


def flat_ids(batches):
    return [i for b in ids_of(batches) for i in b]


def _double(s):
    return {"x": s["x"] * 2, "y": s["y"]}


def std_pipe(samples, workers=2, seed=3, pkg=dp):
    pipe = (pkg.InMemorySource(samples)
            .shuffle(8, seed=seed)
            .map(_double, workers=workers)
            .batch(4, drop_last=True))
    return pipe.prefetch(depth=2, device=CPU) if pkg is dp \
        else pipe.prefetch(depth=2)


def _host(batch):
    return {k: np.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the cases of tests/test_datapipe.py, on the port
# ---------------------------------------------------------------------------

class TestSources:
    def test_in_memory_epochs_and_len(self):
        src = dp.InMemorySource(list(range(7)))
        assert len(src) == 7
        assert list(src) == list(range(7))
        assert src.epoch == 1
        assert list(src) == list(range(7))  # next epoch, same stream
        assert src.epoch == 2

    def test_sharding_partitions_disjoint_and_complete(self):
        data = list(range(23))
        shards = [list(dp.InMemorySource(data, num_shards=4, shard_index=i))
                  for i in range(4)]
        assert sorted(x for s in shards for x in s) == data
        assert all(len(set(s)) == len(s) for s in shards)
        with pytest.raises(ValueError):
            dp.InMemorySource(data, num_shards=2, shard_index=2)

    def test_file_source_lines_and_parse(self, tmp_path):
        (tmp_path / "a.txt").write_text("1\n2\n")
        (tmp_path / "b.txt").write_text("3\n")
        src = dp.FileSource(str(tmp_path / "*.txt"), parse=int)
        assert list(src) == [1, 2, 3]
        with pytest.raises(FileNotFoundError):
            list(dp.FileSource(str(tmp_path / "*.nope")))

    def test_recordio_source_roundtrip(self, tmp_path):
        from paddle_tpu_torch.recordio_writer import (
            convert_reader_to_recordio_file)
        path = str(tmp_path / "data.recordio")
        n = convert_reader_to_recordio_file(
            path, lambda: iter(range(10)))
        assert n == 10
        src = dp.RecordIOSource(path)
        assert list(src) == list(range(10))
        # sharded over records
        got = [list(dp.RecordIOSource(path, num_shards=2, shard_index=i))
               for i in range(2)]
        assert sorted(got[0] + got[1]) == list(range(10))
        # a file the JAX package wrote reads the same
        from paddle_tpu.recordio_writer import \
            convert_reader_to_recordio_file as ref_convert
        ref_path = str(tmp_path / "ref.recordio")
        ref_convert(ref_path, lambda: iter(range(10)))
        assert list(dp.RecordIOSource(ref_path)) == list(range(10))

    def test_source_resume_skips_to_offset(self):
        src = dp.InMemorySource(list(range(10)))
        it = iter(src)
        assert [next(it) for _ in range(4)] == [0, 1, 2, 3]
        it.close()
        state = src.state_dict()
        fresh = dp.InMemorySource(list(range(10)))
        fresh.load_state_dict(state)
        assert list(fresh) == [4, 5, 6, 7, 8, 9]


class TestStages:
    def test_shuffle_multiset_and_seed_determinism(self):
        data = list(range(40))
        a = list(dp.InMemorySource(data).shuffle(8, seed=5))
        b = list(dp.InMemorySource(data).shuffle(8, seed=5))
        c = list(dp.InMemorySource(data).shuffle(8, seed=6))
        assert sorted(a) == data and a == b
        assert a != c  # different seed, different permutation
        assert a != data  # it actually shuffles

    def test_shuffle_epochs_differ_but_replay_identically(self):
        pipe = dp.InMemorySource(list(range(20))).shuffle(4, seed=1)
        e0, e1 = list(pipe), list(pipe)
        assert sorted(e0) == sorted(e1) and e0 != e1
        again = dp.InMemorySource(list(range(20))).shuffle(4, seed=1)
        assert [list(again), list(again)] == [e0, e1]

    def test_parallel_map_ordered_and_exceptions(self):
        out = list(dp.InMemorySource(list(range(50)))
                   .map(lambda x: x * 2, workers=3))
        assert out == [2 * i for i in range(50)]

        def boom(x):
            if x == 7:
                raise ValueError("boom")
            return x

        with pytest.raises(ValueError, match="boom"):
            list(dp.InMemorySource(list(range(20))).map(boom, workers=3))

    def test_map_workers_zero_is_synchronous(self):
        out = list(dp.InMemorySource(list(range(10))).map(lambda x: -x))
        assert out == [-i for i in range(10)]

    def test_batch_collate_and_partial(self):
        pipe = dp.InMemorySource(id_samples(10)).batch(4)
        batches = list(pipe)
        assert [b["x"].shape[0] for b in batches] == [4, 4, 2]
        assert flat_ids(batches) == list(range(10))
        pipe = dp.InMemorySource(id_samples(10)).batch(4, drop_last=True)
        assert [b["x"].shape[0] for b in pipe] == [4, 4]

    def test_batch_pad_to_bucket_stabilizes_tail_shape(self):
        pipe = dp.InMemorySource(id_samples(9)).batch(8,
                                                      pad_to_bucket=True)
        batches = list(pipe)
        # 9 = 8 + 1; the tail batch of 1 pads up to the bucket (8): one
        # stable tail signature for the step cache
        assert [b["x"].shape[0] for b in batches] == [8, 8]
        assert batches[1]["y"][1:, 0].tolist() == [0] * 7  # zero pad

    def test_tuple_samples_collate(self):
        data = [(np.float32(i), np.array([i], np.int64)) for i in range(6)]
        batches = list(dp.InMemorySource(data).batch(3))
        assert isinstance(batches[0], tuple)
        assert batches[0][0].shape == (3,)


class TestPrefetch:
    def test_prefetch_yields_device_arrays_in_order(self):
        pipe = dp.InMemorySource(id_samples(12)).batch(4) \
            .prefetch(depth=2, device=CPU)
        batches = list(pipe)
        assert flat_ids(batches) == list(range(12))
        assert isinstance(batches[0]["x"], torch.Tensor)
        assert batches[0]["x"].device.type == "cpu"

    def test_prefetch_overlaps_producer(self):
        # producer latency is hidden behind consumer latency: with a
        # depth-2 queue, total time approaches max(sum(p), sum(c))
        # rather than sum(p) + sum(c)
        def slow(s):
            time.sleep(0.01)
            return s
        pipe = (dp.InMemorySource(id_samples(16))
                .map(slow, workers=1).batch(4).prefetch(depth=2,
                                                        device=CPU))
        t0 = time.perf_counter()
        for _ in pipe:
            time.sleep(0.01)  # consumer-side "compute"
        elapsed = time.perf_counter() - t0
        assert elapsed < 0.33, elapsed  # serial would be ~0.2+0.04+eps

    def test_restored_pending_batches_are_device_placed(self):
        pipe = dp.InMemorySource(id_samples(12)).batch(4) \
            .prefetch(depth=2, device=CPU)
        it = iter(pipe)
        next(it)
        it.close()                       # leaves batches queued/pending
        state = pickle.dumps(pipe.state_dict())
        fresh = dp.InMemorySource(id_samples(12)).batch(4) \
            .prefetch(depth=2, device=CPU)
        fresh.load_state_dict(pickle.loads(state))
        batches = list(fresh)
        # the first post-restore batch comes from the restored pending
        # buffer (host numpy in the pickle): the stage places it again
        assert batches and all(isinstance(b["x"], torch.Tensor)
                               for b in batches)

    def test_abandoned_iterator_stops_threads_and_keeps_position(self):
        base = threading.active_count()
        pipe = std_pipe(id_samples(40))
        it = iter(pipe)
        first = next(it)
        it.close()
        deadline = time.time() + 5
        while threading.active_count() > base and time.time() < deadline:
            time.sleep(0.01)
        assert threading.active_count() <= base
        # the abandoned position is kept: continuing yields the rest
        rest = list(pipe)
        ref = list(std_pipe(id_samples(40)))
        assert ids_of([first]) + ids_of(rest) == ids_of(ref)


class TestStateDict:
    def test_mid_epoch_resume_exact_sequence(self):
        ref = list(std_pipe(id_samples(37)))
        pipe = std_pipe(id_samples(37))
        it = iter(pipe)
        first = [next(it) for _ in range(3)]
        it.close()
        blob = pickle.dumps(pipe.state_dict())
        fresh = std_pipe(id_samples(37))
        fresh.load_state_dict(pickle.loads(blob))
        rest = list(fresh)
        assert ids_of(first) + ids_of(rest) == ids_of(ref)

    def test_resume_across_epoch_boundary(self):
        pipe = std_pipe(id_samples(16))
        e0 = list(pipe)  # full epoch consumed; next iter = epoch 1
        state = pickle.dumps(pipe.state_dict())
        e1 = list(pipe)
        fresh = std_pipe(id_samples(16))
        fresh.load_state_dict(pickle.loads(state))
        assert ids_of(list(fresh)) == ids_of(e1)
        assert ids_of(e0) != ids_of(e1)

    def test_shape_mismatch_rejected(self):
        pipe = dp.InMemorySource(list(range(4))).batch(2)
        other = dp.InMemorySource(list(range(4))).shuffle(2)
        with pytest.raises(dp.PipelineStateError):
            other.load_state_dict(pipe.state_dict())

    def test_reset_rewinds_to_epoch_zero(self):
        pipe = std_pipe(id_samples(16))
        e0 = ids_of(list(pipe))
        _ = list(pipe)
        pipe.reset()
        assert ids_of(list(pipe)) == e0

    def test_per_step_state_dict_does_not_replay_source(self):
        """A checkpoint per step quiesces the chain; the source's live
        stream must survive that, not rebuild and re-skip O(offset)
        samples every step."""
        reads = [0]

        class CountingSource(dp.Source):
            def _stream(self, epoch):
                for i in range(60):
                    reads[0] += 1
                    yield i

        pipe = (CountingSource().map(lambda x: x, workers=2)
                .batch(10, drop_last=True))
        it = iter(pipe)
        seen = []
        for _ in range(5):
            seen.append(next(it))
            pipe.state_dict()       # per-step checkpoint pattern
        it.close()
        assert [b.tolist() for b in seen] == \
            [list(range(i * 10, i * 10 + 10)) for i in range(5)]
        # 50 delivered + the bounded map window of lookahead
        assert reads[0] <= 60, reads[0]


class TestMetricsAndChaos:
    def test_stage_metrics_reported(self):
        profiler.runtime_metrics.reset()
        list(std_pipe(id_samples(24)))
        snap = profiler.runtime_metrics.snapshot()
        assert snap["counters"]["datapipe.source.items"] == 24
        assert snap["counters"]["datapipe.batch.items"] == 6
        assert "datapipe.prefetch.stall_seconds" in snap["series"]
        assert any(k.startswith("datapipe.") for k in snap["gauges"])
        picked = dp.stats()
        assert "counters" in picked and all(
            k.startswith("datapipe.") for k in picked["counters"])

    def test_source_failpoint_propagates(self):
        chaos.inject("datapipe.source", after=5)
        src = dp.InMemorySource(list(range(10)))
        it = iter(src)
        got = [next(it) for _ in range(5)]
        with pytest.raises(chaos.FaultInjected):
            next(it)
        assert got == list(range(5))

    def test_source_failpoint_through_threaded_stages(self):
        chaos.inject("datapipe.source", after=6)
        pipe = std_pipe(id_samples(30))
        with pytest.raises(chaos.FaultInjected):
            list(pipe)


def _port_trainer(seed=None):
    main, startup = pt.Program(), pt.Program()
    if seed is not None:
        main.random_seed = startup.random_seed = seed
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", shape=[3], dtype="float32")
        y = pt.layers.data("y", shape=[1], dtype="float32")
        pred = pt.layers.fc(x, 1)
        loss = pt.layers.reduce_mean(pt.layers.square_error_cost(pred, y))
        pt.optimizer.SGD(learning_rate=0.01).minimize(loss)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    return exe, scope, main, loss


def _xy_samples(n):
    return [{"x": np.full((3,), i, np.float32),
             "y": np.array([float(i)], np.float32)} for i in range(n)]


class TestRunPipeline:
    def test_datapipe_pipeline_and_max_steps(self):
        exe, scope, main, loss = _port_trainer()
        pipe = dp.InMemorySource(_xy_samples(12)).batch(4) \
            .prefetch(device=CPU)
        outs = exe.run_pipeline(main, pipe, fetch_list=[loss.name],
                                scope=scope, max_steps=2)
        assert len(outs) == 2
        # the unconsumed batch stays in the pipeline, not dropped
        assert sum(1 for _ in pipe) == 1

    def test_plain_iterable_of_feed_dicts(self):
        exe, scope, main, loss = _port_trainer()
        batches = [{"x": np.ones((4, 3), np.float32),
                    "y": np.zeros((4, 1), np.float32)}] * 3
        outs = exe.run_pipeline(main, batches, fetch_list=[loss.name],
                                scope=scope)
        assert len(outs) == 3


class TestCheckpointManagerIntegration:
    def test_save_restore_roundtrip_with_datapipe(self, tmp_path):
        from paddle_tpu_torch.fault.checkpoint import DATAPIPE_STATE_NAME
        exe, scope, main, loss = _port_trainer(seed=7)
        samples = _xy_samples(24)

        def build():
            return (dp.InMemorySource(samples).shuffle(6, seed=1)
                    .batch(4).prefetch(depth=2, device=CPU))

        pipe = build()
        mgr = CheckpointManager(str(tmp_path), keep=3, executor=exe,
                                main_program=main, scope=scope,
                                datapipe=pipe)
        it = iter(pipe)
        consumed = []
        for step in (1, 2):
            b = next(it)
            consumed.append(b)
            exe.run(main, feed=b, fetch_list=[loss.name], scope=scope)
            mgr.save(step)
        it.close()
        assert os.path.exists(
            os.path.join(mgr.path(2), DATAPIPE_STATE_NAME))

        pipe2 = build()
        mgr2 = CheckpointManager(str(tmp_path), keep=3, executor=exe,
                                 main_program=main, scope=pt.Scope(),
                                 datapipe=pipe2)
        assert mgr2.restore_latest() == 2
        rest = list(pipe2)
        ref = list(build())
        assert ids_of(consumed) + ids_of(rest) == ids_of(ref)


DATAPIPE_TRAINER = r'''
"""Deterministic datapipe trainer of the port for the kill-and-resume
drill: a shuffled, mapped, batched, prefetched pipeline checkpointed
through CheckpointManager every step; every consumed batch's sample ids
are appended to --log AFTER the step runs."""
import argparse
import json

import numpy as np

import paddle_tpu_torch as pt
import paddle_tpu_torch.datapipe as dp
from paddle_tpu_torch.fault import CheckpointManager, chaos

ap = argparse.ArgumentParser()
ap.add_argument("--ckpt", required=True)
ap.add_argument("--log", required=True)
ap.add_argument("--steps", type=int, required=True)
args = ap.parse_args()

main, startup = pt.Program(), pt.Program()
main.random_seed = startup.random_seed = 11
with pt.program_guard(main, startup):
    x = pt.layers.data("x", shape=[4], dtype="float32")
    y = pt.layers.data("y", shape=[1], dtype="float32")
    pred = pt.layers.fc(x, 1, param_attr="w", bias_attr="b")
    loss = pt.layers.reduce_mean(pt.layers.square_error_cost(pred, y))
    pt.optimizer.SGD(learning_rate=0.05).minimize(loss)

exe = pt.Executor(pt.CPUPlace())
exe.run(startup)

samples = [{"x": np.full((4,), i, np.float32),
            "y": np.array([float(i)], np.float32),
            "sid": np.array([i], np.int64)} for i in range(64)]
pipe = (dp.InMemorySource(samples)
        .shuffle(16, seed=3)
        .map(lambda s: dict(s, x=s["x"] * 0.1), workers=2)
        .batch(4, drop_last=True)
        .prefetch(depth=2, device="cpu"))
mgr = CheckpointManager(args.ckpt, keep=3, executor=exe,
                        main_program=main, datapipe=pipe)
start = mgr.restore_latest() or 0

step = start
logf = open(args.log, "a")
it = iter(pipe)
while step < args.steps:
    batch = next(it)
    step += 1
    chaos.fire("train.step", step=step)
    sids = np.asarray(batch.pop("sid"))[:, 0].tolist()
    exe.run(main, feed=batch, fetch_list=[loss.name])
    logf.write(json.dumps({"step": step, "ids": sids}) + "\n")
    logf.flush()
    mgr.save(step)
it.close()
'''


def _subprocess(script, args, chaos_spec=None, expect_rc=0):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("PADDLE_TPU_CHAOS", None)
    if chaos_spec:
        env["PADDLE_TPU_CHAOS"] = chaos_spec
    r = subprocess.run([sys.executable, str(script)] + [str(a)
                                                        for a in args],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == expect_rc, (r.returncode, r.stderr[-2000:])
    return r


@pytest.mark.chaos
class TestKillAndResumeSampleOrder:
    def test_killed_run_resumes_identical_sample_sequence(self, tmp_path):
        trainer = tmp_path / "trainer.py"
        trainer.write_text(DATAPIPE_TRAINER)
        steps = 10

        def run(ckpt, log, **kw):
            return _subprocess(trainer, ["--ckpt", ckpt, "--log", log,
                                         "--steps", steps], **kw)

        ref_log = tmp_path / "ref.log"
        run(tmp_path / "ref_ckpt", ref_log)
        ref = [json.loads(l) for l in ref_log.read_text().splitlines()]
        assert [r["step"] for r in ref] == list(range(1, steps + 1))

        # chaos run: hard-killed at step 6 (steps 1-5 committed)
        ckpt, log = tmp_path / "ckpt", tmp_path / "got.log"
        run(ckpt, log, chaos_spec="train.step=kill@5",
            expect_rc=chaos.KILL_EXIT_CODE)
        partial = [json.loads(l) for l in log.read_text().splitlines()]
        assert [r["step"] for r in partial] == [1, 2, 3, 4, 5]

        # resume: the post-checkpoint sample order is EXACTLY the
        # reference's: no lost, duplicated or reordered samples
        run(ckpt, log)
        got = [json.loads(l) for l in log.read_text().splitlines()]
        assert got == ref


# ---------------------------------------------------------------------------
# the run_pipeline cases of tests/test_sentinel.py and the
# crash-during-rollback drill of tests/test_fault_injection.py
# ---------------------------------------------------------------------------

def build_model(pkg, seed=11, lr=0.05):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.framework.unique_name_scope("dp_"), \
            pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[6], dtype="float32")
        y = pkg.layers.data("y", shape=[1], dtype="float32")
        pred = pkg.layers.fc(x, 1, param_attr="w", bias_attr="b")
        loss = pkg.layers.reduce_mean(pkg.layers.square_error_cost(pred, y))
        pkg.optimizer.Momentum(learning_rate=lr, momentum=0.9) \
            .minimize(loss)
    return main, startup, loss


def make_samples(n=40, seed=7):
    rng = np.random.RandomState(seed)
    w_true = np.arange(1.0, 7.0, dtype="float32").reshape(6, 1)
    xs = rng.rand(n, 6).astype("float32")
    return [{"x": xs[i], "y": (xs[i:i + 1] @ w_true)[0].astype("float32")}
            for i in range(n)]


def make_pipe(samples, pkg=dp):
    # shuffle (RNG + buffer state) and a threaded prefetch stage: the
    # rollback must restore and quiesce both kinds of state
    pipe = pkg.InMemorySource(samples).shuffle(8, seed=3) \
        .batch(4, drop_last=True)
    return pipe.prefetch(depth=2, device=CPU) if pkg is dp \
        else pipe.prefetch(depth=2)


def _losses(outs):
    return [float(np.asarray(o[0]).reshape(-1)[0]) for o in outs]


def _ladder(pkg, root, tag, inject, state=None):
    """``run_pipeline`` over 40 samples (10 batches) in ``pkg`` from
    ``state`` (name -> array; else the startup's); with ``inject`` a
    ``Sentinel(strikes=2)`` on a manager saving every step and
    ``sentinel.nan`` on the 5th and 6th checks."""
    main, startup, loss = build_model(pkg)
    if pkg is pt:
        exe = pt.Executor(pt.CPUPlace())
        scope = scope_from_numpy(state, pt.CPUPlace(), main) \
            if state is not None else pt.Scope()
        if state is None:
            exe.run(startup, scope=scope)
        mgr_cls, sent_cls, fp = CheckpointManager, Sentinel, chaos
    else:
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        exe.run(startup, scope=scope)
        mgr_cls, sent_cls, fp = RefManager, RefSentinel, ref_chaos
    pipe = make_pipe(make_samples(), dp if pkg is pt else rdp)
    mgr = sentinel = on_step = None
    if inject:
        mgr = mgr_cls(str(root / tag), keep=4, executor=exe,
                      main_program=main, scope=scope, datapipe=pipe)
        sentinel = sent_cls(manager=mgr, cadence=1, strikes=2,
                            mark_good_after=1)

        def on_step(step, fetches):
            mgr.save(step)
            sentinel.note_checkpoint(step)

        fp.inject("sentinel.nan", after=4, times=2)
    try:
        outs = exe.run_pipeline(main, pipe, fetch_list=[loss.name],
                                scope=scope, sentinel=sentinel,
                                on_step=on_step)
    finally:
        fp.clear("sentinel.nan")
    return outs, mgr, sentinel, main, scope


class TestSentinelThroughRunPipeline:
    def test_skip_quarantine_rollback_resume_same_loss(self, tmp_path):
        counters = ("sentinel.skipped_steps", "sentinel.quarantined",
                    "sentinel.rollbacks")
        m = profiler.runtime_metrics
        ref_outs, _, _, _, _ = _ladder(pt, tmp_path, "ref", False)
        before = {n: m.counter(n) for n in counters}
        got_outs, mgr, sentinel, _, _ = _ladder(pt, tmp_path, "chaos",
                                                True)
        delta = {n: m.counter(n) - before[n] for n in counters}
        # (i) the two poisoned steps were skipped and quarantined
        assert delta == {"sentinel.skipped_steps": 2,
                         "sentinel.quarantined": 2,
                         "sentinel.rollbacks": 1}
        assert len(os.listdir(sentinel.quarantine_dir)) == 2
        assert mgr.last_good_step() is not None
        # (ii) the rollback rewound params AND the pipeline, and the
        # rewound entries were dropped: the returned list is the clean
        # sequence, each batch applied once (bit for bit here: the
        # restore puts back the state's bytes)
        assert len(ref_outs) == 10
        assert _losses(got_outs) == _losses(ref_outs)

    def test_ladder_matches_the_reference_package(self, tmp_path):
        """Both packages' drills from one state: the same 10 applied
        losses to ``LOSS_RTOL``, with the same skips and rollback."""
        jm, js, _ = build_model(fluid)
        jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        jexe.run(js, scope=jscope)
        state = {n: np.asarray(jscope.find_var(n))
                 for n in persistable_names(jm)}
        ref_outs, ref_mgr, _, _, _ = _ladder(fluid, tmp_path, "jax", True)
        got_outs, mgr, _, _, _ = _ladder(pt, tmp_path, "port", True,
                                         state=state)
        assert mgr.last_good_step() == ref_mgr.last_good_step()
        np.testing.assert_allclose(_losses(got_outs), _losses(ref_outs),
                                   rtol=LOSS_RTOL)

    def test_rollback_exact_once_under_restart_renumbering(self, tmp_path):
        """A restarted trainer renumbering its steps from 0 under a
        directory still holding a prior run's higher ckpt-N: commits are
        detected through the manager's own in-process saves, so the
        rollback truncates exactly."""
        samples = make_samples()
        main, startup, loss = build_model(pt)
        scope = pt.Scope()
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=scope)
        stale = CheckpointManager(str(tmp_path), keep=8, executor=exe,
                                  main_program=main, scope=scope,
                                  datapipe=make_pipe(samples))
        stale.save(50)
        pipe = make_pipe(samples)
        mgr = CheckpointManager(str(tmp_path), keep=8, executor=exe,
                                main_program=main, scope=scope,
                                datapipe=pipe)
        assert mgr.latest_step() == 50      # the trap this test locks
        sentinel = Sentinel(manager=mgr, cadence=1, strikes=2,
                            mark_good_after=1)

        def on_step(step, fetches):
            mgr.save(step)                  # renumbered from 0
            sentinel.note_checkpoint(step)

        chaos.inject("sentinel.nan", after=4, times=2)
        outs = exe.run_pipeline(main, pipe, fetch_list=[loss.name],
                                scope=scope, sentinel=sentinel,
                                on_step=on_step)
        chaos.clear("sentinel.nan")
        assert mgr.last_good_step() is not None
        assert mgr.last_good_step() < 50
        assert len(outs) == 10

    def test_unrecoverable_without_manager_reraises(self, tmp_path):
        main, startup, loss = build_model(pt)
        scope = pt.Scope()
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=scope)
        pipe = dp.InMemorySource(make_samples(16)).batch(4)
        sentinel = Sentinel(manager=None, cadence=1, strikes=1,
                            spike_factor=None,
                            quarantine_dir=str(tmp_path))
        chaos.inject("sentinel.nan", times=1)
        with pytest.raises(NumericalFault):
            exe.run_pipeline(main, pipe, fetch_list=[loss.name],
                             scope=scope, sentinel=sentinel)
        # the fault was still quarantined on the way out
        assert any(n.startswith("quarantine-")
                   for n in os.listdir(str(tmp_path)))


SENTINEL_TRAINER = r'''
"""Pipeline trainer of the port for the crash-during-rollback drill:
run_pipeline under a Sentinel guard, per-step checkpoints promoted to
known-good, resume via restore_last_good().  PADDLE_TPU_CHAOS arms
sentinel.nan (force the rollback) and ckpt.restore (kill mid-restore)."""
import argparse
import json

import numpy as np

import paddle_tpu_torch as pt
import paddle_tpu_torch.datapipe as dp
from paddle_tpu_torch.fault import CheckpointManager, Sentinel

ap = argparse.ArgumentParser()
ap.add_argument("--ckpt", required=True)
ap.add_argument("--out", required=True)
args = ap.parse_args()

main, startup = pt.Program(), pt.Program()
main.random_seed = startup.random_seed = 11
with pt.program_guard(main, startup):
    x = pt.layers.data("x", shape=[6], dtype="float32")
    y = pt.layers.data("y", shape=[1], dtype="float32")
    pred = pt.layers.fc(x, 1, param_attr="w", bias_attr="b")
    loss = pt.layers.reduce_mean(pt.layers.square_error_cost(pred, y))
    pt.optimizer.Momentum(learning_rate=0.05, momentum=0.9) \
        .minimize(loss)

rng = np.random.RandomState(7)
w_true = np.arange(1.0, 7.0, dtype="float32").reshape(6, 1)
xs = rng.rand(40, 6).astype("float32")
samples = [{"x": xs[i], "y": (xs[i:i + 1] @ w_true)[0].astype("float32")}
           for i in range(40)]
pipe = dp.InMemorySource(samples).shuffle(8, seed=3) \
    .batch(4, drop_last=True)

exe = pt.Executor(pt.CPUPlace())
exe.run(startup)
mgr = CheckpointManager(args.ckpt, keep=4, executor=exe,
                        main_program=main, datapipe=pipe)
resumed = mgr.restore_last_good()
sentinel = Sentinel(manager=mgr, cadence=1, strikes=2, mark_good_after=1)

losses = []

def on_step(step, fetches):
    losses.append(float(np.asarray(fetches[0]).reshape(-1)[0]))
    mgr.save(step)
    sentinel.note_checkpoint(step)

exe.run_pipeline(main, pipe, fetch_list=[loss.name], sentinel=sentinel,
                 on_step=on_step)

with open(args.out, "w") as f:
    json.dump({"final_loss": losses[-1], "resumed_from": resumed,
               "steps": len(losses)}, f)
'''


@pytest.mark.chaos
def test_crash_during_rollback_restarts_clean(tmp_path):
    """Chaos-kill the trainer mid-``restore_last_good()`` (the
    sentinel's rollback rung): the restart still restores a verified
    checkpoint with its datapipe state and reaches the uninterrupted
    run's final loss."""
    trainer = tmp_path / "trainer.py"
    trainer.write_text(SENTINEL_TRAINER)

    def run(ckpt, out, **kw):
        return _subprocess(trainer, ["--ckpt", ckpt, "--out", out], **kw)

    ref_out = tmp_path / "ref.json"
    run(tmp_path / "ref_ckpt", ref_out)
    ref = json.loads(ref_out.read_text())
    assert ref["resumed_from"] is None and ref["steps"] == 10

    ckpt, out = tmp_path / "ckpt", tmp_path / "got.json"
    run(ckpt, out, chaos_spec="sentinel.nan=error@4*2;ckpt.restore=kill",
        expect_rc=chaos.KILL_EXIT_CODE)
    assert not out.exists()          # it really died mid-rollback

    run(ckpt, out)
    got = json.loads(out.read_text())
    assert got["resumed_from"] == 2  # newest PROMOTED known-good
    assert got["steps"] == 7         # batches 3..9 replayed
    np.testing.assert_allclose(got["final_loss"], ref["final_loss"],
                               rtol=1e-5)
    qdir = ckpt / "quarantine"
    assert qdir.is_dir() and len(list(qdir.glob("*.pkl"))) == 2


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def test_seeded_pipeline_yields_identical_batches_in_both_packages():
    samples = id_samples(37)
    got = [_host(b) for b in std_pipe(samples)]
    want = [_host(b) for b in std_pipe(samples, pkg=rdp)]
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    # and a second epoch, the shuffle RNG carried on
    a, b = std_pipe(samples), std_pipe(samples, pkg=rdp)
    list(a), list(b)
    assert ids_of(list(a)) == ids_of(list(b))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_mid_epoch_state_continues_in_the_other_package(writer):
    samples = id_samples(45)
    ref = ids_of(std_pipe(samples))
    src_pkg, dst_pkg = (dp, rdp) if writer == "port" else (rdp, dp)
    pipe = std_pipe(samples, pkg=src_pkg)
    it = iter(pipe)
    first = [next(it) for _ in range(4)]
    it.close()                  # prefetch holds queued batches
    blob = pickle.dumps(pipe.state_dict())
    assert pickle.loads(blob)["state"]["pending"], \
        "the state should carry prefetched batches"
    fresh = std_pipe(samples, pkg=dst_pkg)
    fresh.load_state_dict(pickle.loads(blob))
    rest = list(fresh)
    assert ids_of(first) + ids_of(rest) == ref
    # the rest's values, not only its ids
    want = list(std_pipe(samples))[4:]
    for g, w in zip(rest, want):
        np.testing.assert_array_equal(np.asarray(g["x"]),
                                      np.asarray(w["x"]))


def _hp(mod):
    hp = mod.ModelHyperParams()
    hp.d_model, hp.d_inner_hid, hp.n_layer = 64, 128, 2
    hp.n_head, hp.d_key, hp.d_value = 4, 16, 16
    hp.src_vocab_size = hp.trg_vocab_size = 64
    hp.max_length = 32
    hp.dropout = 0.0
    return hp


def test_run_pipeline_transformer_matches_reference(monkeypatch):
    """``run_pipeline`` on a 2 + 2 layer, d_model 64 Transformer (Adam,
    dropout 0) over one seeded pipeline in each package, from one
    transplanted state: the same losses to ``LOSS_RTOL``."""
    monkeypatch.delenv("PADDLE_TPU_FLASH_MIN_S", raising=False)
    B, S, steps = 2, 16, 4
    progs = {}
    for key, pkg, names, mod in (("jax", fluid, jax_names, JT),
                                 ("port", pt, torch_names, TT)):
        main, startup = pkg.Program(), pkg.Program()
        with names("rp_"), pkg.program_guard(main, startup):
            cost, _ = mod.transformer(B, S, S, _hp(mod))
            pkg.optimizer.Adam(learning_rate=1e-3).minimize(cost)
        progs[key] = (main, startup, cost)
    jm, js, jc = progs["jax"]
    tm, _, tc = progs["port"]
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    jexe.run(js, scope=jscope)
    tscope = scope_from_numpy({n: np.asarray(jscope.find_var(n))
                               for n in persistable_names(tm)},
                              pt.CPUPlace(), tm)
    rows = TT.fake_batch(B * steps, S, S, _hp(TT), seed=5)
    samples = [{k: v[i] for k, v in rows.items()}
               for i in range(B * steps)]
    ref = jexe.run_pipeline(
        jm, std_like(samples, rdp, B), fetch_list=[jc], scope=jscope)
    got = pt.Executor(pt.CPUPlace()).run_pipeline(
        tm, std_like(samples, dp, B), fetch_list=[tc], scope=tscope)
    assert len(got) == len(ref) == steps
    np.testing.assert_allclose(_losses(got), _losses(ref), rtol=LOSS_RTOL)


def std_like(samples, pkg, B):
    pipe = pkg.InMemorySource(samples).shuffle(4, seed=9) \
        .map(lambda s: s, workers=2).batch(B, drop_last=True)
    return pipe.prefetch(depth=2, device=CPU) if pkg is dp \
        else pipe.prefetch(depth=2)


def test_device_prefetch_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = dp.InMemorySource(id_samples(4)).batch(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        src.prefetch()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dp.DevicePrefetch(src, device="cuda")
    # the CPU only when asked for, as a place or a name
    assert src.prefetch(device=pt.CPUPlace()).device.type == "cpu"
    assert src.prefetch(device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.Executor().run_pipeline(pt.Program(), [])


def test_threaded_stages_under_a_short_switch_interval():
    """More map workers than cores and a prefetch thread, with the
    interpreter switching threads every microsecond, quiesced and
    restored every few batches: the sample sequence is the serial one,
    nothing lost or repeated."""
    import os as _os
    samples = id_samples(96)
    workers = 2 * (_os.cpu_count() or 4)

    def build():
        return (dp.InMemorySource(samples).shuffle(16, seed=4)
                .map(_double, workers=workers).batch(4)
                .prefetch(depth=4, device=CPU))

    want = ids_of(dp.InMemorySource(samples).shuffle(16, seed=4)
                  .map(_double).batch(4))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got, pipe = [], build()
        deadline = time.time() + 60
        while time.time() < deadline:
            it = iter(pipe)
            batch = [b for _, b in zip(range(3), it)]
            it.close()
            got += ids_of(batch)
            if not batch:
                break
            state = pickle.loads(pickle.dumps(pipe.state_dict()))
            pipe = build()
            pipe.load_state_dict(state)
    finally:
        sys.setswitchinterval(old)
    assert got == want
