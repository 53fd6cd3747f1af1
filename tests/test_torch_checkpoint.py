"""The port's persistence and checkpoints against the JAX package's: the
``save`` / ``load`` ops and ``save_params`` / ``load_params`` files,
checkpoints written by either package read by the other (the port's
shard format at one shard a variable; the JAX package's shard format on
a one-device and a 4-way mesh), bfloat16 state, the
``CheckpointManager`` drills of ``tests/test_fault_injection.py``
(``TestCheckpointManager``, ``TestGracefulShutdown``), the async save's
snapshot, and the kill-and-resume drill of ``TestKillAndResume``.

Everything restored is compared exactly: a checkpoint holds the state's
bytes, and a resumed run at dropout 0 (the port's Adam on the CPU) is
held bit for bit to one that never stopped."""

import os
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.fault import CheckpointManager as JaxManager
from paddle_tpu_torch.convert import to_numpy
from paddle_tpu_torch.fault import (CheckpointManager, CorruptCheckpoint,
                                    GracefulShutdown, chaos, shard_ckpt)
from paddle_tpu_torch.fault.checkpoint import (MANIFEST_NAME,
                                               verify_checkpoint)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_failpoints():
    chaos.clear()
    yield
    chaos.clear()


def _corrupt_largest_file(ckpt_dir, truncate_to_half=True):
    from conftest import corrupt_largest_file
    return corrupt_largest_file(ckpt_dir, truncate_to_half)


def _tiny(pkg):
    """``(main, startup, loss)``: x [4, 8] -> fc -> squared error, Adam;
    the same names every time, in both packages."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 3
    names = pkg.framework.unique_name_scope
    with names("ck_"), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[4, 8], append_batch_size=False)
        y = pkg.layers.data(name="y", shape=[4, 1], append_batch_size=False)
        pred = pkg.layers.fc(input=x, size=1, param_attr="ck_w",
                             bias_attr="ck_b")
        loss = pkg.layers.mean(pkg.layers.square_error_cost(input=pred,
                                                            label=y))
        pkg.optimizer.Adam(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _tiny_feed(step):
    rng = np.random.RandomState(step)
    xs = rng.rand(4, 8).astype("float32")
    return {"x": xs, "y": xs.sum(1, keepdims=True).astype("float32") * 0.1}


class _Port:
    """The tiny program on the port's CPU executor, in its own scope."""

    def __init__(self):
        self.main, self.startup, self.loss = _tiny(pt)
        self.exe = pt.Executor(pt.CPUPlace())
        self.scope = pt.Scope()
        self.exe.run(self.startup, scope=self.scope)

    def step(self, s):
        return self.exe.run(self.main, feed=_tiny_feed(s),
                            fetch_list=[self.loss], scope=self.scope)

    def manager(self, d, keep=10, **kw):
        return CheckpointManager(str(d), keep=keep, executor=self.exe,
                                 main_program=self.main, scope=self.scope,
                                 **kw)

    def state(self):
        return {n: to_numpy(v) for n, v in self.scope.items()
                if isinstance(v, torch.Tensor)}


def _train_and_save(tmp_path, steps, keep=10):
    port = _Port()
    mgr = port.manager(tmp_path, keep=keep)
    for s in range(1, steps + 1):
        port.step(s)
        mgr.save(s)
    return mgr, port


def _jax_scope(main, startup):
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    return exe, scope


def _persistables(main, scope):
    return {v.name: np.array(scope.find_var(v.name))
            for v in main.list_vars()
            if v.persistable and hasattr(scope.find_var(v.name), "dtype")}


def _assert_state_equal(got, want):
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        assert got[n].dtype == w.dtype, n
        np.testing.assert_array_equal(got[n], w, err_msg=n)


# ---------------------------------------------------------------------------
# save / load ops and the io functions, across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("filename", [None, "__params__"])
@pytest.mark.parametrize("which", ["persistables", "params"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_save_and_load_cross_packages(tmp_path, writer, which, filename):
    port = _Port()
    port.step(1)
    jm, js, _ = _tiny(fluid)
    jexe, jscope = _jax_scope(jm, js)
    d = str(tmp_path / "vars")
    if writer == "torch":
        with pt.scope_guard(port.scope):
            getattr(pt.io, f"save_{which}")(port.exe, d, port.main,
                                            filename=filename)
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            getattr(fluid.io, f"load_{which}")(jexe, d, jm,
                                               filename=filename)
        got = {n: np.asarray(v) for n, v in scope._vars.items()
               if v is not None}
        want = port.state()
    else:
        with fluid.scope_guard(jscope):
            getattr(fluid.io, f"save_{which}")(jexe, d, jm,
                                               filename=filename)
        scope = pt.Scope()
        with pt.scope_guard(scope):
            getattr(pt.io, f"load_{which}")(port.exe, d, port.main,
                                            filename=filename)
        got = {n: to_numpy(v) for n, v in scope.items()}
        want = _persistables(jm, jscope)
    if which == "params":
        want = {n: v for n, v in want.items() if n in ("ck_w", "ck_b")}
    _assert_state_equal(got, want)
    if filename is None:
        assert sorted(os.listdir(d)) == sorted(want)


def test_save_and_load_ops_keep_bfloat16_and_lod(tmp_path):
    main = pt.Program()
    block = main.global_block()
    for n, dt in (("h", "bfloat16"), ("s", "int64")):
        block.create_var(name=n, shape=[3, 2], dtype=dt, persistable=True)
    src = pt.Scope()
    h = torch.randn(3, 2).to(torch.bfloat16)
    src.set_var("h", h)
    src.set_var("s", torch.arange(6).reshape(3, 2))
    exe = pt.Executor(pt.CPUPlace())
    d = str(tmp_path / "v")
    with pt.scope_guard(src):
        pt.io.save_persistables(exe, d, main)
    dst = pt.Scope()
    with pt.scope_guard(dst):
        pt.io.load_persistables(exe, d, main)
    assert dst.find_var("h").dtype == torch.bfloat16
    assert torch.equal(dst.find_var("h").view(torch.int16),
                       h.view(torch.int16))
    assert torch.equal(dst.find_var("s"), src.find_var("s"))
    # a record's LoD survives save -> load
    from paddle_tpu_torch.ops import persist_ops
    with open(os.path.join(d, "s"), "rb") as f:
        t, lod = persist_ops.read_tensor(f)
    assert lod == [] and t.dtype == torch.int64
    p = str(tmp_path / "lod")
    with open(p, "wb") as f:
        persist_ops.write_tensor(f, torch.ones(3, 2), lod=[[0, 1, 3]])
    from paddle_tpu.ops import persist_ops as jax_persist
    with open(p, "rb") as f:
        arr, jlod = jax_persist.read_tensor(f)
    assert jlod == [[0, 1, 3]] and arr.shape == (3, 2)


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

def test_port_checkpoint_reads_in_the_reference(tmp_path):
    mgr, port = _train_and_save(tmp_path, steps=2)
    want = port.state()
    jm, _, _ = _tiny(fluid)
    scope = fluid.Scope()
    assert fluid.io.load_checkpoint(None, str(tmp_path), jm,
                                    scope=scope) == 2
    _assert_state_equal({n: np.asarray(v) for n, v in scope._vars.items()},
                        want)
    # the reference's manager verifies the manifest and its topology
    jmgr = JaxManager(str(tmp_path), executor=None, main_program=jm,
                      scope=fluid.Scope())
    assert jmgr.restore_latest() == 2 and jmgr.quarantined() == []
    manifest = verify_checkpoint(mgr.path(2))
    assert manifest["topology"]["mesh_shape"] == [1]
    assert {r["num_shards"] for r in
            manifest["topology"]["shards"].values()} == {1}


@pytest.mark.parametrize("devices", [1, 4])
def test_reference_mesh_checkpoint_reads_in_the_port(tmp_path, devices):
    """The JAX package's shard format on a one-device mesh, and on a
    4-way mesh with ``ck_w`` split along its rows (four pieces the port
    concatenates)."""
    from jax.sharding import Mesh
    jm, js, jl = _tiny(fluid)
    jexe, jscope = _jax_scope(jm, js)
    jexe.run(jm, feed=_tiny_feed(1), fetch_list=[jl], scope=jscope)
    mesh = Mesh(np.array(jax.devices()[:devices]), ("dp",))
    specs = {"ck_w": ("dp", None)} if devices > 1 else None
    fluid.io.save_checkpoint(jexe, str(tmp_path), jm, step=7, scope=jscope,
                             mesh=mesh, shard_specs=specs)
    topo = verify_checkpoint(os.path.join(str(tmp_path), "ckpt-7"))[
        "topology"]
    assert topo["shards"]["ck_w"]["num_shards"] == devices
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    assert pt.io.load_checkpoint(exe, str(tmp_path), scope=scope) == 7
    _assert_state_equal({n: to_numpy(v) for n, v in scope.items()},
                        _persistables(jm, jscope))


def test_reference_orbax_checkpoint_raises_in_the_port(tmp_path):
    jm, js, _ = _tiny(fluid)
    jexe, jscope = _jax_scope(jm, js)
    fluid.io.save_checkpoint(jexe, str(tmp_path), jm, step=1, scope=jscope)
    with pytest.raises(ValueError, match="orbax"):
        pt.io.load_checkpoint(pt.Executor(pt.CPUPlace()), str(tmp_path),
                              scope=pt.Scope())


def test_mesh_arguments_raise_naming_item_7(tmp_path):
    """The mesh arguments came with item 7 (``tests/
    test_torch_mesh_ckpt.py`` drives them over gloo worlds): without a
    mesh, ``shard_specs`` is ignored as in the JAX package (one shard a
    variable), and a restore onto something that is not a DeviceMesh
    raises before the scope changes."""
    port = _Port()
    pt.io.save_checkpoint(port.exe, str(tmp_path), port.main,
                          scope=port.scope, shard_specs={"ck_w": ("dp",)})
    from paddle_tpu_torch.fault import shard_ckpt
    topo = shard_ckpt.read_manifest(str(tmp_path / "ckpt-0"))["topology"]
    assert {r["num_shards"] for r in topo["shards"].values()} == {1}
    before = {n: port.scope.find_var(n) for n in port.scope.local_var_names()}
    with pytest.raises(AttributeError):
        pt.io.load_checkpoint(port.exe, str(tmp_path), scope=port.scope,
                              mesh=object())
    assert all(port.scope.find_var(n) is v for n, v in before.items())


def test_bfloat16_state_round_trips_both_ways(tmp_path):
    import ml_dtypes
    from jax.sharding import Mesh
    main = pt.Program()
    main.global_block().create_var(name="h", shape=[4, 3],
                                   dtype="bfloat16", persistable=True)
    h = torch.randn(4, 3).to(torch.bfloat16)
    scope = pt.Scope()
    scope.set_var("h", h)
    pt.io.save_checkpoint(None, str(tmp_path / "port"), main, step=1,
                          scope=scope)
    back = pt.Scope()
    pt.io.load_checkpoint(pt.Executor(pt.CPUPlace()), str(tmp_path / "port"),
                          scope=back)
    assert back.find_var("h").dtype == torch.bfloat16
    words = h.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(to_numpy(back.find_var("h")), words)
    # the file is the JAX package's np.save of a bfloat16 array
    f = os.path.join(str(tmp_path / "port"), "ckpt-1",
                     shard_ckpt.shard_relpath("h", 0, 1))
    ref = np.load(f)
    assert ref.dtype.kind == "V" and ref.dtype.itemsize == 2
    np.testing.assert_array_equal(ref.view(np.uint16), words)
    # and the reference's bfloat16 state reads as bfloat16 in the port
    jm = fluid.Program()
    jm.global_block().create_var(name="h", shape=[4, 3], dtype="bfloat16",
                                 persistable=True)
    jscope = fluid.Scope()
    jscope.set_var("h", jax.numpy.asarray(
        words.view(ml_dtypes.bfloat16)))
    fluid.io.save_checkpoint(None, str(tmp_path / "ref"), jm, step=2,
                             scope=jscope,
                             mesh=Mesh(np.array(jax.devices()[:1]), ("dp",)))
    got = pt.Scope()
    pt.io.load_checkpoint(pt.Executor(pt.CPUPlace()), str(tmp_path / "ref"),
                          scope=got)
    assert got.find_var("h").dtype == torch.bfloat16
    np.testing.assert_array_equal(to_numpy(got.find_var("h")), words)


# ---------------------------------------------------------------------------
# CheckpointManager (tests/test_fault_injection.py TestCheckpointManager)
# ---------------------------------------------------------------------------

def test_manifest_written_and_verifies(tmp_path):
    mgr, _ = _train_and_save(tmp_path, steps=1)
    manifest = verify_checkpoint(mgr.path(1))
    assert manifest["step"] == 1 and manifest["files"]
    assert os.path.exists(os.path.join(mgr.path(1), MANIFEST_NAME))


def test_restore_latest_restores_the_saved_state(tmp_path):
    mgr, port = _train_and_save(tmp_path, steps=3)
    want = port.state()
    port.step(9)                              # move on, then roll back
    fresh = _Port()
    got = fresh.manager(tmp_path).restore_latest()
    assert got == 3
    _assert_state_equal(fresh.state(), want)


def test_keep_n_gc(tmp_path):
    mgr, _ = _train_and_save(tmp_path, steps=5, keep=2)
    assert mgr.steps() == [4, 5]


def test_truncated_checkpoint_quarantined_and_fallback(tmp_path):
    mgr, port = _train_and_save(tmp_path, steps=2)
    _corrupt_largest_file(mgr.path(2))
    with pytest.raises(CorruptCheckpoint):
        mgr.verify(2)
    assert mgr.restore_latest() == 1
    assert mgr.steps() == [1]
    assert any("ckpt-2" in q for q in mgr.quarantined())
    assert pt.io.load_checkpoint(port.exe, str(tmp_path),
                                 scope=port.scope) == 1


def test_bitflip_detected_by_checksum(tmp_path):
    mgr, _ = _train_and_save(tmp_path, steps=1)
    _corrupt_largest_file(mgr.path(1), truncate_to_half=False)
    with pytest.raises(CorruptCheckpoint, match="checksum"):
        mgr.verify(1)


def test_resave_same_step_overwrites_safely(tmp_path):
    mgr, port = _train_and_save(tmp_path, steps=1)
    port.step(9)
    mgr.save(1)
    assert mgr.steps() == [1]
    assert mgr.restore_latest() == 1
    assert not [n for n in os.listdir(str(tmp_path))
                if n.startswith(".tmp-")]


def test_checkpoint_without_manifest_is_skipped_not_quarantined(tmp_path):
    """A checkpoint whose manifest is gone cannot be verified or read (its
    topology lives in the manifest): restore_latest skips it without
    quarantining it, as the JAX package skips an unreadable legacy
    checkpoint, and restores the one before."""
    mgr, _ = _train_and_save(tmp_path, steps=2)
    os.remove(os.path.join(mgr.path(2), MANIFEST_NAME))
    assert mgr.restore_latest() == 1
    assert mgr.quarantined() == [] and mgr.steps() == [1, 2]


def test_restore_latest_empty_dir(tmp_path):
    assert _Port().manager(tmp_path).restore_latest() is None


def test_gc_pins_newest_verified_when_newer_are_corrupt(tmp_path):
    mgr, _ = _train_and_save(tmp_path, steps=3)
    _corrupt_largest_file(mgr.path(2))
    _corrupt_largest_file(mgr.path(3))
    mgr.keep = 1
    mgr._gc()
    assert mgr.steps() == [1, 3]
    assert mgr.restore_latest() == 1


def test_mark_good_and_restore_last_good(tmp_path):
    mgr, port = _train_and_save(tmp_path, steps=3)
    assert mgr.mark_good(2) == 2
    assert mgr.last_good_step() == 2
    assert mgr.restore_last_good() == 2
    assert pt.io.load_checkpoint(port.exe, str(tmp_path),
                                 scope=port.scope) == 2


def test_gc_never_collects_known_good(tmp_path):
    mgr, port = _train_and_save(tmp_path, steps=2, keep=2)
    mgr.mark_good(1)
    for s in (3, 4, 5):
        port.step(s)
        mgr.save(s)
    assert mgr.steps() == [1, 4, 5]
    assert mgr.last_good_step() == 1


def test_resaving_the_anchor_step_drops_the_pointer(tmp_path):
    mgr, port = _train_and_save(tmp_path, steps=2)
    mgr.mark_good(2)
    port.step(9)
    mgr.save(2)
    assert mgr.last_good_step() is None
    assert mgr.restore_last_good() == 2


def test_mark_good_of_rotated_away_step_returns_none(tmp_path):
    import shutil
    mgr, _ = _train_and_save(tmp_path, steps=2)
    shutil.rmtree(mgr.path(1))
    assert mgr.mark_good(1) is None
    assert mgr.last_good_step() is None


def test_gc_protects_fresh_commit_under_restart_renumbering(tmp_path):
    mgr, port = _train_and_save(tmp_path, steps=6, keep=3)
    port.step(9)
    mgr.save(0)
    assert 0 in mgr.steps()
    assert pt.io.load_checkpoint(port.exe, str(tmp_path),
                                 scope=port.scope) == 0


def test_mark_good_reverifies_foreign_checkpoints(tmp_path):
    mgr, port = _train_and_save(tmp_path, steps=1)
    _corrupt_largest_file(mgr.path(1))
    fresh = port.manager(tmp_path)
    with pytest.raises(CorruptCheckpoint):
        fresh.mark_good(1)
    assert fresh.last_good_step() is None


def test_restore_last_good_falls_back_when_good_is_corrupt(tmp_path):
    mgr, _ = _train_and_save(tmp_path, steps=3)
    mgr.mark_good(2)
    _corrupt_largest_file(mgr.path(2))
    assert mgr.restore_last_good() == 3
    assert any("ckpt-2" in q for q in mgr.quarantined())
    assert mgr.last_good_step() is None


def test_kill_at_commit_leaves_previous_restorable(tmp_path):
    mgr, port = _train_and_save(tmp_path, steps=1)
    chaos.inject("ckpt.commit", error=KeyboardInterrupt("preempted"))
    port.step(2)
    with pytest.raises(KeyboardInterrupt):
        mgr.save(2)
    chaos.clear()
    assert mgr.steps() == [1]
    assert [n for n in os.listdir(str(tmp_path)) if n.startswith(".tmp-")]
    assert mgr.restore_latest() == 1
    mgr.save(2)
    assert not [n for n in os.listdir(str(tmp_path))
                if n.startswith(".tmp-")]


class _Sidecar:
    """A datapipe / ledger stub: ``state_dict`` / ``load_state_dict``."""

    def __init__(self, pos):
        self.pos = pos

    def state_dict(self):
        return {"pos": self.pos}

    def load_state_dict(self, d):
        self.pos = d["pos"]


def test_datapipe_and_ledger_sidecars_ride_the_commit(tmp_path):
    port = _Port()
    pipe, ledger = _Sidecar(0), _Sidecar(0)
    mgr = port.manager(tmp_path, datapipe=pipe, ledger=ledger)
    for s in (1, 2):
        pipe.pos, ledger.pos = 10 * s, 100 * s
        port.step(s)
        mgr.save(s)
    assert "datapipe_state.pkl" in verify_checkpoint(mgr.path(2))["files"]
    pipe.pos = ledger.pos = -1
    mgr.mark_good(1)
    assert mgr.restore_last_good() == 1
    assert (pipe.pos, ledger.pos) == (10, 100)
    assert mgr.last_restore_rewound is True
    assert mgr.restore_latest() == 2 and (pipe.pos, ledger.pos) == (20, 200)


def test_real_datapipe_and_ledger_sidecars_ride_the_commit(tmp_path):
    """The stub's drill with the real sidecars: a prefetching pipeline
    and a run ledger driven by ``run_pipeline``; a restore of an older
    step rewinds both, and the loop resumes on the saved position."""
    import paddle_tpu_torch.datapipe as dp
    from paddle_tpu_torch.obs.ledger import RunLedger, read_rows
    port = _Port()
    rng = np.random.RandomState(0)
    samples = [{"x": rng.rand(8).astype("float32"),
                "y": rng.rand(1).astype("float32")} for _ in range(32)]

    pipe = dp.InMemorySource(samples).shuffle(8, seed=2).batch(
        4, drop_last=True).prefetch(depth=2, device="cpu")
    ledger = RunLedger(str(tmp_path / "ledger"), flush_every=1,
                       install=False)
    mgr = port.manager(tmp_path / "ckpt", datapipe=pipe, ledger=ledger)

    def on_step(s, fetches):
        mgr.save(s + 1)

    outs = port.exe.run_pipeline(
        port.main, pipe, fetch_list=[port.loss], scope=port.scope,
        max_steps=5, ledger=ledger, on_step=on_step)
    assert len(outs) == 5 and ledger.rows_total == 5
    seen = ledger.tail(5)
    assert mgr.restore(2) is not None
    assert mgr.last_restore_rewound is True
    assert (ledger.rows_total, ledger.last_step) == (2, 1)
    rest = port.exe.run_pipeline(port.main, pipe, fetch_list=[port.loss],
                                 scope=port.scope, ledger=ledger)
    # the pipeline resumed at batch 3 of the 8: the same batches, once
    assert len(rest) == 6
    np.testing.assert_array_equal(
        [float(np.asarray(o[0]).reshape(())) for o in rest[:3]],
        [r["loss"] for r in seen[2:]])
    ledger.close()
    assert [r["step"] for r in read_rows(ledger.dirname)] == list(range(8))


def test_restore_reports_params_only_when_no_datapipe_state(tmp_path):
    mgr, _ = _train_and_save(tmp_path, steps=1)
    mgr.mark_good(1)

    class _Pipe:
        def load_state_dict(self, d):
            raise AssertionError("no state to load")

    mgr.datapipe = _Pipe()
    assert mgr.restore_last_good() == 1
    assert mgr.last_restore_rewound is False


def test_manager_from_env(tmp_path, monkeypatch):
    from paddle_tpu_torch.fault import manager_from_env
    monkeypatch.delenv("PADDLE_TPU_CKPT_DIR", raising=False)
    assert manager_from_env() is None
    monkeypatch.setenv("PADDLE_TPU_CKPT_DIR", str(tmp_path))
    monkeypatch.setenv("PADDLE_TPU_CKPT_KEEP", "2")
    mgr = manager_from_env()
    assert mgr.keep == 2 and mgr.dirname == str(tmp_path)


def test_save_async_writes_the_snapshot_not_the_next_step(tmp_path):
    """The port's steps write the scope's tensors in place: the async
    save must serialize the state as it was when ``save_async`` returned,
    while the next step (and an in-place write, as a CUDA graph's
    write-back makes) changes it under the writer."""
    port = _Port()
    port.step(1)
    mgr = port.manager(tmp_path)
    want = port.state()
    chaos.inject("ckpt.save", delay=0.3)     # the writer starts late
    fut = mgr.save_async(1)
    port.scope.find_var("ck_w").add_(1.0)    # in place, under the writer
    port.step(2)
    assert mgr.wait_pending() == fut.result()
    after = port.state()
    assert not np.array_equal(after["ck_b"], want["ck_b"])
    fresh = _Port()
    assert fresh.manager(tmp_path).restore_latest() == 1
    _assert_state_equal(fresh.state(), want)


def test_blocking_save_clones_nothing(tmp_path, monkeypatch):
    """A blocking save copies the live tensors to the host: no device
    clone of the state (only ``save_async`` needs one)."""
    port = _Port()
    port.step(1)
    want = port.state()

    def no_clone(*a, **k):
        raise AssertionError("a blocking save cloned the state")
    live = []
    host_state = shard_ckpt.host_state

    def spy(state):
        live.append(sorted(state) == sorted(want) and all(
            v is port.scope.find_var(n) for n, v in state.items()))
        return host_state(state)
    monkeypatch.setattr(pt.io, "snapshot_state", no_clone)
    monkeypatch.setattr(shard_ckpt, "host_state", spy)
    port.manager(tmp_path).save(1)
    pt.io.save_checkpoint(None, str(tmp_path / "io"), port.main, step=1,
                          scope=port.scope)
    monkeypatch.undo()
    assert live == [True, True]
    for d in (tmp_path, tmp_path / "io"):
        fresh = _Port()
        assert pt.io.load_checkpoint(fresh.exe, str(d),
                                     scope=fresh.scope) == 1
        _assert_state_equal(fresh.state(), want)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no CUDA")
def test_restore_without_executor_targets_the_default_place(tmp_path):
    """Without an executor a restore goes to the default place
    (``cuda:0``), never to the CPU on its own: here, with no CUDA, it
    raises as every entry point given no place does."""
    _, port = _train_and_save(tmp_path, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.io.load_checkpoint(None, str(tmp_path), scope=pt.Scope())
    mgr = CheckpointManager(str(tmp_path), main_program=port.main,
                            scope=pt.Scope())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mgr.restore_latest()
    assert mgr.quarantined() == []


# ---------------------------------------------------------------------------
# graceful shutdown (tests/test_fault_injection.py TestGracefulShutdown)
# ---------------------------------------------------------------------------

def test_sigterm_sets_flag_and_restores_handler():
    prev = signal.getsignal(signal.SIGTERM)
    with GracefulShutdown() as stop:
        assert not stop.should_stop()
        os.kill(os.getpid(), signal.SIGTERM)
        assert stop.wait(5.0)
        assert stop.received == signal.SIGTERM
    assert signal.getsignal(signal.SIGTERM) is prev


def test_preempted_loop_commits_final_checkpoint(tmp_path):
    port = _Port()
    mgr = port.manager(tmp_path)
    done = 0
    with GracefulShutdown() as stop:
        for step in range(1, 100):
            if stop.should_stop():
                break
            port.step(step)
            done = step
            if step == 3:
                os.kill(os.getpid(), signal.SIGTERM)
        mgr.save(done)
    assert done == 3 and mgr.restore_latest() == 3


# ---------------------------------------------------------------------------
# kill-and-resume (tests/test_fault_injection.py TestKillAndResume)
# ---------------------------------------------------------------------------

TRAINER_SCRIPT = r'''
"""Deterministic port trainer for the kill-and-resume drill: Adam at
dropout 0 on the CPU, a checkpoint every step through CheckpointManager,
resume from restore_latest(), the train.step failpoint armed by
PADDLE_TPU_CHAOS; the final state goes to --out."""
import argparse

import numpy as np
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import to_numpy
from paddle_tpu_torch.fault import CheckpointManager, chaos

ap = argparse.ArgumentParser()
ap.add_argument("--ckpt", required=True)
ap.add_argument("--steps", type=int, required=True)
ap.add_argument("--out", required=True)
args = ap.parse_args()

main, startup = pt.Program(), pt.Program()
main.random_seed = startup.random_seed = 11
# names restart from zero: the same names in a fresh process and in one
# that built programs before
with pt.framework.unique_name_scope(""), pt.program_guard(main, startup):
    x = pt.layers.data("x", shape=[6], dtype="float32")
    y = pt.layers.data("y", shape=[1], dtype="float32")
    h = pt.layers.fc(x, 8, act="relu", param_attr="w1", bias_attr="b1")
    pred = pt.layers.fc(h, 1, param_attr="w2", bias_attr="b2")
    loss = pt.layers.reduce_mean(pt.layers.square_error_cost(pred, y))
    pt.optimizer.Adam(learning_rate=0.05).minimize(loss)

exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
exe.run(startup, scope=scope)
mgr = CheckpointManager(args.ckpt, keep=3, executor=exe, main_program=main,
                        scope=scope)
start = mgr.restore_latest() or 0

def feed_for(step):
    rng = np.random.RandomState(1000 + step)
    xs = rng.rand(16, 6).astype("float32")
    ys = (xs @ np.arange(1.0, 7.0, dtype="float32").reshape(6, 1)
          ).astype("float32")
    return {"x": xs, "y": ys}

for step in range(start + 1, args.steps + 1):
    chaos.fire("train.step", step=step)
    exe.run(main, feed=feed_for(step), fetch_list=[loss], scope=scope)
    mgr.save(step)

np.savez(args.out, resumed_from=start,
         **{n: to_numpy(v) for n, v in scope.items()
            if isinstance(v, torch.Tensor)})
'''


def _trainer(tmp_path, ckpt, out, chaos_spec=None, expect_rc=0,
             in_process=False):
    """One trainer run, in a subprocess (``in_process``: in this one,
    for the run that is never killed)."""
    script = tmp_path / "trainer.py"
    if not script.exists():
        script.write_text(TRAINER_SCRIPT)
    argv = [str(script), "--ckpt", str(ckpt), "--steps", "8", "--out",
            str(out)]
    if in_process:
        import runpy
        saved = sys.argv
        sys.argv = argv
        try:
            runpy.run_path(str(script), run_name="__main__")
        finally:
            sys.argv = saved
        return
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("PADDLE_TPU_CHAOS", None)
    if chaos_spec:
        env["PADDLE_TPU_CHAOS"] = chaos_spec
    r = subprocess.run([sys.executable] + argv, cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == expect_rc, (r.returncode, r.stderr[-2000:])


def _final_state(out):
    with np.load(out) as z:
        return int(z["resumed_from"]), {n: z[n] for n in z.files
                                        if n != "resumed_from"}


def test_killed_run_resumes_to_the_same_state(tmp_path):
    """Killed hard before step 5 (steps 1-4 committed), resumed: the
    parameters and Adam moments after step 8 equal, bit for bit, those of
    a run that never stopped."""
    _trainer(tmp_path, tmp_path / "ref_ckpt", tmp_path / "ref.npz",
             in_process=True)
    start, want = _final_state(tmp_path / "ref.npz")
    assert start == 0
    assert any(n.startswith("moment1") for n in want)
    ckpt = tmp_path / "ckpt"
    _trainer(tmp_path, ckpt, tmp_path / "got.npz",
             chaos_spec="train.step=kill@4",
             expect_rc=chaos.KILL_EXIT_CODE)
    assert not (tmp_path / "got.npz").exists()
    _trainer(tmp_path, ckpt, tmp_path / "got.npz")
    start, got = _final_state(tmp_path / "got.npz")
    assert start == 4
    _assert_state_equal(got, want)


def test_resume_skips_truncated_checkpoint(tmp_path):
    ckpt = tmp_path / "ckpt"
    _trainer(tmp_path, ckpt, tmp_path / "out.npz",
             chaos_spec="train.step=kill@4",
             expect_rc=chaos.KILL_EXIT_CODE)
    _corrupt_largest_file(ckpt / "ckpt-4")
    _trainer(tmp_path, ckpt, tmp_path / "out.npz")
    start, _ = _final_state(tmp_path / "out.npz")
    assert start == 3
    assert any(n.endswith(".corrupt") for n in os.listdir(ckpt))
