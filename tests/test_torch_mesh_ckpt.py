"""Mesh-sharded checkpoints in the port (``io.save_checkpoint(mesh=,
shard_specs=)``, ``io.load_checkpoint(mesh=)``,
``fault.shard_ckpt.plan_restore``) against the JAX package's format.

A 4-rank gloo world trains a ZeRO Adam program on a dp4 mesh and saves
it, each rank writing the accumulator shards it owns; a 2-rank world
restores it onto dp2, the pieces re-sliced, and must hold every variable
bit for bit.  The JAX package, on 4 of the 8 virtual devices of
``tests/conftest.py``, saves its own dp4 ZeRO checkpoint, which the
port restores bit for bit without a mesh and onto dp2; and it restores
the port's dp4 checkpoint onto its own dp2 mesh bit for bit.
"""

import numpy as np
import pytest

import jax

import paddle_tpu as fluid
import paddle_tpu.layers as layers
from paddle_tpu.framework import unique_name_scope

import torch_worlds
import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import persistable_names, to_numpy


def _program():
    main, startup = fluid.Program(), fluid.Program()
    with unique_name_scope("mc"), fluid.program_guard(main, startup):
        x = layers.data(name="img", shape=[16, 32], append_batch_size=False)
        y = layers.data(name="label", shape=[16, 1], dtype="int64",
                        append_batch_size=False)
        h = layers.fc(input=x, size=64, act="relu")
        pred = layers.fc(input=h, size=8, act="softmax")
        loss = layers.mean(layers.cross_entropy(input=pred, label=y))
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, loss


def _feeds(n):
    rng = np.random.RandomState(0)
    return [{"img": rng.rand(16, 32).astype("float32"),
             "label": rng.randint(0, 8, (16, 1)).astype("int64")}
            for _ in range(n)]


def _jax_mesh_checkpoint(main, startup, loss, dirname):
    """The JAX package's dp4 ZeRO run, saved with ``mesh=``; returns its
    state as numpy."""
    from paddle_tpu.parallel import ParallelExecutor
    from paddle_tpu.parallel.mesh import make_mesh
    mesh = make_mesh((4,), ("data",), devices=jax.devices()[:4])
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor()
        exe.run(startup)
        pexe = ParallelExecutor(main_program=main, mesh=mesh, zero=True)
        for f in _feeds(2):
            pexe.run(feed=f, fetch_list=[loss.name])
        fluid.io.save_checkpoint(pexe, dirname, main, step=3, scope=scope,
                                 mesh=mesh,
                                 shard_specs=pexe.zero_plan.checkpoint_specs())
    names = persistable_names(pt.Program.from_dict(main.to_dict()))
    return {n: np.asarray(scope.find_var(n)) for n in names}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_ckpt")
    send_w4, saving = torch_worlds.spawn_world(torch_worlds.ckpt_save, 4,
                                               root / "w4")
    send_w2, restoring = torch_worlds.spawn_world(torch_worlds.multi, 2,
                                                  root / "w2")
    main, startup, loss = _program()
    jscope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=jscope)
    names = persistable_names(pt.Program.from_dict(main.to_dict()))
    state = {n: np.array(np.asarray(jscope.find_var(n))) for n in names}
    port_dir, jax_dir = str(root / "port"), str(root / "jax")
    case = {"program": main.to_dict(), "state": state, "feeds": _feeds(2),
            "fetch": [loss.name], "mesh": ((4,), ("data",)),
            "dir": port_dir}
    send_w4(case)
    jax_state = _jax_mesh_checkpoint(main, startup, loss, jax_dir)
    saved = saving()
    send_w2(
        [("ckpt_restore", dict(case, mesh=((2,), ("data",)),
                               feeds=_feeds(1), manager=True)),
         ("ckpt_restore", dict(case, mesh=((2,), ("data",)), dir=jax_dir,
                               feeds=())),
         ("ckpt_save_async", dict(case, mesh=((2,), ("data",)),
                                  dir=str(root / "async"),
                                  feeds=_feeds(3)))])
    restored = restoring()
    return {"main": main, "loss": loss, "saved": saved,
            "restored": restored[0], "jax_restored": restored[1],
            "async": restored[2], "async_dir": str(root / "async"),
            "jax_state": jax_state, "port_dir": port_dir,
            "jax_dir": jax_dir}


def _assert_bit_equal(got, want):
    assert sorted(got) == sorted(want)
    for n in want:
        a, b = np.asarray(got[n]), np.asarray(want[n])
        assert a.shape == b.shape and a.dtype == b.dtype, n
        assert a.tobytes() == b.tobytes(), n


def test_each_rank_writes_the_shards_it_owns(ckpts):
    from paddle_tpu_torch.fault import shard_ckpt
    topo = shard_ckpt.read_manifest(ckpts["saved"]["path"])["topology"]
    assert topo["mesh_shape"] == [4] and topo["processes"] == 4
    split = {n for n, r in topo["shards"].items() if r["num_shards"] == 4}
    assert split == set(ckpts["saved"]["specs"]) and split
    assert all("moment" in n for n in split)
    assert not shard_ckpt.validate_topology(
        shard_ckpt.read_manifest(ckpts["saved"]["path"]))


def test_dp4_checkpoint_restores_on_dp2_bit_exact(ckpts):
    got = ckpts["restored"]
    assert got["step"] == 7
    _assert_bit_equal(got["state"], ckpts["saved"]["state"])
    # the accumulators land split over dp2, a half each
    for name in got["plan"]:
        assert got["placements"][name] == [0], name
        assert got["local_shapes"][name][0] * 2 == \
            got["state"][name].shape[0]
    assert np.isfinite(np.asarray(got["fetches"][0][0])).all()


def test_checkpoint_manager_on_a_mesh(ckpts):
    """``CheckpointManager(mesh=, shard_specs=)`` saves on dp4 (rank 0
    commits and collects) and ``restore_latest()`` onto dp2 holds the
    saved state bit for bit."""
    got = ckpts["restored"]
    assert got["manager_step"] == 9
    _assert_bit_equal(got["manager_state"], ckpts["saved"]["state"])


def test_save_async_on_a_mesh_while_the_ranks_step(ckpts):
    """``CheckpointManager(mesh=).save_async`` on dp2: the ranks take two
    more steps while the writer thread is held, and the commit at
    ``wait_pending()`` holds the state of the save point bit for bit.
    Every collective of the save runs on the thread that steps (two
    threads would issue theirs in different orders on different
    ranks)."""
    from paddle_tpu_torch.fault import shard_ckpt
    got = ckpts["async"]
    assert got["collective_threads"] == {"MainThread"}
    assert got["pending_while_stepping"]
    assert got["path"] == got["future"] and got["path"].endswith("ckpt-5")
    assert not shard_ckpt.validate_topology(
        shard_ckpt.read_manifest(got["path"]))
    scope = pt.Scope()
    step = pt.io.load_checkpoint(pt.Executor(pt.CPUPlace()),
                                 ckpts["async_dir"], scope=scope)
    assert step == 5
    _assert_bit_equal({n: to_numpy(v) for n, v in scope.items()},
                      got["state"])
    assert len(got["fetches"]) == 2
    assert all(np.isfinite(np.asarray(f[0])).all() for f in got["fetches"])
    assert any(got["after"][n].tobytes() != got["state"][n].tobytes()
               for n in got["state"])


def test_a_jax_package_mesh_checkpoint_restores_in_the_port(ckpts):
    """The JAX package's dp4 ZeRO checkpoint: without a mesh (one
    process, every var whole) and onto a dp2 mesh, bit for bit."""
    scope = pt.Scope()
    step = pt.io.load_checkpoint(pt.Executor(pt.CPUPlace()),
                                 ckpts["jax_dir"], scope=scope)
    assert step == 3
    whole = {n: to_numpy(v) for n, v in scope.items()}
    want = {n: v.view(np.uint16) if v.dtype.name == "bfloat16" else v
            for n, v in ckpts["jax_state"].items()}
    _assert_bit_equal(whole, want)
    _assert_bit_equal(ckpts["jax_restored"]["state"], want)


def test_the_jax_package_restores_the_ports_checkpoint(ckpts):
    """The port's dp4 checkpoint onto the JAX package's dp2 mesh."""
    from paddle_tpu.parallel.mesh import make_mesh
    mesh = make_mesh((2,), ("data",), devices=jax.devices()[:2])
    scope = fluid.Scope()
    step = fluid.io.load_checkpoint(fluid.Executor(), ckpts["port_dir"],
                                    ckpts["main"], scope=scope, mesh=mesh)
    assert step == 7
    got = {n: np.asarray(scope.find_var(n)) for n in ckpts["saved"]["state"]}
    _assert_bit_equal(got, ckpts["saved"]["state"])


def test_plan_restore_refuses_a_mesh_without_the_axis(ckpts):
    """A restore plan onto a mesh that lacks the saved axis raises
    ``ReshardError`` before any shard is read, with the JAX package's
    diagnostics."""
    from paddle_tpu.fault import shard_ckpt as jsc
    from paddle_tpu.parallel.mesh import make_mesh
    from paddle_tpu_torch.fault import shard_ckpt
    topo = shard_ckpt.read_manifest(ckpts["saved"]["path"])["topology"]

    class Mesh:     # plan_restore reads the axes' names and sizes only
        mesh_dim_names, shape = ("model",), (2,)

    with pytest.raises(shard_ckpt.ReshardError) as got:
        shard_ckpt.plan_restore(topo, Mesh())
    with pytest.raises(jsc.ReshardError) as want:
        jsc.plan_restore(topo, make_mesh((2,), ("model",),
                                         devices=jax.devices()[:2]))
    assert str(got.value) == str(want.value)

    class Dp2:
        mesh_dim_names, shape = ("data",), (2,)

    plan = shard_ckpt.plan_restore(topo, Dp2())
    assert plan == jsc.plan_restore(topo, make_mesh(
        (2,), ("data",), devices=jax.devices()[:2]))
