"""The port's master (``paddle_tpu_torch.parallel.master``): the JAX
package's task-lease and replica-lease tests run against the port
(``TestMasterService``, ``TestStaleLeases``, ``TestMasterRPCRetry``,
``TestReplicaRegistry``, ``TestMasterNetwork``, ``TestCloudReader``), and
the two packages against each other: either package's ``MasterClient``
against the other's ``MasterServer`` gives the replies the same call
sequence gets within one package, a snapshot written by either recovers
in the other, and the reference's fault-tolerance drill (a trainer leases
recordio tasks, dies holding one, the master re-leases it after its
timeout, a restarted trainer resumes from its checkpoint) runs in
subprocesses on the port.

Tolerance: the drill's final ``w``, ``b`` equal the port's uninterrupted
run bit for bit and the JAX package's within ``rtol = 1e-6`` (torch and
XLA sum in different orders).  Every server is shut down in a
``finally``, every failpoint cleared, every wait bounded."""

import json
import os
import pickle
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from paddle_tpu.parallel import master as jax_master
from paddle_tpu_torch.fault import FaultInjected, RetryError, RetryPolicy, \
    chaos
from paddle_tpu_torch.parallel import master as torch_master
from paddle_tpu_torch.parallel.master import (MasterClient, MasterServer,
                                              MasterService, Task,
                                              partition_files)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRILL_RTOL = 1e-6


@pytest.fixture(autouse=True)
def _clear_chaos():
    chaos.clear()
    yield
    chaos.clear()


class TestMasterService:
    def test_lease_finish(self):
        tasks = partition_files([f"f{i}" for i in range(4)])
        m = MasterService(tasks, timeout=60)
        got = []
        while True:
            t = m.get_task()
            if t is None:
                break
            got.append(t)
            assert m.task_finished(t.id, t.epoch)
        assert len(got) == 4
        assert m.all_done()

    def test_timeout_requeues_and_drops(self):
        m = MasterService([Task(0, ["a"])], timeout=0.05, failure_max=2)
        t1 = m.get_task()
        assert t1 is not None
        e1 = t1.epoch  # snapshot: the lease epoch this holder was given
        time.sleep(0.08)
        t2 = m.get_task()  # lease expired -> requeued (failure 1)
        assert t2 is not None and t2.id == 0 and t2.epoch != e1
        # stale epoch report from the dead holder is rejected
        assert not m.task_finished(0, epoch=e1)
        time.sleep(0.08)
        assert m.get_task() is None  # second failure -> dropped
        assert m.stats()["dropped"] == 1
        assert m.all_done()

    def test_snapshot_recover(self, tmp_path):
        snap = str(tmp_path / "master.json")
        m = MasterService(partition_files(["a", "b", "c"]), timeout=60,
                          snapshot_path=snap)
        t = m.get_task()
        m.task_finished(t.id, t.epoch)
        m.get_task()  # leave one pending
        # master dies; a new one recovers: pending returns to todo
        m2 = MasterService(timeout=60, snapshot_path=snap)
        st = m2.stats()
        assert st["done"] == 1 and st["pending"] == 0 and st["todo"] == 2

    def test_concurrent_trainers(self):
        tasks = partition_files([f"f{i}" for i in range(50)])
        m = MasterService(tasks, timeout=60)
        done = []
        lock = threading.Lock()

        def trainer():
            while True:
                t = m.get_task()
                if t is None:
                    return
                with lock:
                    done.append(t.id)
                m.task_finished(t.id, t.epoch)

        threads = [threading.Thread(target=trainer) for _ in range(8)]
        [t.start() for t in threads]
        [t.join() for t in threads]
        assert sorted(done) == list(range(50))
        assert m.all_done()

class TestStaleLeases:
    def test_stale_task_failed_ignored(self):
        m = MasterService(partition_files(["a"]), timeout=60)
        t_old = m.get_task()
        e_old = t_old.epoch  # in-process service aliases Task objects:
        old_id = t_old.id    # snapshot what the dead holder knew
        # evict the holder: force its lease to expire, then re-lease
        m.pending[old_id] = (m.pending[old_id][0], 0.0)
        t_new = m.get_task()
        assert t_new is not None and t_new.epoch != e_old
        e_new = t_new.epoch
        # dead holder reports failure with its stale epoch: must be
        # IGNORED — the new lease stays pending, no duplicate in todo
        assert m.task_failed(old_id, epoch=e_old) is False
        st = m.stats()
        assert st["pending"] == 1 and st["todo"] == 0
        assert m.task_finished(t_new.id, e_new) is True

    def test_requeue_bumps_epoch_rejecting_late_finish(self):
        m = MasterService([Task(0, ["a"])], timeout=0.01, failure_max=10)
        t = m.get_task()
        e_leased = t.epoch   # epoch the (about to be evicted) holder saw
        time.sleep(0.03)
        m.all_done()  # triggers _requeue_timeouts; task back in todo
        st = m.stats()
        assert st["todo"] == 1 and st["pending"] == 0
        # late finish from the evicted holder: rejected (not in pending)
        assert m.task_finished(0, epoch=e_leased) is False
        # even the requeued task's epoch moved past the evicted lease
        assert m.todo[0].epoch > e_leased

    def test_heartbeat_reclaims_dead_trainer_leases(self):
        m = MasterService(partition_files(["a", "b"]), timeout=60,
                          heartbeat_timeout=0.05)
        ta = m.get_task(trainer_id="A")
        assert ta is not None
        e_a = ta.epoch
        m.heartbeat("A")     # A opts into heartbeat eviction...
        time.sleep(0.1)      # ...then goes silent past the window
        m.heartbeat("B")
        # A's lease was reclaimed well before the 60s lease timeout
        st = m.stats()
        assert st["pending"] == 0 and st["todo"] == 2
        tb = m.get_task(trainer_id="B")
        assert tb is not None
        # A's late report is rejected by the epoch bump
        assert m.task_finished(ta.id, epoch=e_a) is False

    def test_no_heartbeat_opt_in_means_no_heartbeat_eviction(self):
        """A trainer that only leases (never heartbeats) must not be
        declared dead for working longer than the heartbeat window —
        its lease is governed by the lease timeout alone."""
        m = MasterService(partition_files(["a"]), timeout=60,
                          heartbeat_timeout=0.05)
        t = m.get_task(trainer_id="slowpoke")
        time.sleep(0.1)      # longer than heartbeat_timeout
        m.heartbeat("other")
        assert m.stats()["pending"] == 1          # lease intact
        assert m.task_finished(t.id, t.epoch) is True


class TestMasterRPCRetry:
    def _serve(self, tasks):
        svc = MasterService(tasks, timeout=60)
        server = MasterServer(svc, port=0)
        server.start_background()
        return svc, server, f"{server.addr[0]}:{server.addr[1]}"

    def test_injected_rpc_faults_are_retried(self):
        svc, server, addr = self._serve(partition_files(["a", "b"]))
        try:
            client = MasterClient(
                addr, retry=RetryPolicy(max_attempts=5, base_delay=0.001,
                                        jitter=0,
                                        retryable=(ConnectionError,
                                                   TimeoutError, OSError,
                                                   FaultInjected)))
            chaos.inject("master.rpc", times=2)  # two transient faults
            t = client.get_task()
            assert t is not None
            assert client.task_finished(t.id, t.epoch) is True
            client.close()
        finally:
            server.shutdown()

    def test_client_survives_master_restart(self):
        svc, server, addr = self._serve(partition_files(["a", "b"]))
        host, port = server.addr
        client = MasterClient(
            addr, retry=RetryPolicy(max_attempts=8, base_delay=0.05,
                                    jitter=0))
        t1 = client.get_task()
        assert t1 is not None
        # master dies and comes back on the same port (state survives:
        # same in-process service, fresh server)
        server.shutdown()
        server2 = MasterServer(svc, host=host, port=port)
        server2.start_background()
        try:
            # the client's socket is dead; _call must reconnect + retry
            assert client.task_finished(t1.id, t1.epoch) is True
            t2 = client.get_task()
            assert t2 is not None and t2.id != t1.id
            client.close()
        finally:
            server2.shutdown()

    def test_exhausted_retries_surface(self):
        svc, server, addr = self._serve(partition_files(["a"]))
        server.shutdown()  # nobody listening anymore
        # construction is lazy (restart-safe); the RPC itself exhausts
        # its retries and surfaces a RetryError
        client = MasterClient(
            addr, retry=RetryPolicy(max_attempts=2, base_delay=0.001,
                                    jitter=0))
        with pytest.raises(RetryError):
            client.get_task()

    def test_construction_while_master_down(self):
        """The client dials lazily: constructing it while the master is
        briefly down (trainer resume during a master restart) works."""
        svc = MasterService(partition_files(["a"]), timeout=60)
        server = MasterServer(svc, port=0)
        host, port = server.addr
        server.start_background()
        server.shutdown()            # master not up yet
        client = MasterClient(
            (host, port), retry=RetryPolicy(max_attempts=10,
                                            base_delay=0.05, jitter=0))
        server2 = MasterServer(svc, host=host, port=port)
        server2.start_background()
        try:
            t = client.get_task()
            assert t is not None
            client.close()
        finally:
            server2.shutdown()

    def test_background_heartbeats_keep_lease_alive(self):
        svc = MasterService(partition_files(["a"]), timeout=60,
                            heartbeat_timeout=0.2)
        server = MasterServer(svc, port=0)
        server.start_background()
        try:
            client = MasterClient(
                f"{server.addr[0]}:{server.addr[1]}", trainer_id="hb")
            client.start_heartbeats(interval=0.05)
            t = client.get_task()
            time.sleep(0.5)          # >> heartbeat window
            assert svc.stats()["pending"] == 1   # lease kept alive
            assert client.task_finished(t.id, t.epoch) is True
            client.close()
        finally:
            server.shutdown()

    def test_trainer_id_flows_through_rpc(self):
        svc, server, addr = self._serve(partition_files(["a"]))
        try:
            client = MasterClient(addr, trainer_id="t-0")
            assert client.heartbeat() is True
            t = client.get_task()
            assert t is not None
            assert svc.stats()["trainers"] == 1
            client.close()
        finally:
            server.shutdown()

class TestReplicaRegistry:
    """MasterService's lease table re-aimed at serving replicas."""

    def test_register_renew_expire_cycle(self):
        svc = MasterService(replica_ttl=0.2)
        lease = svc.register_replica("a", "127.0.0.1:1000")
        assert lease == {"epoch": 1, "ttl": 0.2}
        assert [r["id"] for r in svc.list_replicas()] == ["a"]
        # renewing keeps it alive past the original TTL
        for _ in range(3):
            time.sleep(0.1)
            assert svc.renew_replica("a") is True
        assert svc.list_replicas()
        # silence expires it — and a late renew is refused
        time.sleep(0.3)
        assert svc.list_replicas() == []
        assert svc.renew_replica("a") is False

    def test_stale_epoch_renew_rejected(self):
        svc = MasterService(replica_ttl=5.0)
        e1 = svc.register_replica("a", "127.0.0.1:1000")["epoch"]
        e2 = svc.register_replica("a", "127.0.0.1:2000")["epoch"]
        assert e2 == e1 + 1
        # the old incarnation's renew must not keep the new lease alive
        assert svc.renew_replica("a", epoch=e1) is False
        assert svc.renew_replica("a", epoch=e2) is True
        # the re-registration's address won
        assert svc.list_replicas()[0]["addr"] == "127.0.0.1:2000"

    def test_deregister_is_immediate(self):
        svc = MasterService(replica_ttl=60.0)
        svc.register_replica("a", "127.0.0.1:1000")
        assert svc.deregister_replica("a") is True
        assert svc.list_replicas() == []
        assert svc.deregister_replica("a") is False

    def test_lease_expire_failpoint_forces_loss(self):
        svc = MasterService(replica_ttl=60.0)
        svc.register_replica("a", "127.0.0.1:1000")
        with chaos.scoped("master.lease.expire", error=True, times=1):
            assert svc.renew_replica("a") is False
        assert svc.list_replicas() == []
        # re-registration recovers (the replica-side rejoin path)
        svc.register_replica("a", "127.0.0.1:1000")
        assert svc.renew_replica("a") is True

    def test_replica_leases_not_snapshotted(self, tmp_path):
        """Leases are ephemeral by design: a restarted master must not
        resurrect replicas it cannot know are alive."""
        snap = str(tmp_path / "master.json")
        svc = MasterService(replica_ttl=60.0, snapshot_path=snap)
        svc.register_replica("a", "127.0.0.1:1000")
        svc.get_task()  # force a snapshot write
        with open(snap) as f:
            assert "replicas" not in json.load(f)
        svc2 = MasterService(replica_ttl=60.0, snapshot_path=snap)
        assert svc2.list_replicas() == []

class TestMasterNetwork:
    def test_server_client_roundtrip(self, tmp_path):
        files = []
        for i in range(4):
            p = tmp_path / f"part-{i}"
            p.write_text("x")
            files.append(str(p))
        svc = MasterService(partition_files(files), timeout=5.0)
        server = MasterServer(svc, port=0)
        server.start_background()
        try:
            client = MasterClient(server.addr)
            seen = []
            while True:
                t = client.get_task()
                if t is None:
                    break
                seen.extend(t.chunks)
                assert client.task_finished(t.id, t.epoch)
            assert sorted(seen) == sorted(files)
            assert client.all_done()
            stats = client.stats()
            assert stats["done"] == 4 and stats["todo"] == 0
            client.close()
        finally:
            server.shutdown()

    def test_failed_task_requeues(self, tmp_path):
        svc = MasterService(partition_files(["a", "b"]), timeout=60.0,
                            failure_max=3)
        server = MasterServer(svc, port=0)
        server.start_background()
        try:
            client = MasterClient(server.addr)
            t = client.get_task()
            assert client.task_failed(t.id, t.epoch)
            ids = set()
            while True:
                t2 = client.get_task()
                if t2 is None:
                    break
                ids.add(t2.id)
                client.task_finished(t2.id, t2.epoch)
            assert t.id in ids  # failed task came back
            client.close()
        finally:
            server.shutdown()


class TestCloudReader:
    def test_reads_all_tasks_via_master(self, tmp_path):
        """cloud_reader drains record files leased from the master service
        (reference v2 cloud_reader over the etcd master client)."""
        from paddle_tpu_torch.reader.creator import cloud_reader
        from paddle_tpu_torch.recordio_writer import \
            convert_reader_to_recordio_file

        all_samples = set()
        paths = []
        for i in range(3):
            p = str(tmp_path / f"shard-{i}.recordio")

            def samples(i=i):
                for j in range(5):
                    yield (f"s{i}-{j}",)

            convert_reader_to_recordio_file(p, samples)
            all_samples.update(f"s{i}-{j}" for j in range(5))
            paths.append(p)

        svc = MasterService(partition_files(paths), timeout=30.0)
        server = MasterServer(svc, port=0)
        server.start_background()
        try:
            addr = f"{server.addr[0]}:{server.addr[1]}"
            got = {s[0] for s in cloud_reader(addr)()}
            assert got == all_samples
            assert svc.stats()["done"] == 3
        finally:
            server.shutdown()


# ---------------------------------------------------------------------------
# across the packages: wire format, snapshot file, the FT drill
# ---------------------------------------------------------------------------

PKGS = {"jax": jax_master, "torch": torch_master}


def _rpc_sequence(client):
    """One call sequence over every RPC of the wire format; returns the
    replies as plain JSON values (``expires_in`` dropped: a clock)."""
    out = []
    t = client.get_task()
    out.append(("get_task", t.to_dict()))
    out.append(("heartbeat", client.heartbeat()))
    out.append(("task_finished", client.task_finished(t.id, t.epoch)))
    out.append(("task_finished again", client.task_finished(t.id, t.epoch)))
    t2 = client.get_task()
    out.append(("get_task 2", t2.to_dict()))
    out.append(("task_failed stale", client.task_failed(t2.id, t2.epoch + 7)))
    out.append(("task_failed", client.task_failed(t2.id, t2.epoch)))
    out.append(("stats", client.stats()))
    out.append(("register", client.register_replica(
        "r0", "127.0.0.1:1", ttl=30.0, meta={"pid": 1})))
    out.append(("register again", client.register_replica(
        "r0", "127.0.0.1:2", ttl=30.0)))
    out.append(("renew", client.renew_replica("r0", epoch=2)))
    out.append(("renew stale", client.renew_replica("r0", epoch=1)))
    out.append(("list", [{k: v for k, v in r.items() if k != "expires_in"}
                         for r in client.list_replicas()]))
    out.append(("deregister", client.deregister_replica("r0")))
    out.append(("deregister again", client.deregister_replica("r0")))
    while True:
        t = client.get_task()
        if t is None:
            break
        out.append(("drain", t.to_dict(),
                    client.task_finished(t.id, t.epoch)))
    out.append(("all_done", client.all_done()))
    out.append(("reset_pass", client.reset_pass()))
    out.append(("stats 2", client.stats()))
    try:
        client._call("no_such_method")
    except Exception as e:
        out.append(("error", type(e).__name__, str(e)))
    return json.loads(json.dumps(out))


def _serve_and_run(client_pkg, server_pkg):
    svc = PKGS[server_pkg].MasterService(
        PKGS[server_pkg].partition_files(["a", "b", "c", "d"]), timeout=60)
    server = PKGS[server_pkg].MasterServer(svc, port=0)
    server.start_background()
    client = PKGS[client_pkg].MasterClient(
        f"{server.addr[0]}:{server.addr[1]}", trainer_id="t0")
    try:
        return _rpc_sequence(client)
    finally:
        client.close()
        server.shutdown()


@pytest.mark.parametrize("client_pkg,server_pkg",
                         [("torch", "jax"), ("jax", "torch")])
def test_clients_and_servers_cross_packages(client_pkg, server_pkg):
    """Either package's client against the other's server gets, call by
    call, what the same sequence gets within one package: the wire
    format (JSON lines, the ``_trace`` hop) is one."""
    crossed = _serve_and_run(client_pkg, server_pkg)
    assert crossed == _serve_and_run(server_pkg, server_pkg)
    assert crossed == _serve_and_run(client_pkg, client_pkg)
    assert crossed[-1][0] == "error" and "MasterError" in crossed[-1][1]


def _snapshot_ops(pkg, path):
    m = PKGS[pkg].MasterService(
        PKGS[pkg].partition_files(["a", "b", "c", "d", "e"]), timeout=60,
        failure_max=2, snapshot_path=path)
    t = m.get_task()
    m.task_finished(t.id, t.epoch)
    t = m.get_task()
    m.task_failed(t.id, t.epoch)
    t = m.get_task()
    m.task_failed(t.id, t.epoch)
    m.get_task()                  # left pending: recovers into todo
    return m


@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
def test_snapshot_recovers_across_packages(tmp_path, writer, reader):
    """A snapshot one package writes is the other's, byte for byte, and
    recovers there to the same queues."""
    w_path, r_path = str(tmp_path / "w.json"), str(tmp_path / "r.json")
    _snapshot_ops(writer, w_path)
    _snapshot_ops(reader, r_path)
    with open(w_path, "rb") as f, open(r_path, "rb") as g:
        assert f.read() == g.read()
    got = PKGS[reader].MasterService(timeout=60, snapshot_path=w_path)
    want = PKGS[writer].MasterService(timeout=60, snapshot_path=r_path)
    assert got.stats() == want.stats()
    for q in ("todo", "done", "failed_drop"):
        assert [t.to_dict() for t in getattr(got, q)] == \
            [t.to_dict() for t in getattr(want, q)]
    # and the recovered master serves on: every task leases and finishes
    n = 0
    while (t := got.get_task()) is not None:
        assert got.task_finished(t.id, t.epoch)
        n += 1
    assert n == want.stats()["todo"] and got.all_done()


DRILL_WORKER = r'''
"""FT-drill worker on the port: lease recordio tasks from the master,
train a linear model from fixed weights, checkpoint after every finished
task; with --die-after N, lease the (N+1)-th task and crash hard."""
import argparse
import os
import pickle
import sys
import time

import numpy as np

import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, layers
from paddle_tpu_torch.parallel.master import MasterClient
from paddle_tpu_torch.recordio_writer import RecordIOScanner

ap = argparse.ArgumentParser()
ap.add_argument("--master", required=True)
ap.add_argument("--ckpt", required=True)
ap.add_argument("--log", required=True)
ap.add_argument("--init", required=True)
ap.add_argument("--die-after", type=int, default=-1)
args = ap.parse_args()

main, startup = pt.Program(), pt.Program()
with pt.program_guard(main, startup):
    x = layers.data("x", shape=[4], dtype="float32")
    y = layers.data("y", shape=[1], dtype="float32")
    pred = layers.fc(x, 1, param_attr="w", bias_attr="b")
    loss = layers.reduce_mean(layers.square_error_cost(pred, y))
    pt.optimizer.SGD(learning_rate=0.05).minimize(loss)
exe = pt.Executor(pt.CPUPlace())
exe.run(startup)
init = np.load(args.init)
scope = pt.global_scope()
for name in ("w", "b"):
    scope.set_var(name, convert.to_tensor(init[name], "cpu"))
done = 0
if os.path.exists(os.path.join(args.ckpt, "latest")):
    done = pt.io.load_checkpoint(exe, args.ckpt, main_program=main)


def log(msg):
    with open(args.log, "a") as f:
        f.write(msg + "\n")


client = MasterClient(args.master, timeout=30.0)
while True:
    task = client.get_task()
    if task is None:
        if client.all_done():
            break
        time.sleep(0.05)
        continue
    if args.die_after >= 0 and done >= args.die_after:
        log(f"leased-then-died {task.chunks[0]}")
        os._exit(9)  # hard crash mid-task: no finish, no checkpoint
    rows = [pickle.loads(rec) for path in task.chunks
            for rec in RecordIOScanner(path)]
    xv = np.stack([r[0] for r in rows]).astype("float32")
    yv = np.stack([r[1] for r in rows]).astype("float32")
    exe.run(main, feed={"x": xv, "y": yv}, fetch_list=[loss])
    if not client.task_finished(task.id, task.epoch):
        log(f"finish-rejected {task.chunks[0]}")
        sys.exit(3)
    done += 1
    pt.io.save_checkpoint(exe, args.ckpt, main_program=main, step=done)
    log(f"finished {task.chunks[0]}")
client.close()
np.savez(os.path.join(args.ckpt, "final.npz"),
         w=convert.to_numpy(scope.find_var("w")),
         b=convert.to_numpy(scope.find_var("b")))
log("all-done")
'''


def _linear_run(pkg, init, order):
    """The drill's model trained uninterrupted over ``order`` in this
    process, in ``pkg`` ("torch": the port on the CPU, "jax": the JAX
    package); returns the final ``w``, ``b``."""
    if pkg == "torch":
        import paddle_tpu_torch as P
        from paddle_tpu_torch import convert
        from paddle_tpu_torch.recordio_writer import RecordIOScanner
        exe = P.Executor(P.CPUPlace())
    else:
        import paddle_tpu as P
        from paddle_tpu.recordio_writer import RecordIOScanner
        exe = P.Executor()
    main, startup = P.Program(), P.Program()
    with P.program_guard(main, startup):
        x = P.layers.data("x", shape=[4], dtype="float32")
        y = P.layers.data("y", shape=[1], dtype="float32")
        pred = P.layers.fc(x, 1, param_attr="w", bias_attr="b")
        loss = P.layers.reduce_mean(P.layers.square_error_cost(pred, y))
        P.optimizer.SGD(learning_rate=0.05).minimize(loss)
    scope = P.Scope()
    with P.scope_guard(scope):
        exe.run(startup)
        for name in ("w", "b"):
            scope.set_var(name, convert.to_tensor(init[name], "cpu")
                          if pkg == "torch" else init[name])
        for path in order:
            rows = [pickle.loads(r) for r in RecordIOScanner(path)]
            exe.run(main, feed={
                "x": np.stack([r[0] for r in rows]).astype("float32"),
                "y": np.stack([r[1] for r in rows]).astype("float32")},
                fetch_list=[loss])
        if pkg == "torch":
            return {n: convert.to_numpy(scope.find_var(n))
                    for n in ("w", "b")}
        return {n: np.asarray(scope.find_var(n)) for n in ("w", "b")}


def test_fault_tolerance_drill_in_subprocesses(tmp_path):
    """The reference's drill (``tests/test_distributed_aux.py``) on the
    port: trainer A finishes 2 tasks, leases a third and dies hard; the
    master requeues that task at its lease timeout with a new epoch (A's
    late finish is refused); a restarted trainer restores its latest
    checkpoint and drains the rest.  Its final ``w``, ``b`` equal an
    uninterrupted port run over the same task order bit for bit, and the
    JAX package's within ``DRILL_RTOL``."""
    from paddle_tpu_torch.recordio_writer import \
        convert_reader_to_recordio_file

    rng = np.random.RandomState(0)
    w_true = rng.randn(4, 1).astype("float32")
    init = {"w": (rng.randn(4, 1) * 0.1).astype("float32"),
            "b": np.zeros((1,), "float32")}
    init_path = str(tmp_path / "init.npz")
    np.savez(init_path, **init)
    paths = []
    for i in range(4):
        p = str(tmp_path / f"shard-{i}.recordio")
        xs = rng.rand(8, 4).astype("float32")
        ys = xs @ w_true
        convert_reader_to_recordio_file(
            p, lambda xs=xs, ys=ys: ((xs[j], ys[j]) for j in range(8)))
        paths.append(p)
    # the lease timeout outlasts a live task's step + checkpoint by far;
    # phase 2 waits out the dead trainer's lease
    svc = MasterService(partition_files(paths), timeout=4.0, failure_max=5)
    server = MasterServer(svc, port=0)
    server.start_background()
    worker = tmp_path / "worker.py"
    worker.write_text(DRILL_WORKER)
    ckpt, log = tmp_path / "ckpt", tmp_path / "events.log"
    ckpt.mkdir()
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("PADDLE_TPU_CHAOS", None)
    argv = [sys.executable, str(worker), "--master",
            f"{server.addr[0]}:{server.addr[1]}", "--ckpt", str(ckpt),
            "--log", str(log), "--init", init_path]
    try:
        a = subprocess.run(argv + ["--die-after", "2"], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=120)
        assert a.returncode == 9, (a.returncode, a.stderr[-2000:])
        events = log.read_text().splitlines()
        assert len([e for e in events if e.startswith("finished")]) == 2
        died_on = [e.split()[1] for e in events
                   if e.startswith("leased-then-died")][0]
        (held,) = [t for t, _ in svc.pending.values()]
        stale_epoch = held.epoch
        t0 = time.monotonic()
        b = subprocess.run(argv, cwd=REPO, env=env, capture_output=True,
                           text=True, timeout=120)
        assert b.returncode == 0, b.stderr[-2000:]
        # the dead trainer's lease ran out before its task came back
        assert time.monotonic() - t0 >= 0.5
        assert not svc.task_finished(held.id, stale_epoch)
        finished = [e.split()[1] for e in log.read_text().splitlines()
                    if e.startswith("finished")]
        assert sorted(finished) == sorted(paths)   # nothing lost
        assert died_on in finished[2:]             # re-leased and redone
        assert svc.stats()["done"] == 4
    finally:
        server.shutdown()
    got = np.load(ckpt / "final.npz")
    want = _linear_run("torch", init, finished)
    np.testing.assert_array_equal(got["w"], want["w"])
    np.testing.assert_array_equal(got["b"], want["b"])
    ref = _linear_run("jax", init, finished)
    np.testing.assert_allclose(got["w"], ref["w"], rtol=DRILL_RTOL)
    np.testing.assert_allclose(got["b"], ref["b"], rtol=DRILL_RTOL)
