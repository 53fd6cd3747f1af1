"""Fault-tolerant data-task dispatch service (the port's copy of
``paddle_tpu.parallel.master``; wire format and snapshot file are the
same, so either package's client works against the other's server).

The equivalent of the reference's Go master (``go/master/service.go``):
partition input files/chunks into tasks, lease them to trainers with a
timeout, recycle failed/timed-out tasks
(``checkTimeoutFunc`` :341, ``TaskFailed`` :455, ``processFailedTask``
:313, drop after ``failureMax``), and snapshot the queue state on every
mutation so a restarted master resumes where it left off (``snapshot``
:207 / ``recover`` :165 — etcd replaced by a local snapshot file; any
shared filesystem or object store works the same way).

In-process + thread-safe: multi-host tests drive it the way the Go tests
drive the in-memory store (``go/master/service_internal_test.go``).
"""

from __future__ import annotations

import json
import os
import threading
import time

from paddle_tpu_torch.obs import trace as _trace
from paddle_tpu_torch.obs.trace import span as _span

__all__ = ["Task", "MasterService", "partition_files",
           "MasterServer", "MasterClient", "MasterError"]

DEFAULT_TIMEOUT = 60.0
DEFAULT_FAILURE_MAX = 3
DEFAULT_REPLICA_TTL = 10.0


class Task:
    def __init__(self, task_id, chunks):
        self.id = task_id
        self.chunks = list(chunks)   # opaque work units (paths, ranges...)
        self.failures = 0
        self.epoch = 0               # lease epoch; stale reports rejected

    def to_dict(self):
        return {"id": self.id, "chunks": self.chunks,
                "failures": self.failures, "epoch": self.epoch}

    @staticmethod
    def from_dict(d):
        t = Task(d["id"], d["chunks"])
        t.failures = d["failures"]
        t.epoch = d["epoch"]
        return t


def partition_files(paths, chunks_per_task=1):
    """Files -> tasks (reference ``partition`` in service.go)."""
    tasks = []
    buf = []
    for p in sorted(paths):
        buf.append(p)
        if len(buf) == chunks_per_task:
            tasks.append(Task(len(tasks), buf))
            buf = []
    if buf:
        tasks.append(Task(len(tasks), buf))
    return tasks


class MasterService:
    def __init__(self, tasks=None, timeout=DEFAULT_TIMEOUT,
                 failure_max=DEFAULT_FAILURE_MAX, snapshot_path=None,
                 heartbeat_timeout=None, replica_ttl=DEFAULT_REPLICA_TTL):
        self._lock = threading.Lock()
        self.timeout = timeout
        self.failure_max = failure_max
        self.heartbeat_timeout = heartbeat_timeout
        self.replica_ttl = replica_ttl
        # serving-fleet discovery: replica_id -> lease record.  Leases
        # are deliberately ephemeral (never snapshotted): a restarted
        # master knows nothing about replica health, so replicas simply
        # re-register on their next heartbeat cycle.
        self._replicas = {}
        self.snapshot_path = snapshot_path
        self.todo = list(tasks or [])
        self.pending = {}            # task_id -> (Task, deadline)
        self.done = []
        self.failed_drop = []        # exceeded failure_max
        self._lease_owner = {}       # task_id -> trainer_id (when known)
        self._trainer_seen = {}      # trainer_id -> last heartbeat time
        # only trainers that OPTED IN by heartbeating are subject to
        # heartbeat eviction — a trainer that merely passes trainer_id
        # to get_task must not be declared dead for processing a task
        # longer than heartbeat_timeout
        self._heartbeaters = set()
        if snapshot_path and os.path.exists(snapshot_path):
            self._recover()
        else:
            self._snapshot()

    # -- client API (reference GetTask/TaskFinished/TaskFailed) ------------
    def get_task(self, trainer_id=None):
        """Lease a task; returns None when nothing is currently available
        (caller retries — tasks may return via timeout)."""
        with self._lock:
            if trainer_id is not None:
                self._trainer_seen[trainer_id] = time.time()
            self._requeue_timeouts()
            if not self.todo:
                return None
            task = self.todo.pop(0)
            task.epoch += 1
            self.pending[task.id] = (task, time.time() + self.timeout)
            if trainer_id is not None:
                self._lease_owner[task.id] = trainer_id
            self._snapshot()
            return task

    def heartbeat(self, trainer_id):
        """Trainer liveness ping.  With ``heartbeat_timeout`` set, leases
        held by a trainer that stops pinging are reclaimed promptly (at
        the next queue mutation) instead of waiting out the full lease
        timeout — the reference leaned solely on etcd lease TTLs here."""
        with self._lock:
            self._trainer_seen[trainer_id] = time.time()
            self._heartbeaters.add(trainer_id)
            self._requeue_timeouts()
            return True

    def task_finished(self, task_id, epoch=None):
        with self._lock:
            entry = self.pending.get(task_id)
            if entry is None:
                return False
            task, _ = entry
            if epoch is not None and epoch != task.epoch:
                return False  # stale lease report: current lease untouched
            del self.pending[task_id]
            self._lease_owner.pop(task_id, None)
            task.failures = 0  # reference: NumFailure resets on success
            self.done.append(task)
            self._snapshot()
            return True

    def task_failed(self, task_id, epoch=None):
        with self._lock:
            entry = self.pending.get(task_id)
            if entry is None:
                return False
            task, _ = entry
            if epoch is not None and epoch != task.epoch:
                return False  # stale lease report: current lease untouched
            del self.pending[task_id]
            self._lease_owner.pop(task_id, None)
            self._process_failed(task)
            self._snapshot()
            return True

    def all_done(self):
        with self._lock:
            self._requeue_timeouts()
            return not self.todo and not self.pending

    def reset_pass(self):
        """Re-seed the queue for a new data pass: finished tasks go back
        to todo (reference master restarts passes the same way when the
        dataset drains).  Call only when all_done() — a coordinator (e.g.
        cloud_reader's pass loop) drives this."""
        with self._lock:
            if self.todo or self.pending:
                return False
            # reference service.go: Todo = Done + Failed for the new pass
            for t in self.failed_drop:
                t.failures = 0
            self.todo = self.done + self.failed_drop
            self.done = []
            self.failed_drop = []
            self._snapshot()
            return True

    def stats(self):
        with self._lock:
            now = time.time()
            return {"todo": len(self.todo), "pending": len(self.pending),
                    "done": len(self.done),
                    "dropped": len(self.failed_drop),
                    "trainers": len(self._trainer_seen),
                    # expired-but-unpruned leases are NOT live replicas
                    "replicas": sum(1 for r in self._replicas.values()
                                    if r["expires"] >= now)}

    # -- serving-fleet discovery (lease-based replica health) -------------
    #
    # The trainer-side lease machinery above re-aimed at inference: a
    # serving replica registers its address on startup, renews the lease
    # on every heartbeat, and is dropped from the routing table the
    # moment the lease expires (a silent replica IS a dead replica, the
    # router never has to probe it).

    def register_replica(self, replica_id, addr, ttl=None, meta=None):
        """Enroll (or re-enroll) a serving replica at ``addr`` with a
        lease of ``ttl`` seconds.  Returns the lease terms; the replica
        must :meth:`renew_replica` within ``ttl`` or it is dropped from
        :meth:`list_replicas`.  Re-registering bumps the lease epoch
        (late renews from a previous incarnation are then rejected)."""
        ttl = float(ttl if ttl is not None else self.replica_ttl)
        if ttl <= 0:
            raise ValueError(f"replica ttl must be > 0, got {ttl}")
        with self._lock:
            prev = self._replicas.get(replica_id)
            epoch = (prev["epoch"] + 1) if prev else 1
            self._replicas[replica_id] = {
                "id": replica_id, "addr": str(addr),
                "meta": dict(meta or {}), "ttl": ttl,
                "expires": time.time() + ttl, "epoch": epoch,
            }
            return {"epoch": epoch, "ttl": ttl}

    def renew_replica(self, replica_id, epoch=None):
        """Heartbeat-renew a replica lease.  Returns False when the
        lease is unknown, already expired, or from a stale epoch — the
        replica is (or just became) invisible to the router and must
        re-register before taking traffic again."""
        from paddle_tpu_torch.fault import chaos
        try:
            # armed drill: the master force-expires this lease as if the
            # TTL ran out — the replica sees lease_lost while perfectly
            # alive, exactly the split-brain /readyz must surface
            chaos.fire("master.lease.expire", replica_id=replica_id)
        except chaos.FaultInjected:
            with self._lock:
                self._replicas.pop(replica_id, None)
            return False
        with self._lock:
            rec = self._replicas.get(replica_id)
            now = time.time()
            if rec is None or rec["expires"] < now or \
                    (epoch is not None and epoch != rec["epoch"]):
                if rec is not None and rec["expires"] < now:
                    del self._replicas[replica_id]
                return False
            rec["expires"] = now + rec["ttl"]
            return True

    def deregister_replica(self, replica_id):
        """Release a replica lease explicitly (the drain path of a
        rolling restart: the router stops routing BEFORE the replica
        stops accepting).  Returns False when the lease was already
        gone."""
        with self._lock:
            return self._replicas.pop(replica_id, None) is not None

    def list_replicas(self):
        """Live replicas (expired leases pruned), for router discovery:
        ``[{id, addr, meta, epoch, expires_in}, ...]``."""
        with self._lock:
            now = time.time()
            for rid in [rid for rid, rec in self._replicas.items()
                        if rec["expires"] < now]:
                del self._replicas[rid]
            return [{"id": rec["id"], "addr": rec["addr"],
                     "meta": dict(rec["meta"]), "epoch": rec["epoch"],
                     "expires_in": round(rec["expires"] - now, 3)}
                    for rec in self._replicas.values()]

    # -- internals ---------------------------------------------------------
    def _process_failed(self, task):
        task.failures += 1
        if task.failures >= self.failure_max:
            self.failed_drop.append(task)
        else:
            self.todo.append(task)

    def _requeue_timeouts(self):
        now = time.time()
        expired = [tid for tid, (_, dl) in self.pending.items() if dl < now]
        if self.heartbeat_timeout is not None:
            # leases of trainers that stopped heartbeating are reclaimed
            # without waiting out the full lease timeout
            dead = {t for t in self._heartbeaters
                    if now - self._trainer_seen.get(t, now)
                    > self.heartbeat_timeout}
            expired += [tid for tid, owner in self._lease_owner.items()
                        if owner in dead and tid not in expired
                        and tid in self.pending]
            for t in dead:
                self._trainer_seen.pop(t, None)
                self._heartbeaters.discard(t)
        # registry hygiene: trainer ids that neither hold leases nor
        # heartbeat within a generous horizon are forgotten, so a
        # long-lived master serving elastically scaled trainers (fresh
        # ids every restart) doesn't grow without bound
        horizon = max(self.heartbeat_timeout or 0.0, 10.0 * self.timeout)
        owners = set(self._lease_owner.values())
        for tid in [t for t, seen in self._trainer_seen.items()
                    if now - seen > horizon and t not in owners]:
            self._trainer_seen.pop(tid, None)
            self._heartbeaters.discard(tid)
        for tid in expired:
            task, _ = self.pending.pop(tid)
            self._lease_owner.pop(tid, None)
            # bump the epoch at eviction so a LATE task_finished /
            # task_failed from the evicted holder is rejected even if it
            # lands before the task is re-leased
            task.epoch += 1
            self._process_failed(task)
        if expired:
            self._snapshot()

    def _snapshot(self):
        if not self.snapshot_path:
            return
        state = {
            "todo": [t.to_dict() for t in self.todo],
            "pending": [t.to_dict() for t, _ in self.pending.values()],
            "done": [t.to_dict() for t in self.done],
            "dropped": [t.to_dict() for t in self.failed_drop],
        }
        tmp = self.snapshot_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, self.snapshot_path)

    def _recover(self):
        with open(self.snapshot_path) as f:
            state = json.load(f)
        # leases don't survive a master restart: pending -> todo
        self.todo = [Task.from_dict(d) for d in state["todo"]] + \
                    [Task.from_dict(d) for d in state["pending"]]
        self.pending = {}
        self.done = [Task.from_dict(d) for d in state["done"]]
        self.failed_drop = [Task.from_dict(d) for d in state["dropped"]]


# ---------------------------------------------------------------------------
# network layer: the go/cmd/master binary + trainer-side client analog
# (reference ``go/cmd/master/master.go`` serving Go net/rpc;
# ``python/paddle/v2/master/client.py`` ctypes client).  JSON-lines over
# TCP: {"method": ..., "params": {...}} -> {"result": ...}.
# ---------------------------------------------------------------------------

import socket
import socketserver


class _MasterRPCHandler(socketserver.StreamRequestHandler):
    def handle(self):
        svc = self.server.service
        for line in self.rfile:
            try:
                req = json.loads(line)
                method = req.get("method")
                params = req.get("params") or {}
                # trace-context hop: the caller's trace id rides the
                # frame as _trace — this RPC's server-side span joins
                # the calling trainer's timeline
                caller_trace = params.pop("_trace", None)
                with _trace.trace_context(caller_trace), \
                        _span("master.serve", method=str(method)):
                    result = self._dispatch(svc, method, params)
                resp = {"result": result}
            except Exception as e:  # surface errors to the client
                resp = {"error": str(e)}
            self.wfile.write((json.dumps(resp) + "\n").encode())
            self.wfile.flush()

    @staticmethod
    def _dispatch(svc, method, params):
        if method == "get_task":
            t = svc.get_task(params.get("trainer_id"))
            return t.to_dict() if t is not None else None
        if method == "heartbeat":
            return svc.heartbeat(params["trainer_id"])
        if method == "task_finished":
            return svc.task_finished(params["task_id"],
                                     params.get("epoch"))
        if method == "task_failed":
            return svc.task_failed(params["task_id"],
                                   params.get("epoch"))
        if method == "all_done":
            return svc.all_done()
        if method == "reset_pass":
            return svc.reset_pass()
        if method == "stats":
            return svc.stats()
        if method == "register_replica":
            return svc.register_replica(params["replica_id"],
                                        params["addr"],
                                        ttl=params.get("ttl"),
                                        meta=params.get("meta"))
        if method == "renew_replica":
            return svc.renew_replica(params["replica_id"],
                                     epoch=params.get("epoch"))
        if method == "deregister_replica":
            return svc.deregister_replica(params["replica_id"])
        if method == "list_replicas":
            return svc.list_replicas()
        if method == "ping":
            return "pong"
        raise ValueError(f"unknown method {method!r}")


class MasterServer:
    """Serve a MasterService over TCP (go master binary analog)."""

    def __init__(self, service, host="127.0.0.1", port=0):
        class _Srv(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Srv((host, port), _MasterRPCHandler)
        self._server.service = service
        self.addr = self._server.server_address

    def serve_forever(self):
        self._server.serve_forever()

    def start_background(self):
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self._server.shutdown()
        self._server.server_close()


class MasterError(RuntimeError):
    """The master executed the request and reported an error (NOT a
    transport failure — never retried)."""


class MasterClient:
    """Trainer-side client (reference ``go/pserver/client`` C ABI +
    ``python/paddle/v2/master/client.py``).

    Transport failures (connection reset, master restart, timeout) are
    retried under ``retry`` (a :class:`paddle_tpu_torch.fault.RetryPolicy`;
    default ``DEFAULT_RPC_POLICY``) with a fresh connection per attempt,
    so a flaky or briefly-restarting master no longer kills the trainer.
    Re-sent requests are at-least-once safe: every mutating method is
    idempotent under the lease epoch (a duplicate ``task_finished`` /
    ``task_failed`` returns False, a re-sent ``get_task`` at worst
    double-leases a task whose first lease times out and requeues).
    """

    def __init__(self, addr, timeout=30.0, retry=None, trainer_id=None):
        from paddle_tpu_torch.fault.retry import (DEFAULT_RPC_POLICY,
                                                  parse_hostport)
        self._addr = parse_hostport(addr)
        self._timeout = timeout
        self._retry = retry or DEFAULT_RPC_POLICY
        self.trainer_id = trainer_id
        self._lock = threading.Lock()
        self._sock = None
        self._rfile = None
        self._hb_stop = None
        self._closed = False
        # connection is lazy: the first _call dials under the retry
        # policy, so constructing a client while the master is briefly
        # down (trainer resume during master restart) is safe

    def _connect(self):
        if self._closed:
            raise RuntimeError("MasterClient is closed")
        self._drop_connection()
        host, port = self._addr
        self._sock = socket.create_connection((host, int(port)),
                                              timeout=self._timeout)
        self._rfile = self._sock.makefile("r")

    def _drop_connection(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None
        self._rfile = None

    def _call(self, method, **params):
        from paddle_tpu_torch.fault import chaos
        rid = _trace.current_trace_id()
        if rid is not None:
            # caller's trace id crosses the process boundary in-frame;
            # the master's handler spans join this trace
            params["_trace"] = rid

        def attempt():
            chaos.fire("master.rpc", method=method)
            with self._lock:
                if self._sock is None:
                    self._connect()
                try:
                    msg = json.dumps({"method": method,
                                      "params": params}) + "\n"
                    self._sock.sendall(msg.encode())
                    line = self._rfile.readline()
                    if not line:  # server closed mid-request
                        raise ConnectionError("master closed connection")
                    return json.loads(line)
                except OSError:
                    # a dead stream can't be reused: reconnect on the
                    # next attempt
                    self._drop_connection()
                    raise
                except ValueError as e:
                    # garbled/truncated frame — same remedy as a reset
                    self._drop_connection()
                    raise ConnectionError(f"garbled master reply: {e}") \
                        from e

        with _span("master.rpc", method=method):
            resp = self._retry.call(attempt)
        if "error" in resp:
            raise MasterError(f"master: {resp['error']}")
        return resp["result"]

    def get_task(self):
        d = self._call("get_task", trainer_id=self.trainer_id)
        return Task.from_dict(d) if d is not None else None

    def heartbeat(self):
        if self.trainer_id is None:
            raise ValueError("heartbeat requires a trainer_id")
        return self._call("heartbeat", trainer_id=self.trainer_id)

    def start_heartbeats(self, interval=5.0):
        """Send heartbeats from a daemon thread every ``interval``
        seconds (enrolls this trainer in heartbeat-based lease
        reclamation on the master).  Stops on :meth:`close`."""
        if self.trainer_id is None:
            raise ValueError("heartbeats require a trainer_id")
        if self._hb_stop is not None:
            return
        stop = threading.Event()   # captured: immune to close() racing
        self._hb_stop = stop       # the attribute back to None

        def beat():
            while not stop.wait(interval):
                try:
                    self.heartbeat()
                except Exception:
                    pass  # transient (retried already) — or closed

        threading.Thread(target=beat, daemon=True).start()

    def task_finished(self, task_id, epoch=None):
        return self._call("task_finished", task_id=task_id, epoch=epoch)

    def task_failed(self, task_id, epoch=None):
        return self._call("task_failed", task_id=task_id, epoch=epoch)

    def all_done(self):
        return self._call("all_done")

    def reset_pass(self):
        return self._call("reset_pass")

    def stats(self):
        return self._call("stats")

    # -- serving-fleet discovery ------------------------------------------
    def register_replica(self, replica_id, addr, ttl=None, meta=None):
        return self._call("register_replica", replica_id=replica_id,
                          addr=addr, ttl=ttl, meta=meta)

    def renew_replica(self, replica_id, epoch=None):
        return self._call("renew_replica", replica_id=replica_id,
                          epoch=epoch)

    def deregister_replica(self, replica_id):
        return self._call("deregister_replica", replica_id=replica_id)

    def list_replicas(self):
        return self._call("list_replicas")

    def close(self):
        self._closed = True   # an in-flight retry can no longer redial
        if self._hb_stop is not None:
            self._hb_stop.set()
            self._hb_stop = None
        self._drop_connection()
