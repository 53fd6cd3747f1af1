"""Fleet replica: an :class:`~paddle_tpu_torch.serving.InferenceServer`
enrolled in master-backed service discovery.

The reference framework's production unit was a *cluster* — trainers
and pservers coordinated by the Go master's leases and heartbeats.
:class:`FleetReplica` re-aims that machinery at inference: on startup
(once `/readyz` would pass, i.e. loaded AND warmed) the replica
registers its address with the master under a TTL lease and renews it
from a heartbeat thread; a replica that stops renewing — crash, hang,
partition — simply vanishes from :meth:`MasterService.list_replicas`
and the router stops sending it traffic.  No prober, no gossip: a
silent replica IS a dead replica.

Lease loss while alive (master restarted, `master.lease.expire` drill)
flips the wrapped server's ``lease_state`` so `/readyz` answers
``503 lease_lost`` — the load balancer and the router agree about
health — and, with ``auto_rejoin``, the next heartbeat re-registers.

The ``fleet.replica.kill`` failpoint fires in the heartbeat loop: armed
with ``kill`` (subprocess drills) it is a real ``os._exit(137)``;
armed with ``error`` (in-process drills) it routes to :meth:`kill`,
the abrupt no-drain stop that chaos tests use to hard-kill one replica
of an in-process fleet mid-load.
"""

from __future__ import annotations

import logging
import os
import threading

from paddle_tpu_torch.serving import InferenceServer

logger = logging.getLogger(__name__)

__all__ = ["FleetReplica"]


class FleetReplica:
    """One serving replica of a master-routed fleet.

    ``server_kwargs`` pass through to :class:`InferenceServer`
    (``place`` included: ``cuda:0`` unless the caller passes
    ``CPUPlace()``) — ``warmup=True`` is the fast-scale-out
    configuration: a replacement replica builds and loads every kernel
    and runs every prompt/page bucket before `/readyz` flips, so rolling
    restarts never serve a cold build.  The port has no compile cache:
    a kernel library already built under ``kernels/_build/`` is loaded,
    not rebuilt.
    """

    def __init__(self, model_dir, master_addr, replica_id=None,
                 host="127.0.0.1", port=0, lease_ttl=5.0,
                 heartbeat_interval=None, advertise_host=None,
                 auto_rejoin=True, **server_kwargs):
        from paddle_tpu_torch.parallel.master import MasterClient
        self.replica_id = replica_id or \
            f"replica-{os.getpid():x}-{os.urandom(3).hex()}"
        self.lease_ttl = float(lease_ttl)
        # 3 renews per TTL: one lost heartbeat never expires the lease
        self.heartbeat_interval = float(
            heartbeat_interval if heartbeat_interval is not None
            else max(0.05, self.lease_ttl / 3.0))
        self.server = InferenceServer(model_dir, host=host, port=port,
                                      **server_kwargs)
        self.addr = self.server.addr
        self.advertise_addr = \
            f"{advertise_host or self.addr[0]}:{self.addr[1]}"
        self.auto_rejoin = bool(auto_rejoin)
        self._master = MasterClient(master_addr)
        self._stop = threading.Event()
        # serializes lease mutations (register vs drain's deregister):
        # a rejoin racing drain() must never re-enroll a dead listener
        self._lease_lock = threading.Lock()
        self._hb_thread = None
        self._serve_thread = None
        self.killed = False
        self._epoch = None

    # -- lifecycle ---------------------------------------------------------
    def warm(self, ready_timeout=300.0):
        """Serve and wait for readiness (load + warmup) WITHOUT
        registering: the warm-standby half of :meth:`start`.

        A warmed replica has paid its model load and warmup (every
        kernel built or loaded, every bucket run once on its device) but
        takes no traffic: the router never discovers it until
        :meth:`enroll` registers the lease.  This is the fleet
        controller's standby pool shape: scale-up becomes a
        registration (milliseconds), not a warmup (seconds).

        Also labels this process's timeline row for merged fleet traces
        (``obs.trace.set_process_name``; first caller wins, so an
        operator-chosen name is never overwritten).  Raises if the
        model load failed — and a failed warm tears down what it
        already built (listener, master connection), so the caller is
        not left with a leaked port it has no handle to drain.
        Idempotent once warmed."""
        from paddle_tpu_torch.obs import trace as _trace
        if self._serve_thread is not None:
            return self
        _trace.set_process_name(f"replica:{self.replica_id}")
        self._serve_thread = self.server.start_background()
        try:
            if not self.server.wait_until_ready(ready_timeout):
                raise TimeoutError(
                    f"replica {self.replica_id} not ready in "
                    f"{ready_timeout}s")
        except BaseException:
            self._stop.set()
            try:
                self.server.shutdown()
            except Exception:
                pass
            try:
                self._master.close()
            except Exception:
                pass
            raise
        return self

    def enroll(self):
        """Register a WARMED replica with the master and start the
        heartbeat thread — the promotion half of :meth:`start`, and the
        fleet controller's scale-up primitive.  Registration is
        deliberately after readiness: the router must never discover a
        replica whose `/readyz` would still say 503.  Raises
        ``RuntimeError`` when called before :meth:`warm`; idempotent
        once enrolled."""
        if self._serve_thread is None:
            raise RuntimeError(
                f"replica {self.replica_id} not warmed: call warm() "
                f"before enroll()")
        if self._hb_thread is not None:
            return self
        try:
            self._register()
        except BaseException:
            self._stop.set()
            try:
                self.server.shutdown()
            except Exception:
                pass
            try:
                self._master.close()
            except Exception:
                pass
            raise
        self._hb_thread = threading.Thread(
            target=self._beat_loop, daemon=True,
            name=f"fleet-hb-{self.replica_id}")
        self._hb_thread.start()
        return self

    def start(self, ready_timeout=300.0):
        """Serve, wait for readiness (load + warmup), THEN register:
        :meth:`warm` + :meth:`enroll`."""
        self.warm(ready_timeout)
        self.enroll()
        return self

    def _register(self):
        from paddle_tpu_torch import profiler as _profiler
        with self._lease_lock:
            if self._stop.is_set():
                # drain()/kill() won the race: stay deregistered
                return
            lease = self._master.register_replica(
                self.replica_id, self.advertise_addr, ttl=self.lease_ttl,
                meta={"pid": os.getpid()})
            self._epoch = lease["epoch"]
            self.server.lease_state = "held"
        _profiler.runtime_metrics.inc("fleet.replica_registrations")

    def _beat_loop(self):
        from paddle_tpu_torch import profiler as _profiler
        from paddle_tpu_torch.fault import chaos
        while not self._stop.wait(self.heartbeat_interval):
            try:
                # armed `kill`: a real os._exit mid-load (subprocess
                # drill); armed `error`: the in-process hard-kill below
                chaos.fire("fleet.replica.kill",
                           replica_id=self.replica_id)
            except chaos.FaultInjected:
                logger.warning("fleet.replica.kill fired: hard-killing "
                               "replica %s", self.replica_id)
                self.kill()
                return
            try:
                renewed = self._master.renew_replica(self.replica_id,
                                                     epoch=self._epoch)
            except Exception:
                # transport failures were already retried by the client
                # policy; keep beating — the lease may outlive the blip
                continue
            if renewed:
                if self.server.lease_state != "held":
                    self.server.lease_state = "held"
                continue
            # lease lost while alive: surface it on /readyz first, then
            # (optionally) re-enroll — the order matters, a probe racing
            # the rejoin must never see "ready" without a lease
            if self.server.lease_state != "lost":
                self.server.lease_state = "lost"
                _profiler.runtime_metrics.inc("fleet.lease_lost")
                logger.warning("replica %s lost its fleet lease",
                               self.replica_id)
            if self.auto_rejoin and not self._stop.is_set():
                # (_stop re-checked: drain() deregisters AFTER setting
                # the flag — a rejoin racing it would resurrect a dead
                # replica in the routing table for a full TTL)
                try:
                    live = {r["id"] for r in self._master.list_replicas()}
                    if self.replica_id in live:
                        # a NEWER incarnation holds this id (rolling
                        # restart with a stable --replica-id): stand
                        # down instead of fighting over the lease —
                        # re-registering here would epoch-bump the
                        # replacement out and ping-pong forever
                        continue
                    self._register()
                except Exception:
                    pass  # master still down: retry next beat

    # -- exits -------------------------------------------------------------
    def drain(self, deadline_s=30.0):
        """Rolling-restart drain: deregister (the router stops routing
        new requests), stop heartbeats, checkpoint-migrate any active
        generative sessions, then shut the server down — stop
        accepting, finish in-flight, release resources.  The lease is
        released *before* the listener closes, so the fleet's ready
        count drops by exactly one with no refused-connection window.

        ``deadline_s`` bounds how long in-flight generative streams may
        run to natural completion; on expiry the remaining sessions are
        checkpointed at a token boundary and handed back (as ``migrate``
        tails on their still-open streams) for re-placement on a
        survivor, instead of being awaited forever.  Returns the list
        of migrated session checkpoints (empty for non-gen bundles)."""
        self._stop.set()
        with self._lease_lock:
            # under the lock: an in-flight rejoin either registered
            # BEFORE this deregister (undone here) or observes _stop
            # and stands down — no window re-enrolls a dead listener
            try:
                self._master.deregister_replica(self.replica_id)
            except Exception:
                pass  # master gone: the lease TTL expires it anyway
            self.server.lease_state = None
        # checkpoint BEFORE the listener closes: migrate tails must
        # flush on the streams' still-open connections
        checkpoints = []
        try:
            checkpoints = self.server.drain_sessions(deadline_s)
        except Exception:
            logger.exception("replica %s: session drain failed",
                             self.replica_id)
        self.server.shutdown()
        self._master.close()
        return checkpoints

    def kill(self):
        """In-process hard-kill: stop heartbeats and close the listener
        with NO drain and NO deregistration — in-flight connections race
        the close, new connections are refused, and the master only
        notices when the lease TTL runs out.  This is the in-process
        analog of ``kill -9`` for chaos drills (subprocess drills arm
        ``fleet.replica.kill=kill`` for the real thing)."""
        self.killed = True
        self._stop.set()
        try:
            # sever active generative streams too: closing the listener
            # alone leaves handler threads decoding — a real SIGKILL
            # kills them, so the in-process analog must as well (their
            # clients see a retryable error tail and resume elsewhere)
            self.server.abort_streams()
        except Exception:
            pass
        try:
            self.server._server.shutdown()
        except Exception:
            pass
        try:
            self.server._server.server_close()
        except Exception:
            pass
        try:
            self._master.close()
        except Exception:
            pass

    def close(self):
        """Alias for :meth:`drain` (context-manager friendliness)."""
        self.drain()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if not self.killed:
            self.drain()
        return False
