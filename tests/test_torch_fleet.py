"""The port's serving fleet on the CPU: the JAX package's fleet tests
(``tests/test_fleet.py``) run against the port's master, replicas,
router and client over an fc bundle the JAX package exported, every
replica on ``CPUPlace()``; the rolling restart checks that the warmed
replacement builds no kernel (the port has no compile cache).  Then a
mixed fleet: a JAX replica and a port replica under one master, routed
by each package's router in turn — ``/predict`` replies are equal, and a
kill-owner drill on the ``GenConfig`` bundle resumes the stream on the
other package's replica to the cache-free greedy tokens.

Tolerance: float32 ``rtol = atol = 1e-5`` between the packages' replies
(torch and XLA sum in different orders); tokens and indices are compared
exactly.  Every server is shut down in a ``finally``, every failpoint
cleared, every wait bounded."""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu.layers as layers
from paddle_tpu import fleet as jax_fleet
from paddle_tpu import profiler as jax_profiler
from paddle_tpu.fault import chaos as jax_chaos
from paddle_tpu.models import gen_lm as jax_gen_lm
from paddle_tpu_torch import CPUPlace
from paddle_tpu_torch import profiler
from paddle_tpu_torch.fault import RetryError, RetryPolicy, chaos
from paddle_tpu_torch.fleet import FleetReplica, FleetRouter
from paddle_tpu_torch.obs import trace as _trace
from paddle_tpu_torch.parallel.master import MasterServer, MasterService
from paddle_tpu_torch.serving import InferenceServer, ServingClient

FEED = {"x": np.ones((3, 4), "float32")}
TOL = 1e-5


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A tiny untrained fc model, exported by the JAX package — fleet
    tests exercise routing, not numerics."""
    d = str(tmp_path_factory.mktemp("torch_fleet") / "model")
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = layers.data(name="x", shape=[4])
        pred = layers.fc(input=x, size=2)
        exe = fluid.Executor()
        exe.run(startup)
        fluid.io.save_inference_model(d, ["x"], [pred], exe,
                                      main_program=main)
    return d


@pytest.fixture()
def master():
    svc = MasterService(replica_ttl=1.0)
    srv = MasterServer(svc, port=0)
    srv.start_background()
    yield svc, f"{srv.addr[0]}:{srv.addr[1]}"
    srv.shutdown()


@pytest.fixture(autouse=True)
def _clear_chaos():
    chaos.clear()
    jax_chaos.clear()
    yield
    chaos.clear()
    jax_chaos.clear()


def _start_replicas(model_dir, master_addr, n, **kw):
    kw.setdefault("lease_ttl", 1.0)
    kw.setdefault("place", CPUPlace())
    kw.setdefault("heartbeat_interval", 0.15)
    return [FleetReplica(model_dir, master_addr,
                         replica_id=f"r{i}", **kw).start()
            for i in range(n)]


def _get(addr, path):
    host, port = addr
    try:
        with urllib.request.urlopen(
                f"http://{host}:{port}{path}", timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(addr, path, obj, headers=None):
    host, port = addr
    req = urllib.request.Request(
        f"http://{host}:{port}{path}", data=json.dumps(obj).encode(),
        headers=dict({"Content-Type": "application/json"},
                     **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class TestLeaseReadyz:
    def test_readyz_reports_lease_lost_then_rejoin(self, model_dir,
                                                   master):
        """Satellite: a replica whose lease expired while the process is
        alive must answer 503 lease_lost — the router and the LB agree —
        and auto-rejoin must restore 200 without a restart."""
        svc, maddr = master
        (rep,) = _start_replicas(model_dir, maddr, 1, auto_rejoin=False)
        try:
            assert _get(rep.addr, "/readyz")[0] == 200
            with chaos.scoped("master.lease.expire", error=True, times=1):
                deadline = time.time() + 5
                while rep.server.lease_state != "lost" and \
                        time.time() < deadline:
                    time.sleep(0.05)
            code, body = _get(rep.addr, "/readyz")
            assert code == 503
            assert body["error"]["type"] == "lease_lost"
            assert body["retryable"] is True
            assert svc.list_replicas() == []
            # flip auto_rejoin back on: the next heartbeat re-registers
            rep.auto_rejoin = True
            deadline = time.time() + 5
            while rep.server.lease_state != "held" and \
                    time.time() < deadline:
                time.sleep(0.05)
            assert _get(rep.addr, "/readyz")[0] == 200
            assert [r["id"] for r in svc.list_replicas()] == ["r0"]
        finally:
            rep.drain()


class TestDeadlinePropagation:
    def test_expired_deadline_is_immediate_504(self, model_dir):
        server = InferenceServer(model_dir, port=0, place=CPUPlace())
        server.start_background()
        try:
            code, body = _post(server.addr, "/predict",
                               {"feeds": {"x": FEED["x"].tolist()}},
                               headers={"X-Deadline-Ms": "0"})
            assert code == 504 and body["retryable"] is True
            assert body["error"]["type"] == "deadline_exceeded"
        finally:
            server.shutdown()

    def test_malformed_deadline_is_400(self, model_dir):
        server = InferenceServer(model_dir, port=0, place=CPUPlace())
        server.start_background()
        try:
            code, body = _post(server.addr, "/predict",
                               {"feeds": {"x": FEED["x"].tolist()}},
                               headers={"X-Deadline-Ms": "soon"})
            assert code == 400 and body["retryable"] is False
        finally:
            server.shutdown()

    def test_deadline_bounds_batcher_wait(self, model_dir):
        """X-Deadline-Ms flows into MicroBatcher's per-request timeout:
        a request whose batch is stuck behind a slow dispatch gives up
        by the CALLER's budget, not the server's (unset) timeout."""
        server = InferenceServer(model_dir, port=0, batching=True,
                                 place=CPUPlace(),
                                 request_timeout=None)
        server.start_background()
        try:
            assert server.wait_until_ready(120)
            _post(server.addr, "/predict",
                  {"feeds": {"x": FEED["x"].tolist()}})  # warm out
            chaos.inject("serving.predict", delay=1.5, times=1)
            t0 = time.monotonic()
            code, body = _post(server.addr, "/predict",
                               {"feeds": {"x": FEED["x"].tolist()}},
                               headers={"X-Deadline-Ms": "300"})
            elapsed = time.monotonic() - t0
            assert code == 504 and body["retryable"] is True
            assert elapsed < 1.4, elapsed  # gave up well before 1.5s
        finally:
            chaos.clear()
            server.shutdown()


class TestClientBalancer:
    def test_failover_to_live_replica(self, model_dir):
        server = InferenceServer(model_dir, port=0, place=CPUPlace())
        server.start_background()
        dead = "127.0.0.1:1"  # reserved port: immediate refusal
        try:
            client = ServingClient(
                [dead, f"{server.addr[0]}:{server.addr[1]}"],
                retry=RetryPolicy(max_attempts=4, base_delay=0.01,
                                  jitter="full"))
            for _ in range(4):  # every round-robin phase recovers
                (out,) = client.predict(FEED)
                assert out.shape == (3, 2)
        finally:
            server.shutdown()

    def test_retry_error_carries_replica_history(self):
        client = ServingClient(
            ["127.0.0.1:1", "127.0.0.1:2"],
            retry=RetryPolicy(max_attempts=3, base_delay=0.01,
                              jitter="full"))
        with pytest.raises(RetryError) as ei:
            client.predict(FEED)
        history = ei.value.history
        assert len(history) == 3
        assert set(history) == {"http://127.0.0.1:1",
                                "http://127.0.0.1:2"}
        # failover preferred the UNTRIED replica before repeating one
        assert history[0] != history[1]

    def test_pre_dispatch_reset_retried_under_one_request_id(
            self, model_dir):
        """Regression (satellite): a connection reset before any reply —
        the request never reached a batcher — must be retried, and every
        attempt must carry the SAME X-Request-Id so the retry chain is
        idempotent and traceable."""
        seen_ids = []

        # a "replica" that reads the request, records X-Request-Id, and
        # slams the connection with no reply (pre-dispatch reset)
        resetter = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        resetter.bind(("127.0.0.1", 0))
        resetter.listen(4)
        stop = threading.Event()

        def slam():
            while not stop.is_set():
                try:
                    conn, _ = resetter.accept()
                except OSError:
                    return
                try:
                    data = conn.recv(65536).decode("latin-1")
                    for line in data.split("\r\n"):
                        if line.lower().startswith("x-request-id:"):
                            seen_ids.append(line.split(":", 1)[1].strip())
                finally:
                    conn.close()

        t = threading.Thread(target=slam, daemon=True)
        t.start()
        server = InferenceServer(model_dir, port=0, place=CPUPlace())
        server.start_background()
        try:
            reset_addr = "127.0.0.1:%d" % resetter.getsockname()[1]
            _trace.enable()
            _trace.clear()
            client = ServingClient(
                [reset_addr, f"{server.addr[0]}:{server.addr[1]}"],
                retry=RetryPolicy(max_attempts=6, base_delay=0.01,
                                  jitter="full"))
            for _ in range(3):
                (out,) = client.predict(FEED)
                assert out.shape == (3, 2)
            assert seen_ids, "the resetting replica never saw a request"
            served = [sp["attrs"]["request_id"]
                      for sp in _trace.snapshot_spans()
                      if sp["name"] == "serving.request"]
            # every id the dead replica saw was retried into a real
            # serving.request on the live one — same id, zero drops
            assert set(seen_ids) <= set(served)
        finally:
            stop.set()
            resetter.close()
            server.shutdown()
            _trace.disable()
            _trace.clear()


class TestRouter:
    def test_routes_and_passes_permanent_errors_through(self, model_dir,
                                                        master):
        svc, maddr = master
        reps = _start_replicas(model_dir, maddr, 2)
        router = FleetRouter(master_addr=maddr, poll_interval=0.05)
        router.start_background()
        try:
            deadline = time.time() + 5
            while len(router.live_replicas()) < 2 and \
                    time.time() < deadline:
                time.sleep(0.05)
            code, body = _post(router.addr, "/predict",
                               {"feeds": {"x": FEED["x"].tolist()}})
            assert code == 200
            assert np.asarray(body["outputs"][0]).shape == (3, 2)
            # permanent 400 (bad feed name) is NOT failed over: the
            # caller sees the replica's own structured error verbatim
            code, body = _post(router.addr, "/predict",
                               {"feeds": {"nope": [1.0]}})
            assert code == 400 and body["retryable"] is False
            code, body = _get(router.addr, "/readyz")
            assert code == 200 and body["replicas"] == 2
            code, body = _get(router.addr, "/stats")
            assert "router" in body and len(body["router"]["replicas"]) == 2
        finally:
            for r in reps:
                r.drain()
            router.shutdown()

    def test_no_replicas_is_retryable_503(self):
        router = FleetRouter(replicas=["127.0.0.1:1"])
        router._table.clear()  # empty static table
        router.start_background()
        try:
            code, body = _post(router.addr, "/predict", {"feeds": {}})
            assert code == 503 and body["retryable"] is True
            assert body["error"]["type"] == "no_replicas"
        finally:
            router.shutdown()

    def test_dead_fleet_bounded_by_caller_deadline(self):
        """Satellite: the router's retry chain (full jitter) never
        exceeds the caller's X-Deadline-Ms — it gives up with a
        retryable error and the per-attempt replica trail."""
        router = FleetRouter(replicas=["127.0.0.1:1", "127.0.0.1:2"],
                             retry=RetryPolicy(max_attempts=50,
                                               base_delay=0.02,
                                               max_delay=0.1,
                                               jitter="full"))
        router.start_background()
        try:
            t0 = time.monotonic()
            code, body = _post(router.addr, "/predict", {"feeds": {}},
                               headers={"X-Deadline-Ms": "400"})
            elapsed = time.monotonic() - t0
            assert code in (503, 504)
            assert body["retryable"] is True
            assert elapsed < 1.5, elapsed  # 400ms budget + slack, not 50 tries
            assert body["replicas_tried"], body
            assert set(body["replicas_tried"]) <= {"127.0.0.1:1",
                                                   "127.0.0.1:2"}
        finally:
            router.shutdown()

    def test_blackhole_failpoint_fails_over(self, model_dir, master):
        svc, maddr = master
        reps = _start_replicas(model_dir, maddr, 2)
        router = FleetRouter(master_addr=maddr, poll_interval=0.05)
        router.start_background()
        try:
            deadline = time.time() + 5
            while len(router.live_replicas()) < 2 and \
                    time.time() < deadline:
                time.sleep(0.05)
            with chaos.scoped("fleet.route.blackhole", error=True,
                              times=1):
                code, _ = _post(router.addr, "/predict",
                                {"feeds": {"x": FEED["x"].tolist()}})
            assert code == 200  # first route blackholed, sibling served
            assert len(router.failover_log) >= 1
        finally:
            for r in reps:
                r.drain()
            router.shutdown()


class TestChaosDrillKillReplica:
    """Acceptance drill: 3 replicas under closed-loop load,
    fleet.replica.kill hard-kills one mid-flight — zero lost requests,
    bounded p99, and the failed-over request's X-Request-Id shows up in
    a surviving replica's /trace."""

    @pytest.mark.chaos
    def test_kill_one_replica_mid_load_loses_zero_requests(
            self, model_dir, master):
        svc, maddr = master
        _trace.enable(65536)  # room for the whole drill's spans
        _trace.clear()
        # warm the drill's exact request shape so the measured
        # window meets no new shape (lease ttl generous: GIL-heavy
        # in-process load must not flap leases and muddy the drill)
        reps = _start_replicas(model_dir, maddr, 3, lease_ttl=3.0,
                               warmup=True, warmup_batch_sizes=(3,))
        router = FleetRouter(master_addr=maddr, poll_interval=0.05)
        router.start_background()
        stats = [{"latencies": [], "failures": []} for _ in range(6)]
        try:
            deadline = time.time() + 5
            while len(router.live_replicas()) < 3 and \
                    time.time() < deadline:
                time.sleep(0.05)
            assert len(router.live_replicas()) == 3
            warm = ServingClient(router.addr)
            for _ in range(6):  # touch every replica before the clock
                warm.predict(FEED)

            def loop(out, stop_at):
                client = ServingClient(
                    router.addr, deadline=10.0,
                    retry=RetryPolicy(max_attempts=8, base_delay=0.05,
                                      max_delay=0.5, jitter="full"))
                while time.monotonic() < stop_at:
                    t0 = time.perf_counter()
                    try:
                        client.predict(FEED)
                        out["latencies"].append(
                            time.perf_counter() - t0)
                    except Exception as e:  # a LOST request
                        out["failures"].append(repr(e))

            stop_at = time.monotonic() + 2.5
            threads = [threading.Thread(target=loop,
                                        args=(stats[i], stop_at))
                       for i in range(len(stats))]
            for t in threads:
                t.start()
            time.sleep(0.8)  # mid-load: hard-kill exactly one replica
            chaos.inject("fleet.replica.kill", error=True, times=1)
            for t in threads:
                t.join()
            chaos.clear("fleet.replica.kill")

            failures = [f for s in stats for f in s["failures"]]
            lats = sorted(x for s in stats for x in s["latencies"])
            assert not failures, failures[:5]       # zero lost requests
            assert len(lats) > 50
            killed = [r for r in reps if r.killed]
            assert len(killed) == 1                  # the drill fired
            p99 = lats[min(len(lats) - 1, int(0.99 * len(lats)))]
            assert p99 < 5.0, p99                    # p99 stays bounded
            assert router.failover_log, "no failover was recorded"

            # the failed-over request is traceable ON A SURVIVOR: its
            # X-Request-Id appears in /trace served by the replica that
            # completed it
            survivor_ports = {r.addr[1] for r in reps if not r.killed}
            survivor = next(r for r in reps if not r.killed)
            tr = ServingClient(survivor.addr).trace()
            served = {(ev["args"].get("request_id"),
                       ev["args"].get("port"))
                      for ev in tr["traceEvents"]
                      if ev["name"] == "serving.request"}
            assert any((rid, port) in served
                       for rid, *chain in router.failover_log
                       for port in survivor_ports), (
                list(router.failover_log)[:3])
            # eventually the lease expires and discovery prunes the dead
            deadline = time.time() + 10
            while len(router.live_replicas()) > 2 and \
                    time.time() < deadline:
                time.sleep(0.1)
            assert len(router.live_replicas()) == 2
        finally:
            chaos.clear()
            for r in reps:
                if not r.killed:
                    r.drain()
            router.shutdown()
            _trace.disable()
            _trace.clear()


class TestFleetObservabilityChurn:
    """Acceptance drill (observability plane): 3 replicas under load,
    one hard-killed mid-flight — the federated /metrics?fleet=1 rollup
    stays servable THROUGHOUT (the corpse marked stale=1, never a
    failed scrape), and /trace?fleet=1 returns ONE merged timeline in
    which a failed-over X-Request-Id's full story reads end-to-end:
    the router's attempt on the replica that died, the failover, the
    survivor's serving.request — next to the dead replica's own
    pre-death spans."""

    @pytest.mark.chaos
    def test_federation_and_trace_assembly_survive_kill(
            self, model_dir, master):
        import urllib.parse

        svc, maddr = master
        _trace.enable(65536)
        _trace.clear()
        reps = _start_replicas(model_dir, maddr, 3, lease_ttl=3.0,
                               warmup=True, warmup_batch_sizes=(3,))
        router = FleetRouter(master_addr=maddr, poll_interval=0.05)
        router.start_background()

        def fleet_metrics():
            host, port = router.addr
            with urllib.request.urlopen(
                    f"http://{host}:{port}/metrics?fleet=1",
                    timeout=30) as r:
                assert r.status == 200
                return r.read().decode()

        def fleet_trace():
            host, port = router.addr
            with urllib.request.urlopen(
                    f"http://{host}:{port}/trace?fleet=1",
                    timeout=30) as r:
                assert r.status == 200
                return json.loads(r.read())

        stats = [{"latencies": [], "failures": []} for _ in range(4)]
        try:
            deadline = time.time() + 5
            while len(router.live_replicas()) < 3 and \
                    time.time() < deadline:
                time.sleep(0.05)
            warm = ServingClient(router.addr)
            for _ in range(6):
                warm.predict(FEED)

            # healthy federation: all three replicas live, no stale
            text = fleet_metrics()
            assert 'stale="0"' in text and 'stale="1"' not in text
            assert text.count("paddle_tpu_fleet_replica_up{") == 3

            def loop(out, stop_at):
                client = ServingClient(
                    router.addr, deadline=10.0,
                    retry=RetryPolicy(max_attempts=8, base_delay=0.05,
                                      max_delay=0.5, jitter="full"))
                while time.monotonic() < stop_at:
                    t0 = time.perf_counter()
                    try:
                        client.predict(FEED)
                        out["latencies"].append(
                            time.perf_counter() - t0)
                    except Exception as e:
                        out["failures"].append(repr(e))

            stop_at = time.monotonic() + 2.5
            threads = [threading.Thread(target=loop,
                                        args=(stats[i], stop_at))
                       for i in range(len(stats))]
            for t in threads:
                t.start()
            time.sleep(0.8)
            chaos.inject("fleet.replica.kill", error=True, times=1)
            # mid-churn: the fleet view must stay servable while the
            # corpse is dying/dead but still leased into the table
            deadline = time.time() + 5
            text = fleet_metrics()
            while 'stale="1"' not in text and time.time() < deadline:
                time.sleep(0.1)
                text = fleet_metrics()
            for t in threads:
                t.join()
            chaos.clear("fleet.replica.kill")

            killed = [r for r in reps if r.killed]
            assert len(killed) == 1
            dead = killed[0]
            dead_addr = f"{dead.addr[0]}:{dead.addr[1]}"
            assert not [f for s in stats for f in s["failures"]]
            assert router.failover_log, "no failover recorded"

            # (1) the rollup rendered WITH the corpse marked stale
            assert (f'paddle_tpu_fleet_replica_up{{replica='
                    f'"{dead_addr}"') in text
            assert 'stale="1"} 0' in text
            assert "paddle_tpu_fleet_replicas_stale 1" in text
            # survivors' samples still labelled and present
            for r in reps:
                if not r.killed:
                    assert f'replica="{r.addr[0]}:{r.addr[1]}"' in text

            # (2) one merged timeline tells the failed-over request's
            # whole story
            obj = fleet_trace()
            asm = obj["fleetAssembly"]
            assert any(f["source"] == dead_addr
                       for f in asm["failures"])   # corpse unreachable
            assert any(p["source"] == "router"
                       for p in asm["processes"])
            evs = [e for e in obj["traceEvents"] if e["ph"] == "X"]
            by_rid = {}
            for e in evs:
                rid = e["args"].get("trace_id") or \
                    e["args"].get("request_id")
                if rid:
                    by_rid.setdefault(rid, []).append(e)
            survivor_ports = {r.addr[1] for r in reps if not r.killed}
            proved = False
            for rid, *chain in router.failover_log:
                spans = by_rid.get(rid, [])
                names = {e["name"] for e in spans}
                if not {"fleet.request", "fleet.attempt",
                        "serving.request"} <= names:
                    continue
                attempted = {e["args"].get("replica") for e in spans
                             if e["name"] == "fleet.attempt"}
                served_ports = {e["args"].get("port") for e in spans
                                if e["name"] == "serving.request"}
                if dead_addr in attempted and \
                        served_ports & survivor_ports:
                    proved = True
                    break
            assert proved, (list(router.failover_log)[:3],
                            sorted(by_rid)[:5])
            # the dead replica's own (pre-death) spans are in the SAME
            # artifact — the in-process ring outlives the listener, so
            # its timeline row survives the kill
            dead_spans = [e for e in evs
                          if e["name"] == "serving.request"
                          and e["args"].get("port") == dead.addr[1]]
            assert dead_spans, "dead replica's timeline row is empty"
        finally:
            chaos.clear()
            for r in reps:
                if not r.killed:
                    r.drain()
            router.shutdown()
            _trace.disable()
            _trace.clear()


class TestRouterSLOWatchdog:
    """Acceptance: a deliberately induced latency SLO breach inside a
    live router produces `slo.breach` + a flight-recorder post-mortem
    carrying the breach."""

    @pytest.mark.chaos
    def test_induced_latency_breach_and_postmortem(
            self, model_dir, master, tmp_path, monkeypatch):
        import os

        from paddle_tpu_torch import profiler

        svc, maddr = master
        monkeypatch.setenv("PADDLE_TPU_POSTMORTEM", str(tmp_path))
        spec = {"version": 1, "interval_seconds": 0.1,
                "sustained_breaches": 2,
                "objectives": [
                    {"name": "router-latency-p99", "kind": "quantile",
                     "series": "fleet.request_seconds",
                     "quantile": "p99", "max": 0.05}]}
        reps = _start_replicas(model_dir, maddr, 1, warmup=True,
                               warmup_batch_sizes=(3,))
        breaches0 = profiler.runtime_metrics.counter("slo.breach")
        pms0 = profiler.runtime_metrics.counter("slo.postmortems")
        router = FleetRouter(master_addr=maddr, poll_interval=0.05,
                             slo_spec=spec)
        router.start_background()
        try:
            deadline = time.time() + 5
            while not router.live_replicas() and \
                    time.time() < deadline:
                time.sleep(0.05)
            client = ServingClient(router.addr)
            client.predict(FEED)  # warm, fast: no breach material yet
            # the induced degradation: every dispatch now stalls 200ms,
            # blowing the 50ms p99 objective
            chaos.inject("serving.predict", delay=0.2)
            deadline = time.time() + 15
            while (profiler.runtime_metrics.counter("slo.postmortems")
                   == pms0) and time.time() < deadline:
                client.predict(FEED)
            assert profiler.runtime_metrics.counter("slo.breach") \
                > breaches0
            assert profiler.runtime_metrics.counter("slo.postmortems") \
                > pms0
            pm_file = tmp_path / f"postmortem-{os.getpid()}.json"
            body = json.loads(pm_file.read_text())
            assert "sustained SLO breach: router-latency-p99" in \
                body["reason"]
            breach = body["extra"]["slo_breach"]
            assert breach["value"] > 0.05
            # the breach log is surfaced on the router's /stats
            code, snap = _get(router.addr, "/stats")
            assert code == 200
            assert snap["slo"]["breaching"].get("router-latency-p99")
        finally:
            chaos.clear()
            for r in reps:
                r.drain()
            router.shutdown()


class TestRollingRestartDrill:
    """Acceptance drill: drain one replica and replace it with a warmed
    one — the replacement flips /readyz without building a kernel (the
    port has no compile cache: a warm replacement is one whose warmup
    found every kernel built or loaded and every bucket run), and the
    fleet never drops below N-1 ready replicas."""

    @pytest.mark.chaos
    def test_drain_and_warm_replace(self, model_dir, master):
        from paddle_tpu_torch.kernels import build

        svc, maddr = master
        reps = _start_replicas(model_dir, maddr, 3, warmup=True)
        replacement = None
        min_ready = []
        stop = threading.Event()
        try:
            assert len(svc.list_replicas()) == 3
            builds0 = dict(build.counts)

            def monitor():
                while not stop.wait(0.03):
                    min_ready.append(len(svc.list_replicas()))

            mon = threading.Thread(target=monitor, daemon=True)
            mon.start()
            # -- the rolling restart ---------------------------------
            reps[0].drain()
            replacement = FleetReplica(
                model_dir, maddr, replica_id="r0b", lease_ttl=1.0,
                heartbeat_interval=0.15, warmup=True,
                place=CPUPlace()).start()
            stop.set()
            mon.join()
            # ready the moment it registered — and it built NOTHING:
            # every bucket of its warmup found its kernels in place
            assert _get(replacement.addr, "/readyz")[0] == 200
            assert dict(build.counts) == builds0
            code, snap = _get(replacement.addr, "/stats")
            assert code == 200 and snap["server"]["warmup"]
            assert {b["cache"] for b in snap["server"]["warmup"]} == \
                {"warm"}
            assert len(svc.list_replicas()) == 3
            assert min(min_ready) >= 2, min(min_ready)  # never below N-1
        finally:
            stop.set()
            for r in reps[1:]:
                r.drain()
            if replacement is not None:
                replacement.drain()


class TestFleetMetrics:
    def test_router_prometheus_exports_fleet_series(self, model_dir,
                                                    master):
        svc, maddr = master
        reps = _start_replicas(model_dir, maddr, 1)
        router = FleetRouter(master_addr=maddr, poll_interval=0.05)
        router.start_background()
        try:
            deadline = time.time() + 5
            while not router.live_replicas() and time.time() < deadline:
                time.sleep(0.05)
            code, _ = _post(router.addr, "/predict",
                            {"feeds": {"x": FEED["x"].tolist()}})
            assert code == 200
            host, port = router.addr
            with urllib.request.urlopen(
                    f"http://{host}:{port}/metrics", timeout=30) as r:
                body = r.read().decode()
            assert "fleet" in body
        finally:
            for r in reps:
                r.drain()
            router.shutdown()


# ---------------------------------------------------------------------------
# a mixed fleet: one JAX replica and one port replica under one master
# ---------------------------------------------------------------------------

ROUTERS = {"jax": jax_fleet.FleetRouter, "torch": FleetRouter}


def _wait_live(router, n, timeout=10.0):
    deadline = time.time() + timeout
    while len(router.live_replicas()) < n and time.time() < deadline:
        time.sleep(0.05)
    assert len(router.live_replicas()) == n


def _mixed(model_dir, maddr, **kw):
    """A JAX replica and a port replica enrolled with the master at
    ``maddr`` (the port's); the JAX one speaks to it with its own
    ``MasterClient``."""
    kw.setdefault("lease_ttl", 3.0)
    kw.setdefault("heartbeat_interval", 0.3)
    reps = {"jax": jax_fleet.FleetReplica(model_dir, maddr,
                                          replica_id="jax", **kw)}
    try:
        reps["jax"].start()
        reps["torch"] = FleetReplica(model_dir, maddr, replica_id="torch",
                                     place=CPUPlace(), **kw).start()
    except BaseException:
        for r in reps.values():
            r.drain()
        raise
    return reps


@pytest.mark.parametrize("router_pkg", ["jax", "torch"])
def test_mixed_fleet_predict_replies_match(model_dir, master, router_pkg):
    svc, maddr = master
    reps = _mixed(model_dir, maddr)
    router = ROUTERS[router_pkg](master_addr=maddr, poll_interval=0.05)
    router.start_background()
    try:
        assert sorted(r["id"] for r in svc.list_replicas()) == \
            ["jax", "torch"]
        _wait_live(router, 2)
        direct = {pkg: np.asarray(_post(r.addr, "/predict", {
            "feeds": {"x": FEED["x"].tolist()}})[1]["outputs"][0])
            for pkg, r in reps.items()}
        np.testing.assert_allclose(direct["torch"], direct["jax"],
                                   rtol=TOL, atol=TOL)
        for _ in range(6):
            code, body = _post(router.addr, "/predict",
                               {"feeds": {"x": FEED["x"].tolist()}})
            assert code == 200
            np.testing.assert_allclose(np.asarray(body["outputs"][0]),
                                       direct["jax"], rtol=TOL, atol=TOL)
        # least-outstanding routing spread the calls over both packages
        served = {e["id"]: e["requests"] for e in router.table().values()}
        assert served["jax"] > 0 and served["torch"] > 0, served
    finally:
        router.shutdown()
        for r in reps.values():
            r.drain()


@pytest.fixture(scope="module")
def gen_bundle(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_fleet_gen") / "bundle")
    jax_gen_lm.export_gen_model(d, jax_gen_lm.GenConfig(), num_slots=4)
    return d


@pytest.fixture(scope="module")
def gen_fleet(gen_bundle):
    """One master, a JAX and a port gen replica (warmed), for the
    kill-owner drills of both routers."""
    svc = MasterService(replica_ttl=3.0)
    srv = MasterServer(svc, port=0)
    srv.start_background()
    maddr = f"{srv.addr[0]}:{srv.addr[1]}"
    try:
        reps = _mixed(gen_bundle, maddr, warmup=True, request_timeout=30.0)
    except BaseException:
        srv.shutdown()
        raise
    yield maddr, reps
    for r in reps.values():
        r.drain()
    srv.shutdown()


def _ref_greedy(predictor, prompt, n):
    seq = list(prompt)
    out = []
    for _ in range(n):
        logits, _ = predictor.prefill(seq)
        t = int(np.argmax(logits))
        out.append(t)
        seq.append(t)
    return out


def _read_stream(addr, payload, timeout=60):
    import http.client
    conn = http.client.HTTPConnection(addr[0], addr[1], timeout=timeout)
    conn.request("POST", "/generate", json.dumps(payload).encode(),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200, resp.read()
    events = []
    while True:
        line = resp.readline()
        if not line:
            break
        events.append(json.loads(line))
        if events[-1].get("done"):
            break
    conn.close()
    return events


@pytest.mark.parametrize("router_pkg", ["jax", "torch"])
def test_mixed_fleet_kill_owner_resumes_across_packages(gen_fleet,
                                                        router_pkg):
    """The owner's stream is cut after its 4th token by the router's
    ``gen.session.kill_owner``; the survivor is the other package's
    replica, which re-prefills the prompt plus the delivered tokens: the
    stream ends token- and index-identical to the greedy reference."""
    maddr, reps = gen_fleet
    router = ROUTERS[router_pkg](master_addr=maddr, poll_interval=0.05)
    router.start_background()
    router_chaos = jax_chaos if router_pkg == "jax" else chaos
    metrics = (jax_profiler if router_pkg == "jax" else profiler) \
        .runtime_metrics
    resumes0 = metrics.counter("gen.session.resumes")
    try:
        _wait_live(router, 2)
        for c in (chaos, jax_chaos):
            c.inject("gen.decode.stall", delay=0.02)
        router_chaos.inject("gen.session.kill_owner", error=True, times=1,
                            after=3)
        events = _read_stream(router.addr, {"prompt": [2, 9],
                                            "max_new_tokens": 10})
        toks = [e["token"] for e in events if "token" in e]
        idxs = [e["index"] for e in events if "token" in e]
        assert idxs == list(range(10)), "lost or duplicated tokens"
        want = _ref_greedy(reps["jax"].server.gen_predictor, [2, 9], 10)
        assert toks == want
        tail = events[-1]
        assert tail["done"] and tail["finish_reason"] == "length"
        assert metrics.counter("gen.session.resumes") == resumes0 + 1
        # the router logs the failover after relaying the last chunk
        deadline = time.time() + 5
        while not router.failover_log and time.time() < deadline:
            time.sleep(0.01)
        (chain,) = [f[1:] for f in router.failover_log]
        ids = {f"{r.addr[0]}:{r.addr[1]}": pkg for pkg, r in reps.items()}
        assert sorted(ids[a] for a in chain) == ["jax", "torch"], chain
    finally:
        chaos.clear()
        jax_chaos.clear()
        router.shutdown()


def test_scope_guards_are_per_thread():
    """In-process replicas run their predictors under guards of their own
    scopes from their own threads: a thread inside a guard reads its own
    scope whatever another thread enters meanwhile, and a thread inside
    none reads the process-wide current scope."""
    from paddle_tpu_torch.scope import Scope, global_scope, scope_guard
    a, b = Scope(), Scope()
    entered, checked = threading.Barrier(2), threading.Barrier(2)
    seen = {}

    def run(name, scope):
        with scope_guard(scope):
            entered.wait(10)
            seen[name] = global_scope() is scope
            checked.wait(10)

    threads = [threading.Thread(target=run, args=args)
               for args in (("a", a), ("b", b))]
    [t.start() for t in threads]
    [t.join(10) for t in threads]
    assert seen == {"a": True, "b": True}
    outer = Scope()
    with scope_guard(outer):
        got = []
        t = threading.Thread(target=lambda: got.append(global_scope()))
        t.start()
        t.join(10)
        assert got == [outer]
