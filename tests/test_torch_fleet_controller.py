"""The port's fleet controller and traffic replay on the CPU: the JAX
package's units (``tests/test_fleet_controller.py``: the policy schema,
Retry-After plumbing, the router's admission ladder and 429
classification, the controller loop on stub replicas, the SLO episode
re-arm; ``tests/test_traffic.py``: rate patterns, the heavy-tail mix,
open-loop replay) run against the port, and the two packages against
each other: ``validate_policy`` names the same problems for each bad
policy, the controller loop takes the same ladder and scale decisions
for one pressure sequence, and ``TrafficReplay`` with one seed sends on
the same schedule (a virtual clock) with the same prompt lengths.

Decisions, problem lists and schedules are compared exactly.  Every
server is shut down, every failpoint cleared, every wait bounded."""

import json
import os
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from paddle_tpu import fleet as jax_fleet
from paddle_tpu import profiler as jax_profiler
from paddle_tpu.fleet import controller as jax_fc
from paddle_tpu.fleet import traffic as jax_traffic
from paddle_tpu_torch import profiler
from paddle_tpu_torch.fault import RetryError, RetryPolicy, chaos
from paddle_tpu_torch.fault.retry import parse_retry_after
from paddle_tpu_torch.fleet import FleetController, FleetRouter, \
    TrafficReplay
from paddle_tpu_torch.fleet import controller as fc
from paddle_tpu_torch.fleet import traffic as torch_traffic
from paddle_tpu_torch.fleet.traffic import (diurnal, flash_crowd,
                                            heavy_tail_lengths, step)
from paddle_tpu_torch.profiler import RuntimeMetrics
from paddle_tpu_torch.serving import ServingClient


# ---------------------------------------------------------------------------
# helpers


class _StubReplica:
    """Minimal HTTP stand-in for a FleetReplica: scripted POST /predict
    responses plus a /stats body good enough for FleetScraper."""

    def __init__(self, script=None, gauges=None):
        # script(i) -> (status, json_body, extra_headers or None)
        self.script = script or (lambda i: (200, {"outputs": [[[1.0]]]},
                                            None))
        self.gauges = dict(gauges or {})
        self.hits = 0
        self._lock = threading.Lock()
        stub = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _send(self, status, body, headers=None):
                payload = json.dumps(body).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                self._send(200, {"counters": {}, "gauges": dict(stub.gauges),
                                 "series": {}})

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                if n:
                    self.rfile.read(n)
                with stub._lock:
                    i = stub.hits
                    stub.hits += 1
                status, body, headers = stub.script(i)
                self._send(status, body, headers)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.addr = "127.0.0.1:%d" % self.server.server_address[1]

    def close(self):
        self.server.shutdown()
        self.server.server_close()


class FakeWatchdog:
    """Settable pressure source standing in for SLOWatchdog."""

    def __init__(self):
        self.values = []

    def set_pressure(self, ratio):
        self.values = [{"objective": "fake", "kind": "quantile",
                        "value": ratio, "threshold": 1.0,
                        "breached": ratio > 1.0}]

    def maybe_evaluate(self):
        return []

    def last_values(self):
        return [dict(v) for v in self.values]


class FakeReplica:
    """Lifecycle recorder standing in for FleetReplica in loop tests."""

    _seq = [0]

    def __init__(self):
        FakeReplica._seq[0] += 1
        self.replica_id = "fake-%d" % FakeReplica._seq[0]
        self.warmed = False
        self.enrolled = False
        self.drained = False
        self.killed = False

    def warm(self, timeout=None):
        self.warmed = True

    def enroll(self):
        self.enrolled = True

    def drain(self):
        self.drained = True


def _post(addr, body=None, headers=None, timeout=5.0):
    req = urllib.request.Request(
        "http://%s/predict" % addr,
        data=json.dumps(body or {"feeds": {"x": [[0.0]]}}).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


@pytest.fixture(autouse=True)
def _clear_chaos():
    chaos.clear()
    yield
    chaos.clear()


# ---------------------------------------------------------------------------
# policy schema


class TestPolicySchema:
    def test_example_policy_validates(self):
        assert fc.validate_policy(fc.EXAMPLE_POLICY) == []

    def test_bad_policies_are_named(self):
        def problems(**over):
            p = json.loads(json.dumps(fc.EXAMPLE_POLICY))
            for k, v in over.items():
                if isinstance(v, dict):
                    p[k].update(v)
                else:
                    p[k] = v
            return fc.validate_policy(p)

        assert problems(version=2)
        assert problems(min_replicas=5, max_replicas=2)
        assert problems(degrade={"ladder": [0.1, 0.5]})       # not 0-based
        assert problems(degrade={"ladder": [0.0, 0.8, 0.2]})  # decreasing
        assert problems(degrade={"ladder": [0.0, 1.5]})       # out of range
        assert problems(scale_up={"sustained_ticks": 0})
        assert problems(bogus_knob=1)
        assert any("bogus" in s for s in problems(bogus_knob=1))

    def test_load_policy_roundtrip_and_errors(self, tmp_path):
        path = tmp_path / "policy.json"
        path.write_text(json.dumps(fc.EXAMPLE_POLICY))
        pol = fc.load_policy(str(path))
        assert pol.max_replicas == fc.EXAMPLE_POLICY["max_replicas"]
        assert pol.source == str(path)
        assert "version" in pol.to_dict()

        path.write_text("not json {")
        with pytest.raises(ValueError, match="not JSON"):
            fc.load_policy(str(path))

    def test_policy_from_env(self, tmp_path, monkeypatch):
        monkeypatch.delenv(fc.POLICY_ENV, raising=False)
        assert fc.policy_from_env() is None

        good = tmp_path / "good.json"
        good.write_text(json.dumps(fc.EXAMPLE_POLICY))
        monkeypatch.setenv(fc.POLICY_ENV, str(good))
        assert fc.policy_from_env() is not None

        bad = tmp_path / "bad.json"
        bad.write_text(json.dumps({"version": 1, "min_replicas": -3}))
        monkeypatch.setenv(fc.POLICY_ENV, str(bad))
        with pytest.warns(UserWarning, match="disarmed"):
            assert fc.policy_from_env() is None

    def test_defaults_fill(self):
        pol = fc.ControllerPolicy({"version": 1})
        assert pol.min_replicas >= 1
        assert pol.degrade["ladder"][0] == 0.0


# ---------------------------------------------------------------------------
# Retry-After plumbing (fault.retry units)


class TestRetryAfterHint:
    def test_parse_retry_after(self):
        assert parse_retry_after("1.5") == 1.5
        assert parse_retry_after("0") == 0.0
        assert parse_retry_after("-1") is None
        assert parse_retry_after("nan") is None
        assert parse_retry_after("soon") is None
        assert parse_retry_after("") is None
        assert parse_retry_after(None) is None

    def test_hinted_delay_caps_at_max(self):
        p = RetryPolicy(max_delay=0.5, jitter=None)
        assert p.hinted_delay(0.2) == 0.2
        assert p.hinted_delay(9.0) == 0.5

    def test_call_prefers_hint_over_backoff(self):
        calls = [0]

        def fn():
            calls[0] += 1
            if calls[0] <= 2:
                e = RuntimeError("overloaded")
                e.retry_after = 0.01
                raise e
            return "ok"

        # base_delay 5s would blow the 1s budget — proves the hint won.
        p = RetryPolicy(max_attempts=5, base_delay=5.0, jitter=None,
                        retryable=(RuntimeError,))
        t0 = time.monotonic()
        assert p.call(fn) == "ok"
        assert time.monotonic() - t0 < 1.0

    def test_hint_clamped_to_deadline(self):
        def fn():
            e = RuntimeError("overloaded")
            e.retry_after = 10.0
            raise e

        p = RetryPolicy(max_attempts=50, base_delay=0.01, jitter=None,
                        deadline=0.2, retryable=(RuntimeError,))
        t0 = time.monotonic()
        with pytest.raises(RetryError):
            p.call(fn)
        # a 10s hint honored verbatim would sleep past the deadline
        assert time.monotonic() - t0 < 2.0


# ---------------------------------------------------------------------------
# router admission control


@pytest.fixture()
def admission_router():
    stub = _StubReplica()
    router = FleetRouter(replicas=[stub.addr], poll_interval=0.1)
    router.start_background()
    yield router, stub
    router.shutdown()
    stub.close()


class TestAdmissionControl:
    def test_shed_carries_retry_after_clamped_to_deadline(
            self, admission_router):
        router, _ = admission_router
        addr = "%s:%d" % router.addr
        router.set_admission(1, 1.0, retry_after_s=5.0, reason="test")

        status, body, headers = _post(addr, headers={"X-Deadline-Ms": "250"})
        assert status == 429
        assert body["error"]["type"] == "admission_shed"
        assert body["retryable"] is True
        hint = float(headers["Retry-After"])
        assert 0.0 <= hint <= 0.25

        # without a caller deadline the advisory hint passes through
        status, _, headers = _post(addr)
        assert status == 429
        assert float(headers["Retry-After"]) == pytest.approx(5.0)

    def test_fractional_shed_interleaves(self, admission_router):
        router, stub = admission_router
        addr = "%s:%d" % router.addr
        router.set_admission(1, 0.5, retry_after_s=0.01)
        statuses = [_post(addr)[0] for _ in range(8)]
        assert statuses == [200, 429] * 4      # Bresenham: admit first
        assert stub.hits == 4

        router.set_admission(0, 0.0)
        assert all(_post(addr)[0] == 200 for _ in range(4))

    def test_admission_state_in_stats(self, admission_router):
        router, _ = admission_router
        router.set_admission(2, 0.75, retry_after_s=0.5, reason="drill")
        with urllib.request.urlopen(
                "http://%s:%d/stats" % router.addr, timeout=5) as resp:
            snap = json.loads(resp.read())
        adm = snap["router"]["admission"]
        assert adm["level"] == 2
        assert adm["shed_fraction"] == 0.75
        assert adm["reason"] == "drill"

    def test_shed_counter_moves(self, admission_router):
        router, _ = admission_router
        addr = "%s:%d" % router.addr
        before = profiler.runtime_metrics.counter("fleet.admission_shed")
        router.set_admission(1, 1.0, retry_after_s=0.01)
        assert _post(addr)[0] == 429
        after = profiler.runtime_metrics.counter("fleet.admission_shed")
        assert after == before + 1

    def test_exhausted_shed_has_retry_after(self):
        # static router pointed at a dead port: every attempt fails,
        # the resulting 503 must still carry backpressure advice
        router = FleetRouter(
            replicas=["127.0.0.1:9"],
            retry=RetryPolicy(max_attempts=2, base_delay=0.01, jitter=None),
            poll_interval=0.1)
        router.start_background()
        try:
            addr = "%s:%d" % router.addr
            status, body, headers = _post(addr, timeout=10.0)
            assert status == 503
            assert body["retryable"] is True
            assert "Retry-After" in headers
        finally:
            router.shutdown()


# ---------------------------------------------------------------------------
# clients honor Retry-After


class TestServingClientHonorsHint:
    def test_predict_waits_hint_not_backoff(self):
        def script(i):
            if i < 2:
                return (429, {"error": {"type": "admission_shed"},
                              "retryable": True},
                        {"Retry-After": "0.01"})
            return 200, {"outputs": [[[1.0]]]}, None

        stub = _StubReplica(script)
        try:
            client = ServingClient(
                stub.addr,
                retry=RetryPolicy(max_attempts=5, base_delay=5.0,
                                  jitter=None))
            t0 = time.monotonic()
            out = client.predict({"x": [[0.0]]})
            assert time.monotonic() - t0 < 2.0   # 5s backoff never slept
            assert out and stub.hits == 3
        finally:
            stub.close()

    def test_retry_error_history_annotates_hint(self):
        stub = _StubReplica(lambda i: (
            429, {"error": {"type": "admission_shed"}, "retryable": True},
            {"Retry-After": "0.01"}))
        try:
            client = ServingClient(
                stub.addr,
                retry=RetryPolicy(max_attempts=2, base_delay=0.01,
                                  jitter=None))
            with pytest.raises(RetryError) as ei:
                client.predict({"x": [[0.0]]})
            assert any("retry-after=0.01s" in h for h in ei.value.history)
        finally:
            stub.close()


# ---------------------------------------------------------------------------
# upstream 429 classification at the router


class Test429Classification:
    def test_failover_only_with_scrape_evidence_of_headroom(self):
        # A always sheds but advertises the most headroom (so the
        # shuffled tie-break deterministically tries it first);
        # B answers.  With scrape evidence the router retries B.
        shed = (429, {"error": {"type": "admission_shed"},
                      "retryable": True},
                {"Retry-After": "0.005"})
        a = _StubReplica(lambda i: shed,
                         gauges={"hbm.headroom_bytes": 1 << 30})
        b = _StubReplica()
        router = FleetRouter(replicas=[a.addr, b.addr], poll_interval=0.1)
        router.start_background()
        try:
            router._scraper.scrape()
            addr = "%s:%d" % router.addr
            for _ in range(4):
                assert _post(addr, timeout=10.0)[0] == 200
            assert a.hits >= 1          # A was tried, then failed over
            assert b.hits >= 4
        finally:
            router.shutdown()
            a.close()
            b.close()

    def test_passthrough_verbatim_without_alternative(self):
        a = _StubReplica(lambda i: (
            429, {"error": {"type": "admission_shed"}, "retryable": True},
            {"Retry-After": "0.123"}))
        router = FleetRouter(replicas=[a.addr], poll_interval=0.1)
        router.start_background()
        try:
            router._scraper.scrape()
            addr = "%s:%d" % router.addr
            status, _, headers = _post(addr)
            assert status == 429
            assert headers["Retry-After"] == "0.123"
        finally:
            router.shutdown()
            a.close()


# ---------------------------------------------------------------------------
# controller loop


def _policy(**over):
    p = {"version": 1, "min_replicas": 1, "max_replicas": 4,
         "standby_pool": 0, "ready_timeout_seconds": 5.0,
         "scale_up": {"pressure_ratio": 0.8, "sustained_ticks": 2,
                      "cooldown_seconds": 0.0},
         "scale_down": {"idle_rps_per_replica": 0.5, "sustained_ticks": 2,
                        "cooldown_seconds": 0.0},
         # engage_ratio 10 keeps the ladder quiet unless a test wants it
         "degrade": {"ladder": [0.0, 0.5, 1.0], "engage_ratio": 10.0,
                     "recover_ticks": 2, "retry_after_seconds": 0.25}}
    for k, v in over.items():
        if isinstance(v, dict):
            p[k].update(v)
        else:
            p[k] = v
    return p


@pytest.fixture()
def loop_rig():
    stub = _StubReplica()
    router = FleetRouter(replicas=[stub.addr], poll_interval=0.1)
    router.start_background()
    made = []

    def factory():
        r = FakeReplica()
        made.append(r)
        return r

    yield stub, router, made, factory
    router.shutdown()
    stub.close()


class TestControllerLoop:
    def test_ladder_climbs_and_recovers_with_hysteresis(self, loop_rig):
        _, router, _, factory = loop_rig
        m = RuntimeMetrics()
        wd = FakeWatchdog()
        ctl = FleetController(
            router, policy=_policy(degrade={"engage_ratio": 0.95},
                                   scale_up={"pressure_ratio": 99.0}),
            standby_factory=factory, watchdog=wd, metrics=m)

        wd.set_pressure(1.2)
        ctl.tick()
        assert ctl.state()["degrade_level"] == 1
        assert router.admission_state()["shed_fraction"] == 0.5
        ctl.tick()
        assert ctl.state()["degrade_level"] == 2
        assert router.admission_state()["shed_fraction"] == 1.0
        ctl.tick()
        assert ctl.state()["degrade_level"] == 2      # top rung holds

        wd.set_pressure(0.2)
        ctl.tick()
        assert ctl.state()["degrade_level"] == 2      # 1 healthy tick
        ctl.tick()
        assert ctl.state()["degrade_level"] == 1      # hysteresis step
        ctl.tick()
        ctl.tick()
        assert ctl.state()["degrade_level"] == 0
        assert router.admission_state()["shed_fraction"] == 0.0
        assert m.counter("controller.degrade_steps") >= 4
        ctl.shutdown()

    def test_scale_up_after_sustained_pressure(self, loop_rig):
        _, router, made, factory = loop_rig
        m = RuntimeMetrics()
        wd = FakeWatchdog()
        ctl = FleetController(router, policy=_policy(standby_pool=1),
                              standby_factory=factory, watchdog=wd,
                              metrics=m)
        assert ctl.prewarm() == 1
        assert made[0].warmed and not made[0].enrolled

        wd.set_pressure(0.9)
        ctl.tick()
        assert m.counter("controller.scale_ups") == 0   # 1 of 2 ticks
        ctl.tick()
        assert m.counter("controller.scale_ups") == 1
        assert made[0].enrolled                  # standby promoted, not cold
        assert ctl.state()["owned"] == [made[0].replica_id]
        ctl.shutdown()

    def test_scale_up_capped_at_max_replicas(self, loop_rig):
        _, router, _, factory = loop_rig
        m = RuntimeMetrics()
        wd = FakeWatchdog()
        ctl = FleetController(router, policy=_policy(max_replicas=1),
                              standby_factory=factory, watchdog=wd,
                              metrics=m)
        wd.set_pressure(5.0)
        for _ in range(4):
            ctl.tick()
        assert m.counter("controller.scale_ups") == 0
        ctl.shutdown()

    def test_scale_stall_failpoint_loses_one_promotion(self, loop_rig):
        _, router, made, factory = loop_rig
        m = RuntimeMetrics()
        ctl = FleetController(router, policy=_policy(),
                              standby_factory=factory,
                              watchdog=FakeWatchdog(), metrics=m)
        chaos.inject("fleet.scale.stall", error=True, times=1)
        assert ctl.scale_up(reason="drill") is None
        assert m.counter("controller.scale_stalls") == 1
        assert ctl.scale_up(reason="drill") is not None
        assert made[-1].enrolled
        ctl.shutdown()

    def test_standby_fail_failpoint(self, loop_rig):
        _, router, made, factory = loop_rig
        m = RuntimeMetrics()
        ctl = FleetController(router, policy=_policy(standby_pool=1),
                              standby_factory=factory,
                              watchdog=FakeWatchdog(), metrics=m)
        chaos.inject("fleet.standby.fail", error=True, times=1)
        assert ctl.prewarm(raise_on_failure=False) == 0
        assert m.counter("controller.standby_warm_failures") == 1
        with pytest.raises(RuntimeError):
            chaos.inject("fleet.standby.fail", error=True, times=1)
            ctl.prewarm()
        chaos.clear()
        assert ctl.prewarm() == 1
        assert made[-1].warmed
        ctl.shutdown()

    def test_scale_down_drains_idle_owned_replica(self):
        a, b = _StubReplica(), _StubReplica()
        router = FleetRouter(replicas=[a.addr, b.addr], poll_interval=0.1)
        router.start_background()
        try:
            m = RuntimeMetrics()
            wd = FakeWatchdog()
            wd.set_pressure(0.0)
            ctl = FleetController(
                router,
                policy=_policy(scale_down={"sustained_ticks": 2},
                               scale_up={"pressure_ratio": 99.0}),
                standby_factory=FakeReplica, watchdog=wd, metrics=m)
            owned = ctl.scale_up(reason="test")
            assert owned is not None
            # tick 1 seeds the rate window; later ticks see rps 0.0
            for _ in range(4):
                ctl.tick()
                time.sleep(0.02)
            assert owned.drained
            assert m.counter("controller.scale_downs") == 1
            assert ctl.state()["owned"] == []
            ctl.shutdown()
        finally:
            router.shutdown()
            a.close()
            b.close()

    def test_never_drains_while_degraded(self):
        a, b = _StubReplica(), _StubReplica()
        router = FleetRouter(replicas=[a.addr, b.addr], poll_interval=0.1)
        router.start_background()
        try:
            m = RuntimeMetrics()
            wd = FakeWatchdog()
            ctl = FleetController(
                router,
                policy=_policy(scale_down={"sustained_ticks": 1},
                               scale_up={"pressure_ratio": 99.0},
                               degrade={"engage_ratio": 0.9,
                                        "recover_ticks": 1000}),
                standby_factory=FakeReplica, watchdog=wd, metrics=m)
            owned = ctl.scale_up(reason="test")
            wd.set_pressure(1.5)
            ctl.tick()                       # engages the ladder
            assert ctl.state()["degrade_level"] >= 1
            wd.set_pressure(0.0)             # idle by rps, but degraded
            for _ in range(4):
                ctl.tick()
                time.sleep(0.02)
            assert not owned.drained
            assert m.counter("controller.scale_downs") == 0
            ctl.shutdown()
        finally:
            router.shutdown()
            a.close()
            b.close()

    def test_shutdown_drains_standbys_and_owned(self, loop_rig):
        _, router, made, factory = loop_rig
        ctl = FleetController(router, policy=_policy(standby_pool=1),
                              standby_factory=factory,
                              watchdog=FakeWatchdog(),
                              metrics=RuntimeMetrics())
        ctl.prewarm()
        ctl.scale_up(reason="test")
        ctl.shutdown(drain_owned=True)
        assert all(r.drained for r in made)

    def test_state_schema(self, loop_rig):
        _, router, _, factory = loop_rig
        ctl = FleetController(router, policy=_policy(),
                              standby_factory=factory,
                              watchdog=FakeWatchdog(),
                              metrics=RuntimeMetrics())
        ctl.tick()
        st = ctl.state()
        for key in ("policy", "degrade_level", "admission", "pressure",
                    "standbys", "owned", "live_replicas"):
            assert key in st
        ctl.shutdown()


# ---------------------------------------------------------------------------
# satellite: SLO watchdog episode re-arm under the controller loop


class TestEpisodeRearm:
    def test_one_postmortem_per_episode_no_duplicate_scaling(
            self, tmp_path, monkeypatch):
        from paddle_tpu_torch.obs.slo import SLOWatchdog

        monkeypatch.setenv("PADDLE_TPU_POSTMORTEM", str(tmp_path))
        stub = _StubReplica()
        router = FleetRouter(replicas=[stub.addr], poll_interval=0.1)
        router.start_background()
        try:
            m = RuntimeMetrics()
            wd = SLOWatchdog(
                {"version": 1, "interval_seconds": 0.001,
                 "sustained_breaches": 2,
                 "objectives": [{"name": "latency", "kind": "quantile",
                                 "series": "s", "quantile": "p99",
                                 "max": 0.1}]},
                metrics=m)
            ctl = FleetController(
                router,
                policy=_policy(
                    scale_up={"pressure_ratio": 0.8, "sustained_ticks": 1,
                              "cooldown_seconds": 3600.0},
                    degrade={"engage_ratio": 0.95, "recover_ticks": 1}),
                standby_factory=FakeReplica, watchdog=wd, metrics=m)

            def tick(n):
                for _ in range(n):
                    time.sleep(0.01)
                    ctl.tick()

            for _ in range(50):          # p99 well above 0.1s threshold
                m.observe("s", 1.0)
            tick(2)                      # 2 consecutive breaches -> dump
            assert m.counter("slo.postmortems") == 1
            assert m.counter("controller.scale_ups") == 1
            assert ctl.state()["degrade_level"] >= 1

            for _ in range(3000):        # recovery floods the window
                m.observe("s", 0.001)
            tick(3)
            assert m.gauge("slo.breaching") == 0
            assert ctl.state()["degrade_level"] == 0

            for _ in range(3000):        # second episode
                m.observe("s", 1.0)
            tick(2)
            # re-armed: exactly one more post-mortem; cooldown means the
            # controller does NOT fire a duplicate scale action
            assert m.counter("slo.postmortems") == 2
            assert m.counter("controller.scale_ups") == 1
            assert os.path.exists(
                os.path.join(str(tmp_path),
                             "postmortem-%d.json" % os.getpid()))
            ctl.shutdown()
        finally:
            router.shutdown()
            stub.close()


# ---------------------------------------------------------------------------
# traffic replay


class TestPatterns:
    def test_step(self):
        r = step(2.0, 10.0, at=5.0)
        assert r(0.0) == 2.0
        assert r(4.99) == 2.0
        assert r(5.0) == 10.0
        assert r(100.0) == 10.0

    def test_step_with_duration_reverts(self):
        r = step(2.0, 10.0, at=5.0, duration=3.0)
        assert r(6.0) == 10.0
        assert r(8.0) == 2.0

    def test_diurnal_trough_and_peak(self):
        r = diurnal(1.0, 9.0, period=60.0)
        assert r(0.0) == pytest.approx(1.0)
        assert r(30.0) == pytest.approx(9.0)
        assert r(60.0) == pytest.approx(1.0)
        assert 1.0 < r(10.0) < 9.0

    def test_flash_crowd_rise_and_decay(self):
        r = flash_crowd(1.0, 21.0, at=2.0, rise=0.5, fall=1.0)
        assert r(1.0) == 1.0
        assert r(2.25) == pytest.approx(11.0)   # mid-rise
        peak = r(2.5)
        assert peak == pytest.approx(21.0)
        assert 1.0 < r(4.0) < peak              # decaying
        assert r(30.0) == pytest.approx(1.0, abs=0.01)

    def test_heavy_tail_lengths(self):
        a = heavy_tail_lengths(500, seed=3, median=32, cap=512)
        b = heavy_tail_lengths(500, seed=3, median=32, cap=512)
        assert a == b                           # seeded
        assert a != heavy_tail_lengths(500, seed=4, median=32, cap=512)
        assert all(1 <= n <= 512 for n in a)
        s = sorted(a)
        med = s[len(s) // 2]
        assert 16 <= med <= 64                  # near the target median
        assert s[-1] > 4 * med                  # the heavy tail exists


def _replay(send, pattern, duration, **kw):
    m = kw.pop("metrics", RuntimeMetrics())
    replay = TrafficReplay(send, pattern, duration, metrics=m, **kw)
    return replay.run(), m


class TestReplay:
    def test_classification_and_hint_split(self):
        # deterministic outcome script keyed by arrival index
        script = [
            {"status": 200},
            {"status": 429, "retry_after": "0.5"},
            {"status": 429, "retry_after": None},
            {"status": 503, "retry_after": "1.0"},
            {"status": 504},
            {"status": 500},
            "raise",
        ]

        def send(i):
            entry = script[i % len(script)]
            if entry == "raise":
                raise ConnectionError("boom")
            return entry

        summary, m = _replay(send, lambda t: 200.0, 0.5, seed=1)
        n = summary["attempted"]
        assert n > 20
        out = summary["outcomes"]
        assert out["ok"] == m.counter("traffic.ok") > 0
        assert out["shed"] == m.counter("traffic.shed") > 0
        assert out["deadline"] == m.counter("traffic.deadline_exceeded") > 0
        assert out["error"] == m.counter("traffic.errors") > 0
        assert summary["shed_with_hint"] + summary["shed_without_hint"] \
            == out["shed"]
        assert summary["shed_without_hint"] > 0   # the None-hint 429s
        assert summary["lost_accepted"] == out["error"] + out["deadline"]
        assert m.counter("traffic.sent") == n   # every arrival metered

    def test_same_seed_same_schedule(self):
        def send(i):
            return {"status": 200}

        s1, _ = _replay(send, step(50.0, 200.0, at=0.25), 0.5, seed=9)
        s2, _ = _replay(send, step(50.0, 200.0, at=0.25), 0.5, seed=9)
        s3, _ = _replay(send, step(50.0, 200.0, at=0.25), 0.5, seed=10)
        assert s1["attempted"] == s2["attempted"]
        assert s1["attempted"] != s3["attempted"]

    def test_inflight_cap_counts_dropped(self):
        release = threading.Event()

        def send(i):
            release.wait(timeout=10.0)
            return {"status": 200}

        m = RuntimeMetrics()
        replay = TrafficReplay(send, lambda t: 100.0, 0.3, seed=2,
                               max_inflight=2, metrics=m)
        done = {}

        def run():
            done["summary"] = replay.run()

        t = threading.Thread(target=run, daemon=True)
        t.start()
        time.sleep(0.4)
        release.set()
        t.join(timeout=10.0)
        summary = done["summary"]
        assert summary["outcomes"]["dropped"] > 0
        assert summary["outcomes"]["dropped"] == m.counter("traffic.dropped")
        assert summary["outcomes"]["ok"] <= 2 + summary["attempted"]
        # dropped arrivals were still offered load
        assert m.counter("traffic.sent") == summary["attempted"]

    def test_zero_rate_stretch_sends_nothing(self):
        sent = []

        def send(i):
            sent.append(i)
            return {"status": 200}

        summary, m = _replay(send, lambda t: 0.0, 0.3, seed=0)
        assert summary["attempted"] == 0
        assert sent == []
        assert m.counter("traffic.sent") == 0

    def test_latency_percentiles_over_ok_only(self):
        def send(i):
            time.sleep(0.01)
            return {"status": 200}

        summary, _ = _replay(send, lambda t: 50.0, 0.4, seed=5)
        assert summary["latency_ms"]["p50"] >= 10.0
        assert summary["latency_ms"]["p99"] >= summary["latency_ms"]["p50"]


# ---------------------------------------------------------------------------
# across the packages: policy problems, controller decisions, schedules


def _bad_policy(pkg_fc, **over):
    p = json.loads(json.dumps(pkg_fc.EXAMPLE_POLICY))
    for k, v in over.items():
        if isinstance(v, dict):
            p[k].update(v)
        else:
            p[k] = v
    return p


BAD_POLICIES = [
    {"version": 2},
    {"min_replicas": 5, "max_replicas": 2},
    {"degrade": {"ladder": [0.1, 0.5]}},
    {"degrade": {"ladder": [0.0, 0.8, 0.2]}},
    {"degrade": {"ladder": [0.0, 1.5]}},
    {"scale_up": {"sustained_ticks": 0}},
    {"bogus_knob": 1},
    {"min_replicas": -3, "standby_pool": "two"},
]


@pytest.mark.parametrize("over", BAD_POLICIES,
                         ids=[",".join(o) for o in BAD_POLICIES])
def test_validate_policy_problems_match_reference(over):
    assert fc.EXAMPLE_POLICY == jax_fc.EXAMPLE_POLICY
    got = fc.validate_policy(_bad_policy(fc, **over))
    assert got and got == jax_fc.validate_policy(_bad_policy(jax_fc, **over))


PRESSURES = [1.2, 1.2, 1.2, 0.2, 0.2, 0.2, 0.2, 0.9, 0.9, 0.9, 5.0, 5.0,
             0.0, 0.0, 0.0, 0.0, 0.0, 0.0]


def _decisions(pkg):
    """Each tick's (ladder rung, shed fraction, scale-ups, scale-downs,
    owned, standbys) of ``pkg``'s controller over ``PRESSURES`` on two
    stub replicas, with a warm standby pool of one."""
    metrics = (jax_profiler if pkg == "jax" else profiler).RuntimeMetrics()
    if pkg == "jax":
        router_cls, ctl_cls = jax_fleet.FleetRouter, jax_fleet.FleetController
    else:
        router_cls, ctl_cls = FleetRouter, FleetController
    stubs = [_StubReplica(), _StubReplica()]
    router = router_cls(replicas=[s.addr for s in stubs], poll_interval=0.1)
    router.start_background()
    made = []

    def factory():
        r = FakeReplica()
        made.append(r)
        return r

    try:
        wd = FakeWatchdog()
        ctl = ctl_cls(router, policy=_policy(
            standby_pool=1, max_replicas=3,
            scale_down={"sustained_ticks": 3},
            degrade={"engage_ratio": 1.0}),
            standby_factory=factory, watchdog=wd, metrics=metrics)
        assert ctl.prewarm() == 1
        out = []
        for p in PRESSURES:
            wd.set_pressure(p)
            ctl.tick()
            time.sleep(0.02)      # the idle check reads a rate window
            st = ctl.state()
            out.append((st["degrade_level"],
                        router.admission_state()["shed_fraction"],
                        metrics.counter("controller.scale_ups"),
                        metrics.counter("controller.scale_downs"),
                        len(st["owned"]), len(st["standbys"])))
        ctl.shutdown(drain_owned=True)
        assert all(r.drained for r in made)
        return out
    finally:
        router.shutdown()
        for s in stubs:
            s.close()


def test_controller_decisions_match_reference():
    """The same pressure sequence drives both packages' controllers
    through the same rungs, promotions and drains, tick by tick."""
    got = _decisions("torch")
    assert got == _decisions("jax")
    levels = [d[0] for d in got]
    assert max(levels) == 2 and levels[-1] == 0     # climbed and recovered
    assert got[-1][2] >= 1 and got[-1][3] >= 1      # scaled up and down


class _VirtualClock:
    """``time`` for a traffic module: ``sleep`` advances a virtual clock
    that ``monotonic`` / ``perf_counter`` read, so a replay's arrival
    times are its schedule, free of this machine's scheduling."""

    def __init__(self):
        self.now = 1000.0
        self._lock = threading.Lock()

    def monotonic(self):
        with self._lock:
            return self.now

    perf_counter = time_ = monotonic

    def time(self):
        return self.monotonic()

    def sleep(self, d):
        with self._lock:
            self.now += max(0.0, d)


@pytest.mark.parametrize("pattern", [
    ("step", (20.0, 200.0), {"at": 0.5}),
    ("diurnal", (10.0, 90.0), {"period": 1.0}),
    ("flash_crowd", (5.0, 150.0), {"at": 0.3, "rise": 0.2, "fall": 0.4}),
], ids=lambda p: p[0])
def test_replay_schedule_and_lengths_match_reference(pattern, monkeypatch):
    name, args, kw = pattern
    runs = {}
    for pkg, mod in (("torch", torch_traffic), ("jax", jax_traffic)):
        clock = _VirtualClock()
        monkeypatch.setattr(mod, "time", clock)
        sent = []

        def send(i, sent=sent, clock=clock):
            sent.append((i, round(clock.monotonic() - 1000.0, 12)))
            return {"status": 200}

        replay = mod.TrafficReplay(send, getattr(mod, name)(*args, **kw),
                                   1.5, seed=11,
                                   metrics=(profiler if pkg == "torch"
                                            else jax_profiler)
                                   .RuntimeMetrics())
        summary = replay.run()
        runs[pkg] = (sorted(sent), summary["attempted"],
                     summary["outcomes"])
    assert runs["torch"] == runs["jax"]
    assert runs["torch"][1] > 20
    for seed in (0, 3):
        assert heavy_tail_lengths(400, seed=seed, median=24, cap=256) == \
            jax_traffic.heavy_tail_lengths(400, seed=seed, median=24,
                                           cap=256)
