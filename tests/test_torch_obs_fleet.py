"""The port's fleet observability on the CPU (``obs.aggregate`` and
``fleet-stats``): the JAX package's federation, trace-assembly and CLI
tests (``tests/test_obs_fleet.py``) run against the port's scraper and
its servers on ``CPUPlace()``, and the two packages against each other:
``render_federated``, ``merged_quantile``, ``replica_perf`` and
``assemble_fleet_trace`` give the JAX package's output, exactly, on the
same scrapes and span payloads.

Every server is shut down in a ``finally``; every scrape has a
timeout."""

import json
import os
import time

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu.layers as layers
from paddle_tpu.obs import aggregate as jax_aggregate
from paddle_tpu_torch import CPUPlace, cli, profiler
from paddle_tpu_torch.obs import aggregate, trace
from paddle_tpu_torch.profiler import RuntimeMetrics
from paddle_tpu_torch.serving import InferenceServer

from tests.test_obs_prom import assert_conformant


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_obs_fleet") / "model")
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = layers.data(name="x", shape=[4])
        pred = layers.fc(input=x, size=2)
        exe = fluid.Executor()
        exe.run(startup)
        fluid.io.save_inference_model(d, ["x"], [pred], exe,
                                      main_program=main)
    return d


def _addr(server):
    return f"{server.addr[0]}:{server.addr[1]}"


class TestFederation:
    def test_scrape_federate_and_stale_marking(self, model_dir):
        a = InferenceServer(model_dir, port=0, place=CPUPlace())
        b = InferenceServer(model_dir, port=0, place=CPUPlace())
        a.start_background()
        b.start_background()
        targets = [(_addr(a), "ra"), (_addr(b), "rb")]
        scraper = aggregate.FleetScraper(lambda: targets, timeout=5.0)
        try:
            profiler.runtime_metrics.inc("serving.requests_ok", 3)
            text, scrapes = scraper.federate()
            assert all(s["ok"] for s in scrapes)
            assert_conformant(text)
            # per-replica labels + liveness rows for both replicas
            for addr, rid in targets:
                assert (f'paddle_tpu_fleet_replica_up{{replica="{addr}"'
                        f',id="{rid}",stale="0"}} 1') in text
                assert f'replica="{addr}"' in text
            # first pass: totals but no rates yet
            assert "paddle_tpu_fleet_rps" not in text
            assert "paddle_tpu_fleet_replicas_scraped 2" in text
            assert "paddle_tpu_fleet_replicas_stale 0" in text

            # second pass computes rates from counter deltas
            profiler.runtime_metrics.inc("serving.requests_ok", 5)
            text, _ = scraper.federate()
            assert "paddle_tpu_fleet_rps " in text

            # kill one replica: the rollup must still render, with the
            # corpse marked stale instead of failing the scrape
            b.shutdown()
            errors0 = profiler.runtime_metrics.counter(
                "fleet.scrape.errors")
            text, scrapes = scraper.federate()
            assert_conformant(text)
            by_addr = {s["addr"]: s for s in scrapes}
            assert by_addr[_addr(a)]["ok"]
            assert not by_addr[_addr(b)]["ok"]
            assert by_addr[_addr(b)]["error"]
            assert (f'paddle_tpu_fleet_replica_up{{replica='
                    f'"{_addr(b)}",id="rb",stale="1"}} 0') in text
            assert "paddle_tpu_fleet_replicas_stale 1" in text
            # the live replica's samples still carry its label
            assert f'replica="{_addr(a)}"' in text
            assert f'total{{replica="{_addr(b)}"}}' not in text
            assert profiler.runtime_metrics.counter(
                "fleet.scrape.errors") > errors0
        finally:
            a.shutdown()
            try:
                b.shutdown()
            except Exception:
                pass

    def test_rates_survive_replica_death_between_scrapes(self):
        """Review regression: deltas are per-replica — a replica dying
        (its counters leaving the live sum) must not zero the
        survivors' reported fleet rate."""
        m = RuntimeMetrics()

        def scrape_of(addr, requests):
            return {"addr": addr, "id": addr, "ok": True,
                    "stats": {"counters":
                              {"serving.requests_ok": requests}}}

        scraper = aggregate.FleetScraper(lambda: [], metrics=m)
        rps, _ = scraper._rates([scrape_of("a", 10000),
                                 scrape_of("b", 10000)])
        assert rps is None                      # first pass: no window
        time.sleep(0.02)
        # b died; a served 50 more requests — the fleet rate is a's
        # delta, NOT max(0, 10050 - 20000) == 0
        rps, _ = scraper._rates([scrape_of("a", 10050)])
        assert rps is not None and rps > 0
        time.sleep(0.02)
        # b restarts with reset counters: clamped per-replica, a's
        # delta still counts
        rps, _ = scraper._rates([scrape_of("a", 10100),
                                 scrape_of("b", 3)])
        assert rps is not None and rps > 0

    def test_merged_quantile_is_count_weighted(self):
        def scrape(count, p99):
            return {"ok": True, "stats": {"series": {
                "gen.ttft_seconds": {"count": count, "p99": p99}}}}
        scrapes = [scrape(30, 0.1), scrape(10, 0.5),
                   {"ok": False, "stats": None}]
        got = aggregate.merged_quantile(scrapes, "gen.ttft_seconds",
                                        "p99")
        assert got == pytest.approx((30 * 0.1 + 10 * 0.5) / 40)
        assert aggregate.merged_quantile(scrapes, "nope") is None


def _payload(pid, proc, spans, epoch_unix, now_unix):
    return {"pid": pid, "process_name": proc, "epoch_unix": epoch_unix,
            "now_unix": now_unix, "spans": spans}


class TestTraceAssembly:
    def _span(self, name, ts, span_id, pid, trace_id="rid-1"):
        return {"name": name, "trace_id": trace_id, "span_id": span_id,
                "parent_id": None, "ts": ts, "dur": 0.01, "tid": 1,
                "pid": pid, "proc": None, "attrs": {}}

    def test_skew_normalization_against_envelope(self):
        """A replica whose wall clock is 100s ahead still lands its
        spans where they belong on the assembler's timeline: the
        send/recv envelope pins the offset."""
        zero = 1000.0
        # assembler's own span at t=+1.0s
        local = _payload(10, "router",
                         [self._span("fleet.request", 1.0, 1, 10)],
                         epoch_unix=zero, now_unix=zero + 2.0)
        # the replica handled the same request ~1.05s in (its clock is
        # +100s skewed); the scrape happened at assembler time 2.0
        SKEW = 100.0
        remote = _payload(20, "replica:r0",
                          [self._span("serving.request", 0.05, 1, 20)],
                          epoch_unix=zero + 1.0 + SKEW,
                          now_unix=zero + 2.0 + SKEW)
        obj = aggregate.assemble_fleet_trace(
            [{"source": "router", "payload": local, "envelope": None},
             {"source": "r0", "payload": remote,
              "envelope": (zero + 1.99, zero + 2.01)}],
            zero_unix=zero)
        evs = [e for e in obj["traceEvents"] if e["ph"] == "X"]
        by_pid = {e["pid"]: e for e in evs}
        assert set(by_pid) == {10, 20}
        # local span at 1.0s; remote at ~1.05s on the SAME clock
        assert by_pid[10]["ts"] == pytest.approx(1.0 * 1e6)
        assert by_pid[20]["ts"] == pytest.approx(1.05 * 1e6, abs=0.1e6)
        offsets = {p["source"]: p["clock_offset_s"]
                   for p in obj["fleetAssembly"]["processes"]}
        assert offsets["r0"] == pytest.approx(SKEW, abs=0.1)
        # one process_name metadata row per pid
        meta = {e["pid"]: e["args"]["name"]
                for e in obj["traceEvents"]
                if e["ph"] == "M" and e["name"] == "process_name"}
        assert meta[20] == "replica:r0" and meta[10] == "router"

    def test_colliding_os_pids_stay_distinct_processes(self):
        """Review regression: containerized replicas all run as pid 1 —
        identity is (pid, process_name), so neither replica's spans are
        dropped and each keeps its own (remapped) timeline row."""
        zero = 0.0
        a = _payload(1, "replica:r0",
                     [self._span("serving.request", 1.0, 1, 1)],
                     zero, zero + 2.0)
        b = _payload(1, "replica:r1",
                     [self._span("serving.request", 1.1, 1, 1)],
                     zero, zero + 2.0)
        obj = aggregate.assemble_fleet_trace(
            [{"source": "r0", "payload": a,
              "envelope": (zero + 1.9, zero + 2.1)},
             {"source": "r1", "payload": b,
              "envelope": (zero + 1.9, zero + 2.1)}],
            zero_unix=zero)
        evs = [e for e in obj["traceEvents"] if e["ph"] == "X"]
        assert len(evs) == 2                    # nothing deduped away
        assert len({e["pid"] for e in evs}) == 2  # two distinct rows
        meta = {e["args"]["name"] for e in obj["traceEvents"]
                if e["ph"] == "M" and e["name"] == "process_name"}
        assert {"replica:r0", "replica:r1"} <= meta
        procs = obj["fleetAssembly"]["processes"]
        assert all(p["os_pid"] == 1 for p in procs)
        assert len({p["pid"] for p in procs}) == 2

    def test_dedupe_and_failures_reported(self):
        zero = 0.0
        spans = [self._span("a", 1.0, 7, 10)]
        p = _payload(10, "proc", spans, zero, zero + 1.5)
        obj = aggregate.assemble_fleet_trace(
            [{"source": "self", "payload": p, "envelope": None},
             # the same ring scraped twice (in-process fleet): deduped
             {"source": "again", "payload": p,
              "envelope": (zero + 1.4, zero + 1.6)},
             {"source": "corpse", "error": "ConnectionError: down"}],
            zero_unix=zero)
        evs = [e for e in obj["traceEvents"] if e["ph"] == "X"]
        assert len(evs) == 1
        assert obj["fleetAssembly"]["failures"] == [
            {"source": "corpse", "error": "ConnectionError: down"}]

    def test_live_servers_spans_endpoint_assembles(self, model_dir):
        """/spans end-to-end: scrape a real server's ring and merge it
        with the local one."""
        server = InferenceServer(model_dir, port=0, place=CPUPlace())
        server.start_background()
        trace.enable(4096)
        try:
            with trace.trace_context("rid-spans-1"), \
                    trace.span("local.mark"):
                pass
            payload, envelope = aggregate.fetch_spans(_addr(server))
            assert payload["pid"] == os.getpid()  # in-process server
            assert envelope[0] <= envelope[1]
            obj = aggregate.assemble_fleet_trace(
                [{"source": "local",
                  "payload": trace.snapshot_payload(),
                  "envelope": None},
                 {"source": _addr(server), "payload": payload,
                  "envelope": envelope}])
            names = {e["name"] for e in obj["traceEvents"]}
            assert "local.mark" in names
        finally:
            server.shutdown()
            trace.disable()
            trace.clear()


class TestFleetStatsCLI:
    def test_fleet_stats_static_replicas(self, model_dir, capsys):
        server = InferenceServer(model_dir, port=0, place=CPUPlace())
        server.start_background()
        try:
            rc = cli.main(["fleet-stats", "--replicas", _addr(server)])
            assert rc == 0
            out = capsys.readouterr().out
            assert_conformant(out)
            assert f'replica="{_addr(server)}"' in out
            rc = cli.main(["fleet-stats", "--replicas", _addr(server),
                           "--json"])
            assert rc == 0
            report = json.loads(capsys.readouterr().out)
            assert report["replicas"][0]["ok"] is True
        finally:
            server.shutdown()

    def test_fleet_stats_needs_a_target(self, capsys):
        assert cli.main(["fleet-stats"]) == 2


# ---------------------------------------------------------------------------
# across the packages: the same scrapes and payloads, the same output
# ---------------------------------------------------------------------------

def _scrapes(seed):
    """Three replicas' ``/stats`` scrapes (one dead) with counters,
    gauges, series and histograms drawn from ``seed``."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(3):
        addr = f"127.0.0.1:{9100 + i}"
        if i == 2:
            out.append({"addr": addr, "id": f"r{i}", "ok": False,
                        "error": "ConnectionError: refused",
                        "stats": None, "rtt_s": None})
            continue
        series = {name: {"count": int(rng.randint(1, 500)),
                         **{q: float(rng.rand()) for q in
                            ("p50", "p95", "p99")},
                         "sum": float(rng.rand() * 10)}
                  for name in ("gen.ttft_seconds", "serving.latency",
                               "gen.decode_step_seconds")}
        gauges = {"hbm.headroom_bytes": float(rng.randint(1, 80) << 30),
                  "hbm.total_bytes": float(80 << 30),
                  "gen.decode_mfu": float(rng.rand()),
                  "serving.queue_depth": float(rng.randint(0, 9))}
        stats = {"counters": {"serving.requests_ok": int(rng.randint(1e4)),
                              "gen.tokens": int(rng.randint(1e5)),
                              "fleet.scrape.errors": 0},
                 "gauges": gauges, "series": series,
                 "histograms": {"gen.batch_occupancy":
                                {"1": int(rng.randint(9)),
                                 "4": int(rng.randint(9))}}}
        out.append({"addr": addr, "id": f"r{i}", "ok": True,
                    "error": None, "stats": stats,
                    "rtt_s": float(rng.rand() / 100)})
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_federated_text_matches_reference(seed):
    scrapes = _scrapes(seed)
    for kw in ({}, {"rps": 12.5, "tokens_per_sec": 3456.25}):
        text = aggregate.render_federated(scrapes, **kw)
        assert text == jax_aggregate.render_federated(scrapes, **kw)
        assert_conformant(text)
    assert aggregate.replica_perf(scrapes) == \
        jax_aggregate.replica_perf(scrapes)
    for series in ("gen.ttft_seconds", "serving.latency", "nope"):
        for q in ("p50", "p99"):
            assert aggregate.merged_quantile(scrapes, series, q) == \
                jax_aggregate.merged_quantile(scrapes, series, q)


def test_fleet_trace_matches_reference():
    rng = np.random.RandomState(2)

    def spans(pid, n):
        return [{"name": f"op{j % 3}", "trace_id": f"rid-{j % 4}",
                 "span_id": j + 1, "parent_id": None,
                 "ts": float(rng.rand() * 5), "dur": float(rng.rand()),
                 "tid": 1 + j % 2, "pid": pid, "proc": None,
                 "attrs": {"k": j}} for j in range(n)]

    zero = 5000.0
    sources = [
        {"source": "router", "payload": _payload(
            10, "router", spans(10, 6), zero, zero + 9.0),
         "envelope": None},
        {"source": "127.0.0.1:9100", "payload": _payload(
            1, "replica:r0", spans(1, 5), zero + 37.5, zero + 46.25),
         "envelope": (zero + 8.9, zero + 9.1)},
        {"source": "127.0.0.1:9101", "payload": _payload(
            1, "replica:r1", spans(1, 4), zero - 3.0, zero + 6.0),
         "envelope": (zero + 8.95, zero + 9.05)},
        {"source": "127.0.0.1:9102", "error": "ConnectionError: down"},
    ]
    got = aggregate.assemble_fleet_trace(json.loads(json.dumps(sources)),
                                         zero_unix=zero)
    want = jax_aggregate.assemble_fleet_trace(
        json.loads(json.dumps(sources)), zero_unix=zero)
    assert got == want
    assert len(got["fleetAssembly"]["processes"]) == 3
