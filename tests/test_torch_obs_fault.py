"""The port's own copies of the observability and fault modules against
the JAX package's: the same operations through both give the same
Chrome trace export (timestamps, durations, pids and thread ids left
out), the same Prometheus text, the same percentiles and snapshots, the
same SLO verdicts, the same chaos spec parsing and firing, the same
seeded retry backoff, and the same PTA codes from ``check_gen_bundle``
on a good bundle and on hand-broken metas.

Everything here is host code: values are compared exactly."""

import json
import random

import pytest

from paddle_tpu import profiler as jax_profiler
from paddle_tpu.analysis import check_gen_bundle as jax_check_gen_bundle
from paddle_tpu.analysis.distributed import \
    load_saved_program as jax_load_saved_program
from paddle_tpu.fault import chaos as jax_chaos
from paddle_tpu.fault import retry as jax_retry
from paddle_tpu.models import gen_lm as jax_gen_lm
from paddle_tpu.obs import prom as jax_prom
from paddle_tpu.obs import slo as jax_slo
from paddle_tpu.obs import trace as jax_trace
from paddle_tpu_torch import profiler as torch_profiler
from paddle_tpu_torch.analysis import \
    check_gen_bundle as torch_check_gen_bundle
from paddle_tpu_torch.analysis.distributed import \
    load_saved_program as torch_load_saved_program
from paddle_tpu_torch.fault import chaos as torch_chaos
from paddle_tpu_torch.fault import retry as torch_retry
from paddle_tpu_torch.obs import prom as torch_prom
from paddle_tpu_torch.obs import slo as torch_slo
from paddle_tpu_torch.obs import trace as torch_trace

# ---------------------------------------------------------------------------
# trace
# ---------------------------------------------------------------------------

def _record(trace):
    """The same nested spans, a trace context and a cross-thread
    ``record_span``, through one package's ``trace``."""
    import threading
    import time

    with trace.trace_context("req-1"):
        with trace.span("serving.request", request_id="req-1", port=1):
            with trace.span("serving.dispatch", size=3) as sp:
                sp.set(rows=12)
            t0 = time.perf_counter()

    def other():
        trace.record_span("serving.queue_wait", t0, 0.001,
                          trace_id="req-1")

    th = threading.Thread(target=other)
    th.start()
    th.join()
    with trace.span("gen.decode_step"):
        pass


def _strip(chrome):
    """The Chrome export without what differs run to run: timestamps,
    durations, pids, thread ids and the random span and trace ids
    (replaced by their order of first appearance; a trace id set by
    ``trace_context`` is kept)."""
    ids = {}

    def norm(v):
        return ids.setdefault(v, f"id{len(ids)}")

    out = []
    for ev in chrome["traceEvents"]:
        ev = {k: v for k, v in ev.items()
              if k not in ("ts", "dur", "pid", "tid")}
        args = dict(ev.get("args", {}))
        for k in ("span_id", "parent_id", "trace_id"):
            if k in args and args[k] != "req-1":
                args[k] = norm(args[k])
        ev["args"] = args
        out.append(ev)
    return {"traceEvents": out, "displayTimeUnit": chrome["displayTimeUnit"]}


@pytest.fixture
def traces_on():
    """Both rings on and empty, and no process name (the first caller of
    ``set_process_name`` wins, so one left by an earlier test in the
    process is cleared here and put back after)."""
    was = [(t, t.enabled(), t.process_name())
           for t in (jax_trace, torch_trace)]
    for t, _, _ in was:
        t.enable(64)
        t.clear()
        t.set_process_name(None)
    yield
    for t, on, name in was:
        t.clear()
        t.set_process_name(None)
        t.set_process_name(name)
        if not on:
            t.disable()


def test_chrome_trace_export_matches(traces_on):
    exports = []
    for trace in (jax_trace, torch_trace):
        trace.set_process_name("replica")
        _record(trace)
        exports.append(_strip(json.loads(trace.dump_chrome_trace())))
        trace.set_process_name(None)
    assert exports[0] == exports[1]
    names = [e["name"] for e in exports[1]["traceEvents"]]
    assert names == ["process_name", "serving.dispatch", "serving.request",
                     "serving.queue_wait", "gen.decode_step"]


def test_disabled_trace_records_nothing_in_both():
    for trace in (jax_trace, torch_trace):
        was = trace.enabled()
        trace.disable()
        try:
            with trace.span("serving.request"):
                pass
            assert trace.snapshot_spans() == [] or not was
        finally:
            if was:
                trace.enable()


def test_trace_env_parsing_matches():
    for value in ("", "0", "1", "true", "128", "bogus"):
        got = []
        for trace in (jax_trace, torch_trace):
            was = trace.enabled()
            try:
                got.append(trace.configure_from_env(value))
            finally:
                trace.enable() if was else trace.disable()
        assert got[0] == got[1], value


# ---------------------------------------------------------------------------
# runtime metrics and Prometheus
# ---------------------------------------------------------------------------

def _fill(metrics):
    for i in range(1, 41):
        metrics.observe("gen.ttft_seconds", i * 0.0125)
        metrics.observe("serving.request_seconds", (i % 7) * 0.5)
    metrics.inc("gen.tokens", 320)
    metrics.inc("serving.requests_ok")
    metrics.inc("serving.requests_ok", 4)
    metrics.bucket("serving.batch_occupancy", 3)
    metrics.bucket("serving.batch_occupancy", 1)
    metrics.bucket("serving.batch_occupancy", 3)
    metrics.bucket("gen.slot_occupancy", 10)
    metrics.set_gauge("gen.slots_active", 2)
    metrics.set_gauge("slo.breaching", 0)


def _metrics_pair():
    pair = (jax_profiler.RuntimeMetrics(), torch_profiler.RuntimeMetrics())
    for m in pair:
        _fill(m)
    return pair


def test_runtime_metrics_snapshot_and_percentiles_match():
    jm, tm = _metrics_pair()
    assert tm.snapshot() == jm.snapshot()
    for name in ("gen.ttft_seconds", "serving.request_seconds", "none"):
        qs = (1, 50, 90, 95, 99, 100)
        assert tm.percentiles(name, qs) == jm.percentiles(name, qs)
    assert tm.counter("gen.tokens") == jm.counter("gen.tokens") == 320
    assert tm.gauge("gen.slots_active") == jm.gauge("gen.slots_active")
    for q in (0, 1, 33, 50, 99, 100):
        xs = sorted(range(17))
        assert torch_profiler._nearest_rank(xs, q) == \
            jax_profiler._nearest_rank(xs, q)


def test_record_latency_errors_match():
    jm, tm = jax_profiler.RuntimeMetrics(), torch_profiler.RuntimeMetrics()
    for prof, m in ((jax_profiler, jm), (torch_profiler, tm)):
        with prof.record_latency("executor.warmup_seconds", metrics=m):
            pass
        with pytest.raises(KeyError):
            with prof.record_latency("executor.warmup_seconds", metrics=m):
                raise KeyError("x")
    assert tm.counter("executor.warmup_seconds.errors") == \
        jm.counter("executor.warmup_seconds.errors") == 1
    assert tm.snapshot()["series"]["executor.warmup_seconds"]["count"] == \
        jm.snapshot()["series"]["executor.warmup_seconds"]["count"] == 2


@pytest.mark.parametrize("labels,meta", [(None, True),
                                         ({"replica": "h:1"}, False)])
def test_prometheus_text_matches(labels, meta):
    jm, tm = _metrics_pair()
    want = jax_prom.render_prometheus(jm.snapshot(), labels=labels,
                                      emit_meta=meta)
    got = torch_prom.render_prometheus(tm.snapshot(), labels=labels,
                                       emit_meta=meta)
    assert got == want
    assert "paddle_tpu_gen_tokens_total" in got


# ---------------------------------------------------------------------------
# SLO watchdog
# ---------------------------------------------------------------------------

SLO_SPEC = {
    "version": 1, "interval_seconds": 0.5, "sustained_breaches": 2,
    "objectives": [
        {"name": "ttft", "kind": "quantile", "series": "gen.ttft_seconds",
         "quantile": "p99", "max": 0.3},
        {"name": "errors", "kind": "error_rate",
         "ok": ["serving.requests_ok"], "errors": ["serving.shed"],
         "max_ratio": 0.1},
        {"name": "tokens-floor", "kind": "rate_floor",
         "counter": "gen.tokens", "min_rate": 1e12},
    ]}


def _verdicts(watchdog):
    return [{k: v for k, v in b.items() if k not in ("t", "time_unix")}
            for b in watchdog.evaluate()]


def test_slo_verdicts_match():
    jm, tm = jax_profiler.RuntimeMetrics(), torch_profiler.RuntimeMetrics()
    jw = jax_slo.SLOWatchdog(SLO_SPEC, metrics=jm)
    tw = torch_slo.SLOWatchdog(SLO_SPEC, metrics=tm)
    rounds = []
    for step in range(3):
        for m in (jm, tm):
            _fill(m)
            m.inc("serving.shed", step * 3)
        rounds.append((_verdicts(jw), _verdicts(tw)))
    for want, got in rounds:
        assert [(b["objective"], b["kind"]) for b in got] == \
            [(b["objective"], b["kind"]) for b in want]
        for g, w in zip(got, want):
            for k in ("objective", "kind", "threshold", "consecutive"):
                assert g.get(k) == w.get(k), k
    assert rounds[-1][1], "the spec must breach"
    assert tm.counter("slo.breach") == jm.counter("slo.breach")
    assert tm.gauge("slo.breaching") == jm.gauge("slo.breaching")
    assert [(v["objective"], v["breached"]) for v in tw.last_values()] == \
        [(v["objective"], v["breached"]) for v in jw.last_values()]


@pytest.mark.parametrize("spec", [
    SLO_SPEC,
    {"version": 1, "objectives": []},
    {"version": 2, "objectives": [{"name": "x", "kind": "quantile"}]},
    {"objectives": [{"name": "x", "kind": "nope"}]},
])
def test_slo_spec_validation_matches(spec):
    assert torch_slo.validate_spec(spec) == jax_slo.validate_spec(spec)


# ---------------------------------------------------------------------------
# chaos and retry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "train.step=kill@4;master.rpc=error*2;reader.pump=delay:0.5",
    "gen.decode.stall=delay:0.05, serving.batch=error*2@3",
    "serving.run",
    "serving.load=explode",
])
def test_chaos_spec_parsing_matches(spec):
    got = []
    for chaos in (jax_chaos, torch_chaos):
        chaos.clear()
        try:
            names = chaos.arm_from_env(spec)
            armed = {n: (fp.error, fp.kill, fp.delay, fp.times, fp.after)
                     for n, fp in chaos._registry.items()}
            got.append((names, armed))
        except ValueError as e:
            got.append(("ValueError", str(e)))
        finally:
            chaos.clear()
    assert got[0] == got[1]


def test_chaos_firing_sequence_matches():
    seqs = []
    for chaos in (jax_chaos, torch_chaos):
        chaos.clear()
        chaos.arm_from_env("serving.batch=error*2@3")
        seq = []
        try:
            for _ in range(8):
                try:
                    chaos.fire("serving.batch", size=1)
                    seq.append("ok")
                except chaos.FaultInjected as e:
                    seq.append(str(e))
        finally:
            chaos.clear()
        seqs.append(seq)
    assert seqs[0] == seqs[1]
    assert seqs[1].count("ok") == 6
    assert all("fault injected at 'serving.batch'" in s
               for s in seqs[1] if s != "ok")


@pytest.mark.parametrize("jitter", [0.5, "full", None])
def test_seeded_retry_backoff_matches(jitter):
    seqs = []
    for retry in (jax_retry, torch_retry):
        policy = retry.RetryPolicy(max_attempts=8, base_delay=0.1,
                                   max_delay=2.0, jitter=jitter)
        random.seed(1234)
        seqs.append([policy.backoff(a) for a in range(1, 9)] +
                    [policy.hinted_delay(h) for h in (0.5, 9.0)])
    assert seqs[0] == seqs[1]


def test_retry_call_and_parsers_match():
    for value in (None, "", "250", "0", "-5", "abc"):
        got = []
        for retry in (jax_retry, torch_retry):
            try:
                got.append(retry.parse_deadline_ms(value))
            except ValueError:
                got.append("ValueError")
        assert got[0] == got[1], value
    for value in (None, "3", "1.5", "soon", "-1"):
        assert torch_retry.parse_retry_after(value) == \
            jax_retry.parse_retry_after(value)
    for addr in ("h:1", ("h", 2), "127.0.0.1:8866"):
        assert torch_retry.parse_hostport(addr) == \
            jax_retry.parse_hostport(addr)
    msgs = []
    for retry in (jax_retry, torch_retry):
        calls = []

        def flaky():
            calls.append(1)
            raise ConnectionError("down")

        with pytest.raises(retry.RetryError) as ei:
            retry.RetryPolicy(max_attempts=3, base_delay=0.0,
                              jitter=None).call(flaky)
        msgs.append((len(calls), str(ei.value)))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# check_gen_bundle
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gen_bundles(tmp_path_factory):
    out = {}
    for paged in (True, False):
        d = str(tmp_path_factory.mktemp("gen_check") /
                ("paged" if paged else "dense"))
        jax_gen_lm.export_gen_model(d, jax_gen_lm.GenConfig(),
                                    num_slots=4, paged=paged)
        out[paged] = d
    return out


def _broken(meta, paged):
    """Hand-broken metas: each key a PTA018/PTA019 case."""
    cases = {"good": dict(meta),
             "no_prompt_buckets": dict(meta, prompt_buckets=[]),
             "unsorted_buckets": dict(meta, prompt_buckets=[16, 8, 32]),
             "bucket_past_max_len": dict(
                 meta, prompt_buckets=list(meta["prompt_buckets"]) +
                 [int(meta["max_len"]) * 2]),
             "short_cache_vars": dict(meta, cache_vars=meta["cache_vars"]
                                      [:-1]),
             "unknown_cache_var": dict(meta, cache_vars=["nope"] +
                                       meta["cache_vars"][1:])}
    if paged:
        cases.update({
            "no_page_buckets": dict(meta, page_buckets=[]),
            "short_page_ladder": dict(meta, page_buckets=[1]),
            "page_ladder_past_slot": dict(
                meta, page_buckets=list(meta["page_buckets"]) + [999]),
            "small_pool": dict(meta, num_pages=1),
            "wrong_page_len": dict(meta, page_len=int(meta["page_len"]) * 2),
            "wrong_table_feed": dict(meta, page_table_feed="gen_lens2")})
    else:
        cases.update({"wrong_slots": dict(meta, num_slots=7),
                      "wrong_max_len": dict(meta, max_len=17)})
    return cases


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_check_gen_bundle_codes_match(gen_bundles, paged):
    import os
    d = gen_bundles[paged]
    with open(os.path.join(d, "gen_meta.json")) as f:
        meta = json.load(f)
    jpre = jax_load_saved_program(os.path.join(d, "prefill"))
    jdec = jax_load_saved_program(os.path.join(d, "decode"))
    tpre = torch_load_saved_program(os.path.join(d, "prefill"))
    tdec = torch_load_saved_program(os.path.join(d, "decode"))
    seen = set()
    for name, m in _broken(meta, paged).items():
        want = [(x.code, x.severity, x.var, x.program, x.message)
                for x in jax_check_gen_bundle(jpre, jdec, m)]
        got = [(x.code, x.severity, x.var, x.program, x.message)
               for x in torch_check_gen_bundle(tpre, tdec, m)]
        assert got == want, name
        if name == "good":
            assert got == []
        else:
            assert got, f"{name}: no finding"
        seen.update(c for c, *_ in got)
    assert seen == {"PTA018", "PTA019"}
