"""Fleet-wide observability aggregation: metrics federation and
cross-process trace assembly.

The spans, flight recorder, and Prometheus exposition are strictly
per-process; the serving fleet (router + master + N replicas) needs the
two multi-process shapes of the related work:

- **Metrics federation** (Monarch/Prometheus-federation shape):
  :class:`FleetScraper` pulls every replica's ``/stats`` snapshot and
  renders ONE fleet-level exposition — each replica's full registry
  under a ``replica="host:port"`` label, per-replica
  ``fleet_replica_up`` liveness, and computed rollups (aggregate RPS
  and tokens/s from counter deltas between scrapes, fleet-level
  latency/TTFT percentiles merged from the per-replica summaries).  A
  dead replica marks its sample block STALE (``up 0``, ``stale="1"``)
  instead of failing the scrape: the fleet view stays servable through
  churn.

- **Cross-process trace assembly** (Dapper stitching shape): trace ids
  already flow through ``X-Request-Id`` headers and master RPC frames;
  :func:`assemble_fleet_trace` fetches each process's span ring
  (``/spans``), normalizes clock skew NTP-style against the scraper's
  send/receive envelope (offset = remote ``now_unix`` minus the
  envelope midpoint), and merges everything into one Chrome-trace
  timeline with a distinct ``pid`` row group per process — a
  failed-over request's router -> dead-replica -> surviving-replica
  story becomes one artifact.

Merged-percentile caveat: ``/stats`` summaries carry window
percentiles, not raw samples, so the fleet p99 is the COUNT-WEIGHTED
mean of per-replica p99s — an approximation (exact only when replicas
see identical distributions), clearly better than "one process's p99"
and cheap enough to compute on every scrape.  The per-replica labelled
series remain in the exposition for exact per-process values.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

from paddle_tpu_torch.obs import trace as _trace
from paddle_tpu_torch.obs.prom import _fmt, _labelset, render_prometheus, \
    sanitize_name

__all__ = ["FleetScraper", "fetch_stats", "fetch_spans",
           "fetch_spans_many", "merged_quantile", "render_federated",
           "replica_perf", "assemble_fleet_trace", "CONTENT_TYPE",
           "PERF_GAUGES"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# counter families summed into the fleet rollup rates
_REQUEST_COUNTERS = ("serving.requests_ok", "gen.requests_ok")
_TOKEN_COUNTERS = ("gen.tokens",)
# series whose per-replica summaries merge into fleet percentiles
_MERGED_SERIES = ("serving.request_seconds", "gen.ttft_seconds",
                  "gen.intertoken_seconds", "gen.decode_step_seconds")
# device-performance gauges federated per replica (obs.perf): each
# replica's value rides its labelled registry block; these also feed
# the fleet_mfu_mean / fleet_hbm_headroom_min rollups and the router's
# /stats `fleet_perf` summary
PERF_GAUGES = ("train.mfu", "gen.decode_mfu", "hbm.headroom_bytes",
               "hbm.total_bytes", "hbm.high_watermark_bytes",
               # training-health gauges (obs.numerics fused norms):
               # federated per replica and rolled up as
               # fleet_grad_norm_max — the exploding replica pages you
               "train.grad_norm", "train.param_norm",
               "train.update_ratio")


def replica_perf(scrapes):
    """Per-replica device-performance summary of a federation pass:
    ``{addr: {"id": ..., <gauge>: value}}`` over the :data:`PERF_GAUGES`
    a replica reports (replicas running no perf-instrumented work are
    omitted; stale replicas never appear)."""
    out = {}
    for s in scrapes:
        if not s.get("ok"):
            continue
        gauges = (s["stats"].get("gauges") or {})
        vals = {g: gauges[g] for g in PERF_GAUGES if g in gauges}
        if vals:
            out[s["addr"]] = dict(vals, id=s.get("id") or s["addr"])
    return out


def _get_json(addr, path, timeout):
    with urllib.request.urlopen(f"http://{addr}{path}",
                                timeout=timeout) as r:
        return json.loads(r.read())


def fetch_stats(addr, timeout=5.0):
    """One replica's ``/stats`` snapshot (raises on unreachable)."""
    return _get_json(addr, "/stats", timeout)


def fetch_spans(addr, timeout=5.0):
    """One process's ``/spans`` payload plus the scraper-side send/recv
    envelope ``(t_send_unix, t_recv_unix)`` used for clock-skew
    normalization."""
    t_send = time.time()
    payload = _get_json(addr, "/spans", timeout)
    t_recv = time.time()
    return payload, (t_send, t_recv)


def fetch_spans_many(addrs, timeout=5.0, max_concurrency=8):
    """Concurrent ``/spans`` scrape of many processes: a list of
    :func:`assemble_fleet_trace` source dicts, one per address —
    unreachable processes come back as ``{"source", "error"}`` entries
    (reported in the assembly sidecar, never fatal), and N hung
    replicas cost one timeout per pass, not N."""
    from concurrent.futures import ThreadPoolExecutor

    def one(addr):
        try:
            payload, envelope = fetch_spans(addr, timeout=timeout)
        except Exception as e:
            return {"source": addr, "error": f"{type(e).__name__}: {e}"}
        return {"source": addr, "payload": payload,
                "envelope": envelope}

    addrs = list(addrs)
    if not addrs:
        return []
    with ThreadPoolExecutor(
            max_workers=min(max(1, int(max_concurrency)),
                            len(addrs))) as pool:
        return list(pool.map(one, addrs))


def merged_quantile(scrapes, series, q="p99"):
    """Count-weighted merge of one series' per-replica window
    percentile across live scrapes; None when no replica has samples."""
    weighted = 0.0
    total = 0
    for s in scrapes:
        if not s.get("ok"):
            continue
        entry = ((s["stats"].get("series") or {}).get(series)) or {}
        count, value = entry.get("count") or 0, entry.get(q)
        if count and value is not None:
            weighted += value * count
            total += count
    return (weighted / total) if total else None


class FleetScraper:
    """Pull-based federation over a replica table.

    ``targets_fn`` returns the current scrape targets as ``[(addr,
    replica_id)]`` (the router passes a closure over its routing table
    — including cooling-down replicas: the scrape itself decides
    staleness by failing).  Rollup RATES come from counter deltas
    between consecutive scrapes, so the first federation pass renders
    totals but no rates."""

    def __init__(self, targets_fn, timeout=2.0, metrics=None,
                 max_concurrency=8):
        self._targets_fn = targets_fn
        self._timeout = float(timeout)
        self._max_concurrency = max(1, int(max_concurrency))
        if metrics is None:
            from paddle_tpu_torch.profiler import runtime_metrics
            metrics = runtime_metrics
        self._metrics = metrics
        self._lock = threading.Lock()
        self._prev = None  # (monotonic, {addr: (requests, tokens)})
        self._last_perf = {}  # replica_perf() of the latest pass
        self._last_ok = set()  # addrs that answered the latest pass

    def _scrape_one(self, target):
        addr, replica_id = target
        one = {"addr": addr, "id": replica_id, "ok": False,
               "stats": None, "error": None, "rtt_s": None}
        t_req = time.perf_counter()
        try:
            one["stats"] = fetch_stats(addr, timeout=self._timeout)
            one["ok"] = True
            self._metrics.inc("fleet.scrape.ok")
        except Exception as e:
            one["error"] = f"{type(e).__name__}: {e}"
            self._metrics.inc("fleet.scrape.errors")
        one["rtt_s"] = time.perf_counter() - t_req
        return one

    def scrape(self):
        """One federation pass: ``[{addr, id, ok, stats|error,
        rtt_s}]`` — unreachable replicas come back ``ok=False`` (stale)
        instead of raising.  Targets are scraped CONCURRENTLY, so N
        partitioned replicas (connect hangs, not refuses) cost one
        scrape timeout per pass, not N — a Prometheus pull of the
        router must not go dark because a replica did."""
        from concurrent.futures import ThreadPoolExecutor
        t0 = time.perf_counter()
        targets = list(self._targets_fn())
        if not targets:
            scrapes = []
        else:
            with ThreadPoolExecutor(
                    max_workers=min(self._max_concurrency,
                                    len(targets))) as pool:
                scrapes = list(pool.map(self._scrape_one, targets))
        self._metrics.observe("fleet.scrape_seconds",
                              time.perf_counter() - t0)
        self._metrics.set_gauge("fleet.replicas_stale",
                                sum(1 for s in scrapes if not s["ok"]))
        with self._lock:
            self._last_perf = replica_perf(scrapes)
            self._last_ok = {s["addr"] for s in scrapes if s["ok"]}
        return scrapes

    def last_perf(self):
        """Per-replica MFU / HBM summary of the most recent federation
        pass (the router's ``/stats`` ``fleet_perf`` body; empty before
        the first scrape — ``/stats`` must never block on a fleet
        pull)."""
        with self._lock:
            return {addr: dict(vals)
                    for addr, vals in self._last_perf.items()}

    def last_ok(self):
        """Addresses that answered the most recent federation pass —
        the router's *scrape evidence* when deciding whether a sibling
        replica plausibly has headroom (empty before the first scrape:
        no evidence, make no headroom claims)."""
        with self._lock:
            return set(self._last_ok)

    def rates(self, scrapes):
        """Public face of the rollup rates: ``(rps, tokens_per_sec)``
        vs the previous pass — the controller's demand signal."""
        return self._rates(scrapes)

    def _rates(self, scrapes):
        """(rps, tokens_per_sec) vs the previous scrape; None on the
        first pass or when time stood still.  Deltas are PER REPLICA —
        summed only over replicas present in both passes, each clamped
        at 0 — so a replica dying (its counters leaving the sum) or
        restarting (its counters resetting) between scrapes does not
        zero the survivors' reported rate."""
        now = time.monotonic()
        per = {}
        for s in scrapes:
            if not s["ok"]:
                continue
            counters = s["stats"].get("counters") or {}
            per[s["addr"]] = (
                sum(counters.get(c, 0) for c in _REQUEST_COUNTERS),
                sum(counters.get(c, 0) for c in _TOKEN_COUNTERS))
        with self._lock:
            prev, self._prev = self._prev, (now, per)
        if prev is None or now <= prev[0]:
            return None, None
        dt = now - prev[0]
        requests = tokens = 0
        for addr, (r, t) in per.items():
            if addr not in prev[1]:
                continue  # newly seen: contributes from the next pass
            pr, pt = prev[1][addr]
            requests += max(0, r - pr)
            tokens += max(0, t - pt)
        return requests / dt, tokens / dt

    def federate(self):
        """Scrape + render: the fleet ``/metrics`` body.  Returns
        ``(text, scrapes)``."""
        scrapes = self.scrape()
        rps, tps = self._rates(scrapes)
        return render_federated(scrapes, rps=rps, tokens_per_sec=tps), \
            scrapes


def render_federated(scrapes, rps=None, tokens_per_sec=None):
    """Render a federation pass as one Prometheus exposition: fleet
    rollups first, per-replica liveness, then every replica's registry
    under its ``replica=`` label (one TYPE declaration per family)."""
    live = [s for s in scrapes if s["ok"]]
    lines = []
    declared = set()

    def rollup(metric, value, help_text):
        if value is None:
            return
        lines.append(f"# HELP {metric} {help_text}")
        lines.append(f"# TYPE {metric} gauge")
        declared.add(metric)
        lines.append(f"{metric} {_fmt(value)}")

    rollup("paddle_tpu_fleet_replicas_scraped", len(scrapes),
           "replicas in the federation scrape set")
    rollup("paddle_tpu_fleet_replicas_stale",
           len(scrapes) - len(live),
           "replicas unreachable in this pass (marked stale)")
    rollup("paddle_tpu_fleet_rps", rps,
           "aggregate completed requests/sec across live replicas "
           "(counter delta between scrapes)")
    rollup("paddle_tpu_fleet_tokens_per_sec", tokens_per_sec,
           "aggregate generated tokens/sec across live replicas "
           "(counter delta between scrapes)")
    for series in _MERGED_SERIES:
        for q in ("p50", "p99"):
            rollup(f"{sanitize_name(series)}_fleet_{q}",
                   merged_quantile(scrapes, series, q),
                   f"{series} {q} merged across replicas "
                   f"(count-weighted)")
    # device-performance rollups: fleet-mean MFU (a replica compiling
    # or idling drags it visibly) and the TIGHTEST HBM headroom — the
    # replica closest to OOM is the one that pages you, so min, not
    # mean.  Per-replica exact values ride the labelled registries.
    perf = replica_perf(scrapes)
    mfus = [v for p in perf.values()
            for v in [p.get("train.mfu", p.get("gen.decode_mfu"))]
            if v is not None]
    rollup("paddle_tpu_fleet_mfu_mean",
           (sum(mfus) / len(mfus)) if mfus else None,
           "mean live MFU across replicas reporting one "
           "(train.mfu, else gen.decode_mfu)")
    heads = [p["hbm.headroom_bytes"] for p in perf.values()
             if p.get("hbm.headroom_bytes") is not None]
    rollup("paddle_tpu_fleet_hbm_headroom_min_bytes",
           min(heads) if heads else None,
           "tightest device-memory headroom across replicas")
    grads = [p["train.grad_norm"] for p in perf.values()
             if p.get("train.grad_norm") is not None]
    rollup("paddle_tpu_fleet_grad_norm_max",
           max(grads) if grads else None,
           "largest per-step update norm across training replicas "
           "(the diverging replica surfaces here first)")

    lines.append("# HELP paddle_tpu_fleet_replica_up replica scrape "
                 "health (0 = unreachable/stale)")
    lines.append("# TYPE paddle_tpu_fleet_replica_up gauge")
    declared.add("paddle_tpu_fleet_replica_up")
    for s in scrapes:
        labels = {"replica": s["addr"], "id": s["id"] or s["addr"],
                  "stale": "0" if s["ok"] else "1"}
        lines.append(f"paddle_tpu_fleet_replica_up{_labelset(labels)} "
                     f"{1 if s['ok'] else 0}")

    # per-replica registries: declare each family once, then append
    # every live replica's labelled samples for it
    kinds = (("counters", "counter", "_total"),
             ("gauges", "gauge", ""),
             ("series", "summary", ""),
             ("histograms", "histogram", ""))
    for key, kind, suffix in kinds:
        names = sorted({name for s in live
                        for name in (s["stats"].get(key) or {})})
        for name in names:
            metric = sanitize_name(name) + suffix
            if metric not in declared:
                # a fleet rollup may share a family name with a
                # replica-registry gauge (an in-process fleet scrapes
                # its own fleet.* gauges back): one TYPE per family,
                # labelled samples join it
                lines.append(f"# HELP {metric} {name} "
                             f"(per-replica {kind})")
                lines.append(f"# TYPE {metric} {kind}")
                declared.add(metric)
            for s in live:
                value = (s["stats"].get(key) or {}).get(name)
                if value is None:
                    continue
                block = render_prometheus(
                    {key: {name: value}},
                    labels={"replica": s["addr"]}, emit_meta=False)
                lines.extend(block.splitlines())
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# cross-process trace assembly
# ---------------------------------------------------------------------------

def _normalize(payload, envelope, zero_unix):
    """One process's spans shifted onto the assembler's clock: span
    ``ts`` becomes seconds since ``zero_unix`` IN THE ASSEMBLER'S
    wall clock, using offset = remote now_unix - envelope midpoint."""
    offset = 0.0
    if envelope is not None:
        offset = payload["now_unix"] - (envelope[0] + envelope[1]) / 2.0
    base = payload["epoch_unix"] - offset - zero_unix
    out = []
    for sp in payload["spans"]:
        d = dict(sp)
        d["ts"] = base + sp["ts"]
        d.setdefault("pid", payload.get("pid"))
        if not d.get("proc"):
            d["proc"] = payload.get("process_name")
        out.append(d)
    return out, offset


def assemble_fleet_trace(sources, zero_unix=None):
    """Merge span payloads from several processes into one Chrome-trace
    timeline.

    ``sources`` is a list of ``{"source": label, "payload": <the
    /spans body>, "envelope": (t_send, t_recv) | None}`` dicts — the
    assembler's own ring goes in with ``envelope=None`` (no skew by
    definition); unreachable processes go in as ``{"source": label,
    "error": str}`` and are reported, not fatal.

    Process identity is ``(pid, process_name)``, NOT the raw OS pid:
    span ids are per-process counters, and containerized replicas
    routinely all run as pid 1, so keying on pid alone would silently
    drop every process after the first AND fold them onto one timeline
    row.  Spans dedupe by ``(identity, span_id)`` — so an in-process
    fleet (every replica serving the same ring under the same
    identity) assembles without duplicate events — and identities
    whose raw pids collide get a remapped DISPLAY pid so each process
    keeps its own labelled row.  The result is a Perfetto-loadable
    trace object with a ``fleetAssembly`` sidecar describing
    per-process display pids, clock offsets, and failures."""
    if zero_unix is None:
        zero_unix = _trace.epoch_unix()
    merged = []
    seen = set()
    processes = []
    failures = []
    display = {}       # identity -> display pid
    used_pids = set()
    for src in sources:
        if src.get("error") is not None or src.get("payload") is None:
            failures.append({"source": src.get("source"),
                             "error": src.get("error") or "no payload"})
            continue
        payload = src["payload"]
        identity = (payload.get("pid"), payload.get("process_name"))
        if identity not in display:
            pid = payload.get("pid") or 1
            while pid in used_pids:   # another process owns this pid
                pid += 1
            used_pids.add(pid)
            display[identity] = pid
        disp_pid = display[identity]
        spans, offset = _normalize(payload, src.get("envelope"),
                                   zero_unix)
        fresh = []
        for sp in spans:
            key = (identity, sp.get("span_id"))
            if key in seen:
                continue
            seen.add(key)
            sp["pid"] = disp_pid
            fresh.append(sp)
        merged.extend(fresh)
        processes.append({"source": src.get("source"),
                          "pid": disp_pid,
                          "os_pid": payload.get("pid"),
                          "process_name": payload.get("process_name"),
                          "clock_offset_s": offset,
                          "spans": len(fresh)})
    merged.sort(key=lambda sp: sp["ts"])
    obj = _trace.chrome_trace(merged)
    obj["fleetAssembly"] = {"zero_unix": zero_unix,
                            "processes": processes,
                            "failures": failures}
    return obj
