"""Health-aware HTTP router over a fleet of serving replicas.

A thin front-end: discovers live replicas from the master's lease table
(or a static list), spreads `/predict` traffic by least-outstanding
requests, and on connection failure / retryable 503 / lease expiry
retries the request on a *different* replica under a
:class:`~paddle_tpu_torch.fault.RetryPolicy` with full jitter — bounded end
to end by the caller's deadline, which rides the ``X-Deadline-Ms``
header into the replica's own :class:`MicroBatcher` timeout so a
failover chain can never spend more than the original budget.  The
caller's ``X-Request-Id`` (minted here when absent) is forwarded on
every attempt, making one request traceable across replicas in their
``/trace`` rings.

The router holds no model state and does no JSON re-encoding of predict
bodies — request and reply bytes pass through verbatim — so it stays
cheap enough to front many replicas from one process.

It is also the fleet's observability vantage point
(``docs/observability.md`` § Fleet observability):
``/metrics?fleet=1`` federates every replica's registry into one
exposition (``obs.aggregate.FleetScraper``; dead replicas marked stale,
never fatal), ``/trace?fleet=1`` assembles every process's span ring
into one clock-normalized Chrome timeline, ``/spans`` serves the
router's own ring in the same scrape shape, and an optional SLO
watchdog (``slo_spec=`` / ``PADDLE_TPU_SLO``) evaluates declarative
objectives over the runtime metrics in a background thread, surfacing
its breach log under ``/stats``.

Streamed ``/generate`` traffic is *session-aware*: each request mints
(or carries) a session id tracked in a bounded
:class:`~paddle_tpu_torch.fleet.sessions.SessionTable` — owning replica,
prompt hash, tokens delivered — so follow-ups and resumes route back
to the owner (affine routing), and when the owner dies mid-stream the
router re-prefills ``prompt + tokens_so_far`` on a survivor with a
``resume_from`` index and splices the continuation into the SAME
client response, deduplicating on the monotone ``token_index`` every
event carries (greedy decode is deterministic, so the splice is
token-identical and exactly-once).

Failpoints: ``fleet.route.blackhole`` fires per forward attempt (armed
``error`` turns the attempt into a connection failure — the drill for a
partitioned replica the lease hasn't expired yet);
``gen.session.kill_owner`` fires per relayed token (armed ``error``
simulates the owning replica dying after producing that token — the
mid-stream failover drill); ``gen.stream.truncate`` fires per upstream
stream read (armed ``error`` tears the stream mid-chunk — the torn
transport drill).
"""

from __future__ import annotations

import collections
import json
import threading
import time
from urllib.parse import parse_qs, urlsplit

from paddle_tpu_torch.obs import aggregate as _aggregate
from paddle_tpu_torch.obs import slo as _slo
from paddle_tpu_torch.obs import trace as _trace
from paddle_tpu_torch.obs.trace import span as _span

__all__ = ["FleetRouter"]


class _NoReplicas(ConnectionError):
    """No live replica to route to (retryable: one may re-register)."""


class _Transient(ConnectionError):
    """Upstream replied retryable (503/504-class): fail over."""


class _DeadlineExhausted(RuntimeError):
    """The caller's end-to-end budget ran out (non-retryable)."""


class _StreamAborted(RuntimeError):
    """The DOWNSTREAM client vanished mid-relay (non-retryable: there is
    nobody left to fail over for)."""


class FleetRouter:
    """Route `/predict` across replicas with health-aware failover.

    ``master_addr`` enables discovery from
    :meth:`MasterService.list_replicas` (polled every
    ``poll_interval``); ``replicas`` is the static-list alternative.
    ``retry`` defaults to full-jitter exponential backoff; the
    effective deadline per request is the caller's ``X-Deadline-Ms``
    when present, else ``default_deadline`` seconds.
    """

    def __init__(self, master_addr=None, replicas=None, host="127.0.0.1",
                 port=0, retry=None, poll_interval=0.25,
                 default_deadline=30.0, attempt_timeout=30.0,
                 down_cooldown=1.0, slo_spec=None, scrape_timeout=2.0,
                 session_capacity=1024):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        from paddle_tpu_torch.fault.retry import RetryPolicy, parse_hostport
        from paddle_tpu_torch.fleet.sessions import SessionTable
        if master_addr is None and not replicas:
            raise ValueError("FleetRouter needs master_addr or replicas")
        self._master_addr = master_addr
        self._master = None
        self._retry = retry or RetryPolicy(
            max_attempts=6, base_delay=0.05, max_delay=0.5, jitter="full")
        self._default_deadline = float(default_deadline)
        self._attempt_timeout = float(attempt_timeout)
        self._down_cooldown = float(down_cooldown)
        self._poll_interval = float(poll_interval)
        self._lock = threading.Lock()
        # addr ("host:port") -> per-replica health/load book-keeping
        self._table = {}
        for a in replicas or []:
            h, p = parse_hostport(a)
            self._table[f"{h}:{p}"] = self._fresh_entry(f"{h}:{p}")
        self._static = master_addr is None
        self._stop = threading.Event()
        # per-handler-thread keep-alive connections to replicas (the
        # replica side speaks HTTP/1.1 exactly so the router does not
        # pay a TCP handshake + server thread spawn per forwarded
        # request); entries die with their handler thread
        self._tl = threading.local()
        # last N failovers: (request_id, failed addrs..., served-by) —
        # the drill's evidence that a specific request changed replicas
        self.failover_log = collections.deque(maxlen=256)
        # live generative sessions: affine routing + mid-stream resume
        # state (evicted on terminal delivery; bounded, orphan-counting)
        self.sessions = SessionTable(capacity=session_capacity)
        # fleet observability plane: federation scraper over the
        # routing table (obs.aggregate) + optional SLO watchdog
        # (obs.slo; explicit spec wins over PADDLE_TPU_SLO)
        self._scrape_timeout = float(scrape_timeout)
        self._scraper = _aggregate.FleetScraper(
            self.scrape_targets, timeout=self._scrape_timeout)
        self._slo = (_slo.SLOWatchdog(slo_spec) if slo_spec is not None
                     else _slo.watchdog_from_env())
        if self._slo is not None:
            self._slo.start()
        # graceful-degradation ladder (admission control): level 0
        # admits everything; a controller raises the level to shed a
        # growing fraction of arrivals at the door with 429 +
        # Retry-After INSTEAD of queueing them into a deadline timeout
        self._admission_lock = threading.Lock()
        self._admission = {"level": 0, "shed_fraction": 0.0,
                           "retry_after_s": 1.0, "reason": "",
                           "since_unix": time.time()}
        self._admission_acc = 0.0  # Bresenham-style shed accumulator
        _trace.set_process_name("router")
        router = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _reply_raw(self, code, body, content_type,
                           extra_headers=None):
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (extra_headers or {}).items():
                    self.send_header(k, v)
                rid = getattr(self, "_request_id", None)
                if rid:
                    self.send_header("X-Request-Id", rid)
                self.end_headers()
                self.wfile.write(body)

            def _reply(self, code, obj):
                self._reply_raw(code, json.dumps(obj).encode(),
                                "application/json")

            def _error(self, code, etype, message, retryable,
                       **extra):
                body = {"error": {"type": etype, "message": message},
                        "retryable": retryable}
                body.update(extra)
                self._reply(code, body)

            def do_GET(self):
                self._request_id = (self.headers.get("X-Request-Id")
                                    or "").strip() or None
                parts = urlsplit(self.path)
                path = parts.path
                query = parse_qs(parts.query)
                # ?fleet=1 flips /metrics and /trace from this
                # process's view to the FEDERATED one (every replica
                # scraped, merged, labelled)
                fleet = (query.get("fleet", ["0"])[0].lower()
                         not in ("", "0", "false", "no"))
                if path in ("/health", "/healthz"):
                    self._reply(200, {"status": "ok"})
                elif path == "/readyz":
                    n = len(router.live_replicas())
                    if n > 0:
                        self._reply(200, {"status": "ready",
                                          "replicas": n})
                    else:
                        self._error(503, "no_replicas",
                                    "no live replicas in the routing "
                                    "table", retryable=True)
                elif path == "/replicas":
                    self._reply(200, {"replicas": router.table()})
                elif path == "/stats":
                    from paddle_tpu_torch import profiler as _profiler
                    snap = _profiler.runtime_metrics.snapshot()
                    snap["router"] = {
                        "replicas": router.table(),
                        "failovers": [list(f) for f in
                                      router.failover_log],
                        "admission": router.admission_state(),
                        "sessions": router.sessions.snapshot(),
                    }
                    # per-replica MFU / HBM headroom from the latest
                    # federation pass (empty before the first
                    # /metrics?fleet=1 scrape — never blocks on one)
                    snap["fleet_perf"] = router._scraper.last_perf()
                    if router._slo is not None:
                        snap["slo"] = router._slo.state()
                    self._reply(200, snap)
                elif path == "/metrics":
                    if fleet:
                        self._reply_raw(
                            200, router.fleet_metrics().encode(),
                            _aggregate.CONTENT_TYPE)
                        return
                    from paddle_tpu_torch.obs import prom as _prom
                    self._reply_raw(
                        200, _prom.render_prometheus().encode(),
                        _prom.CONTENT_TYPE)
                elif path == "/trace":
                    if fleet:
                        self._reply_raw(
                            200,
                            json.dumps(router.fleet_trace()).encode(),
                            "application/json")
                        return
                    self._reply_raw(200,
                                    _trace.dump_chrome_trace().encode(),
                                    "application/json")
                elif path == "/spans":
                    # the router's own ring, in the same scrape shape
                    # replicas serve (so a higher-level aggregator can
                    # treat the router as just another process)
                    self._reply(200, _trace.snapshot_payload())
                else:
                    self._error(404, "not_found", self.path,
                                retryable=False)

            def do_POST(self):
                from paddle_tpu_torch.fault.retry import parse_deadline_ms
                self._request_id = (self.headers.get("X-Request-Id")
                                    or "").strip() or _trace.new_trace_id()
                if "Content-Length" not in self.headers:
                    # no declared length (absent or chunked): the body
                    # can't be read, so don't burn a routed attempt
                    # delivering an empty one — reject here
                    self.close_connection = True
                    self._error(411, "length_required",
                                "POST requires Content-Length",
                                retryable=False)
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    raw = self.rfile.read(n)
                except ValueError:
                    self.close_connection = True
                    self._error(400, "bad_request",
                                "invalid Content-Length header",
                                retryable=False)
                    return
                if self.path not in ("/predict", "/run", "/generate"):
                    self._error(404, "not_found", self.path,
                                retryable=False)
                    return
                try:
                    budget = parse_deadline_ms(
                        self.headers.get("X-Deadline-Ms"))
                except ValueError:
                    self._error(400, "bad_request",
                                f"invalid X-Deadline-Ms header: "
                                f"{self.headers.get('X-Deadline-Ms')!r}",
                                retryable=False)
                    return
                if budget is None:
                    budget = router._default_deadline
                # admission control runs BEFORE any routing work: a
                # shed request costs the fleet one header parse, not a
                # queued attempt that burns its own deadline
                shed = router.admit(budget)
                if shed is not None:
                    self._reply_raw(*shed)
                    return
                if self.path == "/generate":
                    # streamed generation: chunks are forwarded to the
                    # caller AS the replica produces them — time-to-
                    # first-token survives the fleet hop
                    router.route_stream(self, raw, self._request_id,
                                        budget)
                    return
                code, body, ctype, headers = router.route(
                    self.path, raw, self._request_id, budget)
                self._reply_raw(code, body, ctype, headers)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.addr = self._server.server_address
        self._poll_thread = None
        if not self._static:
            self._poll_thread = threading.Thread(
                target=self._poll_loop, daemon=True,
                name="fleet-router-discovery")
            self._poll_thread.start()

    # -- routing table -----------------------------------------------------
    @staticmethod
    def _fresh_entry(addr, replica_id=None):
        return {"id": replica_id or addr, "addr": addr, "outstanding": 0,
                "requests": 0, "failures": 0, "down_until": 0.0}

    def _poll_loop(self):
        while not self._stop.wait(self._poll_interval):
            self.refresh()

    def refresh(self):
        """One discovery pass against the master (no-op in static
        mode): live leases enter the table, expired ones leave it."""
        from paddle_tpu_torch import profiler as _profiler
        if self._static:
            return
        try:
            if self._master is None:
                from paddle_tpu_torch.parallel.master import MasterClient
                self._master = MasterClient(self._master_addr)
            live = self._master.list_replicas()
        except Exception:
            return  # master blip: keep routing on the current table
        with self._lock:
            seen = set()
            for rec in live:
                addr = rec["addr"]
                seen.add(addr)
                entry = self._table.get(addr)
                if entry is None:
                    self._table[addr] = self._fresh_entry(addr, rec["id"])
                else:
                    entry["id"] = rec["id"]
            for addr in [a for a in self._table if a not in seen]:
                del self._table[addr]
            _profiler.runtime_metrics.set_gauge("fleet.replicas_live",
                                                len(self._table))

    def live_replicas(self):
        """Addresses currently eligible for new traffic."""
        now = time.monotonic()
        with self._lock:
            return [a for a, e in self._table.items()
                    if e["down_until"] <= now]

    def table(self):
        """Per-replica health/load snapshot (the `/replicas` body)."""
        now = time.monotonic()
        with self._lock:
            return {a: {"id": e["id"], "outstanding": e["outstanding"],
                        "requests": e["requests"],
                        "failures": e["failures"],
                        "down": e["down_until"] > now}
                    for a, e in self._table.items()}

    def _pick(self, tried, prefer=None):
        """Least-outstanding live replica, preferring one not yet tried
        by THIS request; falls back to tried replicas only when every
        live one has failed this chain (single-replica fleets still
        retry).  ``prefer`` (a session's owning replica — affine
        routing) wins outright while it is live and not yet tried."""
        now = time.monotonic()
        with self._lock:
            if prefer is not None and prefer not in tried:
                e = self._table.get(prefer)
                if e is not None and e["down_until"] <= now:
                    return prefer
            live = [(e["outstanding"], a) for a, e in self._table.items()
                    if e["down_until"] <= now]
            if not live:
                # every replica is cooling down: routing to a maybe-dead
                # replica beats refusing while the table is non-empty
                live = [(e["outstanding"], a)
                        for a, e in self._table.items()]
        if not live:
            raise _NoReplicas("no live replicas in the routing table")
        untried = [(o, a) for o, a in live if a not in tried]
        pool = untried or live
        # random tie-break: a deterministic (outstanding, addr) sort
        # would pin ALL low-concurrency traffic to the smallest address
        import random
        random.shuffle(pool)
        # equal-outstanding ties break toward the replica with the most
        # HBM headroom in the latest federation pass (cost-model
        # placement: the replica closest to OOM is the worst home for
        # new work); replicas without scrape evidence sort neutral
        perf = self._scraper.last_perf()

        def load_key(e):
            o, a = e
            head = (perf.get(a) or {}).get("hbm.headroom_bytes")
            return (o, 0.0 if head is None else -float(head))

        pool.sort(key=load_key)
        return pool[0][1]

    def _mark_down(self, addr):
        """Short cooldown after a connection-level failure, so the hot
        path stops picking a dead replica before the lease expires."""
        with self._lock:
            e = self._table.get(addr)
            if e is not None:
                e["failures"] += 1
                e["down_until"] = time.monotonic() + self._down_cooldown

    # -- fleet observability plane -----------------------------------------
    def scrape_targets(self):
        """Federation scrape set: EVERY replica in the table, including
        cooling-down ones — the scrape itself decides staleness by
        failing, and a corpse must show up as ``stale=1``, not vanish
        from the fleet view before its lease expires."""
        with self._lock:
            return [(a, e["id"]) for a, e in sorted(self._table.items())]

    def fleet_metrics(self):
        """The federated ``/metrics?fleet=1`` body: every replica's
        registry under ``replica=`` labels plus fleet rollups; dead
        replicas are marked stale, never fatal."""
        text, _scrapes = self._scraper.federate()
        return text

    def fleet_trace(self):
        """The assembled ``/trace?fleet=1`` body: the router's own span
        ring merged with every reachable replica's (clock-skew
        normalized against this process's send/recv envelopes,
        scraped concurrently), one timeline row per process.
        Unreachable replicas are reported in
        ``fleetAssembly.failures`` — a hard-killed replica must not
        take the fleet timeline down with it."""
        sources = [{"source": "router",
                    "payload": _trace.snapshot_payload(),
                    "envelope": None}]
        sources.extend(_aggregate.fetch_spans_many(
            [addr for addr, _rid in self.scrape_targets()],
            timeout=self._scrape_timeout))
        return _aggregate.assemble_fleet_trace(sources)

    # -- admission control (graceful-degradation ladder) -------------------
    def set_admission(self, level, shed_fraction, retry_after_s=1.0,
                      reason=""):
        """Set the degradation rung: shed ``shed_fraction`` of incoming
        POSTs at the door with ``429`` + ``Retry-After:
        retry_after_s`` (clamped per request to the caller's own
        ``X-Deadline-Ms`` budget).  Level 0 / fraction 0 admits
        everything.  Called by the fleet controller as SLO pressure
        builds and recedes; ``reason`` lands in ``/stats`` so an
        operator can see WHY the fleet is shedding."""
        from paddle_tpu_torch import profiler as _profiler
        level = max(0, int(level))
        shed_fraction = min(1.0, max(0.0, float(shed_fraction)))
        with self._admission_lock:
            changed = level != self._admission["level"]
            self._admission = {
                "level": level,
                "shed_fraction": shed_fraction,
                "retry_after_s": max(0.0, float(retry_after_s)),
                "reason": str(reason),
                "since_unix": (time.time() if changed
                               else self._admission["since_unix"]),
            }
            if changed:
                self._admission_acc = 0.0
        _profiler.runtime_metrics.set_gauge("fleet.admission_level",
                                            level)

    def admission_state(self):
        """The current rung (the ``/stats`` ``router.admission`` body)."""
        with self._admission_lock:
            return dict(self._admission)

    def admit(self, budget):
        """Admission decision for ONE arriving request: None to admit,
        or a ready-to-send ``(429, body, content_type, headers)`` shed.
        Sheds are spread evenly through the arrival stream (error-
        accumulator, not random draws: a 25% shed rung bounces exactly
        every 4th request, so a short probe burst can never be
        all-unlucky), and the ``Retry-After`` hint is clamped to the
        caller's remaining deadline budget — a hint the caller cannot
        possibly wait out is just a slower timeout."""
        with self._admission_lock:
            frac = self._admission["shed_fraction"]
            if frac <= 0.0:
                return None
            self._admission_acc += frac
            if self._admission_acc < 1.0:
                return None
            self._admission_acc -= 1.0
            level = self._admission["level"]
            reason = self._admission["reason"]
            hint = self._admission["retry_after_s"]
        from paddle_tpu_torch import profiler as _profiler
        _profiler.runtime_metrics.inc("fleet.admission_shed")
        retry_after = hint if budget is None \
            else max(0.0, min(hint, float(budget)))
        body = json.dumps({
            "error": {"type": "admission_shed",
                      "message": f"fleet shedding at degradation level "
                                 f"{level}" + (f": {reason}" if reason
                                               else "")},
            "retryable": True,
            "degrade_level": level,
            "retry_after_s": retry_after,
        }).encode()
        return 429, body, "application/json", \
            {"Retry-After": f"{retry_after:.3f}"}

    def _shed_hint(self, deadline_at):
        """Retry-After for a router-GENERATED shed (503/504): the
        admission ladder's current pacing hint, clamped to the caller's
        remaining budget when any is left (a caller whose budget is
        gone gets the unclamped hint for its NEXT request)."""
        with self._admission_lock:
            hint = self._admission["retry_after_s"] or 1.0
        remaining = deadline_at - time.monotonic()
        if remaining > 0:
            hint = min(hint, remaining)
        return max(0.0, hint)

    def _alternative_with_headroom(self, addr):
        """True when the latest federation pass shows a DIFFERENT live
        replica plausibly able to absorb a request the replica at
        ``addr`` just shed with 429 — the gate on treating an upstream
        429 as retryable-elsewhere.  Requires scrape EVIDENCE: before
        the first pass (or when no candidate answered it) the answer is
        False and the 429 passes through verbatim, so clients back off
        instead of the router hammering a uniformly saturated fleet."""
        ok = self._scraper.last_ok()
        if not ok:
            return False
        now = time.monotonic()
        with self._lock:
            me = self._table.get(addr)
            my_out = (me["outstanding"] if me is not None
                      else float("inf"))
            for a, e in self._table.items():
                if a == addr or e["down_until"] > now or a not in ok:
                    continue
                if e["outstanding"] <= my_out:
                    return True
        return False

    # -- request path ------------------------------------------------------
    def route(self, path, raw, request_id, budget):
        """Forward one request; returns ``(status, body, content_type,
        extra_headers)``.  Every terminal failure the router
        *generates* is a structured retryable error with a
        ``Retry-After`` pacing hint — the client's own policy decides
        what to do."""
        from paddle_tpu_torch import profiler as _profiler
        from paddle_tpu_torch.fault.retry import RetryError
        deadline_at = time.monotonic() + budget
        tried = []
        t0 = time.perf_counter()

        def attempt():
            remaining = deadline_at - time.monotonic()
            if remaining <= 0:
                raise _DeadlineExhausted(
                    f"deadline ({budget * 1e3:.0f}ms) exhausted after "
                    f"{len(tried)} attempt(s)")
            addr = self._pick(tried)
            tried.append(addr)
            with _span("fleet.attempt", replica=addr,
                       attempt=len(tried)):
                return self._forward(addr, path, raw, request_id,
                                     remaining)

        def on_retry(attempt_no, exc, delay):
            _profiler.runtime_metrics.inc("fleet.retries")

        try:
            with _trace.trace_context(request_id), \
                    _span("fleet.request", request_id=request_id,
                          path=path):
                status, body, ctype, headers = self._retry.call(
                    attempt, on_retry=on_retry, deadline=budget)
            if status == 200:
                _profiler.runtime_metrics.inc("fleet.requests_ok")
                if len(tried) > 1:
                    # the request changed replicas and still completed:
                    # the headline failover event, logged for forensics
                    _profiler.runtime_metrics.inc("fleet.failovers")
                    self.failover_log.append(
                        (request_id, *tried))
            return status, body, ctype, headers
        except _DeadlineExhausted as e:
            _profiler.runtime_metrics.inc("fleet.shed")
            return self._shed(504, "deadline_exceeded", str(e), tried,
                              retry_after=self._shed_hint(deadline_at))
        except RetryError as e:
            e.history = list(tried)
            _profiler.runtime_metrics.inc("fleet.shed")
            if isinstance(e.last, _NoReplicas):
                return self._shed(
                    503, "no_replicas", str(e.last), tried,
                    retry_after=self._shed_hint(deadline_at))
            return self._shed(503, "upstream_unavailable",
                              f"all failover attempts failed: {e.last}",
                              tried,
                              retry_after=self._shed_hint(deadline_at))
        except _NoReplicas as e:
            _profiler.runtime_metrics.inc("fleet.shed")
            return self._shed(503, "no_replicas", str(e), tried,
                              retry_after=self._shed_hint(deadline_at))
        finally:
            _profiler.runtime_metrics.observe(
                "fleet.request_seconds", time.perf_counter() - t0)

    # -- streamed generation (/generate) -----------------------------------
    def route_stream(self, handler, raw, request_id, budget):
        """Forward one ``/generate`` request, relaying response chunks
        to ``handler`` AS the replica produces them (no body
        buffering — the first token reaches the caller while the
        replica is still decoding).

        Failover semantics: retryable failures BEFORE the first
        forwarded byte (connection failure, retryable 503/504, upstream
        dying without producing a chunk) fail over to a sibling replica
        exactly like :meth:`route`.  MID-stream, the request is a
        tracked *session*: when the owning replica dies (or hands the
        stream back with a drain-time ``migrate`` tail), the router
        re-submits ``prompt + tokens_delivered`` with a ``resume_from``
        index to a survivor and splices the deterministic continuation
        into the same client response — the caller sees one
        uninterrupted, duplicate-free token sequence.  Only when every
        resume attempt fails does the relay terminate with a structured
        trailing error line (now carrying ``token_index`` +
        ``retryable``)."""
        from paddle_tpu_torch import profiler as _profiler
        from paddle_tpu_torch.fault.retry import RetryError
        from paddle_tpu_torch.fleet import sessions as _sessions
        deadline_at = time.monotonic() + budget
        tried = []
        t0 = time.perf_counter()
        # parse once for the session registry; malformed bodies forward
        # verbatim (the replica owns request validation and the 400)
        sess = None
        try:
            req = json.loads(raw)
            prompt = [int(t) for t in req.get("prompt") or []]
            if prompt:
                sid = str(req.get("session_id")
                          or _sessions.new_session_id())
                sess = {"sid": sid, "prompt": prompt,
                        "max_new": int(req.get("max_new_tokens", 16)),
                        "eos_id": req.get("eos_id"),
                        "stream": bool(req.get("stream", True)),
                        "resume_from0": int(req.get("resume_from", 0)
                                            or 0),
                        "tokens": [], "sent_headers": False,
                        "resumed": False}
                self.sessions.begin(sid, None, prompt, sess["max_new"],
                                    delivered=sess["resume_from0"])
        except (AttributeError, TypeError, ValueError):
            sess = None

        def attempt():
            remaining = deadline_at - time.monotonic()
            if remaining <= 0:
                raise _DeadlineExhausted(
                    f"deadline ({budget * 1e3:.0f}ms) exhausted after "
                    f"{len(tried)} attempt(s)")
            # affine routing: a follow-up/resume for a known session
            # goes back to the owning replica when it is still live
            prefer = (self.sessions.owner(sess["sid"])
                      if sess is not None else None)
            addr = self._pick(tried, prefer=prefer)
            tried.append(addr)
            if sess is not None:
                self.sessions.note(sess["sid"], replica=addr)
            with _span("fleet.attempt", replica=addr,
                       attempt=len(tried)):
                return self._forward_stream(addr, handler, raw,
                                            request_id, remaining,
                                            sess=sess)

        def on_retry(attempt_no, exc, delay):
            _profiler.runtime_metrics.inc("fleet.retries")

        try:
            with _trace.trace_context(request_id), \
                    _span("fleet.request", request_id=request_id,
                          path="/generate"):
                outcome = self._retry.call(attempt, on_retry=on_retry,
                                           deadline=budget)
            if sess is not None and outcome == "passthrough":
                self.sessions.finish(sess["sid"])
            if outcome == "ok":
                # only CLEAN completions count: a relay terminated by a
                # mid-stream upstream death delivered an error tail,
                # not a successful request
                _profiler.runtime_metrics.inc("fleet.requests_ok")
                if len(tried) > 1:
                    _profiler.runtime_metrics.inc("fleet.failovers")
                    self.failover_log.append((request_id, *tried))
            return
        except _StreamAborted:
            # downstream client hung up mid-stream: nothing to reply
            # to (the session entry stays until the orphan eviction —
            # a reconnecting client may still resume it)
            handler.close_connection = True
            return
        except _DeadlineExhausted as e:
            _profiler.runtime_metrics.inc("fleet.shed")
            code, body, ctype, headers = self._shed(
                504, "deadline_exceeded", str(e), tried,
                retry_after=self._shed_hint(deadline_at))
        except RetryError as e:
            e.history = list(tried)
            _profiler.runtime_metrics.inc("fleet.shed")
            if isinstance(e.last, _NoReplicas):
                code, body, ctype, headers = self._shed(
                    503, "no_replicas", str(e.last), tried,
                    retry_after=self._shed_hint(deadline_at))
            else:
                code, body, ctype, headers = self._shed(
                    503, "upstream_unavailable",
                    f"all failover attempts failed: {e.last}", tried,
                    retry_after=self._shed_hint(deadline_at))
        except _NoReplicas as e:
            _profiler.runtime_metrics.inc("fleet.shed")
            code, body, ctype, headers = self._shed(
                503, "no_replicas", str(e), tried,
                retry_after=self._shed_hint(deadline_at))
        finally:
            _profiler.runtime_metrics.observe(
                "fleet.request_seconds", time.perf_counter() - t0)
        if sess is not None and sess["sent_headers"]:
            # the 200 + chunked headers are already downstream: the
            # terminal failure must ride the stream as an error TAIL,
            # not a second status line
            try:
                err = json.loads(body).get("error") or {}
            except ValueError:
                err = {}
            self._finish_stream(
                handler,
                error=err.get("message", "stream failed"),
                etype=err.get("type", "upstream_died"),
                token_index=sess["resume_from0"] + len(sess["tokens"]),
                retryable=True)
            self.sessions.finish(sess["sid"])
            return
        if sess is not None:
            self.sessions.finish(sess["sid"])
        handler._reply_raw(code, body, ctype, headers)

    def _forward_stream(self, addr, handler, raw, request_id, remaining,
                        sess=None):
        """One streamed attempt; returns ``"ok"`` when the relay ran to
        clean completion, ``"upstream_error"`` when it relayed a
        terminal error tail, ``"upstream_died"`` when a SESSION-less
        relay was terminated mid-stream, ``"passthrough"`` when the
        upstream reply was passed through verbatim (permanent error).

        With session state (``sess``), a mid-stream owner death, a
        retryable error tail, or a drain-time ``migrate`` tail raises
        ``_Transient`` INSTEAD of terminating the relay: the retry
        policy re-enters this method with ``sess["resumed"]`` set, the
        request body is rebuilt as ``prompt + tokens_delivered`` with a
        ``resume_from`` index, and the survivor's continuation is
        spliced into the SAME downstream chunked response — exactly-once
        token delivery across replica death, keyed on the monotone
        ``token_index``."""
        import http.client

        from paddle_tpu_torch import profiler as _profiler
        from paddle_tpu_torch.fault import chaos
        try:
            chaos.fire("fleet.route.blackhole", replica=addr)
        except chaos.FaultInjected as e:
            self._mark_down(addr)
            raise _Transient(f"route to {addr} blackholed") from e
        sid = sess["sid"] if sess is not None else None
        resumed = bool(sess and sess["resumed"])
        body = raw if sess is None else self._resume_body(sess, raw)
        with self._lock:
            entry = self._table.get(addr)
            if entry is not None:
                entry["outstanding"] += 1
                entry["requests"] += 1
        timeout = min(remaining, self._attempt_timeout)
        headers = {
            "Content-Type": "application/json",
            "X-Request-Id": request_id,
            "X-Deadline-Ms": str(int(remaining * 1000)),
        }

        def resume_or_die(msg, mark_down=True, cause=None):
            # one mid-stream fault, one decision: sessions fail over
            # (the policy re-enters with a rebuilt resume body);
            # session-less relays terminate with a legacy error tail
            self._drop_conn(addr)
            if mark_down:
                self._mark_down(addr)
            if sess is not None:
                if sess["sent_headers"] and \
                        len(sess["tokens"]) >= sess["max_new"]:
                    # every budgeted token is already delivered — only
                    # the done tail was lost: synthesize it, no resume
                    self._synthesize_done(handler, sess)
                    return "ok"
                sess["resumed"] = True
                _profiler.runtime_metrics.inc("gen.session.resumes")
                raise _Transient(
                    f"session {sid}: {msg} — resuming from token "
                    f"{sess['resume_from0'] + len(sess['tokens'])}"
                ) from cause
            self._finish_stream(handler, error=msg)
            return "upstream_died"

        try:
            for retry_fresh in (False, True):
                reused, conn = self._pooled_conn(addr, timeout)
                try:
                    conn.request("POST", "/generate", body, headers)
                    resp = conn.getresponse()
                    break
                except (OSError, http.client.HTTPException) as e:
                    self._drop_conn(addr)
                    if reused and not retry_fresh:
                        continue
                    self._mark_down(addr)
                    raise ConnectionError(
                        f"replica {addr} unreachable: {e}") from e
            if resp.status != 200:
                rbody = resp.read()
                from paddle_tpu_torch.fault.retry import parse_retry_after
                hint_raw = resp.getheader("Retry-After")
                if resp.will_close:
                    self._drop_conn(addr)
                try:
                    parsed = json.loads(rbody)
                except ValueError:
                    parsed = {"retryable":
                              resp.status in (429, 502, 503, 504)}
                if parsed.get("retryable"):
                    if resp.status == 429 and \
                            not self._alternative_with_headroom(addr) \
                            and not (sess and sess["sent_headers"]):
                        # no sibling with scraped headroom: the 429 +
                        # Retry-After passes through verbatim
                        handler._reply_raw(
                            resp.status, rbody, "application/json",
                            {"Retry-After": hint_raw} if hint_raw
                            else None)
                        return "passthrough"
                    err = parsed.get("error") or {}
                    exc = _Transient(
                        f"replica {addr} replied {resp.status} "
                        f"{err.get('type', 'retryable')}: "
                        f"{err.get('message', '')}")
                    hint = parse_retry_after(hint_raw)
                    if hint is not None:
                        exc.retry_after = hint
                    raise exc
                if sess is not None and sess["sent_headers"]:
                    # a resume attempt hit a PERMANENT error (e.g.
                    # resume_unsupported) after the 200 went downstream:
                    # terminate the stream with a non-retryable tail
                    err = parsed.get("error") or {}
                    self._finish_stream(
                        handler,
                        error=err.get("message",
                                      f"upstream replied {resp.status}"),
                        etype=err.get("type", "upstream_error"),
                        token_index=(sess["resume_from0"]
                                     + len(sess["tokens"])),
                        retryable=False)
                    self.sessions.finish(sid)
                    return "upstream_error"
                handler._reply_raw(resp.status, rbody,
                                   "application/json")
                return "passthrough"
            # the replica holds its 200 until the first token exists,
            # so the first line is imminent; reading it BEFORE sending
            # downstream headers keeps this attempt fully retryable
            try:
                first = resp.readline()
            except (OSError, http.client.HTTPException) as e:
                self._drop_conn(addr)
                self._mark_down(addr)
                raise ConnectionError(
                    f"replica {addr} died before streaming: {e}") from e
            if not first:
                self._drop_conn(addr)
                self._mark_down(addr)
                raise _Transient(
                    f"replica {addr} closed the stream before the "
                    f"first chunk")
            ctype = resp.getheader("Content-Type",
                                   "application/x-ndjson")
            if sess is None:
                return self._relay_stream_verbatim(
                    addr, handler, request_id, resp, first, ctype)
            # session-aware relay: parse each upstream line, dedupe on
            # token_index, convert resumable faults into failover
            terminal = None
            line = first
            while True:
                try:
                    obj = json.loads(line)
                except ValueError:
                    obj = None
                if obj is not None and "token" in obj \
                        and "index" in obj:
                    delivered = (sess["resume_from0"]
                                 + len(sess["tokens"]))
                    idx = obj["index"]
                    if idx < delivered:
                        # replayed prefix after a resume: exactly-once
                        # delivery is THIS drop
                        _profiler.runtime_metrics.inc(
                            "gen.session.dedup_drops")
                    elif idx > delivered:
                        return resume_or_die(
                            f"token_index gap (got {idx}, expected "
                            f"{delivered})", mark_down=False)
                    else:
                        try:
                            chaos.fire("gen.session.kill_owner",
                                       replica=addr, session=sid)
                        except chaos.FaultInjected as e:
                            # the drill: the owner dies after producing
                            # this token but before the relay — it is
                            # lost upstream and a survivor must
                            # regenerate it
                            return resume_or_die(
                                f"owner {addr} killed (fault "
                                f"injection)", cause=e)
                        try:
                            self._ensure_stream_headers(
                                handler, sess, request_id, ctype)
                            self._relay_chunk(handler, line)
                        except OSError as e:
                            self._drop_conn(addr)
                            raise _StreamAborted(str(e)) from e
                        sess["tokens"].append(int(obj["token"]))
                        if resumed:
                            _profiler.runtime_metrics.inc(
                                "gen.session.spliced_tokens")
                        self.sessions.note(sid, delivered=delivered + 1)
                elif obj is not None and obj.get("done") \
                        and "migrate" in obj:
                    # drain-time hand-back: the owner checkpointed the
                    # stream at a token boundary — re-place it on a
                    # survivor (the owner is NOT down, just leaving)
                    return resume_or_die(
                        f"owner {addr} draining (migrate tail at "
                        f"token {obj['migrate'].get('resume_from')})",
                        mark_down=False)
                elif obj is not None and obj.get("done") \
                        and obj.get("error") is not None \
                        and obj.get("retryable"):
                    # the replica ended the stream with a RETRYABLE
                    # failure tail (scheduler abort, stall): resume
                    # on a sibling instead of surfacing it
                    return resume_or_die(
                        f"retryable upstream error tail "
                        f"({(obj.get('error') or {}).get('type')})",
                        mark_down=False)
                elif obj is not None and obj.get("done"):
                    # clean finish or non-retryable error: relay the
                    # tail verbatim and evict the session
                    try:
                        self._ensure_stream_headers(
                            handler, sess, request_id, ctype)
                        self._relay_chunk(handler, line)
                    except OSError as e:
                        self._drop_conn(addr)
                        raise _StreamAborted(str(e)) from e
                    terminal = ("upstream_error" if obj.get("error")
                                else "ok")
                    self.sessions.finish(sid)
                else:
                    # unparseable / unknown event shape: relay verbatim
                    try:
                        self._ensure_stream_headers(
                            handler, sess, request_id, ctype)
                        self._relay_chunk(handler, line)
                    except OSError as e:
                        self._drop_conn(addr)
                        raise _StreamAborted(str(e)) from e
                try:
                    chaos.fire("gen.stream.truncate", replica=addr,
                               session=sid)
                    line = resp.readline()
                except chaos.FaultInjected as e:
                    if terminal is not None:
                        self._drop_conn(addr)
                        line = b""
                    else:
                        return resume_or_die(
                            "stream truncated (fault injection)",
                            mark_down=False, cause=e)
                except (OSError, http.client.HTTPException) as e:
                    if terminal is not None:
                        self._drop_conn(addr)
                        line = b""
                    else:
                        return resume_or_die(
                            f"owner {addr} died mid-stream: {e}",
                            cause=e)
                if not line:
                    break
            if terminal is None:
                # EOF without a terminal tail: the owner closed the
                # stream mid-decode (hard kill between chunks)
                return resume_or_die(
                    f"owner {addr} closed the stream without a "
                    f"terminal event")
            try:
                handler.wfile.write(b"0\r\n\r\n")
                handler.wfile.flush()
            except OSError as e:
                raise _StreamAborted(str(e)) from e
            return terminal
        finally:
            with self._lock:
                entry = self._table.get(addr)
                if entry is not None:
                    entry["outstanding"] = max(
                        0, entry["outstanding"] - 1)

    def _relay_stream_verbatim(self, addr, handler, request_id, resp,
                               first, ctype):
        """The session-less relay (body did not parse as a generate
        request): chunks pass through verbatim, a mid-stream upstream
        death terminates with a legacy error tail — no resume."""
        import http.client
        try:
            handler.send_response(200)
            handler.send_header("Content-Type", ctype)
            handler.send_header("Transfer-Encoding", "chunked")
            if request_id:
                handler.send_header("X-Request-Id", request_id)
            handler.end_headers()
            self._relay_chunk(handler, first)
        except OSError as e:
            self._drop_conn(addr)
            raise _StreamAborted(str(e)) from e
        last = first
        while True:
            try:
                line = resp.readline()
            except (OSError, http.client.HTTPException) as e:
                # upstream died MID-stream: the request cannot be
                # replayed (tokens already delivered) — terminate
                # with a structured error line the client can parse
                self._drop_conn(addr)
                self._mark_down(addr)
                self._finish_stream(handler, error=(
                    f"replica {addr} died mid-stream: {e}"))
                return "upstream_died"
            if not line:
                break
            last = line
            try:
                self._relay_chunk(handler, line)
            except OSError as e:
                self._drop_conn(addr)
                raise _StreamAborted(str(e)) from e
        try:
            handler.wfile.write(b"0\r\n\r\n")
            handler.wfile.flush()
        except OSError as e:
            raise _StreamAborted(str(e)) from e
        # a replica-side failure (scheduler crash, stall) ends the
        # stream CLEANLY with an {"error": ..., "done": true} tail
        # — one JSON parse of the final line keeps that out of the
        # success metrics without re-encoding the relayed body
        if b'"error"' in last:
            try:
                if json.loads(last).get("error"):
                    return "upstream_error"
            except ValueError:
                pass
        return "ok"

    @staticmethod
    def _resume_body(sess, raw):
        """The request body for one attempt: the caller's bytes
        verbatim until a resume happens, then a rebuilt re-prefill
        request — the original prompt plus every token already
        delivered downstream, with ``resume_from`` so the survivor
        numbers its continuation exactly where the dead owner
        stopped."""
        if not sess["resumed"]:
            return raw
        delivered = sess["resume_from0"] + len(sess["tokens"])
        p = {"prompt": sess["prompt"] + sess["tokens"],
             "max_new_tokens": sess["max_new"] - len(sess["tokens"]),
             "resume_from": delivered,
             "stream": sess["stream"],
             "session_id": sess["sid"]}
        if sess["eos_id"] is not None:
            p["eos_id"] = sess["eos_id"]
        return json.dumps(p).encode()

    @staticmethod
    def _ensure_stream_headers(handler, sess, request_id, ctype):
        """Send the downstream 200 + chunked headers exactly once per
        CLIENT response, even when the upstream relay fails over
        mid-stream (the spliced continuation rides the same
        response)."""
        if sess["sent_headers"]:
            return
        handler.send_response(200)
        handler.send_header("Content-Type", ctype)
        handler.send_header("Transfer-Encoding", "chunked")
        if request_id:
            handler.send_header("X-Request-Id", request_id)
        handler.end_headers()
        sess["sent_headers"] = True

    def _synthesize_done(self, handler, sess, reason="length"):
        """Every budgeted token reached the client but the owner died
        before its done tail: the router KNOWS the stream is complete,
        so it synthesizes the terminal event instead of burning a
        resume that would be rejected for an empty budget."""
        delivered = sess["resume_from0"] + len(sess["tokens"])
        line = (json.dumps({"done": True, "finish_reason": reason,
                            "tokens": delivered,
                            "token_index": delivered}) + "\n").encode()
        try:
            self._relay_chunk(handler, line)
            handler.wfile.write(b"0\r\n\r\n")
            handler.wfile.flush()
        except OSError:
            handler.close_connection = True
        self.sessions.finish(sess["sid"])

    @staticmethod
    def _relay_chunk(handler, line):
        handler.wfile.write(b"%x\r\n" % len(line) + line + b"\r\n")
        handler.wfile.flush()

    def _finish_stream(self, handler, error, etype="upstream_died",
                       token_index=None, retryable=True):
        """Terminate an already-started chunked relay with a structured
        error tail.  New tails carry the ``token_index`` high-water
        mark plus a top-level ``retryable`` flag so resuming clients
        know exactly where the stream stopped; legacy tails (neither
        field) must keep parsing — the protocol regression test holds
        both shapes against the schema."""
        obj = {"error": {"type": etype, "message": error},
               "done": True, "retryable": bool(retryable)}
        if token_index is not None:
            obj["token_index"] = int(token_index)
        try:
            line = (json.dumps(obj) + "\n").encode()
            self._relay_chunk(handler, line)
            handler.wfile.write(b"0\r\n\r\n")
            handler.wfile.flush()
        except OSError:
            handler.close_connection = True

    @staticmethod
    def _shed(code, etype, message, tried, retry_after=None):
        obj = {"error": {"type": etype, "message": message},
               "retryable": True,
               "replicas_tried": list(tried)}
        headers = None
        if retry_after is not None:
            obj["retry_after_s"] = retry_after
            headers = {"Retry-After": f"{retry_after:.3f}"}
        return code, json.dumps(obj).encode(), "application/json", \
            headers

    def _pooled_conn(self, addr, timeout):
        """(reused, conn): this handler thread's keep-alive connection
        to ``addr``, or a fresh one.  The per-attempt timeout is applied
        to the live socket on reuse."""
        import http.client

        from paddle_tpu_torch.fault.retry import parse_hostport
        pool = getattr(self._tl, "conns", None)
        if pool is None:
            pool = self._tl.conns = {}
        conn = pool.get(addr)
        if conn is not None:
            conn.timeout = timeout
            if conn.sock is not None:
                conn.sock.settimeout(timeout)
            return True, conn
        host, port = parse_hostport(addr)
        conn = http.client.HTTPConnection(host, port, timeout=timeout)
        pool[addr] = conn
        return False, conn

    def _drop_conn(self, addr):
        pool = getattr(self._tl, "conns", None)
        conn = pool.pop(addr, None) if pool else None
        if conn is not None:
            conn.close()

    def _forward(self, addr, path, raw, request_id, remaining):
        """One proxied attempt.  Success and PERMANENT upstream errors
        pass through verbatim; retryable upstream errors and transport
        failures raise (the policy fails the request over)."""
        import http.client

        from paddle_tpu_torch.fault import chaos
        try:
            chaos.fire("fleet.route.blackhole", replica=addr)
        except chaos.FaultInjected as e:
            self._mark_down(addr)
            raise _Transient(f"route to {addr} blackholed") from e
        with self._lock:
            entry = self._table.get(addr)
            if entry is not None:
                entry["outstanding"] += 1
                entry["requests"] += 1
        timeout = min(remaining, self._attempt_timeout)
        headers = {
            "Content-Type": "application/json",
            "X-Request-Id": request_id,
            # the REMAINING budget, not the original: replicas bound
            # their batcher wait by what the caller has left
            "X-Deadline-Ms": str(int(remaining * 1000)),
        }
        try:
            for retry_fresh in (False, True):
                reused, conn = self._pooled_conn(addr, timeout)
                try:
                    conn.request("POST", path, raw, headers)
                    resp = conn.getresponse()
                    body = resp.read()
                    status = resp.status
                    if resp.will_close:
                        self._drop_conn(addr)
                    break
                except (OSError, http.client.HTTPException) as e:
                    self._drop_conn(addr)
                    if reused and not retry_fresh:
                        # a stale keep-alive connection (replica idled
                        # it out) must not read as replica death: one
                        # fresh-connection retry against the SAME
                        # replica before declaring it unreachable
                        continue
                    self._mark_down(addr)
                    raise ConnectionError(
                        f"replica {addr} unreachable: {e}") from e
        finally:
            with self._lock:
                entry = self._table.get(addr)
                if entry is not None:
                    entry["outstanding"] = max(
                        0, entry["outstanding"] - 1)
        if status == 200:
            return status, body, "application/json", None
        from paddle_tpu_torch.fault.retry import parse_retry_after
        hint_raw = resp.getheader("Retry-After")
        try:
            parsed = json.loads(body)
        except ValueError:
            parsed = {"retryable": status in (429, 502, 503, 504)}
        if parsed.get("retryable"):
            if status == 429 and \
                    not self._alternative_with_headroom(addr):
                # saturated replica, no sibling with scraped headroom:
                # pass the 429 + Retry-After through VERBATIM so the
                # client backs off instead of the router burning its
                # budget hammering a uniformly saturated fleet
                return status, body, "application/json", \
                    ({"Retry-After": hint_raw} if hint_raw else None)
            err = parsed.get("error") or {}
            exc = _Transient(
                f"replica {addr} replied {status} "
                f"{err.get('type', 'retryable')}: "
                f"{err.get('message', '')}")
            hint = parse_retry_after(hint_raw)
            if hint is not None:
                # the retry policy paces the failover by the replica's
                # own hint instead of its default backoff
                exc.retry_after = hint
            raise exc
        # permanent upstream error (400 bad feed, 500 model bug): the
        # caller must see it unchanged — failing over would just repeat
        # the same error on a healthy replica
        return status, body, "application/json", None

    # -- lifecycle ---------------------------------------------------------
    def start_background(self):
        t = threading.Thread(target=self._server.serve_forever,
                             daemon=True, name="fleet-router")
        t.start()
        return t

    def serve_forever(self):
        self._server.serve_forever()

    def shutdown(self):
        self._stop.set()
        if self._slo is not None:
            self._slo.stop()
        self._server.shutdown()
        self._server.server_close()
        if self._master is not None:
            self._master.close()
