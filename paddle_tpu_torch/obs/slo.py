"""SLO watchdog: declarative service-level objectives evaluated on a
sliding window over :class:`profiler.RuntimeMetrics`.

An SLO spec is a small JSON document (``PADDLE_TPU_SLO=/path/spec.json``
arms it; ``paddle_tpu selfcheck`` validates its schema statically):

.. code-block:: json

    {
      "version": 1,
      "interval_seconds": 5.0,
      "sustained_breaches": 3,
      "objectives": [
        {"name": "request-latency", "kind": "quantile",
         "series": "fleet.request_seconds", "quantile": "p99",
         "max": 0.5},
        {"name": "error-rate", "kind": "error_rate",
         "ok": ["fleet.requests_ok"], "errors": ["fleet.shed"],
         "max_ratio": 0.01},
        {"name": "ttft", "kind": "quantile",
         "series": "gen.ttft_seconds", "quantile": "p99", "max": 0.3},
        {"name": "tokens-floor", "kind": "rate_floor",
         "counter": "gen.tokens", "min_rate": 50.0}
      ]
    }

Three objective kinds cover the serving SLOs that matter:

- ``quantile`` — a windowed latency percentile (the bounded reservoir
  :meth:`RuntimeMetrics.percentiles` keeps) must stay under ``max``
  seconds.  No samples in the window = nothing to judge (skipped, not
  breached).
- ``error_rate`` — errors / (ok + errors) over the counter DELTAS since
  the previous evaluation must stay under ``max_ratio``.  A window with
  zero traffic is skipped.
- ``rate_floor`` — a counter's rate (delta / elapsed) must stay at or
  above ``min_rate``.  By default an idle window (zero delta) is
  skipped — a tokens/s floor means "when generating, generate this
  fast", not "never be idle"; set ``"idle_ok": false`` for a liveness
  floor that breaches on silence.

The :class:`SLOWatchdog` emits ``slo.evaluations`` / ``slo.breach``
counters and the ``slo.breaching`` gauge, keeps a bounded structured
``breach_log``, logs every breach, and — after ``sustained_breaches``
CONSECUTIVE breaches of one objective — writes a flight-recorder
post-mortem (``slo.postmortems``) so the span ring and metrics at the
moment the SLO went red are preserved.  The episode re-arms after the
objective recovers: a flapping SLO produces one post-mortem per
sustained episode, not one per evaluation.

Hot-path contract: :func:`tick` is the only thing schedulers/routers
call per iteration — a ``None`` watchdog costs one identity check, an
armed-but-not-due one costs a single monotonic clock read (guarded by
``tests/test_obs_overhead.py``).
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
import time

logger = logging.getLogger(__name__)

__all__ = ["SLOSpec", "SLOWatchdog", "load_spec", "validate_spec",
           "watchdog_from_env", "tick", "SLO_ENV", "EXAMPLE_SPEC"]

SLO_ENV = "PADDLE_TPU_SLO"
SPEC_VERSION = 1
_KINDS = ("quantile", "error_rate", "rate_floor")
_QUANTILES = ("p50", "p95", "p99")

# the documented spec shape — selfcheck validates this constant so the
# schema validator itself is exercised even when no spec file is armed
EXAMPLE_SPEC = {
    "version": 1,
    "interval_seconds": 5.0,
    "sustained_breaches": 3,
    "objectives": [
        {"name": "request-latency-p99", "kind": "quantile",
         "series": "fleet.request_seconds", "quantile": "p99",
         "max": 0.5},
        {"name": "error-rate", "kind": "error_rate",
         "ok": ["fleet.requests_ok"], "errors": ["fleet.shed"],
         "max_ratio": 0.01},
        {"name": "ttft-p99", "kind": "quantile",
         "series": "gen.ttft_seconds", "quantile": "p99", "max": 0.3},
        {"name": "tokens-per-sec-floor", "kind": "rate_floor",
         "counter": "gen.tokens", "min_rate": 50.0},
    ],
}


def _is_number(v):
    return isinstance(v, (int, float)) and not isinstance(v, bool) \
        and v == v and abs(v) != float("inf")


def validate_spec(obj):
    """Schema problems of an SLO spec dict, as a list of strings (empty
    = valid).  Never raises — selfcheck renders the list."""
    problems = []
    if not isinstance(obj, dict):
        return [f"spec must be a JSON object, got {type(obj).__name__}"]
    if obj.get("version") != SPEC_VERSION:
        problems.append(f"version must be {SPEC_VERSION}, "
                        f"got {obj.get('version')!r}")
    for key in ("interval_seconds",):
        if key in obj and (not _is_number(obj[key]) or obj[key] <= 0):
            problems.append(f"{key} must be a positive number")
    if "sustained_breaches" in obj and (
            not isinstance(obj["sustained_breaches"], int)
            or isinstance(obj["sustained_breaches"], bool)
            or obj["sustained_breaches"] < 1):
        problems.append("sustained_breaches must be an integer >= 1")
    objectives = obj.get("objectives")
    if not isinstance(objectives, list) or not objectives:
        problems.append("objectives must be a non-empty list")
        objectives = []
    seen = set()
    for i, o in enumerate(objectives):
        where = f"objectives[{i}]"
        if not isinstance(o, dict):
            problems.append(f"{where}: must be an object")
            continue
        name = o.get("name")
        if not isinstance(name, str) or not name:
            problems.append(f"{where}: needs a non-empty string name")
        elif name in seen:
            problems.append(f"{where}: duplicate name {name!r}")
        else:
            seen.add(name)
        kind = o.get("kind")
        if kind not in _KINDS:
            problems.append(f"{where}: kind must be one of {_KINDS}, "
                            f"got {kind!r}")
            continue
        if kind == "quantile":
            if not isinstance(o.get("series"), str) or not o.get("series"):
                problems.append(f"{where}: quantile needs a series name")
            if o.get("quantile", "p99") not in _QUANTILES:
                problems.append(f"{where}: quantile must be one of "
                                f"{_QUANTILES}, "
                                f"got {o.get('quantile')!r}")
            if not _is_number(o.get("max")) or o.get("max") <= 0:
                problems.append(f"{where}: needs max > 0 (seconds)")
        elif kind == "error_rate":
            for key in ("ok", "errors"):
                v = o.get(key)
                if not isinstance(v, list) or not v or \
                        not all(isinstance(c, str) and c for c in v):
                    problems.append(f"{where}: {key} must be a non-empty "
                                    f"list of counter names")
            r = o.get("max_ratio")
            if not _is_number(r) or not (0 <= r <= 1):
                problems.append(f"{where}: max_ratio must be in [0, 1]")
        elif kind == "rate_floor":
            if not isinstance(o.get("counter"), str) or \
                    not o.get("counter"):
                problems.append(f"{where}: rate_floor needs a counter "
                                f"name")
            if not _is_number(o.get("min_rate")) or o["min_rate"] < 0:
                problems.append(f"{where}: needs min_rate >= 0")
            if "idle_ok" in o and not isinstance(o["idle_ok"], bool):
                problems.append(f"{where}: idle_ok must be a boolean")
        unknown = set(o) - {"name", "kind", "series", "quantile", "max",
                            "ok", "errors", "max_ratio", "counter",
                            "min_rate", "idle_ok", "description"}
        if unknown:
            problems.append(f"{where}: unknown keys {sorted(unknown)}")
    return problems


class SLOSpec:
    """A validated SLO spec; construct via :func:`load_spec`."""

    def __init__(self, obj, source=None):
        problems = validate_spec(obj)
        if problems:
            raise ValueError(
                "invalid SLO spec" + (f" ({source})" if source else "")
                + ":\n  " + "\n  ".join(problems))
        self.source = source
        self.interval = float(obj.get("interval_seconds", 5.0))
        self.sustained = int(obj.get("sustained_breaches", 3))
        self.objectives = [dict(o) for o in obj["objectives"]]

    def to_dict(self):
        return {"version": SPEC_VERSION,
                "interval_seconds": self.interval,
                "sustained_breaches": self.sustained,
                "objectives": [dict(o) for o in self.objectives]}


def load_spec(spec):
    """Coerce a path / dict / SLOSpec into an :class:`SLOSpec`; raises
    ``ValueError`` naming every schema problem."""
    if isinstance(spec, SLOSpec):
        return spec
    if isinstance(spec, dict):
        return SLOSpec(spec)
    with open(spec) as f:
        try:
            obj = json.load(f)
        except ValueError as e:
            raise ValueError(f"invalid SLO spec ({spec}): not JSON: {e}")
    return SLOSpec(obj, source=str(spec))


class SLOWatchdog:
    """Evaluate an :class:`SLOSpec` against a metrics registry.

    Two wirings (both used in-tree): the router runs :meth:`start` for
    a background evaluation thread; the :class:`gen.GenScheduler` calls
    :func:`tick` from its decode loop so evaluation piggybacks on the
    thread that produces the metrics being judged."""

    def __init__(self, spec, metrics=None, log_size=256):
        self.spec = load_spec(spec)
        if metrics is None:
            from paddle_tpu_torch.profiler import runtime_metrics
            metrics = runtime_metrics
        self._metrics = metrics
        self._lock = threading.Lock()
        self._last_eval = None           # monotonic of last evaluate()
        self._prev = None                # (monotonic, {counter: value})
        self._consecutive = collections.Counter()
        self._postmortem_armed = {o["name"]: True
                                  for o in self.spec.objectives}
        self.breach_log = collections.deque(maxlen=log_size)
        self.breaches_total = 0
        self.evaluations = 0
        self._last_values = []        # per-objective verdicts, last pass
        self._thread = None
        self._stop = threading.Event()

    # -- evaluation --------------------------------------------------------
    def _counters_for_prev(self):
        names = set()
        for o in self.spec.objectives:
            if o["kind"] == "error_rate":
                names.update(o["ok"])
                names.update(o["errors"])
            elif o["kind"] == "rate_floor":
                names.add(o["counter"])
        return {n: self._metrics.counter(n) for n in names}

    def evaluate(self):
        """One evaluation pass over every objective; returns the list
        of breach dicts found this pass.  All shared state
        (``_consecutive``, ``_postmortem_armed``, ``breach_log``) is
        mutated under the watchdog lock — :meth:`state` reads the same
        structures from HTTP handler threads, and a dict/deque resized
        mid-iteration would 500 the /stats probe at exactly breach
        onset."""
        now = time.monotonic()
        with self._lock:
            self._last_eval = now
            prev = self._prev
            counters = self._counters_for_prev()
            self._prev = (now, counters)
        elapsed = (now - prev[0]) if prev else None
        breaches = []
        breaching = 0
        last_values = []
        for o in self.spec.objectives:
            self._metrics.inc("slo.evaluations")
            verdict = self._judge(o, prev, counters, elapsed)
            name = o["name"]
            last_values.append({
                "objective": name, "kind": o["kind"],
                "value": None if verdict is None else verdict[0],
                "threshold": None if verdict is None else verdict[1],
                "breached": bool(verdict and verdict[2])})
            dump = False
            with self._lock:
                self.evaluations += 1
                if verdict is None:      # nothing to judge this window
                    self._consecutive[name] = 0
                    self._postmortem_armed[name] = True
                    continue
                value, threshold, breached = verdict
                if not breached:
                    self._consecutive[name] = 0
                    self._postmortem_armed[name] = True
                    continue
                breaching += 1
                self._consecutive[name] += 1
                breach = {"time_unix": time.time(),
                          "objective": name, "kind": o["kind"],
                          "value": value, "threshold": threshold,
                          "consecutive": self._consecutive[name]}
                self.breach_log.append(breach)
                log_tail = list(self.breach_log)[-32:]
                self.breaches_total += 1
                if self._consecutive[name] >= self.spec.sustained and \
                        self._postmortem_armed[name]:
                    # one post-mortem per sustained episode: re-arms
                    # only after the objective recovers (or goes idle)
                    self._postmortem_armed[name] = False
                    dump = True
            breaches.append(breach)
            self._metrics.inc("slo.breach")
            logger.warning("slo.breach %s", json.dumps(breach))
            if dump:
                self._metrics.inc("slo.postmortems")
                from paddle_tpu_torch.obs import flight
                flight.write_postmortem(
                    reason=f"sustained SLO breach: {name} "
                           f"({breach['consecutive']} consecutive)",
                    extra={"slo_breach": breach,
                           "breach_log": log_tail,
                           "spec": self.spec.to_dict()})
        with self._lock:
            self._last_values = last_values
        self._metrics.set_gauge("slo.breaching", breaching)
        return breaches

    def last_values(self):
        """Per-objective verdicts of the most recent :meth:`evaluate`
        pass: ``[{objective, kind, value, threshold, breached}]``
        (``value``/``threshold`` None when that window had nothing to
        judge).  This is the fleet controller's PRESSURE signal — it
        acts on value-vs-threshold *margins* before a breach, not only
        on the binary breach log."""
        with self._lock:
            return [dict(v) for v in self._last_values]

    def _judge(self, o, prev, counters, elapsed):
        """(value, threshold, breached) for one objective, or None when
        this window has nothing to judge."""
        kind = o["kind"]
        if kind == "quantile":
            q = o.get("quantile", "p99")
            value = self._metrics.percentiles(o["series"], (int(q[1:]),)) \
                .get(q)
            if value is None:
                return None
            return value, o["max"], value > o["max"]
        if prev is None or not elapsed or elapsed <= 0:
            return None                 # rate kinds need two passes
        if kind == "error_rate":
            ok = sum(counters[c] - prev[1].get(c, 0) for c in o["ok"])
            err = sum(counters[c] - prev[1].get(c, 0)
                      for c in o["errors"])
            total = ok + err
            if total <= 0:
                return None
            ratio = err / total
            return ratio, o["max_ratio"], ratio > o["max_ratio"]
        if kind == "rate_floor":
            delta = counters[o["counter"]] - \
                prev[1].get(o["counter"], 0)
            if delta == 0 and o.get("idle_ok", True):
                return None
            rate = delta / elapsed
            return rate, o["min_rate"], rate < o["min_rate"]
        return None  # pragma: no cover - validate_spec rejects

    def maybe_evaluate(self):
        """Evaluate iff the spec's interval has elapsed — the cheap
        call hot loops make every iteration."""
        last = self._last_eval
        if last is not None and \
                time.monotonic() - last < self.spec.interval:
            return None
        return self.evaluate()

    # -- state / lifecycle -------------------------------------------------
    def state(self):
        """JSON-able summary for /stats (shared structures copied
        under the watchdog lock — the evaluation thread mutates them
        concurrently)."""
        with self._lock:
            breaching = {name: n for name, n
                         in self._consecutive.items() if n}
            log_tail = list(self.breach_log)[-16:]
            evaluations = self.evaluations
            breaches_total = self.breaches_total
        return {"source": self.spec.source,
                "interval_seconds": self.spec.interval,
                "sustained_breaches": self.spec.sustained,
                "objectives": [o["name"] for o in self.spec.objectives],
                "evaluations": evaluations,
                "breaches_total": breaches_total,
                "breaching": breaching,
                "breach_log": log_tail}

    def start(self, interval=None):
        """Background evaluation thread (the router wiring); idempotent."""
        if self._thread is not None:
            return self._thread
        period = float(interval if interval is not None
                       else self.spec.interval)

        def loop():
            while not self._stop.wait(period):
                try:
                    self.evaluate()
                except Exception:  # pragma: no cover - must never die
                    logger.exception("slo watchdog evaluation failed")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="paddle-tpu-slo-watchdog")
        self._thread.start()
        return self._thread

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def watchdog_from_env(metrics=None):
    """An armed :class:`SLOWatchdog` from ``PADDLE_TPU_SLO``, or None
    when the env var is unset.  A malformed file WARNS and disarms —
    an observability knob must never veto serving (selfcheck is the
    static gate that fails it loudly)."""
    path = os.environ.get(SLO_ENV, "").strip()
    if not path:
        return None
    try:
        return SLOWatchdog(path, metrics=metrics)
    except (OSError, ValueError) as e:
        import warnings
        warnings.warn(f"{SLO_ENV}={path!r} did not load — SLO watchdog "
                      f"disarmed: {e}")
        return None


def tick(watchdog):
    """The per-iteration hot-path hook: no-op when no watchdog is
    armed, one clock read when armed but not due."""
    if watchdog is not None:
        watchdog.maybe_evaluate()
