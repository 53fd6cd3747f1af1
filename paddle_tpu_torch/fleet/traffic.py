"""Traffic-replay harness: the load side of the fleet control loop.

A controller that only ever sees closed-loop bench clients is untested
where it matters — closed-loop load self-throttles exactly when the
fleet saturates (each client waits for its reply before sending the
next request), hiding the overload the controller exists to survive.
:class:`TrafficReplay` is OPEN-LOOP: arrivals are a Poisson process
whose rate follows a deterministic pattern function, independent of
how the fleet is coping, which is how real traffic behaves.

Patterns are plain ``t_seconds -> rps`` callables; :func:`step`
(the 5× ramp drill), :func:`diurnal` (slow sinusoidal swell), and
:func:`flash_crowd` (instant spike, exponential decay) cover the
shapes the autoscaler must survive.  :func:`heavy_tail_lengths` gives
a seeded lognormal prompt-length mix — the heavy tail is what makes
per-request cost non-uniform, which is what makes placement matter.

Every request is metered (``traffic.*`` counters + the
``traffic.request`` span) and classified:

- ``ok`` — 200.
- ``shed`` — 429: the fleet said "not now" WITH a pacing hint; the
  summary splits sheds by whether ``Retry-After`` was present, because
  a shed without a hint is a bug (the acceptance criterion).
- ``deadline`` — 504: the budget burned in a queue, the outcome
  admission control exists to prevent.
- ``error`` — transport failure or any other status: a LOST accepted
  request (the chaos drill's zero-loss criterion counts these).
- ``dropped`` — never sent: the replayer's own inflight cap was hit
  (client-side protection; not a fleet failure).

All randomness is seeded — two runs with the same seed replay the
same arrival schedule and prompt mix, so A/B runs (fixed fleet vs
controller fleet) see identical offered load.
"""

from __future__ import annotations

import math
import random
import threading
import time

from paddle_tpu_torch.obs.trace import span as _span

__all__ = ["TrafficReplay", "step", "diurnal", "flash_crowd",
           "heavy_tail_lengths"]


# ---------------------------------------------------------------------------
# rate patterns (t_seconds -> requests/sec)
# ---------------------------------------------------------------------------

def step(base_rps, peak_rps, at, duration=None):
    """Flat ``base_rps``, then a hard step to ``peak_rps`` at ``at``
    seconds (optionally stepping back down after ``duration``) — the
    "did the autoscaler keep up with a 5× step" drill."""
    base, peak, at = float(base_rps), float(peak_rps), float(at)

    def rate(t):
        if t < at:
            return base
        if duration is not None and t >= at + float(duration):
            return base
        return peak

    return rate


def diurnal(base_rps, peak_rps, period=60.0, phase=0.0):
    """Sinusoidal swell between ``base_rps`` and ``peak_rps`` over
    ``period`` seconds — the compressed day/night cycle (starts at the
    trough with ``phase=0``)."""
    base, peak = float(base_rps), float(peak_rps)
    period = float(period)

    def rate(t):
        frac = 0.5 * (1.0 - math.cos(
            2.0 * math.pi * (t + phase) / period))
        return base + (peak - base) * frac

    return rate


def flash_crowd(base_rps, peak_rps, at, rise=0.5, fall=5.0):
    """Flat ``base_rps`` until ``at``, a near-instant ramp to
    ``peak_rps`` over ``rise`` seconds, then exponential decay back
    with time-constant ``fall`` — the "a link went viral" shape that
    is too fast to scale for, i.e. the admission ladder's moment."""
    base, peak, at = float(base_rps), float(peak_rps), float(at)
    rise, fall = max(1e-6, float(rise)), max(1e-6, float(fall))

    def rate(t):
        if t < at:
            return base
        if t < at + rise:
            return base + (peak - base) * (t - at) / rise
        return base + (peak - base) * math.exp(-(t - at - rise) / fall)

    return rate


def heavy_tail_lengths(n, seed=0, median=32, sigma=1.0, cap=512):
    """``n`` seeded lognormal prompt lengths (median ``median`` tokens,
    shape ``sigma``, clamped to ``[1, cap]``) — the heavy-tailed mix
    where a p99 prompt costs ~10× a median one."""
    rng = random.Random(seed)
    mu = math.log(max(1.0, float(median)))
    return [max(1, min(int(cap),
                       int(round(rng.lognormvariate(mu, sigma)))))
            for _ in range(int(n))]


# ---------------------------------------------------------------------------
# the replayer
# ---------------------------------------------------------------------------

class TrafficReplay:
    """Open-loop Poisson replay of a rate pattern against a fleet.

    ``send(i)`` performs ONE request (the bench wires an HTTP POST to
    the router here) and returns ``{"status": int, "retry_after":
    str | None, ...}``; raising classifies the request as ``error``.
    ``pattern`` is a ``t_seconds -> rps`` callable; ``duration`` bounds
    the replay; ``seed`` fixes the arrival schedule.  ``max_inflight``
    bounds the replayer's own thread fan-out — arrivals past the cap
    are counted ``dropped``, never silently skipped."""

    def __init__(self, send, pattern, duration, seed=0,
                 max_inflight=64, metrics=None):
        self._send = send
        self._pattern = pattern
        self._duration = float(duration)
        self._seed = int(seed)
        self._max_inflight = max(1, int(max_inflight))
        if metrics is None:
            from paddle_tpu_torch.profiler import runtime_metrics
            metrics = runtime_metrics
        self._metrics = metrics
        self._lock = threading.Lock()
        self._inflight = 0
        self.outcomes = []   # (outcome, latency_s, retry_after | None)

    # -- one request --------------------------------------------------------
    def _classify(self, result):
        status = result.get("status")
        if status == 200:
            return "ok"
        if status in (429, 503):
            # backpressure: admission shed (429) or the router giving
            # up retryably (503) — both tell the caller to come back,
            # both must carry Retry-After, neither is a lost request
            return "shed"
        if status == 504:
            return "deadline"
        return "error"

    def _one(self, i):
        t0 = time.perf_counter()
        try:
            with _span("traffic.request", index=i):
                result = self._send(i) or {}
            outcome = self._classify(result)
            hint = result.get("retry_after")
        except Exception as e:
            outcome, hint = "error", None
            result = {"exception": repr(e)}
        latency = time.perf_counter() - t0
        self._metrics.observe("traffic.request_seconds", latency)
        if outcome == "ok":
            self._metrics.inc("traffic.ok")
        elif outcome == "shed":
            self._metrics.inc("traffic.shed")
        elif outcome == "deadline":
            self._metrics.inc("traffic.deadline_exceeded")
        else:
            self._metrics.inc("traffic.errors")
        with self._lock:
            self.outcomes.append((outcome, latency, hint))
            self._inflight -= 1

    # -- the replay loop ----------------------------------------------------
    def run(self):
        """Replay the full schedule; returns :meth:`summary`.  Blocks
        until every dispatched request has completed — the tail of the
        last in-flight work belongs to the measurement."""
        rng = random.Random(self._seed)
        threads = []
        t_start = time.monotonic()
        next_at = 0.0
        i = 0
        while True:
            rate = max(0.0, float(self._pattern(next_at)))
            if rate <= 0.0:
                # idle stretch of the pattern: walk time forward until
                # the rate comes back (or the replay ends)
                next_at += 0.05
            else:
                next_at += rng.expovariate(rate)
            if next_at >= self._duration:
                break
            if rate <= 0.0:
                continue
            delay = t_start + next_at - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            self._metrics.inc("traffic.sent")
            with self._lock:
                over = self._inflight >= self._max_inflight
                if not over:
                    self._inflight += 1
            if over:
                # open-loop protection: the fleet is so far behind that
                # the replayer would hoard threads — count it, loudly
                self._metrics.inc("traffic.dropped")
                with self._lock:
                    self.outcomes.append(("dropped", 0.0, None))
                i += 1
                continue
            t = threading.Thread(target=self._one, args=(i,),
                                 daemon=True,
                                 name=f"traffic-replay-{i}")
            t.start()
            threads.append(t)
            i += 1
        for t in threads:
            t.join(timeout=60.0)
        return self.summary()

    # -- results ------------------------------------------------------------
    def summary(self):
        """Aggregate the replay: per-outcome counts, the
        with/without-``Retry-After`` shed split, and latency
        percentiles over completed (ok) requests."""
        with self._lock:
            outcomes = list(self.outcomes)
        counts = {"ok": 0, "shed": 0, "deadline": 0, "error": 0,
                  "dropped": 0}
        shed_with_hint = shed_without_hint = 0
        ok_lat = []
        for outcome, latency, hint in outcomes:
            counts[outcome] = counts.get(outcome, 0) + 1
            if outcome == "ok":
                ok_lat.append(latency)
            elif outcome == "shed":
                if hint:
                    shed_with_hint += 1
                else:
                    shed_without_hint += 1
        ok_lat.sort()

        def pct(q):
            if not ok_lat:
                return None
            return ok_lat[min(len(ok_lat) - 1,
                              int(q / 100.0 * len(ok_lat)))]

        return {"attempted": len(outcomes),
                "outcomes": counts,
                "shed_with_hint": shed_with_hint,
                "shed_without_hint": shed_without_hint,
                "lost_accepted": counts["error"] + counts["deadline"],
                "latency_ms": {"p50": (pct(50) or 0.0) * 1e3,
                               "p99": (pct(99) or 0.0) * 1e3}}
