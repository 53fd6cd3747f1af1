"""Runtime metrics and the op-level table (the parts of
``paddle_tpu.profiler`` the port has): one process-wide registry of
counters, gauges, bounded latency reservoirs and small-value histograms,
served by the inference server's ``/stats`` and ``/metrics`` and by
``paddle_tpu_torch stats``; and the per-op-type timing table of
:func:`op_profiler` (reference ``platform/profiler.h``), which forces the
executor's op-by-op eager step.

CUDA graph captures are recorded as the JAX package's compile listeners
record compiles: ``compile.backend_seconds`` and ``compile.events``.  The
JAX package's trace bridge (``jax.profiler``, device-second measurement)
has no counterpart here yet; the port's device timing will sit on
``torch.profiler``.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

__all__ = ["RuntimeMetrics", "runtime_metrics", "record_latency",
           "reset_profiler", "op_profiling_enabled", "enable_op_profiling",
           "disable_op_profiling", "record_op", "op_profile_table",
           "op_profiler"]

# ---------------------------------------------------------------------------
# op-level aggregation table (reference EnableProfiler/DisableProfiler,
# ``platform/profiler.h:110-115``: sorted per-op-type event tables).
#
# A CUDA graph replays the whole step at once, so op-level timing runs
# the block in the executor's op-by-op eager step with a device sync per
# op, the overhead FLAGS_benchmark adds on the reference.
# ---------------------------------------------------------------------------

_op_profiling = False
_op_events = {}


def reset_profiler():
    """Clear the collected op-level events (reference ``profiler.py``
    reset_profiler)."""
    global _op_events
    _op_events = {}


def op_profiling_enabled():
    return _op_profiling


def enable_op_profiling():
    """Start collecting per-op timings; forces the eager step (it enters
    the executor's signature, so a graphed block is looked up anew)."""
    global _op_profiling, _op_events
    _op_profiling = True
    _op_events = {}


def disable_op_profiling():
    global _op_profiling
    _op_profiling = False


@contextlib.contextmanager
def record_op(op_type, ctx=None):
    """Time the body as one call of ``op_type``; with the lowering's
    ``ctx``, synchronize the device of its outputs first, so the interval
    covers device work (the reference's implicit wait)."""
    t0 = time.perf_counter()
    yield
    if ctx is not None:
        devices = {v.device for v in ctx.outputs.values()
                   if hasattr(v, "device") and v.device.type == "cuda"}
        if devices:
            import torch
            for d in devices:
                torch.cuda.synchronize(d)
    dt = time.perf_counter() - t0
    ev = _op_events.setdefault(op_type, [0, 0.0, 0.0])
    ev[0] += 1
    ev[1] += dt
    ev[2] = max(ev[2], dt)


def op_profile_table(sorted_key="total"):
    """Sorted per-op aggregation table as a string (reference
    ``profiler.h`` PrintProfiler: Event/Calls/Total/Min/Max/Ave)."""
    keys = {"total": 1, "calls": 0, "max": 2,
            "ave": lambda item: item[1][1] / max(item[1][0], 1)}
    k = keys.get(sorted_key or "total", 1)
    rows = sorted(_op_events.items(),
                  key=(k if callable(k) else (lambda item, i=k: item[1][i])),
                  reverse=True)
    lines = [f"{'Event':<28}{'Calls':>8}{'Total(ms)':>12}"
             f"{'Ave(ms)':>12}{'Max(ms)':>12}"]
    for op_type, (calls, total, mx) in rows:
        lines.append(f"{op_type:<28}{calls:>8}{total * 1e3:>12.3f}"
                     f"{total / max(calls, 1) * 1e3:>12.3f}{mx * 1e3:>12.3f}")
    return "\n".join(lines)


@contextlib.contextmanager
def op_profiler(sorted_key="total"):
    """Context manager: profile per-op and print the table on exit."""
    enable_op_profiling()
    try:
        yield
    finally:
        disable_op_profiling()
        print(op_profile_table(sorted_key))

# ---------------------------------------------------------------------------
# runtime metrics surface: counters, latency percentiles and small-value
# histograms.  One process-wide registry serves the executor (warmup),
# the kernel builds, the serving batcher and the generation scheduler.
# ---------------------------------------------------------------------------

_LATENCY_WINDOW = 2048  # samples kept per series for percentile estimates


def _nearest_rank(sorted_xs, q):
    """Nearest-rank percentile over an ascending-sorted list (shared by
    percentiles() and snapshot() so the two can never drift)."""
    if not sorted_xs:
        return None
    i = min(len(sorted_xs) - 1,
            max(0, int(round(q / 100.0 * len(sorted_xs))) - 1))
    return sorted_xs[i]


class RuntimeMetrics:
    """Thread-safe process-wide counters + bounded latency reservoirs."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters = collections.Counter()
        self._series = {}       # name -> deque[float] (bounded window)
        self._series_agg = {}   # name -> [count, total]  (unwindowed)
        self._hist = {}         # name -> Counter (small integer values)
        self._gauges = {}       # name -> float (last-write-wins level)

    # -- writers -------------------------------------------------------
    def inc(self, name, n=1):
        with self._lock:
            self._counters[name] += n

    def observe(self, name, value):
        """Record one sample (seconds, rows, ...) into a bounded window."""
        with self._lock:
            d = self._series.get(name)
            if d is None:
                d = self._series[name] = collections.deque(
                    maxlen=_LATENCY_WINDOW)
                self._series_agg[name] = [0, 0.0]
            d.append(float(value))
            agg = self._series_agg[name]
            agg[0] += 1
            agg[1] += float(value)

    def bucket(self, name, key):
        """Histogram over small discrete values (batch occupancy)."""
        with self._lock:
            self._hist.setdefault(name, collections.Counter())[int(key)] += 1

    def set_gauge(self, name, value):
        """Instantaneous level (queue depth, pool size): last write wins,
        unlike observe()'s sample series."""
        with self._lock:
            self._gauges[name] = float(value)

    # -- readers -------------------------------------------------------
    def counter(self, name):
        with self._lock:
            return self._counters.get(name, 0)

    def gauge(self, name):
        with self._lock:
            return self._gauges.get(name)

    def percentiles(self, name, qs=(50, 95, 99)):
        """Window percentiles of ``name``; an unknown or empty series
        yields None per quantile (never raises — dashboards poll series
        that may not have emitted yet)."""
        with self._lock:
            d = self._series.get(name)
            xs = sorted(d) if d else []
        return {f"p{q}": _nearest_rank(xs, q) for q in qs}

    def snapshot(self):
        """One JSON-serializable dict of everything (the /stats body)."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hist = {n: {str(k): v for k, v in sorted(c.items())}
                    for n, c in self._hist.items()}
            series = {n: (list(d), list(self._series_agg[n]))
                      for n, d in self._series.items()}
        latency = {}
        for name, (window, (count, total)) in series.items():
            xs = sorted(window)
            entry = {"count": count, "total": total,
                     "mean": (total / count) if count else None}
            for q in (50, 95, 99):
                entry[f"p{q}"] = _nearest_rank(xs, q)
            # 1/mean — a true rate ONLY for serially-recorded series
            # (executor.step_seconds = steps/sec); for concurrent
            # series (request latencies) it is NOT throughput — divide
            # a request counter by wall time instead
            entry["per_sec_serial"] = (count / total) if total else None
            latency[name] = entry
        return {"counters": counters, "series": latency,
                "histograms": hist, "gauges": gauges}

    def reset(self):
        with self._lock:
            self._counters.clear()
            self._series.clear()
            self._series_agg.clear()
            self._hist.clear()
            self._gauges.clear()


runtime_metrics = RuntimeMetrics()


@contextlib.contextmanager
def record_latency(name, metrics=None):
    """Time the body and observe it as one sample of ``name``.

    A raising body still has its elapsed time observed (failures are
    often the SLOW samples — dropping them would flatter the
    percentiles) and additionally bumps the ``<name>.errors`` counter,
    so error-rate and latency stay attributable to the same series."""
    m = metrics or runtime_metrics
    t0 = time.perf_counter()
    try:
        yield
    except BaseException:
        m.observe(name, time.perf_counter() - t0)
        m.inc(name + ".errors")
        raise
    else:
        m.observe(name, time.perf_counter() - t0)

