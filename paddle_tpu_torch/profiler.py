"""Profiler bridge (the port of ``paddle_tpu.profiler``; reference
``python/paddle/fluid/profiler.py`` over the CUPTI device tracer): one
process-wide registry of counters, gauges, bounded latency reservoirs and
small-value histograms, served by the inference server's ``/stats`` and
``/metrics`` and by ``paddle_tpu_torch stats``; the per-op-type timing
table of :func:`op_profiler` (reference ``platform/profiler.h``), which
forces the executor's op-by-op eager step; and device timing on
``torch.profiler``.

Device timing.  Where the JAX package reads ``jax.profiler`` xplane
traces, the port records ``torch.profiler`` traces (CUPTI under it sees
the kernels the port launches through ``ctypes`` and the kernels inside
CUDA graph replays) and reads their Chrome trace JSON:
:func:`start_profiler` / :func:`stop_profiler` / :func:`profiler` write
one, :func:`iter_trace_events` walks its events,
:func:`device_busy_seconds` is the UNION of the device's kernel, copy and
memset intervals (overlapping kernels of several streams count once, so
a trace's busy time never exceeds its wall time),
:func:`scope_device_seconds` sums the events a name matches, and
:func:`measure_device_seconds` owns the trace's lifecycle around one
call.  Per-op attribution (:func:`compiled_op_table`,
:func:`compiled_profiler`): a graph replay carries no op boundaries, so
while such a profile is armed (:func:`op_ranges_enabled`) the executor
runs the eager step with a ``record_function`` range named
:func:`op_scope_name` around each op, and each kernel is charged to the
innermost range open on the thread that launched it (matched through the
trace's correlation ids).

CUDA graph captures are recorded as the JAX package's compile listeners
record compiles: ``compile.backend_seconds`` and ``compile.events``.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time

__all__ = ["RuntimeMetrics", "runtime_metrics", "record_latency",
           "reset_profiler", "op_profiling_enabled", "enable_op_profiling",
           "disable_op_profiling", "record_op", "op_profile_table",
           "op_profiler", "start_profiler", "stop_profiler", "profiler",
           "cuda_profiler", "op_scope_name", "parse_op_scope",
           "op_ranges_enabled", "iter_trace_events",
           "measure_device_seconds", "device_busy_seconds",
           "scope_device_seconds", "compiled_op_table",
           "compiled_profiler"]

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
# torch.profiler traces (the reference's start/stop_profiler and the JAX
# package's device-time readers, paddle_tpu/profiler.py:33-88, 218-307)
# ---------------------------------------------------------------------------

_active = None          # (torch.profiler.profile, profile_path)

#: Chrome-trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: categories of the host calls that launch it (their correlation ids
#: match the device events')
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _default_path():
    import tempfile
    return os.path.join(tempfile.gettempdir(), "paddle_tpu_profile")


def _activities(state="All"):
    import torch
    acts = []
    if state in ("CPU", "All"):
        acts.append(torch.profiler.ProfilerActivity.CPU)
    if state in ("GPU", "All") and torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts or [torch.profiler.ProfilerActivity.CPU]


def start_profiler(state="All", profile_path=None):
    """Start a ``torch.profiler`` trace (``state``: ``"CPU"``, ``"GPU"``
    or ``"All"``); :func:`stop_profiler` writes it under
    ``profile_path``.  A second start while one runs is ignored."""
    global _active
    if _active is not None:
        return
    import torch
    prof = torch.profiler.profile(activities=_activities(state))
    prof.start()
    _active = (prof, profile_path or _default_path())


def stop_profiler(sorted_key=None, profile_path=None):
    """Stop the running trace and write it as Chrome trace JSON,
    ``<profile_path>/trace.json``; returns that path (None when no trace
    ran)."""
    global _active
    if _active is None:
        return None
    import torch
    prof, path = _active
    _active = None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    path = profile_path or path
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, "trace.json")
    prof.export_chrome_trace(out)
    return out


@contextlib.contextmanager
def profiler(state="All", sorted_key=None, profile_path=None):
    """Reference ``profiler.py:76``: trace the body."""
    start_profiler(state, profile_path)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


@contextlib.contextmanager
def cuda_profiler(output_file, output_mode=None, config=None):
    """The reference's name, kept: a ``torch.profiler`` trace of the body
    written under ``output_file``."""
    with profiler("All", profile_path=output_file):
        yield


_SCOPE_PREFIX = "ptop_"


def op_scope_name(op):
    """The trace range name of an IR op: ``ptop_<type>__<first output>``
    (dots and slashes replaced, as the JAX package names its scopes)."""
    outs = op.output_arg_names
    tag = outs[0] if outs else ""
    return _SCOPE_PREFIX + f"{op.type}__{tag}".replace(".", "_") \
        .replace("/", "_")


def parse_op_scope(name):
    """The deepest ``ptop_`` component of a ``/``-separated name, as
    ``(op_type, output_tag)``, or None."""
    hit = None
    for part in str(name).split("/"):
        if part.startswith(_SCOPE_PREFIX):
            hit = part[len(_SCOPE_PREFIX):]
    if hit is None:
        return None
    op_type, _, tag = hit.partition("__")
    return op_type, tag


_op_ranges = False


def op_ranges_enabled():
    """True while a per-op device profile is armed: the executor then
    runs the eager step with a ``record_function`` range around each op
    (it enters the signature, so a graphed block is looked up anew)."""
    return _op_ranges


def _trace_files(trace):
    import glob
    if os.path.isdir(trace):
        return sorted(glob.glob(os.path.join(trace, "**", "*.json"),
                                recursive=True))
    return [trace]


def _trace_events(trace):
    """The complete ("X") events of a Chrome trace: a loaded dict, a
    JSON file, or a directory of them."""
    import json
    docs = [trace] if isinstance(trace, dict) else []
    if not docs:
        for path in _trace_files(trace):
            with open(path) as f:
                docs.append(json.load(f))
    events = []
    for doc in docs:
        evs = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
        events.extend(e for e in evs if e.get("ph") == "X")
    return events


def _correlation(ev):
    args = ev.get("args") or {}
    return args.get("correlation", args.get("correlation id"))


def _op_scopes(events):
    """``correlation id -> op scope name``: each launch charged to the
    innermost ``ptop_`` range open on its thread at its start."""
    ranges, launches = {}, {}
    for ev in events:
        key = (ev.get("pid"), ev.get("tid"))
        if ev.get("cat") == "user_annotation" and \
                str(ev.get("name", "")).startswith(_SCOPE_PREFIX):
            ranges.setdefault(key, []).append(
                (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]),
                 ev["name"]))
        elif ev.get("cat") in _LAUNCH_CATS and _correlation(ev) is not None:
            launches.setdefault(key, []).append((float(ev["ts"]),
                                                 _correlation(ev)))
    out = {}
    for key, calls in launches.items():
        spans = sorted(ranges.get(key, ()))
        calls.sort()
        stack, i = [], 0
        for ts, corr in calls:
            # ranges of one thread nest: the stack holds the chain of
            # open ones, the innermost on top
            while i < len(spans) and spans[i][0] <= ts:
                while stack and stack[-1][1] < spans[i][0]:
                    stack.pop()
                stack.append(spans[i])
                i += 1
            while stack and stack[-1][1] < ts:
                stack.pop()
            if stack:
                out[corr] = stack[-1][2]
    return out


def iter_trace_events(trace, device_only=False, exclude_async=False):
    """Yield ``(name_candidates, duration_ps)`` for every complete event
    of a ``torch.profiler`` Chrome trace (a dict, a JSON file, or a
    directory of them): the event's name, then, for a device event, the
    op range it is charged to (:func:`op_scope_name`).  ``device_only``
    keeps the device's kernels, copies and memsets; ``exclude_async``
    drops the ranges mirrored onto the device timeline
    (``gpu_user_annotation``), which overlap the kernels they contain."""
    events = _trace_events(trace)
    scopes = _op_scopes(events)
    for ev in events:
        cat = ev.get("cat")
        device = cat in DEVICE_CATS
        if device_only and not device:
            continue
        if exclude_async and cat == "gpu_user_annotation":
            continue
        cands = [str(ev.get("name", ""))]
        if device:
            scope = scopes.get(_correlation(ev))
            if scope is not None:
                cands.append(scope)
        yield cands, int(round(float(ev.get("dur", 0)) * 1e6))


def _device_intervals(trace):
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in _trace_events(trace) if e.get("cat") in DEVICE_CATS]


def device_busy_seconds(trace):
    """Busy device seconds of a trace: the UNION of its kernel, copy and
    memset intervals on every stream (two kernels that overlap, on two
    streams or in a graph's parallel branches, count once; their plain
    sum can exceed the wall time).  Like the JAX package's, it sees every
    program on the card during the window; :func:`scope_device_seconds`
    with a name does not."""
    total, end = 0.0, None
    for s, e in sorted(_device_intervals(trace)):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e6


def scope_device_seconds(trace, substring):
    """Total device seconds of the events any of whose name candidates
    (the kernel's name, its op range) contains ``substring``: a plain sum
    of their durations."""
    total_ps = 0
    for cands, dur in iter_trace_events(trace, device_only=True,
                                        exclude_async=True):
        if any(substring in c for c in cands):
            total_ps += dur
    return total_ps / 1e12


def measure_device_seconds(fn, scope=None):
    """Run ``fn()`` under a ``torch.profiler`` trace and return its DEVICE
    seconds: the busy time (:func:`device_busy_seconds`), or with
    ``scope`` the events matching that substring
    (:func:`scope_device_seconds`).  The trace lives in a temporary
    directory for the call only."""
    import shutil
    import tempfile
    global _active
    if _active is not None:
        raise RuntimeError("measure_device_seconds: a profiler trace is "
                           "already running")
    td = tempfile.mkdtemp(prefix="pttrace_")
    try:
        start_profiler("All", td)
        try:
            fn()
        finally:
            path = stop_profiler(profile_path=td)
        if scope is not None:
            return scope_device_seconds(path, scope)
        return device_busy_seconds(path)
    finally:
        shutil.rmtree(td, ignore_errors=True)


def compiled_op_table(trace, sorted_key="total"):
    """Aggregate a trace into per-IR-op device time, by the op ranges
    (:func:`op_scope_name`) the kernels are charged to.  Returns
    ``(table_string, rows)``, ``rows`` ``[(op_type, events,
    total_seconds)]`` sorted descending (by ``calls`` or ``total``)."""
    agg = collections.Counter()
    calls = collections.Counter()
    for cands, dur in iter_trace_events(trace, device_only=True,
                                        exclude_async=True):
        for c in cands:
            parsed = parse_op_scope(c)
            if parsed is not None:
                agg[parsed[0]] += dur / 1e12
                calls[parsed[0]] += 1
                break
    rows = sorted(((t, calls[t], s) for t, s in agg.items()),
                  key=lambda r: r[1 if sorted_key == "calls" else 2],
                  reverse=True)
    lines = [f"{'Event':<28}{'Calls':>8}{'Total(ms)':>12}{'Ave(ms)':>12}"]
    for op_type, n, total in rows:
        lines.append(f"{op_type:<28}{n:>8}{total * 1e3:>12.3f}"
                     f"{total / max(n, 1) * 1e3:>12.3f}")
    return "\n".join(lines), rows


@contextlib.contextmanager
def compiled_profiler(trace_dir=None, sorted_key="total"):
    """Trace the body with the per-op ranges armed and print the per-IR-op
    device-time table on exit (the device-side counterpart of
    :func:`op_profiler`, which times the host's view of each op).  The
    executor runs the eager step while it is armed.  A temporary trace
    directory is made, and removed after, unless ``trace_dir`` is given
    (pass one to keep the trace)."""
    import shutil
    import tempfile
    global _op_ranges
    own = trace_dir is None
    d = trace_dir or tempfile.mkdtemp(prefix="ptprof_")
    _op_ranges = True
    start_profiler("All", d)
    try:
        yield d
    finally:
        _op_ranges = False
        path = stop_profiler(profile_path=d)
        try:
            table, _ = compiled_op_table(path, sorted_key)
            print(table)
        finally:
            if own:
                shutil.rmtree(d, ignore_errors=True)


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

