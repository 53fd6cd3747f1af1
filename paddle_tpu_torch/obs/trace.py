"""Span-based structured tracing: the "where did step N spend its time"
layer.

Dapper-style spans (trace id propagated across threads and process
boundaries, parent/child nesting via ``contextvars``) recorded into a
thread-safe bounded ring buffer, exported in the Chrome trace-event JSON
convention (``chrome://tracing`` / Perfetto / ``ui.perfetto.dev`` load
the dump directly) — the same convention ``profiler.iter_trace_events``
already parses on the XProf side.

Design constraints, in order:

1. **Near-zero cost when disabled.**  ``span(...)`` is one module-global
   read + one shared no-op object when tracing is off — no allocation,
   no contextvar traffic, no lock.  Hot loops (``Executor.run``, the
   datapipe pull path, the serving batcher) stay instrumented
   permanently.
2. **Bounded memory.**  Spans land in a ``deque(maxlen=ring)``; a
   week-long trainer holds the last N spans, which is exactly what the
   flight recorder wants on a crash.
3. **Cross-boundary context.**  A trace id set with
   :func:`trace_context` (serving does this per ``X-Request-Id``;
   ``MasterClient`` ships it in the RPC frame) tags every span recorded
   under it, including spans recorded on OTHER threads via
   :func:`record_span` — how a batched request's queue-wait, dispatch,
   and scatter stitch back into one timeline.

Enable with ``PADDLE_TPU_TRACE=1`` (default ring 4096 spans) or
``PADDLE_TPU_TRACE=<ring-size>``; ``0``/empty disables.  Programmatic:
:func:`enable` / :func:`disable`.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import os
import threading
import time
import collections

__all__ = ["span", "record_span", "enable", "disable", "enabled",
           "configure_from_env", "trace_context", "current_trace_id",
           "new_trace_id", "snapshot_spans", "snapshot_payload", "clear",
           "chrome_trace", "dump_chrome_trace", "set_process_name",
           "process_name", "epoch_unix", "DEFAULT_RING"]

DEFAULT_RING = 4096

# one steady clock for every span: ts/dur subtract against this epoch so
# nesting math (child inside parent interval) is exact within a process
_EPOCH = time.perf_counter()

# human-readable process role for merged fleet timelines ("router",
# "replica:r0", ...); None renders as "pid <pid>" in the Chrome export
_proc_name = None


def set_process_name(name):
    """Name this process's timeline row in merged fleet traces.  The
    first caller wins by default (a FleetReplica must not rename a
    process the operator already labelled); pass ``name=None`` to
    clear."""
    global _proc_name
    if name is None:
        _proc_name = None
    elif _proc_name is None:
        _proc_name = str(name)
    return _proc_name


def process_name():
    return _proc_name


def epoch_unix():
    """Wall-clock time (``time.time()``) of this process's trace epoch:
    ``epoch_unix() + span["ts"]`` is a span's absolute start time, the
    anchor cross-process assembly normalizes clock skew against."""
    return time.time() - (time.perf_counter() - _EPOCH)

_current_span = contextvars.ContextVar("paddle_tpu_span", default=None)
_ambient_trace = contextvars.ContextVar("paddle_tpu_trace_id",
                                        default=None)

_span_ids = itertools.count(1)
_trace_seq = itertools.count(1)
_lock = threading.Lock()
_ring = collections.deque(maxlen=DEFAULT_RING)
_enabled = False


def new_trace_id():
    """Process-unique trace id (pid-prefixed so ids from different
    processes of one job never collide in a merged timeline)."""
    return f"{os.getpid():x}-{next(_trace_seq):x}-{os.urandom(4).hex()}"


def current_trace_id():
    """Trace id of the innermost active span, else the ambient id set by
    :func:`trace_context`, else None."""
    sp = _current_span.get()
    if sp is not None:
        return sp.trace_id
    return _ambient_trace.get()


@contextlib.contextmanager
def trace_context(trace_id):
    """Bind an ambient trace id (e.g. an ``X-Request-Id``): spans opened
    inside — on this thread/context — join that trace."""
    token = _ambient_trace.set(trace_id)
    try:
        yield trace_id
    finally:
        _ambient_trace.reset(token)


class _NoopSpan:
    """Shared do-nothing span returned while tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("name", "attrs", "trace_id", "span_id", "parent_id",
                 "t0", "dur", "tid", "_token")

    def __init__(self, name, attrs):
        self.name = name
        self.attrs = attrs
        self.span_id = next(_span_ids)
        self.parent_id = None
        self.trace_id = None
        self.t0 = 0.0
        self.dur = 0.0
        self.tid = 0
        self._token = None

    def set(self, **attrs):
        """Attach/override attributes mid-span."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        parent = _current_span.get()
        if parent is not None:
            self.trace_id = parent.trace_id
            self.parent_id = parent.span_id
        else:
            self.trace_id = _ambient_trace.get() or new_trace_id()
        self._token = _current_span.set(self)
        self.tid = threading.get_ident()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.dur = time.perf_counter() - self.t0
        if self._token is not None:
            _current_span.reset(self._token)
        if exc_type is not None:
            # time under failure is still attributed — tagged, never
            # swallowed or misfiled (same contract as record_latency)
            self.attrs["error"] = True
            self.attrs.setdefault("error_type", exc_type.__name__)
        _ring.append(self)
        return False


def span(name, **attrs):
    """Open a span: ``with span("executor.dispatch", step=i): ...``.

    Returns a shared no-op object when tracing is disabled — the check
    is one global read, so this belongs in hot paths.  The yielded span
    supports ``.set(key=value)`` for attributes known only mid-body.
    """
    if not _enabled:
        return _NOOP
    return _Span(name, attrs)


def record_span(name, t0, dur, trace_id=None, parent_id=None, **attrs):
    """Record an already-measured interval (``t0`` from
    ``time.perf_counter()``): for cross-thread measurements like a
    request's queue wait, where enter/exit happen on different threads.
    No-op while disabled.

    With no explicit ``trace_id`` and no ambient context the span's
    trace id stays None (it still renders on its thread timeline) —
    minting a fresh id here would cost a syscall per sample on the
    datapipe pull path and correlate nothing."""
    if not _enabled:
        return None
    sp = _Span(name, attrs)
    sp.trace_id = trace_id or current_trace_id()
    sp.parent_id = parent_id
    sp.t0 = t0
    sp.dur = dur
    sp.tid = threading.get_ident()
    _ring.append(sp)
    return sp


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------

def enable(ring_size=None):
    """Turn tracing on; ``ring_size`` (spans kept) rebuilds the ring
    when it differs from the current bound."""
    global _enabled, _ring
    with _lock:
        if ring_size is not None and int(ring_size) != _ring.maxlen:
            _ring = collections.deque(_ring, maxlen=max(1, int(ring_size)))
        _enabled = True


def disable():
    global _enabled
    _enabled = False


def enabled():
    return _enabled


def clear():
    """Drop recorded spans (tests; ring bound and enabled flag kept)."""
    _ring.clear()


def configure_from_env(value=None):
    """Parse ``PADDLE_TPU_TRACE``: ``0``/empty/false = off, ``1``/true =
    on with the default ring, an integer > 1 = on with that ring size.
    A malformed value WARNS and disables — an observability knob must
    never veto ``import paddle_tpu`` (this runs at import)."""
    raw = (value if value is not None
           else os.environ.get("PADDLE_TPU_TRACE", "")).strip().lower()
    if raw in ("", "0", "false", "off", "no"):
        disable()
        return False
    if raw in ("1", "true", "on", "yes"):
        enable(DEFAULT_RING)
        return True
    try:
        size = int(raw)
    except ValueError:
        import warnings
        warnings.warn(
            f"PADDLE_TPU_TRACE={raw!r} is not 0, 1, or a ring size — "
            f"tracing stays disabled")
        disable()
        return False
    enable(size)
    return True


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def snapshot_spans():
    """Recorded spans, oldest first, as JSON-able dicts.  ``ts``/``dur``
    are seconds relative to the process trace epoch; every dict carries
    the recording process's ``pid`` (and ``proc`` role name) so span
    lists from several processes stay self-describing when merged."""
    spans = list(_ring)  # atomic under the GIL; appends during the copy
    # land in later snapshots
    pid = os.getpid()
    return [{"name": sp.name, "trace_id": sp.trace_id,
             "span_id": sp.span_id, "parent_id": sp.parent_id,
             "ts": sp.t0 - _EPOCH, "dur": sp.dur, "tid": sp.tid,
             "pid": pid, "proc": _proc_name,
             "attrs": dict(sp.attrs)} for sp in spans]


def snapshot_payload():
    """The ``/spans`` scrape body: this process's span ring plus the
    identity and clock anchors cross-process trace assembly needs —
    ``pid``/``process_name`` pick the timeline row, ``epoch_unix``
    converts span ``ts`` to absolute time, and ``now_unix`` (this
    process's wall clock at serialization) lets the scraper estimate
    clock skew against its own send/recv envelope."""
    return {"pid": os.getpid(), "process_name": _proc_name,
            "epoch_unix": epoch_unix(), "now_unix": time.time(),
            "spans": snapshot_spans()}


def chrome_trace(spans=None):
    """Chrome trace-event JSON object (Perfetto-loadable): complete
    ``ph: "X"`` events with microsecond ``ts``/``dur``, one ``tid`` row
    per recording thread, span attributes + ids under ``args``.

    Each span's OWN ``pid`` is honored (falling back to this process),
    and every distinct pid gets a ``process_name`` metadata event — so a
    merged fleet span list renders one labelled row group per process
    instead of interleaving every process into this one's."""
    if spans is None:
        spans = snapshot_spans()
    own_pid = os.getpid()
    events = []
    proc_names = {}  # pid -> process_name metadata value
    for sp in spans:
        args = dict(sp["attrs"])
        if sp["trace_id"] is not None:
            args["trace_id"] = sp["trace_id"]
        args["span_id"] = sp["span_id"]
        if sp["parent_id"] is not None:
            args["parent_id"] = sp["parent_id"]
        pid = sp.get("pid") or own_pid
        proc = sp.get("proc") or (_proc_name if pid == own_pid else None)
        if proc or pid not in proc_names:
            proc_names[pid] = proc or f"pid {pid}"
        events.append({"name": sp["name"], "ph": "X", "cat": "paddle_tpu",
                       "ts": sp["ts"] * 1e6, "dur": sp["dur"] * 1e6,
                       "pid": pid, "tid": sp["tid"], "args": args})
    meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": name}}
            for pid, name in sorted(proc_names.items())]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def dump_chrome_trace(path=None, spans=None):
    """Serialize :func:`chrome_trace` to ``path`` (atomic: tmp +
    rename), or return the JSON string when ``path`` is None."""
    body = json.dumps(chrome_trace(spans))
    if path is None:
        return body
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(body)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


configure_from_env()
