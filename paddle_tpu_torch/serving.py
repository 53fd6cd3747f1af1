"""Serving front of the port: Predictor, MicroBatcher, the HTTP
inference server and its client (the port of ``paddle_tpu.serving``).

- :class:`Predictor` — load-once, run-many handle over a saved
  inference model on a place (``cuda:0`` unless the caller passes
  ``CPUPlace()``), with row-bucketed batched dispatch (``run_many``) and
  a warmup over the declared feed shapes.
- :class:`MicroBatcher` — coalesces concurrent requests into one padded
  dispatch, with the 503/504 degradation contract (:class:`QueueFull`,
  :class:`DeadlineExceeded`, :class:`BatcherCrashed`).
- :class:`InferenceServer` / :func:`serve` — ``/healthz``, ``/readyz``,
  ``/meta``, ``/stats``, ``/metrics``, ``/trace``, ``/spans``,
  ``/predict`` (``/run``) and, for a generation bundle, the streamed or
  buffered ``/generate`` with resume, drain and migration.
- :class:`ServingClient` — a retrying client over one address, a list
  of them or the replicas a fleet master lists, with mid-stream resume
  of ``/generate``.

- ``_capi_create`` / ``_capi_feed_names`` / ``_capi_run`` — the bridge
  the C inference ABI (``native/capi.cpp``) calls through the CPython
  API; its predictor runs on ``cuda:0`` unless the C caller names a
  place (``native.load_capi``).
"""

from __future__ import annotations

import json
import logging
import sys
import threading
import time
from http.server import ThreadingHTTPServer

import numpy as np

from paddle_tpu_torch.obs import trace as _trace
from paddle_tpu_torch.obs.trace import (span as _span,
                                        record_span as _record_span)

logger = logging.getLogger(__name__)

__all__ = ["Predictor", "serve", "InferenceServer", "MicroBatcher",
           "DeadlineExceeded", "QueueFull", "BatcherCrashed",
           "ServingClient", "ServingError"]


class DeadlineExceeded(RuntimeError):
    """A request timed out waiting for the predictor (queue saturation)."""


class QueueFull(RuntimeError):
    """The batcher's bounded request queue is full (load shedding — the
    caller gets a retryable 503 instead of queueing unboundedly)."""


class BatcherCrashed(RuntimeError):
    """The batcher thread died on an unexpected exception.  Every
    pending request fails with this (a retryable 503 at the HTTP layer)
    instead of hanging until its client timeout; the batcher restarts
    itself within a bounded budget."""


class ServingError(RuntimeError):
    """Structured server-side error; ``retryable`` mirrors the reply."""

    def __init__(self, etype, message, retryable=False):
        super().__init__(f"{etype}: {message}")
        self.etype = etype
        self.retryable = retryable


class _TransientServingError(ConnectionError):
    """A retryable (503/504) reply, surfaced as a transport-class error
    so RetryPolicy's default ``retryable`` set covers it."""


class Predictor:
    """Load-once, run-many inference handle over a saved inference model
    (the ``paddle_gradient_machine`` analog) on ``place`` (default
    ``cuda:0``; raises when CUDA is absent and no ``CPUPlace()`` was
    given)."""

    def __init__(self, model_dir, place=None):
        from paddle_tpu_torch.executor import Executor
        from paddle_tpu_torch.io import load_inference_model
        from paddle_tpu_torch.place import default_place
        from paddle_tpu_torch.scope import Scope, scope_guard

        self._scope_guard = scope_guard
        self.place = place if place is not None else default_place()
        self._scope = Scope()
        self._lock = threading.Lock()  # Executor/scope are not re-entrant
        # None until a batched dispatch proves (True) or disproves
        # (False) that outputs track the row axis; False short-circuits
        # run_many straight to per-request dispatches
        self._row_scatter_ok = None
        with scope_guard(self._scope):
            self._exe = Executor(self.place)
            (self._program, self._feed_names,
             self._fetch_targets) = load_inference_model(
                model_dir, self._exe)
        self.device = self._exe.device

    @property
    def feed_names(self):
        return list(self._feed_names)

    @property
    def fetch_names(self):
        return [t.name if hasattr(t, "name") else str(t)
                for t in self._fetch_targets]

    def run(self, feed, timeout=None):
        """feed: dict name -> ndarray; returns list of ndarrays.

        ``timeout``: max seconds to wait for the (serialized) executor —
        a saturated predictor raises :class:`DeadlineExceeded` instead of
        queueing the caller indefinitely."""
        missing = [n for n in self._feed_names if n not in feed]
        if missing:
            raise ValueError(f"missing feeds: {missing}")
        if not self._lock.acquire(timeout=-1 if timeout is None
                                  else timeout):
            raise DeadlineExceeded(
                f"predictor busy for more than {timeout}s")
        try:
            # fires INSIDE the lock: a delay action models device time
            # serialized per predictor (the one-device-per-replica cost
            # model the fleet bench leans on); an error action models a
            # dispatch failure
            from paddle_tpu_torch.fault import chaos as _chaos
            _chaos.fire("serving.predict", feeds=len(feed))
            with self._scope_guard(self._scope):
                outs = self._exe.run(self._program, feed=dict(feed),
                                     fetch_list=self._fetch_targets)
        finally:
            self._lock.release()
        return [np.asarray(o) for o in outs]

    def run_many(self, feeds_list, timeout=None):
        """Run several per-request feed dicts as ONE padded, row-bucketed
        dispatch (the micro-batching hot path).

        All requests must be batch-compatible — same feed names, dtypes
        and trailing dims, with a shared leading (row) axis; see
        :func:`batch_key`.  Rows are concatenated, zero-padded up to a
        ``lod.row_bucket`` edge (so the jit-cache key is the bucket, not
        the exact total), dispatched once, and the outputs are scattered
        back by row ranges.  Outputs whose leading dim does not track the
        row axis (e.g. a batch-reduced scalar) cannot be scattered: the
        batch falls back to per-request runs (counted as
        ``serving.batch_fallbacks``).  Returns a list of per-request
        output lists."""
        from paddle_tpu_torch import profiler as _profiler
        from paddle_tpu_torch.lod import row_bucket

        if self._row_scatter_ok is False:
            # this model's outputs were seen not to track the row axis:
            # skip the (wasted) batched attempt entirely
            return [self.run(f, timeout=timeout) for f in feeds_list]
        if len(feeds_list) == 1:
            key, _ = batch_key(feeds_list[0])
            if key is None:
                return [self.run(feeds_list[0], timeout=timeout)]
        rows = []
        for f in feeds_list:
            _, r = batch_key(f)
            if r is None:
                raise ValueError("run_many got a non-batchable request in "
                                 "a batch of size > 1")
            rows.append(r)
        total = sum(rows)
        bucket = row_bucket(total)
        names = sorted(feeds_list[0])
        feed = {}
        for name in names:
            parts = [np.asarray(f[name]) for f in feeds_list]
            cat = parts[0] if len(parts) == 1 else np.concatenate(parts, 0)
            if bucket > total:
                pad = np.zeros((bucket - total,) + cat.shape[1:], cat.dtype)
                cat = np.concatenate([cat, pad], 0)
            feed[name] = cat
        outs = self.run(feed, timeout=timeout)
        if any(o.ndim == 0 or o.shape[0] != bucket for o in outs):
            # row-misaligned outputs: correctness beats throughput —
            # and remember, so later batches skip the wasted attempt
            self._row_scatter_ok = False
            logger.warning(
                "model outputs do not track the batch row axis; "
                "micro-batching disabled for this predictor (requests "
                "dispatch individually)")
            _profiler.runtime_metrics.inc("serving.batch_fallbacks")
            return [self.run(f, timeout=timeout) for f in feeds_list]
        self._row_scatter_ok = True
        results, off = [], 0
        for r in rows:
            results.append([o[off:off + r] for o in outs])
            off += r
        return results

    def warmup(self, batch_sizes=(1,), bucket=True):
        """Run the model once for each batch size before traffic arrives
        (`Executor.warmup` over the DECLARED feed shapes of the loaded
        inference program), building every kernel it reaches.
        ``bucket=True`` rounds sizes through ``lod.row_bucket`` — the
        shapes BATCHED dispatches actually see;
        pass ``bucket=False`` on the serialized path, where requests run
        unpadded and only exact sizes match.  Feeds whose trailing dims
        are dynamic or that carry LoD cannot be synthesized — warmup
        then skips (logged + ``warmup.skipped`` counter) and returns 0.
        Returns the :class:`~paddle_tpu_torch.obs.perf.WarmupReport`."""
        from paddle_tpu_torch import io as _io
        from paddle_tpu_torch.lod import row_bucket

        from paddle_tpu_torch import profiler as _profiler
        specs = _io.infer_feed_specs(self._program, self._feed_names)
        shapes = {}
        for name, spec in specs.items():
            shape = spec["shape"]
            if shape is None or spec["lod_level"] or len(shape) == 0 or \
                    any(d is None for d in shape[1:]):
                # can't synthesize this feed — say so loudly: /readyz
                # will flip with nothing warmed, and the first real
                # request pays the kernel builds warmup exists to avoid
                logger.warning(
                    "warmup skipped: feed %r has dynamic non-batch dims "
                    "or LoD (%r) — no signature can be synthesized",
                    name, shape)
                _profiler.runtime_metrics.inc("warmup.skipped")
                return 0
            shapes[name] = shape
        sigs, seen = [], set()
        sizes = {row_bucket(b) if bucket else max(int(b), 1)
                 for b in batch_sizes}
        for b in sorted(sizes):
            sig = {name: tuple(shape) if shape[0] is not None
                   else (b,) + tuple(shape[1:])
                   for name, shape in shapes.items()}
            frozen = tuple(sorted((n, s) for n, s in sig.items()))
            if frozen not in seen:
                seen.add(frozen)
                sigs.append(sig)
        with self._lock:
            with self._scope_guard(self._scope):
                return self._exe.warmup(self._program, sigs,
                                        fetch_list=self._fetch_targets,
                                        scope=self._scope)


def batch_key(feed):
    """(compatibility key, rows) for a request feed — requests sharing a
    key can ride one padded dispatch (same feed names/dtypes/trailing
    dims form one stable jit-cache bucket).  ``(None, None)`` marks a
    non-batchable request: a rank-0 feed, or feeds that disagree on the
    leading (row) dim."""
    rows = None
    parts = []
    for name in sorted(feed):
        a = np.asarray(feed[name])
        if a.ndim == 0:
            return None, None
        if rows is None:
            rows = int(a.shape[0])
        elif int(a.shape[0]) != rows:
            return None, None
        parts.append((name, str(a.dtype), tuple(a.shape[1:])))
    if rows is None or rows == 0:
        return None, None
    return tuple(parts), rows


class _Pending:
    """One enqueued request awaiting its batch slot."""

    __slots__ = ("feed", "key", "rows", "event", "result", "error",
                 "abandoned", "enqueue_t", "trace_id")

    def __init__(self, feed, key, rows):
        self.feed = feed
        self.key = key
        self.rows = rows
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.abandoned = False
        # queue-wait measurement + cross-thread trace stitching: the
        # batcher thread records this request's spans under the trace id
        # the submitting handler was serving (the X-Request-Id)
        self.enqueue_t = time.perf_counter()
        self.trace_id = _trace.current_trace_id()


class MicroBatcher:
    """Dynamic request micro-batching over a :class:`Predictor`.

    Concurrent ``submit`` calls land in a bounded queue; a single batcher
    thread coalesces batch-compatible requests — up to ``max_batch_size``
    requests / ``max_batch_rows`` total rows, waiting at most
    ``max_batch_delay`` seconds after the first — into ONE padded
    dispatch through ``Predictor.run_many``, and scatters per-request
    outputs back.  Mixed-shape requests (different trailing dims or feed
    sets) never share a batch: each compatibility key is its own bucket.

    Degradation semantics mirror the serialized path: a full queue raises
    :class:`QueueFull` (503 load shedding), a request whose result does
    not arrive within its timeout raises :class:`DeadlineExceeded` (504)
    and its queue slot is abandoned.

    An UNEXPECTED exception escaping the batcher thread (a bug, not a
    per-batch dispatch failure — those already route to their batch)
    must not leave queued requests hanging until client timeout: every
    pending request fails immediately with :class:`BatcherCrashed`
    (503, retryable) and the thread restarts, up to ``max_restarts``
    times (``serving.batcher_restarts`` counts them); past the budget
    the batcher is dead and ``submit`` fails fast."""

    def __init__(self, predictor, max_batch_size=8, max_batch_delay=0.005,
                 queue_size=128, max_batch_rows=None, max_restarts=5):
        from paddle_tpu_torch.lod import row_bucket
        self._predictor = predictor
        self.max_batch_size = max(1, int(max_batch_size))
        self.max_batch_delay = max(0.0, float(max_batch_delay))
        self.queue_size = max(1, int(queue_size))
        self.max_batch_rows = int(max_batch_rows) if max_batch_rows \
            else max(row_bucket(self.max_batch_size), self.max_batch_size)
        self.max_restarts = max(0, int(max_restarts))
        self._queue = []
        self._cv = threading.Condition()
        self._closed = False
        self._restarts = 0
        self._failed = None       # terminal crash after restart budget
        self._assembling = None   # batch popped but not yet dispatched
        self._thread = self._spawn_thread()

    def _spawn_thread(self):
        t = threading.Thread(target=self._run, daemon=True,
                             name="paddle-tpu-batcher")
        t.start()
        return t

    def _run(self):
        try:
            self._loop()
        except BaseException as e:   # batcher bug: recover, don't hang
            self._crash(e)

    def _crash(self, exc):
        from paddle_tpu_torch import profiler as _profiler
        logger.exception("batcher thread crashed")
        with self._cv:
            pending, self._queue = self._queue, []
            assembling, self._assembling = self._assembling, None
            restart = not self._closed and \
                self._restarts < self.max_restarts
            if restart:
                self._restarts += 1
            elif not self._closed:
                self._failed = exc
        # record the restart BEFORE waking any waiter: "submit raised
        # BatcherCrashed" must imply "restart already observable" (the
        # counter and the live thread), or observers race the dying
        # thread's tail
        if restart:
            _profiler.runtime_metrics.inc("serving.batcher_restarts")
            self._thread = self._spawn_thread()
        err = BatcherCrashed(
            f"batcher thread crashed ({type(exc).__name__}: {exc}); "
            f"request aborted — retry")
        err.__cause__ = exc
        for p in (assembling or []) + pending:
            if not p.abandoned:
                p.error = err
                p.event.set()

    @property
    def queue_depth(self):
        with self._cv:
            return len(self._queue)

    @property
    def failed(self):
        """Terminal crash exception once the restart budget is spent
        (None while the batcher is alive) — the signal /readyz uses to
        pull a permanently-503 replica out of rotation."""
        with self._cv:
            return self._failed

    def submit(self, feed, timeout=None):
        """Enqueue one request feed and block for its outputs."""
        from paddle_tpu_torch import profiler as _profiler
        missing = [n for n in self._predictor.feed_names if n not in feed]
        if missing:
            raise ValueError(f"missing feeds: {missing}")
        key, rows = batch_key(feed)
        p = _Pending(feed, key, rows)
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is shut down")
            if self._failed is not None:
                # restart budget exhausted: fail fast (still a 503 so a
                # load balancer retries a healthy replica)
                raise BatcherCrashed(
                    f"batcher is down after {self._restarts} restarts: "
                    f"{self._failed}")
            if len(self._queue) >= self.queue_size:
                _profiler.runtime_metrics.inc("serving.queue_rejections")
                raise QueueFull(
                    f"batch queue full ({self.queue_size} pending)")
            self._queue.append(p)
            self._cv.notify_all()
        if not p.event.wait(timeout):
            with self._cv:
                p.abandoned = True
                # free the queue slot NOW: a dead entry left in place
                # would count toward queue_size and shed live traffic
                try:
                    self._queue.remove(p)
                except ValueError:
                    pass  # already taken into a batch
            _profiler.runtime_metrics.inc("serving.deadline_exceeded")
            raise DeadlineExceeded(
                f"request waited more than {timeout}s for its batch")
        if p.error is not None:
            raise p.error
        return p.result

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=5)

    # -- batcher thread ------------------------------------------------
    def _take_compatible(self, batch, key, rows_budget):
        """Move queued requests compatible with ``key`` into ``batch``
        (holding the lock); returns the remaining row budget."""
        i = 0
        while i < len(self._queue):
            if len(batch) >= self.max_batch_size or rows_budget <= 0 or \
                    key is None:
                break
            p = self._queue[i]
            if p.abandoned:
                self._queue.pop(i)
                continue
            if p.key == key and p.rows <= rows_budget:
                self._queue.pop(i)
                batch.append(p)
                rows_budget -= p.rows
                continue
            i += 1
        return rows_budget

    def _loop(self):
        from paddle_tpu_torch.fault import chaos
        while True:
            batch = []
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait(0.05)
                if not self._queue:
                    if self._closed:
                        return
                    continue
                first = self._queue.pop(0)
                if first.abandoned:
                    continue
                # visible to _crash: a thread death between pop and
                # scatter must fail THESE requests too, not strand them
                self._assembling = batch
                assembly_t0 = time.perf_counter()
                batch.append(first)
                budget = self.max_batch_rows - (first.rows or 0)
                # linger up to max_batch_delay for co-batchable arrivals
                deadline = time.monotonic() + self.max_batch_delay
                while first.key is not None and \
                        len(batch) < self.max_batch_size and budget > 0:
                    budget = self._take_compatible(batch, first.key, budget)
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or \
                            len(batch) >= self.max_batch_size or budget <= 0:
                        break
                    self._cv.wait(remaining)
            # OUTSIDE _dispatch's per-batch try: an armed failpoint here
            # models a bug in the batcher thread itself (the per-batch
            # dispatch path already routes ITS failures to the batch)
            chaos.fire("serving.batcher.crash", size=len(batch))
            self._dispatch(batch, assembly_t0)
            with self._cv:
                self._assembling = None
                # a completed assemble->dispatch cycle is forward
                # progress: refill the restart budget (mirroring the
                # sentinel's max_rollbacks refill) so rare-but-recovered
                # crashes spread over a long uptime never accumulate
                # into a terminal outage — the budget bounds CONSECUTIVE
                # crashes, not lifetime ones
                self._restarts = 0

    def _dispatch(self, batch, assembly_t0=None):
        from paddle_tpu_torch import profiler as _profiler
        from paddle_tpu_torch.fault import chaos
        now = time.perf_counter()
        lead = batch[0].trace_id
        for p in batch:
            # queue wait measured per request, stitched to ITS trace id
            _record_span("serving.queue_wait", p.enqueue_t,
                         now - p.enqueue_t, trace_id=p.trace_id)
        if assembly_t0 is not None:
            _record_span("serving.batch_assembly", assembly_t0,
                         now - assembly_t0, trace_id=lead,
                         size=len(batch))
        try:
            chaos.fire("serving.batch", size=len(batch))
            _profiler.runtime_metrics.bucket("serving.batch_occupancy",
                                             len(batch))
            _profiler.runtime_metrics.inc("serving.batches")
            with _trace.trace_context(lead):
                with _span("serving.dispatch", size=len(batch)):
                    results = self._predictor.run_many(
                        [p.feed for p in batch])
        except BaseException as e:
            for p in batch:
                p.error = e
                p.event.set()
            return
        with _trace.trace_context(lead):
            with _span("serving.scatter", size=len(batch)):
                for p, r in zip(batch, results):
                    p.result = r
                    p.event.set()


# ---------------------------------------------------------------------------
# C-ABI bridge (called from native/capi.cpp through the CPython API)
# ---------------------------------------------------------------------------

def _capi_create(model_dir, place=None):
    """A :class:`Predictor` over ``model_dir`` on ``place``, a place
    string as the CLI's ``--place`` takes it (``cpu``, ``cuda[:N]``);
    None: ``cuda:0``."""
    from paddle_tpu_torch.cli import _place
    return Predictor(model_dir, place=None if place is None
                     else _place(place))


def _capi_feed_names(predictor):
    return predictor.feed_names


def _capi_run(predictor, names, buffers, shapes, dtypes):
    """names: list[str]; buffers: list[memoryview of raw bytes];
    shapes: list[tuple]; dtypes: list[str].  Returns ``(list[bytes],
    list[tuple[int]], list[str])``, one entry a fetch."""
    feed = {}
    for name, buf, shape, dtype in zip(names, buffers, shapes, dtypes):
        feed[name] = np.frombuffer(buf, dtype=dtype).reshape(shape).copy()
    outs = [np.asarray(o) for o in predictor.run(feed)]
    payloads = [np.ascontiguousarray(o).tobytes() for o in outs]
    out_shapes = [tuple(int(d) for d in o.shape) for o in outs]
    out_dtypes = [str(o.dtype) for o in outs]
    return payloads, out_shapes, out_dtypes


# ---------------------------------------------------------------------------
# HTTP inference server (the serving-runtime gap in L6; JSON in/out)
# ---------------------------------------------------------------------------

class _HTTPServer(ThreadingHTTPServer):
    """The threaded server, quiet about clients that hang up: a reset or
    a broken pipe on a connection its client closed (a streaming client
    closes with the terminal chunk unread) is not a server error."""

    def handle_error(self, request, client_address):
        if isinstance(sys.exc_info()[1],
                      (ConnectionResetError, BrokenPipeError)):
            return
        super().handle_error(request, client_address)


class InferenceServer:
    """HTTP inference server with graceful degradation.

    - ``/healthz`` (and legacy ``/health``): liveness — 200 while the
      process serves, even before the model loads.
    - ``/readyz``: readiness — 200 only once the model is loaded; 503
      with ``retryable: true`` while loading, 500 with ``retryable:
      false`` if the load failed.
    - ``/predict`` (and alias ``/run``): 503 + ``retryable: true``
      before the model is ready or when all ``max_inflight`` slots are
      taken (load shedding), 504 + ``retryable: true`` when a request
      waits longer than ``request_timeout`` on the predictor, 400/500
      structured errors otherwise.  Every error body is
      ``{"error": {"type", "message"}, "retryable": bool}``.

    ``async_load=True`` starts serving immediately and loads the model
    in the background (k8s-style: readiness gates traffic, liveness
    doesn't kill the pod during a long restore).

    ``batching=True`` coalesces concurrent ``/predict`` requests into
    padded, row-bucketed micro-batches through a :class:`MicroBatcher`
    (one dispatch per batch instead of one per request); the
    per-request 503/504 degradation semantics are preserved.
    ``warmup=True`` runs the declared serving buckets once during load,
    BEFORE ``/readyz`` flips, building and loading every kernel they
    reach — the first real request never waits on ``nvcc``.  ``/stats``
    serves the runtime metrics snapshot (``profiler.runtime_metrics``)
    plus server/batcher state, the warmup report per bucket and the
    process's kernel builds (``kernels.build.counts``).

    A GENERATION bundle (``gen_meta.json`` + prefill/decode programs,
    see ``paddle_tpu_torch/gen/``) is served through ``/generate``
    instead of ``/predict``: continuous-batching autoregressive decode
    with streamed (chunked) token responses over the same keep-alive
    connection.  ``warmup=True`` then runs BOTH signature families
    (every prefill bucket + the decode step at every page bucket) before
    ``/readyz`` flips.  ``gen_admission``/``gen_queue_size``/
    ``gen_prefill_budget`` configure the
    :class:`paddle_tpu_torch.gen.GenScheduler` (the budget caps the
    static prefill FLOPs admitted between two decode iterations).

    ``place``: where the model runs (default ``cuda:0``); without CUDA
    and without ``CPUPlace()`` the constructor raises.
    """

    def __init__(self, model_dir, host="127.0.0.1", port=0,
                 async_load=False, max_inflight=32, request_timeout=None,
                 batching=False, max_batch_size=8, max_batch_delay=0.005,
                 batch_queue_size=128, warmup=False,
                 warmup_batch_sizes=None, gen_admission="continuous",
                 gen_queue_size=64, gen_prefill_budget=None, place=None):
        from http.server import BaseHTTPRequestHandler

        from paddle_tpu_torch.fault import chaos
        from paddle_tpu_torch import profiler as _profiler
        from paddle_tpu_torch.kernels import build as _build
        from paddle_tpu_torch.lod import bucket_edges
        from paddle_tpu_torch.place import default_place

        # resolve the device NOW: a server without CUDA and without a
        # CPU place must fail at construction, not in its loader thread
        self.place = place if place is not None else default_place()
        self.place.torch_device()
        self.predictor = None
        self._gen = None          # GenScheduler for generation bundles
        self.gen_predictor = None
        # master-backed fleet membership (set by fleet.FleetReplica):
        # None = not fleet-managed, "held" = lease current, "lost" = the
        # master expired our lease while this process is alive — /readyz
        # then reports 503 lease_lost so the LB and the router agree
        self.lease_state = None
        self._gen_conf = {"admission": str(gen_admission),
                          "queue_size": int(gen_queue_size),
                          "prefill_budget": gen_prefill_budget}
        self._ready = threading.Event()
        self._load_done = threading.Event()  # set on success OR failure
        self._load_error = None
        self._slots = threading.BoundedSemaphore(max_inflight)
        self._request_timeout = request_timeout
        self._batcher = None
        self._batch_conf = {"batching": bool(batching),
                            "max_batch_size": int(max_batch_size),
                            "max_batch_delay": float(max_batch_delay),
                            "batch_queue_size": int(batch_queue_size)}
        if warmup_batch_sizes is None and warmup:
            # cover every bucket a batch of 1..max rows can pad into, so
            # no steady-state batched dispatch meets a new shape after /readyz
            warmup_batch_sizes = bucket_edges(
                1, max(int(max_batch_size), 1)) if batching else (1,)
        self._warmup_batch_sizes = tuple(warmup_batch_sizes or ())
        self._do_warmup = bool(warmup)
        # per-bucket warmup report (seconds + cold/persistent-hit/warm
        # kernel-build provenance), surfaced in /stats
        self._warmup_report = None
        server = self

        def _load():
            try:
                chaos.fire("serving.load", model_dir=model_dir)
                from paddle_tpu_torch.gen import is_gen_bundle
                if is_gen_bundle(model_dir):
                    from paddle_tpu_torch.gen import (GenPredictor,
                                                      GenScheduler)
                    gen_predictor = GenPredictor(model_dir,
                                                 place=server.place)
                    if server._do_warmup:
                        chaos.fire("serving.warmup", model_dir=model_dir)
                        # both signature families — every prefill
                        # bucket AND the decode step — build their
                        # kernels before /readyz flips
                        rep = gen_predictor.warmup()
                        server._warmup_report = getattr(
                            rep, "buckets", None)
                    server.gen_predictor = gen_predictor
                    server._gen = GenScheduler(
                        gen_predictor,
                        queue_size=server._gen_conf["queue_size"],
                        admission=server._gen_conf["admission"],
                        prefill_budget=server._gen_conf[
                            "prefill_budget"])
                    server._ready.set()
                    return
                predictor = Predictor(model_dir, place=server.place)
                if server._do_warmup:
                    chaos.fire("serving.warmup", model_dir=model_dir)
                    # batched dispatches see row-bucketed (padded)
                    # shapes; serialized ones see exact request shapes
                    rep = predictor.warmup(
                        server._warmup_batch_sizes or (1,),
                        bucket=server._batch_conf["batching"])
                    server._warmup_report = getattr(rep, "buckets", None)
                if server._batch_conf["batching"]:
                    server._batcher = MicroBatcher(
                        predictor,
                        max_batch_size=server._batch_conf["max_batch_size"],
                        max_batch_delay=server._batch_conf
                        ["max_batch_delay"],
                        queue_size=server._batch_conf["batch_queue_size"])
                server.predictor = predictor
                server._ready.set()
            except BaseException as e:
                server._load_error = e
            finally:
                server._load_done.set()

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1 keep-alive: every reply carries Content-Length, so
            # closed-loop clients reuse one connection (and one server
            # thread) instead of paying connect/teardown per request
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _reply_raw(self, code, body, content_type):
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                rid = getattr(self, "_request_id", None)
                if rid:
                    # echo the (accepted or generated) request id so the
                    # caller can correlate logs/traces across the hop
                    self.send_header("X-Request-Id", rid)
                self.end_headers()
                self.wfile.write(body)

            def _reply(self, code, obj):
                self._reply_raw(code, json.dumps(obj).encode(),
                                "application/json")

            def _error(self, code, etype, message, retryable):
                self._reply(code, {"error": {"type": etype,
                                             "message": message},
                                   "retryable": retryable})

            def _gate_ready(self):
                """404/503/500 preludes; returns the predictor or None
                (reply already sent)."""
                if server._load_error is not None:
                    self._error(500, "model_load_failed",
                                str(server._load_error), retryable=False)
                    return None
                if not server._ready.is_set():
                    self._error(503, "model_loading",
                                "model is still loading; retry later",
                                retryable=True)
                    return None
                return server.predictor

            def do_GET(self):
                # per-REQUEST id: a keep-alive connection reuses this
                # handler instance, so a stale id from an earlier POST
                # must not leak onto this reply (echo the caller's own
                # header when present, else no header)
                self._request_id = (self.headers.get("X-Request-Id")
                                    or "").strip() or None
                if self.path in ("/health", "/healthz"):
                    self._reply(200, {"status": "ok"})
                elif self.path == "/readyz":
                    batcher = server._batcher
                    gen = server._gen
                    if server._load_error is not None:
                        self._error(500, "model_load_failed",
                                    str(server._load_error),
                                    retryable=False)
                    elif gen is not None and gen.failed is not None:
                        # terminal scheduler death: every /generate
                        # would 503 forever — pull this replica
                        self._error(500, "scheduler_down",
                                    f"generation scheduler is down: "
                                    f"{gen.failed}", retryable=False)
                    elif batcher is not None and \
                            batcher.failed is not None:
                        # terminal batcher death: every /predict would
                        # 503 forever — stop reporting ready so the
                        # load balancer pulls this replica
                        self._error(500, "batcher_down",
                                    f"batcher is down: {batcher.failed}",
                                    retryable=False)
                    elif server.lease_state == "lost":
                        # alive and loaded, but the master expired our
                        # lease: the router already dropped us, so stop
                        # reporting ready (retryable — re-registration
                        # restores the lease without a process restart)
                        self._error(503, "lease_lost",
                                    "fleet lease expired; replica is "
                                    "out of the routing table",
                                    retryable=True)
                    elif server._ready.is_set():
                        self._reply(200, {"status": "ready"})
                    else:
                        self._error(503, "model_loading",
                                    "model is still loading",
                                    retryable=True)
                elif self.path == "/meta":
                    if server._gen is not None:
                        self._reply(200, {"generate": True,
                                          **server.gen_predictor.meta})
                        return
                    predictor = self._gate_ready()
                    if predictor is not None:
                        self._reply(200,
                                    {"feeds": predictor.feed_names,
                                     "fetches": predictor.fetch_names})
                elif self.path == "/stats":
                    snap = _profiler.runtime_metrics.snapshot()
                    batcher = server._batcher
                    snap["server"] = dict(
                        server._batch_conf,
                        ready=server._ready.is_set(),
                        request_timeout=server._request_timeout,
                        queue_depth=batcher.queue_depth if batcher else 0,
                        warmup_batch_sizes=list(
                            server._warmup_batch_sizes),
                        warmup=server._warmup_report,
                        kernel_builds=dict(_build.counts))
                    gen = server._gen
                    if gen is not None:
                        snap["server"]["gen"] = {
                            "admission": gen.admission,
                            "queue_size": gen.queue_size,
                            "queue_depth": gen.queue_depth,
                            "active_slots": gen.active_slots,
                            "num_slots": gen.predictor.num_slots,
                            "max_len": gen.predictor.max_len,
                        }
                    self._reply(200, snap)
                elif self.path == "/metrics":
                    from paddle_tpu_torch.obs import prom as _prom
                    self._reply_raw(
                        200, _prom.render_prometheus().encode(),
                        _prom.CONTENT_TYPE)
                elif self.path == "/trace":
                    # Chrome trace-event JSON of the span ring: load the
                    # body straight into Perfetto/chrome://tracing
                    self._reply_raw(200,
                                    _trace.dump_chrome_trace().encode(),
                                    "application/json")
                elif self.path == "/spans":
                    # raw span ring + pid/process-name/clock anchors:
                    # the scrape body fleet-level trace assembly merges
                    # (obs.aggregate.assemble_fleet_trace)
                    self._reply(200, _trace.snapshot_payload())
                else:
                    self._error(404, "not_found", self.path,
                                retryable=False)

            def do_POST(self):
                # accept the caller's X-Request-Id (generate one when
                # absent): every reply echoes it, every span of this
                # request is tagged with it — the Dapper trace-context
                # hop across the HTTP boundary
                self._request_id = (self.headers.get("X-Request-Id")
                                    or "").strip() or _trace.new_trace_id()
                # drain the body FIRST: replying on an early-error path
                # with unread body bytes would desync a keep-alive
                # connection (the next request would parse mid-body)
                if "Content-Length" not in self.headers:
                    # no declared length (absent or chunked body): the
                    # body can't be drained, so the connection can't be
                    # reused — close it after this reply
                    self.close_connection = True
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    raw = self.rfile.read(n)
                except ValueError:
                    # unreadable length: same problem, same remedy
                    self.close_connection = True
                    self._error(400, "bad_request",
                                "invalid Content-Length header",
                                retryable=False)
                    return
                if self.path == "/generate":
                    self._handle_generate(raw)
                    return
                if self.path not in ("/predict", "/run"):
                    self._error(404, "not_found", self.path,
                                retryable=False)
                    return
                if server._gen is not None:
                    self._error(404, "not_found",
                                "generation bundle: POST /generate "
                                "instead of /predict", retryable=False)
                    return
                predictor = self._gate_ready()
                if predictor is None:
                    return
                # end-to-end deadline propagation: the caller's (or the
                # router's) remaining budget arrives as X-Deadline-Ms and
                # tightens the server-side timeout, so a retried request
                # can never spend more than the original caller allowed
                from paddle_tpu_torch.fault.retry import parse_deadline_ms
                timeout = server._request_timeout
                try:
                    budget = parse_deadline_ms(
                        self.headers.get("X-Deadline-Ms"))
                except ValueError:
                    self._error(400, "bad_request",
                                f"invalid X-Deadline-Ms header: "
                                f"{self.headers.get('X-Deadline-Ms')!r}",
                                retryable=False)
                    return
                if budget is not None:
                    if budget <= 0:
                        _profiler.runtime_metrics.inc(
                            "serving.deadline_exceeded")
                        self._error(504, "deadline_exceeded",
                                    "caller deadline already expired",
                                    retryable=True)
                        return
                    timeout = budget if timeout is None \
                        else min(timeout, budget)
                if not server._slots.acquire(blocking=False):
                    # saturated: shed load instead of queueing unboundedly
                    self._error(503, "overloaded",
                                "all inference slots busy", retryable=True)
                    return
                t0 = time.perf_counter()
                try:
                    with _trace.trace_context(self._request_id), \
                            _span("serving.request",
                                  request_id=self._request_id,
                                  path=self.path,
                                  port=server.addr[1]):
                        chaos.fire("serving.run", path=self.path)
                        req = json.loads(raw)
                        feed = {k: np.asarray(v, dtype="float32")
                                if not isinstance(v, dict)
                                else np.asarray(v["data"],
                                                dtype=v.get("dtype",
                                                            "float32"))
                                for k, v in req["feeds"].items()}
                        if server._batcher is not None:
                            outs = server._batcher.submit(
                                feed, timeout=timeout)
                        else:
                            with _span("serving.dispatch", size=1):
                                outs = predictor.run(
                                    feed, timeout=timeout)
                        _profiler.runtime_metrics.inc(
                            "serving.requests_ok")
                    self._reply(200, {"outputs": [o.tolist() for o in outs],
                                      "shapes": [list(o.shape)
                                                 for o in outs],
                                      "dtypes": [str(o.dtype)
                                                 for o in outs]})
                except QueueFull as e:
                    self._error(503, "overloaded", str(e), retryable=True)
                except BatcherCrashed as e:
                    # the batcher died under this request and restarted:
                    # retryable by contract, same as load shedding
                    self._error(503, "batcher_restarted", str(e),
                                retryable=True)
                except DeadlineExceeded as e:
                    self._error(504, "deadline_exceeded", str(e),
                                retryable=True)
                except (ValueError, KeyError, TypeError) as e:
                    self._error(400, "bad_request", str(e), retryable=False)
                except Exception as e:
                    self._error(500, "internal", str(e), retryable=False)
                finally:
                    server._slots.release()
                    _profiler.runtime_metrics.observe(
                        "serving.request_seconds",
                        time.perf_counter() - t0)

            # -- continuous-batching generation (/generate) ------------
            def _write_chunk(self, obj):
                """One chunked-transfer ndjson line.  The
                ``gen.client.disconnect`` failpoint fires per chunk —
                an armed ``error`` simulates the client dropping
                mid-stream exactly at a write boundary (the slot-
                reclamation drill)."""
                chaos.fire("gen.client.disconnect")
                data = (json.dumps(obj) + "\n").encode()
                self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
                self.wfile.flush()

            def _handle_generate(self, raw):
                from paddle_tpu_torch.fault.retry import parse_deadline_ms
                # load gates FIRST: while the loader runs we cannot yet
                # know whether this model even has a /generate, and a
                # retryable 503 keeps the router failing over instead
                # of a permanent 404 for a replica that is milliseconds
                # from ready
                if server._load_error is not None:
                    self._error(500, "model_load_failed",
                                str(server._load_error), retryable=False)
                    return
                if not server._ready.is_set():
                    self._error(503, "model_loading",
                                "model is still loading; retry later",
                                retryable=True)
                    return
                gen = server._gen
                if gen is None:
                    self._error(404, "not_found",
                                "this model has no /generate (one-shot "
                                "inference model: POST /predict)",
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
                timeout = server._request_timeout
                if budget is not None:
                    if budget <= 0:
                        # already expired on arrival: the immediate-504
                        # MicroBatcher contract at the generation edge
                        _profiler.runtime_metrics.inc("gen.expired")
                        self._error(504, "deadline_exceeded",
                                    "caller deadline already expired",
                                    retryable=True)
                        return
                    timeout = budget if timeout is None \
                        else min(timeout, budget)
                try:
                    req = json.loads(raw)
                    prompt = req["prompt"]
                    max_new = int(req.get("max_new_tokens", 16))
                    eos_id = req.get("eos_id")
                    do_stream = bool(req.get("stream", True))
                    # resumable sessions: resume_from=k means the
                    # prompt already carries the original prompt plus
                    # the k tokens the client holds — event indices
                    # continue at k, so the splice stays monotone and
                    # duplicate-free across replicas
                    resume_from = int(req.get("resume_from", 0) or 0)
                    if resume_from < 0:
                        raise ValueError(
                            f"resume_from must be >= 0, "
                            f"got {resume_from}")
                except (ValueError, KeyError, TypeError) as e:
                    self._error(400, "bad_request", str(e),
                                retryable=False)
                    return
                if resume_from > 0:
                    predictor = server.gen_predictor
                    eff_eos = predictor.eos_id if eos_id is None \
                        else int(eos_id)
                    try:
                        tail_tok = int(prompt[-1]) if prompt else None
                    except (TypeError, ValueError):
                        tail_tok = None
                    if tail_tok is not None and tail_tok == eff_eos:
                        # the owner died AFTER emitting EOS but before
                        # the done tail: nothing left to decode — a
                        # re-prefill here would invent tokens past EOS,
                        # so synthesize the terminal tail instead
                        self._finish_resumed_eos(do_stream, resume_from)
                        return
                    if hasattr(predictor, "can_resume") and \
                            not predictor.can_resume(len(prompt)):
                        self._error(400, "resume_unsupported",
                                    f"resumed sequence of {len(prompt)} "
                                    f"tokens exceeds this bundle's max "
                                    f"prompt length "
                                    f"{predictor.max_prompt_len}",
                                    retryable=False)
                        return
                with _trace.trace_context(self._request_id), \
                        _span("gen.request",
                              request_id=self._request_id,
                              path=self.path, port=server.addr[1]):
                    from paddle_tpu_torch.gen import SchedulerDraining
                    try:
                        stream = gen.submit(prompt, max_new_tokens=max_new,
                                            deadline=budget, eos_id=eos_id,
                                            timeout=timeout)
                    except QueueFull as e:
                        self._error(503, "overloaded", str(e),
                                    retryable=True)
                        return
                    except SchedulerDraining as e:
                        # rolling restart in progress: retryable 503 —
                        # the router (or resume-capable client) places
                        # the session on a sibling replica
                        self._error(503, "draining", str(e),
                                    retryable=True)
                        return
                    except BatcherCrashed as e:
                        self._error(503, "scheduler_restarted", str(e),
                                    retryable=True)
                        return
                    except (ValueError, KeyError, TypeError) as e:
                        self._error(400, "bad_request", str(e),
                                    retryable=False)
                        return
                    # the reply STATUS is decided by the first event
                    # (admitted and producing vs shed), so headers wait
                    # for the first token — that instant IS the TTFT.
                    # With an explicit deadline, wait slightly PAST it:
                    # the scheduler's own expiry sweep (504 +
                    # gen.expired) is the authoritative verdict, the
                    # handler timeout only a backstop
                    first_wait = timeout
                    if budget is not None and first_wait is not None:
                        first_wait = timeout + 0.5
                    first = stream.next_event(timeout=first_wait)
                    if first is None:
                        stream.cancel()
                        _profiler.runtime_metrics.inc(
                            "serving.deadline_exceeded")
                        self._error(504, "deadline_exceeded",
                                    f"no first token within {timeout}s",
                                    retryable=True)
                        return
                    if first[0] == "error":
                        self._gen_error(first[1])
                        return
                    if first[0] == "migrate":
                        # drained while still queued: zero tokens were
                        # produced, so a plain retryable 503 IS the
                        # resume (no splice state to carry)
                        self._error(503, "draining",
                                    "replica is draining: session "
                                    "migrated before first token",
                                    retryable=True)
                        return
                    if not do_stream:
                        self._generate_buffered(stream, first,
                                                resume_from)
                        return
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/x-ndjson")
                    self.send_header("Transfer-Encoding", "chunked")
                    if self._request_id:
                        self.send_header("X-Request-Id", self._request_id)
                    self.end_headers()
                    try:
                        # indices continue at resume_from: the monotone
                        # token_index the router/client dedupe on
                        self._write_chunk({"token": first[1],
                                           "index": resume_from})
                        index = resume_from + 1
                        while True:
                            ev = stream.next_event(timeout=300)
                            if ev is None:
                                # nobody will consume further tokens:
                                # release the KV slot too
                                stream.cancel()
                                self._write_chunk(
                                    {"error": {"type": "stalled",
                                               "message": "generation "
                                               "stalled"}, "done": True,
                                     "token_index": index,
                                     "retryable": True})
                                break
                            kind, value = ev
                            if kind == "token":
                                self._write_chunk({"token": value,
                                                   "index": index})
                                index += 1
                            elif kind == "done":
                                self._write_chunk(
                                    {"done": True,
                                     "finish_reason": value,
                                     "tokens": resume_from
                                     + len(stream.tokens),
                                     "token_index": resume_from
                                     + len(stream.tokens)})
                                break
                            elif kind == "migrate":
                                # drain-time hand-back at a token
                                # boundary: the router (or a resume-
                                # capable client) re-places the session
                                # on a survivor from exactly this index
                                self._write_chunk(
                                    {"migrate": {
                                        "resume_from": index,
                                        "remaining_tokens": value[
                                            "remaining_tokens"]},
                                     "done": True,
                                     "token_index": index,
                                     "retryable": True})
                                break
                            else:
                                self._write_chunk(
                                    {"error": {
                                        "type": type(value).__name__,
                                        "message": str(value)},
                                     "done": True,
                                     "token_index": index,
                                     "retryable":
                                         self._gen_retryable(value)})
                                break
                        self.wfile.write(b"0\r\n\r\n")
                    except (OSError, chaos.FaultInjected):
                        # the client went away mid-stream (or the
                        # disconnect drill fired): reclaim the slot and
                        # drop the connection — the decode loop must
                        # never crash on a closed socket
                        stream.cancel()
                        self.close_connection = True

            def _generate_buffered(self, stream, first, resume_from=0):
                """stream=false: collect the full generation and reply
                with a normal Content-Length body."""
                tokens = [first[1]]
                while True:
                    ev = stream.next_event(timeout=300)
                    if ev is None:
                        stream.cancel()   # free the slot: nobody reads
                        ev = ("error",
                              DeadlineExceeded("generation stalled"))
                    kind, value = ev
                    if kind == "token":
                        tokens.append(value)
                    elif kind == "done":
                        self._reply(200, {"tokens": tokens,
                                          "finish_reason": value,
                                          "done": True,
                                          "token_index": resume_from
                                          + len(tokens)})
                        return
                    elif kind == "migrate":
                        # buffered callers hold no partial state, so a
                        # retryable 503 re-runs the whole request on a
                        # survivor (greedy decode: same tokens)
                        self._error(503, "draining",
                                    "replica is draining: session "
                                    "migrated mid-generation",
                                    retryable=True)
                        return
                    else:
                        self._gen_error(value)
                        return

            def _finish_resumed_eos(self, do_stream, resume_from):
                """A resume whose prompt already ends in EOS: the owner
                died between emitting EOS and the done tail — reply the
                terminal tail directly instead of re-prefilling past
                end-of-sequence."""
                if not do_stream:
                    self._reply(200, {"tokens": [],
                                      "finish_reason": "eos",
                                      "done": True,
                                      "token_index": resume_from})
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                if self._request_id:
                    self.send_header("X-Request-Id", self._request_id)
                self.end_headers()
                try:
                    self._write_chunk({"done": True,
                                       "finish_reason": "eos",
                                       "tokens": resume_from,
                                       "token_index": resume_from})
                    self.wfile.write(b"0\r\n\r\n")
                except (OSError, chaos.FaultInjected):
                    self.close_connection = True

            @staticmethod
            def _gen_retryable(exc):
                """Whether a mid-stream failure is safe to resume via
                re-prefill on a sibling replica (the tail's top-level
                ``retryable`` flag)."""
                from paddle_tpu_torch.gen import SchedulerDraining
                return isinstance(exc, (DeadlineExceeded, QueueFull,
                                        BatcherCrashed,
                                        SchedulerDraining,
                                        ConnectionError))

            def _gen_error(self, exc):
                from paddle_tpu_torch.gen import SchedulerDraining
                if isinstance(exc, DeadlineExceeded):
                    self._error(504, "deadline_exceeded", str(exc),
                                retryable=True)
                elif isinstance(exc, SchedulerDraining):
                    self._error(503, "draining", str(exc),
                                retryable=True)
                elif isinstance(exc, QueueFull):
                    self._error(503, "overloaded", str(exc),
                                retryable=True)
                elif isinstance(exc, BatcherCrashed):
                    self._error(503, "scheduler_restarted", str(exc),
                                retryable=True)
                elif isinstance(exc, (ValueError, KeyError, TypeError)):
                    self._error(400, "bad_request", str(exc),
                                retryable=False)
                else:
                    self._error(500, "internal", str(exc),
                                retryable=False)

        self._server = _HTTPServer((host, port), Handler)
        self.addr = self._server.server_address
        if async_load:
            self._loader = threading.Thread(target=_load, daemon=True)
            self._loader.start()
        else:
            _load()
            if self._load_error is not None:
                self._server.server_close()  # don't leak the bound socket
                raise self._load_error

    @property
    def ready(self):
        return self._ready.is_set()

    @property
    def load_error(self):
        return self._load_error

    def wait_until_ready(self, timeout=None):
        """Block until the model loads.  A FAILED async load raises the
        load error instead of blocking forever; a timeout returns
        False."""
        if not self._load_done.wait(timeout):
            return False
        if self._load_error is not None:
            raise self._load_error
        return self._ready.is_set()

    def serve_forever(self):
        self._server.serve_forever()

    def start_background(self):
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()
        return t

    def drain_sessions(self, deadline_s=None):
        """Rolling-restart half-step: stop admitting new generative
        sessions, await live streams to natural completion for up to
        ``deadline_s`` seconds, then checkpoint-migrate the remainder
        at a token boundary (the handlers flush ``migrate`` tails to
        their still-open connections).  Returns the checkpoints handed
        back; a no-op (empty list) for non-generation bundles.  Call
        BEFORE :meth:`shutdown` so the tails reach the wire."""
        if self._gen is None:
            return []
        return self._gen.drain(deadline_s)

    def abort_streams(self):
        """In-process hard-kill support (chaos drills): fail every live
        generative stream with a retryable error, as an abruptly killed
        replica would.  No-op for non-generation bundles."""
        if self._gen is not None:
            self._gen.abort_streams()

    def shutdown(self):
        # stop accepting FIRST: closing the batcher while handlers are
        # still arriving would turn their requests into non-retryable
        # 500s; close() then drains what is already queued
        self._server.shutdown()
        if self._batcher is not None:
            self._batcher.close()
        if self._gen is not None:
            self._gen.close()
        self._server.server_close()


def _history_with_hints(history, hints):
    """The per-attempt base-URL trail with ``retry-after=<s>s``
    annotations appended to the attempts whose replies carried a
    ``Retry-After`` hint — RetryError.history is the forensic record of
    a failed failover chain, and *who told us to back off, by how much*
    is part of it.  Attempts without a hint stay plain base strings
    (tests and failover bookkeeping compare those verbatim)."""
    out = []
    for i, base in enumerate(history):
        hint = hints.get(i)
        out.append(base if hint is None
                   else f"{base} retry-after={hint:g}s")
    return out


class ServingClient:
    """Retrying client for :class:`InferenceServer` — optionally a
    client-side load balancer over a replica fleet.

    Transport failures AND replies the server marks ``retryable: true``
    (model still loading, load shedding, deadline exceeded) are retried
    under ``retry`` (a :class:`paddle_tpu_torch.fault.RetryPolicy`); permanent
    errors raise :class:`ServingError` immediately.  This is the
    trainer/edge-side mirror of the master RPC retry path: a briefly
    unready or saturated server no longer kills the caller.

    ``addr`` may be one ``host:port`` or a LIST of them: requests then
    round-robin across the replicas and every retry prefers a replica
    that has not failed this request yet (client-side failover).  With
    ``master=`` the replica list is discovered live from a
    :class:`paddle_tpu_torch.parallel.master.MasterService` (lease-expired
    replicas drop out on the next refresh).  Exhausted retries raise
    :class:`paddle_tpu_torch.fault.RetryError` with ``.history`` holding
    the per-attempt replica bases — the forensic trail of a failed
    failover chain.

    Idempotency/traceability: every logical request carries ONE
    ``X-Request-Id`` (the ambient trace id when set, else freshly
    minted) across ALL its retry attempts, so replicas and the router
    can recognize — and operators can trace — the same request as it
    fails over.  Pre-dispatch connection errors (reset/refused before a
    reply line) are always retryable: the server has not dispatched
    anything, so re-sending is safe.
    """

    def __init__(self, addr=None, retry=None, timeout=30.0, master=None,
                 refresh_interval=1.0, deadline=None):
        from paddle_tpu_torch.fault.retry import RetryPolicy, parse_hostport
        if addr is None and master is None:
            raise ValueError("ServingClient needs addr(s) or master=")
        # end-to-end budget (seconds) for one LOGICAL request including
        # every retry: each attempt ships the remaining budget as
        # X-Deadline-Ms (the router forwards it, the replica's batcher
        # bounds its wait by it) and the retry chain is cut when the
        # budget can't cover the next backoff
        self._deadline = None if deadline is None else float(deadline)
        if addr is None:
            addrs = []
        elif isinstance(addr, list):
            addrs = list(addr)
        elif isinstance(addr, tuple) and len(addr) == 2 and \
                (isinstance(addr[1], int) or str(addr[1]).isdigit()):
            addrs = [addr]          # one (host, port) pair
        elif isinstance(addr, tuple):
            addrs = list(addr)      # a tuple OF addresses
        else:
            addrs = [addr]
        self._bases = []
        for a in addrs:
            host, port = parse_hostport(a)
            self._bases.append(f"http://{host}:{port}")
        self._timeout = timeout
        self._retry = retry or RetryPolicy(max_attempts=8, base_delay=0.1,
                                           max_delay=2.0, deadline=60.0)
        self._lock = threading.Lock()
        self._rr = 0
        self._master_addr = master
        self._master = None
        self._refresh_interval = float(refresh_interval)
        self._refreshed_at = 0.0

    @property
    def _base(self):
        """The first live replica base (single-replica callers)."""
        bases = self._live_bases()
        return bases[0] if bases else None

    def _live_bases(self):
        """Current replica bases, refreshing from the master when one is
        configured and the cached list is stale (or empty)."""
        if self._master_addr is None:
            return list(self._bases)
        now = time.monotonic()
        with self._lock:
            stale = now - self._refreshed_at > self._refresh_interval
            cached = list(self._bases)
        if not stale and cached:
            return cached
        try:
            with self._lock:
                if self._master is None:
                    from paddle_tpu_torch.parallel.master import \
                        MasterClient
                    self._master = MasterClient(self._master_addr)
                master = self._master
            live = master.list_replicas()
            from paddle_tpu_torch.fault.retry import parse_hostport
            bases = []
            for rec in live:
                host, port = parse_hostport(rec["addr"])
                bases.append(f"http://{host}:{port}")
            with self._lock:
                self._bases = bases
                self._refreshed_at = now
            return bases
        except Exception:
            # master briefly unreachable: serve from the cached list —
            # and back off (stamp the refresh time) so the request hot
            # path doesn't re-dial the dead master on every attempt
            with self._lock:
                self._refreshed_at = now
            return cached

    def _pick_base(self, tried):
        """Round-robin over live bases, preferring one not yet tried by
        THIS request (failover targets a *different* replica while any
        remain)."""
        bases = self._live_bases()
        if not bases:
            raise ConnectionError("no live serving replicas")
        with self._lock:
            self._rr += 1
            start = self._rr
        untried = [b for b in bases if b not in tried]
        pool = untried or bases
        return pool[start % len(pool)]

    def _request(self, path, payload=None, retry=True):
        import urllib.error
        import urllib.request
        from paddle_tpu_torch.fault.retry import RetryError

        # ONE id per logical request, reused verbatim by every retry
        # attempt (idempotency key + the trace the failover chain shares)
        rid = _trace.current_trace_id() or _trace.new_trace_id()
        history = []
        hints = {}      # attempt index -> Retry-After seconds
        deadline_at = None if self._deadline is None \
            else time.monotonic() + self._deadline

        def attempt():
            from paddle_tpu_torch.fault.retry import parse_retry_after
            base = self._pick_base(history)
            history.append(base)
            headers = {"Content-Type": "application/json",
                       "X-Request-Id": rid}
            timeout = self._timeout
            if deadline_at is not None:
                remaining = max(deadline_at - time.monotonic(), 0.001)
                headers["X-Deadline-Ms"] = str(int(remaining * 1000) or 1)
                # one hung attempt must not outlive the logical budget
                timeout = min(timeout, remaining)
            req = urllib.request.Request(
                base + path,
                data=None if payload is None
                else json.dumps(payload).encode(),
                headers=headers)
            try:
                with urllib.request.urlopen(
                        req, timeout=timeout) as r:
                    return json.loads(r.read())
            except urllib.error.HTTPError as e:
                try:
                    body = json.loads(e.read())
                except ValueError:
                    body = {"error": {"type": "http", "message": str(e)},
                            "retryable": e.code in (429, 502, 503, 504)}
                err = body.get("error") or {}
                if body.get("retryable"):
                    exc = _TransientServingError(
                        f"{err.get('type', 'http')}: "
                        f"{err.get('message', str(e))}")
                    hint = parse_retry_after(
                        e.headers.get("Retry-After")
                        if e.headers is not None else None)
                    if hint is not None:
                        # server-paced: the retry policy sleeps this
                        # instead of its own backoff
                        exc.retry_after = hint
                        hints[len(history) - 1] = hint
                    raise exc from e
                raise ServingError(err.get("type", "http"),
                                   err.get("message", str(e)),
                                   retryable=False) from e
            except urllib.error.URLError as e:
                # pre-dispatch transport failure (refused/reset before a
                # reply): nothing reached a batcher, re-sending under the
                # same X-Request-Id is safe — always retryable
                raise ConnectionError(str(e)) from e

        try:
            if not retry:
                return attempt()
            # deadline=None falls back to the policy's own budget
            return self._retry.call(attempt, deadline=self._deadline)
        except RetryError as e:
            e.history = _history_with_hints(history, hints)
            raise

    def predict(self, feeds):
        """feeds: dict name -> array-like; returns list of ndarrays."""
        resp = self._request("/predict", {
            "feeds": {k: np.asarray(v).tolist() for k, v in feeds.items()}})
        dtypes = resp.get("dtypes") or [None] * len(resp["outputs"])
        return [np.asarray(o) if dt is None else np.asarray(o, dtype=dt)
                for o, dt in zip(resp["outputs"], dtypes)]

    def generate(self, prompt, max_new_tokens=16, eos_id=None,
                 stream=True, retry=True, session_id=None, resume=True,
                 max_resumes=8):
        """Stream a generation from ``/generate``: returns an iterator
        of parsed ndjson events — ``{"token": id, "index": i}`` per
        produced token, then ``{"done": true, "finish_reason": ...}``
        (or ``{"error": ..., "done": true}`` if the stream failed
        mid-flight).  Chunks are yielded AS THEY ARRIVE, so the first
        token is available while the server is still decoding.

        Pre-stream failures (connection errors, retryable 503/504
        replies) retry/fail over under the client's policy like
        ``predict``.  MID-stream failures are resumable (``resume=``,
        the router-less failover path): on a dead socket, a torn
        chunk, a retryable error tail, or a drain-time ``migrate``
        tail, the client re-submits ``prompt + tokens_so_far`` with a
        ``resume_from`` index to a (preferably different) replica and
        splices the continuation, deduplicating on each event's
        monotone ``token_index`` — greedy decode is deterministic, so
        the client-visible sequence is identical to an unbroken
        stream.  A NON-retryable mid-stream failure (or ``resume=
        False``, or ``max_resumes`` exhausted) surfaces as the
        documented terminal error event, never as a raw exception out
        of the iterator."""
        import http.client
        from paddle_tpu_torch.fault.retry import RetryError, parse_hostport

        rid = _trace.current_trace_id() or _trace.new_trace_id()
        if session_id is None:
            from paddle_tpu_torch.fleet.sessions import new_session_id
            session_id = new_session_id()
        orig_prompt = [int(t) for t in prompt]
        max_new = int(max_new_tokens)
        toks = []       # tokens delivered to the caller so far
        history = []
        hints = {}      # attempt index -> Retry-After seconds
        deadline_at = None if self._deadline is None \
            else time.monotonic() + self._deadline

        def payload():
            p = {"prompt": orig_prompt + toks,
                 "max_new_tokens": max_new - len(toks),
                 "stream": bool(stream),
                 "session_id": session_id}
            if toks:
                p["resume_from"] = len(toks)
            if eos_id is not None:
                p["eos_id"] = int(eos_id)
            return p

        def attempt():
            from paddle_tpu_torch.fault.retry import parse_retry_after
            base = self._pick_base(history)
            history.append(base)
            host, port = parse_hostport(base[len("http://"):])
            headers = {"Content-Type": "application/json",
                       "X-Request-Id": rid}
            timeout = self._timeout
            if deadline_at is not None:
                remaining = max(deadline_at - time.monotonic(), 0.001)
                headers["X-Deadline-Ms"] = str(int(remaining * 1000) or 1)
                timeout = min(timeout, remaining)
            body = json.dumps(payload()).encode()
            conn = http.client.HTTPConnection(host, port, timeout=timeout)
            try:
                conn.request("POST", "/generate", body, headers)
                resp = conn.getresponse()
            except (OSError, http.client.HTTPException) as e:
                conn.close()
                raise ConnectionError(str(e)) from e
            if resp.status != 200:
                data = resp.read()
                hint = parse_retry_after(resp.getheader("Retry-After"))
                conn.close()
                try:
                    parsed = json.loads(data)
                except ValueError:
                    parsed = {"retryable":
                              resp.status in (429, 502, 503, 504)}
                err = parsed.get("error") or {}
                if parsed.get("retryable"):
                    exc = _TransientServingError(
                        f"{err.get('type', 'http')}: "
                        f"{err.get('message', resp.status)}")
                    if hint is not None:
                        exc.retry_after = hint
                        hints[len(history) - 1] = hint
                    raise exc
                raise ServingError(err.get("type", "http"),
                                   err.get("message", str(resp.status)),
                                   retryable=False)
            return conn, resp

        def connect():
            if retry:
                return self._retry.call(attempt,
                                        deadline=self._deadline)
            return attempt()

        try:
            conn, resp = connect()
        except RetryError as e:
            e.history = _history_with_hints(history, hints)
            raise

        def events():
            import http.client

            from paddle_tpu_torch import profiler as _profiler
            nonlocal conn, resp
            resumes = 0
            resumable = bool(resume) and stream
            try:
                while True:
                    failure = None
                    obj = None
                    try:
                        line = resp.readline()
                        if not line:
                            if not resumable:
                                return      # legacy: silent clean EOF
                            failure = ConnectionError(
                                "stream closed without a terminal "
                                "event")
                        else:
                            obj = json.loads(line)
                    except (OSError, http.client.HTTPException,
                            ValueError) as e:
                        failure = e
                    if failure is None:
                        if "token" in obj and "index" in obj:
                            idx = obj["index"]
                            if idx < len(toks):
                                # replayed prefix after a resume: the
                                # exactly-once guarantee is THIS drop
                                _profiler.runtime_metrics.inc(
                                    "gen.session.dedup_drops")
                                continue
                            if idx == len(toks):
                                toks.append(int(obj["token"]))
                                yield obj
                                continue
                            # an index GAP means tokens were torn out
                            # of the transport: resume from what we
                            # actually hold
                            failure = ConnectionError(
                                f"token_index gap: got {idx}, "
                                f"expected {len(toks)}")
                        elif obj.get("done") and "migrate" in obj:
                            failure = ConnectionError(
                                "session migrated (replica draining)")
                        elif obj.get("done") and obj.get("error") \
                                and obj.get("retryable") and resumable:
                            failure = ConnectionError(
                                f"retryable mid-stream error tail: "
                                f"{obj['error'].get('type')}")
                        else:
                            yield obj
                            if obj.get("done"):
                                return
                            continue
                    # a resumable fault: re-submit prompt + toks with
                    # resume_from and splice the continuation
                    if not resumable or resumes >= max_resumes:
                        yield {"error": {"type": type(failure).__name__,
                                         "message": str(failure)},
                               "done": True,
                               "token_index": len(toks),
                               "retryable": True}
                        return
                    try:
                        conn.close()
                    except Exception:
                        pass
                    try:
                        conn, resp = connect()
                    except (RetryError, ServingError,
                            ConnectionError) as e:
                        yield {"error": {"type": type(e).__name__,
                                         "message": str(e)},
                               "done": True,
                               "token_index": len(toks),
                               "retryable": not isinstance(
                                   e, ServingError)}
                        return
                    resumes += 1
                    _profiler.runtime_metrics.inc("gen.session.resumes")
            finally:
                conn.close()

        return events()

    def meta(self):
        return self._request("/meta")

    def stats(self):
        """Runtime metrics snapshot (/stats): request latency
        percentiles, batch occupancy, warmup report, kernel builds."""
        return self._request("/stats")

    def trace(self):
        """The server's span ring as a Chrome trace-event JSON object
        (/trace) — save it and load into Perfetto."""
        return self._request("/trace")

    def prom_metrics(self):
        """The server's /metrics body: Prometheus text exposition of
        the runtime metrics registry (plain text, not JSON)."""
        import urllib.request
        base = self._base
        if base is None:
            raise ConnectionError("no live serving replicas")
        with urllib.request.urlopen(base + "/metrics",
                                    timeout=self._timeout) as r:
            return r.read().decode()

    def close(self):
        """Release the master discovery connection (no-op without
        ``master=``)."""
        with self._lock:
            master, self._master = self._master, None
        if master is not None:
            master.close()

    def healthy(self):
        """Single-shot liveness probe (no retries — probes must be cheap)."""
        try:
            return self._request("/healthz",
                                 retry=False).get("status") == "ok"
        except Exception:
            return False

    def ready(self):
        """Single-shot readiness probe."""
        try:
            return self._request("/readyz",
                                 retry=False).get("status") == "ready"
        except Exception:
            return False


def serve(model_dir, host="127.0.0.1", port=8866, async_load=False,
          max_inflight=32, request_timeout=None, batching=False,
          max_batch_size=8, max_batch_delay=0.005, batch_queue_size=128,
          warmup=False, warmup_batch_sizes=None,
          gen_admission="continuous", gen_queue_size=64,
          gen_prefill_budget=None, place=None):
    """Serve ``model_dir`` on ``host:port`` until the process ends (the
    ``paddle_tpu_torch serve`` entry point); ``place`` and
    ``gen_prefill_budget`` as for :class:`InferenceServer`."""
    server = InferenceServer(model_dir, host, port, async_load=async_load,
                             max_inflight=max_inflight,
                             request_timeout=request_timeout,
                             batching=batching,
                             max_batch_size=max_batch_size,
                             max_batch_delay=max_batch_delay,
                             batch_queue_size=batch_queue_size,
                             warmup=warmup,
                             warmup_batch_sizes=warmup_batch_sizes,
                             gen_admission=gen_admission,
                             gen_queue_size=gen_queue_size,
                             gen_prefill_budget=gen_prefill_budget,
                             place=place)
    print(f"serving {model_dir} on {server.addr[0]}:{server.addr[1]}",
          flush=True)
    server.serve_forever()
