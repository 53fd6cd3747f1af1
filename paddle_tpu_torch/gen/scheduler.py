"""Iteration-level (continuous-batching) generation scheduler (the port
of ``paddle_tpu.gen.scheduler``).

Between decode steps the scheduler admits queued requests into free
KV-cache slots (prefill interleaved with decode), evicts finished
sequences (EOS / length cap / client disconnect), and streams each
request's tokens out as they are produced.  The
:class:`~paddle_tpu_torch.serving.MicroBatcher` degradation contract is
reused at token granularity: a full admission queue raises
:class:`~paddle_tpu_torch.serving.QueueFull` (503 load shedding), a
request whose ``X-Deadline-Ms`` budget expires while still queued for
admission fails with :class:`~paddle_tpu_torch.serving.DeadlineExceeded`
(504, ``gen.expired``) WITHOUT ever taking a slot, and an unexpected
scheduler-thread crash fails every live stream fast (retryable 503,
:class:`~paddle_tpu_torch.serving.BatcherCrashed`) and restarts the
thread within a bounded consecutive-crash budget.  The three classes are
the serving module's, so a handler's ``except`` maps the scheduler's
failures to the same replies as the batcher's.

``drain(deadline_s)`` stops admission, lets live streams finish for up
to the deadline and then checkpoint-migrates the rest at a token
boundary; ``abort_streams()`` fails every stream with a retryable error
(the in-process hard kill).

``admission="batch"`` degrades the scheduler to request-level
semantics — new requests are admitted only when the pool is EMPTY, so a
batch runs start-to-finish as a unit while later arrivals queue behind
it (the benchmark baseline of continuous batching).

Cost-weighted admission (``prefill_budget``, continuous admission
only): an admission pass admits prefills until their summed static
cost (``GenPredictor.prefill_cost``, from ``analysis.cost``) would pass
the budget; the first of a pass is always admitted.
"""

from __future__ import annotations

import logging
import threading
import time

import numpy as np

from paddle_tpu_torch import profiler as _profiler
from paddle_tpu_torch.obs import slo as _slo
from paddle_tpu_torch.obs import trace as _trace
from paddle_tpu_torch.obs.slo import tick as _slo_tick
from paddle_tpu_torch.serving import (BatcherCrashed, DeadlineExceeded,
                                      QueueFull)

logger = logging.getLogger(__name__)

__all__ = ["GenScheduler", "GenStream", "SchedulerDraining",
           "StreamMigrated"]


class SchedulerDraining(RuntimeError):
    """The scheduler stopped admitting new sessions (rolling-restart
    drain): retryable by contract — a sibling replica will take the
    request."""


class StreamMigrated(RuntimeError):
    """A locally-iterated stream was checkpoint-migrated at a token
    boundary (drain-time hand-back); ``.checkpoint`` holds everything a
    survivor needs to continue token-identically."""

    def __init__(self, checkpoint):
        super().__init__("stream checkpoint-migrated at token boundary")
        self.checkpoint = checkpoint


class GenStream:
    """One request's token stream, produced by the scheduler thread and
    consumed by an HTTP handler (or any iterator)."""

    def __init__(self, prompt, max_new_tokens, eos_id, deadline_at,
                 trace_id=None):
        self.prompt = list(prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.deadline_at = deadline_at      # monotonic, None = unbounded
        self.trace_id = trace_id or _trace.current_trace_id()
        self.created_t = time.perf_counter()
        self.cancelled = False              # set by the consumer side
        self.finish_reason = None
        self.error = None
        self.tokens = []
        self._events = []
        self._cv = threading.Condition()

    # -- producer side (scheduler thread) ---------------------------------
    def _push(self, event):
        with self._cv:
            self._events.append(event)
            self._cv.notify_all()

    def emit(self, token):
        self.tokens.append(int(token))
        self._push(("token", int(token)))

    def finish(self, reason):
        self.finish_reason = reason
        self._push(("done", reason))

    def fail(self, exc):
        self.error = exc
        self._push(("error", exc))

    # -- consumer side -----------------------------------------------------
    def cancel(self):
        """Mark the consumer gone (client disconnect): the scheduler
        reclaims the slot and stops decoding for this stream on its next
        iteration."""
        self.cancelled = True

    def next_event(self, timeout=None):
        """Block for the next ``("token", id)`` / ``("done", reason)`` /
        ``("error", exc)`` event; returns None on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while not self._events:
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return None
                self._cv.wait(remaining if remaining is not None else 0.5)
            return self._events.pop(0)

    def __iter__(self):
        """Yield token ids until the stream finishes; raises the
        stream's error if it failed."""
        while True:
            kind, value = self.next_event()
            if kind == "token":
                yield value
            elif kind == "done":
                return
            elif kind == "migrate":
                raise StreamMigrated(value)
            else:
                raise value


class _Slot:
    __slots__ = ("stream", "pos", "steps", "last_token", "last_emit_t")

    def __init__(self, stream, prompt_len, first_token):
        self.stream = stream
        # the NEXT decode step consumes first_token and writes its K/V
        # at position prompt_len
        self.pos = prompt_len
        self.steps = 0
        self.last_token = first_token
        self.last_emit_t = time.perf_counter()


class GenScheduler:
    """Continuous-batching decode loop over a
    :class:`~paddle_tpu_torch.gen.predictor.GenPredictor`."""

    def __init__(self, predictor, queue_size=64, admission="continuous",
                 max_restarts=5, slo_watchdog=None,
                 prefill_budget=None):
        if admission not in ("continuous", "batch"):
            raise ValueError(
                f"admission must be 'continuous' or 'batch', "
                f"got {admission!r}")
        # admission weighting (analysis/cost): cap the static prefill
        # FLOPs admitted between two decode iterations at
        # ``prefill_budget`` (None = unbounded).  Prefills interleave
        # with decode on ONE device, so an unbounded admission burst
        # stalls every live stream's next token; the budget bounds that
        # stall by compute actually admitted (weighted by
        # GenPredictor.prefill_cost — the real program's cost at the
        # prompt's padded bucket).  At least one request is always
        # admitted per pass, so the queue drains even when one prefill
        # exceeds the budget.  CONTINUOUS admission only: batch mode
        # refills the pool as one unit by definition — a budget cut
        # mid-refill would strand the unfilled slots for the whole batch.
        self.prefill_budget = None if prefill_budget is None \
            or admission != "continuous" else float(prefill_budget)
        if self.prefill_budget is not None and \
                hasattr(predictor, "prefill_cost"):
            # warm the cost model's fit HERE (it walks the prefill
            # program twice) so no _admit pass pays it while holding
            # the scheduler lock
            predictor.prefill_cost(1)
        # SLO watchdog (obs.slo): evaluated from the scheduler loop so
        # TTFT/tokens-per-sec objectives are judged by the thread that
        # produces them.  Default arms from PADDLE_TPU_SLO; unarmed the
        # per-iteration cost is one None check (tick()).
        if slo_watchdog is None:
            slo_watchdog = _slo.watchdog_from_env()
        self.slo_watchdog = slo_watchdog
        self.predictor = predictor
        self.queue_size = max(1, int(queue_size))
        self.admission = admission
        self.max_restarts = max(0, int(max_restarts))
        self._queue = []
        self._slots = {}          # slot index -> _Slot
        self._free = list(range(predictor.num_slots))
        self._cv = threading.Condition()
        self._closed = False
        self._restarts = 0
        self._crashes = 0
        self._failed = None
        # drain-time migration (rolling restarts): _draining rejects
        # new admissions; _migrate_req asks the scheduler thread to
        # checkpoint every remaining stream at the next token boundary
        # (between decode iterations — the only place a stream is
        # guaranteed whole-token); _abort_exc is the in-process
        # hard-kill analog (fail everything retryable, no checkpoint)
        self._draining = False
        self._migrate_req = False
        self._migrate_done = None
        self._abort_exc = None
        # streams popped from _queue but not yet seated in _slots
        # (prefill in flight): drain()'s all-idle check must count
        # these or it can declare the scheduler empty mid-admission
        self._admitting = 0
        self.migrated = []        # checkpoints handed back by drain()
        self._thread = self._spawn_thread()

    # -- public surface ----------------------------------------------------
    @property
    def queue_depth(self):
        with self._cv:
            return len(self._queue)

    @property
    def active_slots(self):
        with self._cv:
            return len(self._slots)

    @property
    def failed(self):
        """Terminal crash once the consecutive-restart budget is spent
        (None while alive) — the /readyz pull-the-replica signal."""
        with self._cv:
            return self._failed

    @property
    def crashes(self):
        """Scheduler-thread crashes over the scheduler's lifetime."""
        with self._cv:
            return self._crashes

    def submit(self, prompt, max_new_tokens=16, deadline=None,
               eos_id=None, timeout=None):
        """Enqueue one generation request; returns a :class:`GenStream`.

        ``deadline``: seconds of end-to-end admission budget (the
        ``X-Deadline-Ms`` contract) — expiry while queued fails the
        stream with DeadlineExceeded without taking a slot.  ``eos_id``
        overrides the bundle's EOS token for this request."""

        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if any(t < 0 or t >= self.predictor.vocab_size for t in prompt):
            raise ValueError("prompt token out of vocabulary range")
        if len(prompt) > self.predictor.max_prompt_len:
            raise ValueError(
                f"prompt of {len(prompt)} tokens exceeds the bundle's "
                f"max prompt length {self.predictor.max_prompt_len}")
        if int(max_new_tokens) < 1:
            raise ValueError("max_new_tokens must be >= 1")
        eos = self.predictor.eos_id if eos_id is None else int(eos_id)
        deadline_at = None
        if deadline is not None:
            deadline_at = time.monotonic() + float(deadline)
        elif timeout is not None:
            deadline_at = time.monotonic() + float(timeout)
        stream = GenStream(prompt, max_new_tokens, eos, deadline_at)
        with self._cv:
            if self._closed:
                raise RuntimeError("generation scheduler is shut down")
            if self._draining:
                raise SchedulerDraining(
                    "replica is draining: not admitting new sessions")
            if self._failed is not None:
                raise BatcherCrashed(
                    f"generation scheduler is down after "
                    f"{self._restarts} restarts: {self._failed}")
            if len(self._queue) >= self.queue_size:
                _profiler.runtime_metrics.inc("gen.queue_rejections")
                raise QueueFull(
                    f"generation queue full ({self.queue_size} pending)")
            self._queue.append(stream)
            self._cv.notify_all()
        return stream

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=10)

    def drain(self, deadline_s=None):
        """Stop admitting new sessions, await the live ones to natural
        completion for up to ``deadline_s`` seconds (None = unbounded),
        then checkpoint-migrate whatever remains at the next token
        boundary.  Returns the list of checkpoints handed back (empty
        when every stream finished inside the deadline) — each one is
        ``{"prompt", "tokens", "remaining_tokens", "eos_id",
        "reason"}``, everything a survivor replica needs to continue
        the stream token-identically via deterministic re-prefill.

        A length-cap decode used to be able to hold a rolling restart
        open for minutes; with a deadline it costs at most
        ``deadline_s`` plus one decode iteration."""
        with self._cv:
            self._draining = True
            self._cv.notify_all()
        deadline_at = None if deadline_s is None \
            else time.monotonic() + float(deadline_s)
        while True:
            with self._cv:
                if (not self._queue and not self._slots and
                        not self._admitting) or \
                        self._closed or self._failed is not None:
                    return list(self.migrated)
            if deadline_at is not None and \
                    time.monotonic() >= deadline_at:
                break
            time.sleep(0.005)
        done = threading.Event()
        with self._cv:
            self._migrate_done = done
            self._migrate_req = True
            self._cv.notify_all()
        done.wait(timeout=30.0)
        return list(self.migrated)

    def abort_streams(self, exc=None):
        """In-process hard-kill support: ask the scheduler thread to
        fail every queued and active stream with a RETRYABLE error at
        the next token boundary — what a real ``kill -9`` looks like to
        a resume-capable client, minus the socket corpse.  Returns
        immediately (the kill is asynchronous, like a crash)."""
        if exc is None:
                exc = BatcherCrashed(
                "replica hard-killed mid-decode; stream aborted — "
                "resume on a survivor")
        with self._cv:
            self._abort_exc = exc
            self._cv.notify_all()

    # -- scheduler thread --------------------------------------------------
    def _spawn_thread(self):
        t = threading.Thread(target=self._run, daemon=True,
                             name="paddle-tpu-torch-gen-scheduler")
        t.start()
        return t

    def _run(self):
        try:
            self._loop()
        except BaseException as e:
            self._crash(e)

    def _crash(self, exc):
        logger.exception("generation scheduler thread crashed")
        with self._cv:
            queued, self._queue = self._queue, []
            active, self._slots = list(self._slots.values()), {}
            self._free = list(range(self.predictor.num_slots))
            self._crashes += 1
            restart = not self._closed and \
                self._restarts < self.max_restarts
            if restart:
                self._restarts += 1
            elif not self._closed:
                self._failed = exc
        # the wholesale slot reset above must also reset the page
        # pool, or a crash strands every live allocation and the
        # restarted loop livelocks on page-aware admission
        if getattr(self.predictor, "paged", False):
            self.predictor.free_all_pages()
        if restart:
            _profiler.runtime_metrics.inc("gen.scheduler_restarts")
            self._thread = self._spawn_thread()
        err = BatcherCrashed(
            f"generation scheduler crashed ({type(exc).__name__}: {exc});"
            f" request aborted — retry")
        err.__cause__ = exc
        for slot in active:
            slot.stream.fail(err)
        for stream in queued:
            stream.fail(err)

    def _loop(self):
        while True:
            with self._cv:
                while not self._queue and not self._slots and \
                        not self._closed and self._abort_exc is None \
                        and not self._migrate_req:
                    self._cv.wait(0.05)
                if self._closed:
                    queued, self._queue = self._queue, []
                    active, self._slots = list(self._slots.items()), {}
                    break
            # kill/migrate run HERE — between decode iterations, the
            # only point every live stream is at a whole-token boundary
            if self._abort_exc is not None:
                self._do_abort()
            if self._migrate_req:
                self._do_migrate()
            self._sweep_queue()
            self._admit()
            if self._slots:
                self._decode_iteration()
                # a completed iteration is forward progress: the restart
                # budget bounds CONSECUTIVE crashes, not lifetime ones
                with self._cv:
                    self._restarts = 0
            _profiler.runtime_metrics.set_gauge("gen.slots_active",
                                                len(self._slots))
            _slo_tick(self.slo_watchdog)
        # shutdown discards the slots wholesale; return their pages so
        # a later scheduler over the SAME predictor starts with a full
        # pool (the test suite reuses warmed predictors this way)
        if getattr(self.predictor, "paged", False):
            self.predictor.free_all_pages()
        err = RuntimeError("generation scheduler shut down")
        for _, slot in active:
            slot.stream.fail(err)
        for stream in queued:
            stream.fail(err)

    def _do_abort(self):
        """Scheduler-thread half of :meth:`abort_streams`: wholesale
        reset (slots, free list, page pool), every stream failed with
        the retryable kill error."""
        with self._cv:
            exc, self._abort_exc = self._abort_exc, None
            queued, self._queue = self._queue, []
            active, self._slots = list(self._slots.values()), {}
            self._free = list(range(self.predictor.num_slots))
        if getattr(self.predictor, "paged", False):
            self.predictor.free_all_pages()
        for slot in active:
            slot.stream.fail(exc)
        for stream in queued:
            stream.fail(exc)

    def _do_migrate(self):
        """Scheduler-thread half of :meth:`drain`'s expiry path:
        checkpoint every remaining stream at its current token boundary
        and hand it back as a ``("migrate", checkpoint)`` event, then
        release the slot/pages.  Queued (never-admitted) streams
        migrate with zero emitted tokens."""
        with self._cv:
            queued, self._queue = self._queue, []
            active = sorted(self._slots.items())
        for idx, slot in active:
            if not slot.stream.cancelled:
                self._checkpoint_out(slot.stream)
            else:
                slot.stream.finish("disconnect")
            if getattr(self.predictor, "paged", False):
                self.predictor.free_slot_pages(idx)
            with self._cv:
                self._slots.pop(idx, None)
                self._free.append(idx)
        for stream in queued:
            if not stream.cancelled:
                self._checkpoint_out(stream)
            else:
                stream.finish("disconnect")
        with self._cv:
            self._migrate_req = False
            done, self._migrate_done = self._migrate_done, None
        if done is not None:
            done.set()

    def _checkpoint_out(self, stream):
        ckpt = {"prompt": list(stream.prompt),
                "tokens": list(stream.tokens),
                "remaining_tokens": max(
                    0, stream.max_new_tokens - len(stream.tokens)),
                "eos_id": stream.eos_id,
                "reason": "draining"}
        self.migrated.append(ckpt)
        _profiler.runtime_metrics.inc("gen.session.migrations")
        stream.finish_reason = "migrated"
        stream._push(("migrate", ckpt))

    def _sweep_queue(self):
        """Fail expired/abandoned QUEUED requests immediately — an
        expired deadline gets its 504 now, not when a slot frees up."""
        now = time.monotonic()
        with self._cv:
            keep = []
            for stream in self._queue:
                if stream.cancelled:
                    stream.finish("disconnect")
                    continue
                if stream.deadline_at is not None and \
                        now > stream.deadline_at:
                    _profiler.runtime_metrics.inc("gen.expired")
                    stream.fail(DeadlineExceeded(
                        "deadline expired while queued for admission"))
                    continue
                keep.append(stream)
            self._queue = keep

    def _admit(self):
        """Move queued requests into free slots (continuous mode), or —
        batch mode — refill the pool only once it is completely empty,
        and then fill it WHOLE (the refill decision is made once per
        call, so one batch admission loads every free slot rather than
        degrading to serial batch-of-1)."""
        refill = None
        spent = 0.0
        admitted_n = 0
        while True:
            with self._cv:
                if not self._queue or not self._free:
                    return
                if self.admission == "batch":
                    if refill is None:
                        refill = not self._slots
                    if not refill:
                        return
                if getattr(self.predictor, "paged", False):
                    # page-aware admission: a request is only admitted
                    # when the pool can cover its WHOLE length horizon
                    # (allocation happens once, at admission), so decode
                    # growth never fails mid-request; otherwise the
                    # head-of-line request waits for an eviction to
                    # return pages — backpressure, like the FLOPs
                    # budget below, not an error
                    head = self._queue[0]
                    need = self.predictor.pages_needed(
                        len(head.prompt), head.max_new_tokens)
                    if need > self.predictor.free_pages:
                        return
                if self.prefill_budget is not None and admitted_n:
                    # cost-weighted admission: stop once this pass has
                    # admitted its budget of static prefill FLOPs (the
                    # first admission is always free so the queue
                    # drains); the rest of the queue waits one decode
                    # iteration instead of stalling every live stream
                    cost = self.predictor.prefill_cost(
                        len(self._queue[0].prompt))
                    if spent + cost > self.prefill_budget:
                        return
                stream = self._queue.pop(0)
                slot_idx = self._free.pop(0)
                self._admitting += 1
            if self.prefill_budget is not None:
                cost = self.predictor.prefill_cost(len(stream.prompt))
                spent += cost
                _profiler.runtime_metrics.observe("gen.admission_cost",
                                                  cost)
            admitted_n += 1
            admitted = False
            try:
                admitted = self._prefill_into(slot_idx, stream)
            finally:
                with self._cv:
                    self._admitting -= 1
                    if not admitted:
                        self._free.append(slot_idx)

    def _prefill_into(self, slot_idx, stream):
        """Prefill one request and seed its slot; returns True when the
        slot stays occupied (request still generating)."""
        t0 = time.perf_counter()
        with _trace.trace_context(stream.trace_id):
            try:
                logits, kv = self.predictor.prefill(stream.prompt)
            except BaseException as e:
                stream.fail(e)
                return False
        # counted only when prefill actually ran for an admitted
        # request — a failed prefill above never takes the slot
        _profiler.runtime_metrics.inc("gen.admissions")
        _profiler.runtime_metrics.observe("gen.prefill_seconds",
                                          time.perf_counter() - t0)
        first = int(np.argmax(logits))
        now = time.perf_counter()
        _profiler.runtime_metrics.observe("gen.ttft_seconds",
                                          now - stream.created_t)
        _profiler.runtime_metrics.inc("gen.tokens")
        stream.emit(first)
        prompt_len = len(stream.prompt)
        if first == stream.eos_id:
            return self._finish(stream, "eos")
        if stream.max_new_tokens <= 1 or prompt_len >= self.predictor.max_len:
            return self._finish(stream, "length")
        if getattr(self.predictor, "paged", False):
            try:
                self.predictor.alloc_slot_pages(
                    slot_idx, self.predictor.pages_needed(
                        prompt_len, stream.max_new_tokens))
            except BaseException as e:
                stream.fail(e)
                return False
            try:
                self.predictor.write_slot(slot_idx, kv, prompt_len)
            except BaseException:
                self.predictor.free_slot_pages(slot_idx)
                raise
        else:
            self.predictor.write_slot(slot_idx, kv, prompt_len)
        with self._cv:
            self._slots[slot_idx] = _Slot(stream, prompt_len, first)
        return True

    def _finish(self, stream, reason):
        stream.finish(reason)
        _profiler.runtime_metrics.inc("gen.requests_ok")
        return False

    def _evict(self, slot_idx, reason=None):
        # Eviction runs only on the scheduler thread, so the slot
        # cannot be re-admitted while this is in flight.  The slot is
        # removed from `_slots`/returned to `_free` LAST: once
        # `active_slots` reads 0, the slot's pages are already back in
        # the pool — observers (and page-aware admission) never see a
        # half-evicted slot.
        with self._cv:
            slot = self._slots.get(slot_idx)
            if slot is None:
                return
        if reason == "disconnect":
            _profiler.runtime_metrics.inc("gen.disconnects")
            self.predictor.clear_slot(slot_idx)
            # terminal event even though the usual consumer is gone: a
            # LOCAL consumer that cancelled must not block forever on a
            # stream nobody will ever finish
            slot.stream.finish("disconnect")
        # paged bundles: EVERY eviction (eos / length / disconnect)
        # returns the slot's pages to the pool — the admission
        # backpressure above turns a leak here into a livelock; for
        # disconnects this runs AFTER clear_slot, which addresses
        # pages through the still-live allocation
        if getattr(self.predictor, "paged", False):
            self.predictor.free_slot_pages(slot_idx)
        with self._cv:
            self._slots.pop(slot_idx, None)
            self._free.append(slot_idx)
        _profiler.runtime_metrics.inc("gen.evictions")

    def _decode_iteration(self):
        """One token for every live slot: sweep disconnects, build the
        (constant-signature) step feeds, dispatch, scatter tokens."""
        # reclaim disconnected streams BEFORE paying a step for them
        with self._cv:
            live = list(self._slots.items())
        for idx, slot in live:
            if slot.stream.cancelled:
                self._evict(idx, reason="disconnect")
        with self._cv:
            live = sorted(self._slots.items())
        if not live:
            return
        S, L = self.predictor.num_slots, self.predictor.max_len
        tokens = np.zeros(S, np.int32)
        positions = np.zeros(S, np.int32)
        paged = getattr(self.predictor, "paged", False)
        if paged:
            lens = np.zeros(S, np.int32)
        else:
            pos_onehot = np.zeros((S, L), np.float32)
            attn_mask = np.zeros((S, L), np.float32)
        for idx, slot in live:
            tokens[idx] = slot.last_token
            positions[idx] = slot.pos
            if paged:
                lens[idx] = slot.pos + 1
            else:
                pos_onehot[idx, slot.pos] = 1.0
                attn_mask[idx, :slot.pos + 1] = 1.0
        _profiler.runtime_metrics.bucket("gen.slot_occupancy", len(live))
        t0 = time.perf_counter()
        if paged:
            logits = self.predictor.decode_step(tokens, positions,
                                                lens=lens)
        else:
            logits = self.predictor.decode_step(tokens, positions,
                                                pos_onehot, attn_mask)
        now = time.perf_counter()
        _profiler.runtime_metrics.observe("gen.decode_step_seconds",
                                          now - t0)
        for idx, slot in live:
            stream = slot.stream
            token = int(np.argmax(logits[idx]))
            slot.steps += 1
            slot.pos += 1
            slot.last_token = token
            _profiler.runtime_metrics.inc("gen.tokens")
            _profiler.runtime_metrics.observe("gen.intertoken_seconds",
                                              now - slot.last_emit_t)
            slot.last_emit_t = now
            stream.emit(token)
            done = 1 + slot.steps
            if token == stream.eos_id:
                self._finish(stream, "eos")
                self._evict(idx)
            elif done >= stream.max_new_tokens or slot.pos >= L:
                self._finish(stream, "length")
                self._evict(idx)
