"""Iteration-level (continuous-batching) generation scheduler (the
continuous-batching core of ``paddle_tpu.gen.scheduler``).

Between decode steps the scheduler admits queued requests into free
KV-cache slots (prefill interleaved with decode), evicts finished
sequences (EOS / length cap / client disconnect), and streams each
request's tokens out as they are produced.  A full admission queue
raises :class:`QueueFull`, a request whose deadline expires while queued
fails with :class:`DeadlineExceeded` without taking a slot, and an
unexpected scheduler-thread crash fails every live stream with
:class:`BatcherCrashed` and restarts the thread within a bounded
consecutive-crash budget (after which :attr:`GenScheduler.failed` holds
the crash).
"""

from __future__ import annotations

import logging
import threading
import time

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["GenScheduler", "GenStream", "QueueFull", "BatcherCrashed",
           "DeadlineExceeded"]


class QueueFull(RuntimeError):
    """The admission queue is full: shed the request (retryable)."""


class BatcherCrashed(RuntimeError):
    """The scheduler thread crashed; the request was aborted (retryable)."""


class DeadlineExceeded(TimeoutError):
    """The request's deadline expired before it was admitted."""


class GenStream:
    """One request's token stream, produced by the scheduler thread and
    consumed by any iterator."""

    def __init__(self, prompt, max_new_tokens, eos_id, deadline_at):
        self.prompt = list(prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.deadline_at = deadline_at      # monotonic, None = unbounded
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
        """Mark the consumer gone: the scheduler reclaims the slot on its
        next iteration."""
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
        """Yield token ids until the stream finishes; raises the stream's
        error if it failed."""
        while True:
            kind, value = self.next_event()
            if kind == "token":
                yield value
            elif kind == "done":
                return
            else:
                raise value


class _Slot:
    __slots__ = ("stream", "pos", "steps", "last_token")

    def __init__(self, stream, prompt_len, first_token):
        self.stream = stream
        # the NEXT decode step consumes first_token and writes its K/V
        # at position prompt_len
        self.pos = prompt_len
        self.steps = 0
        self.last_token = first_token


class GenScheduler:
    """Continuous-batching decode loop over a
    :class:`~paddle_tpu_torch.gen.predictor.GenPredictor`."""

    def __init__(self, predictor, queue_size=64, max_restarts=5):
        self.predictor = predictor
        self.queue_size = max(1, int(queue_size))
        self.max_restarts = max(0, int(max_restarts))
        self._queue = []
        self._slots = {}          # slot index -> _Slot
        self._free = list(range(predictor.num_slots))
        self._cv = threading.Condition()
        self._closed = False
        self._restarts = 0
        self._crashes = 0
        self._failed = None
        self._thread = self._spawn_thread()

    # -- public surface ----------------------------------------------------
    @property
    def failed(self):
        """Terminal crash once the consecutive-restart budget is spent
        (None while alive)."""
        with self._cv:
            return self._failed

    @property
    def crashes(self):
        """Scheduler-thread crashes over the scheduler's lifetime."""
        with self._cv:
            return self._crashes

    def submit(self, prompt, max_new_tokens=16, deadline=None,
               eos_id=None):
        """Enqueue one generation request; returns a :class:`GenStream`.

        ``deadline``: seconds of admission budget (expiry while queued
        fails the stream with DeadlineExceeded without taking a slot).
        ``eos_id`` overrides the bundle's EOS token for this request."""
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
        deadline_at = None if deadline is None \
            else time.monotonic() + float(deadline)
        stream = GenStream(prompt, max_new_tokens, eos, deadline_at)
        with self._cv:
            if self._closed:
                raise RuntimeError("generation scheduler is shut down")
            if self._failed is not None:
                raise BatcherCrashed(
                    f"generation scheduler is down after "
                    f"{self._restarts} restarts: {self._failed}")
            if len(self._queue) >= self.queue_size:
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
        # the wholesale slot reset above must also reset the page pool,
        # or a crash strands every live allocation
        if getattr(self.predictor, "paged", False):
            self.predictor.free_all_pages()
        if restart:
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
                        not self._closed:
                    self._cv.wait(0.05)
                if self._closed:
                    queued, self._queue = self._queue, []
                    active, self._slots = list(self._slots.items()), {}
                    break
            self._sweep_queue()
            self._admit()
            if self._slots:
                self._decode_iteration()
                # a completed iteration is forward progress: the restart
                # budget bounds CONSECUTIVE crashes, not lifetime ones
                with self._cv:
                    self._restarts = 0
        # shutdown discards the slots wholesale; return their pages so a
        # later scheduler over the SAME predictor starts with a full pool
        if getattr(self.predictor, "paged", False):
            self.predictor.free_all_pages()
        err = RuntimeError("generation scheduler shut down")
        for _, slot in active:
            slot.stream.fail(err)
        for stream in queued:
            stream.fail(err)

    def _sweep_queue(self):
        """Fail expired/abandoned QUEUED requests immediately."""
        now = time.monotonic()
        with self._cv:
            keep = []
            for stream in self._queue:
                if stream.cancelled:
                    stream.finish("disconnect")
                    continue
                if stream.deadline_at is not None and \
                        now > stream.deadline_at:
                    stream.fail(DeadlineExceeded(
                        "deadline expired while queued for admission"))
                    continue
                keep.append(stream)
            self._queue = keep

    def _admit(self):
        """Move queued requests into free slots."""
        while True:
            with self._cv:
                if not self._queue or not self._free:
                    return
                if getattr(self.predictor, "paged", False):
                    # page-aware admission: a request is admitted only
                    # when the pool can cover its WHOLE length horizon,
                    # so decode growth never fails mid-request
                    head = self._queue[0]
                    need = self.predictor.pages_needed(
                        len(head.prompt), head.max_new_tokens)
                    if need > self.predictor.free_pages:
                        return
                stream = self._queue.pop(0)
                slot_idx = self._free.pop(0)
            admitted = False
            try:
                admitted = self._prefill_into(slot_idx, stream)
            finally:
                if not admitted:
                    with self._cv:
                        self._free.append(slot_idx)

    def _prefill_into(self, slot_idx, stream):
        """Prefill one request and seed its slot; returns True when the
        slot stays occupied (request still generating).  A failed prefill
        or page allocation fails only its own stream."""
        try:
            logits, kv = self.predictor.prefill(stream.prompt)
        except BaseException as e:
            stream.fail(e)
            return False
        first = int(np.argmax(logits))
        stream.emit(first)
        prompt_len = len(stream.prompt)
        if first == stream.eos_id:
            return self._finish(stream, "eos")
        if stream.max_new_tokens <= 1 or \
                prompt_len >= self.predictor.max_len:
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
        return False

    def _evict(self, slot_idx, reason=None):
        # runs only on the scheduler thread; the slot is returned to
        # `_free` LAST, after its pages are back in the pool
        with self._cv:
            slot = self._slots.get(slot_idx)
            if slot is None:
                return
        if reason == "disconnect":
            self.predictor.clear_slot(slot_idx)
            slot.stream.finish("disconnect")
        if getattr(self.predictor, "paged", False):
            self.predictor.free_slot_pages(slot_idx)
        with self._cv:
            self._slots.pop(slot_idx, None)
            self._free.append(slot_idx)

    def _decode_iteration(self):
        """One token for every live slot: sweep disconnects, build the
        step feeds, dispatch, scatter tokens."""
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
        if paged:
            logits = self.predictor.decode_step(tokens, positions,
                                                lens=lens)
        else:
            logits = self.predictor.decode_step(tokens, positions,
                                                pos_onehot, attn_mask)
        for idx, slot in live:
            stream = slot.stream
            token = int(np.argmax(logits[idx]))
            slot.steps += 1
            slot.pos += 1
            slot.last_token = token
            stream.emit(token)
            if token == stream.eos_id:
                self._finish(stream, "eos")
                self._evict(idx)
            elif 1 + slot.steps >= stream.max_new_tokens or slot.pos >= L:
                self._finish(stream, "length")
                self._evict(idx)
