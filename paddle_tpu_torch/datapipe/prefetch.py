"""Async device prefetch: the stage that hides host time (the port's
counterpart of ``paddle_tpu.datapipe.prefetch``).

A background thread pulls batches from upstream, copies them to the
device, and parks them in a bounded queue, so that the host's decode,
collate and transfer of batch N+1 overlap the device's compute of batch
N (the double-buffer discipline of the reference's
``create_double_buffer_reader_op.cc``, generalized to a depth-``depth``
queue).  The consumer-side ``datapipe.prefetch.stall_seconds`` series is
the input-starvation signal: near zero means the pipeline keeps the
card fed; large means add map workers or prefetch depth.

On the card (the default device, ``cuda:0``; the stage raises without
CUDA unless given the CPU) the worker copies each batch from pinned host
memory with ``non_blocking=True`` on a CUDA stream of its own and
records an event after the copy.  The consumer makes its current stream
wait on that event before it yields the batch, so a step that reads the
batch (a graph replay copies its feeds into the graph's static buffers
on the current stream) never sees a copy that has not finished, and
marks each tensor used by that stream (``record_stream``), so the
caching allocator does not hand the block back to the copy stream while
the step still reads it.  On the CPU the batch becomes CPU tensors.

Quiesce semantics match the other threaded stages: ``state_dict()``
stops the thread and drains queued batches into a pending buffer (device
tensors are copied back to host numpy for pickling, after their copy's
event), so a checkpoint taken between steps loses nothing.  A batch
already in the worker's hands when the stop lands is stashed into an
overflow slot and folded in after the queued (older) batches: order is
preserved, no sample is dropped or replayed.  Restored pending batches
are placed on the device again before they are yielded.

The staged batches on the card are the HBM census's ``prefetch``
collection (``obs.perf.register_hbm_provider``), unregistered when the
stage is collected.
"""

from __future__ import annotations

import collections
import queue
import threading
import time

import numpy as np

from paddle_tpu_torch.datapipe.core import Stage, _Raised
from paddle_tpu_torch.obs.trace import record_span
from paddle_tpu_torch.profiler import runtime_metrics

__all__ = ["DevicePrefetch"]

_EOF = object()


def _resolve_device(device):
    """``device`` (None = ``cuda:0``, a place, a ``torch.device`` or its
    name) as a ``torch.device``; raises when it is a card and CUDA is
    absent."""
    import torch
    from paddle_tpu_torch.place import Place, default_place
    if device is None:
        device = default_place()
    if isinstance(device, Place):
        return device.torch_device()
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"DevicePrefetch({device}): CUDA is not available (pass "
                f"device='cpu' to prefetch on the CPU)")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def _values(batch):
    if isinstance(batch, dict):
        return list(batch.values())
    if isinstance(batch, (tuple, list)):
        return list(batch)
    return [batch]


def _rebuild(batch, values):
    if isinstance(batch, dict):
        return dict(zip(batch, values))
    if isinstance(batch, (tuple, list)):
        return tuple(values)
    return values[0]


def _place(v, device):
    """A batch value as a tensor on ``device`` (a tensor there as it is;
    never a view of the caller's array)."""
    import torch
    from paddle_tpu_torch.convert import to_tensor
    if isinstance(v, torch.Tensor) and v.device == device:
        return v
    return to_tensor(v, device)


class _Staged:
    """A batch whose copy to the card was queued on the copy stream, and
    the event recorded after it."""

    __slots__ = ("batch", "event")

    def __init__(self, batch, event):
        self.batch = batch
        self.event = event


def _stage_on(batch, device, stream):
    """Worker side: ``batch``'s copy to the card queued on ``stream``
    from pinned host memory."""
    import torch
    from paddle_tpu_torch.ops.reader_ops import _pinned
    with torch.cuda.device(device), torch.cuda.stream(stream):
        out = [_pinned(np.asarray(v)).to(device, non_blocking=True)
               for v in _values(batch)]
        event = torch.cuda.Event()
        event.record(stream)
    return _Staged(_rebuild(batch, out), event)


def _to_host(batch):
    from paddle_tpu_torch.convert import to_numpy
    if isinstance(batch, _Staged):
        batch.event.synchronize()
        batch = batch.batch
    return _rebuild(batch, [to_numpy(v) for v in _values(batch)])


class DevicePrefetch(Stage):
    """Prefetch ``depth`` batches onto ``device`` (default ``cuda:0``, a
    place, a ``torch.device`` or its name) on a background thread."""

    kind = "prefetch"

    def __init__(self, upstream, depth=2, device=None, name=None):
        super().__init__(upstream, name or "prefetch")
        if depth < 1:
            raise ValueError("prefetch depth must be >= 1")
        self.depth = int(depth)
        self.device = _resolve_device(device)
        self._stream = None      # the copy stream, made at first use
        self._q = None
        self._thread = None
        self._stop = None
        self._up_iter = None
        self._pending = collections.deque()
        self._overflow = []      # worker's in-hand items at quiesce time
        self._eof_pending = False
        # HBM census: staged (queued + pending) device batches are the
        # `prefetch` collection, weakref'd so a dropped stage releases
        import weakref
        from paddle_tpu_torch.obs import perf as _perf
        ref = weakref.ref(self)
        self._hbm_token = _perf.register_hbm_provider(
            "prefetch", lambda: (ref().device_buffers()
                                 if ref() is not None else ()))
        # a per-epoch rebuilt pipeline must not leak dead providers
        weakref.finalize(self, _perf.unregister_hbm_provider,
                         self._hbm_token)

    def device_buffers(self):
        """Flat snapshot of the CUDA tensors staged in this stage (queued
        + pending batches): the census's ``prefetch`` collection.
        Pending batches restored by ``load_state_dict`` are host numpy
        until the next iterate places them again; host memory is not
        the card's, so only CUDA tensors count."""
        import torch
        batches = list(self._pending)
        q = self._q
        if q is not None:
            with q.mutex:
                batches.extend(q.queue)
        out = []
        for b in batches:
            if isinstance(b, _Staged):
                b = b.batch
            elif b is _EOF or isinstance(b, _Raised):
                continue
            out.extend(v for v in _values(b)
                       if isinstance(v, torch.Tensor) and v.is_cuda)
        return out

    # -- placement ------------------------------------------------------
    def _stage(self, batch):
        """Worker side: the batch's copy to the device (queued on the copy
        stream on the card)."""
        if self.device.type == "cuda":
            if self._stream is None:
                import torch
                self._stream = torch.cuda.Stream(self.device)
            return _stage_on(batch, self.device, self._stream)
        return _rebuild(batch, [_place(v, self.device)
                                for v in _values(batch)])

    def _ready(self, item):
        """Consumer side: a staged batch made safe to read on the current
        stream (it waits on the copy's event; each tensor is marked used
        by it), or a restored host batch placed on the device (on the
        card by a copy on the current stream)."""
        if not isinstance(item, _Staged):
            return _rebuild(item, [_place(v, self.device)
                                   for v in _values(item)])
        import torch
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(item.event)
        for v in _values(item.batch):
            v.record_stream(stream)
        return item.batch

    # -- producer -------------------------------------------------------
    def _ensure_thread(self):
        if self._thread is not None:
            return
        self._q = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._up_iter = iter(self._upstream)
        up_iter = self._up_iter

        def deliver(q, stop, overflow, item):
            """Queue ``item``; once stopped, stash it in the overflow
            slot instead (never drop: the item was already pulled from
            upstream, so upstream's position has moved past it)."""
            while True:
                if stop.is_set():
                    overflow.append(item)
                    return False
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue

        def worker(q, stop, overflow):
            try:
                while not stop.is_set():
                    t0 = time.perf_counter()
                    try:
                        batch = self._pull(up_iter)
                    except StopIteration:
                        deliver(q, stop, overflow, _EOF)
                        return
                    dev = self._stage(batch)
                    dt = time.perf_counter() - t0
                    runtime_metrics.observe(
                        self._metrics + ".fill_seconds", dt)
                    record_span(self._metrics + ".fill", t0, dt)
                    if not deliver(q, stop, overflow, dev):
                        return
                    runtime_metrics.set_gauge(
                        self._metrics + ".queue_depth", q.qsize())
            except BaseException as e:
                deliver(q, stop, overflow, _Raised(e))

        self._thread = threading.Thread(
            target=worker, args=(self._q, self._stop, self._overflow),
            daemon=True, name=f"datapipe-{self.name}")
        self._thread.start()

    # -- consumer -------------------------------------------------------
    def _iterate(self):
        while True:
            while self._pending:
                item = self._pending.popleft()
                if isinstance(item, _Raised):
                    raise item.exc
                self._count()
                # pending batches restored by load_state_dict are host
                # numpy: place them so that the device contract holds on
                # the steps after a restore too
                yield self._ready(item)
            if self._eof_pending:
                self._eof_pending = False
                return
            self._ensure_thread()
            t0 = time.perf_counter()
            item = self._q.get()
            dt = time.perf_counter() - t0
            runtime_metrics.observe(self._metrics + ".stall_seconds", dt)
            record_span(self._metrics + ".stall", t0, dt)
            runtime_metrics.set_gauge(self._metrics + ".queue_depth",
                                      self._q.qsize())
            if item is _EOF:
                self._shutdown()      # joins the (exiting) thread
                self._eof_pending = False
                return
            if isinstance(item, _Raised):
                self._shutdown()
                raise item.exc
            self._count()
            yield self._ready(item)

    # -- quiesce --------------------------------------------------------
    def _shutdown(self):
        if self._thread is None:
            return
        self._stop.set()
        # drain while the thread winds down so a put blocked on a full
        # queue completes; queued items are OLDER than the worker's
        # in-hand overflow item, so the queue folds into pending first
        while self._thread.is_alive():
            self._drain_into_pending()
            self._thread.join(timeout=0.05)
        self._drain_into_pending()
        self._thread = None
        for item in self._overflow:
            if item is _EOF:
                self._eof_pending = True
            else:
                self._pending.append(item)
        del self._overflow[:]
        if self._up_iter is not None:
            self._up_iter.close()
            self._up_iter = None

    def _drain_into_pending(self):
        try:
            while True:
                item = self._q.get_nowait()
                if item is _EOF:
                    self._eof_pending = True
                else:
                    self._pending.append(item)
        except queue.Empty:
            pass

    def _state(self):
        pending = []
        for item in self._pending:
            if isinstance(item, _Raised):
                raise RuntimeError(
                    f"prefetch stage {self.name!r} holds a pending "
                    f"worker exception; consume (and handle) it before "
                    f"checkpointing")
            pending.append(_to_host(item))
        return {"pending": pending, "eof_pending": self._eof_pending}

    def _load_state(self, state):
        self._pending = collections.deque(state["pending"])
        self._eof_pending = bool(state["eof_pending"])

    def _reset_local(self):
        self._pending.clear()
        self._eof_pending = False

