"""Reader-as-IR ops: the input pipeline expressed in the program (the
port's copy of ``paddle_tpu.ops.reader_ops``; reference
``paddle/fluid/operators/reader/`` — create_recordio_file_reader,
open_files, create_{shuffle,batch,double_buffer,multi_pass,threaded}_reader,
create_random_data_generator — and ``reader_op_registry.h``).

Execution model, as in the JAX package: reader ops are **executor
pre-pass ops**.  Before each dispatch the Executor walks the block,
(idempotently) constructs reader objects for creation ops, pops one batch
from each ``read`` op's reader on the host, and injects the arrays into
the feed set.  The step (a CUDA graph on the card) then consumes them as
ordinary feeds, so batches of the same shapes share one signature.  The
double-buffer reader's background thread decodes batch N+1 and, on the
card, copies it from pinned host memory to the device on a side stream
while batch N computes (the purpose of
``create_double_buffer_reader_op.cc``); the consumer's stream waits on
the copy's event before it reads the batch.

Shuffles and the random generator draw from ``numpy.random.RandomState``
seeded as the JAX package seeds them, so a pipeline yields the same
batches in the same order in both packages.
"""

from __future__ import annotations

import pickle
import queue
import threading

import numpy as np

from paddle_tpu_torch.ops.registry import register_op, ShapeInferenceSkip

# op types handled by the executor pre-pass (and skipped by lowering)
READER_CREATE_OPS = frozenset({
    "create_recordio_file_reader", "open_files",
    "create_random_data_generator", "create_shuffle_reader",
    "create_batch_reader", "create_double_buffer_reader",
    "create_multi_pass_reader", "create_threaded_reader",
})
READER_OPS = READER_CREATE_OPS | {"read"}


class EOFException(Exception):
    """Raised by ``read`` when the reader is exhausted (reference
    ``paddle/fluid/framework/reader.h`` EOF semantics); call
    ``reader.reset()`` and re-run."""


def _split_shapes(shape_concat, ranks):
    shapes, pos = [], 0
    for r in ranks:
        shapes.append(tuple(int(d) for d in shape_concat[pos:pos + r]))
        pos += r
    return shapes


# ---------------------------------------------------------------------------
# reader objects (host-side state, stored in the Scope under the reader
# variable's name — the ReaderHolder analog)
# ---------------------------------------------------------------------------

class _ReaderBase:
    """Subclasses implement ``_next``/``_reset``; the base owns the
    pushback buffer (batches returned by the executor when a multi-step
    pull hits EOF part-way — see ``executor._run_reader_ops``)."""

    _pushback = None

    def next(self):
        if self._pushback:
            return self._pushback.pop()
        return self._next()

    def unget(self, batch):
        """Return an already-pulled batch; served (LIFO) before _next."""
        if self._pushback is None:
            self._pushback = []
        self._pushback.append(batch)

    def reset(self):
        """Rewind.  Pushed-back batches (pulled but never consumed — a
        run_steps call that hit EOF mid-pull) SURVIVE the reset and are
        served before the rewound stream, so no data is silently lost."""
        self._reset()

    def _next(self):
        raise NotImplementedError

    def _reset(self):
        raise NotImplementedError


class RecordIOReader(_ReaderBase):
    """One pickled sample tuple per record (see
    ``recordio_writer.convert_reader_to_recordio_file``)."""

    def __init__(self, filename, shapes, dtypes):
        from paddle_tpu_torch.recordio_writer import RecordIOScanner
        self._scanner = RecordIOScanner(filename)
        self.shapes = shapes
        self.dtypes = dtypes
        self._it = iter(self._scanner)

    def _coerce(self, sample):
        out = []
        for i, item in enumerate(sample):
            dt = self.dtypes[i] if i < len(self.dtypes) else None
            arr = np.asarray(item, dtype=dt)
            if i < len(self.shapes):
                want = self.shapes[i]
                if want and all(d > 0 for d in want) and \
                        arr.shape != tuple(want):
                    arr = arr.reshape(want)
            out.append(arr)
        return tuple(out)

    def _next(self):
        rec = next(self._it)  # StopIteration -> caller maps to EOF
        return self._coerce(pickle.loads(rec))

    def _reset(self):
        self._it = iter(self._scanner)


class FilesReader(RecordIOReader):
    """Multi-file reader over the native threaded loader
    (reference ``open_files_op.cc``)."""

    def __init__(self, filenames, shapes, dtypes, thread_num=2,
                 buffer_size=64):
        self.shapes = shapes
        self.dtypes = dtypes
        self._filenames = list(filenames)
        self._thread_num = thread_num
        self._buffer_size = buffer_size
        self._loader = None
        self.reset()

    def _reset(self):
        from paddle_tpu_torch.recordio_writer import (RecordIOLoader,
                                                     RecordIOScanner)
        if self._loader is not None:
            self._loader.close()
        try:
            self._loader = RecordIOLoader(self._filenames,
                                          n_threads=self._thread_num,
                                          capacity=self._buffer_size)
            self._it = iter(self._loader)
        except RuntimeError:
            # no native toolchain: chain plain scanners
            def chain():
                for f in self._filenames:
                    yield from RecordIOScanner(f)
            self._loader = None
            self._it = chain()


class RandomDataGenerator(_ReaderBase):
    """reference ``create_random_data_generator_op.cc``: endless uniform
    [low, high) float batches of the declared shapes."""

    def __init__(self, shapes, low, high, seed=0):
        self.shapes = shapes
        self.low, self.high = low, high
        self._rng = np.random.RandomState(seed or None)

    def _next(self):
        return tuple(self._rng.uniform(self.low, self.high,
                                       size=s).astype("float32")
                     for s in self.shapes)

    def _reset(self):
        pass


class ShuffleReader(_ReaderBase):
    def __init__(self, underlying, buffer_size, seed=0):
        self.u = underlying
        self.buffer_size = buffer_size
        self._rng = np.random.RandomState(seed or None)
        self._buf = []

    def _fill(self):
        while len(self._buf) < self.buffer_size:
            try:
                self._buf.append(self.u.next())
            except StopIteration:
                break

    def _next(self):
        self._fill()
        if not self._buf:
            raise StopIteration
        i = self._rng.randint(len(self._buf))
        self._buf[i], self._buf[-1] = self._buf[-1], self._buf[i]
        return self._buf.pop()

    def _reset(self):
        self._buf = []
        self.u.reset()


class BatchReader(_ReaderBase):
    """Stacks ``batch_size`` samples per slot.  Deviation from the
    reference BatchReader: the trailing partial batch is DROPPED (a smaller
    final batch would be a new static shape → one extra XLA compile)."""

    def __init__(self, underlying, batch_size):
        self.u = underlying
        self.batch_size = batch_size

    def _next(self):
        samples = []
        for _ in range(self.batch_size):
            try:
                samples.append(self.u.next())
            except StopIteration:
                break
        if len(samples) < self.batch_size:
            raise StopIteration
        return tuple(np.stack([s[i] for s in samples])
                     for i in range(len(samples[0])))

    def _reset(self):
        self.u.reset()


class MultiPassReader(_ReaderBase):
    def __init__(self, underlying, pass_num):
        self.u = underlying
        self.pass_num = pass_num
        self._pass = 0

    def _next(self):
        try:
            return self.u.next()
        except StopIteration:
            self._pass += 1
            if self._pass >= self.pass_num:
                raise
            self.u.reset()
            return self.u.next()

    def _reset(self):
        self._pass = 0
        self.u.reset()


class ThreadedReader(_ReaderBase):
    """Thread-safe wrapper (reference create_threaded_reader_op.cc)."""

    def __init__(self, underlying):
        self.u = underlying
        self._lock = threading.Lock()

    def _next(self):
        with self._lock:
            return self.u.next()

    def _reset(self):
        with self._lock:
            self.u.reset()


class _Staged:
    """A batch copied to the card on the reader's side stream: its device
    tensors and the event recorded after the copies."""

    __slots__ = ("tensors", "event")

    def __init__(self, tensors, event):
        self.tensors = tensors
        self.event = event


def _pinned(arr):
    """``arr`` as a tensor in pinned host memory (the source of an
    asynchronous copy to the card)."""
    import torch
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).pin_memory()


class DoubleBufferReader(_ReaderBase):
    """Background-thread prefetch + eager host→device transfer: batch N+1
    is decoded and copied while batch N computes (reference
    ``create_double_buffer_reader_op.cc``).

    On the card (``device`` a CUDA device) the worker thread copies each
    batch from pinned host memory on a side stream and records an event;
    :meth:`next` makes the consumer's current stream wait on that event
    and marks the tensors used by that stream (``record_stream``), so the
    caching allocator does not hand their blocks to the next copy while
    a step (a graph replay's feed copy) still reads them.  Elsewhere it
    is a plain prefetch thread of host batches."""

    _SENTINEL = object()

    def __init__(self, underlying, device=None, capacity=4):
        self.u = underlying
        self.device = device
        self.capacity = capacity
        self._stream = None
        if device is not None and getattr(device, "type", None) == "cuda":
            import torch
            self._stream = torch.cuda.Stream(device)
        self._q = None
        self._thread = None
        self._start()

    def _stage(self, batch):
        """Worker side: the batch's copy to the card, queued on the side
        stream (a host batch unchanged off the card)."""
        if self._stream is None:
            return batch
        import torch
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            tensors = tuple(_pinned(b).to(self.device, non_blocking=True)
                            for b in batch)
            event = torch.cuda.Event()
            event.record(self._stream)
        return _Staged(tensors, event)

    def _start(self):
        self._q = queue.Queue(maxsize=self.capacity)
        self._stop = threading.Event()

        def worker(q, stop):
            # q/stop are LOCALS: a worker that outlives a reset can only
            # ever touch its own (abandoned) queue and stop event
            while not stop.is_set():
                try:
                    batch = self._stage(self.u.next())
                except StopIteration:
                    q.put(self._SENTINEL)
                    return
                except Exception as e:  # surface errors on the consumer
                    q.put(e)
                    return
                q.put(batch)

        self._thread = threading.Thread(target=worker,
                                        args=(self._q, self._stop),
                                        daemon=True)
        self._thread.start()

    def _next(self):
        item = self._q.get()
        if item is self._SENTINEL:
            # sticky EOF: the worker exited after enqueueing one sentinel;
            # re-enqueue so a retrying caller gets EOF again, not a hang
            self._q.put(self._SENTINEL)
            raise StopIteration
        if isinstance(item, Exception):
            self._q.put(item)
            raise item
        if isinstance(item, _Staged):
            import torch
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(item.event)
            for t in item.tensors:
                t.record_stream(stream)
            return item.tensors
        return item

    def _reset(self):
        self._stop.set()
        try:  # drain so the worker can exit a blocked put
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
        if self._thread.is_alive():
            # resetting the underlying reader under a live worker would
            # corrupt its stream — fail loudly instead
            raise RuntimeError(
                "double-buffer worker did not stop within 5s (blocked in "
                "underlying reader?); cannot safely reset")
        self.u.reset()
        self._start()


# ---------------------------------------------------------------------------
# builders: op desc -> reader object (executor pre-pass)
# ---------------------------------------------------------------------------

def build_reader(op, scope, device=None):
    """The reader object of creation op ``op`` (its underlying reader
    found in ``scope``); ``device``: the executor's torch device, where a
    double buffer stages its batches."""
    t = op.type
    a = op.attrs

    def underlying():
        name = op.input("UnderlyingReader")[0]
        u = scope.find_var(name)
        if u is None:
            raise RuntimeError(f"underlying reader {name!r} not created")
        return u

    if t == "create_recordio_file_reader":
        shapes = _split_shapes(a.get("shape_concat", []), a.get("ranks", []))
        return RecordIOReader(a["filename"], shapes, a.get("dtypes", []))
    if t == "open_files":
        shapes = _split_shapes(a.get("shape_concat", []), a.get("ranks", []))
        return FilesReader(a["file_names"], shapes, a.get("dtypes", []),
                           a.get("thread_num", 2), a.get("buffer_size", 64))
    if t == "create_random_data_generator":
        shapes = _split_shapes(a.get("shape_concat", []), a.get("ranks", []))
        return RandomDataGenerator(shapes, a.get("min", 0.0),
                                   a.get("max", 1.0), a.get("seed", 0))
    if t == "create_shuffle_reader":
        return ShuffleReader(underlying(), a.get("buffer_size", 512),
                             a.get("seed", 0))
    if t == "create_batch_reader":
        return BatchReader(underlying(), a["batch_size"])
    if t == "create_multi_pass_reader":
        return MultiPassReader(underlying(), a.get("pass_num", 1))
    if t == "create_threaded_reader":
        return ThreadedReader(underlying())
    if t == "create_double_buffer_reader":
        return DoubleBufferReader(underlying(), device=device,
                                  capacity=a.get("capacity", 4))
    raise NotImplementedError(f"unknown reader op {t!r}")


# ---------------------------------------------------------------------------
# lowerings — no-ops: the pre-pass did the work (creation ops bind scope
# state; read outputs arrive as feeds).  The executor skips these ops
# (``executor._SKIP_OPS``); the lowerings serve walkers that lower every
# registered op.
# ---------------------------------------------------------------------------

def _infer_skip(op, block):
    raise ShapeInferenceSkip()


def _noop_lower(ctx):
    pass


for _t in sorted(READER_CREATE_OPS):
    register_op(_t, infer_shape=_infer_skip, no_gradient=True)(_noop_lower)


@register_op("read", infer_shape=_infer_skip, no_gradient=True)
def read_lower(ctx):
    # outputs were injected as feeds by the executor pre-pass; verify
    for n in ctx.op.output("Out"):
        if n not in ctx.env:
            raise RuntimeError(
                f"read op output {n!r} missing — the executor reader "
                f"pre-pass did not run for this block")
