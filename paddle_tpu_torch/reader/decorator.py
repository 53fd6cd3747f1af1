"""Reader decorators (the port's copy of ``paddle_tpu.reader.decorator``).

A *reader* is a nullary callable returning an iterable of samples — the
reference's data-pipeline protocol (``python/paddle/reader/decorator.py``
declares the same surface).  Each decorator here wraps one reader (or
several) and returns a new reader; the threaded ones (``buffered``,
``xmap_readers``) use a shared ``_STOP`` sentinel plus bounded queues,
and ordered ``xmap_readers`` re-sequences results with a heap on the
consumer side instead of busy-waiting in the workers.
"""

from __future__ import annotations

import heapq
import itertools
import queue
import random
import threading

from paddle_tpu_torch.fault import chaos as _chaos

__all__ = ["map_readers", "buffered", "compose", "chain", "shuffle",
           "firstn", "xmap_readers", "cache"]

# end-of-stream marker shared by the threaded decorators (identity
# compared, so samples can be anything — including numpy arrays)
_STOP = object()


def _put_unless(abandoned, q, item, timeout=0.1):
    """Queue ``item``, polling so a producer blocked on a full queue
    notices the consumer abandoning the stream; False once abandoned."""
    while not abandoned.is_set():
        try:
            q.put(item, timeout=timeout)
            return True
        except queue.Full:
            continue
    return False


class _Raised:
    """A producer/worker exception, carried through the queue so it
    re-raises on the CONSUMER side instead of vanishing in a daemon
    thread (which would read as a clean, silently-truncated stream)."""

    def __init__(self, exc):
        self.exc = exc


def map_readers(func, *readers):
    """``func`` applied elementwise across the readers' parallel streams."""

    def _read():
        yield from map(func, *(r() for r in readers))

    return _read


def shuffle(reader, buf_size):
    """Local shuffling: collect a window of ``buf_size`` samples, emit it
    in random order, repeat; the tail window is shuffled too."""

    def _read():
        window = []
        for sample in reader():
            window.append(sample)
            if len(window) == buf_size:
                random.shuffle(window)
                yield from window
                window = []
        random.shuffle(window)
        yield from window

    return _read


def chain(*readers):
    """All samples of the first reader, then the second, and so on."""

    def _read():
        for r in readers:
            yield from r()

    return _read


class ComposeNotAligned(ValueError):
    pass


def compose(*readers, **kwargs):
    """Zip several readers into one: each output sample is the
    concatenation of one (tuple-ified) sample from every input.  With
    ``check_alignment=True`` (default) a length mismatch raises
    :class:`ComposeNotAligned`; otherwise the shortest stream wins."""
    check_alignment = kwargs.pop("check_alignment", True)

    def _as_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def _read():
        streams = [r() for r in readers]
        if check_alignment:
            groups = itertools.zip_longest(*streams, fillvalue=_STOP)
        else:
            groups = zip(*streams)
        for group in groups:
            if any(s is _STOP for s in group):
                raise ComposeNotAligned(
                    "composed readers produced streams of different "
                    "lengths")
            yield tuple(itertools.chain.from_iterable(
                map(_as_tuple, group)))

    return _read


def buffered(reader, size):
    """Decouple producer from consumer: a daemon thread pumps the wrapped
    reader into a queue bounded at ``size`` samples, hiding producer
    latency behind consumption.

    A consumer that abandons iteration early (breaks out, drops the
    generator) closes it, which flips the ``abandoned`` event — the pump
    thread sees it at its next (timeout-polled) ``put`` and exits
    instead of blocking forever on the full queue."""

    def _read():
        q = queue.Queue(maxsize=size)
        abandoned = threading.Event()

        def pump():
            try:
                for sample in reader():
                    _chaos.fire("reader.pump")
                    if not _put_unless(abandoned, q, sample):
                        return
            except BaseException as e:  # re-raised consumer-side
                _put_unless(abandoned, q, _Raised(e))
            else:
                _put_unless(abandoned, q, _STOP)

        threading.Thread(target=pump, daemon=True).start()
        try:
            while True:
                sample = q.get()
                if sample is _STOP:
                    return
                if isinstance(sample, _Raised):
                    raise sample.exc
                yield sample
        finally:
            abandoned.set()
            try:  # unblock a put stuck on the (bounded) queue right now
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass

    return _read


def firstn(reader, n):
    """Only the first ``n`` samples."""

    def _read():
        return itertools.islice(reader(), n)

    return _read


def cache(reader):
    """Materialize the stream on first full pass; replay from memory on
    every later pass.  (A pass abandoned midway is not cached.)"""
    memo = []
    complete = [False]

    def _read():
        if complete[0]:
            yield from memo
            return
        fresh = []
        for sample in reader():
            fresh.append(sample)
            yield sample
        memo[:] = fresh
        complete[0] = True

    return _read


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Run ``mapper`` over the stream on ``process_num`` worker threads.

    Every sample is tagged with its position; with ``order=True`` the
    consumer re-sequences results through a min-heap keyed on that
    position (workers never wait on each other).  Total in-flight
    samples — queues, worker hands, and the re-sequencing heap — are
    bounded by a sliding window of ``2 * buffer_size + process_num``
    un-yielded samples, enforced at the feeder.  Exceptions from the
    reader or the mapper re-raise on the consumer side.
    """

    def _read():
        inq = queue.Queue(maxsize=buffer_size)
        outq = queue.Queue()     # bounded by the window semaphore
        window = threading.Semaphore(2 * buffer_size + process_num)
        # flipped when the consumer abandons the generator: the feeder's
        # window.acquire/inq.put and the workers' loops poll it so no
        # thread is left blocked forever on a stream nobody reads
        abandoned = threading.Event()

        def feed():
            try:
                for tagged in enumerate(reader()):
                    while not window.acquire(timeout=0.1):
                        if abandoned.is_set():
                            return
                    if not _put_unless(abandoned, inq, tagged):
                        return
            except BaseException as e:
                outq.put(_Raised(e))
            finally:
                for _ in range(process_num):
                    if not _put_unless(abandoned, inq, _STOP):
                        break

        def work():
            try:
                while not abandoned.is_set():
                    try:
                        item = inq.get(timeout=0.1)
                    except queue.Empty:
                        continue
                    if item is _STOP:
                        return
                    pos, sample = item
                    _chaos.fire("reader.worker")
                    outq.put((pos, mapper(sample)))
            except BaseException as e:
                outq.put(_Raised(e))
            finally:
                outq.put(_STOP)

        for target in [feed] + [work] * process_num:
            threading.Thread(target=target, daemon=True).start()

        def drain():
            item = outq.get()
            if isinstance(item, _Raised):
                raise item.exc
            return item

        try:
            live_workers = process_num
            if not order:
                while live_workers:
                    item = drain()
                    if item is _STOP:
                        live_workers -= 1
                    else:
                        window.release()
                        yield item[1]
                return

            ahead = []          # results that arrived before their turn
            next_pos = 0
            while live_workers or ahead:
                if ahead and ahead[0][0] == next_pos:
                    window.release()
                    yield heapq.heappop(ahead)[1]
                    next_pos += 1
                else:
                    item = drain()
                    if item is _STOP:
                        live_workers -= 1
                    else:
                        heapq.heappush(ahead, item)
        finally:
            abandoned.set()

    return _read
