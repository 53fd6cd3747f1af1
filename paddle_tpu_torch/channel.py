"""Go-style CSP channels (the port's copy of ``paddle_tpu.channel``;
reference ``paddle/fluid/framework/channel.h:33`` / ``channel_impl.h``,
semantics pinned by ``channel_test.cc``).

Host-side concurrency primitives (the reference's are C++ threads +
condition variables; here Python threads: channels coordinate host
control flow; the values they carry may be tensors on the card):

* capacity == 0 → unbuffered rendezvous: ``send`` blocks until a receiver
  takes the value, ``receive`` blocks until a sender arrives.
* capacity > 0 → FIFO buffer: ``send`` blocks only when full.
* ``close``: further sends raise ``ChannelClosedError`` (panic semantics);
  blocked senders are woken with the same error; receivers drain residual
  buffered values, then get ``(zero, False)``.
* receive order == send order.
"""

from __future__ import annotations

import collections
import threading

__all__ = ["Channel", "ChannelClosedError"]


class ChannelClosedError(RuntimeError):
    """Send on a closed channel (reference: PADDLE_THROW 'Cannot send on
    closed channel', channel_impl.h)."""


class Channel:
    def __init__(self, capacity=0, dtype=None):
        self.capacity = int(capacity)
        self.dtype = dtype
        self._buf = collections.deque()
        self._closed = False
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # unbuffered rendezvous bookkeeping: #receivers waiting, and a
        # one-slot handoff queue consumed in FIFO order
        self._recv_waiting = 0

    # -- introspection (Channel::Cap/IsClosed/CanSend/CanReceive) ---------
    def cap(self):
        return self.capacity

    def is_closed(self):
        with self._lock:
            return self._closed

    def can_send(self):
        with self._lock:
            if self._closed:
                return False
            if self.capacity > 0:
                return len(self._buf) < self.capacity
            return self._recv_waiting > 0

    def can_receive(self):
        # non-empty buffer covers both buffered values and unbuffered
        # senders waiting at the rendezvous
        with self._lock:
            return bool(self._buf)

    # -- core ops ---------------------------------------------------------
    def send(self, value, timeout=None):
        with self._cond:
            if self._closed:
                raise ChannelClosedError("cannot send on closed channel")
            if self.capacity > 0:
                while len(self._buf) >= self.capacity and not self._closed:
                    if not self._cond.wait(timeout=timeout):
                        raise TimeoutError("channel send timed out")
                if self._closed:
                    raise ChannelClosedError("cannot send on closed channel")
                self._buf.append(value)
                self._cond.notify_all()
                return
            # unbuffered: enqueue the value; a receiver must take it before
            # this send returns (rendezvous)
            item = [value, False]  # [value, taken]
            self._buf.append(item)
            self._cond.notify_all()
            while not item[1]:
                if self._closed:
                    # close unblocks senders with a panic (channel_test.cc
                    # UnbufferedChannelCloseUnblocksSendersTest)
                    try:
                        self._buf.remove(item)
                    except ValueError:
                        pass
                    raise ChannelClosedError(
                        "cannot send on closed channel")
                if not self._cond.wait(timeout=timeout):
                    try:
                        self._buf.remove(item)
                    except ValueError:
                        pass
                    raise TimeoutError("channel send timed out")

    def receive(self, timeout=None):
        """Returns (value, ok).  ok=False means closed-and-drained."""
        with self._cond:
            if self.capacity > 0:
                while not self._buf and not self._closed:
                    if not self._cond.wait(timeout=timeout):
                        raise TimeoutError("channel receive timed out")
                if self._buf:
                    v = self._buf.popleft()
                    self._cond.notify_all()
                    return v, True
                return None, False  # closed and drained
            # unbuffered
            self._recv_waiting += 1
            try:
                while not self._buf and not self._closed:
                    if not self._cond.wait(timeout=timeout):
                        raise TimeoutError("channel receive timed out")
                if self._buf:
                    item = self._buf.popleft()
                    item[1] = True
                    self._cond.notify_all()
                    return item[0], True
                return None, False
            finally:
                self._recv_waiting -= 1

    def try_send(self, value):
        """Non-blocking send; True on success (select-case probe)."""
        with self._cond:
            if self._closed:
                raise ChannelClosedError("cannot send on closed channel")
            if self.capacity > 0:
                if len(self._buf) < self.capacity:
                    self._buf.append(value)
                    self._cond.notify_all()
                    return True
                return False
            if self._recv_waiting > 0 and not self._buf:
                item = [value, False]
                self._buf.append(item)
                self._cond.notify_all()
                # the waiting receiver will take it; from the select's
                # perspective the case fired
                return True
            return False

    def try_receive(self):
        """Non-blocking receive; (value, ok, ready)."""
        with self._cond:
            if self._buf:
                if self.capacity > 0:
                    v = self._buf.popleft()
                    self._cond.notify_all()
                    return v, True, True
                item = self._buf.popleft()
                item[1] = True
                self._cond.notify_all()
                return item[0], True, True
            if self._closed:
                return None, False, True  # closed fires immediately
            return None, False, False

    def close(self):
        with self._cond:
            self._closed = True
            self._cond.notify_all()
