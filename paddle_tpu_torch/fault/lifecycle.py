"""Preemption-aware lifecycle: finish the step, checkpoint, exit clean
(the port's copy of ``paddle_tpu.fault.lifecycle``).

Cloud schedulers preempt with a SIGTERM and a grace window; the reference
trainer just died and leaned on the master's lease timeout to requeue
its work.  :class:`GracefulShutdown` converts SIGTERM/SIGINT into a stop
flag the training loop polls between steps, so the trainer commits a
final checkpoint instead of losing the tail of its progress — the
TF-style preemption-safe checkpointing discipline.
"""

from __future__ import annotations

import signal
import threading

__all__ = ["GracefulShutdown", "graceful_shutdown"]


class GracefulShutdown:
    """Context manager: trap termination signals into a flag.

    ::

        with GracefulShutdown() as stop:
            for step in range(start, num_steps):
                if stop.should_stop():
                    break           # fall through to the final commit
                run_one_step()
                manager.save(step)

    Signal handlers are only installable from the main thread; elsewhere
    the guard still works as a manual flag (``stop.request()``).  The
    previous handlers are restored on exit.  ``on_shutdown`` (if given)
    runs inside the handler — keep it async-signal-light (set flags,
    don't checkpoint there; checkpoint from the loop).
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT),
                 on_shutdown=None):
        self.signals = tuple(signals)
        self.on_shutdown = on_shutdown
        self._event = threading.Event()
        self._previous = {}
        self.received = None      # signum of the first trapped signal

    # -- flag --------------------------------------------------------------
    def should_stop(self):
        return self._event.is_set()

    def wait(self, timeout=None):
        return self._event.wait(timeout)

    def request(self, signum=None):
        """Trip the flag programmatically (tests, cluster RPCs)."""
        if self.received is None:
            self.received = signum
        self._event.set()
        # flight-recorder snapshot at the moment of preemption (no-op
        # unless PADDLE_TPU_POSTMORTEM is armed) — if the grace window
        # runs out mid-commit, this is what survives.  MUST NOT run in
        # this frame: request() is called from the signal handler, i.e.
        # on the main thread, which may be interrupted INSIDE a
        # runtime-metrics lock — snapshotting here would deadlock.  A
        # daemon thread acquires that lock normally once the handler
        # returns and the main thread releases it; __exit__ writes a
        # final synchronous dump as the deterministic backstop.
        try:
            self._dump_async(signum)
        except Exception:
            pass
        if self.on_shutdown is not None:
            self.on_shutdown(signum)

    def _dump_async(self, signum):
        from paddle_tpu_torch.obs import flight
        if flight.postmortem_path() is None:
            return
        reason = f"graceful shutdown (signal {signum})"
        threading.Thread(target=flight.write_postmortem, daemon=True,
                         kwargs={"reason": reason},
                         name="paddle-tpu-postmortem").start()

    # -- context -----------------------------------------------------------
    def _handler(self, signum, frame):
        self.request(signum)

    def __enter__(self):
        for sig in self.signals:
            try:
                self._previous[sig] = signal.signal(sig, self._handler)
            except ValueError:      # not the main thread: manual-flag mode
                break
        return self

    def __exit__(self, *exc):
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()
        if self.received is not None:
            # deterministic final dump from loop context (the async
            # handler-side dump is best-effort; the write is atomic and
            # idempotent, so doubling up is safe)
            try:
                from paddle_tpu_torch.obs import flight
                flight.write_postmortem(
                    reason=f"graceful shutdown (signal {self.received})")
            except Exception:
                pass
        return False


def graceful_shutdown(**kwargs):
    """Convenience alias: ``with graceful_shutdown() as stop: ...``"""
    return GracefulShutdown(**kwargs)
