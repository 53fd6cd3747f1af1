"""Failpoint-based fault injection.

Product code marks failure boundaries with ``chaos.fire("name")``; tests
(or an operator, via ``PADDLE_TPU_CHAOS``) arm those names to raise,
delay, or hard-kill the process exactly there.  Modeled on the
freebsd/etcd ``failpoint`` idiom: a disarmed failpoint is one dict
lookup on an (almost always) empty dict, so instrumentation can stay in
hot-ish paths like the reader pump and the RPC client.

The authoritative list of failpoint names wired through the codebase is
the registry table in ``docs/fault_tolerance.md`` — it is
scanner-enforced (``tests/test_chaos_failpoint_registry.py`` fails when
a ``chaos.fire(...)`` site is missing from it), so unlike a docstring
copy it cannot drift.

Env grammar (``;`` or ``,`` separated)::

    PADDLE_TPU_CHAOS="train.step=kill@4;master.rpc=error*2;reader.pump=delay:0.5"

``action`` is ``error`` (raise :class:`FaultInjected`), ``kill``
(``os._exit(137)``), or ``delay:SECONDS``.  ``@N`` skips the first N
fires; ``*N`` triggers at most N times (default: unlimited).
"""

from __future__ import annotations

import os
import random
import re
import threading
import time

__all__ = ["FaultInjected", "inject", "fire", "clear", "armed",
           "failpoints", "scoped", "swap", "arm_from_env",
           "KILL_EXIT_CODE"]

KILL_EXIT_CODE = 137


class FaultInjected(RuntimeError):
    """Raised by an armed ``error`` failpoint."""

    def __init__(self, failpoint, message=None):
        super().__init__(message or f"fault injected at {failpoint!r}")
        self.failpoint = failpoint


class _Failpoint:
    def __init__(self, name, error=None, kill=False, delay=None,
                 times=None, after=0, probability=1.0):
        self.name = name
        self.error = error
        self.kill = kill
        self.delay = delay
        self.times = times        # remaining triggers; None = unlimited
        self.after = after        # skip this many fires first
        self.probability = probability
        self.fired = 0            # total fire() calls seen
        self.triggered = 0        # times the action actually ran


_lock = threading.Lock()
_registry: dict[str, _Failpoint] = {}
_env_loaded = False


def inject(name, error=None, kill=False, delay=None, times=None, after=0,
           probability=1.0):
    """Arm failpoint ``name``.

    ``error``: exception instance/class to raise (``True`` or ``None``
    with no other action means a :class:`FaultInjected`); ``kill``:
    ``os._exit(137)`` — a crash no ``finally`` can intercept; ``delay``:
    sleep seconds (combinable with error/kill); ``times``: max triggers
    before auto-disarm; ``after``: let this many fires pass first;
    ``probability``: trigger chance per eligible fire.
    """
    fp = _Failpoint(name, error=error, kill=kill, delay=delay, times=times,
                    after=after, probability=probability)
    with _lock:
        _registry[name] = fp
    return fp


def clear(name=None):
    """Disarm one failpoint (or all, when ``name`` is None)."""
    with _lock:
        if name is None:
            _registry.clear()
        else:
            _registry.pop(name, None)


def armed(name):
    return name in _registry


def swap(name, fp):
    """Install failpoint object ``fp`` under ``name`` (remove it when
    ``fp`` is None) and return the previously armed object, if any —
    the save/restore idiom for code that must re-arm a failpoint
    briefly without clobbering an operator's live spec (``scoped``
    only disarms on exit; it cannot restore a prior arm)."""
    with _lock:
        prev = _registry.pop(name, None)
        if fp is not None:
            _registry[name] = fp
        return prev


def failpoints():
    """Snapshot of armed failpoints: name -> (fired, triggered)."""
    with _lock:
        return {n: (fp.fired, fp.triggered) for n, fp in _registry.items()}


def fire(name, **context):
    """Evaluate failpoint ``name``; no-op unless armed.

    Called from product code at failure boundaries.  ``context`` is
    carried into the :class:`FaultInjected` message for debuggability.
    """
    if not _env_loaded:
        _load_env()
    if not _registry:          # fast path: nothing armed
        return
    with _lock:
        fp = _registry.get(name)
        if fp is None:
            return
        fp.fired += 1
        if fp.fired <= fp.after:
            return
        if fp.times is not None and fp.triggered >= fp.times:
            return
        if fp.probability < 1.0 and random.random() >= fp.probability:
            return
        fp.triggered += 1
        error, kill, delay = fp.error, fp.kill, fp.delay
    if delay:
        time.sleep(delay)
    if kill:
        # last act before the hard exit: flight-recorder dump (no-op
        # unless PADDLE_TPU_POSTMORTEM is set; write_postmortem never
        # raises).  A chaos kill is the drill for a real crash — the
        # post-mortem is the artifact the drill validates.
        try:
            from paddle_tpu_torch.obs import flight
            flight.write_postmortem(
                reason=f"chaos kill at failpoint {name!r}",
                extra={"failpoint": name, "context": repr(context)})
        except Exception:
            pass
        os._exit(KILL_EXIT_CODE)   # hard crash: no atexit, no finally
    if error is not None or delay is None:
        detail = f" ({context})" if context else ""
        if isinstance(error, BaseException):
            raise error
        if isinstance(error, type) and issubclass(error, BaseException):
            raise error(f"fault injected at {name!r}{detail}")
        raise FaultInjected(name, f"fault injected at {name!r}{detail}")


class scoped:
    """``with chaos.scoped("master.rpc", error=...):`` — auto-disarm."""

    def __init__(self, name, **kwargs):
        self.name = name
        self.kwargs = kwargs

    def __enter__(self):
        return inject(self.name, **self.kwargs)

    def __exit__(self, *exc):
        clear(self.name)
        return False


def arm_from_env(spec=None):
    """Parse ``PADDLE_TPU_CHAOS`` (or an explicit ``spec``) and arm the
    failpoints it names.  Returns the list of armed names."""
    spec = spec if spec is not None else os.environ.get("PADDLE_TPU_CHAOS", "")
    names = []
    for clause in spec.replace(",", ";").split(";"):
        clause = clause.strip()
        if not clause:
            continue
        name, _, action = clause.partition("=")
        name, action = name.strip(), (action.strip() or "error")
        after, times = 0, None
        # the @N / *N modifiers compose in either order (error*2@3 ==
        # error@3*2): peel them off the tail one at a time
        while True:
            m = re.search(r"([*@])(\d+)$", action)
            if m is None:
                break
            if m.group(1) == "*":
                times = int(m.group(2))
            else:
                after = int(m.group(2))
            action = action[:m.start()]
        kwargs = dict(after=after, times=times)
        if action == "kill":
            kwargs["kill"] = True
        elif action == "delay" or action.startswith("delay:"):
            kwargs["delay"] = float(action.partition(":")[2] or 0.1)
        elif action != "error":
            raise ValueError(
                f"PADDLE_TPU_CHAOS: unknown action {action!r} in "
                f"{clause!r} (want error|kill|delay:SECS)")
        inject(name, **kwargs)
        names.append(name)
    return names


def _load_env():
    global _env_loaded
    with _lock:
        if _env_loaded:
            return
        _env_loaded = True
    if os.environ.get("PADDLE_TPU_CHAOS"):
        arm_from_env()
