"""Bounded retry with exponential backoff + jitter.

The reference's Go clients retry master/pserver RPCs in ad-hoc loops
(``go/master/client.go`` reconnects on lease loss; ``go/pserver/client``
re-dials).  Here the policy is one reusable object so every networked
path — :class:`MasterClient`, the serving client, checkpoint IO — shares
the same knobs: max attempts, exponential backoff with full jitter, and
an overall deadline.
"""

from __future__ import annotations

import random
import time

__all__ = ["RetryPolicy", "RetryError", "retrying", "DEFAULT_RPC_POLICY",
           "parse_hostport", "parse_deadline_ms", "parse_retry_after"]


def parse_hostport(addr):
    """``(host, port)`` from a tuple or a ``"host:port"`` string — the
    shared address convention of the networked clients (master RPC,
    serving HTTP)."""
    if isinstance(addr, tuple):
        host, port = addr
    else:
        host, _, port = addr.rpartition(":")
    return host, int(port)


def parse_deadline_ms(value):
    """Seconds of budget from an ``X-Deadline-Ms`` header value, or
    None when absent/blank — the shared deadline convention of the
    serving/fleet HTTP surface.  Raises ValueError on anything
    non-finite: nan compares False everywhere and inf breaks int()
    downstream, so both must be rejected at the edge, identically by
    every consumer."""
    import math
    value = (value or "").strip()
    if not value:
        return None
    budget = float(value) / 1000.0   # ValueError on garbage propagates
    if not math.isfinite(budget):
        raise ValueError(f"non-finite deadline {value!r}")
    return budget


def parse_retry_after(value):
    """Seconds from a ``Retry-After`` header value, or None when
    absent/unparseable.  Only the delta-seconds form is supported (the
    fleet's own sheds emit it; HTTP-date senders fall back to the
    default backoff) and negative/non-finite values are rejected as
    None — a malformed hint must degrade to the policy's own backoff,
    never produce a negative sleep."""
    import math
    if not isinstance(value, str):
        return None
    value = value.strip()
    if not value:
        return None
    try:
        secs = float(value)
    except ValueError:
        return None
    if not math.isfinite(secs) or secs < 0:
        return None
    return secs


class RetryError(RuntimeError):
    """All attempts exhausted (or deadline hit); ``.last`` is the final
    underlying exception, also chained as ``__cause__``.  ``.history``
    is the per-attempt context trail (e.g. the replica each attempt hit,
    attached by failover callers like ``FleetRouter``/``ServingClient``)
    — empty when the caller recorded none."""

    def __init__(self, message, last, history=None):
        super().__init__(message)
        self.last = last
        self.history = list(history) if history else []


class RetryPolicy:
    """``cap(n) = min(max_delay, base_delay * multiplier**n)``, jittered;
    give up after ``max_attempts`` tries or when the remaining
    ``deadline`` budget is smaller than the next backoff (the policy
    raises :class:`RetryError` immediately rather than sleeping through
    — or past — the budget).

    ``jitter`` is either a float ``j`` (equal-style: the cap scaled by
    ``1 ± j``) or the string ``"full"`` (AWS full jitter:
    ``uniform(0, cap)`` — the decorrelated choice for thundering-herd
    retry storms, where every client re-dialing a restarted master at
    the same instant is exactly the failure mode).
    """

    def __init__(self, max_attempts=5, base_delay=0.05, max_delay=2.0,
                 multiplier=2.0, jitter=0.5, deadline=None,
                 retryable=(ConnectionError, TimeoutError, OSError)):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if jitter != "full":
            try:
                # coerce on store: a numeric string must not survive
                # construction only to blow up inside backoff() mid-retry
                jitter = None if jitter is None else float(jitter)
                valid = jitter is None or 0 <= jitter <= 1
            except (TypeError, ValueError):
                valid = False
            if not valid:
                raise ValueError(
                    'jitter must be "full", None, or a float in [0, 1]')
        self.max_attempts = max_attempts
        self.base_delay = base_delay
        self.max_delay = max_delay
        self.multiplier = multiplier
        self.jitter = jitter
        self.deadline = deadline
        self.retryable = tuple(retryable)

    def backoff(self, attempt):
        """Sleep before retry number ``attempt`` (1-based)."""
        delay = min(self.max_delay,
                    self.base_delay * self.multiplier ** (attempt - 1))
        if self.jitter == "full":
            return random.uniform(0.0, delay)
        if self.jitter:
            delay *= 1.0 + self.jitter * (2.0 * random.random() - 1.0)
        return max(0.0, delay)

    def hinted_delay(self, hint):
        """Sleep for a server-supplied ``Retry-After`` hint: the hint
        capped at ``max_delay``, under the policy's own jitter mode —
        with full jitter the N clients a shedding server just bounced
        drain back spread over the hinted window instead of returning
        in one synchronized wave."""
        base = min(max(0.0, float(hint)), self.max_delay)
        if self.jitter == "full":
            return random.uniform(0.0, base)
        if self.jitter:
            base *= 1.0 + self.jitter * (2.0 * random.random() - 1.0)
        return max(0.0, base)

    def call(self, fn, *args, on_retry=None, deadline=None, **kwargs):
        """Run ``fn(*args, **kwargs)``, retrying on ``self.retryable``.

        ``on_retry(attempt, exc, delay)`` is invoked before each sleep
        (logging / reconnect hooks).  ``deadline`` overrides the
        policy's budget for this one call (seconds from the first
        attempt) — when the remaining budget is smaller than the next
        backoff, :class:`RetryError` is raised immediately instead of
        sleeping.  Non-retryable exceptions propagate immediately;
        exhausted attempts raise :class:`RetryError`.  (``deadline`` is
        consumed by the policy, never forwarded to ``fn``.)
        """
        deadline = self.deadline if deadline is None else deadline
        start = time.monotonic()
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn(*args, **kwargs)
            except self.retryable as e:
                if attempt >= self.max_attempts:
                    raise RetryError(
                        f"gave up after {attempt} attempts: {e}", e) from e
                hint = getattr(e, "retry_after", None)
                if hint is not None:
                    # server-paced backoff: sleep the Retry-After hint
                    # (jittered, capped) clamped to the remaining budget
                    # — a shedding server's hint should never make us
                    # abandon a request the deadline still allows
                    delay = self.hinted_delay(hint)
                    if deadline is not None:
                        remaining = deadline - (time.monotonic() - start)
                        if remaining <= 0.01:
                            raise RetryError(
                                f"deadline {deadline}s exceeded after "
                                f"{attempt} attempts (Retry-After "
                                f"{hint}s hinted, {remaining:.3f}s "
                                f"remaining): {e}", e) from e
                        delay = min(delay, max(0.0, remaining - 0.005))
                else:
                    delay = self.backoff(attempt)
                    if deadline is not None:
                        remaining = deadline - (time.monotonic() - start)
                        if delay > remaining:
                            raise RetryError(
                                f"deadline {deadline}s exceeded after "
                                f"{attempt} attempts ({remaining:.3f}s "
                                f"remaining < next backoff {delay:.3f}s): "
                                f"{e}", e) from e
                if on_retry is not None:
                    on_retry(attempt, e, delay)
                time.sleep(delay)


def retrying(policy=None, **kwargs):
    """Decorator form: ``@retrying(RetryPolicy(...))`` or
    ``@retrying(max_attempts=3)``."""
    policy = policy or RetryPolicy(**kwargs)

    def wrap(fn):
        def wrapped(*args, **kw):
            return policy.call(fn, *args, **kw)
        wrapped.__name__ = getattr(fn, "__name__", "retrying")
        wrapped.__doc__ = fn.__doc__
        wrapped.retry_policy = policy
        return wrapped

    return wrap


# trainer-facing RPC default: ~6s worst-case total sleep, enough to ride
# out a master restart without stalling a trainer for minutes
DEFAULT_RPC_POLICY = RetryPolicy(max_attempts=6, base_delay=0.05,
                                 max_delay=2.0, deadline=30.0)
