"""Generative session registry: the state that makes a ``/generate``
stream survive its replica.

The reference framework's Go master keeps a lease table so a dead
trainer's task can be re-assigned without losing the pass
(``go/master/service.go``); this module keeps the serving-plane
analog: one bounded table of live generative sessions — which replica
owns the stream, a hash of the prompt, and how many tokens the client
has already received — so the :class:`~paddle_tpu.fleet.router.
FleetRouter` can (a) route a follow-up or resume request back to the
owning replica and (b) re-prefill ``prompt + tokens_so_far`` on a
survivor when the owner dies mid-stream.  Greedy decode is
deterministic (the KV-exactness tests are the proof obligation), so
the re-prefilled continuation is token-identical and the router can
splice the two streams into one duplicate-free sequence keyed on the
monotone ``token_index`` every streamed event carries.

Entries are evicted on ``done``; the table is bounded, and evicting a
session that never finished counts ``gen.session.orphaned`` — the
leak detector for streams whose client vanished without a terminal
event.

The module also owns the resume-protocol schema validators
(:func:`validate_stream_event`, :func:`validate_checkpoint`) that the
``paddle_tpu selfcheck`` ``sessions`` section round-trips — protocol
drift fails a release gate, not a production resume.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time

__all__ = ["SessionTable", "new_session_id", "prompt_hash",
           "validate_stream_event", "validate_checkpoint"]


def new_session_id():
    """Mint a session id (uuid-free: 12 hex bytes of os.urandom)."""
    return f"s-{os.urandom(12).hex()}"


def prompt_hash(prompt):
    """Stable short hash of a token-id prompt (session-table identity
    check: a resume whose prompt prefix changed is a different
    request, not a resume)."""
    h = hashlib.sha256()
    for t in prompt:
        h.update(str(int(t)).encode())
        h.update(b",")
    return h.hexdigest()[:16]


class SessionTable:
    """Bounded, thread-safe registry of live generative sessions.

    Each entry tracks the owning replica, the prompt hash, and the
    count of tokens DELIVERED to the client so far (the resume
    index).  ``finish`` evicts on ``done``; capacity overflow evicts
    the least-recently-touched entry and counts it as orphaned when it
    never finished.
    """

    def __init__(self, capacity=1024):
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._table = {}        # sid -> entry dict (insertion ordered)
        self.orphaned = 0       # non-done entries evicted by capacity

    def __len__(self):
        with self._lock:
            return len(self._table)

    def begin(self, sid, replica, prompt, max_new_tokens,
              delivered=0):
        """Register (or re-register, on resume) a session. Returns the
        entry."""
        now = time.monotonic()
        with self._lock:
            entry = self._table.pop(sid, None)
            if entry is None:
                entry = {"sid": sid, "created_t": now}
            entry.update(replica=replica,
                         prompt_hash=prompt_hash(prompt),
                         prompt_len=len(prompt),
                         max_new_tokens=int(max_new_tokens),
                         delivered=int(delivered),
                         done=False, touched_t=now)
            self._table[sid] = entry        # re-insert: LRU order
            self._evict_over_capacity()
            return entry

    def note(self, sid, replica=None, delivered=None):
        """Update a live session's owner and/or delivered count."""
        with self._lock:
            entry = self._table.get(sid)
            if entry is None:
                return None
            if replica is not None:
                entry["replica"] = replica
            if delivered is not None:
                entry["delivered"] = int(delivered)
            entry["touched_t"] = time.monotonic()
            return entry

    def lookup(self, sid):
        with self._lock:
            entry = self._table.get(sid)
            return dict(entry) if entry is not None else None

    def owner(self, sid):
        """The owning replica address, or None."""
        with self._lock:
            entry = self._table.get(sid)
            return entry["replica"] if entry is not None else None

    def finish(self, sid):
        """Terminal event delivered: evict the entry (returns it, or
        None when unknown)."""
        with self._lock:
            entry = self._table.pop(sid, None)
            if entry is not None:
                entry["done"] = True
            return entry

    def _evict_over_capacity(self):
        # caller holds the lock; dicts iterate in insertion order and
        # begin()/touch re-inserts, so the first key is the LRU entry
        from paddle_tpu_torch import profiler as _profiler
        while len(self._table) > self.capacity:
            sid = next(iter(self._table))
            entry = self._table.pop(sid)
            if not entry.get("done"):
                self.orphaned += 1
                _profiler.runtime_metrics.inc("gen.session.orphaned")

    def snapshot(self):
        """The ``/stats`` body: counts plus a bounded sample of live
        sessions."""
        with self._lock:
            sample = [
                {"sid": e["sid"], "replica": e["replica"],
                 "delivered": e["delivered"],
                 "prompt_len": e["prompt_len"],
                 "age_s": round(time.monotonic() - e["created_t"], 3)}
                for e in list(self._table.values())[:32]]
            return {"count": len(self._table),
                    "capacity": self.capacity,
                    "orphaned": self.orphaned,
                    "sessions": sample}


# ---------------------------------------------------------------------------
# resume-protocol schemas (selfcheck `sessions` section round-trips these)
# ---------------------------------------------------------------------------

def _is_int(v):
    return isinstance(v, int) and not isinstance(v, bool)


def validate_stream_event(obj):
    """Problems with one streamed ``/generate`` ndjson event (empty =
    valid).  Three shapes are legal:

    - token:     ``{"token": id, "index": i}`` — ``index`` is the
      monotone token_index the dedupe/splice logic keys on;
    - terminal:  ``{"done": true, ...}`` with either
      ``finish_reason`` (clean), ``error`` (failure; new tails add
      ``token_index`` + top-level ``retryable``), or ``migrate``
      (drain-time hand-back: ``{"resume_from": i}``);
    - legacy terminal error tails WITHOUT ``token_index``/
      ``retryable`` still validate — old clients and old tails must
      keep parsing.
    """
    problems = []
    if not isinstance(obj, dict):
        return [f"event must be an object, got {type(obj).__name__}"]
    if "token" in obj:
        if not _is_int(obj["token"]):
            problems.append("token must be an int token id")
        if not _is_int(obj.get("index", None)) or obj.get("index", -1) < 0:
            problems.append("token event needs a non-negative int index")
        if obj.get("done"):
            problems.append("token event cannot also be terminal")
        return problems
    if not obj.get("done"):
        return ["non-token event must be terminal (done: true)"]
    kinds = [k for k in ("finish_reason", "error", "migrate") if k in obj]
    if len(kinds) != 1:
        problems.append("terminal event needs exactly one of "
                        "finish_reason / error / migrate, got "
                        f"{kinds or 'none'}")
        return problems
    if "finish_reason" in obj and not isinstance(obj["finish_reason"],
                                                 str):
        problems.append("finish_reason must be a string")
    if "error" in obj:
        err = obj["error"]
        if not isinstance(err, dict) or not isinstance(
                err.get("type"), str):
            problems.append("error must be an object with a type string")
        # token_index / retryable are OPTIONAL (legacy tails) but must
        # be well-typed when present
        if "token_index" in obj and (
                not _is_int(obj["token_index"]) or obj["token_index"] < 0):
            problems.append("token_index must be a non-negative int")
        if "retryable" in obj and not isinstance(obj["retryable"], bool):
            problems.append("retryable must be a boolean")
    if "migrate" in obj:
        mig = obj["migrate"]
        if not isinstance(mig, dict) or not _is_int(
                mig.get("resume_from", None)) or mig["resume_from"] < 0:
            problems.append("migrate must be an object with a "
                            "non-negative int resume_from")
        if obj.get("retryable") is not True:
            problems.append("migrate tails must be retryable: true "
                            "(the whole point is a resume)")
    return problems


def validate_checkpoint(ckpt):
    """Problems with a drain-time session checkpoint (empty = valid):
    the scheduler's token-boundary hand-back — prompt as submitted,
    tokens emitted since, the remaining budget, and the eos override —
    everything a survivor needs to continue token-identically."""
    problems = []
    if not isinstance(ckpt, dict):
        return [f"checkpoint must be an object, "
                f"got {type(ckpt).__name__}"]
    prompt = ckpt.get("prompt")
    if not isinstance(prompt, list) or not prompt or \
            not all(_is_int(t) for t in prompt):
        problems.append("prompt must be a non-empty list of int "
                        "token ids")
    tokens = ckpt.get("tokens")
    if not isinstance(tokens, list) or \
            not all(_is_int(t) for t in tokens):
        problems.append("tokens must be a list of int token ids")
    rem = ckpt.get("remaining_tokens")
    if not _is_int(rem) or rem < 0:
        problems.append("remaining_tokens must be a non-negative int")
    if "eos_id" in ckpt and ckpt["eos_id"] is not None and \
            not _is_int(ckpt["eos_id"]):
        problems.append("eos_id must be an int or null")
    if not isinstance(ckpt.get("reason"), str) or not ckpt.get("reason"):
        problems.append("reason must be a non-empty string")
    return problems
