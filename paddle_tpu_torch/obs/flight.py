"""Flight recorder: "what was the process doing when it died".

On a crash — an uncaught exception, a :class:`fault.GracefulShutdown`
signal, a chaos-failpoint hard kill, or a ``fault.Sentinel`` rollback
(the numerical-fault analog of a crash: the run survived, the state
did not) — the recorder atomically writes a post-mortem JSON file
holding the last N spans from the trace ring plus a full
``RuntimeMetrics.snapshot()``.  The span tail reconstructs
the final step's phase timeline (feed/dispatch/fetch, datapipe pulls,
checkpoint commits); the metrics snapshot carries the counters the
grafana board would have shown at the moment of death.

Arming: set ``PADDLE_TPU_POSTMORTEM`` to a file path (or a directory —
the file becomes ``postmortem-<pid>.json`` inside it).  The fault layer
calls :func:`write_postmortem` from its kill/shutdown paths whenever the
env var is set; :func:`install_excepthook` (installed automatically at
import when armed) covers uncaught exceptions.  Unarmed, every hook is a
no-op.

The write is tmp-file + ``os.replace``: a crash during the dump itself
leaves either the previous complete post-mortem or none — never a torn
JSON (the same commit discipline as ``fault.checkpoint``).
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
import traceback

from paddle_tpu_torch.obs import trace

__all__ = ["POSTMORTEM_ENV", "postmortem_path", "write_postmortem",
           "install_excepthook", "install_from_env", "read_postmortem"]

POSTMORTEM_ENV = "PADDLE_TPU_POSTMORTEM"
POSTMORTEM_FORMAT = 1

_excepthook_installed = False
_dump_seq = itertools.count()


def postmortem_path(path=None):
    """Resolve the post-mortem target: explicit ``path`` wins, else the
    ``PADDLE_TPU_POSTMORTEM`` env var; a directory value maps to
    ``postmortem-<pid>.json`` inside it.  None = recorder unarmed."""
    p = path or os.environ.get(POSTMORTEM_ENV, "").strip()
    if not p:
        return None
    if os.path.isdir(p):
        return os.path.join(p, f"postmortem-{os.getpid()}.json")
    return p


def write_postmortem(path=None, reason="", extra=None):
    """Atomically dump spans + metrics to the post-mortem file.

    Returns the path written, or None when unarmed.  Never raises: this
    runs from signal handlers, excepthooks, and the instant before
    ``os._exit`` — a recorder failure must not mask the original death.
    """
    target = postmortem_path(path)
    if target is None:
        return None
    try:
        from paddle_tpu_torch.profiler import runtime_metrics
        body = {
            "format": POSTMORTEM_FORMAT,
            "reason": reason,
            "pid": os.getpid(),
            "time_unix": time.time(),
            "argv": list(sys.argv),
            "spans": trace.snapshot_spans(),
            "metrics": runtime_metrics.snapshot(),
        }
        if extra:
            body["extra"] = extra
        try:
            from paddle_tpu_torch.obs import ledger as _ledger
            rows = _ledger.active_tail(32)
            if rows:
                # the loss/grad trajectory INTO the fault, next to the
                # span timeline (obs/ledger.py)
                body["ledger_tail"] = rows
        except Exception:
            pass
        # the tmp name must be unique PER CALL, not per process: a
        # graceful shutdown dumps twice concurrently (the async
        # signal-handler thread and the __exit__ backstop), and two
        # writers sharing one tmp inode interleave into torn JSON —
        # unique names keep every rename a complete document, last
        # writer wins
        tmp = (f"{target}.tmp-{os.getpid()}"
               f"-{threading.get_ident()}-{next(_dump_seq)}")
        with open(tmp, "w") as f:
            json.dump(body, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, target)
        return target
    except Exception:  # pragma: no cover - by-design last resort
        return None


def read_postmortem(path):
    """Load a post-mortem file (forensics helper; plain ``json.load``)."""
    with open(path) as f:
        return json.load(f)


def install_excepthook():
    """Chain a post-mortem dump in front of the current
    ``sys.excepthook`` (idempotent).  The previous hook still runs, so
    tracebacks print exactly as before."""
    global _excepthook_installed
    if _excepthook_installed:
        return
    _excepthook_installed = True
    previous = sys.excepthook

    def hook(exc_type, exc, tb):
        write_postmortem(
            reason=f"uncaught {exc_type.__name__}: {exc}",
            extra={"traceback": traceback.format_exception(exc_type, exc,
                                                           tb)})
        previous(exc_type, exc, tb)

    sys.excepthook = hook


def install_from_env():
    """Arm the uncaught-exception hook iff ``PADDLE_TPU_POSTMORTEM`` is
    set (called at ``paddle_tpu.obs`` import; unarmed = zero change)."""
    if os.environ.get(POSTMORTEM_ENV, "").strip():
        install_excepthook()
        return True
    return False
