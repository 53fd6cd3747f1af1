"""Fault injection and retry for the port (its own copies of the JAX
package's ``fault/chaos.py`` and ``fault/retry.py``):

- :mod:`paddle_tpu_torch.fault.chaos` — named failpoints armed by tests
  or the ``PADDLE_TPU_CHAOS`` env var (the same grammar and the same
  failpoint names); a disarmed failpoint costs one dict lookup.
- :mod:`paddle_tpu_torch.fault.retry` — :class:`RetryPolicy` (bounded
  attempts, exponential backoff + jitter, deadline).

Checkpointing, the lifecycle and the sentinel are not ported yet.
"""

from __future__ import annotations

from paddle_tpu_torch.fault import chaos
from paddle_tpu_torch.fault.chaos import FaultInjected, fire, inject
from paddle_tpu_torch.fault.retry import RetryError, RetryPolicy, retrying

__all__ = ["chaos", "FaultInjected", "fire", "inject",
           "RetryError", "RetryPolicy", "retrying"]

# parse PADDLE_TPU_CHAOS eagerly so a malformed spec fails fast at
# import, not from inside an arbitrary failpoint site
chaos._load_env()
