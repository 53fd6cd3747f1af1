"""Fault tolerance for the port (its own copies of the JAX package's
``fault/`` modules):

- :mod:`paddle_tpu_torch.fault.checkpoint` — crash-consistent checkpoint
  commits (temp dir -> checksummed manifest -> fsync -> atomic rename)
  and a :class:`CheckpointManager` with keep-N GC, async saves,
  known-good promotion and a ``restore_latest()`` that quarantines
  torn/corrupt checkpoints.
- :mod:`paddle_tpu_torch.fault.shard_ckpt` — the per-shard checkpoint
  format the port writes (one shard a variable) and reads (any shard
  count), with its manifest topology record.
- :mod:`paddle_tpu_torch.fault.lifecycle` — :class:`GracefulShutdown`:
  SIGTERM/SIGINT-aware stop flag so a preempted trainer finishes the
  current step, commits a checkpoint, and exits cleanly.
- :mod:`paddle_tpu_torch.fault.chaos` — named failpoints armed by tests
  or the ``PADDLE_TPU_CHAOS`` env var (the same grammar and the same
  failpoint names); a disarmed failpoint costs one dict lookup.
- :mod:`paddle_tpu_torch.fault.retry` — :class:`RetryPolicy` (bounded
  attempts, exponential backoff + jitter, deadline).
- :mod:`paddle_tpu_torch.fault.sentinel` — :class:`Sentinel`: numerical
  fault detection on ``Executor.run(..., sentinel=...)``, skip-step,
  quarantine bundles, rollback to the last known-good checkpoint, and
  the bundles' CPU replay.
"""

from __future__ import annotations

from paddle_tpu_torch.fault import chaos
from paddle_tpu_torch.fault.chaos import FaultInjected, fire, inject
from paddle_tpu_torch.fault.checkpoint import (CheckpointManager,
                                               CorruptCheckpoint,
                                               manager_from_env,
                                               verify_checkpoint)
from paddle_tpu_torch.fault.lifecycle import (GracefulShutdown,
                                              graceful_shutdown)
from paddle_tpu_torch.fault.retry import RetryError, RetryPolicy, retrying
from paddle_tpu_torch.fault.sentinel import (BUNDLE_FORMAT, NumericalFault,
                                             Sentinel, load_bundle,
                                             replay_bundle,
                                             sentinel_from_env)
from paddle_tpu_torch.fault.shard_ckpt import ReshardError

__all__ = [
    "chaos", "FaultInjected", "fire", "inject",
    "CheckpointManager", "CorruptCheckpoint", "manager_from_env",
    "verify_checkpoint", "ReshardError",
    "GracefulShutdown", "graceful_shutdown",
    "RetryError", "RetryPolicy", "retrying",
    "Sentinel", "NumericalFault", "sentinel_from_env", "replay_bundle",
    "load_bundle", "BUNDLE_FORMAT",
]

# parse PADDLE_TPU_CHAOS eagerly so a malformed spec fails fast at
# import, not from inside an arbitrary failpoint site
chaos._load_env()
