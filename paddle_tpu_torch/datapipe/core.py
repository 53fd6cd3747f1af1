"""Composable input-pipeline stages with checkpointable iterators (the
port's copy of ``paddle_tpu.datapipe.core``).

The 2018-era surface (``reader/decorator.py``) is a chain of nullary
generator factories: fast to write, but impossible to checkpoint (a
generator's position cannot be saved), blind (no per-stage metrics), and
leaky (threads owned by abandoned generators).  ``datapipe`` replaces it
with a chain of :class:`Stage` objects — the tf.data lineage (Murray et
al., VLDB 2021) realized over this repo's runtime:

* every stage IS the iterator state: ``state_dict()`` /
  ``load_state_dict()`` capture (shard position, epoch, RNG state,
  buffered samples) so a killed trainer resumes mid-epoch with the
  EXACT sample sequence an uninterrupted run would have seen
  (``fault.CheckpointManager(datapipe=...)`` wires this into the
  crash-consistent checkpoint commit);
* threaded stages (:class:`~paddle_tpu_torch.datapipe.stages.ParallelMap`,
  :class:`~paddle_tpu_torch.datapipe.prefetch.DevicePrefetch`) quiesce on
  ``state_dict()``: in-flight samples drain into a ``pending`` buffer
  that is part of the state — nothing is lost, nothing replays;
* every stage reports throughput / stall-time / queue-depth into
  ``profiler.runtime_metrics`` (``datapipe.<stage>.*``), visible through
  the serving ``/stats`` endpoint and ``python -m paddle_tpu_torch
  stats --local``.

Iteration protocol: ``iter(stage)`` yields the REMAINDER of the current
epoch (a fresh pipeline starts at epoch 0, offset 0); exhausting it
advances the epoch, so ``for _ in range(passes): for batch in pipe:``
is the multi-epoch loop.  Abandoning an iterator mid-epoch keeps the
position — the next ``iter()`` continues where it stopped; ``reset()``
rewinds to epoch 0.
"""

from __future__ import annotations

import time

from paddle_tpu_torch.obs.trace import record_span
from paddle_tpu_torch.profiler import runtime_metrics

__all__ = ["Stage", "PipelineStateError", "stats"]


class PipelineStateError(ValueError):
    """A ``load_state_dict`` payload does not match the pipeline shape."""


class _Raised:
    """An exception captured in a worker/buffer, re-raised at the
    consumer in sequence position (shared with the threaded stages)."""

    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc


class Stage:
    """One pipeline node.  Subclasses implement ``_iterate`` (a generator
    over the rest of the current epoch), ``_shutdown`` (quiesce any
    worker threads, draining in-flight items into stage state), and the
    ``_state``/``_load_state`` pair for their local position."""

    kind = "stage"

    def __init__(self, upstream=None, name=None):
        self._upstream = upstream
        self.name = name or self.kind
        self._metrics = "datapipe." + self.name

    # -- iteration ------------------------------------------------------
    def __iter__(self):
        try:
            yield from self._iterate()
        finally:
            # runs on exhaustion AND on abandonment (generator close/GC):
            # threads stop, in-flight items drain into stage state
            self._shutdown()

    def _iterate(self):
        raise NotImplementedError

    def _shutdown(self):
        """Quiesce: stop worker threads, fold in-flight items into state.
        Must be idempotent and callable at any time."""

    def close(self):
        """Quiesce this stage and everything upstream."""
        self._shutdown()
        if self._upstream is not None:
            self._upstream.close()

    # -- state ----------------------------------------------------------
    def _state(self):
        return {}

    def _load_state(self, state):
        pass

    def state_dict(self):
        """Picklable snapshot of the whole chain's position.  Call it
        between ``next()`` calls (the per-step checkpoint pattern);
        threaded stages quiesce first so in-flight samples are captured,
        not lost."""
        self._shutdown()
        d = {"kind": self.kind, "state": self._state()}
        if self._upstream is not None:
            d["upstream"] = self._upstream.state_dict()
        return d

    def load_state_dict(self, d):
        """Restore the whole chain's position from a ``state_dict``
        snapshot.  Safe to call MID-EPOCH with an abandoned iterator
        still open (the sentinel's rollback path does exactly this):
        every stage quiesces first, so the stale iterator's eventual
        ``close()`` hits an idempotent ``_shutdown`` and cannot drain
        pre-rollback in-flight samples over the restored state — reopen
        with ``iter(pipe)`` to resume from the loaded position."""
        if not isinstance(d, dict) or d.get("kind") != self.kind:
            raise PipelineStateError(
                f"stage {self.name!r} (kind {self.kind!r}) cannot load "
                f"state of kind {d.get('kind') if isinstance(d, dict) else d!r}"
                f" — pipeline shape changed since the checkpoint")
        self._shutdown()
        self._load_state(d.get("state") or {})
        if self._upstream is not None:
            if "upstream" not in d:
                raise PipelineStateError(
                    f"stage {self.name!r}: state has no upstream entry")
            self._upstream.load_state_dict(d["upstream"])

    def reset(self):
        """Rewind the whole chain to epoch 0, discarding buffers."""
        self._shutdown()
        self._reset_local()
        if self._upstream is not None:
            self._upstream.reset()

    def _reset_local(self):
        pass

    # -- metrics --------------------------------------------------------
    def _count(self, n=1):
        runtime_metrics.inc(self._metrics + ".items", n)

    def _pull(self, iterator):
        """``next(iterator)`` with the upstream wait observed as this
        stage's stall time (and, under tracing, one
        ``datapipe.<stage>.pull`` span per sample — the per-stage
        timeline every pipeline stage contributes through this choke
        point).  Raises StopIteration through."""
        t0 = time.perf_counter()
        item = next(iterator)
        dt = time.perf_counter() - t0
        runtime_metrics.observe(self._metrics + ".wait_seconds", dt)
        record_span(self._metrics + ".pull", t0, dt)
        return item

    # -- fluent builders ------------------------------------------------
    def shuffle(self, buffer_size, seed=0, name=None):
        from paddle_tpu_torch.datapipe.stages import Shuffle
        return Shuffle(self, buffer_size, seed=seed, name=name)

    def map(self, fn, workers=0, window=None, name=None):
        from paddle_tpu_torch.datapipe.stages import ParallelMap
        return ParallelMap(self, fn, workers=workers, window=window,
                           name=name)

    def batch(self, batch_size, drop_last=False, collate=None,
              pad_to_bucket=False, bucket_edges=None, name=None):
        from paddle_tpu_torch.datapipe.stages import Batch
        return Batch(self, batch_size, drop_last=drop_last,
                     collate=collate, pad_to_bucket=pad_to_bucket,
                     bucket_edges=bucket_edges, name=name)

    def shard_ids(self, field, vocab_size, num_shards, shard_index=None,
                  owner_field=None, name=None):
        from paddle_tpu_torch.datapipe.stages import ShardIds
        return ShardIds(self, field, vocab_size, num_shards,
                        shard_index=shard_index, owner_field=owner_field,
                        name=name)

    def prefetch(self, depth=2, device=None, name=None):
        """A :class:`~paddle_tpu_torch.datapipe.prefetch.DevicePrefetch`
        onto ``device`` (default ``cuda:0``; raises without CUDA)."""
        from paddle_tpu_torch.datapipe.prefetch import DevicePrefetch
        return DevicePrefetch(self, depth=depth, device=device, name=name)


def stats():
    """The ``datapipe.*`` slice of the process-wide runtime metrics —
    per-stage item counts, stall-time series, and queue-depth gauges
    (the same numbers ``/stats`` and ``python -m paddle_tpu_torch stats
    --local`` show)."""
    snap = runtime_metrics.snapshot()
    out = {}
    for section, body in snap.items():
        if not isinstance(body, dict):
            continue
        picked = {k: v for k, v in body.items()
                  if k.startswith("datapipe.")}
        if picked:
            out[section] = picked
    return out
