"""Transform stages: seeded shuffle, bounded parallel map, batch/pad (the
port's copy of ``paddle_tpu.datapipe.stages``).

All three are exactly resumable: their ``state_dict`` includes every
sample that has been pulled from upstream but not yet emitted (shuffle
buffer, in-flight map results, partial batch), so a restore continues
the sample sequence with no loss and no replay.
"""

from __future__ import annotations

import collections
import concurrent.futures
import numpy as np

from paddle_tpu_torch.datapipe.core import Stage, _Raised

__all__ = ["Shuffle", "ParallelMap", "Batch", "ShardIds",
           "default_collate"]


class Shuffle(Stage):
    """Deterministic buffered shuffle: a ``buffer_size`` reservoir is
    kept full; each incoming sample evicts a seeded-RNG-chosen resident
    (then the tail drains in random order at epoch end).  The RNG runs
    continuously from ``seed`` across epochs — two pipelines built with
    the same seed emit identical permutations, and the captured RNG
    state + buffer make mid-epoch resume exact.

    The RNG is numpy's ``default_rng(seed)`` as in the JAX package, and
    the state is its bit generator's state dict: both packages emit the
    same order from one seed, and a pipeline state either writes loads
    in the other.  It draws host data positions, not device values, so
    the port's rule of explicit torch generators does not apply."""

    kind = "shuffle"

    def __init__(self, upstream, buffer_size, seed=0, name=None):
        super().__init__(upstream, name or "shuffle")
        if buffer_size < 1:
            raise ValueError("shuffle buffer_size must be >= 1")
        self.buffer_size = int(buffer_size)
        self.seed = seed
        self._rng = None
        self._buffer = []
        self._draining = False

    def _ensure_rng(self):
        if self._rng is None:
            self._rng = np.random.default_rng(self.seed)
        return self._rng

    def _iterate(self):
        rng = self._ensure_rng()
        buf = self._buffer
        if not self._draining:
            up = iter(self._upstream)
            try:
                while True:
                    try:
                        sample = self._pull(up)
                    except StopIteration:
                        break
                    if len(buf) < self.buffer_size:
                        buf.append(sample)
                        continue
                    j = int(rng.integers(len(buf)))
                    out = buf[j]
                    buf[j] = sample
                    self._count()
                    yield out
            finally:
                up.close()
            self._draining = True
        while buf:
            j = int(rng.integers(len(buf)))
            buf[j], buf[-1] = buf[-1], buf[j]
            self._count()
            yield buf.pop()
        self._draining = False

    def _state(self):
        return {"buffer": list(self._buffer),
                "rng": self._ensure_rng().bit_generator.state,
                "draining": self._draining}

    def _load_state(self, state):
        self._buffer = list(state["buffer"])
        self._rng = np.random.default_rng(self.seed)
        self._rng.bit_generator.state = state["rng"]
        self._draining = bool(state["draining"])

    def _reset_local(self):
        self._buffer = []
        self._rng = None
        self._draining = False


class ParallelMap(Stage):
    """``fn`` over the stream on a bounded worker pool, order-preserving.

    Up to ``window`` samples (default ``2 * workers``) are in flight; the
    consumer side re-joins results in submission order, so the output
    sequence is deterministic regardless of worker scheduling — the
    property the resume guarantee rides on.  ``workers=0`` degrades to a
    synchronous map (no threads).  ``state_dict()`` quiesces the pool:
    in-flight results are drained (in order) into a pending buffer that
    ships with the state; worker exceptions re-raise consumer-side at
    their sequence position.
    """

    kind = "map"

    def __init__(self, upstream, fn, workers=0, window=None, name=None):
        super().__init__(upstream, name or "map")
        self.fn = fn
        self.workers = int(workers)
        self.window = int(window) if window is not None \
            else max(2 * self.workers, 1)
        if self.window < 1:
            raise ValueError("map window must be >= 1")
        self._pool = None
        self._futs = collections.deque()
        self._pending = collections.deque()
        self._up_iter = None
        self._up_eof = False

    def _ensure_pool(self):
        if self._pool is None and self.workers > 0:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=self.workers,
                thread_name_prefix=f"datapipe-{self.name}")
        return self._pool

    def _fill(self):
        """Top the in-flight window up from upstream."""
        from paddle_tpu_torch.profiler import runtime_metrics
        if self._up_iter is None and not self._up_eof:
            self._up_iter = iter(self._upstream)
        while len(self._futs) < self.window and not self._up_eof:
            try:
                sample = self._pull(self._up_iter)
            except StopIteration:
                self._up_eof = True
                self._up_iter = None
                break
            if self.workers > 0:
                self._futs.append(self._ensure_pool().submit(
                    self.fn, sample))
            else:
                # synchronous: apply now, park the result
                try:
                    self._pending.append(self.fn(sample))
                except BaseException as e:
                    self._pending.append(_Raised(e))
                break
        runtime_metrics.set_gauge(self._metrics + ".queue_depth",
                                  len(self._futs) + len(self._pending))

    def _iterate(self):
        while True:
            while self._pending:
                item = self._pending.popleft()
                if isinstance(item, _Raised):
                    raise item.exc
                self._count()
                yield item
            self._fill()
            if self._futs:
                fut = self._futs.popleft()
                self._count()
                yield fut.result()  # re-raises worker exceptions in order
                continue
            if self._pending:
                continue
            if self._up_eof:
                self._up_eof = False
                self._close_pool()
                return

    def _close_pool(self):
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def _shutdown(self):
        while self._futs:
            fut = self._futs.popleft()
            try:
                self._pending.append(fut.result())
            except BaseException as e:
                self._pending.append(_Raised(e))
        self._close_pool()
        if self._up_iter is not None:
            self._up_iter.close()
            self._up_iter = None

    def _state(self):
        pending = list(self._pending)
        if any(isinstance(p, _Raised) for p in pending):
            raise RuntimeError(
                f"map stage {self.name!r} holds a pending worker "
                f"exception; consume (and handle) it before "
                f"checkpointing")
        return {"pending": pending, "up_eof": self._up_eof}

    def _load_state(self, state):
        self._pending = collections.deque(state["pending"])
        self._up_eof = bool(state["up_eof"])

    def _reset_local(self):
        self._pending.clear()
        self._up_eof = False


def default_collate(samples):
    """Stack a list of samples along a new batch axis.  Dict samples
    become a dict of stacked arrays (the executor feed-dict shape),
    tuple/list samples a tuple of stacked slots, scalars/arrays one
    stacked array."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: np.stack([np.asarray(s[k]) for s in samples])
                for k in first}
    if isinstance(first, (tuple, list)):
        return tuple(np.stack([np.asarray(s[i]) for s in samples])
                     for i in range(len(first)))
    return np.stack([np.asarray(s) for s in samples])


def _pad_rows(arr, target):
    if arr.shape[0] >= target:
        return arr
    pad = np.zeros((target - arr.shape[0],) + arr.shape[1:],
                   dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


class Batch(Stage):
    """Group samples into batches of ``batch_size`` and collate.

    ``pad_to_bucket=True`` pads a short final batch's leading axis up to
    ``lod.row_bucket`` (capped at ``batch_size``), so the tail batch of
    every epoch reuses a warm jit-cache entry instead of compiling a
    one-off shape — the zero rows are the caller's to mask.  The partial
    batch under construction is part of ``state_dict``, so resume never
    drops tail samples."""

    kind = "batch"

    def __init__(self, upstream, batch_size, drop_last=False, collate=None,
                 pad_to_bucket=False, bucket_edges=None, name=None):
        super().__init__(upstream, name or "batch")
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.batch_size = int(batch_size)
        self.drop_last = drop_last
        self.collate = collate or default_collate
        self.pad_to_bucket = pad_to_bucket
        self.bucket_edges = bucket_edges
        self._partial = []

    def _emit(self, samples):
        batch = self.collate(samples)
        if self.pad_to_bucket and len(samples) < self.batch_size:
            from paddle_tpu_torch.lod import row_bucket
            target = min(row_bucket(len(samples), self.bucket_edges),
                         self.batch_size)
            if isinstance(batch, dict):
                batch = {k: _pad_rows(np.asarray(v), target)
                         for k, v in batch.items()}
            elif isinstance(batch, tuple):
                batch = tuple(_pad_rows(np.asarray(v), target)
                              for v in batch)
            else:
                batch = _pad_rows(np.asarray(batch), target)
        self._count()
        return batch

    def _iterate(self):
        up = iter(self._upstream)
        try:
            while True:
                try:
                    sample = self._pull(up)
                except StopIteration:
                    break
                self._partial.append(sample)
                if len(self._partial) == self.batch_size:
                    samples, self._partial = self._partial, []
                    yield self._emit(samples)
        finally:
            up.close()
        if self._partial and not self.drop_last:
            samples, self._partial = self._partial, []
            yield self._emit(samples)
        self._partial = []

    def _state(self):
        return {"partial": list(self._partial)}

    def _load_state(self, state):
        self._partial = list(state["partial"])

    def _reset_local(self):
        self._partial = []


class ShardIds(Stage):
    """Route embedding ids to their owning table shard.

    The sharded-table contract (``paddle_tpu_torch.embedding.tables``): a
    table ``P(axis, None)``-sharded over ``num_shards`` devices holds
    contiguous vocab *blocks*, so shard ``k`` owns ids
    ``[k*V/N, (k+1)*V/N)``.  This stage stamps each sample with the
    owner of every id in ``field`` (an ``int32`` array of the same
    shape, stored under ``owner_field``, default ``<field>_owner``) —
    the datapipe-side half of the reference's pserver prefetch routing,
    computed where it is cheap (host, per-sample) instead of in the
    step.  With ``shard_index`` given, the stage also tracks the
    fraction of ids NOT owned locally
    (``datapipe.<stage>.remote_frac`` gauge) — the cross-shard gather
    traffic an operator watches when re-bucketing ids.

    Stateless (a pure per-sample map), so resume is exact for free.
    Dict samples get a new key; tuple/list samples get the owner array
    appended.
    """

    kind = "shard_ids"

    def __init__(self, upstream, field, vocab_size, num_shards,
                 shard_index=None, owner_field=None, name=None):
        super().__init__(upstream, name or "shard_ids")
        from paddle_tpu_torch.embedding.tables import rows_per_shard
        self.field = field
        self.vocab_size = int(vocab_size)
        self.num_shards = int(num_shards)
        # validates divisibility eagerly — the same constraint PTA016
        # enforces on the table's PartitionSpec
        self._rows_per_shard = rows_per_shard(self.vocab_size,
                                              self.num_shards)
        self.shard_index = shard_index
        self.owner_field = owner_field or f"{field}_owner"

    def _route(self, sample):
        from paddle_tpu_torch.profiler import runtime_metrics
        ids = np.asarray(sample[self.field])
        if (ids < 0).any() or (ids >= self.vocab_size).any():
            raise ValueError(
                f"{self.name}: ids in {self.field!r} fall outside "
                f"[0, {self.vocab_size}) — a sharded gather would "
                f"silently drop them")
        owner = (ids // self._rows_per_shard).astype(np.int32)
        if self.shard_index is not None and owner.size:
            remote = float(np.mean(owner != self.shard_index))
            runtime_metrics.set_gauge(
                self._metrics + ".remote_frac", remote)
        if isinstance(sample, dict):
            out = dict(sample)
            out[self.owner_field] = owner
        else:
            out = type(sample)(list(sample) + [owner])
        self._count()
        return out

    def _iterate(self):
        up = iter(self._upstream)
        try:
            while True:
                try:
                    sample = self._pull(up)
                except StopIteration:
                    break
                yield self._route(sample)
        finally:
            up.close()
