"""Sharded, seekable source stages (the port's copy of
``paddle_tpu.datapipe.sources``).

A source owns the deterministic full sample stream of an epoch
(``_stream(epoch)``) and layers two things on top:

* **sharding** — sample-stride partitioning (``shard_index::num_shards``,
  the ``tf.data.Dataset.shard`` discipline): every trainer constructs
  the same source with its own ``shard_index`` and sees a disjoint,
  deterministic slice.  File-granular sharding is the degenerate case of
  handing each trainer its own glob;
* **position** — ``(epoch, offset)`` where ``offset`` counts samples
  already emitted to this shard's consumer this epoch.  Resume seeks by
  skipping ``offset`` samples of the deterministic stream (in-memory
  sources index directly), which is what makes the WHOLE pipeline's
  ``state_dict`` replayable.

The ``datapipe.source`` failpoint fires per emitted sample, so
``PADDLE_TPU_CHAOS`` can break the input stream exactly where a flaky
filesystem or decoder would.
"""

from __future__ import annotations

import glob as _glob
import itertools
import pickle

from paddle_tpu_torch.datapipe.core import Stage
from paddle_tpu_torch.fault import chaos as _chaos

__all__ = ["Source", "InMemorySource", "FileSource", "RecordIOSource"]


class Source(Stage):
    kind = "source"

    def __init__(self, num_shards=1, shard_index=0, name=None):
        super().__init__(None, name or "source")
        num_shards, shard_index = int(num_shards), int(shard_index)
        if num_shards < 1 or not 0 <= shard_index < num_shards:
            raise ValueError(
                f"bad sharding: shard_index={shard_index} of "
                f"num_shards={num_shards}")
        self.num_shards = num_shards
        self.shard_index = shard_index
        self._epoch = 0
        self._offset = 0
        # live stream cache: [iterator, (epoch, offset) it is positioned
        # at].  A downstream quiesce (state_dict per checkpoint) closes
        # the generator chain above the source; without this cache every
        # re-entry would rebuild the stream and re-skip O(offset)
        # samples — quadratic re-reads for file/recordio corpora.
        self._live = None

    @property
    def epoch(self):
        return self._epoch

    def close(self):
        """Release the cached live stream (open file handles for
        file-backed sources).  NOT done in ``_shutdown``: state_dict
        quiesces via _shutdown every checkpoint, and dropping the
        stream there would re-pay the O(offset) seek per save."""
        live, self._live = self._live, None
        if live is not None:
            closer = getattr(live[0], "close", None)
            if closer is not None:
                closer()
        super().close()

    def _stream(self, epoch):
        """The full (unsharded) deterministic sample stream of ``epoch``."""
        raise NotImplementedError

    def _shard_stream(self, epoch, skip):
        """This shard's stream with ``skip`` already-emitted samples
        dropped; subclasses with random access override for O(1) seeks."""
        it = itertools.islice(self._stream(epoch), self.shard_index, None,
                              self.num_shards)
        return itertools.islice(it, skip, None)

    def _iterate(self):
        while True:
            if self._live is None or \
                    self._live[1] != (self._epoch, self._offset):
                self._live = [
                    self._shard_stream(self._epoch, self._offset),
                    (self._epoch, self._offset)]
            live = self._live
            # fire BEFORE pulling: an armed error failpoint must leave
            # the cached stream positioned so a retry re-reads the same
            # sample instead of silently skipping it
            _chaos.fire("datapipe.source", epoch=self._epoch,
                        offset=self._offset)
            try:
                sample = next(live[0])
            except StopIteration:
                self._live = None
                self._epoch += 1
                self._offset = 0
                return
            self._offset += 1
            live[1] = (self._epoch, self._offset)
            self._count()
            yield sample

    def _state(self):
        # sharding geometry rides the state so a restore onto a
        # DIFFERENT dp degree (elastic shrink/grow) can reposition
        # instead of silently replaying/skipping the wrong stride
        return {"epoch": self._epoch, "offset": self._offset,
                "num_shards": self.num_shards,
                "shard_index": self.shard_index}

    def _load_state(self, state):
        self._epoch = int(state["epoch"])
        offset = int(state["offset"])
        saved_shards = int(state.get("num_shards", self.num_shards))
        if saved_shards != self.num_shards:
            # elastic resume: the stream was consumed with a different
            # stride.  All shards advance in lockstep (one batch per
            # step, checkpoints at step boundaries), so the saved
            # per-shard offset means ``saved_shards * offset`` samples
            # of the epoch are consumed globally; this shard resumes at
            # its slice of the remainder.  Exactly-once requires the
            # global position to land on a whole new-stride row — a
            # ragged cut would force replays (duplicates) or skips
            # (gaps), so it fails loudly instead.
            global_consumed = saved_shards * offset
            if global_consumed % self.num_shards:
                from paddle_tpu_torch.datapipe.core import PipelineStateError
                raise PipelineStateError(
                    f"source {self.name!r}: cannot reposition a "
                    f"checkpoint of {saved_shards} shard(s) at offset "
                    f"{offset} onto {self.num_shards} shard(s) — "
                    f"global position {global_consumed} does not align "
                    f"with the new stride (checkpoint at an aligned "
                    f"step, or restore onto the saved degree)")
            offset = global_consumed // self.num_shards
        self._offset = offset

    def _reset_local(self):
        self._epoch = 0
        self._offset = 0
        self._live = None


class InMemorySource(Source):
    """Samples from an in-memory sequence (list/tuple/array rows)."""

    def __init__(self, data, num_shards=1, shard_index=0, name=None):
        super().__init__(num_shards, shard_index, name)
        self._data = data

    def __len__(self):
        n, k = len(self._data), self.num_shards
        return (n - self.shard_index + k - 1) // k

    def _stream(self, epoch):
        return iter(self._data)

    def _shard_stream(self, epoch, skip):
        data = self._data
        start = self.shard_index + skip * self.num_shards
        return (data[i]                 # true O(1) seek: index directly
                for i in range(start, len(data), self.num_shards))


class FileSource(Source):
    """Lines of the files matching ``pattern`` (sorted; newline
    stripped), optionally parsed per line."""

    def __init__(self, pattern, parse=None, num_shards=1, shard_index=0,
                 name=None):
        super().__init__(num_shards, shard_index, name)
        self.pattern = pattern
        self.parse = parse

    def files(self):
        files = sorted(_glob.glob(self.pattern))
        if not files:
            raise FileNotFoundError(
                f"FileSource: no files match {self.pattern!r}")
        return files

    def _stream(self, epoch):
        for path in self.files():
            with open(path) as f:
                for line in f:
                    line = line.rstrip("\n")
                    yield self.parse(line) if self.parse else line


class RecordIOSource(Source):
    """Records of ``recordio_writer``-format files (glob pattern or
    explicit path list); each record decoded by ``load`` (default:
    ``pickle.loads``, the ``convert_reader_to_recordio_file`` inverse),
    read by the port's ``recordio_writer.RecordIOScanner``: a file
    either package wrote reads the same."""

    def __init__(self, paths, load=None, num_shards=1, shard_index=0,
                 name=None):
        super().__init__(num_shards, shard_index, name)
        self.paths = paths
        self.load = load if load is not None else pickle.loads

    def files(self):
        if isinstance(self.paths, str):
            files = sorted(_glob.glob(self.paths))
            if not files:
                raise FileNotFoundError(
                    f"RecordIOSource: no files match {self.paths!r}")
            return files
        return list(self.paths)

    def _stream(self, epoch):
        from paddle_tpu_torch.recordio_writer import RecordIOScanner
        for path in self.files():
            for rec in RecordIOScanner(path):
                yield self.load(rec)
