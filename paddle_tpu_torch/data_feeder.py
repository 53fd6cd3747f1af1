"""DataFeeder: python lists/numpy -> feed dict with LoD handling (the
port's copy of ``paddle_tpu.data_feeder``; reference
``python/paddle/fluid/data_feeder.py:69``: ``DataToLoDTensorConverter:25``).

Ragged (lod_level>0) slots are converted to ``(flattened_values, lod)``
pairs, ``lod`` a list of levels of row splits (offsets), the form
``Executor.run`` takes (see ``paddle_tpu_torch.lod``).  The JAX package's
feeder hands out each level's sequence LENGTHS, which its executor then
reads as offsets; the port converts them (the same lengths, cumulated
from 0).  The feed dict holds host
arrays: ``Executor.run`` copies them to its device, as it does every
feed.  A bfloat16 slot is stacked as float32 (numpy has no bfloat16 of
its own; the JAX package stacks ml_dtypes bfloat16), which the executor
casts to the variable's dtype.
"""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.framework import Variable, default_main_program

__all__ = ["DataFeeder", "FeedShapeError"]


class FeedShapeError(ValueError):
    """Fed samples cannot be reshaped to a slot's declared shape (the
    PADDLE_ENFORCE analog at the feeder boundary — raised HERE, with the
    slot named, instead of letting a mis-shaped array surface as a deep
    trace error downstream)."""


def _offsets(lengths):
    """Row splits of a level of sequence lengths: ``[0, l0, l0 + l1,
    ...]``."""
    out = [0]
    for n in lengths:
        out.append(out[-1] + int(n))
    return out


class DataToLoDTensorConverter:
    def __init__(self, place, lod_level, shape, dtype, name=None):
        self.place = place
        self.lod_level = lod_level
        self.shape = shape
        self.name = name
        self.dtype = np.dtype(dtype if dtype != "bfloat16" else "float32")
        self.reset()

    def reset(self):
        """Clear accumulated samples so the converter can be reused for
        the next batch (DataFeeder caches converters across feed calls)."""
        self.data = []
        self.lod = [[] for _ in range(self.lod_level)]

    def _check_dtype(self, stacked):
        """Reject float samples headed into an integer slot: the dtype
        cast below would silently TRUNCATE them — the classic
        mis-wired-feed bug (labels and features swapped) that then
        trains on garbage without a peep.  ``stacked`` is the batch
        array built WITHOUT a forced dtype, so even one float sample in
        an otherwise-integer batch promotes its kind and is caught."""
        if stacked.dtype.kind in "fc" and self.dtype.kind in "iub":
            raise FeedShapeError(
                f"feed slot {self.name or '<unnamed>'!r}: got "
                f"{stacked.dtype.name} samples for a declared "
                f"{self.dtype.name} slot — refusing the silent "
                f"truncating cast (fix the feed order or the declared "
                f"dtype)")

    def feed(self, data):
        self._feed_impl_(data, self.lod, self.lod_level)

    def _feed_impl_(self, data, lod, lod_level):
        if lod_level == 0:
            self.data.append(data)
        else:
            lod[0].append(len(data))
            for each_data in data:
                self._feed_impl_(each_data, lod[1:], lod_level - 1)

    def _needs_truncation_check(self):
        # only integer/bool targets can silently truncate; float slots
        # keep the single cast-while-stacking path (no double convert
        # on the hot feed loop)
        return self.dtype.kind in "iub"

    def done(self):
        if self.lod_level == 0:
            if self.data and self._needs_truncation_check():
                # stack WITHOUT the target dtype first: mixed batches
                # promote (one float sample makes the whole batch kind
                # 'f'), so the truncation check sees every sample
                arr = np.asarray(self.data)
                self._check_dtype(arr)
                arr = arr.astype(self.dtype, copy=False)
            else:
                arr = np.array(self.data, dtype=self.dtype)
            inner = [d for d in self.shape[1:]] if self.shape else []
            # the strict reshape only makes sense when every non-batch
            # dim is concrete; with dynamic inner dims (-1/None) the
            # stacked sample array is already the right shape
            if inner and all(d is not None and d >= 0 for d in inner):
                try:
                    arr = arr.reshape([-1] + inner)
                except ValueError as e:
                    # a silent pass here used to feed the mis-shaped array
                    # downstream, failing much later inside a trace; name
                    # the slot and fail at the boundary instead
                    raise FeedShapeError(
                        f"feed slot {self.name or '<unnamed>'!r}: "
                        f"{len(self.data)} sample(s) with total shape "
                        f"{arr.shape} cannot be reshaped to declared "
                        f"shape {tuple(self.shape)}: {e}") from e
            return arr
        flat = []

        def _flatten(x):
            if isinstance(x, (list, tuple)):
                for e in x:
                    _flatten(e)
            else:
                flat.append(x)

        _flatten(self.data)
        if flat and self._needs_truncation_check():
            arr = np.asarray(flat)
            self._check_dtype(arr)
            arr = arr.astype(self.dtype, copy=False)
        else:
            arr = np.array(flat, dtype=self.dtype)
        inner = [d for d in self.shape if d != -1]
        if inner:
            arr = arr.reshape([-1] + inner)
        return (arr, [_offsets(level) for level in self.lod])


class DataFeeder:
    """reference ``data_feeder.py:69``."""

    def __init__(self, feed_list, place, program=None):
        self.feed_dtypes = []
        self.feed_names = []
        self.feed_shapes = []
        self.feed_lod_level = []
        program = program or default_main_program()
        for each_var in feed_list:
            if isinstance(each_var, str):
                each_var = program.global_block().var(each_var)
            if not isinstance(each_var, Variable):
                raise TypeError("feed_list should contain Variables or names")
            self.feed_names.append(each_var.name)
            self.feed_lod_level.append(each_var.lod_level)
            self.feed_shapes.append(each_var.shape)
            self.feed_dtypes.append(each_var.dtype)
        self.place = place
        self._converters = None
        self._feeding = False

    def feed(self, iterable):
        """Convert one batch of samples to a feed dict.

        NOT re-entrant: the converter set is cached across calls (built
        once, reset per batch), so one DataFeeder serves one feeding
        thread — overlapping calls would interleave two batches into
        one output array.  Concurrent misuse raises instead."""
        if self._feeding:
            raise RuntimeError(
                "DataFeeder.feed is not re-entrant (converters are "
                "cached across calls); use one DataFeeder per feeding "
                "thread")
        self._feeding = True
        try:
            return self._feed(iterable)
        finally:
            self._feeding = False

    def _feed(self, iterable):
        # converters are built once and reset per batch — the per-feed
        # construction cost (np.dtype parsing, per-slot allocation) used
        # to be paid on EVERY batch of the training loop
        if self._converters is None:
            self._converters = [
                DataToLoDTensorConverter(self.place, lod_level=lod,
                                         shape=shape, dtype=dtype, name=name)
                for lod, shape, dtype, name in zip(self.feed_lod_level,
                                                   self.feed_shapes,
                                                   self.feed_dtypes,
                                                   self.feed_names)]
        else:
            for conv in self._converters:
                conv.reset()
        converters = self._converters
        for each_sample in iterable:
            assert len(each_sample) == len(converters), \
                "sample arity != feed arity"
            for each_converter, each_slot in zip(converters, each_sample):
                each_converter.feed(each_slot)
        return {name: conv.done()
                for name, conv in zip(self.feed_names, converters)}
