"""SelectedRows: the sparse row-subset gradient value (the port of
``paddle_tpu.selected_rows``; reference
``paddle/fluid/framework/selected_rows.h``, functors
``operators/math/selected_rows_functor.cc``).

A ``(rows, value)`` pair standing for a ``[height, ...]`` tensor that is
zero outside ``rows``.  ``lookup_table_grad`` produces one when the
embedding was built with ``is_sparse=True``; the sparse branches of the
``sgd``, ``adam`` and ``adagrad`` ops consume it directly, so the
full-vocab dense gradient is never made and a step costs O(batch·dim)
instead of O(vocab·dim).  Any other op slot reads it densified (the
registry's ``selected_rows_inputs``).

``rows`` may repeat (one slot per occurrence in the batch): linear
consumers (``sgd``, ``sum``) scatter-add directly, the non-linear ones
(the ``adagrad`` and ``adam`` moments) call :meth:`merge_duplicates`
first, the counterpart of the reference's ``scatter::MergeAdd``.

Slots whose row is ``height`` or more stand for nothing: the tail slots
of :meth:`merge_duplicates` and the rows outside a section of
``split_selected_rows`` carry row ``height``.  The JAX package relies on
jax dropping out-of-range scatter indices; torch indexing raises on one
(on the card: a device-side assert), so every consumer here indexes
through :meth:`live` and drops them first.  A plain class, not a pytree:
its tensors live on the op's device.
"""

from __future__ import annotations

import torch

__all__ = ["SelectedRows", "is_selected_rows", "to_dense"]


class SelectedRows:
    def __init__(self, rows, value, height):
        self.rows = rows            # [N] int64 tensor
        self.value = value          # [N, ...] tensor
        self.height = int(height)   # the logical dim-0 extent

    @property
    def dtype(self):
        return self.value.dtype

    @property
    def shape(self):
        return (self.height,) + tuple(self.value.shape[1:])

    def astype(self, dtype):
        return SelectedRows(self.rows, self.value.to(dtype), self.height)

    def live(self):
        """``(rows, value)`` of the slots whose row lies below ``height``."""
        keep = self.rows < self.height
        return self.rows[keep], self.value[keep]

    def to_dense(self):
        """The ``[height, ...]`` tensor (duplicate rows accumulate)."""
        rows, value = self.live()
        out = torch.zeros(self.shape, dtype=self.value.dtype,
                          device=self.value.device)
        return out.index_add_(0, rows, value)

    def merge_duplicates(self):
        """Combine duplicate rows by summation, with the JAX package's
        contract: the result has the same slot count; its first slots
        hold the sorted unique rows, each with its summed value, and the
        tail slots row ``height`` and value 0."""
        sorted_rows, order = torch.sort(self.rows)
        is_head = torch.ones_like(sorted_rows, dtype=torch.bool)
        is_head[1:] = sorted_rows[1:] != sorted_rows[:-1]
        seg = torch.cumsum(is_head, 0) - 1          # group of each slot
        value = torch.zeros_like(self.value).index_add_(
            0, seg, self.value[order])
        rows = torch.full_like(sorted_rows, self.height)
        rows[seg] = sorted_rows                      # one value a group
        return SelectedRows(rows, value, self.height)


def is_selected_rows(v):
    return isinstance(v, SelectedRows)


def to_dense(v):
    return v.to_dense() if isinstance(v, SelectedRows) else v
