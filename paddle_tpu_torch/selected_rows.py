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

The slot count is static, as in the JAX package: a slot whose row lies
outside ``[0, height)`` stands for nothing (the tail slots of
:meth:`merge_duplicates` and the rows outside a section of
``split_selected_rows`` carry row ``height``).  The JAX package relies on
XLA dropping out-of-range scatter indices; a torch index out of range
raises (on the card: a device-side assert), and masking the slots by
value would give a shape that depends on the data.  So a dead slot is
made harmless where it is consumed: an additive consumer adds a zero at
a clamped row (:meth:`clamped`), and one that sets rows points it at a
live slot's row with that slot's own new value
(:func:`redirect_dead_slots`, :func:`gate_dead_slots`), so duplicate
indices always carry identical values.  A plain class, not a pytree: its
tensors live on the op's device.
"""

from __future__ import annotations

import torch

__all__ = ["SelectedRows", "is_selected_rows", "to_dense",
           "redirect_dead_slots", "gate_dead_slots"]


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

    def clamped(self):
        """``(rows, value)`` for an additive consumer: every slot's row
        clamped into the table and a dead slot's value zero, so it adds
        nothing."""
        live = _live(self.rows, self.height)
        value = torch.where(_rowwise(live, self.value), self.value,
                            torch.zeros_like(self.value))
        return self.rows.clamp(0, max(self.height - 1, 0)), value

    def to_dense(self):
        """The ``[height, ...]`` tensor (duplicate rows accumulate)."""
        rows, value = self.clamped()
        out = torch.zeros(self.shape, dtype=self.value.dtype,
                          device=self.value.device)
        return out.index_add_(0, rows, value)

    def merge_duplicates(self):
        """Combine duplicate rows by summation, with the JAX package's
        contract: the result has the same slot count; its first slots
        hold the sorted unique rows, each with its summed value, and the
        tail slots row ``height`` and value 0.  Each group is summed in
        slot order by one ``embedding_bag`` bag (a fixed order on the
        card too, where a scatter-add's atomics would sum in a new order
        each run); the groups' starts are a sort of the heads, so no
        shape depends on the data."""
        n = self.rows.shape[0]
        if n == 0:
            return self
        sorted_rows, order = torch.sort(self.rows, stable=True)
        slots = torch.arange(n, device=self.rows.device)
        is_head = torch.ones_like(sorted_rows, dtype=torch.bool)
        is_head[1:] = sorted_rows[1:] != sorted_rows[:-1]
        # group g starts at starts[g]; the groups past the last start at n
        starts = torch.sort(torch.where(is_head, slots,
                                        torch.full_like(slots, n))).values
        flat = self.value.reshape(n, -1).index_select(0, order)
        summed = torch.nn.functional.embedding_bag(
            slots, flat, starts, mode="sum")
        rows = torch.where(starts < n,
                           sorted_rows.gather(0, starts.clamp(max=n - 1)),
                           torch.full_like(sorted_rows, self.height))
        return SelectedRows(rows, summed.reshape(self.value.shape),
                            self.height)


def _live(rows, height):
    return (rows >= 0) & (rows < height)


def _rowwise(mask, like):
    """``mask`` ``[N]`` shaped to broadcast over ``like``'s rows."""
    return mask.reshape((-1,) + (1,) * (like.ndim - 1))


def redirect_dead_slots(rows, height):
    """``(live, idx, first)`` for an update that sets rows: which slots
    are live, every slot's row (a dead slot's is the row of the first
    live slot, ``first``; the first row, clamped, when none is live) and
    ``first`` itself (``[1]``)."""
    live = _live(rows, height)
    first = live.to(torch.int32).argmax().reshape(1)
    anchor = rows.index_select(0, first).clamp(0, max(height - 1, 0))
    return live, torch.where(live, rows, anchor), first


def gate_dead_slots(live, first, new, old):
    """The rows an update writes at :func:`redirect_dead_slots`' ``idx``:
    ``new`` in the live slots; in a dead one the first live slot's new
    row (the same row, the same value), or the row's ``old`` value when
    no slot is live (the update changes nothing)."""
    fill = torch.where(_rowwise(live.index_select(0, first), new),
                       new.index_select(0, first),
                       old.index_select(0, first))
    return torch.where(_rowwise(live, new), new, fill)


def is_selected_rows(v):
    return isinstance(v, SelectedRows)


def to_dense(v):
    return v.to_dense() if isinstance(v, SelectedRows) else v
