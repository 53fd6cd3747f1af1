"""Row-sharded embedding tables over the mesh (the port's counterpart of
``paddle_tpu.embedding.sharded_table``).

The reference scales CTR embedding tables past one host by splitting
them into pserver blocks and rewriting lookups into ``prefetch_op`` RPCs
(``distribute_transpiler.py``'s sparse branch).  Here the program stays
untouched and the split is a partition spec on the vocab dim —
``P(axis, None)`` — which the PTA016/PTA017 pass can *prove* against the
program before anything runs.

:func:`plan_sharded_tables` is the planning front door: it finds every
``is_distributed`` lookup table of a program, shards the table AND its
row-shaped optimizer accumulators (the sparse Adam moments live with
their rows), verifies the whole plan through
``analysis.distributed.check_distributed_spec``, and hands back rules
for ``ParallelExecutor(param_shardings=...)`` and the placements for
the mesh checkpoints (``CheckpointManager(shard_specs=...)``).

:func:`sharded_gather` / :func:`sharded_scatter_add` are the explicit
exchange on one rank's block of a table, over the ``axis`` of a mesh, as
the ``c_*`` collectives take it (the JAX package's take a ``shard_map``
axis name).

Under ``ParallelExecutor`` a planned table is a DTensor split on dim 0
(``Shard(0)``) over its axis.  The ops that touch it route by row
ownership (``tables.owner_of`` / ``local_row``'s block layout) instead
of DTensor's own rules, which do not cover them: ``lookup_table`` is a
:func:`sharded_gather` of the whole ids (:func:`lookup_rows`), its
``SelectedRows`` grad is made whole on every rank, and the sparse
``sgd`` / ``adam`` / ``adagrad`` updates write the owned rows of each
rank's block in place (:func:`local_rows`), every other row of the
grad becoming a dead slot.  The arithmetic of a row is the one-device
run's, so the result is bitwise the same.  A table left replicated
takes the same route with the whole table as its block
(:func:`row_blocks`), since DTensor has no rule for the sparse update's
row merge either.
"""

from __future__ import annotations

import re

import torch

from paddle_tpu_torch.convert import is_dtensor
from paddle_tpu_torch.embedding import tables as _tables

#: ``parallel.mesh.MODEL_AXIS``; the package imports this module, and
#: ``parallel`` (DTensor) only where a mesh is used
MODEL_AXIS = "model"

__all__ = ["ShardedTablePlan", "plan_sharded_tables", "sharded_gather",
           "sharded_scatter_add", "row_shard", "replicated",
           "lookup_rows", "whole", "local_rows", "row_blocks"]


class ShardedTablePlan:
    """The sharding facts of one program's distributed tables:
    ``tables`` maps table param name -> placement tuple
    (``(axis, None)``), ``states`` the row-shaped optimizer accumulators
    riding along, ``diagnostics`` the PTA016/PTA017 verdict the plan was
    proven with."""

    def __init__(self, program, axis):
        self.program = program
        self.axis = axis
        self.tables = {}       # table name -> (axis, None)
        self.states = {}       # accumulator name -> (axis, None, ...)
        self.diagnostics = []

    def __bool__(self):
        return bool(self.tables)

    def all_placements(self):
        merged = dict(self.tables)
        merged.update(self.states)
        return merged

    def rules(self):
        """``(regex, P)`` rules for ``ParallelExecutor(param_shardings=
        ...)``.  Covering the accumulators here also excludes them from
        the executor's ZeRO plan (user rules come first), keeping one
        owner per tensor."""
        from paddle_tpu_torch.parallel.mesh import P
        return [(f"^{re.escape(name)}$", P(*spec))
                for name, spec in sorted(self.all_placements().items())]

    def checkpoint_specs(self):
        """name -> placement tuple for ``CheckpointManager(shard_specs=
        ...)`` / ``io.save_checkpoint(shard_specs=...)``: each table (and
        its moments) is saved one vocab block a shard."""
        return dict(self.all_placements())


def plan_sharded_tables(program, mesh_axis=MODEL_AXIS, mesh=None,
                        mesh_axes=None, raise_on_error=True):
    """Build and *prove* the row-sharding plan for every
    ``is_distributed`` lookup table in ``program``.

    The table parameter is placed ``P(mesh_axis, None)`` (vocab dim
    blocked over the axis), and every row-shaped optimizer state slot of
    that parameter (Moment1/Moment2/...) is placed identically — scalar
    slots (Beta1Pow) stay replicated.  The plan is then run through
    ``check_distributed_spec``: PTA016 facts (unknown axis, indivisible
    vocab, param/state disagreement) raise ``ProgramVerificationError``
    unless ``raise_on_error=False``.

    ``mesh`` (or a ``mesh_axes`` name->size dict) adds the axis-size
    divisibility proof; without either, the plan is only proven
    structurally.
    """
    from paddle_tpu_torch import profiler as _profiler
    from paddle_tpu_torch.analysis import (AnalysisResult,
                                           check_distributed_spec)
    from paddle_tpu_torch.parallel.distribute_transpiler import \
        DistributedSpec
    from paddle_tpu_torch.parallel.mesh import P
    from paddle_tpu_torch.parallel.zero import OPTIMIZER_STATE_SLOTS

    block = program.global_block()
    plan = ShardedTablePlan(program, mesh_axis)

    for op in block.ops:
        if op.type != "lookup_table" or not op.attr("is_distributed",
                                                    False):
            continue
        w = op.input("W")[0]
        var = block.var(w)
        if not var.shape or len(var.shape) < 2:
            continue
        plan.tables[w] = (mesh_axis, None)
        _tables.register_table(w, vocab=var.shape[0], dim=var.shape[1])

    # the tables' optimizer accumulators: row-shaped slots shard with
    # their rows, scalar slots (Beta1Pow/Beta2Pow) stay replicated
    for op in block.ops:
        slots = OPTIMIZER_STATE_SLOTS.get(op.type)
        if not slots or "Param" not in op.inputs:
            continue
        param = op.input("Param")[0]
        if param not in plan.tables:
            continue
        pshape = block.var(param).shape
        for slot in slots:
            for name in op.inputs.get(slot, ()):
                sshape = block.var(name).shape
                if sshape and tuple(sshape) == tuple(pshape):
                    plan.states[name] = (mesh_axis,) + (None,) * (
                        len(sshape) - 1)

    if mesh is not None and mesh_axes is None:
        mesh_axes = dict(zip(mesh.mesh_dim_names, mesh.shape))

    spec = DistributedSpec()
    spec.param_specs = {name: P(*placement)
                        for name, placement
                        in plan.all_placements().items()}
    plan.diagnostics = check_distributed_spec(program, spec,
                                              mesh_axes=mesh_axes)
    if raise_on_error:
        AnalysisResult(plan.diagnostics).raise_on_errors(
            where="embedding.plan_sharded_tables")
    _profiler.runtime_metrics.inc("embedding.plans")
    return plan


# -- the exchange on one rank's block (parallel/collective.py) --------------

def _block_rank(w_block, axis_name, mesh):
    from paddle_tpu_torch.parallel.collective import _mesh
    mesh = _mesh(mesh)
    return mesh, w_block.shape[0], mesh.get_local_rank(axis_name)


def sharded_gather(w_block, ids, axis_name, mesh=None):
    """Gather rows by *global* id from a block-sharded table: each rank
    resolves the ids it owns (block layout — ``tables.owner_of``),
    contributes zeros elsewhere, and one ``all_reduce`` over the axis
    assembles the result (exactly one owner per id, so the sum IS the
    gather — the prefetch RPC of the reference as a collective).  Every
    rank of the axis must pass the same ids.  At an axis of one rank no
    collective runs (as DTensor elides one)."""
    from paddle_tpu_torch.parallel import collective
    mesh, rows, rank = _block_rank(w_block, axis_name, mesh)
    local = ids.long() - rank * rows
    owned = (local >= 0) & (local < rows)
    vals = w_block.index_select(0, local.clamp(0, rows - 1).reshape(-1))
    vals = vals.reshape(tuple(ids.shape) + tuple(w_block.shape[1:]))
    vals = torch.where(owned.reshape(owned.shape + (1,) * (
        w_block.ndim - 1)), vals, torch.zeros((), dtype=vals.dtype,
                                              device=vals.device))
    if dict(zip(mesh.mesh_dim_names, mesh.shape))[axis_name] == 1:
        return vals
    return collective.all_reduce(vals, axis_name, mesh=mesh)


def sharded_scatter_add(w_block, row_ids, vals, axis_name, mesh=None):
    """Scatter-add SelectedRows-style ``(row_ids, vals)`` updates into a
    block-sharded table: each rank keeps only the rows it owns and drops
    the rest (they land in a dead row past the block), so no collective
    is needed — the rows were already routed by ownership.  Returns the
    new block."""
    mesh, rows, rank = _block_rank(w_block, axis_name, mesh)
    local = row_ids.long().reshape(-1) - rank * rows
    dropped = torch.where((local >= 0) & (local < rows), local,
                          torch.full_like(local, rows))
    out = torch.cat([w_block, w_block.new_zeros((1,) + tuple(
        w_block.shape[1:]))])
    out.index_add_(0, dropped, vals.reshape((-1,) + tuple(
        w_block.shape[1:])).to(w_block.dtype))
    return out[:rows]


# -- row-sharded tables under ParallelExecutor -------------------------------

def row_shard(t):
    """``(mesh, axis name)`` when ``t`` is a DTensor split on dim 0 over
    one mesh axis and replicated on the others (a planned table or one
    of its moments); None otherwise, for DTensor's own rules."""
    if not is_dtensor(t):
        return None
    split = [(name, p) for name, p in zip(t.device_mesh.mesh_dim_names,
                                          t.placements)
             if not p.is_replicate()]
    if len(split) != 1 or not split[0][1].is_shard() or \
            split[0][1].dim != 0:
        return None
    return t.device_mesh, split[0][0]


def whole(t):
    """The whole value of ``t`` on this rank: a DTensor's global tensor
    (a collective where it is split), a tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def lookup_rows(w, ids, shard):
    """``lookup_table`` of a row-sharded table ``w`` at ``ids`` (any
    shape): the rows ``[*ids.shape, dim]`` by :func:`sharded_gather` of
    the whole ids, with ``ops.tensor_ops.take_rows``' rules (a negative
    id counts from the end, one still out of range gives a NaN row), as
    a DTensor replicated on the mesh, then placed as the ids are where
    they are a DTensor (a split of the ids' dims is a local cut)."""
    from torch.distributed.tensor import DTensor, Replicate
    from paddle_tpu_torch.ops.tensor_ops import _fill_value, _wrap_rows
    mesh, axis = shard
    n = w.shape[0]
    idx, valid = _wrap_rows(whole(ids).long(), n)
    out = sharded_gather(w.to_local(), idx.clamp(0, max(n - 1, 0)), axis,
                         mesh)
    out = torch.where(valid.reshape(tuple(idx.shape) + (1,) * (w.ndim - 1)),
                      out, torch.full((), _fill_value(out.dtype),
                                      dtype=out.dtype, device=out.device))
    out = DTensor.from_local(out, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    if is_dtensor(ids) and any(p.is_shard() for p in ids.placements):
        out = out.redistribute(mesh, ids.placements)
    return out


def local_rows(g, shard, height):
    """A SelectedRows grad of a row-sharded table of ``height`` rows,
    made whole on every rank, as a SelectedRows over this rank's block:
    an owned row at its local index, every other row a dead slot (the
    block's height), its value kept."""
    from paddle_tpu_torch.selected_rows import SelectedRows
    mesh, axis = shard
    per = _tables.rows_per_shard(height, dict(zip(
        mesh.mesh_dim_names, mesh.shape))[axis])
    rows = whole(g.rows).long() - mesh.get_local_rank(axis) * per
    owned = (rows >= 0) & (rows < per)
    return SelectedRows(torch.where(owned, rows, torch.full_like(rows, per)),
                        whole(g.value), per)


def replicated(t):
    """``t`` is a DTensor replicated on every axis of its mesh."""
    return is_dtensor(t) and all(p.is_replicate() for p in t.placements)


def row_blocks(g, *tables):
    """``(g, blocks, wrap)`` for a sparse update of ``tables`` (a table
    and its row-shaped state, DTensors placed alike) by the SelectedRows
    ``g``: ``g`` over this rank's block (:func:`local_rows`; where the
    tables are replicated, ``g`` whole and the block the whole table),
    the tables' local blocks, which the update writes in place, and
    ``wrap(block, like)`` turning an updated block back into a DTensor
    placed as ``like``.  Tables placed otherwise come back as they are,
    with ``wrap`` the identity, for DTensor's own rules."""
    from paddle_tpu_torch.selected_rows import SelectedRows
    shard = row_shard(tables[0])
    if shard is None and not replicated(tables[0]):
        return g, tables, lambda t, like: t
    if any(tuple(t.placements) != tuple(tables[0].placements) or
           t.shape[0] != tables[0].shape[0] for t in tables[1:]):
        raise ValueError(
            "a sparse update of a row-sharded table needs its row-shaped "
            "state split alike (plan_sharded_tables places both)")
    from torch.distributed.tensor import DTensor

    def wrap(t, like):
        return DTensor.from_local(t, like.device_mesh, like.placements,
                                  run_check=False, shape=like.shape,
                                  stride=like.stride())

    g = local_rows(g, shard, tables[0].shape[0]) if shard is not None \
        else SelectedRows(whole(g.rows), whole(g.value), g.height)
    return g, [t.to_local() for t in tables], wrap
