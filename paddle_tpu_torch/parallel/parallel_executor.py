"""ParallelExecutor: one training step over a mesh of ranks (the port's
counterpart of ``paddle_tpu.parallel.parallel_executor``; reference
``python/paddle/fluid/parallel_executor.py:23`` over
``paddle/fluid/framework/parallel_executor.cc:53``).

It computes what the JAX package's GSPMD step computes: the GLOBAL step,
the same values as ``Executor.run`` of the whole batch on one device.
The executor's op walk runs on DTensors over the mesh (PyTorch's
counterpart of GSPMD): each value carries its placements, and DTensor's
sharding propagation inserts the collectives an op needs, so batch
statistics, sums and means over the batch and fetched scalars are
global without any op knowing it.

  feeds         -> ``Shard(batch_axis)`` on the ``data`` axis when the
                   batch divides by its size, else replicated (the JAX
                   package's ``feed_sharding``; at a ``data`` axis of
                   size 1 the feed is a one-piece shard, so the same
                   propagation, collectives included, runs at world
                   size 1)
  params/state  -> the first ``param_shardings`` rule matching the name
                   (``(regex, P)``), replicated when none matches, the
                   shape cannot split (``spec_fits``) or the var holds
                   one value; ZeRO's accumulator rules come after the
                   user's
  written state -> redistributed back to its own placement after the
                   step (JAX's ``out_shardings``)
  fetches       -> the global value, on every rank

The state in the scope is DTensors once a step ran.  At its first step
each state tensor is broadcast from the mesh's first rank before it is
placed (the reference's ``BCastParamsToGPUs``), so ranks whose startup
programs drew other weights agree.  The user's program is not changed:
no collective op is written into it.  Kernels get local shards: the
bias-softmax wrappers run on a DTensor's local rows
(``kernels/bias_softmax.py``).  Random ops draw per rank from the
executor's generators: with dropout on, the ranks' masks of a split
batch differ from a single device's, so parity holds at dropout 0.

Nothing falls back: an op that DTensor cannot run raises.  Two
lowerings whose torch calls DTensor refuses run on local shards
instead (``convert.on_local_shards``): the batched ``matmul`` of two
tensors split alike over batch dims (torch's matmul folds those dims
with a view, which torch 2.11's DTensor refuses when two of them are
split over different mesh axes, as attention's batch and heads are),
and the max pool's grad (an in-place scatter into a new tensor).  An
embedding table's lookups, ``SelectedRows`` grads and sparse optimizer
updates, which DTensor has no rules for, run by row ownership on each
rank's block of the table (``embedding.sharded_table``: a
``plan_sharded_tables`` table split by rows, or a replicated one whole).

On the card a parallel signature runs as a CUDA graph by the executor's
rule (``step_graph.StepGraph``: the first step eager, the second
captured, then replays): the capture records the kernels the DTensor
dispatch launches, collectives included, and a replay runs them without
the Python dispatch; the state's local shards are the graph's buffers.
At world size 1 a step has no collective (DTensor skips one-rank mesh
axes); a capture that holds NCCL collectives (world size > 1) has not
run on a card yet (the card checks run at world size 1).
``program._opt_interpret
= True`` keeps a program eager.  :meth:`graph_stats` lists every
parallel signature, ``"graphed"`` True or False and, for an eager one,
why.  ``count_collectives`` counts the
collectives of the following steps (calls and input bytes by op,
``collective_stats``) through a dispatch mode that sees every op, so it
is for measuring, not for steady state.
"""

from __future__ import annotations

import re
from contextlib import nullcontext

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode

from paddle_tpu_torch.convert import to_tensor
from paddle_tpu_torch.executor import Executor
from paddle_tpu_torch.framework import default_main_program
from paddle_tpu_torch.parallel.mesh import (DATA_AXIS, P, axis_sizes,
                                            default_mesh, mesh_size,
                                            placements, spec_fits)
from paddle_tpu_torch.place import CPUPlace, CUDAPlace
from paddle_tpu_torch.step_graph import StepGraph

__all__ = ["ParallelExecutor"]

_COMM_NAMESPACES = ("_c10d_functional", "c10d")


class _CollectiveCounter(TorchDispatchMode):
    """Counts the collectives dispatched under it: calls and the bytes of
    their tensor inputs, by op name."""

    def __init__(self):
        super().__init__()
        self.calls = {}
        self.bytes = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor run first: its redistributions dispatch their
            # collectives on plain tensors, which come back through here
            return NotImplemented
        ns = getattr(func, "namespace", None)
        name = func.__name__.split(".")[0]
        if ns in _COMM_NAMESPACES and not name.startswith(("wait",
                                                          "_wrap")):
            nbytes = 0
            for a in list(args) + list((kwargs or {}).values()):
                for t in (a if isinstance(a, (list, tuple)) else (a,)):
                    if isinstance(t, torch.Tensor):
                        nbytes += t.numel() * t.element_size()
            self.calls[name] = self.calls.get(name, 0) + 1
            self.bytes[name] = self.bytes.get(name, 0) + nbytes
        return func(*args, **(kwargs or {}))


class ParallelExecutor(Executor):
    """``Executor`` over ``mesh`` (default: the default mesh).  The place
    follows the mesh: this rank's card under NCCL, the CPU under gloo."""

    def __init__(self, use_cuda=True, loss_name=None, main_program=None,
                 share_vars_from=None, num_threads=None, mesh=None,
                 batch_axis=0, param_shardings=None, zero=False):
        self.mesh = mesh if mesh is not None else default_mesh()
        place = CPUPlace() if self.mesh.device_type == "cpu" else \
            CUDAPlace(torch.cuda.current_device())
        super().__init__(place)
        self.loss_name = loss_name
        self.batch_axis = batch_axis
        self._main_program = main_program
        # [(compiled regex, P)] — first match wins
        self.param_shardings = [(re.compile(pat), P(*spec))
                                for pat, spec in (param_shardings or [])]
        # ZeRO: the accumulators split over the data axis, the plan proved
        # by the PTA016/PTA017 pass first; user rules keep precedence
        self.zero_plan = None
        if zero:
            from paddle_tpu_torch.parallel.zero import zero_plan
            axis = zero if isinstance(zero, str) else DATA_AXIS
            program = main_program or default_main_program()
            skip = (lambda name: any(pat.search(name) for pat, _ in
                                     self.param_shardings)) \
                if self.param_shardings else None
            plan = zero_plan(program, self.mesh, axis=axis, skip=skip)
            plan.verify()
            self.zero_plan = plan
            self.param_shardings += [(re.compile(pat), spec)
                                     for pat, spec in plan.rules()]
        ranks = self.mesh.mesh.flatten().tolist()
        self._root = int(ranks[0])
        # the broadcast of the first step's state spans the whole mesh
        self._group = None if len(ranks) == dist.get_world_size() else \
            dist.new_group(sorted(ranks))
        self.count_collectives = False
        #: ``{"calls": {op: n}, "bytes": {op: n}}`` of the last counted step
        self.collective_stats = None
        #: ``{"calls", "bytes"}`` of the first steps' state broadcasts
        self.broadcast_stats = {"calls": 0, "bytes": 0}

    @property
    def device_count(self):
        return mesh_size(self.mesh)

    def run(self, fetch_list=None, feed=None, feed_dict=None, program=None,
            return_numpy=True, scope=None, sentinel=None):
        feed = feed if feed is not None else (feed_dict or {})
        program = program or self._main_program or default_main_program()
        return super().run(program=program, feed=feed,
                           fetch_list=fetch_list, scope=scope,
                           return_numpy=return_numpy, sentinel=sentinel)

    def graph_stats(self):
        """One entry per cached parallel signature: a graph's stats
        (``StepGraph.stats``) with ``"graphed": True``, or ``"graphed":
        False`` and why the step runs eagerly."""
        with self._lock:
            entries = list(self._cache.values())
        out = []
        for c in entries:
            if isinstance(c.fn, StepGraph):
                out.append(dict(c.fn.stats(), graphed=True))
            else:
                out.append({"signature": c.label, "graphed": False,
                            "reason": "the CPU runs the eager step"
                            if self.device.type == "cpu" else
                            "the capture rule keeps the block eager"})
        return out

    # ------------------------------------------------------------------
    def _step_aux(self):
        return {"mesh": self.mesh}

    def _spec(self, name, shape):
        if shape is not None and int(np.prod(shape)) == 1:
            # one value (a beta power, a learning rate): replicated, as
            # the JAX package's scalar slots are, whatever rule matches
            return P()
        for pat, spec in self.param_shardings:
            if pat.search(name):
                if shape is None or spec_fits(spec, tuple(shape),
                                              self.mesh):
                    return spec
                break  # the rule matched but the shape cannot split
        return P()

    def _feed_placements(self, t):
        size = axis_sizes(self.mesh).get(DATA_AXIS)
        if size is not None and t.ndim > self.batch_axis and \
                t.shape[self.batch_axis] % size == 0:
            spec = [None] * t.ndim
            spec[self.batch_axis] = DATA_AXIS
            return placements(P(*spec), self.mesh)
        return placements(P(), self.mesh)

    def _distribute(self, t, target):
        """A whole tensor, equal on every rank, as a DTensor with
        ``target`` placements: each rank keeps its own piece."""
        return distribute_tensor(t, self.mesh, target, src_data_rank=None)

    def _place_state(self, scope, names):
        """Every state tensor ``names`` reads as a DTensor at its own
        placement; a plain one is broadcast from the mesh's first rank
        first (the first step's agreement)."""
        for n in names:
            v = scope.find_var(n)
            if not isinstance(v, torch.Tensor):
                if v is None or not hasattr(v, "shape"):
                    continue
                v = to_tensor(v, self.device)
            target = placements(self._spec(n, tuple(v.shape)), self.mesh)
            if isinstance(v, DTensor):
                if v.device_mesh is self.mesh and \
                        tuple(v.placements) == tuple(target):
                    continue
                if v.device_mesh is not self.mesh:
                    v = v.full_tensor()
                else:
                    scope.set_var(n, v.redistribute(self.mesh, target))
                    continue
            v = v.to(self.device).contiguous()
            dist.broadcast(v, self._root, group=self._group)
            self.broadcast_stats["calls"] += 1
            self.broadcast_stats["bytes"] += v.numel() * v.element_size()
            scope.set_var(n, self._distribute(v, target))

    def _written(self, name, value):
        """A written state value back at its own placement."""
        if not isinstance(value, torch.Tensor):
            return value
        target = placements(self._spec(name, tuple(value.shape)),
                            self.mesh)
        if isinstance(value, DTensor):
            if tuple(value.placements) == tuple(target):
                return value
            return value.redistribute(self.mesh, target)
        return self._distribute(value, target)

    def _prepare(self, program, block, feeds, fetch_names, scope,
                 guarded=False):
        parts = super()._prepare(program, block, feeds, fetch_names, scope,
                                 guarded)
        base = parts["step"]
        read = parts["ro_names"] + parts["inout_names"]
        mesh = self.mesh

        def step(feeds, rng_seed, generators, capturing):
            self._place_state(scope, read)
            dfeeds = {n: DTensor.from_local(
                t, mesh, _replicate(mesh), run_check=False).redistribute(
                    mesh, self._feed_placements(t)) if t.ndim else t
                for n, t in feeds.items()}
            counter = _CollectiveCounter() if self.count_collectives \
                else None
            with implicit_replication(), counter or nullcontext():
                fetches, new_state, loaded, stats = base(
                    dfeeds, rng_seed, generators, capturing)
                new_state = {n: self._written(n, v)
                             for n, v in new_state.items()}
                fetches = [v.full_tensor() if isinstance(v, DTensor)
                           else v for v in fetches]
            if counter is not None:
                self.collective_stats = {"calls": counter.calls,
                                         "bytes": counter.bytes}
            return fetches, new_state, loaded, stats

        parts["step"] = step
        return parts

    def _get_compiled(self, program, block, feeds, fetch_names, scope,
                      guarded=False):
        compiled = super()._get_compiled(program, block, feeds, fetch_names,
                                         scope, guarded)
        if not hasattr(compiled, "label"):
            compiled.label = ",".join(
                f"{n}{list(feeds[n].shape)}" for n in sorted(feeds)) + \
                f" -> {len(fetch_names)} fetches"
        return compiled


def _replicate(mesh):
    return placements(P(), mesh)
