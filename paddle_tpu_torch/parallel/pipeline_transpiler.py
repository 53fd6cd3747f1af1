"""IR-level pipeline partitioning: split a Program's op list into P
balanced stages and run it as a GPipe pipeline (the port's counterpart of
``paddle_tpu.parallel.pipeline_transpiler``, completing
``parallel/pipeline.py``'s primitive into a framework feature).

The reference has no pipeline parallelism; the JAX package added it, and
the port keeps its design:

* ``split_program``: walk the global block's ops in program order,
  weight them with the static FLOP model (``analysis.cost.op_flops``),
  and cut at the P-quantiles of cumulative cost.  Any cut is legal:
  everything produced before the cut and consumed after it becomes part
  of the boundary *carrier*.  Ops that carry sub-blocks (while / cond /
  DynamicRNN) are atomic — never split across a cut — and their
  lowerings recurse into their sub-block as the executor's
  ``lower_block`` does.  The split sees the same IR as the JAX package's
  and cuts at the same places.
* Stages are NON-homogeneous.  Each stage's parameters are flat-packed
  into TYPED LANES — one flat vector per dtype class (``f32``, ``bf16``,
  ``i32``) — padded to a common per-lane length and stacked [P, L_lane].
* Activations and feeds cross boundaries the same way: one flat carrier
  per lane of uniform (max-boundary) length.  Integers ride the i32 lane
  exactly; bf16 values keep bf16 width (``torch.bfloat16``); other
  floats ride f32.  Lanes that no boundary or parameter uses are dropped.
* Microbatches feed STAGE 0 ONLY: each rank takes its contiguous block of
  B = M / P microbatches of the [M, L] ingest tensors; after every B
  ticks the blocks hop one rank toward stage 0, arriving when stage 0
  needs them.
* ``run_fn`` is differentiable: autograd through it gives the packed
  lanes' grads, and ``unpack_grads`` scatters them back to named
  parameters (parameters used by several stages get their contributions
  summed).
* AMP: the stages honor the program's mixed-precision flag
  (``Program.amp``), with the executor's op-level cast discipline.  A
  value that is bf16 at run time but declared float32 rides the f32 lane
  (an exact bf16 -> f32 round trip), as in the JAX package.

Where the port differs in form (see ``parallel/pipeline.py``):

* One process a stage.  A rank runs only its own stage's ops (the JAX
  package's ``lax.switch`` on the stage index); every rank runs the same
  ticks and hops, so the point-to-point calls pair up.  A bubble tick
  runs no stage and sends a zero carrier: the rank knows on the host that
  the tick is idle, so its stage is never fed a garbage carrier, which
  is what the JAX package's two ``where``\\ s on a bubble tick (a carrier
  of ones in, zeros out) guarantee for a stage that every device must
  trace.
* The schedule is one :class:`torch.autograd.Function`.  Its forward
  keeps each tick's autograd graph (the stage's op lowerings run under
  ``torch.enable_grad``; the executor's run under ``torch.no_grad``);
  its backward runs the reverse schedule explicitly, the cotangents
  hopping p+1 -> p, each tick's vjp from the kept graph (no recompute).
* The port's integers are int64 where the JAX package's are int32, also
  for values computed inside a stage.  The i32 lane's range guard keys
  on the value's dtype, whatever the value is (a numpy array, a numpy
  scalar, a CPU or a CUDA tensor): an int64 value outside int32 range
  raises ``ValueError``, never wraps.  Inside the schedule a tensor's
  check is a device-side flag (``registry.record_fault``), read once
  after the schedule, so no tick waits on the host.
* The packed parameters and the ingest tensors are whole on every rank,
  and the result and the parameter grads come back whole on every rank.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.convert import to_tensor, torch_dtype
from paddle_tpu_torch.framework import Parameter
from paddle_tpu_torch.ops import registry
from paddle_tpu_torch.parallel.collective import (_all_gather_autograd,
                                                  _wait)
from paddle_tpu_torch.parallel.pipeline import (_all_reduce, _grads,
                                                axis_ring, axis_size, hop)

__all__ = ["pipeline_transpiler", "PipelinedProgram", "split_program"]

_SKIP = ("feed", "fetch")

_LANE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
                "i32": torch.int32}
_INT32 = np.iinfo(np.int32)


def _lane_of(dtype):
    """Which carrier lane a dtype rides: bf16 keeps its width, other
    floats ride f32, ints and bools ride i32 exactly."""
    dtype = torch_dtype(dtype)
    if dtype == torch.bfloat16:
        return "bf16"
    if dtype.is_floating_point:
        return "f32"
    return "i32"


def _op_cost(op, block):
    """Per-op stage-balancing weight: the static cost model
    (``analysis.cost.op_flops``).  Sub-block ops are atomic: weighed by
    their body so the quantile cuts see the FLOPs inside."""
    from paddle_tpu_torch.analysis import cost as _cost
    flops = _cost.op_flops(op, block, default=0)
    inner = sum(_op_cost(sub, blk)
                for blk in _sub_blocks(op) for sub in blk.ops)
    return 1 + flops + inner


def _all_input_names(op, recurse=False):
    names = [n for vs in op.inputs.values() for n in vs]
    if recurse:
        for blk in _sub_blocks(op):
            for sub in blk.ops:
                names += _all_input_names(sub, recurse=True)
    return names


def _all_output_names(op):
    return [n for vs in op.outputs.values() for n in vs]


def _sub_blocks(op):
    return [a for a in op.attrs.values()
            if a.__class__.__name__ == "Block"]


def split_program(program, n_stages, feed_names, fetch_names):
    """Balanced cut points + per-stage op/param/boundary metadata:
    ``(block, stage_ops, stage_params, boundaries)``."""
    block = program.global_block()
    ops = [op for op in block.ops if op.type not in _SKIP]

    costs = [_op_cost(op, block) for op in ops]
    total = float(sum(costs))
    # cut after reaching each quantile of cumulative cost
    cuts, acc, next_q = [], 0.0, 1
    for i, c in enumerate(costs):
        acc += c
        if next_q < n_stages and acc >= total * next_q / n_stages:
            cuts.append(i + 1)
            next_q += 1
    while len(cuts) < n_stages - 1:   # degenerate tails
        cuts.append(len(ops))
    stage_ops = []
    lo = 0
    for cut in cuts + [len(ops)]:
        stage_ops.append(ops[lo:cut])
        lo = cut

    def is_param(name):
        v = block.var(name) if name in block.vars else None
        return v is not None and (isinstance(v, Parameter)
                                  or getattr(v, "persistable", False))

    produced_by = {}
    for s, sops in enumerate(stage_ops):
        for op in sops:
            for n in _all_output_names(op):
                produced_by.setdefault(n, s)

    # sub-block ops are atomic; their inner reads of outer params/vars
    # count toward the owning stage (recurse=True)
    stage_params = []
    for sops in stage_ops:
        names = []
        for op in sops:
            for n in _all_input_names(op, recurse=True):
                if is_param(n) and n not in names:
                    names.append(n)
        stage_params.append(names)

    # boundary b carries everything still needed past it and produced
    # before it: inputs of stage >= b ops, plus fetch targets already
    # produced (they must ride through to the final boundary); feeds
    # count as produced before stage 0
    feed_set = set(feed_names)
    boundaries = []
    for b in range(n_stages + 1):
        need = set()
        for n in fetch_names:
            src = produced_by.get(n)
            # a fetched feed (src None) must ride EVERY boundary — no
            # stage re-produces it, wherever its consumers sit
            if b == n_stages or (src is not None and src < b) or \
                    (src is None and n in feed_set):
                need.add(n)
        for s in range(b, n_stages):
            for op in stage_ops[s]:
                for n in _all_input_names(op, recurse=True):
                    if is_param(n):
                        continue
                    src = produced_by.get(n)
                    if (src is None and n in feed_set) or \
                            (src is not None and src < b):
                        need.add(n)
        boundaries.append(sorted(need))

    # carriers are flat dense vectors; a TensorArray (or reader/channel)
    # cannot cross a cut.  The cut placement is cost-driven, so reject
    # loudly with the remedy instead of crashing in _Layout.pack.
    for b, names in enumerate(boundaries):
        for n in names:
            v = block.var(n) if n in block.vars else None
            vtype = getattr(v, "type", None)
            if vtype in ("tensor_array", "reader", "channel"):
                where = ("the feed carrier" if b == 0 else
                         "the fetch carrier" if b == len(boundaries) - 1
                         else f"the cut before stage {b}")
                raise ValueError(
                    f"pipeline_transpiler: {where} would carry {n!r} "
                    f"(a {vtype}), which cannot ride a flat carrier; "
                    f"keep its producers and consumers in one stage "
                    f"and fetch/feed dense tensors only — fewer "
                    f"stages, or hoist the control-flow region so the "
                    f"quantile cut lands outside it")
    return block, stage_ops, stage_params, boundaries


def _range_message(name):
    return (f"pipeline_transpiler: {name!r} holds int64 values outside "
            f"int32 range; the i32 carrier lane cannot carry them exactly")


class _Layout:
    """Typed flat-packing layout for a list of named tensors: one flat
    vector per dtype lane (f32 / bf16 / i32); ``pack`` -> {lane: vec},
    ``unpack`` restores the dtypes and shapes."""

    def __init__(self, names, shapes, dtypes):
        self.names = list(names)
        self.shapes = [tuple(int(d) for d in s) for s in shapes]
        self.dtypes = [torch_dtype(d) for d in dtypes]
        self.lanes = [_lane_of(d) for d in self.dtypes]
        self.sizes = [int(np.prod(s)) if s else 1 for s in self.shapes]
        self.offsets = []          # per-name offset within its lane
        self.lengths = {}          # lane -> total length
        for lane, size in zip(self.lanes, self.sizes):
            self.offsets.append(self.lengths.get(lane, 0))
            self.lengths[lane] = self.lengths.get(lane, 0) + size

    @staticmethod
    def _check_i32_range(name, v, faults=None):
        """Range-check an int64-typed value before it rides the i32
        lane: a value outside int32 range must fail loudly, not wrap.
        Keyed on the value's dtype (numpy arrays and scalars by
        ``np.dtype``, tensors by ``torch.int64``, on any device).  A
        tensor's check is one device-side flag: with ``faults`` (the
        schedule's fault records) it joins them and is read after the
        schedule; without, it is read at once."""
        if isinstance(v, torch.Tensor):
            if v.dtype != torch.int64 or not v.numel():
                return
            bad = ((v > _INT32.max) | (v < _INT32.min)).any()
            if faults is None:
                if bool(bad):
                    raise ValueError(_range_message(name))
                return
            registry.record_fault({"fault_flags": faults}, ValueError,
                                  _range_message(name), bad)
            return
        a = np.asarray(v)
        if a.dtype == np.int64 and a.size and \
                (a.max() > _INT32.max or a.min() < _INT32.min):
            raise ValueError(_range_message(name))

    def pack(self, values, lanes, device=None, faults=None):
        """values {name: tensor or array} -> {lane: flat vec} over
        ``lanes``; int64 values are range-guarded by
        :meth:`_check_i32_range` (the static half of the same contract
        is the analyzer's PTA010 lint, ``check_pipeline_carriers``).
        Arrays go to ``device`` (default: the CPU)."""
        device = torch.device("cpu") if device is None else device
        flats = {lane: [] for lane in lanes}
        for n, lane in zip(self.names, self.lanes):
            v = values[n]
            if not isinstance(v, torch.Tensor):
                v = np.asarray(v)
            if lane == "i32":
                self._check_i32_range(n, v, faults)
            if not isinstance(v, torch.Tensor):
                v = to_tensor(v, device)
            flats[lane].append(v.reshape(-1).to(_LANE_DTYPES[lane]))
        return {
            lane: (torch.cat(fs) if fs
                   else torch.zeros((0,), dtype=_LANE_DTYPES[lane],
                                    device=device))
            for lane, fs in flats.items()}

    def unpack(self, vecs):
        """{lane: vec} -> {name: tensor} with the original dtype/shape."""
        return {n: vecs[lane][off:off + size].reshape(shape).to(dtype)
                for n, shape, dtype, lane, off, size in zip(
                    self.names, self.shapes, self.dtypes, self.lanes,
                    self.offsets, self.sizes)}


def _pad_lanes(vecs, lengths):
    return {lane: (F.pad(v, (0, lengths[lane] - v.shape[0]))
                   if v.shape[0] < lengths[lane] else v)
            for lane, v in vecs.items()}


class PipelinedProgram:
    """A Program split into P pipeline stages; call :meth:`run_fn` (or
    differentiate through it) with per-microbatch feeds.  ``mesh`` (a
    ``DeviceMesh`` with the ``axis`` of P ranks; default: the default
    mesh, resolved at :meth:`build`) holds one rank a stage."""

    def __init__(self, program, n_stages, feed_names, fetch_names,
                 mesh=None, axis="pipe"):
        from paddle_tpu_torch.analysis import (AnalysisResult,
                                               check_pipeline_carriers,
                                               check_stage_set,
                                               verify_transpiled)
        from paddle_tpu_torch.executor import _amp_enabled
        self.mesh = mesh
        self.axis = axis
        self.n_stages = n_stages
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        self.amp = _amp_enabled(program)
        # post-transpile contract: the program must be structurally
        # well-formed BEFORE it is cut into stages, and no int64
        # constant provably outside int32 range may cross a stage
        # boundary on the i32 carrier lane (the static half of
        # _Layout.pack's runtime range guard)
        verify_transpiled(program, where="pipeline_transpiler")
        (self.block, self.stage_ops, self.stage_param_names,
         self.boundaries) = split_program(program, n_stages, feed_names,
                                          fetch_names)
        check_pipeline_carriers(self.block, self.boundaries)
        # cross-stage contract (analysis/distributed.py): every consumed
        # upstream value rides its boundary carrier, and the stages emit
        # matching collective sequences (PTA011/PTA015)
        AnalysisResult(check_stage_set(
            self.block, self.stage_ops, self.boundaries,
            feed_names=self.feed_names)) \
            .raise_on_errors(where="pipeline_transpiler")

        def check_rng(op):
            opdef = registry.lookup(op.type)
            if opdef is not None and opdef.uses_rng:
                raise ValueError(
                    f"pipeline_transpiler: op {op.type!r} uses the "
                    f"rng stream; run with dropout/sampling disabled "
                    f"in the pipelined region")
            for blk in _sub_blocks(op):
                for sub in blk.ops:
                    check_rng(sub)

        for sops in self.stage_ops:
            for op in sops:
                check_rng(op)

    # -- layouts (need var shapes; resolved against scope values) -------
    def _var_meta(self, name):
        v = self.block.var(name) if name in self.block.vars else None
        if v is None or v.shape is None:
            raise ValueError(f"pipeline_transpiler: no shape for {name!r}")
        return tuple(int(d) for d in v.shape), v.dtype

    def build(self, scope, microbatch_feeds):
        """Finalize layouts from the startup-initialized ``scope`` and a
        SAMPLE microbatch feed dict (fixes the microbatch shapes).  A
        feed rides at its declared dtype, the one the executor casts it
        to.  The packed parameters go to the mesh's device."""
        from paddle_tpu_torch.parallel.mesh import default_mesh
        if self.mesh is None:
            self.mesh = default_mesh()
        self.device = torch.device("cuda", torch.cuda.current_device()) \
            if self.mesh.device_type == "cuda" else torch.device("cpu")
        self._param_layouts = []
        param_values = []     # local: only needed to build packed_params
        for names in self.stage_param_names:
            vals = {}
            for n in names:
                v = scope.find_var(n)
                vals[n] = v if isinstance(v, torch.Tensor) else \
                    to_tensor(v, "cpu")
            lay = _Layout(names, [vals[n].shape for n in names],
                          [vals[n].dtype for n in names])
            self._param_layouts.append(lay)
            param_values.append(vals)

        self._carrier_layouts = []
        for names in self.boundaries:
            shapes, dtypes = [], []
            for n in names:
                if n in microbatch_feeds:
                    shapes.append(np.shape(microbatch_feeds[n]))
                    var = self.block.vars.get(n)
                    dtypes.append(var.dtype if var is not None and
                                  var.dtype is not None else
                                  microbatch_feeds[n].dtype)
                else:
                    s, d = self._var_meta(n)
                    shapes.append(s)
                    dtypes.append(d)
            self._carrier_layouts.append(_Layout(names, shapes, dtypes))

        # active lanes: one fixed set across boundaries and stages
        self.carrier_lanes = tuple(
            lane for lane in _LANE_DTYPES
            if any(lay.lengths.get(lane) for lay in self._carrier_layouts))
        if not self.carrier_lanes:
            self.carrier_lanes = ("f32",)
        self.param_lanes = tuple(
            lane for lane in _LANE_DTYPES
            if any(lay.lengths.get(lane) for lay in self._param_layouts))
        if not self.param_lanes:
            self.param_lanes = ("f32",)
        self.carrier_len = {
            lane: max(lay.lengths.get(lane, 0)
                      for lay in self._carrier_layouts)
            for lane in self.carrier_lanes}
        self.param_len = {
            lane: max(lay.lengths.get(lane, 0)
                      for lay in self._param_layouts)
            for lane in self.param_lanes}

        # packed parameter buffers {lane: [P, L_lane]}
        rows = {lane: [] for lane in self.param_lanes}
        for lay, vals in zip(self._param_layouts, param_values):
            vals = {n: v.to(self.device) for n, v in vals.items()}
            vecs = _pad_lanes(lay.pack(vals, self.param_lanes, self.device),
                              self.param_len)
            for lane in self.param_lanes:
                rows[lane].append(vecs[lane])
        self.packed_params = {lane: torch.stack(rows[lane])
                              for lane in self.param_lanes}
        return self

    def pack_microbatch(self, feed):
        """feed dict -> {lane: [L_lane]} carrier for boundary 0.  Values
        pass to ``pack`` as they are: an int64 array is range-checked
        before anything narrows it."""
        lay = self._carrier_layouts[0]
        vals = {}
        for n in lay.names:
            v = feed[n]
            if isinstance(v, torch.Tensor):
                vals[n] = v.to(self.device)
            else:
                vals[n] = np.asarray(v)
        vecs = lay.pack(vals, self.carrier_lanes, self.device)
        vecs = {lane: v.to(self.device) for lane, v in vecs.items()}
        return _pad_lanes(vecs, self.carrier_len)

    def stack_microbatches(self, feeds):
        """[feed dicts] -> {lane: [M, L_lane]} ingest tensors."""
        packed = [self.pack_microbatch(f) for f in feeds]
        return {lane: torch.stack([p[lane] for p in packed])
                for lane in self.carrier_lanes}

    def unpack_outputs(self, vecs):
        """One final-boundary carrier {lane: [L_lane]} -> fetch dict."""
        lay = self._carrier_layouts[-1]
        return lay.unpack({lane: vecs[lane][:lay.lengths.get(lane, 0)]
                           for lane in self.carrier_lanes})

    def select_fetch(self, outs, name):
        """{lane: [M, L]} stacked outputs -> [M, ...] values of one
        fetch target."""
        lay = self._carrier_layouts[-1]
        i = lay.names.index(name)
        lane, off, size = lay.lanes[i], lay.offsets[i], lay.sizes[i]
        sl = outs[lane][:, off:off + size]
        return sl.reshape((sl.shape[0],) + lay.shapes[i]).to(lay.dtypes[i])

    def unpack_grads(self, packed_grads):
        """{lane: [P, L]} grads -> {param_name: float64 numpy grad}
        (multi-stage placements summed; integer lanes have none)."""
        out = {}
        for s, lay in enumerate(self._param_layouts):
            for n, shape, lane, off, size in zip(
                    lay.names, lay.shapes, lay.lanes, lay.offsets,
                    lay.sizes):
                if lane == "i32":
                    continue
                g = packed_grads.get(lane)
                if g is None or not g.numel():
                    continue
                v = g[s, off:off + size].detach().double().cpu().numpy()
                out[n] = out.get(n, 0) + v.reshape(shape)
        return out

    # -- one stage ------------------------------------------------------
    def _run_stage(self, s, pvecs, carrier, faults):
        """carrier {lane: [L]} -> carrier {lane: [L]} of stage ``s``,
        given its packed parameter vectors: the stage's op lowerings
        (sub-block ops recurse through ``executor.lower_block``)."""
        from paddle_tpu_torch.executor import lower_block
        in_lay = self._carrier_layouts[s]
        out_lay = self._carrier_layouts[s + 1]
        p_lay = self._param_layouts[s]
        env = p_lay.unpack({lane: pvecs[lane][:p_lay.lengths.get(lane, 0)]
                            for lane in set(p_lay.lanes)})
        env.update(in_lay.unpack(
            {lane: carrier[lane][:in_lay.lengths.get(lane, 0)]
             for lane in set(in_lay.lanes)}))
        aux = {"device": self.device, "rng_counter": -1, "amp": self.amp,
               "lod": {}, "lower_block": lower_block, "constants": {},
               "fault_flags": faults}
        for op in self.stage_ops[s]:
            opdef = registry.resolve_lowering(op.type)
            aux["rng_counter"] += op.attrs.get("__rng_slots__", 1)
            ctx = registry.LowerContext(op, env, self.block, aux=aux,
                                        op_index=aux["rng_counter"])
            opdef.lower(ctx)
            env.update(ctx.outputs)
        out = out_lay.pack(env, self.carrier_lanes, self.device, faults)
        return _pad_lanes(out, self.carrier_len)

    # -- the pipelined schedule ----------------------------------------
    def run_fn(self, data_axis=None):
        """Returns ``fn(packed_params {lane: [P, Lp]}, xs {lane: [M, L]})
        -> {lane: [M, L]}`` (final-boundary carriers a microbatch), the
        same on every rank and differentiable with respect to the packed
        parameters' float lanes.

        ``data_axis``: optional mesh axis name for dp x pp composition —
        the microbatches are split over ``(data_axis, pipe axis)``, data
        major, and each data row runs an independent pipeline over its
        own block of them (the parameters whole on every row; their
        grads summed over the rows); outputs come back stacked in global
        microbatch order."""
        lanes = self.carrier_lanes
        p_lanes = self.param_lanes
        if axis_size(self.mesh, self.axis) != self.n_stages:
            raise ValueError(
                f"pipeline_transpiler: {self.n_stages} stages need a "
                f"{self.axis!r} mesh axis of {self.n_stages} ranks, one "
                f"stage per rank")

        def fn(packed_params, xs):
            outs = _PipelineFunction.apply(
                self, data_axis, len(p_lanes),
                *[packed_params[lane] for lane in p_lanes],
                *[xs[lane] for lane in lanes])
            return dict(zip(lanes, outs))

        return fn


def _float_lane(lane):
    return lane != "i32"


class _PipelineFunction(torch.autograd.Function):
    """The pipelined schedule of a :class:`PipelinedProgram`:
    ``(packed param lanes..., ingest lanes...) -> output lanes``."""

    @staticmethod
    def forward(ctx, prog, data_axis, n_params, *tensors):
        p_lanes, lanes = prog.param_lanes, prog.carrier_lanes
        packed = dict(zip(p_lanes, tensors[:n_params]))
        xs = dict(zip(lanes, tensors[n_params:]))
        group, stage, n_stages = axis_ring(prog.mesh, prog.axis)
        dgroup, row, n_rows = axis_ring(prog.mesh, data_axis) \
            if data_axis else (None, 0, 1)
        total = next(iter(xs.values())).shape[0]
        if total % (n_rows * n_stages):
            raise ValueError(
                f"pipeline_transpiler: {total} microbatches do not split "
                f"into {n_rows} x {n_stages} blocks")
        B = total // (n_rows * n_stages)
        M = B * n_stages
        n_ticks = M + n_stages - 1
        blk = row * n_stages + stage
        buf = {lane: xs[lane][blk * B:(blk + 1) * B] for lane in lanes}
        # this stage's parameters, leaves of the ticks' graphs
        pvecs = {lane: packed[lane][stage].detach().requires_grad_(
            _float_lane(lane)) for lane in p_lanes}
        length = prog.carrier_len
        device = prog.device
        zeros = {lane: torch.zeros((length[lane],), dtype=_LANE_DTYPES[lane],
                                   device=device) for lane in lanes}
        received = dict(zeros)
        outputs = {lane: torch.zeros((M, length[lane]),
                                     dtype=_LANE_DTYPES[lane], device=device)
                   for lane in lanes}
        faults = {}
        ticks = {}
        up = stage + 1 if stage < n_stages - 1 else None
        down = stage - 1 if stage > 0 else None
        for t in range(n_ticks):
            if group is not None and t and t % B == 0 and \
                    t // B < n_stages:
                # rotate the ingest blocks one hop toward stage 0: after
                # k rotations stage 0 holds block k, exactly when ticks
                # [kB, (k+1)B) consume it
                got = hop([buf[lane] for lane in lanes], group, down, up)
                if got is not None:
                    buf = dict(zip(lanes, got))
            mb = t - stage
            sent = zeros
            if 0 <= mb < M:
                src = {lane: buf[lane][t % B] for lane in lanes} \
                    if stage == 0 else received
                inp = {lane: v.detach().requires_grad_(_float_lane(lane))
                       for lane, v in src.items()}
                with torch.enable_grad():
                    out = prog._run_stage(stage, pvecs, inp, faults)
                ticks[t] = (inp, out)
                sent = {lane: v.detach() for lane, v in out.items()}
                if stage == n_stages - 1:
                    for lane in lanes:
                        outputs[lane][mb] = sent[lane]
            if group is not None and t < n_ticks - 1:
                got = hop([sent[lane] for lane in lanes], group, up, down)
                if got is not None:
                    received = dict(zip(lanes, got))
        registry.raise_fault(*registry.fault_word({"fault_flags": faults}))
        result = []
        for lane in lanes:
            o = _all_reduce(outputs[lane], group)
            if dgroup is not None:
                o = _wait(_all_gather_autograd(o.contiguous(), 0, dgroup))
            result.append(o)
        ctx.prog = prog
        ctx.meta = (group, dgroup, stage, n_stages, row, M, n_ticks,
                    n_params)
        ctx.ticks, ctx.pvecs = ticks, pvecs
        ctx.mark_non_differentiable(*[o for lane, o in zip(lanes, result)
                                      if not _float_lane(lane)])
        return tuple(result)

    @staticmethod
    def backward(ctx, *g_out):
        prog = ctx.prog
        group, dgroup, stage, n_stages, row, M, n_ticks, n_params = \
            ctx.meta
        lanes = prog.carrier_lanes
        f_lanes = [lane for lane in lanes if _float_lane(lane)]
        p_float = [lane for lane in prog.param_lanes if _float_lane(lane)]
        g_row = {lane: (g[row * M:(row + 1) * M] if g is not None else None)
                 for lane, g in zip(lanes, g_out)}
        length = prog.carrier_len
        zeros = {lane: torch.zeros((length[lane],), dtype=_LANE_DTYPES[lane],
                                   device=prog.device) for lane in f_lanes}
        acc = {lane: torch.zeros_like(ctx.pvecs[lane]) for lane in p_float}
        up = stage + 1 if stage < n_stages - 1 else None
        down = stage - 1 if stage > 0 else None
        recv = dict(zeros)
        for t in reversed(range(n_ticks)):
            sent = zeros
            if t in ctx.ticks:
                inp, out = ctx.ticks.pop(t)
                if stage == n_stages - 1:
                    cot = {lane: (g_row[lane][t - stage]
                                  if g_row[lane] is not None
                                  else zeros[lane]) for lane in f_lanes}
                else:
                    cot = recv
                got = _grads([out[lane] for lane in f_lanes],
                             [inp[lane] for lane in f_lanes] +
                             [ctx.pvecs[lane] for lane in p_float],
                             [cot[lane] for lane in f_lanes])
                sent = dict(zip(f_lanes, got[:len(f_lanes)]))
                for lane, g in zip(p_float, got[len(f_lanes):]):
                    acc[lane] = acc[lane] + g
            if group is not None and t > 0 and f_lanes:
                got = hop([sent[lane] for lane in f_lanes], group, down, up)
                if got is not None:
                    recv = dict(zip(f_lanes, got))
        grads = []
        for lane in prog.param_lanes:
            if lane not in acc:
                grads.append(None)
                continue
            full = acc[lane].new_zeros(
                (n_stages,) + tuple(acc[lane].shape))
            full[stage] = acc[lane]
            grads.append(_all_reduce(_all_reduce(full, group), dgroup))
        return (None, None, None, *grads, *([None] * len(lanes)))


def pipeline_transpiler(program, n_stages, feed_names, fetch_names,
                        mesh=None, axis="pipe"):
    """Split ``program`` into ``n_stages`` balanced pipeline stages.

    Returns a :class:`PipelinedProgram`; call ``.build(scope,
    sample_microbatch)`` after running the startup program, then
    ``.run_fn()`` for the differentiable pipelined step."""
    return PipelinedProgram(program, n_stages, feed_names, fetch_names,
                            mesh, axis)
