"""Operator registry: shape inference, forward lowerings over torch
tensors and grad-op makers (the port of ``paddle_tpu.ops.registry``;
reference ``paddle/fluid/framework/op_registry.h:62``,
``grad_op_desc_maker.h:33``).

Each op registers ONE ``lower`` function, a function from input tensors
to output tensors; the port's Executor calls them op by op.  Shape
inference is the JAX package's, unchanged, so a program built with the
port serializes to the same IR dict.

Gradients are IR-level, as in the JAX package: ``backward.py`` appends
``<type>_grad`` ops.  The default grad lowering is ``torch.func.vjp`` of
the forward lowering, re-run eagerly on the backward-time values (the
JAX package leaves that recompute to XLA's CSE; here it is paid).  Ops
with randomness, integer semantics, saved residuals or a hand-written
backward kernel register an explicit grad lowering instead.

Control flow: an op with a ``sub_block`` attr runs its body through
``aux["lower_block"]``.  A ``while`` overwrites its loop carries in the
env, so it leaves its pre-loop values in ``aux["env_snapshots"]`` (keyed
by ``id(sub_block)``, as the JAX package keys them) and its grad re-runs
the loop from there.  A tensor array (``control_flow_ops.TensorArray``)
crosses ``torch.func.vjp`` as its buffer: the auto-vjp hands the buffer
in as the primal and takes it out of an output, and a cotangent array is
matched to its output's buffer (a missing one is zero).

Device faults: an error the JAX package cannot raise under ``jit`` (an
array index outside the capacity, a bounded loop still true after its
bound) is not read on the host where it happens: the op records a flag
(:func:`record_fault`), or an array access its index and gate
(:func:`record_range_fault`, compared only at the fold, so a loop trip
pays no op for it), :func:`fault_word` folds the step's records into
one int64 word, and the executor reads the word once after the step and
raises (:func:`raise_fault`).  Only an unbounded ``while`` reads its
condition on the host, with :func:`host_scalar` (a device sync each on
the card, counted in ``aux["host_reads"]``).

CUDA graphs: the executor captures a block's step as one graph unless an
op of it (or of a sub-block) is marked ``host`` (the JAX package's flag)
or ``eager_only`` (the port's: its lowering reads the device on the
host, copies host data to the device or draws from the run's host
generator).  A grad op takes its forward's marks.  In the bucketed LoD
mode (``lod.DynLoD``) an op marked ``eager_dyn_ok`` (the JAX package's
``host_dyn_ok``, widened to the port's ``eager_only``) builds its tables
from the splits tensor on the device and keeps no block eager.  Random
ops draw from
:meth:`LowerContext.generator`, which the executor can hand one
generator per draw that a graph keeps and reseeds before each replay.
"""

from __future__ import annotations

import collections

import torch

from paddle_tpu_torch.selected_rows import SelectedRows

__all__ = [
    "OpDef", "register_op", "register_grad_lower",
    "lookup", "all_ops",
    "resolve_lowering", "LowerContext", "run_lowering",
    "ShapeInferenceSkip", "infer_shape_unary", "infer_shape_elementwise",
    "default_grad_maker", "auto_vjp_grad_lower", "GRAD_SUFFIX",
    "host_scalar", "slot_seed", "eager_only", "record_fault",
    "record_range_fault", "fault_word", "raise_fault",
]

GRAD_SUFFIX = "@GRAD"

_REGISTRY = {}

_INT_DTYPES = ("int32", "int64", "bool", "int8", "uint8", "int16")


class ShapeInferenceSkip(Exception):
    """Raised by infer_shape when shapes cannot be determined at build time."""


class OpDef:
    def __init__(self, type, lower=None, infer_shape=None, grad_maker=None,
                 grad_lower=None, no_grad_inputs=(), stop_gradient_outputs=(),
                 uses_rng=False, stateful_outputs=(), amp_cast=(),
                 amp_upcast=(), host=False, selected_rows_inputs=(),
                 eager_only=False, eager_dyn_ok=False):
        self.type = type
        self.lower = lower
        self.infer_shape = infer_shape
        # input slots whose lowering takes a SelectedRows value (the
        # sparse-grad path, ``selected_rows.py``); every other slot reads
        # one densified, as the reference's data-transform layer converts
        # inputs a kernel cannot take (``data_transform.cc``)
        self.selected_rows_inputs = frozenset(selected_rows_inputs)
        # mixed precision: when the program runs with amp enabled, float32
        # tensors read through the listed input slots are cast to bfloat16
        # (amp_cast — matrix products) or forced to float32 (amp_upcast —
        # numerically sensitive ops).  Parameters stay float32 in the scope
        # (master weights) and the vjp of the cast returns float32 grads.
        self.amp_cast = frozenset(amp_cast)
        self.amp_upcast = frozenset(amp_upcast)
        # grad_maker: fn(op, block, no_grad_set) -> (list of op-desc dicts,
        #   dict fwd_input_name -> grad_name).  None => default maker.
        self.grad_maker = grad_maker
        # explicit lowering of the <type>_grad op; None => auto-vjp
        self.grad_lower = grad_lower
        self.no_grad_inputs = frozenset(no_grad_inputs)  # slot names
        self.stop_gradient_outputs = frozenset(stop_gradient_outputs)
        self.uses_rng = uses_rng
        # reads its inputs' values on the host (the sequence ops whose
        # output rows depend on the data): ``analysis.opmeta`` reads it
        self.host = host
        # the port's reasons to keep a block out of a CUDA graph
        # (:func:`eager_only`): True, or a predicate of the op
        self.eager_only = eager_only
        # its bucketed-LoD branch is device-only: under the switch neither
        # ``host`` nor ``eager_only`` keeps its block eager (the JAX
        # package's ``host_dyn_ok``, ``paddle_tpu/ops/registry.py:81``)
        self.eager_dyn_ok = eager_dyn_ok
        # outputs that alias an input across steps (ParamOut of the
        # optimizer ops): the structural verifier accepts them as in-place
        # state updates
        self.stateful_outputs = frozenset(stateful_outputs)
        self.has_grad = True  # flipped by register_op(no_gradient=True)


def register_op(type, *, infer_shape=None, grad_maker=None, grad_lower=None,
                no_grad_inputs=(), stop_gradient_outputs=(), uses_rng=False,
                no_gradient=False, stateful_outputs=(), amp_cast=(),
                amp_upcast=(), selected_rows_inputs=(), host=False,
                eager_only=False, eager_dyn_ok=False):
    """Decorator: register ``fn(ctx)`` as the lowering for op ``type``.
    ``eager_only``: True, or ``fn(op) -> bool``, where the lowering does
    host work a CUDA graph would refuse or freeze (:func:`eager_only`);
    ``eager_dyn_ok``: its bucketed-LoD branch does none."""

    def deco(fn):
        opdef = OpDef(type, lower=fn, infer_shape=infer_shape,
                      grad_maker=grad_maker, grad_lower=grad_lower,
                      no_grad_inputs=no_grad_inputs,
                      stop_gradient_outputs=stop_gradient_outputs,
                      uses_rng=uses_rng, stateful_outputs=stateful_outputs,
                      amp_cast=amp_cast, amp_upcast=amp_upcast,
                      host=host, selected_rows_inputs=selected_rows_inputs,
                      eager_only=eager_only, eager_dyn_ok=eager_dyn_ok)
        opdef.has_grad = not no_gradient
        _REGISTRY[type] = opdef
        return fn

    return deco


def register_grad_lower(fwd_type):
    """Decorator: register an explicit lowering for ``<fwd_type>_grad``."""

    def deco(fn):
        _REGISTRY[fwd_type].grad_lower = fn
        return fn

    return deco


def lookup(type):
    return _REGISTRY.get(type)


def eager_only(op, dyn=False):
    """True when ``op``'s lowering does host work that a CUDA graph
    would refuse or freeze, by the port's marks (``OpDef.eager_only``;
    a ``<type>_grad`` op takes its forward's); with ``dyn`` (the
    bucketed LoD mode) an ``eager_dyn_ok`` op does none.  The JAX
    package's ``host`` flag is read separately
    (``executor._has_host_ops``)."""
    types = [op.type]
    if op.type.endswith("_grad"):
        types.append(op.type[:-len("_grad")])
    for t in types:
        opdef = _REGISTRY.get(t)
        if opdef is not None and dyn and opdef.eager_dyn_ok:
            continue
        flag = opdef.eager_only if opdef is not None else False
        if callable(flag):
            flag = flag(op)
        if flag:
            return True
    return False


def all_ops():
    return dict(_REGISTRY)


# ---------------------------------------------------------------------------
# common shape-inference helpers (copied from the JAX package so the IR
# dicts of the two packages agree)
# ---------------------------------------------------------------------------

def infer_shape_unary(in_slot="X", out_slot="Out"):
    """Out has the same shape/dtype as the (first) input."""

    def fn(op, block):
        xs = op.input(in_slot)
        outs = op.output(out_slot)
        if not xs or not outs:
            raise ShapeInferenceSkip()
        x = block.var(xs[0])
        for o in outs:
            ov = block.var(o)
            ov.shape = x.shape
            ov.dtype = x.dtype
            ov.lod_level = x.lod_level

    return fn


def infer_shape_elementwise(op, block):
    x = block.var(op.input("X")[0])
    out = block.var(op.output("Out")[0])
    out.shape = x.shape  # paddle semantics: Out matches X (Y broadcasts)
    out.dtype = x.dtype
    out.lod_level = x.lod_level


# ---------------------------------------------------------------------------
# host reads of the run (loop conditions, array indices)
# ---------------------------------------------------------------------------

def host_scalar(aux, tensor):
    """The value of a one-element tensor on the host: a device sync on
    the card, counted in ``aux["host_reads"]``."""
    if tensor.numel() != 1:
        raise ValueError(f"expected a one-element tensor, got shape "
                         f"{tuple(tensor.shape)}")
    aux["host_reads"] = aux.get("host_reads", 0) + 1
    return tensor.reshape(()).item()


def record_fault(aux, exc_type, message, bad):
    """Record that the fault ``(exc_type, message)`` happened where the
    bool tensor ``bad`` holds (and the enclosing loop's or branch's
    ``aux["loop_keep"]`` too): the flag joins the site's list in
    ``aux["fault_flags"]``, which :func:`fault_word` folds into the
    step's word once, after the step.  Nothing is written in place, so a
    site may lie under ``torch.func.vjp``."""
    keep = aux.get("loop_keep")
    if keep is not None:
        bad = bad & keep
    aux.setdefault("fault_flags", {}).setdefault(
        (exc_type, message), []).append(bad.reshape(()))


def record_range_fault(aux, exc_type, message, index, size):
    """Record that the fault ``(exc_type, message)`` happened if the
    integer tensor ``index`` lies outside ``[0, size)`` where the
    enclosing ``aux["loop_keep"]`` holds.  Only the index and the keep
    are kept: :func:`fault_word` compares all of a site's indices at
    once, after the step."""
    aux.setdefault("fault_flags", {}).setdefault(
        (exc_type, message), []).append((index, aux.get("loop_keep"), size))


def _site_hits(records):
    """Whether any of a site's records holds: its flags stacked, its
    range records compared in one op a (size, gated) group."""
    flags = [r for r in records if isinstance(r, torch.Tensor)]
    hits = [torch.stack(flags).any()] if flags else []
    groups = collections.defaultdict(list)
    for r in records:
        if not isinstance(r, torch.Tensor):
            index, keep, size = r
            groups[size, keep is not None].append((index, keep))
    for (size, gated), group in groups.items():
        index = torch.cat([i.reshape(-1) for i, _ in group])
        bad = (index < 0) | (index >= size)
        if gated:
            bad = bad & torch.stack([k.reshape(()) for _, k in group])
        hits.append(bad.any())
    return hits[0] if len(hits) == 1 else torch.stack(hits).any()


def fault_word(aux):
    """``(word, sites)``: the run's device fault word (int64, bit k set
    where a record of the k-th fault site held; bits past 62 share the
    last) and ``{(exc_type, message): bit}``; ``(None, {})`` when the run
    recorded no fault site."""
    word, sites = None, {}
    for k, (site, records) in enumerate(aux.get("fault_flags", {}).items()):
        bit = sites[site] = 1 << min(k, 62)
        hit = _site_hits(records).to(torch.int64) * bit
        word = hit if word is None else word | hit
    return word, sites


def raise_fault(word, sites):
    """Read the fault word (one device read) and raise the error of the
    first site, in the order the step recorded them, whose bit is set;
    nothing when the word is zero or absent."""
    if word is None:
        return
    value = int(word.item())
    if not value:
        return
    for (exc_type, message), bit in sites.items():
        if value & bit:
            raise exc_type(message)
    raise RuntimeError(f"device fault word {value:#x} names no fault site")


def slot_seed(rng_seed, op_index):
    """The seed of the device generator of RNG slot ``op_index`` in a run
    seeded ``rng_seed`` (:meth:`LowerContext.generator`)."""
    return (int(rng_seed) * 1000003 + int(op_index)) % (2 ** 63 - 1)


# ---------------------------------------------------------------------------
# Lowering context
# ---------------------------------------------------------------------------

class LowerContext:
    """Hands an op lowering its input tensors / attrs; collects outputs.

    ``env`` maps variable name -> torch tensor.  ``aux`` carries
    executor-level services: ``device`` (the run's ``torch.device``),
    ``generator`` (the run's host ``torch.Generator`` for random init
    ops), ``amp`` (mixed precision on), ``rng_seed`` (the run's seed
    for the per-op device generators of :meth:`generator`) and ``lod``
    (variable name -> LoD, the ragged row splits as host lists: the feeds'
    and what the ops so far set or shared).
    ``op_index`` is the op's slot on the run's RNG counter
    (``aux["rng_counter"]``, advanced by ``executor.lower_block``), which
    keys :meth:`generator`.
    """

    def __init__(self, op, env, block, aux=None, op_index=0):
        self.op = op
        self.env = env
        self.block = block
        self.aux = aux or {}
        self.op_index = op_index
        self.outputs = {}

    @property
    def device(self):
        return self.aux["device"]

    # -- inputs ------------------------------------------------------------
    def _amp_cast(self, slot, value):
        """bf16-downcast / f32-upcast per the op's AMP slot lists (active
        only when the executor enabled mixed precision for this run);
        first densifies a SelectedRows read through a slot whose lowering
        does not declare it."""
        opdef = lookup(self.op.type)
        if isinstance(value, SelectedRows) and (
                opdef is None or slot not in opdef.selected_rows_inputs):
            value = value.to_dense()
        if value is None or not self.aux.get("amp") or opdef is None:
            return value
        if slot in opdef.amp_cast and value.dtype == torch.float32:
            return value.to(torch.bfloat16)
        if slot in opdef.amp_upcast and value.dtype == torch.bfloat16:
            return value.to(torch.float32)
        return value

    def input(self, slot):
        names = self.op.input(slot)
        if not names:
            return None
        return self._amp_cast(slot, self.env[names[0]])

    def inputs(self, slot):
        return [self._amp_cast(slot, self.env[n])
                for n in self.op.input(slot)]

    # -- attrs -------------------------------------------------------------
    def attr(self, name, default=None):
        return self.op.attr(name, default)

    # -- outputs -----------------------------------------------------------
    def set_output(self, slot, value):
        names = self.op.output(slot)
        if not names:
            return
        self.outputs[names[0]] = value

    def set_outputs(self, slot, values):
        for n, v in zip(self.op.output(slot), values):
            self.outputs[n] = v

    # -- LoD (ragged row splits, host metadata of the run) ------------------
    def input_lod(self, slot):
        names = self.op.input(slot)
        if not names:
            return None
        return self.aux.get("lod", {}).get(names[0])

    def var_lod(self, name):
        return self.aux.get("lod", {}).get(name)

    def set_output_lod(self, slot, lod):
        """Set an output's LoD (``aux["lod"]``); the names are kept in
        ``aux["lods_set"]``, so that the executor keeps a persistable's
        LoD in the scope for the next run."""
        names = self.op.output(slot)
        if names:
            self.aux.setdefault("lod", {})[names[0]] = lod
            self.aux.setdefault("lods_set", set()).add(names[0])

    # -- host reads --------------------------------------------------------
    def host_scalar(self, slot):
        """The (first) ``slot`` input's value on the host
        (:func:`host_scalar`)."""
        return host_scalar(self.aux, self.input(slot))

    # -- rng ---------------------------------------------------------------
    def generator(self, seed=None):
        """A ``torch.Generator`` on the run's device at offset 0, seeded
        from the run's seed and this op's RNG slot (:func:`slot_seed`),
        or with ``seed`` (an op's ``fix_seed``): each random op of a step
        draws its own reproducible stream, on the device that uses it.
        The run's ``aux["generators"]`` (the executor's) hands it out:
        under a CUDA graph capture, a generator the graph keeps and
        reseeds with the same value before each replay."""
        if seed is None:
            base = self.aux.get("rng_seed")
            if base is None:
                raise RuntimeError(
                    f"op {self.op.type} needs random numbers but the run "
                    f"provided no seed")
            key = ("slot", int(self.op_index))
        else:
            key = ("fixed", int(seed))
        table = self.aux.get("generators")
        if table is not None:
            return table.generator(self.device, key)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(key[1] if key[0] == "fixed"
                        else slot_seed(base, key[1]))
        return gen


def run_lowering(op, env, block, aux=None):
    """Execute one op's lowering against ``env``; merge outputs into env."""
    opdef = resolve_lowering(op.type)
    ctx = LowerContext(op, env, block, aux=aux)
    opdef.lower(ctx)
    env.update(ctx.outputs)
    return ctx.outputs


# ---------------------------------------------------------------------------
# default grad maker (reference: DefaultGradOpDescMaker, grad_op_desc_maker.h)
# ---------------------------------------------------------------------------

def default_grad_maker(op, block, no_grad_set):
    """Build the ``<type>_grad`` op desc for a forward op.

    Inputs:  every forward input slot (same names), every forward output
             slot, and ``<out_slot>@GRAD`` for each forward output.
    Outputs: ``<in_slot>@GRAD`` for each differentiable forward input.
    Returns (grad_op_descs, input_grad_map) where input_grad_map maps
    forward input var name -> its grad var name.
    """
    from paddle_tpu_torch.framework import grad_var_name

    opdef = lookup(op.type)
    inputs = {}
    outputs = {}
    input_grad_map = {}
    for slot, names in op.inputs.items():
        inputs[slot] = list(names)
    for slot, names in op.outputs.items():
        inputs[slot] = list(names)
        inputs[slot + GRAD_SUFFIX] = [grad_var_name(n) for n in names]
    for slot, names in op.inputs.items():
        if opdef is not None and slot in opdef.no_grad_inputs:
            continue
        grads = []
        has_any = False
        for n in names:
            try:
                v = block.var(n)
            except KeyError:
                v = None
            if n in no_grad_set or (v is not None and (
                    v.stop_gradient or v.dtype in _INT_DTYPES)):
                grads.append("")  # empty = no grad needed for this arg
            else:
                g = grad_var_name(n)
                grads.append(g)
                input_grad_map[n] = g
                has_any = True
        if has_any:
            outputs[slot + GRAD_SUFFIX] = grads
    if not outputs:
        return [], {}
    desc = {"type": op.type + "_grad", "inputs": inputs, "outputs": outputs,
            "attrs": dict(op.attrs)}
    return [desc], input_grad_map


# ---------------------------------------------------------------------------
# auto-vjp lowering for <type>_grad ops
# ---------------------------------------------------------------------------

def remember_rng_start(aux, sub_block):
    """Keep the RNG counter at which the step's first run of
    ``sub_block`` starts (``aux["rng_starts"]``), for the auto-vjp re-run
    of its carrier op (a ``while`` or ``recurrent``) to start there."""
    aux.setdefault("rng_starts", {}).setdefault(
        id(sub_block), aux.get("rng_counter", -1))


def auto_vjp_grad_lower(fwd_type):
    """Generic lowering for a grad op: ``torch.func.vjp`` of the forward
    lowering.

    The forward lowering is re-run as a function of the differentiable
    inputs with the REAL variable names, over the backward-time env, so
    lowerings that consult the env by name keep working.  The
    executor runs under ``torch.no_grad()``; ``torch.func.vjp`` ignores
    that outer mode, so the recompute is differentiated all the same.
    Missing output grads get zero cotangents.  An op that carries a
    ``sub_block`` re-runs from the values its forward left in
    ``aux["env_snapshots"]`` (a ``while``'s pre-loop carries), over the
    backward-time env for every other name, and from the RNG counter its
    forward started at (``aux["rng_starts"]``, :func:`remember_rng_start`),
    so that every random op of the body draws the mask of the forward it
    differentiates; the outer counter is put back afterwards.
    """
    fwd_def = _REGISTRY[fwd_type]

    def lower(ctx):
        op = ctx.op
        # which forward input args need grads: (slot, idx, grad var name)
        wanted = []
        for slot, grad_names in op.outputs.items():
            if not slot.endswith(GRAD_SUFFIX):
                continue
            in_slot = slot[:-len(GRAD_SUFFIX)]
            for i, g in enumerate(grad_names):
                if g:
                    wanted.append((in_slot, i, g))
        if not wanted:
            return

        # grad-op inputs partition into forward outputs (slots S where
        # both S and S@GRAD are inputs), their grads, and forward inputs
        fwd_out_slots = _fwd_output_slots(op)
        fwd_in_slots = [s for s in op.inputs
                        if not s.endswith(GRAD_SUFFIX)
                        and s not in fwd_out_slots]
        wanted_set = {(s, i) for s, i, _ in wanted}

        base_env = ctx.env
        sub = op.attrs.get("sub_block")
        snap = None if sub is None else \
            ctx.aux.get("env_snapshots", {}).get(id(sub))
        if snap is not None:
            base_env = collections.ChainMap(snap, ctx.env)
        rng_start = None if sub is None else \
            ctx.aux.get("rng_starts", {}).get(id(sub))

        diff_args = []      # (slot, idx, name) of differentiable args
        primal_vals = []
        arrays = {}         # name -> the array whose buffer is the primal
        for slot in fwd_in_slots:
            for i, n in enumerate(op.input(slot)):
                if (slot, i) in wanted_set:
                    v = base_env[n]
                    if _is_array(v):
                        if _is_integer(v):
                            continue
                        arrays[n], v = v, v.data
                    diff_args.append((slot, i, n))
                    primal_vals.append(v)

        from paddle_tpu_torch.framework import Operator
        fop = Operator(ctx.block, fwd_type, {}, {}, dict(op.attrs))
        fop.inputs = {s: list(op.inputs[s]) for s in fwd_in_slots}
        fop.outputs = {s: list(op.inputs.get(s, [])) for s in fwd_out_slots}
        # only outputs the forward actually produced take part in the vjp,
        # and of those only the differentiable ones (an integer output,
        # such as sequence_pool's MaxIndex, has no cotangent)
        out_names = [n for slot in fwd_out_slots
                     for n in fop.outputs[slot]
                     if n in ctx.env and not _is_integer(ctx.env[n])]

        def fwd_fn(*primals):
            # the primals over the backward-time env, without copying it
            env = collections.ChainMap(
                {n: arrays[n].with_data(v) if n in arrays else v
                 for (_, _, n), v in zip(diff_args, primals)}, base_env)
            fctx = LowerContext(fop, env, ctx.block, aux=ctx.aux,
                                op_index=ctx.op_index)
            outer = ctx.aux.get("rng_counter", -1)
            if rng_start is not None:
                ctx.aux["rng_counter"] = rng_start
            try:
                fwd_def.lower(fctx)
            finally:
                ctx.aux["rng_counter"] = outer
            return tuple(_primal_of(fctx.outputs.get(n, env.get(n)))
                         for n in out_names)

        outs, vjp_fn = torch.func.vjp(fwd_fn, *primal_vals)

        # cotangents: the Out@GRAD inputs, in out_names order
        grad_of_out = {}
        for slot in fwd_out_slots:
            onames = op.inputs.get(slot, [])
            gnames = op.inputs.get(slot + GRAD_SUFFIX, [])
            for i, n in enumerate(onames):
                if i < len(gnames) and gnames[i]:
                    grad_of_out[n] = gnames[i]
        cots = []
        for n, o in zip(out_names, outs):
            g = grad_of_out.get(n)
            if g and g in ctx.env:
                cots.append(_match_cotangent_dtype(ctx.env[g], o))
            else:
                cots.append(torch.zeros_like(o))
        grads = vjp_fn(tuple(cots))

        for (slot, i, n), g in zip(diff_args, grads):
            if n in arrays:
                g = arrays[n].with_data(g)
            for ws, wi, gname in wanted:
                if ws == slot and wi == i:
                    ctx.outputs[gname] = g

    return lower


def _is_integer(value):
    """No cotangent: an integer or bool tensor, or a tensor array whose
    buffer is not floating (or not made yet)."""
    if _is_array(value):
        value = value.data
        return value is None or not value.is_floating_point()
    return isinstance(value, torch.Tensor) and not (
        value.is_floating_point() or value.is_complex())


def _is_array(value):
    return hasattr(value, "with_data") and hasattr(value, "capacity")


def _primal_of(value):
    """What ``torch.func.vjp`` sees of an output: a tensor array's
    buffer (its length, an integer, takes no part)."""
    return value.data if _is_array(value) else value


def _match_cotangent_dtype(cot, out_val):
    """Cast a floating cotangent to the forward output's dtype — under
    mixed precision an op's output may be bf16 while the incoming grad
    is f32 (or the reverse).  A tensor array's cotangent is its buffer
    (zeros when it has none), cut or padded with zero steps to the
    output buffer's capacity."""
    if _is_array(cot):
        cot = cot.data
        if cot is None:
            return torch.zeros_like(out_val)
        n, cap = cot.shape[0], out_val.shape[0]
        if n > cap:
            cot = cot[:cap]
        elif n < cap:
            cot = torch.cat([cot, cot.new_zeros((cap - n,) +
                                                tuple(cot.shape[1:]))])
    if cot.dtype != out_val.dtype and cot.is_floating_point() and \
            out_val.is_floating_point():
        return cot.to(out_val.dtype)
    return cot


def _fwd_output_slots(grad_op):
    """Forward output slots present on a default-maker grad op: slots S such
    that both S and S@GRAD appear among the grad op's inputs."""
    slots = []
    for slot in grad_op.inputs:
        if slot.endswith(GRAD_SUFFIX):
            base = slot[:-len(GRAD_SUFFIX)]
            if base in grad_op.inputs and base not in slots:
                slots.append(base)
    return slots


def resolve_lowering(op_type):
    """The :class:`OpDef` that lowers ``op_type``, synthesizing auto-vjp
    lowerings for ``*_grad`` ops whose forward registered no explicit one;
    raises when the port has no lowering for it."""
    opdef = lookup(op_type)
    if opdef is not None and opdef.lower is not None:
        return opdef
    if op_type.endswith("_grad"):
        fwd = op_type[:-len("_grad")]
        fwd_def = lookup(fwd)
        if fwd_def is not None and (fwd_def.lower is not None or
                                    fwd_def.grad_lower is not None):
            if fwd_def.grad_lower is not None:
                lower = fwd_def.grad_lower
            else:
                if fwd_def.uses_rng:
                    raise NotImplementedError(
                        f"op {fwd!r} uses RNG; register an explicit grad "
                        f"lowering instead of auto-vjp")
                lower = auto_vjp_grad_lower(fwd)
            opdef = OpDef(op_type, lower=lower)
            _REGISTRY[op_type] = opdef
            return opdef
    raise NotImplementedError(
        f"no lowering registered for op {op_type!r} in paddle_tpu_torch")
