"""Executor: runs a Program block on torch tensors, on the card as one
CUDA graph per signature (the port's counterpart of
``paddle_tpu.executor``; reference
``paddle/fluid/framework/executor.cc:334``).

Where the JAX package traces a whole block into one compiled XLA
computation, the port prepares the block's step once per signature and
runs it as a CUDA graph:

  1. ``_signature`` (the reference's, ``paddle_tpu/executor.py:1087``):
     program id and version, block, AMP, scope id, op profiling, the
     early-release flag (``memory_optimization_transpiler.
     release_memory``), the feeds' names, dtypes and shapes, their
     frozen LoDs and the fetch names (and ``check_nan_inf``, which moves
     the write-back out of the graph); a guarded step (``sentinel=``),
     numerics probing and the op ranges of a device profile add a
     component, so an unguarded step's key stays as it is.
  2. ``_get_compiled`` looks the signature up in an LRU cache of
     ``jit_cache_capacity()`` entries (``PADDLE_TPU_JIT_CACHE_SIZE``,
     default 64), counting ``jit_cache.hits`` / ``.misses`` /
     ``.evictions`` as the JAX package does; a miss runs ``_prepare``:
     the reads / writes walk (into sub-blocks, ``_external_reads``) that
     partitions the state into read-only, in-out and write-only names,
     the capture rule, and the step function.
  3. On the card a block that may be captured runs as
     :class:`~paddle_tpu_torch.step_graph.StepGraph`: its first run
     eagerly, its second captured and replayed, every later one a
     replay (state written back into the scope's own tensors as the
     graph's last nodes).  On the CPU, and for a block the rule keeps
     eager, ``fn`` is the eager step: every op's lowering runs in program
     order and the written persistables are stored back in the scope.

The capture rule (``_prepare``): a block runs eagerly, with the
reference's host-op cliff warning once per (program, block), when it or
a sub-block holds an op the reference marks ``host`` or the port marks
``eager_only`` (``registry.eager_only``: its lowering reads the device
on the host, copies host data to the device or draws from the run's host
generator: an unbounded ``while``, a static LoD's tables, random init);
and without the warning when op profiling is on
(``profiler.enable_op_profiling``) or the optimization pipeline set
``program._opt_interpret``.  Ops that update state in place
(``paged_attention`` on the KV pool, the sparse branches of ``sgd``,
``adam`` and ``adagrad``) change the scope's own tensor.

Mixed precision: when ``Program.amp`` is set (or, if it is None, the
``PADDLE_TPU_AMP`` environment flag), float32 tensors read through an
op's ``amp_cast`` slots are cast to bfloat16 and those read through its
``amp_upcast`` slots to float32; parameters stay float32 in the scope.

Ragged feeds: ``run`` takes a ``(value, lod)`` pair for a LoD variable
and keeps the LoD in the scope (``Scope.set_lod``); a dense feed clears
a stale one.  Each run seeds ``aux["lod"]`` with the feeds' LoDs, and
after every op an output whose leading dim equals the first LoD-carrying
input's row count inherits that LoD unless the op set one
(:func:`_share_lod`).

The bucketed LoD mode (``program.lod_buckets`` or
``PADDLE_TPU_LOD_BUCKETS``, the JAX package's, ``paddle_tpu/lod.py``):
``run`` pads a single-level ragged feed's rows to a bucket and feeds its
row splits as ``<name>@lod0`` (int32 ``[B + 1]``), keeping the meta
``("dyn", B, T_bucket)`` in the scope; the signature holds the meta, so
one bucket is one cache entry and one graph, and the run's LoD map a
:class:`~paddle_tpu_torch.lod.DynLoD`, whose tables the lowerings build
on the device.  ``run_steps`` takes a list of ``steps`` ``(value, lod)``
batches for such a feed and pads the window to one bucket, the splits
stacked ``[steps, B + 1]`` and sliced per step like a stacked dense
feed.  Under the switch the capture rule lets an op marked
``eager_dyn_ok`` into a graph (``_host_ops(block, dyn=True)``) unless a
feed keeps a static LoD (a multi-level one).

Reader ops (``ops/reader_ops.py``): before each step, and before a
``run_steps`` window, the host-side pre-pass :func:`_run_reader_ops`
builds the readers of the block's creation ops into the scope (once)
and pops a batch a ``read`` op (``steps`` batches, stacked) into the
feeds, which then take the path of any feed: the signature holds their
shapes, so a reader-fed window of like batches is one cache entry and
one graph.  The step skips the reader ops.

Control flow: ``aux["lower_block"]`` is :func:`lower_block`, which the
lowerings of ``while``, ``conditional_block`` and ``recurrent`` run
their sub-blocks through, over the run's own ``aux`` (its LoD map and
index tables).  After each run ``Executor.last_run`` holds the run's
``while`` trips and host reads (``aux["while_trips"]``,
``aux["host_reads"]``: the conditions of unbounded loops, each a device
sync on the card); a graph replay reports its capture's trips and no
host read.

Device faults: an array index outside the capacity or a bounded loop
still true after its bound sets a bit of the step's fault word
(``registry.record_fault``); ``run`` reads the word once after the step
(``run_steps`` once after the window, ORed over its steps) and raises
the op's ``IndexError`` / ``RuntimeError``.  An eager step raises before
its state is written back, as ``check_nan_inf`` does; a CUDA graph
writes its state back as its last nodes, so when a replayed step raises,
that step's state (and, in ``run_steps``, the window's) has already
been written.

Randomness: random init ops draw from one host generator per run, seeded
from the program's ``random_seed``, so the same program initializes the
same values on every device.  Random ops of a step (``dropout``) draw
from generators on the run's device, seeded from the program's seed, the
executor's run counter and the op's slot on the run's RNG counter
(``aux["rng_counter"]``); a graph reseeds its generators with the same
values before each replay, so its masks are the eager step's.  The
counter advances by ``op.attrs.get("__rng_slots__", 1)`` for every op
but feed, fetch and the reader ops, in sub-blocks too, and an op's slot
is the counter after it advanced; the counter starts at -1, so an op of
an unoptimized block without feed, fetch or reader ops has its position
as its slot.  An
optimization pass that removes or fuses ops charges their slots to the
next surviving op, so every random op keeps the slot, and so the mask,
it has in the unoptimized program.

Environment switches, as in the JAX package: ``PADDLE_TPU_VERIFY=1``
runs the structural verifier before a program's first run
(:meth:`Executor._maybe_verify`), ``PADDLE_TPU_OPT=1`` runs the
verify-sandwiched pass pipeline of :mod:`paddle_tpu_torch.analysis.opt`
on a clone (:meth:`Executor._maybe_optimize`), and
``PADDLE_TPU_CHECK_NAN_INF=1`` (or ``Program.check_nan_inf``) raises
naming the first fetch or state variable that is not finite, after the
step and before its write-back.

The training sentinel (``run(..., sentinel=...)``, the JAX package's,
``paddle_tpu/executor.py:519-531``): its check runs after the step and
before the state's write-back, which a guarded signature keeps outside
its CUDA graph, as ``check_nan_inf`` does; a trip leaves the scope
holding the pre-step state (the rows a sparse optimizer branch wrote in
place are put back from copies the guarded step takes before each
write) and raises :class:`~paddle_tpu_torch.fault.NumericalFault` with a
lazily built repro payload (:meth:`Executor._repro_payload`).  With
``sentinel=None`` nothing of this runs.  Numerics probing
(``obs.numerics.probe``) forces the eager step and calls
``numerics.record_op`` after each op; ``profiler.compiled_profiler``
forces it too and opens a ``torch.profiler.record_function`` range named
``profiler.op_scope_name(op)`` around each op.

Device performance (``obs/perf.py``): each prepared signature keeps a
cost record; a step that returns numpy fetches sets the ``train.mfu``
gauge (``gen.decode_mfu`` for a program tagged so, none for an untagged
inference program, ``_mfu_gauge_for``), each step ticks the HBM census
cadence, and under ``perf.enable_step_phases()`` the step records the
``perf.step.{feed,dispatch,device_wait,fetch}_seconds`` series.

Fetches come back as numpy arrays; a bfloat16 value is widened to
float32 (:func:`~paddle_tpu_torch.convert.fetch_numpy`), where the JAX
package returns an ml_dtypes bfloat16 array.  With ``return_numpy=False``
they are tensors the caller owns (a graph's outputs are cloned).
"""

from __future__ import annotations

import logging
import os
import threading
import time
import warnings

import numpy as np
import torch

from paddle_tpu_torch import framework
from paddle_tpu_torch import profiler as _profiler
from paddle_tpu_torch.channel import Channel
from paddle_tpu_torch.convert import fetch_numpy, to_tensor
from paddle_tpu_torch.framework import Program, default_main_program
from paddle_tpu_torch.lod import (SPLITS_SUFFIX, DynLoD, bucket_ragged_feed,
                                  next_bucket, validate_lod)
from paddle_tpu_torch.obs import numerics as _numerics
from paddle_tpu_torch.obs import perf as _perf
from paddle_tpu_torch.obs.trace import record_span as _record_span
from paddle_tpu_torch.obs.trace import span as _span
from paddle_tpu_torch.ops import registry
from paddle_tpu_torch.ops.csp_ops import CSP_OPS
from paddle_tpu_torch.ops.reader_ops import (READER_CREATE_OPS, READER_OPS,
                                             EOFException, build_reader)
from paddle_tpu_torch.place import default_place
from paddle_tpu_torch.scope import global_scope
from paddle_tpu_torch.step_graph import (GeneratorTable, StepGraph, checked,
                                         undoer)

__all__ = ["Executor", "lower_block", "fetch_var", "jit_cache_capacity"]

logger = logging.getLogger(__name__)

# feed/fetch ops are rewritten by the executor (feeds arrive in the env);
# reader ops run in the host-side pre-pass (_run_reader_ops), so the step
# never sees them
_SKIP_OPS = frozenset({"feed", "fetch"}) | READER_OPS


def _reader_ops(block):
    """The reader ops of ``block``, found once a program version (most
    blocks have none, and the pre-pass then walks no ops)."""
    version = block.program._version
    cached = getattr(block, "_reader_ops_cache", None)
    if cached is None or cached[0] != version:
        cached = (version, tuple(op for op in block.ops
                                 if op.type in READER_OPS))
        block._reader_ops_cache = cached
    return cached[1]


def _run_reader_ops(block, scope, feeds, device, steps=None):
    """Host-side reader pre-pass (the JAX package's, ``paddle_tpu/
    executor.py:48``): construct the reader objects of creation ops
    (once: a reader lives in the scope under its variable's name) and
    pop one batch per ``read`` op into ``feeds`` as tensors on
    ``device``, or, with ``steps``, ``steps`` batches stacked ``[steps,
    ...]``.  A pull that hits EOF part-way returns the batches it took
    to the reader (in order) and raises :class:`EOFException`."""
    for op in _reader_ops(block):
        if op.type in READER_CREATE_OPS:
            out = op.output("Out")[0]
            if scope.find_var(out) is None:
                reader = build_reader(op, scope, device=device)
                scope.set_var(out, reader)
                # back-pointer for Variable.reset() with explicit scopes
                var = block.vars.get(out)
                if var is not None:
                    var._reader_runtime = reader
        elif op.type == "read":
            reader = scope.find_var(op.input("Reader")[0])
            if reader is None:
                raise RuntimeError(
                    f"reader {op.input('Reader')[0]!r} is not created — "
                    f"run the startup program first")
            try:
                if steps is None:
                    batch = reader.next()
                else:
                    pulled = []
                    try:
                        for _ in range(steps):
                            pulled.append(reader.next())
                    except StopIteration:
                        # mid-pull EOF: return the consumed batches so a
                        # later pull serves them (in order)
                        for p in reversed(pulled):
                            reader.unget(p)
                        raise
                    # a double buffer on the card staged device tensors
                    stack = torch.stack if isinstance(
                        pulled[0][0], torch.Tensor) else np.stack
                    batch = tuple(stack([p[i] for p in pulled])
                                  for i in range(len(pulled[0])))
            except StopIteration:
                raise EOFException(
                    "reader exhausted — call reader.reset() to rewind")
            for name, arr in zip(op.output("Out"), batch):
                var = block.vars.get(name)
                feeds[name] = to_tensor(arr, device,
                                        getattr(var, "dtype", None))


def lower_block(block, env, aux):
    """Run every op of ``block`` in order against ``env`` (name ->
    tensor), merging each op's outputs into it.  Each op takes the next
    ``__rng_slots__`` (default 1) slots of ``aux["rng_counter"]``; the
    last of them keys its random draws.  While op profiling is on
    (``aux["profile"]``) each op is timed (``profiler.record_op``); with
    ``aux["op_ranges"]`` it runs inside a ``record_function`` range named
    ``profiler.op_scope_name(op)``; with ``aux["probe"]`` its outputs go
    to ``numerics.record_op``; under a CUDA graph capture
    (``aux["capturing"]``) a lowering that fails raises naming its op.
    With a release plan for the block (``aux["release"]``, from
    ``memory_optimization_transpiler.release_memory``) the env entries
    whose last use has passed are dropped after each op, their bytes
    and count added to the plan's ``stats``."""
    profiling = aux.get("profile")
    ranges = aux.get("op_ranges")
    probing = aux.get("probe")
    release = (aux.get("release") or {}).get(block.idx)
    for i, op in enumerate(block.ops):
        if op.type in _SKIP_OPS:
            continue
        opdef = registry.resolve_lowering(op.type)
        aux["rng_counter"] = aux.get("rng_counter", -1) + \
            op.attrs.get("__rng_slots__", 1)
        ctx = registry.LowerContext(op, env, block, aux=aux,
                                    op_index=aux["rng_counter"])
        try:
            if ranges:
                with torch.profiler.record_function(
                        _profiler.op_scope_name(op)):
                    opdef.lower(ctx)
            elif profiling:
                with _profiler.record_op(op.type, ctx):
                    opdef.lower(ctx)
            else:
                opdef.lower(ctx)
        except Exception as e:
            if aux.get("capturing") and not getattr(e, "_graph_op", False):
                err = RuntimeError(
                    f"CUDA graph capture failed lowering op {op.type!r} "
                    f"(#{i} of block {block.idx}): {e}")
                err._graph_op = True
                raise err from e
            raise
        env.update(ctx.outputs)
        if probing:
            # per-op numerics probes (obs/numerics.py): stats of every
            # output right after the op ran, first-non-finite capture
            _numerics.record_op(op, ctx.outputs, env)
        _share_lod(op, ctx.outputs, env, aux)
        if release is not None:
            # early release: an intermediate otherwise lives in the env
            # until the step ends; drop it past its last use, as the
            # reference's delete_var ops do (under a capture the graph's
            # pool reuses the block later in the same capture)
            stats = release["stats"]
            for n in release["dead_after"].get(i, ()):
                v = dict.pop(env, n, None)
                if isinstance(v, torch.Tensor):
                    stats["bytes"] += v.numel() * v.element_size()
                    stats["vars"] += 1
    return env


def _share_lod(op, outputs, env, aux):
    """Default LoD propagation (reference: kernels call ``ShareLoD(X,
    Out)`` unless they change the row structure): an output whose leading
    dim equals the first LoD-carrying input's row count inherits that
    input's LoD, unless the lowering set one.  By row count alone, as the
    JAX package decides it: a dense output with N rows is labelled too
    (for a :class:`~paddle_tpu_torch.lod.DynLoD`, the padded row
    count)."""
    lod_map = aux.get("lod")
    if not lod_map or not outputs:
        return
    src = rows = None
    for n in op.input_arg_names:
        v = env.get(n) if n in lod_map and n in env else None
        if v is not None and getattr(v, "ndim", 0) > 0:
            src, rows = lod_map[n], v.shape[0]
            break
    if src is None:
        return
    for n, v in outputs.items():
        if n not in lod_map and getattr(v, "ndim", 0) > 0 and \
                v.shape[0] == rows:
            lod_map[n] = src


def _lod_buckets_enabled(program):
    """The JAX package's switch for its bucketed LoD mode: the program's
    ``lod_buckets``, else ``PADDLE_TPU_LOD_BUCKETS``."""
    if getattr(program, "lod_buckets", None) is not None:
        return bool(program.lod_buckets)
    return _env_flag("PADDLE_TPU_LOD_BUCKETS")


def _is_lod_pair(value):
    return isinstance(value, tuple) and len(value) == 2 and \
        isinstance(value[1], (list, tuple))


def _host_array(value):
    """A ragged feed's value as a numpy array (to pad it to its bucket)."""
    return fetch_numpy(value) if isinstance(value, torch.Tensor) \
        else np.asarray(value)


def _is_dyn_meta(lod):
    """A scope LoD slot holding the bucketed mode's meta ("dyn", B, T)."""
    return isinstance(lod, tuple) and len(lod) == 3 and lod[0] == "dyn"


def _env_flag(name, default="0"):
    """Environment flag truthiness, as the JAX package parses it."""
    return os.environ.get(name, default).strip().lower() \
        not in ("0", "", "false", "off", "no")


def _check_nan_inf_enabled(program):
    """check_nan_inf mode (reference ``FLAGS_check_nan_inf``): the
    per-program ``check_nan_inf`` wins; ``PADDLE_TPU_CHECK_NAN_INF`` is
    the default."""
    if getattr(program, "check_nan_inf", None) is not None:
        return bool(program.check_nan_inf)
    return _env_flag("PADDLE_TPU_CHECK_NAN_INF")


def _check_nan_inf(fetch_names, fetches, new_state):
    """Raise naming the first fetched value, then the first state
    variable, that holds a NaN or an inf.  The check is one multi-tensor
    launch per dtype (the AMP unscale check at a scale of 1, which leaves
    every value as it was) and one device read for the step; only a step
    that fails looks at the tensors one by one, to name the variable."""
    named = [("fetch", n, v) for n, v in zip(fetch_names, fetches)]
    named += [("state", n, v) for n, v in new_state.items()]
    named = [(kind, n, v) for kind, n, v in named
             if isinstance(v, torch.Tensor) and v.is_floating_point()]
    if not named:
        return
    groups = {}
    for _, _, v in named:
        groups.setdefault((v.device, v.dtype), []).append(v)
    found = {}
    with torch.no_grad():
        for (device, _), group in groups.items():
            if device not in found:
                found[device] = torch.zeros(1, device=device)
            torch._amp_foreach_non_finite_check_and_unscale_(
                group, found[device], torch.ones(1, device=device))
    if not any(f.item() for f in found.values()):
        return
    for kind, name, v in named:
        if bool(torch.isfinite(v).all()):
            continue
        if kind == "fetch":
            raise RuntimeError(f"Operator output {name!r} contains "
                               f"NaN/Inf (check_nan_inf mode)")
        raise RuntimeError(f"Variable {name!r} contains NaN/Inf after "
                           f"the step (check_nan_inf mode)")


def _amp_enabled(program):
    """Mixed precision: a per-program ``Program.amp`` wins; the
    ``PADDLE_TPU_AMP`` flag is the default."""
    if getattr(program, "amp", None) is not None:
        return bool(program.amp)
    return _env_flag("PADDLE_TPU_AMP")


class _StateEnv(dict):
    """Run environment that reads a missing name from the scope (moving a
    host array there to the device, once) — the persistable state.
    ``loaded`` keeps what was read, the values a CUDA graph captures."""

    def __init__(self, scope, device):
        super().__init__()
        self.scope = scope
        self.device = device
        self.loaded = {}

    def _scope_value(self, name):
        """``name``'s scope value, a host array moved to the device (and
        stored back) once; a CSP channel as it is."""
        v = self.scope.find_var(name)
        if v is None:
            raise RuntimeError(
                f"variable {name!r} is not initialized in the scope — "
                f"run the startup program first")
        if isinstance(v, torch.Tensor) and v.device == self.device or \
                isinstance(v, Channel):
            return v
        v = to_tensor(v, self.device)
        self.scope.set_var(name, v)
        return v

    def __missing__(self, name):
        v = self._scope_value(name)
        self[name] = self.loaded[name] = v
        return v


class _SharedStateEnv(_StateEnv):
    """The env of a block holding CSP ops (``ops/csp_ops.py``): every
    persistable variable is read from and written to the shared scope at
    once, the JAX package's ``ScopeEnv`` (``paddle_tpu/executor.py:201``),
    so that ``go`` routines (on clones of this env, ``clone_for_thread``)
    and the block see each other's writes."""

    def __init__(self, scope, device, persistable_names):
        super().__init__(scope, device)
        self.persistable_names = persistable_names

    def __getitem__(self, name):
        if name in self.persistable_names and \
                self.scope.find_var(name) is not None:
            return self._scope_value(name)
        return super().__getitem__(name)

    def get(self, name, default=None):
        try:
            return self[name]
        except (KeyError, RuntimeError):
            return default

    def __setitem__(self, name, value):
        dict.__setitem__(self, name, value)
        if name in self.persistable_names:
            self.scope.set_var(name, value)

    def update(self, other=(), **kw):
        items = other.items() if hasattr(other, "items") else other
        for k, v in list(items) + list(kw.items()):
            self[k] = v

    def clone_for_thread(self):
        env = _SharedStateEnv(self.scope, self.device, self.persistable_names)
        dict.update(env, self)
        return env


def jit_cache_capacity():
    """Executor-level step-cache LRU capacity: PADDLE_TPU_JIT_CACHE_SIZE
    (default 64; values < 1 clamp to 1), as in the JAX package."""
    raw = os.environ.get("PADDLE_TPU_JIT_CACHE_SIZE", "").strip()
    try:
        return max(1, int(raw)) if raw else 64
    except ValueError:
        logger.warning("bad PADDLE_TPU_JIT_CACHE_SIZE=%r; using 64", raw)
        return 64


class _CompiledBlock:
    """A prepared block for one feed/fetch signature (the reference's
    holder of its jitted step): ``_prepare``'s partitions and capture
    decision, its cost record (``obs/perf.py``, or None), and ``fn(feeds,
    rng_seed, check)``, which runs one step and returns ``(fetches,
    stats, owned)``: the eager step (:class:`_EagerStep`) or, on the card,
    a :class:`~paddle_tpu_torch.step_graph.StepGraph`.  ``check(fetches,
    new_state, restore)`` runs before the write-back and returns the
    values to write back; ``restore()`` puts back the rows a guarded
    step wrote in place (:func:`undoer`)."""

    def __init__(self, fn, parts, fetch_names, record=None):
        self.fn = fn
        self.perf_record = record
        self.fetch_names = fetch_names
        self.feed_names = parts["feed_names"]
        self.ro_names = parts["ro_names"]
        self.inout_names = parts["inout_names"]
        self.create_state = parts["create_state"]
        self.param_names = parts["param_names"]
        self.interpret = parts["interpret"]


class _EagerStep:
    """``fn`` of an eager block: the prepared step, then the check and
    the write-back of the written state to the scope.  Its first call
    fills the signature's cost record (``perf.FirstRun``)."""

    def __init__(self, step, scope, device, record=None):
        self.step = step
        self.scope = scope
        self.device = device
        self.record = record

    def __call__(self, feeds, rng_seed, check):
        first = _perf.FirstRun(self.record, self.device)
        fetches, new_state, state_in, stats = self.step(
            feeds, rng_seed, GeneratorTable(rng_seed), False)
        first.done(feeds, state_in, fetches, new_state)
        self.record = None
        registry.raise_fault(stats["fault"], stats["fault_sites"])
        if check is not None:
            # before the write-back: a failing step leaves the scope as
            # it was (a guarded step's in-place rows are put back; a KV
            # pool's in-place writes stay)
            fetches, new_state = checked(check, fetches, new_state,
                                         undoer(stats.get("undo")))
        for n, v in new_state.items():
            self.scope.set_var(n, v)
        for n, lod in stats["state_lods"].items():
            self.scope.set_lod(n, lod)
        return fetches, stats, True


class _GraphShared:
    """The graph pool and capture stream shared by one executor's graphs,
    made at the first capture (a holder the graphs keep, so that they
    hold no reference to the executor)."""

    def __init__(self, device):
        self.device = device
        self._value = None

    def __call__(self):
        if self._value is None:
            self._value = (torch.cuda.graph_pool_handle(),
                           torch.cuda.Stream(self.device))
        return self._value


class Executor:
    """Reference ``python/paddle/fluid/executor.py:181``.  ``place``
    defaults to ``CUDAPlace(0)``; constructing an Executor there raises
    when CUDA is absent (pass ``CPUPlace()`` to run on the CPU)."""

    def __init__(self, place=None):
        self.place = place if place is not None else default_place()
        self.device = self.place.torch_device()
        _perf.arm_census_from_env()
        self._cache = {}
        self._cache_capacity = jit_cache_capacity()
        self._run_counter = 0
        #: ``{"while_trips": n, "host_reads": n}`` of the last run
        self.last_run = {}
        #: ``{name: LoD}`` of the last run's fetched variables that have
        #: one (host metadata: the reference's fetched ``LoDTensor.lod()``)
        self.last_fetch_lods = {}
        # PADDLE_TPU_VERIFY: (id, version) of the programs verified
        self._verified = set()
        # PADDLE_TPU_OPT: (id, version, feeds, fetches) -> optimized clone
        self._opt_cache = {}
        # one graph pool and capture stream for every graph of this
        # executor; replays and captures serialized by this lock
        self._graph_shared = _GraphShared(self.device)
        self._lock = threading.RLock()
        self._last_compiled = None

    # ------------------------------------------------------------------
    def _cache_insert(self, sig, value):
        """LRU insert bounded by PADDLE_TPU_JIT_CACHE_SIZE; evictions are
        counted (``jit_cache.evictions``) — a serving process churning
        through more signatures than the cache holds is re-preparing
        (and re-capturing), and the counter is how you see it."""
        while len(self._cache) >= self._cache_capacity:
            self._cache.pop(next(iter(self._cache)))
            _profiler.runtime_metrics.inc("jit_cache.evictions")
        self._cache[sig] = value

    # ------------------------------------------------------------------
    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, use_program_cache=True, sentinel=None):
        """Run ``program``'s global block once.  ``feed``: name -> array
        or tensor, or ``(value, lod)`` for a ragged variable (``lod``: a
        list of levels of row splits, the last ending at the value's row
        count); ``fetch_list``: Variables or names.  Returns the fetched
        values as numpy arrays (``return_numpy``) or tensors on the
        place's device that the caller owns.  ``use_program_cache`` is
        accepted for API parity: the step cache is always on.

        ``sentinel``: an optional :class:`paddle_tpu_torch.fault.Sentinel`
        guarding this step: its finite and spike checks run before the
        state's write-back, and a trip discards the update and raises
        :class:`~paddle_tpu_torch.fault.NumericalFault`.  A guarded
        signature is a cache entry (and a CUDA graph) of its own, whose
        write-back runs after the replay.  ``sentinel=None`` is the
        unguarded step, with no added host sync."""
        program, scope, fetch_names = self._resolve(program, scope,
                                                    fetch_list, feed)
        block = program.global_block()
        with _span("executor.run"):
            return self._run_traced(program, block, feed or {},
                                    fetch_names, scope, return_numpy,
                                    sentinel)

    def _run_traced(self, program, block, feed, fetch_names, scope,
                    return_numpy, sentinel=None):
        """Body of :meth:`run`, phase-annotated as the JAX package's:
        ``executor.feed`` (host -> device), ``executor.dispatch`` (the
        cache lookup and the step or graph replay, with the sentinel's
        check), ``executor.fetch`` (the fetches' conversion)."""
        phases = _perf.step_phases_enabled()
        t_feed = time.perf_counter()
        with _span("executor.feed"):
            feeds = {}
            for name, value in feed.items():
                var = block.vars.get(name)
                lod = None
                if _is_lod_pair(value):
                    value, lod = value
                _enforce_feed(name, value, var)
                if lod is not None and len(lod) == 1 and \
                        _lod_buckets_enabled(program):
                    # bucketed: rows padded to a bucket, the splits fed as
                    # data, the meta (not the splits) in the scope
                    value, splits, meta = bucket_ragged_feed(
                        name, _host_array(value), lod)
                    validate_lod(name, lod, int(splits[-1]))
                    feeds[name] = to_tensor(value, self.device,
                                            getattr(var, "dtype", None))
                    feeds[name + SPLITS_SUFFIX] = to_tensor(
                        splits, self.device, "int32")
                    scope.set_lod(name, meta)
                    continue
                if lod is not None:
                    rows = value.shape[0] if hasattr(value, "shape") \
                        else np.shape(value)[0]
                    lod = validate_lod(name, lod, rows)
                feeds[name] = to_tensor(value, self.device,
                                        getattr(var, "dtype", None))
                # a dense feed clears a stale LoD of an earlier ragged one
                scope.set_lod(name, lod)
            _run_reader_ops(block, scope, feeds, self.device)
        feed_dt = time.perf_counter() - t_feed
        with self._lock:
            with _span("executor.dispatch") as dsp:
                compiled = self._get_compiled(
                    program, block, feeds, tuple(fetch_names), scope,
                    guarded=sentinel is not None)
                t0 = time.perf_counter()
                fetches, owned, fault = self._dispatch(
                    compiled, program, feeds, scope, sentinel)
                dt = time.perf_counter() - t0
                dsp.set(fetches=len(fetch_names), graphed=not owned)
            _profiler.runtime_metrics.observe("executor.step_seconds", dt)
            _perf.census_tick(scope)
            with _span("executor.fetch"):
                if fault is not None:
                    registry.raise_fault(*fault)
                if phases:
                    # profile-step mode only: one explicit sync separates
                    # "device still computing" from the host conversion
                    tw = time.perf_counter()
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    t_fetch = time.perf_counter()
                    _profiler.runtime_metrics.observe(
                        "perf.step.device_wait_seconds", t_fetch - tw)
                if return_numpy:
                    result = [fetch_numpy(v) for v in fetches]
                    gauge = _mfu_gauge_for(program)
                    if gauge:
                        # the host conversion waited for the device: the
                        # whole step's wall time, feeds to fetches
                        _perf.note_step(compiled.perf_record,
                                        time.perf_counter() - t_feed,
                                        gauge=gauge)
                else:
                    result = fetches if owned \
                        else [v.clone() for v in fetches]
                if phases:
                    m = _profiler.runtime_metrics
                    m.observe("perf.step.feed_seconds", feed_dt)
                    m.observe("perf.step.dispatch_seconds", dt)
                    m.observe("perf.step.fetch_seconds",
                              time.perf_counter() - t_fetch)
                return result

    def _dispatch(self, compiled, program, feeds, scope=None, sentinel=None):
        """One step of ``compiled`` on ``feeds``: ``(fetches, owned,
        fault)``; ``fault`` is a replayed graph's ``(word, sites)``, for
        the caller to read (an eager step raised already), else None."""
        self._run_counter += 1
        rng_seed = int(program.random_seed or 0) * 1000003 + \
            self._run_counter
        check = self._step_check(compiled, program, feeds, scope, sentinel)
        self._last_compiled = compiled
        fetches, stats, owned = compiled.fn(feeds, rng_seed, check)
        self.last_run = {k: stats.get(k, 0)
                         for k in ("while_trips", "host_reads")}
        self.last_fetch_lods = stats.get("fetch_lods", {})
        fault = None
        if not owned and stats.get("fault") is not None:
            fault = (stats["fault"], stats["fault_sites"])
        return fetches, owned, fault

    def _step_check(self, compiled, program, feeds, scope, sentinel):
        """The ``check(fetches, new_state, restore)`` a step runs before
        its write-back: the sentinel's (``after_step``, with the pre-step
        parameters for its health norms and a lazy repro payload, which
        puts back in-place rows first), then ``check_nan_inf``'s; None
        when neither is on."""
        nan_check = _check_nan_inf_enabled(program)
        if sentinel is None and not nan_check:
            return None
        names = compiled.fetch_names

        def check(fetches, new_state, restore):
            if sentinel is not None:
                prev = {n: scope.find_var(n) for n in compiled.param_names}
                fetches, new_state = sentinel.after_step(
                    names, fetches, new_state,
                    repro=lambda: (restore(), self._repro_payload(
                        program, compiled, feeds, scope))[1],
                    prev_state=prev, param_names=compiled.param_names)
            if nan_check:
                _check_nan_inf(names, fetches, new_state)
            return fetches, new_state
        return check

    def _repro_payload(self, program, compiled, feeds, scope):
        """Self-contained replay payload for a sentinel quarantine bundle
        (the JAX package's, ``paddle_tpu/executor.py:576-592``): the
        program dict, the PRE-step state the step reads, the batch and the
        RNG coordinates needed to re-execute this exact step offline
        (``python -m paddle_tpu_torch replay``), as numpy arrays (bfloat16
        widened to float32), and the device type whose generators drew
        the step's random values (``rng_device``).  Built lazily, only on
        a trip, before the write-back."""
        state = {}
        for n in compiled.ro_names + compiled.inout_names:
            v = scope.find_var(n)
            if isinstance(v, (torch.Tensor, np.ndarray)):
                state[n] = fetch_numpy(v)
        return {"program": program.to_dict(),
                "random_seed": program.random_seed,
                "run_counter": self._run_counter,
                # the step's generators are this device's (Philox on a
                # card, MT19937 on the CPU): a replay elsewhere draws
                # other values from the same seed
                "rng_device": self.device.type,
                "feed": {n: fetch_numpy(v) for n, v in feeds.items()},
                "state": state,
                "fetch_names": list(compiled.fetch_names)}

    def run_steps(self, program=None, feed=None, fetch_list=None, steps=1,
                  scope=None, return_numpy=True):
        """Run ``steps`` iterations of ``program`` (reference
        ``paddle_tpu.executor.Executor.run_steps``, a ``lax.scan`` there):
        each step runs the one-step entry of its signature, a graph replay
        on the card, its per-step feeds copied into the graph's feed
        buffers.  A ``feed`` value is either one batch, reused every
        step, or stacked ``[steps, ...]`` batches (exactly one extra
        leading dim of length ``steps``), sliced per step.  Fetches come
        back stacked ``[steps, ...]``.  The entry is the one ``run``
        uses for the same feeds (the reference keys its scan apart)."""
        program, scope, fetch_names = self._resolve(program, scope,
                                                    fetch_list, feed)
        block = program.global_block()
        steps = int(steps)
        const_feed, per_step = {}, {}
        for name, value in (feed or {}).items():
            if isinstance(value, list) and value and \
                    all(map(_is_lod_pair, value)):
                per_step.update(self._ragged_window(
                    program, block, scope, name, value, steps))
                continue
            if _is_lod_pair(value):
                raise ValueError(
                    f"run_steps does not support a single LoD feed (got "
                    f"one for {name!r}); pass a LIST of per-step "
                    f"(value, lod) batches under program.lod_buckets, "
                    f"or bucket/pad ragged batches and use run()")
            scope.set_lod(name, None)
            var = block.vars.get(name)
            t = to_tensor(value, self.device, getattr(var, "dtype", None))
            want = tuple(var.shape) if var is not None and \
                var.shape is not None else None
            if want is not None and t.ndim == len(want) + 1 and \
                    t.shape[0] == steps:
                _enforce_feed(name, t[0], var)
                per_step[name] = t              # stacked [steps, ...]
            else:
                _enforce_feed(name, t, var)
                const_feed[name] = t            # one batch, reused
        # reader ops: `steps` batches a read op, stacked, sliced per step
        reader_feed = {}
        _run_reader_ops(block, scope, reader_feed, self.device, steps=steps)
        per_step.update(reader_feed)
        sample = dict(const_feed)
        sample.update({n: t[0] for n, t in per_step.items()})
        outs, word, sites = [], None, None
        t0 = time.perf_counter()
        with self._lock:
            compiled = self._get_compiled(program, block, sample,
                                          tuple(fetch_names), scope)
            for i in range(steps):
                feeds = dict(const_feed)
                feeds.update({n: t[i] for n, t in per_step.items()})
                fetches, owned, fault = self._dispatch(compiled, program,
                                                       feeds)
                outs.append(fetches if owned
                            else [v.clone() for v in fetches])
                if fault is not None:
                    # a graph output: ORed out before the next replay
                    word = fault[0].clone() if word is None \
                        else word | fault[0]
                    sites = fault[1]
        registry.raise_fault(word, sites)
        stacked = [torch.stack([o[j] for o in outs])
                   for j in range(len(fetch_names))]
        _perf.census_tick(scope)
        if return_numpy:
            result = [fetch_numpy(v) for v in stacked]
            gauge = _mfu_gauge_for(program)
            if gauge:
                # the window's wall time, its conversion waited for the
                # device; the record prices one step
                _perf.note_step(compiled.perf_record,
                                time.perf_counter() - t0, gauge=gauge,
                                flops_scale=steps)
            return result
        return stacked

    def _ragged_window(self, program, block, scope, name, value, steps):
        """A window of ``steps`` ragged ``(value, lod)`` batches of feed
        ``name`` under the bucketed mode (the JAX package's, ``paddle_tpu/
        executor.py:730-790``): every batch padded to one ``(n_bucket,
        t_bucket)``, the values stacked ``[steps, n_bucket, ...]`` and
        the splits ``[steps, B + 1]``; the meta goes into the scope.
        Returns the two stacked feeds."""
        if not _lod_buckets_enabled(program):
            raise ValueError(
                f"run_steps got per-step LoD feeds for {name!r}; "
                f"enable bucketed mode (program.lod_buckets = "
                f"True) so the window shares one executable")
        if len(value) != steps:
            raise ValueError(
                f"run_steps: {name!r} has {len(value)} ragged "
                f"batches for {steps} steps")
        var = block.vars.get(name)
        arrays = [_host_array(v) for v, _ in value]
        rows = [a.shape[0] for a in arrays]
        mls, n_seqs = [], set()
        for _, lod in value:
            sp = np.asarray(lod[-1], np.int64)
            lens = sp[1:] - sp[:-1]
            mls.append(int(lens.max()) if len(lens) else 0)
            n_seqs.add(len(sp) - 1)
        if len(n_seqs) != 1:
            raise ValueError(
                f"run_steps: {name!r} batches disagree on "
                f"sequence count {sorted(n_seqs)}")
        nb = next_bucket(max(max(rows), 1))
        tb = next_bucket(max(max(mls), 1))
        padded, splits, meta = [], [], None
        for a, (_, lod) in zip(arrays, value):
            _enforce_feed(name, a, var)
            p, sp, meta = bucket_ragged_feed(name, a, lod, n_bucket=nb,
                                             t_bucket=tb)
            validate_lod(name, lod, int(sp[-1]))
            padded.append(p)
            splits.append(sp)
        scope.set_lod(name, meta)
        return {name: to_tensor(np.stack(padded), self.device,
                                getattr(var, "dtype", None)),
                name + SPLITS_SUFFIX: to_tensor(np.stack(splits),
                                                self.device, "int32")}

    def run_pipeline(self, program=None, pipeline=None, fetch_list=None,
                     scope=None, max_steps=None, return_numpy=True,
                     on_step=None, sentinel=None, ledger=None):
        """Drive one epoch (or ``max_steps`` batches) of a ``datapipe``
        pipeline through :meth:`run` (reference
        ``paddle_tpu/executor.py:914``, on the same signature).

        Each batch must be a feed dict (``name -> array``), the shape a
        ``Batch`` stage with dict samples (or a custom collate) emits;
        batches already on the card from a ``DevicePrefetch`` stage
        enter :meth:`run` without a host copy.  Fires the ``train.step``
        failpoint per batch (so ``PADDLE_TPU_CHAOS`` kill drills target
        this loop), records the ``datapipe.next`` and ``train.step``
        spans and ``datapipe.step_seconds``.  ``max_steps`` is checked
        before the pull, so no batch is lost; stopping there closes the
        iterator cleanly: threaded stages quiesce with their position
        intact, so a following ``pipeline.state_dict()`` checkpoints
        mid-epoch.

        ``on_step(step_index, fetches)`` runs after each batch (metrics,
        checkpointing).  Returns the list of per-batch fetch lists.

        ``sentinel``: a :class:`paddle_tpu_torch.fault.Sentinel` turns
        this loop into the automatic recovery loop: a tripped check skips
        the poisoned update, quarantines the batch as a repro bundle,
        and after K strikes rolls back to the sentinel's last known-good
        checkpoint (which also rewinds the pipeline's iterator position)
        and resumes.  Skipped steps never appear in the returned fetch
        lists, and a rollback also drops the entries it rewound (their
        batches re-run and re-append), so each applied batch appears
        exactly once.

        ``ledger``: a :class:`paddle_tpu_torch.obs.ledger.RunLedger`
        appends one step row per APPLIED batch (skipped steps write no
        row), BEFORE ``on_step`` runs, so that a checkpoint committed by
        ``on_step`` carries a sidecar whose ``rows_total`` includes its
        own step.  When omitted, the sentinel's checkpoint manager's
        ``ledger`` (if any) is used.  Disabled, it is one ``None`` check
        a step."""
        from paddle_tpu_torch.fault import chaos as _chaos
        from paddle_tpu_torch.fault.sentinel import NumericalFault
        if pipeline is None:
            raise ValueError("run_pipeline requires a datapipe pipeline")
        outs = []
        # checkpoint step -> len(outs) when the manager committed it,
        # keyed by the step number the checkpoint was SAVED under (which
        # need not match this loop's 0-based index: a resumed trainer
        # may number globally); observed through the manager's
        # in-process last_committed_step after each on_step, so that the
        # rollback branch can truncate exactly (not latest_step(): that
        # lists the directory, and a restarted trainer renumbering from
        # 0 under a directory holding a prior run's higher ckpt-N would
        # never see its own commits through it)
        marks = {}
        mgr = sentinel.manager if sentinel is not None else None
        last_ckpt = getattr(mgr, "last_committed_step", None) \
            if mgr is not None else None
        if ledger is None and mgr is not None:
            ledger = getattr(mgr, "ledger", None)
        fetch_name_list = [v.name if hasattr(v, "name") else str(v)
                           for v in (fetch_list or [])]
        it = iter(pipeline)
        try:
            step = 0
            # check the budget BEFORE pulling: a batch pulled past the
            # limit would be dropped (lost from the resume sequence)
            while max_steps is None or step < max_steps:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    break
                stall = time.perf_counter() - t0
                # recorded only on success: a normal epoch-end
                # StopIteration is not an error-tagged span
                _record_span("datapipe.next", t0, stall, step=step)
                _chaos.fire("train.step", step=step)
                try:
                    with _span("train.step", step=step):
                        with _profiler.record_latency(
                                "datapipe.step_seconds"):
                            fetches = self.run(program=program, feed=batch,
                                               fetch_list=fetch_list,
                                               scope=scope,
                                               return_numpy=return_numpy,
                                               sentinel=sentinel)
                        if ledger is not None:
                            ledger.note_step(fetch_names=fetch_name_list,
                                             fetches=fetches,
                                             stall_seconds=stall)
                        if on_step is not None:
                            on_step(step, fetches)
                except NumericalFault as fault:
                    if sentinel is None:
                        raise
                    restored = sentinel.handle_fault(fault, step=step)
                    if restored is not None:
                        mgr = sentinel.manager
                        if getattr(mgr, "last_restore_rewound", False) \
                                and hasattr(pipeline, "load_state_dict"):
                            # the rollback rewound the pipeline's
                            # position; the open iterator still points at
                            # the pre-rollback stream: reopen it, and
                            # drop the entries the rollback undid (their
                            # batches re-run from the rewound stream).  A
                            # checkpoint this loop never committed
                            # rewinds past everything it returned
                            close = getattr(it, "close", None)
                            if close is not None:
                                close()
                            it = iter(pipeline)
                            del outs[marks.get(restored, 0):]
                        else:
                            # params-only rollback: no datapipe state to
                            # rewind; keep consuming the current iterator
                            # (reopening would restart the epoch)
                            logger.warning(
                                "sentinel rollback restored step %s "
                                "params-only (no datapipe state to "
                                "rewind): batches since that step "
                                "cannot be replayed; attach datapipe= "
                                "to CheckpointManager for exact-once "
                                "semantics", restored)
                    step += 1
                    continue
                outs.append(fetches)
                if mgr is not None and on_step is not None:
                    # did on_step commit a checkpoint this step?  Its
                    # saved position is AFTER this batch, so the mark
                    # includes the entry just appended
                    ckpt = getattr(mgr, "last_committed_step", None)
                    if ckpt is not None and ckpt != last_ckpt:
                        marks[ckpt] = len(outs)
                        last_ckpt = ckpt
                step += 1
        finally:
            close = getattr(it, "close", None)  # plain iterables lack it
            if close is not None:
                close()
        return outs

    def warmup(self, program=None, feed_shapes=None, fetch_list=None,
               scope=None, allow_state_updates=False):
        """Run ``program`` for each declared feed signature on zero feeds
        before real traffic arrives, so the first real request pays no
        kernel build and, on the card, no capture: a signature that runs
        as a CUDA graph runs twice (its eager first run, then its
        capture), so the first real request replays it (the counterpart
        of the JAX package's AOT warmup).

        ``feed_shapes``: a dict ``name -> concrete shape`` (one
        signature) or a list of them (one per serving bucket); dtypes come
        from the program's variables.  Every kernel a signature reaches is
        built (``nvcc``) or loaded from the build directory here.

        Warmup EXECUTES the program, so a program that writes persistable
        state is refused unless ``allow_state_updates`` opts in: ``True``
        allows every state write, an iterable of names exactly those (the
        generation decode step declares its KV-cache tensors; zero feeds
        write nothing into them).

        Returns a :class:`paddle_tpu_torch.obs.perf.WarmupReport`: the
        number of kernel sources compiled, with one ``buckets`` entry per
        signature — its seconds, its compiles and its ``cache``: ``"cold"``
        (a source was compiled by ``nvcc`` for it), ``"persistent-hit"``
        (a library was loaded from the build directory) or ``"warm"``
        (nothing new)."""
        from paddle_tpu_torch.io import synth_feed_value
        from paddle_tpu_torch.kernels import build
        from paddle_tpu_torch.obs.perf import WarmupReport

        program = program if program is not None else default_main_program()
        specs = feed_shapes if isinstance(feed_shapes, (list, tuple)) \
            else [feed_shapes or {}]
        block = program.global_block()
        if allow_state_updates is not True:
            allowed = set(allow_state_updates or ())
            written = [n for op in block.ops if op.type not in _SKIP_OPS
                       for n in op.output_arg_names
                       if n not in allowed and n in block.vars and
                       block.vars[n].persistable]
            if written:
                raise ValueError(
                    f"warmup would EXECUTE this program, mutating "
                    f"persistable state ({sorted(set(written))[:3]}...) "
                    f"with zero-filled feeds — warm an inference program "
                    f"instead, or pass allow_state_updates=True if the "
                    f"state writes are intended")
        before = build.counts["compiled"]
        buckets = []
        with _profiler.record_latency("executor.warmup_seconds"):
            for spec in specs:
                feed = {}
                for name, shape in spec.items():
                    if shape is None or any(
                            d is None or int(d) < 0 for d in shape):
                        raise ValueError(
                            f"warmup feed {name!r} needs a concrete "
                            f"shape, got {shape}")
                    var = block.vars.get(name)
                    dtype = (var.dtype if var is not None
                             and var.dtype is not None else "float32")
                    feed[name] = synth_feed_value(shape, dtype)
                built0, loaded0 = build.counts["compiled"], \
                    build.counts["loaded"]
                t0 = time.perf_counter()
                self.run(program=program, feed=feed, fetch_list=fetch_list,
                         scope=scope, return_numpy=False)
                fn = self._last_compiled.fn
                if isinstance(fn, StepGraph) and fn.graph is None:
                    self.run(program=program, feed=feed,
                             fetch_list=fetch_list, scope=scope,
                             return_numpy=False)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                fresh = build.counts["compiled"] - built0
                hit = build.counts["loaded"] - loaded0
                buckets.append({
                    "signature": {n: list(map(int, s))
                                  for n, s in spec.items()},
                    "compiles": fresh,
                    "seconds": time.perf_counter() - t0,
                    "cache": ("cold" if fresh else
                              "persistent-hit" if hit else "warm"),
                })
        compiled = build.counts["compiled"] - before
        _profiler.runtime_metrics.inc("warmup.signatures", len(specs))
        _profiler.runtime_metrics.inc("warmup.compiles", compiled)
        return WarmupReport(compiled, buckets)

    def graph_stats(self):
        """One entry per cached signature that runs as a CUDA graph
        (``StepGraph.stats``): label, captures, replays, capture seconds,
        nodes, pool growth."""
        with self._lock:
            entries = list(self._cache.values())
        return [c.fn.stats() for c in entries if isinstance(c.fn, StepGraph)]

    # ------------------------------------------------------------------
    def _resolve(self, program, scope, fetch_list, feed=None):
        """The program to run (optimized under ``PADDLE_TPU_OPT``, after
        verification under ``PADDLE_TPU_VERIFY``), the scope and the
        fetch names."""
        program = program if program is not None else default_main_program()
        if not isinstance(program, Program):
            raise TypeError("executor requires a Program")
        scope = scope if scope is not None else global_scope()
        fetch_names = [f.name if isinstance(f, framework.Variable) else f
                       for f in (fetch_list or [])]
        if _env_flag("PADDLE_TPU_VERIFY"):
            self._maybe_verify(program, feed or {}, fetch_names)
        program = self._maybe_optimize(program, feed or {}, fetch_names)
        return program, scope, fetch_names

    def _maybe_optimize(self, program, feed, fetch_names):
        """``PADDLE_TPU_OPT=1``: run the pass pipeline of
        :mod:`paddle_tpu_torch.analysis.opt` over a clone of ``program``
        once per ``(program, version, feeds, fetches)``; later runs pay
        one dict lookup, and mutating the program (``bump_version``)
        re-optimizes.  The input program is never mutated, and every
        pass is verify-sandwiched (a pass that introduces a diagnostic
        is reverted)."""
        if not _env_flag("PADDLE_TPU_OPT"):
            return program
        if getattr(program, "_opt_report", None) is not None:
            return program  # already an optimized clone
        key = (id(program), program._version, tuple(sorted(feed or ())),
               tuple(fetch_names))
        cached = self._opt_cache.get(key)
        if cached is not None:
            return cached
        from paddle_tpu_torch.analysis.opt import optimize_program
        optimized, report = optimize_program(
            program, feed_names=tuple(feed or ()),
            fetch_names=tuple(fetch_names))
        logger.debug("PADDLE_TPU_OPT: %r", report)
        if getattr(program, "_release_memory", False):
            # the early-release plan keys op indices: rebuild it against
            # the optimized op list
            from paddle_tpu_torch.memory_optimization_transpiler import \
                release_memory
            release_memory(optimized)
        if len(self._opt_cache) > 256:  # id()-reuse bound, not a cache
            self._opt_cache.clear()
        self._opt_cache[key] = optimized
        return optimized

    def _maybe_verify(self, program, feed, fetch_names):
        """``PADDLE_TPU_VERIFY=1``: run the structural verifier before a
        program's first run, so an ill-formed program fails naming its
        variables and ops before any op runs.  Memoized per ``(program,
        version)``: ``bump_version`` re-verifies."""
        key = (id(program), program._version)
        if key in self._verified:
            return
        from paddle_tpu_torch import analysis
        analysis.verify_program(program, feed_names=tuple(feed),
                                fetch_names=tuple(fetch_names),
                                where="executor.run")
        if len(self._verified) > 4096:  # id() reuse bound, not a cache
            self._verified.clear()
        self._verified.add(key)

    # ------------------------------------------------------------------
    def _signature(self, program, block, feeds, fetch_names, scope,
                   guarded=False):
        """Cheap cache key — no per-op work, safe to compute every step.
        The reference's components (``paddle_tpu/executor.py:1087``),
        its ``_release_memory`` after them, and ``check_nan_inf`` last
        (it moves a graph's write-back after the check).  A guarded
        step, numerics probing and the op ranges of a device profile
        append one tuple naming them, so that an unguarded, unprobed
        step's key is the plain one.  A distinct LoD
        is a distinct entry: the LoD is host metadata of the step; a
        bucketed feed's is its meta ``("dyn", B, T_bucket)``, its splits
        a feed."""
        feed_lods = tuple(sorted(
            (n, _freeze_lod(scope.find_lod(n))) for n in feeds
            if scope.find_lod(n) is not None))
        sig = (id(program), program._version, block.idx,
               _amp_enabled(program),
               id(scope),  # the step binds the scope
               _profiler.op_profiling_enabled(),  # forces the eager step
               tuple(sorted((n, str(a.dtype), tuple(a.shape))
                            for n, a in feeds.items())),
               feed_lods,
               tuple(fetch_names),
               bool(getattr(program, "_release_memory", False)),
               _check_nan_inf_enabled(program))
        extra = _step_modes(guarded)
        return sig + (extra,) if extra else sig

    def _prepare(self, program, block, feeds, fetch_names, scope,
                 guarded=False):
        """Classify the block's variables and build the step function
        (reference ``paddle_tpu/executor.py:1111``).

        Returns a dict with the cache signature, the ``step`` callable,
        the state-name partitions (``ro_names``, ``inout_names``,
        ``create_state``), ``param_names`` and ``interpret`` (the capture
        rule: True keeps the block eager).  O(#ops): callers hit the
        signature cache first."""
        sig = self._signature(program, block, feeds, fetch_names, scope,
                              guarded)
        feed_names = tuple(sorted(feeds))

        # classify non-feed external inputs (state) and written persistables
        produced = set(feed_names)
        reads, writes = [], []
        for op in block.ops:
            if op.type in _SKIP_OPS:
                continue
            for n in op.input_arg_names:
                if n and n not in produced:
                    reads.append(n)
            for n in op.output_arg_names:
                if n:
                    produced.add(n)
                    writes.append(n)
        # sub-block reads of outer vars: any var a sub-block of an op of
        # this block reads that neither it nor this block produced
        for op in block.ops:
            for a in op.attrs.values():
                if isinstance(a, framework.Block):
                    reads.extend(_external_reads(a, produced))

        state_names, seen = [], set()
        for n in reads:
            if n not in seen and n not in feed_names:
                seen.add(n)
                state_names.append(n)
        written_state = []
        for n in writes:
            var = _safe_var(block, n)
            if var is not None and var.persistable and \
                    n not in written_state:
                written_state.append(n)
        # fetched vars never produced in this block (a parameter) are
        # state reads too
        for n in fetch_names:
            if n not in produced and n not in state_names and \
                    n not in feed_names:
                state_names.append(n)
        inout_names = tuple(n for n in state_names if n in written_state)
        ro_names = tuple(n for n in state_names if n not in written_state)
        # persistables written but never read still need write-back
        create_state = tuple(n for n in written_state
                             if n not in inout_names)
        param_names = tuple(
            n for n in inout_names + create_state
            if isinstance(_safe_var(block, n), framework.Parameter))
        # persistable state read here: a LoD a lowering set on it in an
        # earlier run is in the scope (detection_map's accumulators)
        lod_state = tuple(
            n for n in state_names
            if getattr(_safe_var(block, n), "persistable", False))
        # a block with CSP ops shares its persistables with its routines
        shared = _persistable_names(program) if any(
            op.type in CSP_OPS for op in _walk_ops(block)) else None

        feed_lods = {n: lod for n in feeds
                     for lod in (scope.find_lod(n),) if lod is not None}
        buckets = _lod_buckets_enabled(program)
        # under the switch an eager_dyn_ok op keeps no block eager, unless
        # a feed keeps a static LoD, whose tables are host-made
        dyn = buckets and all(map(_is_dyn_meta, feed_lods.values()))
        host = _has_host_ops(block, dyn)
        # no warning for a run-once initializer (no feeds, no fetches:
        # a startup program), whose only run is eager anyway
        if host and (feeds or fetch_names) and \
                not getattr(program, "expect_host_ops", False):
            _warn_host_op_cliff(program, block, dyn)
        profiling = _profiler.op_profiling_enabled()
        probing = _numerics.probing_enabled()
        ranges = _profiler.op_ranges_enabled()
        opt_interpret = bool(getattr(program, "_opt_interpret", False))
        # op profiling, probes and op ranges act per op: the eager step
        interpret = host or profiling or probing or ranges or opt_interpret
        # under the switch, the JAX package would trace this block (its
        # rule: no ``host`` op but the dynamic-LoD ones): a static LoD is
        # a constant of the step (``lod.tables``), and sequence_slice /
        # sequence_erase take their bucketed branch over it
        traced = buckets and not (profiling or probing or ranges or
                                  opt_interpret or any(
            _ref_host(op, buckets) for op in _walk_ops(block)))

        lod_map = {n: DynLoD(n + SPLITS_SUFFIX, lod[1], lod[2])
                   if _is_dyn_meta(lod) else [list(level) for level in lod]
                   for n, lod in feed_lods.items()}
        amp = _amp_enabled(program)
        seed = int(program.random_seed or 0)
        device = self.device
        write_names = inout_names + create_state
        fetch_check = Executor.fetch_missing_check
        # the block's constants on the device (assign_value), made once
        constants = {}
        release = self._release_plan(program, block, fetch_names,
                                     write_names)
        extra_aux = self._step_aux()

        def step(feeds, rng_seed, generators, capturing):
            env = _StateEnv(scope, device) if shared is None else \
                _SharedStateEnv(scope, device, shared)
            env.update(feeds)
            lods = {n: lod if isinstance(lod, DynLoD)
                    else [list(level) for level in lod]
                    for n, lod in lod_map.items()}
            for n in lod_state:
                lod = scope.find_lod(n)
                if lod is not None and not _is_dyn_meta(lod):
                    lods[n] = [list(level) for level in lod]
            aux = {"device": device,
                   # random init ops: one host generator per run
                   "generator": torch.Generator().manual_seed(seed),
                   # device generators of the step's random ops
                   "rng_seed": rng_seed, "generators": generators,
                   "rng_counter": -1, "amp": amp, "scope": scope,
                   "lower_block": lower_block, "profile": profiling,
                   "probe": probing, "op_ranges": ranges,
                   "capturing": capturing, "constants": constants,
                   "traced": traced,
                   # a guarded step's in-place writes, to put back on a
                   # trip (the sparse optimizer branches fill it)
                   "undo": [] if guarded else None,
                   # the feeds' and the state's LoDs; ops add theirs
                   # (set_output_lod) and _share_lod passes them on
                   "lod": lods}
            aux.update(extra_aux)
            if release is not None:
                stats = release[block.idx]["stats"]
                stats["bytes"] = stats["vars"] = 0  # per-walk measurement
                aux["release"] = release
            with torch.no_grad():
                lower_block(block, env, aux)
            if aux.get("go_errors"):
                raise RuntimeError(
                    f"a go routine of block {block.idx} failed: "
                    f"{aux['go_errors'][0]!r}") from aux["go_errors"][0]
            # a fetch the block did not write is read from the scope
            fetches = [env[n] for n in fetch_check(
                fetch_names, {n for n in fetch_names
                              if n in env or scope.find_var(n) is not None})]
            new_state = {n: env[n] for n in write_names if n in env}
            stats = {k: aux.get(k, 0) for k in ("while_trips", "host_reads")}
            stats["state_lods"] = {n: aux["lod"][n] for n in write_names
                                   if n in aux.get("lods_set", ())}
            stats["fetch_lods"] = {n: aux["lod"][n] for n in fetch_names
                                   if isinstance(aux["lod"].get(n), list)}
            stats["fault"], stats["fault_sites"] = registry.fault_word(aux)
            stats["undo"] = aux["undo"]
            return fetches, new_state, env.loaded, stats

        return {"sig": sig, "step": step, "feed_names": feed_names,
                "ro_names": ro_names, "inout_names": inout_names,
                "create_state": create_state, "interpret": interpret,
                "param_names": param_names}

    def _step_aux(self):
        """Entries a subclass adds to every step's ``aux`` (the mesh of
        ``ParallelExecutor``)."""
        return {}

    @staticmethod
    def _release_plan(program, block, fetch_names, write_names):
        """The early-release map of a released program's ``block``
        (``{block.idx: {"dead_after": {op index: [names]}, "stats"}}``,
        reference ``paddle_tpu/executor.py:1207-1224``), or None: each
        variable dies after its last use (a control-flow op lists its
        sub-block's outer reads among its inputs) but the fetches, the
        written state and every persistable.  ``program._release_stats`` is the
        stats dict, filled by each walk of the op list (a graph's only at
        its capture)."""
        if not getattr(program, "_release_memory", False):
            return None
        plan = getattr(program, "_memory_plan", None)
        if plan is None or block.idx not in plan.last_use:
            return None
        protect = set(fetch_names) | set(write_names) | \
            set(_persistable_names(program))
        dead_after = {}
        for name, idx in plan.last_use[block.idx].items():
            if name not in protect:
                dead_after.setdefault(idx, []).append(name)
        stats = {"bytes": 0, "vars": 0}
        program._release_stats = stats
        return {block.idx: {"dead_after": dead_after, "stats": stats}}

    def _get_compiled(self, program, block, feeds, fetch_names, scope,
                      guarded=False):
        """The cached entry of this run's signature (an LRU hit bumps it,
        ``jit_cache.hits``), else a prepared one (``jit_cache.misses``,
        ``executor.prepare_seconds``, a cost record): on the card a
        :class:`~paddle_tpu_torch.step_graph.StepGraph` unless the capture
        rule keeps the block eager.  The graph writes its state back as
        its last nodes unless a check must see the step first
        (``check_nan_inf`` or a sentinel)."""
        sig = self._signature(program, block, feeds, fetch_names, scope,
                              guarded)
        hit = self._cache.get(sig)
        if hit is not None:
            self._cache[sig] = self._cache.pop(sig)  # LRU bump
            _profiler.runtime_metrics.inc("jit_cache.hits")
            return hit
        _profiler.runtime_metrics.inc("jit_cache.misses")
        t0 = time.perf_counter()
        with _profiler.record_latency("executor.prepare_seconds"):
            parts = self._prepare(program, block, feeds, fetch_names, scope,
                                  guarded)
        record = _perf.new_record(program, feeds, fetch_names,
                                  time.perf_counter() - t0, self.device)
        if parts["interpret"] or self.device.type != "cuda":
            fn = _EagerStep(parts["step"], scope, self.device, record)
        else:
            label = ",".join(f"{n}{list(feeds[n].shape)}"
                             for n in parts["feed_names"]) or "no feeds"
            fn = StepGraph(parts["step"], scope, self.device,
                           parts["ro_names"] + parts["inout_names"] +
                           parts["create_state"],
                           self._graph_shared,
                           label=f"{label} -> {len(fetch_names)} fetches",
                           writeback_in_graph=not (
                               guarded or _check_nan_inf_enabled(program)),
                           record=record)
        compiled = _CompiledBlock(fn, parts, tuple(fetch_names), record)
        self._cache_insert(sig, compiled)
        return compiled

    @staticmethod
    def fetch_missing_check(fetch_names, env):
        """Raise naming the first fetch target ``env`` does not hold."""
        for n in fetch_names:
            if n not in env:
                raise KeyError(f"fetch target {n!r} was not produced by the "
                               f"program and is not in the scope")
        return fetch_names

    def close(self):
        """Drop the step cache (and with it every CUDA graph and, once
        they are gone, their pool), the memoized optimized programs and
        the verifications."""
        with self._lock:
            self._cache.clear()
            self._last_compiled = None
            self._graph_shared = _GraphShared(self.device)
            self._opt_cache.clear()
            self._verified.clear()


def _step_modes(guarded):
    """The signature's optional component: the modes that change how a
    step runs (a sentinel guard, numerics probes, op ranges), or ()."""
    return tuple(name for name, on in (
        ("guarded", guarded), ("probing", _numerics.probing_enabled()),
        ("op_ranges", _profiler.op_ranges_enabled())) if on)


def _mfu_gauge_for(program):
    """Which MFU gauge a program's steps feed (the JAX package's,
    ``paddle_tpu/executor.py:1331``): an explicit ``_mfu_gauge`` tag wins
    (``GenPredictor`` tags its decode program ``gen.decode_mfu``);
    untagged TRAINING programs feed ``train.mfu``; untagged inference
    programs (a serving ``Predictor``, a prefill) none, so that a one-shot
    prefill does not overwrite the training and decode gauges."""
    tagged = getattr(program, "_mfu_gauge", None)
    if tagged:
        return tagged
    return None if program._is_inference else "train.mfu"


def _safe_var(block, name):
    try:
        return block.var(name)
    except (KeyError, ValueError):
        return None


_WARNED_HOST_OP_BLOCKS = set()


def _warn_host_op_cliff(program, block, dyn=False):
    """One host op anywhere switches the WHOLE block to op-by-op eager
    execution — warn once per (program, block) naming the culprits, in
    sub-blocks too, so a user adding e.g. ``edit_distance`` to a
    training graph learns why the step got slow (the reference's
    warning; the culprits are :func:`_host_ops`)."""
    key = (id(program), block.idx)
    if key in _WARNED_HOST_OP_BLOCKS:
        return
    _WARNED_HOST_OP_BLOCKS.add(key)
    culprits = _host_ops(block, dyn)
    warnings.warn(
        f"block {block.idx} contains host op(s) "
        f"{sorted(set(culprits))} — the whole block runs op-by-op eager "
        f"instead of one CUDA graph; keep host ops (metrics/decoding) in "
        f"a separate program to keep training graphed",
        skip_file_prefixes=(os.path.dirname(os.path.abspath(__file__)),))


def _has_host_ops(block, dyn=False):
    """The capture rule's op test (the reference's, ``:1457``, widened by
    the port's ``eager_only``): an op of ``block`` or of a sub-block
    keeps it out of a CUDA graph."""
    return bool(_host_ops(block, dyn))


def _walk_ops(block):
    """The ops of ``block`` and of its sub-blocks, depth first."""
    for op in block.ops:
        yield op
        for a in op.attrs.values():
            if isinstance(a, framework.Block):
                yield from _walk_ops(a)


def _ref_host(op, dyn):
    """The reference's ``host`` flag, lifted for an ``eager_dyn_ok`` op
    under the bucketed mode (its ``host_dyn_ok``)."""
    opdef = registry.lookup(op.type)
    return opdef is not None and opdef.host and \
        not (dyn and opdef.eager_dyn_ok)


def _host_ops(block, dyn=False):
    """The types of the ops of ``block`` and its sub-blocks that keep it
    out of a CUDA graph: ``host`` (the reference's flag) or
    ``eager_only`` (the port's, :func:`registry.eager_only`); with
    ``dyn`` (the bucketed LoD mode, the reference's ``dyn`` argument,
    ``paddle_tpu/executor.py:1457``) not the ops marked
    ``eager_dyn_ok``."""
    return [op.type for op in _walk_ops(block)
            if _ref_host(op, dyn) or registry.eager_only(op, dyn)]


def _freeze_lod(lod):
    """Nested row-splits list -> hashable tuple (cache key component); a
    bucketed meta ("dyn", B, T_bucket) is one already: the splits stay
    out of the key."""
    if lod is None:
        return None
    if _is_dyn_meta(lod):
        return lod
    return tuple(tuple(int(x) for x in level) for level in lod)


def _external_reads(block, produced_outer):
    """Names read inside ``block`` (recursively) that neither the block nor
    the outer trace produces — they must come from scope state."""
    produced = set(produced_outer)
    ext = []
    for op in block.ops:
        for n in op.input_arg_names:
            if n and n not in produced and not block.has_var_local(n):
                ext.append(n)
        for n in op.output_arg_names:
            produced.add(n)
        for a in op.attrs.values():
            if isinstance(a, framework.Block):
                ext.extend(_external_reads(a, produced))
    return ext


def _persistable_names(program):
    """Every persistable variable name of ``program``, over all blocks."""
    names = set()
    for blk in program.blocks:
        for v in blk.vars.values():
            if getattr(v, "persistable", False):
                names.add(v.name)
    return names


def fetch_var(name, scope=None, return_numpy=True):
    """The value of ``name`` in ``scope`` (default: the global scope),
    as a numpy array (bfloat16 widened to float32) or as it is held."""
    scope = scope or global_scope()
    v = scope.find_var(name)
    if v is None:
        raise KeyError(f"variable {name!r} not found in scope")
    return fetch_numpy(v) if return_numpy else v


def _enforce_feed(name, value, var):
    """Feed validation at the boundary: a rank or fixed-dim mismatch
    fails with the variable's name (-1 dims take any size)."""
    if var is None or var.shape is None:
        return
    shape = tuple(value.shape) if hasattr(value, "shape") \
        else np.shape(value)
    want = tuple(var.shape)
    if len(shape) != len(want):
        raise ValueError(
            f"feed variable {name!r}: expected rank {len(want)} "
            f"(shape {want}), got rank {len(shape)} (shape {shape})")
    ragged = getattr(var, "lod_level", 0) or 0
    for i, (got_d, want_d) in enumerate(zip(shape, want)):
        if i == 0 and ragged:
            continue
        if want_d is not None and want_d >= 0 and got_d != want_d:
            raise ValueError(
                f"feed variable {name!r}: expected shape {want} "
                f"(-1 = any), got {shape}")
