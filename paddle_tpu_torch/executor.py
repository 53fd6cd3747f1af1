"""Executor: runs a Program block op by op on torch tensors (the port's
counterpart of ``paddle_tpu.executor``; reference
``paddle/fluid/framework/executor.cc:334``).

Where the JAX package traces a whole block into one compiled XLA
computation, the port runs eagerly: feeds go to the place's device,
persistable state is read from the scope, every op's lowering runs in
program order (forward, grad and optimizer ops alike), and the
persistable variables the block wrote are stored back in the scope.  Ops
that update state in place (``paged_attention`` on the KV pool, the
sparse branches of ``sgd``, ``adam`` and ``adagrad`` on a table and its
moments) change the scope's own tensor.

Mixed precision: when ``Program.amp`` is set (or, if it is None, the
``PADDLE_TPU_AMP`` environment flag), float32 tensors read through an
op's ``amp_cast`` slots are cast to bfloat16 and those read through its
``amp_upcast`` slots to float32; parameters stay float32 in the scope.

Ragged feeds: ``run`` takes a ``(value, lod)`` pair for a LoD variable
and keeps the LoD in the scope (``Scope.set_lod``); a dense feed clears
a stale one.  Each run seeds ``aux["lod"]`` with the feeds' LoDs, and
after every op an output whose leading dim equals the first LoD-carrying
input's row count inherits that LoD unless the op set one
(:func:`_share_lod`).  The JAX package's bucketed mode
(``program.lod_buckets`` / ``PADDLE_TPU_LOD_BUCKETS``, per-step LoD
windows in ``run_steps``) is not ported and raises.

Control flow: ``aux["lower_block"]`` is :func:`lower_block`, which the
lowerings of ``while``, ``conditional_block`` and ``recurrent`` run
their sub-blocks through, over the run's own ``aux`` (its LoD map and
index tables).  After each run ``Executor.last_run`` holds the run's
``while`` trips and host reads (``aux["while_trips"]``,
``aux["host_reads"]``: the loop conditions and array indices read on
the host, each a device sync on the card).

Randomness: random init ops draw from one host generator per run, seeded
from the program's ``random_seed``, so the same program initializes the
same values on every device.  Random ops of a step (``dropout``) draw
from generators on the run's device, seeded from the program's seed, the
executor's run counter and the op's slot on the run's RNG counter
(``aux["rng_counter"]``).  The counter advances by
``op.attrs.get("__rng_slots__", 1)`` for every op but feed and fetch, in
sub-blocks too, and an op's slot is the counter after it advanced; the
counter starts at -1, so an op of an unoptimized block without feed or
fetch ops has its position as its slot.  An optimization pass that
removes or fuses ops charges their slots to the next surviving op, so
every random op keeps the slot, and so the mask, it has in the
unoptimized program.

Environment switches, as in the JAX package: ``PADDLE_TPU_VERIFY=1``
runs the structural verifier before a program's first run
(:meth:`Executor._maybe_verify`), ``PADDLE_TPU_OPT=1`` runs the
verify-sandwiched pass pipeline of :mod:`paddle_tpu_torch.analysis.opt`
on a clone (:meth:`Executor._maybe_optimize`), and
``PADDLE_TPU_CHECK_NAN_INF=1`` (or ``Program.check_nan_inf``) raises
naming the first fetch or state variable that is not finite.

Fetches come back as numpy arrays; a bfloat16 value is widened to
float32 (:func:`~paddle_tpu_torch.convert.fetch_numpy`), where the JAX
package returns an ml_dtypes bfloat16 array.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from paddle_tpu_torch import framework
from paddle_tpu_torch.convert import fetch_numpy, to_tensor
from paddle_tpu_torch.framework import Program, default_main_program
from paddle_tpu_torch.lod import validate_lod
from paddle_tpu_torch.ops import registry
from paddle_tpu_torch.place import default_place
from paddle_tpu_torch.scope import global_scope

__all__ = ["Executor", "lower_block", "fetch_var"]

logger = logging.getLogger(__name__)

# feed/fetch ops are rewritten by the executor (feeds arrive in the env)
_SKIP_OPS = frozenset({"feed", "fetch"})


def lower_block(block, env, aux):
    """Run every op of ``block`` in order against ``env`` (name ->
    tensor), merging each op's outputs into it.  Each op takes the next
    ``__rng_slots__`` (default 1) slots of ``aux["rng_counter"]``; the
    last of them keys its random draws."""
    for op in block.ops:
        if op.type in _SKIP_OPS:
            continue
        opdef = registry.resolve_lowering(op.type)
        aux["rng_counter"] = aux.get("rng_counter", -1) + \
            op.attrs.get("__rng_slots__", 1)
        ctx = registry.LowerContext(op, env, block, aux=aux,
                                    op_index=aux["rng_counter"])
        opdef.lower(ctx)
        env.update(ctx.outputs)
        _share_lod(op, ctx.outputs, env, aux)
    return env


def _share_lod(op, outputs, env, aux):
    """Default LoD propagation (reference: kernels call ``ShareLoD(X,
    Out)`` unless they change the row structure): an output whose leading
    dim equals the first LoD-carrying input's row count inherits that
    input's LoD, unless the lowering set one.  By row count alone, as the
    JAX package decides it: a dense output with N rows is labelled too."""
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


#: ROADMAP's item for the bucketed LoD mode
_BUCKETS_ITEM = ("the bucketed LoD mode (DynLoD, bucket_ragged_feed, "
                 "run_steps LoD windows) is not ported yet: ROADMAP queue 1 "
                 "item 5, 'Bucketed LoD'")


def _lod_buckets_enabled(program):
    """The JAX package's switch for its bucketed LoD mode: the program's
    ``lod_buckets``, else ``PADDLE_TPU_LOD_BUCKETS``."""
    if getattr(program, "lod_buckets", None) is not None:
        return bool(program.lod_buckets)
    return _env_flag("PADDLE_TPU_LOD_BUCKETS")


def _is_lod_pair(value):
    return isinstance(value, tuple) and len(value) == 2 and \
        isinstance(value[1], (list, tuple))


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
    host array there to the device, once) — the persistable state."""

    def __init__(self, scope, device):
        super().__init__()
        self.scope = scope
        self.device = device

    def __missing__(self, name):
        v = self.scope.find_var(name)
        if v is None:
            raise RuntimeError(
                f"variable {name!r} is not initialized in the scope — "
                f"run the startup program first")
        if not isinstance(v, torch.Tensor) or v.device != self.device:
            v = to_tensor(v, self.device)
            self.scope.set_var(name, v)
        self[name] = v
        return v


class Executor:
    """Reference ``python/paddle/fluid/executor.py:181``.  ``place``
    defaults to ``CUDAPlace(0)``; constructing an Executor there raises
    when CUDA is absent (pass ``CPUPlace()`` to run on the CPU)."""

    def __init__(self, place=None):
        self.place = place if place is not None else default_place()
        self.device = self.place.torch_device()
        self._run_counter = 0
        #: ``{"while_trips": n, "host_reads": n}`` of the last run
        self.last_run = {}
        # PADDLE_TPU_VERIFY: (id, version) of the programs verified
        self._verified = set()
        # PADDLE_TPU_OPT: (id, version, feeds, fetches) -> optimized clone
        self._opt_cache = {}

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        """Run ``program``'s global block once.  ``feed``: name -> array
        or tensor, or ``(value, lod)`` for a ragged variable (``lod``: a
        list of levels of row splits, the last ending at the value's row
        count); ``fetch_list``: Variables or names.  Returns the fetched
        values as numpy arrays (``return_numpy``) or tensors on the
        place's device."""
        program, scope, fetch_names = self._prepare(program, scope,
                                                    fetch_list, feed)
        block = program.global_block()
        feeds = {}
        for name, value in (feed or {}).items():
            var = block.vars.get(name)
            lod = None
            if _is_lod_pair(value):
                value, lod = value
            _enforce_feed(name, value, var)
            if lod is not None:
                if len(lod) == 1 and _lod_buckets_enabled(program):
                    raise NotImplementedError(
                        f"feed {name!r}: {_BUCKETS_ITEM}")
                rows = value.shape[0] if hasattr(value, "shape") \
                    else np.shape(value)[0]
                lod = validate_lod(name, lod, rows)
            feeds[name] = to_tensor(value, self.device,
                                    getattr(var, "dtype", None))
            # a dense feed clears a stale LoD of an earlier ragged one
            scope.set_lod(name, lod)
        fetches = self._step(program, scope, feeds, fetch_names)
        if return_numpy:
            return [fetch_numpy(v) for v in fetches]
        return fetches

    def run_steps(self, program=None, feed=None, fetch_list=None, steps=1,
                  scope=None, return_numpy=True):
        """Run ``steps`` iterations of ``program`` (reference
        ``paddle_tpu.executor.Executor.run_steps``; here an eager loop on
        the device).  A ``feed`` value is either one batch, reused every
        step, or stacked ``[steps, ...]`` batches (exactly one extra
        leading dim of length ``steps``), sliced per step.  Fetches come
        back stacked ``[steps, ...]``."""
        program, scope, fetch_names = self._prepare(program, scope,
                                                    fetch_list, feed)
        block = program.global_block()
        steps = int(steps)
        const_feed, per_step = {}, {}
        for name, value in (feed or {}).items():
            if _is_lod_pair(value) or (isinstance(value, list) and value and
                                       all(map(_is_lod_pair, value))):
                raise NotImplementedError(
                    f"run_steps feed {name!r} is ragged: {_BUCKETS_ITEM}; "
                    f"run it step by step with Executor.run")
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
        outs = []
        for i in range(steps):
            feeds = dict(const_feed)
            feeds.update({n: t[i] for n, t in per_step.items()})
            outs.append(self._step(program, scope, feeds, fetch_names))
        stacked = [torch.stack([o[j] for o in outs])
                   for j in range(len(fetch_names))]
        if return_numpy:
            return [fetch_numpy(v) for v in stacked]
        return stacked

    def warmup(self, program=None, feed_shapes=None, fetch_list=None,
               scope=None, allow_state_updates=False):
        """Run ``program`` once per declared feed signature on zero feeds
        before real traffic arrives, so the first real request pays no
        kernel build (the counterpart of the JAX package's AOT warmup).

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
        from paddle_tpu_torch import profiler as _profiler
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

    # ------------------------------------------------------------------
    def _prepare(self, program, scope, fetch_list, feed=None):
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

    @staticmethod
    def fetch_missing_check(fetch_names, env):
        """Raise naming the first fetch target ``env`` does not hold."""
        for n in fetch_names:
            if n not in env:
                raise KeyError(f"fetch target {n!r} was not produced by the "
                               f"program and is not in the scope")
        return fetch_names

    def close(self):
        """Drop the memoized optimized programs and verifications."""
        self._opt_cache.clear()
        self._verified.clear()

    def _step(self, program, scope, feeds, fetch_names):
        """One run of the global block on ``feeds`` (tensors on the
        device); writes the persistable outputs back to ``scope`` and
        returns the fetched tensors."""
        block = program.global_block()
        env = _StateEnv(scope, self.device)
        env.update(feeds)
        self._run_counter += 1
        seed = int(program.random_seed or 0)
        aux = {"device": self.device,
               # random init ops: one host generator per run
               "generator": torch.Generator().manual_seed(seed),
               # per-op device generators of the step's random ops
               "rng_seed": seed * 1000003 + self._run_counter,
               "rng_counter": -1,
               "amp": _amp_enabled(program),
               "scope": scope,
               "lower_block": lower_block,
               # the feeds' LoDs; ops add theirs (set_output_lod) and
               # _share_lod passes them on
               "lod": {n: [list(level) for level in lod]
                       for n in feeds
                       for lod in (scope.find_lod(n),) if lod is not None}}
        with torch.no_grad():
            lower_block(block, env, aux)
        self.last_run = {k: aux.get(k, 0)
                         for k in ("while_trips", "host_reads")}

        # persistable variables the block wrote go back to the scope
        new_state = {}
        for op in block.ops:
            for n in op.output_arg_names:
                var = block.vars.get(n)
                if var is not None and var.persistable and n in env:
                    new_state[n] = env[n]
        # a fetch the block did not write is read from the scope
        fetches = [env[n] for n in self.fetch_missing_check(
            fetch_names, {n for n in fetch_names
                          if n in env or scope.find_var(n) is not None})]
        if _check_nan_inf_enabled(program):
            # before the write-back: a failing step leaves the scope as
            # it was (in-place updates of a pool or a table excepted)
            _check_nan_inf(fetch_names, fetches, new_state)
        for n, v in new_state.items():
            scope.set_var(n, v)
        return fetches


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
