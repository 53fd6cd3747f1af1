"""Executor: runs a Program block op by op on torch tensors (the port's
counterpart of ``paddle_tpu.executor``; reference
``paddle/fluid/framework/executor.cc:334``).

Where the JAX package traces a whole block into one compiled XLA
computation, the port runs eagerly: feeds go to the place's device,
persistable state is read from the scope, every op's lowering runs in
program order (forward, grad and optimizer ops alike), and the
persistable variables the block wrote are stored back in the scope.  Ops
that update state in place (``paged_attention`` on the KV pool) change
the scope's own tensor.

Mixed precision: when ``Program.amp`` is set (or, if it is None, the
``PADDLE_TPU_AMP`` environment flag), float32 tensors read through an
op's ``amp_cast`` slots are cast to bfloat16 and those read through its
``amp_upcast`` slots to float32; parameters stay float32 in the scope.

Randomness: random init ops draw from one host generator per run, seeded
from the program's ``random_seed``, so the same program initializes the
same values on every device.  Random ops of a step (``dropout``) draw
from generators on the run's device, seeded from the program's seed, the
executor's run counter and the op's position.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from paddle_tpu_torch import framework
from paddle_tpu_torch.convert import to_numpy, to_tensor
from paddle_tpu_torch.framework import Program, default_main_program
from paddle_tpu_torch.ops import registry
from paddle_tpu_torch.place import default_place
from paddle_tpu_torch.scope import global_scope

__all__ = ["Executor", "lower_block"]

# feed/fetch ops are rewritten by the executor (feeds arrive in the env)
_SKIP_OPS = frozenset({"feed", "fetch"})


def lower_block(block, env, aux):
    """Run every op of ``block`` in order against ``env`` (name ->
    tensor), merging each op's outputs into it."""
    for i, op in enumerate(block.ops):
        if op.type in _SKIP_OPS:
            continue
        opdef = registry.resolve_lowering(op.type)
        ctx = registry.LowerContext(op, env, block, aux=aux, op_index=i)
        opdef.lower(ctx)
        env.update(ctx.outputs)
    return env


def _env_flag(name, default="0"):
    """Environment flag truthiness, as the JAX package parses it."""
    return os.environ.get(name, default).strip().lower() \
        not in ("0", "", "false", "off", "no")


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

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        """Run ``program``'s global block once.  ``feed``: name -> array
        or tensor; ``fetch_list``: Variables or names.  Returns the
        fetched values as numpy arrays (``return_numpy``) or tensors on
        the place's device."""
        program, scope, fetch_names = self._prepare(program, scope,
                                                    fetch_list)
        block = program.global_block()
        feeds = {}
        for name, value in (feed or {}).items():
            var = block.vars.get(name)
            _enforce_feed(name, value, var)
            feeds[name] = to_tensor(value, self.device,
                                    getattr(var, "dtype", None))
        fetches = self._step(program, scope, feeds, fetch_names)
        if return_numpy:
            return [to_numpy(v) for v in fetches]
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
                                                    fetch_list)
        block = program.global_block()
        steps = int(steps)
        const_feed, per_step = {}, {}
        for name, value in (feed or {}).items():
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
            return [to_numpy(v) for v in stacked]
        return stacked

    # ------------------------------------------------------------------
    def _prepare(self, program, scope, fetch_list):
        program = program if program is not None else default_main_program()
        if not isinstance(program, Program):
            raise TypeError("executor requires a Program")
        scope = scope if scope is not None else global_scope()
        fetch_names = [f.name if isinstance(f, framework.Variable) else f
                       for f in (fetch_list or [])]
        return program, scope, fetch_names

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
               "amp": _amp_enabled(program),
               "scope": scope}
        with torch.no_grad():
            lower_block(block, env, aux)

        # persistable variables the block wrote go back to the scope
        for op in block.ops:
            for n in op.output_arg_names:
                var = block.vars.get(n)
                if var is not None and var.persistable and n in env:
                    scope.set_var(n, env[n])
        return [env[n] for n in fetch_names]


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
