"""Executor: runs a Program block op by op on torch tensors (the port's
counterpart of ``paddle_tpu.executor``; reference
``paddle/fluid/framework/executor.cc:334``).

Where the JAX package traces a whole block into one compiled XLA
computation, the port runs eagerly: feeds go to the place's device,
persistable state is read from the scope, every op's lowering runs in
program order, and the persistable variables the block wrote are stored
back in the scope.  Ops that update state in place (``paged_attention``
on the KV pool) change the scope's own tensor.
"""

from __future__ import annotations

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
    for op in block.ops:
        if op.type in _SKIP_OPS:
            continue
        opdef = registry.resolve_lowering(op.type)
        ctx = registry.LowerContext(op, env, block, aux=aux)
        opdef.lower(ctx)
        env.update(ctx.outputs)
    return env


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

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        """Run ``program``'s global block once.  ``feed``: name -> array
        or tensor; ``fetch_list``: Variables or names.  Returns the
        fetched values as numpy arrays (``return_numpy``) or tensors on
        the place's device."""
        program = program if program is not None else default_main_program()
        if not isinstance(program, Program):
            raise TypeError("executor requires a Program")
        scope = scope if scope is not None else global_scope()
        fetch_names = [f.name if isinstance(f, framework.Variable) else f
                       for f in (fetch_list or [])]
        block = program.global_block()

        env = _StateEnv(scope, self.device)
        for name, value in (feed or {}).items():
            var = block.vars.get(name)
            _enforce_feed(name, value, var)
            env[name] = to_tensor(value, self.device,
                                  getattr(var, "dtype", None))
        # random init ops draw from one generator per run, seeded from
        # the program's seed: the same program initializes the same
        # values on every device
        gen = torch.Generator().manual_seed(int(program.random_seed))
        aux = {"device": self.device, "generator": gen, "scope": scope}
        with torch.no_grad():
            lower_block(block, env, aux)

        # persistable variables the block wrote go back to the scope
        for op in block.ops:
            for n in op.output_arg_names:
                var = block.vars.get(n)
                if var is not None and var.persistable and n in env:
                    scope.set_var(n, env[n])
        fetches = [env[n] for n in fetch_names]
        if return_numpy:
            return [to_numpy(v) for v in fetches]
        return fetches


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
