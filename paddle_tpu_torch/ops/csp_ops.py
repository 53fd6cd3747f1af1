"""CSP ops: ``channel_create`` / ``send`` / ``recv`` / ``close``, ``go``
and ``select`` (the port of ``paddle_tpu.ops.csp_ops``; reference
``operators/channel_{create,send,recv,close}_op.cc``, ``go_op.cc``,
``select_op.cc`` over ``framework/channel.h``).

All are host ops, as in the JAX package: a block holding one runs
eagerly (the capture rule keeps it out of a CUDA graph), and the
executor gives it an env that reads and writes persistable variables
through the shared scope (``executor._SharedStateEnv``), so a ``go``
routine and the block see each other's persistable writes.

* ``go`` runs its sub-block on a daemon thread against a clone of the
  step's env (``clone_for_thread``), with an aux of its own: its own
  RNG stream (a seed of its own for its random ops), LoD map, fault
  records, ``host_reads`` and ``while_trips``; the device ops of its
  body run on the run's device.  An error in the body is kept in the
  step's ``aux["go_errors"]`` and closes the channels it sees (so that
  nothing waits on it forever); the executor raises it after the
  block.
* ``channel_send`` sends a clone of its tensor, on its device;
  ``select`` copies its send values to the host once, before it polls
  (the JAX package's hoist, ``paddle_tpu/ops/csp_ops.py:163``); a
  receive puts the value on the run's device.
* A ``select`` that finds no case ready within its ``timeout_s`` attr
  (default 60 s) raises.
"""

from __future__ import annotations

import collections
import threading
import time

import torch

from paddle_tpu_torch.channel import Channel
from paddle_tpu_torch.ops.registry import (register_op, ShapeInferenceSkip,
                                           slot_seed)

#: the op types whose block needs the shared-scope env
CSP_OPS = frozenset({"channel_create", "channel_send", "channel_recv",
                     "channel_close", "go", "select"})


def _infer_skip(op, block):
    raise ShapeInferenceSkip()


def _status(ok, device):
    return torch.tensor([bool(ok)], device=device)


def _received(value, ok, prev, device):
    """A received value on ``device``; a closed and drained channel
    gives zeros of the placeholder's shape where it has one."""
    if ok:
        return torch.as_tensor(value).to(device)
    if prev is not None:
        return torch.zeros_like(prev)
    return torch.zeros((1,), dtype=torch.float32, device=device)


@register_op("channel_create", infer_shape=_infer_skip, no_gradient=True,
             host=True)
def channel_create_lower(ctx):
    out = ctx.op.output("Out")[0]
    # idempotent across steps: reuse the channel living in the scope
    scope = ctx.aux.get("scope")
    existing = scope.find_var(out) if scope is not None else None
    if isinstance(existing, Channel):
        ctx.outputs[out] = existing
        return
    ctx.outputs[out] = Channel(capacity=ctx.attr("capacity", 0),
                               dtype=ctx.attr("data_type"))


@register_op("channel_send", infer_shape=_infer_skip, no_gradient=True,
             host=True)
def channel_send_lower(ctx):
    ch = ctx.env[ctx.op.input("Channel")[0]]
    ch.send(ctx.input("X").clone())
    ctx.set_output("Status", _status(True, ctx.device))


@register_op("channel_recv", infer_shape=_infer_skip, no_gradient=True,
             host=True)
def channel_recv_lower(ctx):
    ch = ctx.env[ctx.op.input("Channel")[0]]
    value, ok = ch.receive()
    out_name = ctx.op.output("Out")[0]
    ctx.outputs[out_name] = _received(value, ok, ctx.env.get(out_name),
                                      ctx.device)
    ctx.set_output("Status", _status(ok, ctx.device))


@register_op("channel_close", infer_shape=_infer_skip, no_gradient=True,
             host=True)
def channel_close_lower(ctx):
    ctx.env[ctx.op.input("Channel")[0]].close()


def clone_env(env):
    """A go routine's env: the step env's ``clone_for_thread`` (its
    persistables still read and written through the shared scope), under
    copies of the enclosing blocks' maps where ``env`` is a
    ``ChainMap``."""
    if isinstance(env, collections.ChainMap):
        return collections.ChainMap(*[dict(m) for m in env.maps[:-1]],
                                    clone_env(env.maps[-1]))
    if hasattr(env, "clone_for_thread"):
        return env.clone_for_thread()
    return dict(env)


def thread_aux(aux, op_index):
    """The aux of a go routine started by the op at RNG slot
    ``op_index``: the run's device, scope, constants and block runner,
    and its own seed, generators, RNG counter, LoD map, fault records
    and counters."""
    from paddle_tpu_torch.step_graph import GeneratorTable

    seed = slot_seed(aux.get("rng_seed") or 0, op_index) + 1
    keep = ("device", "amp", "scope", "lower_block", "constants", "traced")
    out = {k: aux[k] for k in keep if k in aux}
    out.update({"rng_seed": seed, "generators": GeneratorTable(seed),
                "generator": torch.Generator().manual_seed(seed),
                "rng_counter": -1, "capturing": False,
                "lod": dict(aux.get("lod", {})),
                "go_errors": aux.setdefault("go_errors", [])})
    return out


@register_op("go", infer_shape=_infer_skip, no_gradient=True, host=True)
def go_lower(ctx):
    """Start the sub-block as a goroutine (reference ``go_op.cc``:
    ``ExecuteOnThread`` on a detached thread)."""
    sub_block = ctx.attr("sub_block")
    env = clone_env(ctx.env)
    aux = thread_aux(ctx.aux, ctx.op_index)

    def body():
        try:
            with torch.no_grad():
                aux["lower_block"](sub_block, env, aux)
        except Exception as e:  # the routine's end: the step raises it
            aux["go_errors"].append(e)
            # a panic: the routine's channels close, so that no one
            # blocks on it forever
            for v in list(env.values()):
                if isinstance(v, Channel):
                    v.close()

    t = threading.Thread(target=body, daemon=True,
                         name=f"go-{ctx.op_index}")
    ctx.aux.setdefault("go_threads", []).append(t)
    t.start()


@register_op("select", infer_shape=_infer_skip, no_gradient=True, host=True)
def select_lower(ctx):
    """Block until one case can proceed, do its channel action, then run
    that case's block (reference ``select_op.cc``, cases serialized as
    ``"idx,action,channel,value"``; DEFAULT fires when no other case is
    ready at once)."""
    parsed, default_idx = [], None
    for c in ctx.attr("cases", []):
        parts = c.split(",")
        idx, action = int(parts[0]), int(parts[1])
        ch_name = parts[2] if len(parts) > 2 else ""
        val_name = parts[3] if len(parts) > 3 else ""
        if action == 0:  # DEFAULT
            default_idx = idx
        parsed.append((idx, action, ch_name, val_name))
    lower_block = ctx.aux["lower_block"]

    def fire(idx, recv_name=None, recv_value=None, recv_ok=None):
        if recv_name:
            ctx.env[recv_name] = _received(recv_value, recv_ok,
                                           ctx.env.get(recv_name),
                                           ctx.device)
            ctx.outputs[recv_name] = ctx.env[recv_name]
        blk = ctx.op.attrs.get(f"case_block_{idx}")
        if blk is not None:
            lower_block(blk, ctx.env, ctx.aux)
            # the case body's writes are the op's outputs
            for op in blk.ops:
                for n in op.output_arg_names:
                    if n in ctx.env:
                        ctx.outputs[n] = ctx.env[n]

    # the send values on the host once, out of the poll loop
    send_values = {val_name: ctx.env[val_name].detach().cpu()
                   for _, action, __, val_name in parsed if action == 1}
    deadline = time.monotonic() + float(ctx.attr("timeout_s", 60.0))
    while True:
        for idx, action, ch_name, val_name in parsed:
            if action == 1:  # SEND
                if ctx.env[ch_name].try_send(send_values[val_name]):
                    fire(idx)
                    return
            elif action == 2:  # RECEIVE
                value, ok, ready = ctx.env[ch_name].try_receive()
                if ready:
                    fire(idx, recv_name=val_name, recv_value=value,
                         recv_ok=ok)
                    return
        if default_idx is not None:
            fire(default_idx)
            return
        if time.monotonic() > deadline:
            raise RuntimeError("select: no case became ready (deadlock?)")
        time.sleep(0.0005)
