#!/usr/bin/env python3
"""Where the time of the port's Transformer-base training step goes, on
one NVIDIA GPU.

    python3 profile_torch_train.py [--routes A B] [--steps N]

Builds the port's kernels and, for each route of ``chip_smoke.py``'s
training phase (A: composed attention, S = 256, B = 64; B: flash
attention, S = 2048, B = 8; Transformer-base at full width and depth,
bf16 AMP, Adam lr 1e-4, dropout 0.1), runs two warm-up steps and then

* ``--steps`` steps timed on the host clock (each ends in the loss's
  device-to-host copy): ms a step and target tokens/s;
* one step with a CUDA synchronize around every op, timed on the host
  clock, grouped by op type and by phase (forward, backward, optimizer).
  Synchronizing serializes host and device, so these times add up to
  more than a free-running step; they rank the ops, they are not the
  step time.  For every grad op lowered by auto-vjp (``torch.func.vjp``
  of the forward lowering) the forward op it differentiates is run once
  more alone, timed the same way: that is the cost of auto-vjp's eager
  recompute;
* one step under ``torch.profiler`` (CPU and CUDA activities): the
  device's busy time (the sum of CUDA kernel and memcpy durations; an
  upper bound on the busy share, as overlapping work is counted twice),
  its share of the wall time, and the CUDA kernels by total device time.

Prints the card's name and power limit and, as its last line, one JSON
object with the numbers (also written to
``runs/profile_torch_train/summary.json``).  Needs CUDA; exits non-zero
without it.
"""

import argparse
import collections
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "runs", "profile_torch_train")
SEED = 20260416
ROUTES = {"A": (64, 256), "B": (8, 2048)}


def build(pt, T, B, S):
    hp = T.ModelHyperParams()
    hp.max_length = max(hp.max_length, S)
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = SEED
    with pt.program_guard(main, startup):
        cost, _ = T.transformer(B, S, S, hp)
        pt.optimizer.Adam(learning_rate=1e-4).minimize(cost)
    main.amp = True
    return main, startup, cost, T.fake_batch(B, S, S, hp, seed=SEED)


def per_op_step(pt, registry, torch, exe, main, scope, feed, cost):
    """One step with a synchronize around every op; returns the op times
    by (phase, type), the auto-vjp recompute times by forward type, and
    the step's wall seconds."""
    block = main.global_block()
    ops = block.ops
    seed_at = next(i for i, op in enumerate(ops) if op.type == "fill_constant"
                   and op.output("Out")[0] == cost.name + "@GRAD")
    producer = {}
    for i, op in enumerate(ops[:seed_at]):
        for n in op.output_arg_names:
            producer[n] = i
    times = collections.defaultdict(float)
    counts = collections.Counter()
    seen = {}
    depth = [0]                  # auto-vjp re-enters forward lowerings
    saved, wrapped = {}, set()
    for op in ops:
        opdef = registry.resolve_lowering(op.type)
        if id(opdef) in wrapped:
            continue
        wrapped.add(id(opdef))
        saved[id(opdef)] = (opdef, opdef.lower)

        def timed(ctx, _lower=opdef.lower):
            if depth[0]:
                return _lower(ctx)
            torch.cuda.synchronize()
            t = time.perf_counter()
            depth[0] += 1
            try:
                _lower(ctx)
            finally:
                depth[0] -= 1
            torch.cuda.synchronize()
            i = ctx.op_index
            phase = ("forward" if i < seed_at else
                     "optimizer" if ctx.op.type == "adam" else "backward")
            times[(phase, ctx.op.type)] += time.perf_counter() - t
            counts[(phase, ctx.op.type)] += 1
            seen["env"], seen["aux"] = ctx.env, ctx.aux
        opdef.lower = timed
    try:
        t0 = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
        wall = time.perf_counter() - t0
    finally:
        for opdef, lower in saved.values():
            opdef.lower = lower

    # auto-vjp grad ops: time the forward each of them re-runs
    recompute = collections.defaultdict(float)
    env, aux = seen["env"], seen["aux"]
    for op in ops[seed_at:]:
        if not op.type.endswith("_grad"):
            continue
        fwd_def = registry.lookup(op.type[:-len("_grad")])
        if fwd_def is None or fwd_def.grad_lower is not None and \
                op.type != "lookup_table_grad":
            continue                      # an explicit grad lowering
        outs = [n for s, ns in op.inputs.items() if s + "@GRAD" in op.inputs
                for n in ns if n in producer]
        i = producer[outs[0]]
        ctx = registry.LowerContext(ops[i], dict(env), block, aux=aux,
                                    op_index=i)
        with torch.no_grad():
            torch.cuda.synchronize()
            t = time.perf_counter()
            fwd_def.lower(ctx)
            torch.cuda.synchronize()
        recompute[ops[i].type] += time.perf_counter() - t
    return times, counts, recompute, wall


def profile_route(route, steps, pt, registry, torch):
    from torch.profiler import ProfilerActivity, profile
    import numpy as np
    from paddle_tpu_torch.models import transformer as T
    B, S = ROUTES[route]
    main, startup, cost, feed = build(pt, T, B, S)
    scope = pt.Scope()
    exe = pt.Executor()
    exe.run(startup, scope=scope)
    for _ in range(2):
        exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
    step_s = []
    for _ in range(steps):
        t = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
        step_s.append(time.perf_counter() - t)
    times, counts, recompute, sync_wall = per_op_step(
        pt, registry, torch, exe, main, scope, feed, cost)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t
    prof.export_chrome_trace(os.path.join(OUT_DIR, f"trace_{route}.json"))
    kernels = {}
    device_us = 0.0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dur = float(ev.time_range.end - ev.time_range.start)
            device_us += dur
            k = kernels.setdefault(ev.name, [0, 0.0])
            k[0] += 1
            k[1] += dur
    if device_us == 0:
        raise RuntimeError("the profiler recorded no device time")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])

    step = float(np.mean(step_s))
    phases = collections.defaultdict(float)
    for (phase, _), s in times.items():
        phases[phase] += s
    print(f"route {route}: B={B} S={S}: {1e3 * step:.2f} ms a step "
          f"(mean of {steps}) = {B * S / step:.1f} tokens/s")
    print(f"  synchronized per-op step {1e3 * sync_wall:.2f} ms: "
          + ", ".join(f"{p} {1e3 * s:.2f} ms" for p, s in phases.items()))
    for (phase, typ), s in sorted(times.items(), key=lambda kv: -kv[1])[:16]:
        print(f"    {1e3 * s:9.3f} ms  {counts[(phase, typ)]:4d} x  "
              f"{phase:9s} {typ}")
    total_re = sum(recompute.values())
    print(f"  auto-vjp recompute of the forward: {1e3 * total_re:.2f} ms "
          f"a step: " + ", ".join(f"{t} {1e3 * s:.2f}" for t, s in
                                  sorted(recompute.items(),
                                         key=lambda kv: -kv[1])))
    print(f"  profiled step {1e3 * pwall:.2f} ms: device busy "
          f"{device_us / 1e3:.2f} ms = {100 * device_us / 1e6 / pwall:.2f}% "
          f"of the wall time, {sum(n for n, _ in kernels.values())} "
          f"device activities")
    for name, (n, us) in top[:12]:
        print(f"    {us / 1e3:9.3f} ms  {n:6d} x {us / n:9.2f} us  "
              f"{name[:80]}")
    del scope, exe
    torch.cuda.empty_cache()
    return {
        "B": B, "S": S, "step_ms": 1e3 * step, "tokens_per_s": B * S / step,
        "sync_step_ms": 1e3 * sync_wall,
        "sync_phase_ms": {p: 1e3 * s for p, s in phases.items()},
        "sync_op_ms": {f"{p}:{t}": 1e3 * s for (p, t), s in times.items()},
        "op_counts": {f"{p}:{t}": n for (p, t), n in counts.items()},
        "recompute_ms": {t: 1e3 * s for t, s in recompute.items()},
        "recompute_total_ms": 1e3 * total_re,
        "profiled_wall_ms": 1e3 * pwall, "device_busy_ms": device_us / 1e3,
        "device_busy_share": device_us / 1e6 / pwall,
        "top_kernels": [{"name": k, "count": n, "device_ms": us / 1e3}
                        for k, (n, us) in top[:12]],
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--routes", nargs="+", default=["A", "B"],
                    choices=sorted(ROUTES))
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_torch_train: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.ops import registry

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.pop("PADDLE_TPU_FLASH_MIN_S", None)
    build.build_all()
    os.makedirs(OUT_DIR, exist_ok=True)
    print(f"card: {card}")
    summary = {"card": card}
    for route in args.routes:
        summary[route] = profile_route(route, args.steps, pt, registry,
                                       torch)
    with open(os.path.join(OUT_DIR, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(card)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
