#!/usr/bin/env python3
"""Where the time of the port's serving path goes, on one NVIDIA GPU.

    python3 profile_torch_decode.py [--requests N] [--new-tokens N]

Builds the port's kernels, exports a seeded ``GenLongConfig`` bundle,
serves a warm-up pass, then serves the same requests (prompt lengths
straddling page boundaries, as in ``chip_smoke.py``) through
``GenScheduler`` twice: once timed on the host clock, once under
``torch.profiler`` (CPU and CUDA activities).  Prints

* tokens/s, decode steps and the mean host time of one decode step and
  one prefill;
* the device's busy time over the profiled window (the sum of CUDA
  kernel and memcpy durations; an upper bound on the busy share, as
  overlapping work is counted twice) and its share of the wall time;
* the CUDA kernels by total device time, with counts and mean time a
  launch, then the port's two hand-written kernels (paged decode: its
  split and merge kernels; bias softmax: every forward body) summed;

and, as its last two lines, the card's name and power limit and one
JSON object with the numbers.  The trace goes to
``runs/profile_torch_decode/trace.json``.  Needs CUDA; exits non-zero
without it.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "runs", "profile_torch_decode")
PROMPT_LENS = (15, 16, 17, 31, 33, 48, 64, 100, 150, 199)
SEED = 20260416


def serve(sched, prompts, new_tokens, pred):
    """Serve ``prompts``; returns (tokens, seconds, prefills, steps)."""
    pre0, dec0 = pred.prefills, pred.decode_steps
    t0 = time.perf_counter()
    streams = [sched.submit(p, max_new_tokens=new_tokens) for p in prompts]
    outs = [list(s) for s in streams]
    wall = time.perf_counter() - t0
    if sched.failed is not None or sched.crashes:
        raise RuntimeError(f"scheduler failed: {sched.failed!r}")
    return (sum(len(o) for o in outs), wall, pred.prefills - pre0,
            pred.decode_steps - dec0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=len(PROMPT_LENS))
    ap.add_argument("--new-tokens", type=int, default=32)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_decode: CUDA is not available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.gen import GenPredictor, GenScheduler
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.models import gen_lm
    from paddle_tpu_torch.models.gen_lm_long import GenLongConfig

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    os.makedirs(OUT_DIR, exist_ok=True)
    hp = GenLongConfig()
    bundle = gen_lm.export_gen_model(os.path.join(OUT_DIR, "bundle"), hp,
                                     num_slots=8, seed=SEED)
    pred = GenPredictor(bundle)
    rng = np.random.RandomState(SEED)
    lens = [PROMPT_LENS[i % len(PROMPT_LENS)] for i in range(args.requests)]
    prompts = [[int(t) for t in rng.randint(0, hp.vocab_size, n)]
               for n in lens]
    sched = GenScheduler(pred)
    serve(sched, prompts, args.new_tokens, pred)          # warm-up

    step_s, pre_s = [], []
    decode, prefill = pred.decode_step, pred.prefill

    def timed(fn, sink):
        def wrapper(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            if sink is pre_s:
                torch.cuda.synchronize()
            sink.append(time.perf_counter() - t)
            return out
        return wrapper

    pred.decode_step = timed(decode, step_s)
    pred.prefill = timed(prefill, pre_s)
    tokens, wall, prefills, steps = serve(sched, prompts, args.new_tokens,
                                          pred)
    pred.decode_step, pred.prefill = decode, prefill

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, pwall, _, psteps = serve(sched, prompts, args.new_tokens, pred)
        torch.cuda.synchronize()
    sched.close()
    prof.export_chrome_trace(os.path.join(OUT_DIR, "trace.json"))

    kernels = {}
    device_us = 0.0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dur = float(ev.time_range.end - ev.time_range.start)
            device_us += dur
            k = kernels.setdefault(ev.name, [0, 0.0])
            k[0] += 1
            k[1] += dur
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    print(f"card: {card}")
    print(f"served {len(prompts)} requests, {tokens} tokens in {wall:.3f}s "
          f"= {tokens / wall:.1f} tokens/s; {prefills} prefills (mean "
          f"{1e3 * np.mean(pre_s):.3f} ms), {steps} decode steps (mean "
          f"{1e3 * np.mean(step_s):.3f} ms, median "
          f"{1e3 * np.median(step_s):.3f} ms)")
    print(f"profiled window {pwall:.3f}s ({psteps} decode steps): device "
          f"busy {device_us / 1e3:.3f} ms = "
          f"{100 * device_us / 1e6 / pwall:.2f}% of the wall time")
    for name, (n, us) in top[:12]:
        print(f"  {us / 1e3:9.3f} ms  {n:6d} x {us / n:8.2f} us  {name[:90]}")
    # the hand-written kernels by wrapper: the paged decode (its split
    # and merge kernels) and the bias-softmax forward (every body)
    ours = {}
    for k, (n, us) in kernels.items():
        name = ("paged_decode" if "paged_decode_kernel" in k
                or "paged_merge_kernel" in k else "bias_softmax"
                if "bias_softmax_" in k and "grad" not in k else None)
        if name:
            o = ours.setdefault(name, [0, 0.0])
            o[0] += n
            o[1] += us
    for name, (n, us) in ours.items():
        print(f"  hand-written {name}: {us / 1e3:.3f} ms, {n} kernels, "
              f"{us / n:.2f} us each")
    summary = {
        "card": card, "tokens_per_s": tokens / wall,
        "decode_step_ms": 1e3 * float(np.mean(step_s)),
        "prefill_ms": 1e3 * float(np.mean(pre_s)),
        "decode_steps": steps, "prefills": prefills,
        "profiled_wall_s": pwall, "device_busy_ms": device_us / 1e3,
        "device_busy_share": device_us / 1e6 / pwall,
        "kernel_launches": sum(n for n, _ in kernels.values()),
        "hand_written": {k: {"kernels": n, "device_ms": us / 1e3,
                             "us_per_kernel": us / n}
                         for k, (n, us) in ours.items()},
    }
    if device_us == 0:
        raise RuntimeError("the profiler recorded no device time")
    print(card)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
