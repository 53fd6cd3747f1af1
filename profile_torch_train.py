#!/usr/bin/env python3
"""Where the time of the port's training steps goes, on one NVIDIA GPU.

    python3 profile_torch_train.py [--model transformer] [--routes A B C]
                                   [--steps N]
    python3 profile_torch_train.py --model resnet [--batch 256] [--steps N]
    python3 profile_torch_train.py --model wide_deep [--steps N]
    python3 profile_torch_train.py --model stacked_lstm [--steps N]
    python3 profile_torch_train.py --model seq2seq [--steps N]

Builds the port's kernels and then, for the Transformer-base step, each
route of ``chip_smoke.py``'s training phase (A: composed attention,
S = 256, B = 64; B: flash attention, S = 2048, B = 8; C: single-pass
attention, S = 512, B = 32; full width and depth, bf16 AMP, Adam lr 1e-4,
dropout 0.1) or, with ``--model resnet``, the ResNet-50 step of
``bench_resnet.py`` (224x224, 1000 classes, B = 256, bf16 AMP,
Momentum(0.01, 0.9)) or, with ``--model wide_deep``, the Wide & Deep
step of ``chip_smoke.py`` (W&D-Criteo: 26 sparse slots into one table
of 2**23 rows with sparse grads, embeddings of 32, ReLU layers of 1024,
B = 4096, float32, Adam lr 1e-3) or, with ``--model stacked_lstm``, the
stacked dynamic LSTM of ``chip_smoke.py`` (LSTM-IMDB-H512: dictionary
30000, embeddings and 2 peephole LSTM layers of 512, 64 sequences of
2 … 100 words fed as ``(words, lod)``, float32, Adam lr 1e-3) or, with
``--model seq2seq``, the attention seq2seq of ``chip_smoke.py``
(Seq2Seq-NMT-512, ``bench_seq2seq.py``'s widths: dictionaries of 30000,
embeddings, bi-LSTM encoder and decoder of 512, 16 sentence pairs of
2 … 50 tokens, float32, Adam lr 1e-3; the decoder is one ``while`` op
and its grad one ``while_grad``, each timed whole, and the run's
``while`` trips and device reads of a loop condition or index are
printed); runs two warm-up steps and then

* ``--steps`` steps timed on the host clock (each ends in the loss's
  device-to-host copy): ms a step and target tokens/s (images/s for
  ResNet-50, with its MFU: 3 x the conv and fc FLOPs of one forward from
  the IR, over the 989 TFLOP/s bf16 dense peak, ``bench_resnet.py``'s
  convention; examples/s for Wide & Deep, sequences/s for the LSTM);
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
  its share of the wall time, and the CUDA kernels by total device time
  (the first 12, then every hand-written kernel wherever it ranks).

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
ROUTES = {"A": (64, 256), "B": (8, 2048), "C": (32, 512)}
#: name parts of the port's hand-written CUDA kernels
HAND_WRITTEN = ("bias_softmax_", "flash_", "smalls_", "bshd_", "conv3x3_",
                "paged_")
PEAK_BF16 = 989e12
#: the update ops of the optimizers profiled here
OPTIMIZER_OPS = ("adam", "momentum")


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


def build_resnet(pt, B):
    import numpy as np
    from paddle_tpu_torch.models import resnet
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = SEED
    with pt.program_guard(main, startup):
        cost, _, feeds = resnet.resnet_train_program(B, class_dim=1000,
                                                     depth=50)
        pt.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(
            cost)
    main.amp = True
    rng = np.random.RandomState(SEED % (2 ** 31))
    feed = {"image": rng.rand(B, 3, 224, 224).astype("float32"),
            "label": rng.randint(0, 1000, (B, 1)).astype("int64")}
    return main, startup, cost, feed


def build_wide_deep(pt):
    from paddle_tpu_torch.models import wide_and_deep as W
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = SEED
    with pt.program_guard(main, startup):
        cost, _, _ = W.wide_and_deep_train_program(W.CRITEO_BATCH,
                                                   **W.CRITEO)
        pt.optimizer.Adam(learning_rate=1e-3).minimize(cost)
    return main, startup, cost, W.fake_batch(W.CRITEO_BATCH, SEED)


def build_stacked_lstm(pt):
    from paddle_tpu_torch.models import stacked_lstm as TS
    cfg = TS.BENCHMARK_LSTM
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = SEED
    with pt.program_guard(main, startup):
        cost, _, _ = TS.stacked_lstm_net(
            cfg["dict_size"], cfg["emb_dim"], cfg["hidden_dim"],
            cfg["n_layers"], cfg["class_num"])
        pt.optimizer.Adam(learning_rate=cfg["lr"]).minimize(cost)
    return main, startup, cost, TS.fake_batch(cfg["batch"], cfg["max_len"],
                                              cfg["dict_size"], seed=SEED)


def build_seq2seq(pt):
    from paddle_tpu_torch.models import seq2seq as S
    cfg = S.SEQ2SEQ_NMT_512
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = SEED
    with pt.program_guard(main, startup):
        cost, _ = S.seq_to_seq_net(
            cfg["src_dict_size"], cfg["trg_dict_size"], cfg["emb_dim"],
            cfg["encoder_size"], cfg["decoder_size"])
        pt.optimizer.Adam(learning_rate=cfg["lr"]).minimize(cost)
    return main, startup, cost, S.fake_batch(
        cfg["batch"], cfg["src_max"], cfg["trg_max"], cfg["src_dict_size"],
        cfg["trg_dict_size"], seed=SEED)


def per_op_step(pt, registry, torch, exe, main, scope, feed, cost):
    """One step with a synchronize around every op; returns the op times
    by (phase, type), the auto-vjp recompute times by forward type, and
    the step's wall seconds."""
    block = main.global_block()
    ops = block.ops
    seed_at = next(i for i, op in enumerate(ops) if op.type == "fill_constant"
                   and op.output("Out")[0] == cost.name + "@GRAD")
    producers = collections.defaultdict(list)
    for i, op in enumerate(ops[:seed_at]):
        for n in op.output_arg_names:
            producers[n].append(i)
    # the phase of an op is read from its position in the block (its
    # ``op_index`` is its slot on the run's RNG counter)
    position = {id(op): i for i, op in enumerate(ops)}
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
            i = position[id(ctx.op)]
            phase = ("forward" if i < seed_at else
                     "optimizer" if ctx.op.type in OPTIMIZER_OPS
                     else "backward")
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
        if fwd_def is None or fwd_def.grad_lower is not None and (
                op.type != "lookup_table_grad" or op.attr("is_sparse")):
            continue                      # an explicit grad lowering
        fwd_type = op.type[:-len("_grad")]
        outs = [n for s, ns in op.inputs.items() if s + "@GRAD" in op.inputs
                for n in ns if n in producers]
        # the last op of the forward's type that wrote it (a while also
        # lists the arrays its body writes)
        i = max(j for j in producers[outs[0]] if ops[j].type == fwd_type)
        # a while re-runs from its pre-loop values (the grad's snapshot)
        snap = aux.get("env_snapshots", {}).get(
            id(op.attrs.get("sub_block")))
        ctx = registry.LowerContext(
            ops[i], collections.ChainMap(dict(snap or {}), dict(env)), block,
            aux=aux, op_index=i)
        with torch.no_grad():
            torch.cuda.synchronize()
            t = time.perf_counter()
            fwd_def.lower(ctx)
            torch.cuda.synchronize()
        recompute[ops[i].type] += time.perf_counter() - t
    return times, counts, recompute, wall


def profile_route(route, steps, pt, registry, torch):
    from paddle_tpu_torch.models import transformer as T
    B, S = ROUTES[route]
    main, startup, cost, feed = build(pt, T, B, S)
    out = profile_step(f"route {route}: B={B} S={S}", main, startup, cost,
                       feed, steps, B * S, "tokens", pt, registry, torch)
    out.update(B=B, S=S)
    return out


def profile_resnet(B, steps, pt, registry, torch):
    from paddle_tpu_torch.analysis.flops import program_matmul_flops
    main, startup, cost, feed = build_resnet(pt, B)
    fwd_flops = program_matmul_flops(main.global_block())
    out = profile_step(f"resnet50: B={B} 224x224", main, startup, cost,
                       feed, steps, B, "images", pt, registry, torch)
    mfu = 3 * fwd_flops / (out["step_ms"] / 1e3) / PEAK_BF16
    print(f"  MFU {100 * mfu:.2f}% (3 x {fwd_flops / 1e9:.1f} GFLOP of conv "
          f"and fc a forward over {PEAK_BF16 / 1e12:.0f} TFLOP/s); peak "
          f"memory {out['peak_gib']:.2f} GiB")
    out.update(B=B, fwd_gflops=fwd_flops / 1e9, mfu=mfu)
    return out


def profile_wide_deep(steps, pt, registry, torch):
    main, startup, cost, feed = build_wide_deep(pt)
    B = feed["label"].shape[0]
    out = profile_step(f"wide_deep: B={B}", main, startup, cost, feed,
                       steps, B, "examples", pt, registry, torch)
    out.update(B=B)
    return out


def profile_stacked_lstm(steps, pt, registry, torch):
    main, startup, cost, feed = build_stacked_lstm(pt)
    B = feed["label"].shape[0]
    rows = feed["words"][0].shape[0]
    out = profile_step(f"stacked_lstm: B={B} rows={rows}", main, startup,
                       cost, feed, steps, B, "sequences", pt, registry,
                       torch)
    out.update(B=B, rows=int(rows))
    return out


def profile_seq2seq(steps, pt, registry, torch):
    main, startup, cost, feed = build_seq2seq(pt)
    B = len(feed["trg_word"][1][0]) - 1
    tokens = int(feed["trg_word"][0].shape[0])
    out = profile_step(f"seq2seq: B={B} target tokens={tokens}", main,
                       startup, cost, feed, steps, tokens, "target_tokens",
                       pt, registry, torch)
    out.update(B=B, target_tokens=tokens)
    return out


def profile_step(label, main, startup, cost, feed, steps, units, unit,
                 pt, registry, torch):
    """Warm-up, timed steps, a synchronized per-op step and a profiled
    step of one training program; ``units`` of ``unit`` a step."""
    from torch.profiler import ProfilerActivity, profile
    import numpy as np
    scope = pt.Scope()
    exe = pt.Executor()
    exe.run(startup, scope=scope)
    torch.cuda.reset_peak_memory_stats()
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
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof.export_chrome_trace(os.path.join(
        OUT_DIR, f"trace_{label.split(':')[0].replace(' ', '_')}.json"))
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
    loop = dict(exe.last_run)
    phases = collections.defaultdict(float)
    for (phase, _), s in times.items():
        phases[phase] += s
    print(f"{label}: {1e3 * step:.2f} ms a step (mean of {steps}) = "
          f"{units / step:.1f} {unit}/s")
    print(f"  synchronized per-op step {1e3 * sync_wall:.2f} ms: "
          + ", ".join(f"{p} {1e3 * s:.2f} ms" for p, s in phases.items()))
    if loop.get("while_trips"):
        print(f"  while trips a step {loop['while_trips']} (the forward's and "
              f"while_grad's re-run), device reads of a loop condition or "
              f"index {loop['host_reads']}")
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
    # the hand-written kernels, wherever they rank
    ours = {k: v for k, v in kernels.items()
            if any(h in k for h in HAND_WRITTEN)}
    for name, (n, us) in sorted(ours.items(), key=lambda kv: -kv[1][1]):
        print(f"    hand-written {us / 1e3:9.3f} ms  {n:6d} x "
              f"{us / n:9.2f} us  {name[:80]}")
    del scope, exe
    torch.cuda.empty_cache()
    return {
        "step_ms": 1e3 * step, f"{unit}_per_s": units / step,
        "peak_gib": peak, "loop": loop,
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
        "hand_written_kernels": [{"name": k, "count": n,
                                  "device_ms": us / 1e3}
                                 for k, (n, us) in ours.items()],
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="transformer",
                    choices=("transformer", "resnet", "wide_deep",
                             "stacked_lstm", "seq2seq"))
    ap.add_argument("--routes", nargs="+", default=sorted(ROUTES),
                    choices=sorted(ROUTES))
    ap.add_argument("--batch", type=int, default=256,
                    help="ResNet-50's batch (bench_resnet.py's default)")
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
    if args.model == "resnet":
        summary["resnet50"] = profile_resnet(args.batch, args.steps, pt,
                                             registry, torch)
    elif args.model == "wide_deep":
        summary["wide_deep"] = profile_wide_deep(args.steps, pt, registry,
                                                 torch)
    elif args.model == "stacked_lstm":
        summary["stacked_lstm"] = profile_stacked_lstm(args.steps, pt,
                                                       registry, torch)
    elif args.model == "seq2seq":
        summary["seq2seq"] = profile_seq2seq(args.steps, pt, registry, torch)
    else:
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
