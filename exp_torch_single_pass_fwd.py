#!/usr/bin/env python3
"""Experiment: the single-pass attention kernels of two builds of the port
on one H100, side by side: the bfloat16 forward's times and whether the
outputs are the same bits.

Run it from the root of each checkout (copy it into an older one), on a
machine with one NVIDIA H100, then compare:

    (cd OLD && python3 exp_torch_single_pass_fwd.py --out runs/sp/old.pt)
    python3 exp_torch_single_pass_fwd.py --out runs/sp/new.pt
    python3 exp_torch_single_pass_fwd.py --compare OLD/runs/sp/old.pt \
        runs/sp/new.pt

Each run prints one JSON line: the bfloat16 forward's times (CUDA
events, mean of ``--iters`` back-to-back calls after warm-up) at route
C's key-masked and causal ``[32, 8, 512, 64]`` and the ``[B,S,H,D]``
flagship ``[256, 256, 8, 64]`` causal, beside PyTorch's
``scaled_dot_product_attention`` forward on the same inputs (a yardstick
the port never calls), and the card's name and power limit.  Compare
times of one call only, run in turns (old, new, new, old).

With ``--out`` it also saves, from inputs made from one seed at seven
shapes (those three, a ``[4, 8, 1024, 64]`` causal, a ragged ``[2, 4,
200, 64]`` causal with key 0 off, and the flagship twice more at
unit-variance inputs: key-masked, and causal with key 0 off):

- the float32 forward's ``out`` and ``(m, log l)`` residual;
- the float32 and bfloat16 backward's ``dq, dk, dv`` from the same
  inputs (``out`` and the residual of the float32 forward, ``out`` cast
  to bfloat16 for the bfloat16 backward);
- the bfloat16 forward's outputs (these may differ between builds).

``--compare`` prints, for each saved tensor, whether the two runs hold the
same bits, and the largest difference where not; it exits non-zero if a
float32 forward or a backward output differs.

It imports neither JAX nor the JAX package and exits non-zero without
CUDA.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20260417

#: (label, layout, B, H, S, D, causal, key mask: None | "masked" |
#: "first_key_off" | "ones", input standard deviation)
SHAPES = (
    ("route C key-masked", "bhsd", 32, 8, 512, 64, False, "masked", 0.5),
    ("route C causal", "bhsd", 32, 8, 512, 64, True, None, 0.5),
    ("S 1024 causal", "bhsd", 4, 8, 1024, 64, True, None, 0.5),
    ("ragged S 200 causal, first key off", "bhsd", 2, 4, 200, 64, True,
     "first_key_off", 0.5),
    ("bshd flagship causal", "bshd", 256, 8, 256, 64, True, "ones", 0.5),
    ("bshd flagship key-masked, unit variance", "bshd", 256, 8, 256, 64,
     False, "masked", 1.0),
    ("bshd flagship causal, first key off, unit variance", "bshd", 256, 8,
     256, 64, True, "first_key_off", 1.0),
)
#: shapes that are timed (the kernel table's rows)
TIMED = ("route C key-masked", "route C causal", "bshd flagship causal")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters, warmup=5):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_inputs(layout, B, H, S, D, mask_kind, std, generator):
    """bf16 q, k, v, dO on the card (``[B,H,S,D]`` or ``[B,S,H,D]``) and
    a float32 key mask (or None)."""
    import torch
    shape = (B, H, S, D) if layout == "bhsd" else (B, S, H, D)
    q, k, v, do = ((torch.randn(shape, generator=generator) * std)
                   .to(torch.bfloat16).cuda() for _ in range(4))
    mask = None
    if mask_kind is not None:
        mask = torch.ones(B, S)
        if mask_kind == "masked":
            mask = (torch.rand(B, S, generator=generator) > 0.2).float()
            mask[0] = 0.0
        elif mask_kind == "first_key_off":
            mask[:, 0] = 0.0
        mask = mask.cuda()
    return q, k, v, do, mask


def run(out_path, iters):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import bshd_attention as ba
    from paddle_tpu_torch.kernels import smalls_attention as sm
    g = torch.Generator().manual_seed(SEED)
    saved, times = {}, {}
    for label, layout, B, H, S, D, causal, mask_kind, std in SHAPES:
        q, k, v, do, mask = make_inputs(layout, B, H, S, D, mask_kind, std,
                                        g)
        fwd, bwd = ((sm.smalls_attention_fwd, sm.smalls_attention_bwd)
                    if layout == "bhsd" else
                    (ba.bshd_attention_fwd, ba.bshd_attention_bwd))
        scale = D ** -0.5
        if out_path:
            f32 = [x.float() for x in (q, k, v, do)]
            out32, lse = fwd(*f32[:3], mask, causal, scale)
            saved[f"{label}/f32 fwd out"] = out32
            saved[f"{label}/f32 fwd lse"] = lse
            for name, x in zip(("dq", "dk", "dv"),
                               bwd(*f32[:3], mask, out32, lse, f32[3],
                                   causal, scale)):
                saved[f"{label}/f32 bwd {name}"] = x
            for name, x in zip(("dq", "dk", "dv"),
                               bwd(q, k, v, mask, out32.to(torch.bfloat16),
                                   lse, do, causal, scale)):
                saved[f"{label}/bf16 bwd {name}"] = x
            out16, lse16 = fwd(q, k, v, mask, causal, scale)
            saved[f"{label}/bf16 fwd out"] = out16
            saved[f"{label}/bf16 fwd lse"] = lse16
            del f32
        if label in TIMED:
            heads = (q, k, v) if layout == "bhsd" else \
                tuple(x.transpose(1, 2) for x in (q, k, v))
            attn_mask = None
            if mask is not None and mask_kind == "masked":
                attn_mask = (mask > 0.5)[:, None, None, :].expand(
                    B, 1, S, S)
            times[label] = {
                "bf16_fwd_ms": time_ms(lambda: fwd(q, k, v, mask, causal,
                                                   scale), iters),
                "sdpa_fwd_ms": time_ms(
                    lambda: F.scaled_dot_product_attention(
                        *heads, attn_mask=attn_mask, is_causal=causal,
                        scale=scale), iters)}
        del q, k, v, do
        torch.cuda.empty_cache()
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                    exist_ok=True)
        torch.save({k: x.cpu() for k, x in saved.items()}, out_path)
    print(json.dumps({"card": card_line(), "root": ROOT, "times": times}),
          flush=True)


def compare(a_path, b_path):
    import torch
    a, b = torch.load(a_path), torch.load(b_path)
    bad = []
    for key in a:
        same = torch.equal(a[key], b[key])
        diff = 0.0 if same else float(
            (a[key].float() - b[key].float()).abs().max())
        print(f"{key}: {'same bits' if same else f'differs, max {diff:.3e}'}")
        if not same and "bf16 fwd" not in key:
            bad.append(key)
    print(json.dumps({"compared": len(a), "must_match_differ": bad}))
    return 1 if bad else 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="save the outputs here (.pt)")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("exp_torch_single_pass_fwd: torch is not installed",
              file=sys.stderr)
        return 2
    if args.compare:
        return compare(*args.compare)
    if not torch.cuda.is_available():
        print("exp_torch_single_pass_fwd: CUDA is not available",
              file=sys.stderr)
        return 2
    run(args.out, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
