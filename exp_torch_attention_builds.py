#!/usr/bin/env python3
"""Experiment: the attention kernels of two builds of the port on one
H100, side by side: the single-pass and the flash bfloat16 forward's and
backward's times, and whether the outputs are the same bits.

Run it from the root of each checkout (copy it into an older one), on a
machine with one NVIDIA H100, then compare:

    (cd OLD && python3 exp_torch_attention_builds.py --out runs/ab/old.pt)
    python3 exp_torch_attention_builds.py --out runs/ab/new.pt
    python3 exp_torch_attention_builds.py --compare OLD/runs/ab/old.pt \
        runs/ab/new.pt

Each run prints one JSON line: the single-pass bfloat16 forward's and
backward's times (CUDA events, mean of ``--iters`` back-to-back calls
after warm-up; the backward is the wrapper: delta and the one kernel) at
route C's key-masked and causal ``[32, 8, 512, 64]`` and the
``[B,S,H,D]`` flagship ``[256, 256, 8, 64]`` causal, beside PyTorch's
``scaled_dot_product_attention`` forward and backward (one call for dq,
dk and dv) on the same inputs (the flagship's on the transposed views);
the flash
bfloat16 forward's and backward's (the wrapper: delta, dQ and dK/dV) at
route B's key-masked (an all-ones mask, as the model feeds it) and
causal ``[8, 8, 2048, 2048, 64]``, beside SDPA's forward and backward
(one call for dq, dk and dv); and the card's name and power limit.  SDPA is a yardstick the port never
calls.  Compare times of one call only, run in turns (old, new, new,
old).

With ``--out`` it also saves, from inputs made from one seed at seven
shapes (those three, a ``[4, 8, 1024, 64]`` causal, a ragged ``[2, 4,
200, 64]`` causal with key 0 off, and the flagship twice more at
unit-variance inputs: key-masked, and causal with key 0 off):

- the float32 forward's ``out`` and ``(m, log l)`` residual;
- the float32 and bfloat16 backward's ``dq, dk, dv`` from the same
  inputs (``out`` and the residual of the float32 forward, ``out`` cast
  to bfloat16 for the bfloat16 backward);
- the bfloat16 forward's outputs (these may differ between builds);

and of the flash kernels at route B's two shapes (key-masked with a
batch row whose every key is off, and causal) and a ragged
cross-attention ``[2, 8, 300, 517, 64]``:

- the float32 forward's ``out`` and residual, and the float32
  backward's ``dq, dk, dv`` from them;
- the bfloat16 backward's ``dq, dk, dv`` from the same inputs in
  bfloat16 and the float32 forward's residual;
- the bfloat16 forward's ``out`` and residual (these may differ between
  builds).

``--compare`` prints, for each saved tensor, whether the two runs hold the
same bits, and the largest difference where not; it exits non-zero if
any output but the single-pass bfloat16 backward's ``dq, dk, dv``
differs (the body that the builds compared here redesign; the flash
kernels, whose backward bodies it shares, must keep their bits).
``--flash-only`` and ``--single-pass-only`` time the flash or the
single-pass kernels alone (no ``--out``): the quick reading for variants
of one build.

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
#: flash shapes: (label, B, H, Sq, Sk, D, causal, key mask), the first two
#: timed
FLASH_SHAPES = (
    ("flash route B key-masked", 8, 8, 2048, 2048, 64, False, "masked"),
    ("flash route B causal", 8, 8, 2048, 2048, 64, True, None),
    ("flash ragged cross-attention", 2, 8, 300, 517, 64, False, "masked"),
)


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


def make_inputs(layout, B, H, S, D, mask_kind, std, generator, Sk=None):
    """bf16 q, k, v, dO on the card (``[B,H,S,D]`` or ``[B,S,H,D]``; k
    and v of ``Sk`` rows, S by default) and a float32 key mask (or
    None)."""
    import torch
    Sk = S if Sk is None else Sk
    shapes = [(B, H, n, D) if layout == "bhsd" else (B, n, H, D)
              for n in (S, Sk, Sk, S)]
    q, k, v, do = ((torch.randn(shape, generator=generator) * std)
                   .to(torch.bfloat16).cuda() for shape in shapes)
    mask = None
    if mask_kind is not None:
        mask = torch.ones(B, Sk)
        if mask_kind == "masked":
            mask = (torch.rand(B, Sk, generator=generator) > 0.2).float()
            mask[0] = 0.0
        elif mask_kind == "first_key_off":
            mask[:, 0] = 0.0
        mask = mask.cuda()
    return q, k, v, do, mask


def sdpa_bwd_ms(q, k, v, do, mask, causal, scale, iters):
    """SDPA's backward (dq, dk, dv in one call) on [B,H,S,D] inputs."""
    import torch
    import torch.nn.functional as F
    B, _, Sq, _ = q.shape
    attn_mask = None if mask is None else \
        (mask > 0.5)[:, None, None, :].expand(B, 1, Sq, k.shape[2])
    ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
    ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=attn_mask,
                                        is_causal=causal, scale=scale)
    return time_ms(lambda: torch.autograd.grad(ol, (ql, kl, vl), do,
                                               retain_graph=True), iters)


def run_flash(saved, times, iters, generator):
    """The flash kernels' outputs (into ``saved``) and bf16 forward and
    backward times (into ``times``) at ``FLASH_SHAPES``."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import flash_attention as fa
    for label, B, H, Sq, Sk, D, causal, mask_kind in FLASH_SHAPES:
        q, k, v, do, mask = make_inputs("bhsd", B, H, Sq, D, mask_kind, 0.5,
                                        generator, Sk=Sk)
        scale = D ** -0.5
        if saved is not None:
            f32 = [x.float() for x in (q, k, v, do)]
            out32, lse = fa.flash_attention_fwd(*f32[:3], mask, causal,
                                                scale)
            saved[f"{label}/f32 fwd out"] = out32
            saved[f"{label}/f32 fwd lse"] = lse
            for name, x in zip(("dq", "dk", "dv"), fa.flash_attention_bwd(
                    *f32[:3], mask, out32, lse, f32[3], causal, scale)):
                saved[f"{label}/f32 bwd {name}"] = x
            for name, x in zip(("dq", "dk", "dv"), fa.flash_attention_bwd(
                    q, k, v, mask, out32.to(torch.bfloat16), lse, do,
                    causal, scale)):
                saved[f"{label}/bf16 bwd {name}"] = x
            out16, lse16 = fa.flash_attention_fwd(q, k, v, mask, causal,
                                                  scale)
            saved[f"{label}/bf16 fwd out"] = out16
            saved[f"{label}/bf16 fwd lse"] = lse16
            del f32
        if "route B" in label:
            if mask is not None:
                mask.fill_(1.0)     # the encoder's all-ones fake_batch mask
            out, lse = fa.flash_attention_fwd(q, k, v, mask, causal, scale)
            attn_mask = None if mask is None else \
                (mask > 0.5)[:, None, None, :].expand(B, 1, Sq, Sk)
            times[label] = {
                "bf16_fwd_ms": time_ms(lambda: fa.flash_attention_fwd(
                    q, k, v, mask, causal, scale), iters),
                "sdpa_fwd_ms": time_ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=attn_mask, is_causal=causal,
                        scale=scale), iters),
                "bf16_bwd_ms": time_ms(lambda: fa.flash_attention_bwd(
                    q, k, v, mask, out, lse, do, causal, scale), iters),
                "sdpa_bwd_ms": sdpa_bwd_ms(q, k, v, do, mask, causal, scale,
                                           iters)}
        del q, k, v, do, mask
        torch.cuda.empty_cache()


def run(out_path, iters, flash_only=False, single_pass_only=False):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import bshd_attention as ba
    from paddle_tpu_torch.kernels import smalls_attention as sm
    g = torch.Generator().manual_seed(SEED)
    saved, times = {}, {}
    for label, layout, B, H, S, D, causal, mask_kind, std in \
            ([] if flash_only else SHAPES):
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
            heads = (q, k, v, do) if layout == "bhsd" else \
                tuple(x.transpose(1, 2) for x in (q, k, v, do))
            sdpa_mask = mask if mask_kind == "masked" else None
            attn_mask = None
            if sdpa_mask is not None:
                attn_mask = (mask > 0.5)[:, None, None, :].expand(
                    B, 1, S, S)
            out, lse = fwd(q, k, v, mask, causal, scale)
            times[label] = {
                "bf16_fwd_ms": time_ms(lambda: fwd(q, k, v, mask, causal,
                                                   scale), iters),
                "sdpa_fwd_ms": time_ms(
                    lambda: F.scaled_dot_product_attention(
                        *heads[:3], attn_mask=attn_mask, is_causal=causal,
                        scale=scale), iters),
                "bf16_bwd_ms": time_ms(lambda: bwd(
                    q, k, v, mask, out, lse, do, causal, scale), iters),
                "sdpa_bwd_ms": sdpa_bwd_ms(*heads, sdpa_mask, causal,
                                           scale, iters)}
            del out, lse
        del q, k, v, do
        torch.cuda.empty_cache()
    if not single_pass_only:
        run_flash(saved if out_path else None, times, max(iters // 5, 5), g)
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
        may_differ = not key.startswith("flash") and "bf16 bwd" in key
        if not same and not may_differ:
            bad.append(key)
    print(json.dumps({"compared": len(a), "must_match_differ": bad}))
    return 1 if bad else 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="save the outputs here (.pt)")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    ap.add_argument("--flash-only", action="store_true",
                    help="time the flash kernels alone")
    ap.add_argument("--single-pass-only", action="store_true",
                    help="time the single-pass kernels alone")
    args = ap.parse_args()
    if (args.flash_only or args.single_pass_only) and args.out:
        ap.error("--flash-only and --single-pass-only time; they save "
                 "nothing")
    if args.flash_only and args.single_pass_only:
        ap.error("--flash-only and --single-pass-only exclude each other")
    try:
        import torch
    except ImportError:
        print("exp_torch_attention_builds: torch is not installed",
              file=sys.stderr)
        return 2
    if args.compare:
        return compare(*args.compare)
    if not torch.cuda.is_available():
        print("exp_torch_attention_builds: CUDA is not available",
              file=sys.stderr)
        return 2
    run(args.out, args.iters, args.flash_only, args.single_pass_only)
    return 0


if __name__ == "__main__":
    sys.exit(main())
