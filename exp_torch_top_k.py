#!/usr/bin/env python3
"""Experiment: what the ``top_k`` lowering's stable sort costs on one
H100 against ``torch.topk``.

The lowering (``paddle_tpu_torch/ops/tensor_ops.py``, ``top_k_lower``)
sorts the whole last axis stably, descending, and cuts it to ``k``, so
that equal values keep the reference's order (lowest index first);
``torch.topk`` selects ``k`` without a full sort and orders ties as it
likes.  This times both (CUDA events, mean of ``--iters`` back-to-back
calls after warm-up) at the widest last axis a zoo model feeds the op,
Transformer-base's vocabulary of 10000, for a row, a batch of 256 rows
and a training step's 16384 target tokens, at k = 1, 4 and 10, float32
and bfloat16, and checks that both give the same values.  It prints one
JSON line with the card's name and power limit.

    python3 exp_torch_top_k.py

It imports neither JAX nor the JAX package and exits non-zero without
CUDA.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
VOCAB = 10000
ROWS = (1, 256, 16384)
KS = (1, 4, 10)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters, warmup=10):
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


class _Ctx:
    """The three calls a lowering makes of its context."""

    def __init__(self, x, k):
        self.x, self.k, self.out = x, k, {}

    def attr(self, name, default=None):
        return self.k if name == "k" else default

    def input(self, name):
        return self.x

    def set_output(self, name, value):
        self.out[name] = value


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=100)
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("exp_torch_top_k: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("exp_torch_top_k: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from paddle_tpu_torch.ops.tensor_ops import top_k_lower
    g = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for n in ROWS:
            x = torch.randn(n, VOCAB, generator=g, device="cuda").to(dtype)
            for k in KS:
                ctx = _Ctx(x, k)
                top_k_lower(ctx)
                vals, _ = torch.topk(x, k, dim=-1)
                if not torch.equal(ctx.out["Out"], vals):
                    raise AssertionError(f"top_k values differ at rows {n}, "
                                         f"k {k}, {dtype}")
                rows.append({
                    "dtype": str(dtype)[6:], "rows": n, "k": k,
                    "sort_ms": time_ms(lambda: top_k_lower(_Ctx(x, k)),
                                       args.iters),
                    "topk_ms": time_ms(lambda: torch.topk(x, k, dim=-1),
                                       args.iters)})
    print(json.dumps({"card": card_line(), "vocab": VOCAB, "rows": rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
