#!/usr/bin/env python3
"""Experiment: where the single-pass attention pair pays on an H100 (the
port's counterpart of ``exp_smalls_attn.py``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 exp_torch_smalls_attn.py [--sizes 128,256,512,1024,2048]

Attention forward + backward at 65536 tokens (B = 65536 / S), 8 heads of
64, bfloat16, once causal and once key-masked (a tenth of the keys off),
for each S, through four routes on the same inputs:

- ``smalls``: the single-pass pair (``kernels/smalls_attention.py``);
- ``flash``: the streaming flash kernels (``kernels/flash_attention.py``);
- ``composed``: ``torch.matmul`` for the four products around the
  bias-softmax kernels (``kernels/bias_softmax.py``), what the model
  builds below its flash gate;
- ``sdpa``: ``torch.nn.functional.scaled_dot_product_attention`` under
  autograd, PyTorch's own attention, as the yardstick (the port never
  calls it).

Numerics are checked first (as ``check_numerics`` of the original does):
the pair against its plain version to one bf16 rounding and against
float32 softmax attention under autograd.  Then one JSON row a (S, case)
on standard output: milliseconds of forward + backward by CUDA events,
each route timed in two passes in opposite order (``*_ms`` is their
mean, ``*_passes`` both), plus the pair's and the flash kernels' forward
and backward apart, and the pair's forward at 16, 32 and 64 query rows a
block.  The rows answer three questions: how many query rows a forward
block should own (``smalls_fwd_rows``), up to which S
the pair beats the flash kernels (the limit of ``smalls_ok``), and from which
S a fused op beats the composed route (the model's
``PADDLE_TPU_FLASH_MIN_S``).  The card's name and power limit are printed
first: compare rows of one run only.

It imports neither JAX nor the JAX package and exits non-zero without
CUDA.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
HEADS, DIM = 8, 64
TOKENS = 1 << 16
SEED = 20260416


def time_ms(fn, iters, warmup=2):
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


def make_case(B, S, causal, generator):
    import torch
    shape = (B, HEADS, S, DIM)
    q, k, v, do = (torch.randn(shape, generator=generator)
                   .to(torch.bfloat16).cuda() for _ in range(4))
    mask = None
    if not causal:
        mask = (torch.rand(B, S, generator=generator) > 0.1).float().cuda()
    return q, k, v, do, mask


def routes(q, k, v, do, mask, causal):
    """``{name: (forward, backward, forward_and_backward)}`` closures over
    one case; every backward gives dq, dk and dv."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels.bias_softmax import (bias_softmax,
                                                       bias_softmax_grad)
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_fwd)
    from paddle_tpu_torch.kernels.smalls_attention import (
        smalls_attention_bwd, smalls_attention_fwd)
    B, _, S, D = q.shape
    scale = D ** -0.5
    out = {}

    def fused(fwd, bwd):
        o, lse = fwd(q, k, v, mask, causal, scale)

        def both():
            o_, lse_ = fwd(q, k, v, mask, causal, scale)
            return bwd(q, k, v, mask, o_, lse_, do, causal, scale)
        return (lambda: fwd(q, k, v, mask, causal, scale),
                lambda: bwd(q, k, v, mask, o, lse, do, causal, scale), both)

    out["smalls"] = fused(smalls_attention_fwd, smalls_attention_bwd)
    out["flash"] = fused(flash_attention_fwd, flash_attention_bwd)

    row = None if mask is None else (mask - 1.0) * 1e9
    tri = torch.triu(torch.full((1, S, S), -1e9, device=q.device), 1) \
        if causal else None

    def composed_fwd():
        s = torch.matmul(q, k.transpose(-1, -2)) * scale
        p = bias_softmax(s, row, tri)
        return p, torch.matmul(p, v)

    def composed_bwd(p):
        dv = torch.matmul(p.transpose(-1, -2), do)
        ds = bias_softmax_grad(p, torch.matmul(do, v.transpose(-1, -2)))
        return (torch.matmul(ds, k) * scale,
                torch.matmul(ds.transpose(-1, -2), q) * scale, dv)

    p0, _ = composed_fwd()
    out["composed"] = (composed_fwd, lambda: composed_bwd(p0),
                       lambda: composed_bwd(composed_fwd()[0]))

    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    attn_mask = None if mask is None else \
        (mask > 0.5)[:, None, None, :].expand(B, 1, S, S)

    def sdpa_fwd():
        return F.scaled_dot_product_attention(
            *leaves, attn_mask=attn_mask, is_causal=causal, scale=scale)

    o0 = sdpa_fwd()
    out["sdpa"] = (sdpa_fwd,
                   lambda: torch.autograd.grad(o0, leaves, do,
                                               retain_graph=True),
                   lambda: torch.autograd.grad(sdpa_fwd(), leaves, do))
    return out


def check_numerics(S=256, B=4):
    """The pair on the card against its plain version (one bf16 rounding;
    the grads plus ``flash_backward_rounding_slack``, as the tensor-core
    backward sums ``q . k`` and ``dO . v`` in another order, so ``T(p)``
    and ``T(dS)`` may round the other way near a bf16 rounding boundary)
    and against float32 softmax attention under autograd (bf16 operand
    and probability rounding: the original's limits, 0.1 and 0.5 in max
    abs error at unit-variance inputs)."""
    import torch
    from paddle_tpu_torch.kernels.flash_attention import (
        _scores, flash_backward_rounding_slack)
    from paddle_tpu_torch.kernels.smalls_attention import (
        smalls_attention_bwd, smalls_attention_bwd_reference,
        smalls_attention_fwd, smalls_attention_fwd_reference)
    g = torch.Generator().manual_seed(SEED)
    for causal in (False, True):
        q, k, v, do, _ = make_case(B, S, True, g)
        mask = (torch.rand(B, S, generator=g) > 0.1).float().cuda()
        scale = DIM ** -0.5
        out, lse = smalls_attention_fwd(q, k, v, mask, causal, scale)
        grads = smalls_attention_bwd(q, k, v, mask, out, lse, do, causal,
                                     scale)
        torch.cuda.synchronize()
        want = [smalls_attention_fwd_reference(q, k, v, mask, causal,
                                               scale)[0],
                *smalls_attention_bwd_reference(q, k, v, mask, out, lse, do,
                                                causal, scale)]
        slack = [torch.zeros(()), *flash_backward_rounding_slack(
            q, k, v, mask, out, lse, do, causal, scale)]
        for a, b, sl in zip([out, *grads], want, slack):
            w = b.float()
            rms = float(w.square().mean().sqrt())
            tol = 2.0 ** -8 * rms + 2.0 ** -7 * w.abs() + sl.to(w.device)
            if not a.isfinite().all() or ((a.float() - w).abs() > tol).any():
                raise AssertionError("numerics mismatch against the plain "
                                     "version")
        leaves = [x.float().requires_grad_() for x in (q, k, v)]
        ref = torch.softmax(_scores(*leaves[:2], mask, causal, scale),
                            -1) @ leaves[2]
        rgrads = torch.autograd.grad(ref, leaves, do.float())
        err = float((out.float() - ref).abs().max())
        gerr = max(float((a.float() - b).abs().max())
                   for a, b in zip(grads, rgrads))
        print(f"# numerics S={S} causal={causal}: fwd maxerr={err:.4f} "
              f"bwd maxerr={gerr:.4f}", file=sys.stderr)
        if not (err < 0.1 and gerr < 0.5):
            raise AssertionError("numerics mismatch")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="128,256,512,1024,2048",
                    help="comma-separated sequence lengths")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("exp_torch_smalls_attn: torch is not installed",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("exp_torch_smalls_attn: CUDA is not available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.kernels.smalls_attention import (
        fwd_rows_fit, smalls_attention_fwd, smalls_fwd_rows)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"# card: {card}; torch {torch.__version__}", file=sys.stderr)
    build.build_all()
    check_numerics()

    g = torch.Generator().manual_seed(SEED + 1)
    for S in (int(s) for s in args.sizes.split(",")):
        B = TOKENS // S
        for causal in (True, False):
            case = make_case(B, S, causal, g)
            table = routes(*case, causal)
            iters = 5 if S >= 1024 else 10
            row = {"card": card, "S": S, "B": B, "H": HEADS, "D": DIM,
                   "dtype": "bfloat16",
                   "case": "causal" if causal else "key-masked"}
            order = list(table)
            passes = {n: [] for n in order}
            for names in (order, order[::-1]):
                for n in names:
                    passes[n].append(time_ms(table[n][2], iters))
            for n in order:
                row[f"{n}_ms"] = sum(passes[n]) / 2
                row[f"{n}_passes"] = passes[n]
            for n in ("smalls", "flash"):
                row[f"{n}_fwd_ms"] = time_ms(table[n][0], iters)
                row[f"{n}_bwd_ms"] = time_ms(table[n][1], iters)
            # the pair's forward at each count of query rows a block that
            # fits, beside the one smalls_fwd_rows picks
            q, k, v, _, mask = case
            row["smalls_fwd_rows"] = smalls_fwd_rows(S, DIM, DIM)
            for rows in (16, 32, 64):
                if fwd_rows_fit(rows, S, DIM, DIM):
                    row[f"smalls_fwd_rows{rows}_ms"] = time_ms(
                        lambda: smalls_attention_fwd(
                            q, k, v, mask, causal, DIM ** -0.5, rows=rows),
                        iters)
            print(json.dumps(row), flush=True)
            del case, table
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
