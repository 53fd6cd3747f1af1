#!/usr/bin/env python3
"""Experiment: attention in the model's ``[B, S, H, D]`` layout on an H100
(the port's counterpart of ``exp_bshd_attn.py``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 exp_torch_bshd_attn.py

The question: does an attention that reads the projections' ``[B, S, H,
D]`` output directly beat one that pays the head transposes around it?
Forward + backward at the flagship shape (B 256, S 256, H 8, D 64,
bfloat16, causal, an all-ones key mask), through four routes on the same
inputs, each giving dq, dk, dv in ``[B, S, H, D]``:

- ``bshd``: the ``[B, S, H, D]`` pair under autograd
  (``kernels/bshd_attention.py``: ``bshd_attn``), no transposes;
- ``smalls_transposed``: the ``[B, H, S, D]`` single-pass pair
  (``SmallsAttentionFunction``) with the ``.transpose(1, 2).contiguous()``
  copies that the model's ``transpose`` ops make, forward and backward;
- ``composed_transposed``: ``torch.matmul`` for the four products around
  the bias-softmax kernels, with the same transposes: the model's route
  below its flash gate;
- ``sdpa``: ``torch.nn.functional.scaled_dot_product_attention`` on the
  transposed views under autograd, PyTorch's own attention, as the
  yardstick (the port never calls it).

Numerics are checked first (:func:`check_numerics`, as the original's):
the pair against float32 softmax attention under autograd, forward and
grads, causal and not, with a random key mask, to the original's limits,
and the kernels against their plain versions to one bf16 rounding.  Then
one JSON row on standard output: milliseconds of forward + backward by
CUDA events, each route timed in two passes in opposite order (``*_ms``
is their mean, ``*_passes`` both), plus the pair's forward and backward
apart and the ``[B, H, S, D]`` pair's on copies transposed once (the
gap between the two fused routes, less the copies).  The card's name and power limit are printed first: compare rows
of one run only.

It imports neither JAX nor the JAX package and exits non-zero without
CUDA.  :func:`check_numerics` also runs on the CPU (on the plain
versions), at a small size.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
B, S, H, D = 256, 256, 8, 64
ITERS = 10
SEED = 20260416
#: the causal flags :func:`check_numerics` runs, one forward and one
#: backward launch each
CASES = (False, True)
#: the original's limits in max abs error, at unit-variance inputs
FWD_LIMIT, BWD_LIMIT = 0.1, 0.5


def time_ms(fn, iters=ITERS, warmup=2):
    """Mean milliseconds a call of ``fn`` on the card, by CUDA events
    around ``iters`` back-to-back calls after ``warmup`` calls."""
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


def _bf16_close(got, want, what):
    """One bf16 rounding of the same float32 value: ``rtol = 2**-7`` plus
    ``2**-8`` times the output's RMS for elements near zero."""
    import torch
    rms = float(want.float().square().mean().sqrt())
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=2.0 ** -8 * rms,
                               msg=lambda m: f"{what}: {m}")


def _bf16_grads_close(grads, wants, args, what):
    """The pair's ``(dq, dk, dv)`` [B, S, H, D] against the plain
    versions': one bf16 rounding (as :func:`_bf16_close`) plus
    ``flash_backward_rounding_slack`` of ``args`` (the backward's ``q, k,
    v, mask, out, res, dout, causal, scale``) on the head-transposed
    views.  The tensor-core backward sums ``q . k`` and ``dO . v`` in
    another order than the plain version, so ``T(p)`` and ``T(dS)`` may
    round the other way where they lie near a bf16 rounding boundary;
    the slack is zero elsewhere."""
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_backward_rounding_slack)
    q, k, v, mask, out, res, dout, causal, scale = args
    heads = [x.transpose(1, 2) for x in (q, k, v)]
    slack = flash_backward_rounding_slack(
        *heads, mask, *(x.transpose(1, 2) for x in (out, res, dout)),
        causal, scale)
    for n, a, b, sl in zip(("dq", "dk", "dv"), grads, wants, slack):
        w = b.float()
        rms = float(w.square().mean().sqrt())
        over = (a.float() - w).abs() > \
            2.0 ** -8 * rms + 2.0 ** -7 * w.abs() + sl.transpose(1, 2)
        if not a.isfinite().all() or over.any():
            raise AssertionError(f"{what} {n}: {int(over.sum())} elements "
                                 f"beyond one bf16 rounding plus the "
                                 f"rounding-flip slack")


def check_numerics(device="cuda", batch=4, seq=256):
    """The pair at ``[batch, seq, H, D]``, bfloat16, a random key mask in
    bf16 (a tenth of the keys off) as the original passes it, causal and
    not (:data:`CASES`), under autograd with a unit-variance cotangent:

    - against float32 softmax attention under autograd on the transposed
      views (the port's ``_reference_attention``): forward below
      :data:`FWD_LIMIT`, grads below :data:`BWD_LIMIT` in max abs error;
    - against the kernels' plain versions on the same inputs: out to one
      bf16 rounding, the grads to one rounding plus the rounding-flip
      slack of the tensor-core backward (:func:`_bf16_grads_close`), the
      residual to ``atol 1e-5, rtol 1e-6`` (float32 sums in another
      order).

    The original's loss, ``sum(out * arange(D))``, weighs the output by up
    to 63: under the causal mask the first keys' dv then reach a few
    hundred, where a bf16 ulp is 2, so one rounding of a grad can exceed
    its own 0.5 limit for any kernel with bf16 outputs, its arithmetic
    step by step included.  A unit-variance cotangent keeps the grads at
    the scale those limits were set for.

    On the CPU the wrappers are the plain versions.  Returns the worst
    errors ``{"fwd", "bwd", "fwd_plain", "bwd_plain"}``; raises on a
    miss."""
    import torch
    from paddle_tpu_torch.kernels.bshd_attention import (
        BshdAttentionFunction, bshd_attention_bwd_reference,
        bshd_attention_fwd_reference)
    from paddle_tpu_torch.kernels.flash_attention import _scores
    g = torch.Generator().manual_seed(SEED)
    scale = D ** -0.5
    worst = dict.fromkeys(("fwd", "bwd", "fwd_plain", "bwd_plain"), 0.0)
    for causal in CASES:
        q, k, v = (torch.randn(batch, seq, H, D, generator=g)
                   .to(torch.bfloat16).to(device) for _ in range(3))
        mask = (torch.rand(batch, seq, generator=g) > 0.1) \
            .to(torch.bfloat16).to(device)
        dout = torch.randn(batch, seq, H, D, generator=g) \
            .to(torch.bfloat16).to(device)
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out, res = BshdAttentionFunction.apply(*leaves, mask, causal, scale)
        grads = torch.autograd.grad(out, leaves, dout)
        out = out.detach()

        rleaves = [x.float().requires_grad_() for x in (q, k, v)]
        qt, kt, vt = (x.transpose(1, 2) for x in rleaves)
        ref = (torch.softmax(_scores(qt, kt, mask, causal, scale), -1)
               @ vt).transpose(1, 2)
        rgrads = torch.autograd.grad(ref, rleaves, dout.float())
        err = float((out.float() - ref.detach()).abs().max())
        gerr = max(float((a.float() - b).abs().max())
                   for a, b in zip(grads, rgrads))

        pout, pres = bshd_attention_fwd_reference(q, k, v, mask, causal,
                                                  scale)
        pgrads = bshd_attention_bwd_reference(q, k, v, mask, out, res, dout,
                                              causal, scale)
        what = f"bshd numerics causal={causal}"
        _bf16_close(out, pout, f"{what} out")
        torch.testing.assert_close(res, pres, atol=1e-5, rtol=1e-6,
                                   msg=lambda m: f"{what} res: {m}")
        _bf16_grads_close(grads, pgrads, (q, k, v, mask, out, res, dout,
                                          causal, scale), what)
        perr = max(float((out.float() - pout.float()).abs().max()),
                   float((res - pres).abs().max()))
        pgerr = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(grads, pgrads))
        print(f"# numerics [{batch}, {seq}, {H}, {D}] causal={causal}: "
              f"fwd maxerr={err:.4f} bwd maxerr={gerr:.4f}; against the "
              f"plain versions {perr:.3e}, {pgerr:.3e}", file=sys.stderr)
        if not (err < FWD_LIMIT and gerr < BWD_LIMIT):
            raise AssertionError(f"{what}: fwd {err} (limit {FWD_LIMIT}), "
                                 f"bwd {gerr} (limit {BWD_LIMIT})")
        for n, e in (("fwd", err), ("bwd", gerr), ("fwd_plain", perr),
                     ("bwd_plain", pgerr)):
            worst[n] = max(worst[n], e)
    return worst


def make_inputs(generator, device="cuda", batch=B, seq=S):
    """q, k, v, dO [batch, seq, H, D] bfloat16 at unit variance, and the
    all-ones bf16 key mask [batch, seq] of the original's timing."""
    import torch
    q, k, v, do = (torch.randn(batch, seq, H, D, generator=generator)
                   .to(torch.bfloat16).to(device) for _ in range(4))
    return q, k, v, do, torch.ones(batch, seq, dtype=torch.bfloat16,
                                   device=device)


def routes(q, k, v, do, mask):
    """``{name: step}``: each step runs causal attention forward and
    backward on the [B, S, H, D] inputs and returns (dq, dk, dv) in that
    layout.  Nothing launches until a step is called."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels.bias_softmax import (bias_softmax,
                                                       bias_softmax_grad)
    from paddle_tpu_torch.kernels.bshd_attention import bshd_attn
    from paddle_tpu_torch.kernels.smalls_attention import \
        SmallsAttentionFunction
    seq = q.shape[1]
    scale = D ** -0.5
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    mask32 = mask.float()

    def heads_first(x):              # the model's transpose op: a copy
        return x.transpose(1, 2).contiguous()

    def bshd():
        out = bshd_attn(*leaves, mask, True, scale)
        return torch.autograd.grad(out, leaves, do)

    def smalls_transposed():
        qt, kt, vt = (heads_first(x) for x in leaves)
        out, _ = SmallsAttentionFunction.apply(qt, kt, vt, mask32, True,
                                               scale)
        grads = torch.autograd.grad(heads_first(out), leaves, do)
        return [x.contiguous() for x in grads]

    row = (mask32 - 1.0) * 1e9
    tri = torch.triu(torch.full((1, seq, seq), -1e9, device=q.device), 1)

    def composed_transposed():
        qt, kt, vt = (heads_first(x) for x in (q, k, v))
        p = bias_softmax(torch.matmul(qt, kt.transpose(-1, -2)) * scale,
                         row, tri)
        heads_first(torch.matmul(p, vt))            # the forward's output
        dot = heads_first(do)
        dv = torch.matmul(p.transpose(-1, -2), dot)
        ds = bias_softmax_grad(p, torch.matmul(dot, vt.transpose(-1, -2)))
        dq = torch.matmul(ds, kt) * scale
        dk = torch.matmul(ds.transpose(-1, -2), qt) * scale
        return [heads_first(x) for x in (dq, dk, dv)]

    def sdpa():
        out = F.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in leaves), is_causal=True,
            scale=scale).transpose(1, 2)
        return torch.autograd.grad(out, leaves, do)

    return {"bshd": bshd, "smalls_transposed": smalls_transposed,
            "composed_transposed": composed_transposed, "sdpa": sdpa}


def compare_routes(table):
    """Each route's grads against SDPA's: max abs error, within the
    original's backward limit (they compute one function)."""
    want = table["sdpa"]()
    errs = {}
    for name, step in table.items():
        got = step()
        errs[name] = max(float((a.float() - b.float()).abs().max())
                         for a, b in zip(got, want))
        if not errs[name] < BWD_LIMIT:
            raise AssertionError(f"route {name}: grads {errs[name]} from "
                                 f"SDPA's (limit {BWD_LIMIT})")
    return errs


def time_routes(table, iters=ITERS):
    """``{name_ms, name_passes}``: forward + backward of each route, in
    two passes in opposite order."""
    order = list(table)
    passes = {n: [] for n in order}
    for names in (order, order[::-1]):
        for n in names:
            passes[n].append(time_ms(table[n], iters))
    row = {}
    for n in order:
        row[f"{n}_ms"] = sum(passes[n]) / 2
        row[f"{n}_passes"] = passes[n]
    return row


def main():
    try:
        import torch
    except ImportError:
        print("exp_torch_bshd_attn: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("exp_torch_bshd_attn: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.kernels.bshd_attention import (bshd_attention_bwd,
                                                         bshd_attention_fwd)
    from paddle_tpu_torch.kernels.smalls_attention import (
        smalls_attention_bwd, smalls_attention_fwd)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"# card: {card}; torch {torch.__version__}", file=sys.stderr)
    build.build_all()
    check_numerics()

    q, k, v, do, mask = make_inputs(torch.Generator().manual_seed(SEED + 1))
    table = routes(q, k, v, do, mask)
    row = {"card": card, "B": B, "S": S, "H": H, "D": D,
           "dtype": "bfloat16", "case": "causal, all-ones key mask",
           "grad_err_vs_sdpa": compare_routes(table)}
    row.update(time_routes(table))
    scale = D ** -0.5
    out, res = bshd_attention_fwd(q, k, v, mask, True, scale)
    row["bshd_fwd_ms"] = time_ms(
        lambda: bshd_attention_fwd(q, k, v, mask, True, scale))
    row["bshd_bwd_ms"] = time_ms(
        lambda: bshd_attention_bwd(q, k, v, mask, out, res, do, True, scale))
    # the [B, H, S, D] pair alone on copies made once: what of the gap
    # between the two fused routes is the kernels' layout, not the copies
    hq, hk, hv, hdo = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    mask32 = mask.float()
    hout, lse = smalls_attention_fwd(hq, hk, hv, mask32, True, scale)
    row["smalls_fwd_ms"] = time_ms(
        lambda: smalls_attention_fwd(hq, hk, hv, mask32, True, scale))
    row["smalls_bwd_ms"] = time_ms(
        lambda: smalls_attention_bwd(hq, hk, hv, mask32, hout, lse, hdo,
                                     True, scale))
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
