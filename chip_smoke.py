#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``paddle_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. Card and build: print the card's name and power limit, turn TF32 off
   for float32 matmuls and convolutions, and build every CUDA kernel of
   the port from ``paddle_tpu_torch/kernels/csrc`` with ``nvcc`` for
   ``sm_90a`` (one compiler process per source, all at once).
2. Kernels against their plain torch versions, on the card, at the
   shapes of the paths that run them (plus one larger shape for the
   serving kernels), with each kernel's time beside its plain version's,
   one PyTorch library call's where one computes the same function, and
   the least time the card could take (its bound).  float32 within
   ``atol = rtol = 1e-5`` (the two sum in different orders), bfloat16
   outputs within one bf16 rounding of themselves (``BF16_RTOL``, plus
   ``BF16_ATOL_SCALE`` times the output's RMS; see ``assert_matches``).
3. Serving: export a seeded ``GenLongConfig`` bundle with the port, load
   ``GenPredictor`` on ``cuda:0`` and serve requests through
   ``GenScheduler`` (continuous batching, paged KV decode).  Every stream
   must complete, the scheduler must never crash, every greedy stream
   must be token-identical to the port's own cache-free re-prefill, and
   both kernels' launch counts over the run must equal what the run's
   prefills and decode steps imply.
4. Training, route A (composed attention, the bias-softmax kernels) and
   route B (flash attention, the flash kernels): the Transformer-base
   step of ``bench.py`` at full width and depth (d_model 512, 8 heads,
   d_inner 2048, 6 + 6 layers, vocab 10000), bf16 AMP, Adam lr 1e-4,
   dropout 0.1, through ``transformer()``, ``Adam.minimize`` and
   ``Executor.run`` on ``cuda:0``, a few steps on one fixed batch.  The
   loss must be finite and fall, and each of the route's kernels must
   launch exactly 18 times a step (6 encoder self, 6 decoder self and 6
   cross attentions) while the other route's launch none.  Route A runs
   S = 256 at B = 64 (``bench.py`` runs B = 256; cut for this script's
   time limit), route B S = 2048 at B = 8 (the same 16384 tokens a step).
5. Card against CPU: one step of the same program at full width and
   depth 1 + 1, float32, TF32 off, dropout 0, from one scope, on the card
   (kernels) and on the CPU (their plain versions), for each route; the
   losses and every parameter's grad (its first Adam moment) must agree
   (``CARD_CPU_*``).
6. Report: a ``{"kernels": [...]}`` line, the card's name and power
   limit, and as the last line ``{"ok": true, "device": {...}}``.

It imports neither JAX nor the JAX package.  Exits non-zero when CUDA is
unavailable or the port is not beside it.  Writes its bundle and build
logs under ``runs/chip_smoke/``.
"""

import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "runs", "chip_smoke")

#: float32 tolerance of a kernel against its plain version: the kernel
#: and torch reduce in different orders
F32_TOL = 1e-5
#: bfloat16 output against its plain version: both compute in float32
#: from the same bf16 inputs and round once to bf16, so an element may
#: differ by one bf16 ulp of itself (at most 2**-7 of it) where the two
#: float32 values straddle a rounding boundary; ``BF16_ATOL_SCALE`` times
#: the output's RMS covers the float32 summation-order error of elements
#: near zero
BF16_RTOL = 2.0 ** -7
BF16_ATOL_SCALE = 2.0 ** -8
#: H100 SXM peaks from NVIDIA's data sheet: HBM bytes/s, float32
#: (non-tensor-core) operations/s and bf16 dense tensor-core operations/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12

SEED = 20260416
PAGE_LEN, NUM_SLOTS = 16, 8
PROMPT_LENS = (15, 16, 17, 31, 33, 48, 64, 100, 150, 199)
MAX_NEW_TOKENS = 32


def log(msg):
    print(msg, flush=True)


def card_line():
    """``name, power.limit`` as nvidia-smi prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=200, warmup=20):
    """Mean milliseconds per call of ``fn`` on the card: CUDA events
    around ``iters`` back-to-back calls after ``warmup`` calls (so small
    kernels include their launch cost, as the serving loop pays it)."""
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


def device_ms(fn, names, iters=10, warmup=2):
    """Mean device milliseconds a call of ``fn`` spends in each CUDA kernel
    whose name holds one of ``names`` (each must launch once a call), by
    ``torch.profiler`` over ``iters`` calls after ``warmup`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = dict.fromkeys(names, 0.0)
    seen = dict.fromkeys(names, 0)
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for n in names:
            if n in ev.name:
                us[n] += float(ev.time_range.end - ev.time_range.start)
                seen[n] += 1
    if any(seen[n] != iters for n in names):
        raise AssertionError(f"profiler saw launches {seen}, want {iters} "
                             f"each")
    return {n: us[n] / iters / 1e3 for n in names}


def bound_ms(nbytes, nops, ops_per_s=F32_OPS_PER_S):
    """Least time for the work: bytes over HBM rate vs operations over
    ``ops_per_s`` (float32 by default), the larger; returns
    ``(ms, "bytes"|"operations")``."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = nops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def max_err(got, want):
    return float((got.float() - want.float()).abs().max().item())


def assert_matches(got, want, what):
    """``got`` (a kernel's output) against ``want`` (its plain version's):
    float32 within ``F32_TOL``, bfloat16 within one rounding of itself
    (``BF16_RTOL`` and ``BF16_ATOL_SCALE``)."""
    import torch
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite output")
    g, w = got.float(), want.float()
    if got.dtype == torch.bfloat16:
        rms = float(w.square().mean().sqrt().item())
        tol = dict(atol=BF16_ATOL_SCALE * rms, rtol=BF16_RTOL)
    else:
        tol = dict(atol=F32_TOL, rtol=F32_TOL)
    torch.testing.assert_close(g, w, **tol, msg=lambda m: f"{what}: {m}")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def paged_case(S, H, D, PL, P, NP, lens, seed):
    import torch
    g = torch.Generator().manual_seed(seed)
    q = (torch.randn(S, H * D, generator=g) * 0.4).cuda()
    kc = (torch.randn(NP, PL, H * D, generator=g) * 0.4).cuda()
    vc = (torch.randn(NP, PL, H * D, generator=g) * 0.4).cuda()
    pt = torch.randperm(NP, generator=g)[:S * P].reshape(S, P)
    pt = pt.to(torch.int32).cuda()
    lens = torch.tensor(lens, dtype=torch.int32).reshape(S, 1).cuda()
    return q, kc, vc, pt, lens


def check_paged(S, H, D, PL, P, NP, lens, seed):
    """Kernel vs plain version on one case; returns (max_abs_err, args)."""
    import torch
    from paddle_tpu_torch.kernels.paged_decode import (
        paged_attention, paged_attention_reference)
    args = paged_case(S, H, D, PL, P, NP, lens, seed)
    scale = float(D) ** -0.5
    got = paged_attention(*args, H, scale)
    torch.cuda.synchronize()
    want = paged_attention_reference(*args, H, scale)
    live = args[4].reshape(-1) > 0
    if not torch.isfinite(got).all():
        raise AssertionError(f"paged_decode: non-finite output at S={S} "
                             f"H={H} D={D} P={P}")
    err = max_err(got[live], want[live]) if live.any() else 0.0
    torch.testing.assert_close(got[live], want[live], atol=F32_TOL,
                               rtol=F32_TOL)
    return err, args


def paged_bound(args, H):
    q, kc, vc, pt, lens = args
    S, HD = q.shape
    P = pt.shape[1]
    PL = kc.shape[1]
    rows = int(lens.clamp(max=P * PL).sum().item())
    nbytes = 4 * (q.numel() + 2 * rows * HD + pt.numel() + lens.numel()
                  + q.numel())
    nops = 4 * rows * HD            # q.k and p.v, multiply + add each
    return bound_ms(nbytes, nops)


def paged_library(args, H, scale):
    """One SDPA call over the slots' gathered pages (timing yardstick)."""
    import torch
    import torch.nn.functional as F
    q, kc, vc, pt, lens = args
    S, HD = q.shape
    D = HD // H
    P = pt.shape[1]
    NP, PL, _ = kc.shape
    T = P * PL
    kg = kc[pt.long()].reshape(S, T, H, D).permute(0, 2, 1, 3).contiguous()
    vg = vc[pt.long()].reshape(S, T, H, D).permute(0, 2, 1, 3).contiguous()
    qh = q.reshape(S, H, 1, D)
    mask = (torch.arange(T, device=q.device).reshape(1, T)
            < lens.reshape(S, 1)).reshape(S, 1, 1, T)
    return lambda: F.scaled_dot_product_attention(qh, kg, vg,
                                                  attn_mask=mask,
                                                  scale=scale)


def phase_paged():
    import torch
    from paddle_tpu_torch.kernels.paged_decode import (
        paged_attention, paged_attention_reference)
    S, H, D, PL, NP = NUM_SLOTS, 2, 16, PAGE_LEN, 128
    worst = 0.0
    for P in (1, 2, 4, 8, 16):
        full = P * PL
        lens = [min(n, full) for n in
                (0, 1, PL, 2 * PL, full, full - 1, PL + 1, full // 2)]
        err, args = check_paged(S, H, D, PL, P, NP, lens, SEED + P)
        worst = max(worst, err)
        log(f"paged_decode S={S} H={H} D={D} PL={PL} NP={NP} P={P} "
            f"lens={lens}: max_abs_err={err:.3e}")
    main_args = args                      # P = 16, the longest bucket
    err, big = check_paged(32, 8, 128, 16, 16, 512,
                           [int(x) for x in torch.randint(
                               0, 257, (32,), generator=torch.Generator()
                               .manual_seed(SEED)).tolist()], SEED + 99)
    worst = max(worst, err)
    log(f"paged_decode S=32 H=8 D=128 PL=16 NP=512 P=16: "
        f"max_abs_err={err:.3e}")

    rows = {}
    for label, a, h, d in (("serving", main_args, H, D),
                           ("S32_H8_D128", big, 8, 128)):
        scale = float(d) ** -0.5
        ms = time_ms(lambda: paged_attention(*a, h, scale))
        plain = time_ms(lambda: paged_attention_reference(*a, h, scale))
        lib = time_ms(paged_library(a, h, scale))
        b, by = paged_bound(a, h)
        log(f"paged_decode[{label}] kernel_ms={ms:.5f} plain_ms={plain:.5f}"
            f" library_ms={lib:.5f} bound_ms={b:.6f} ({by})")
        rows[label] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                           bound_ms=b, bound_by=by)
    return worst, rows


def prefill_bias(T, p):
    """The predictor's combined causal + padding plane for a prompt of
    ``p`` tokens in bucket ``T``, as [1, T, T]."""
    import torch
    tri = torch.triu(torch.full((T, T), -1e9), 1)
    mask = (torch.arange(T) < p).float()
    return (tri + (mask * 1e9 - 1e9)[None, :]).reshape(1, T, T)


# the training slice's kernel shapes (bench.py's Transformer-base)
TRAIN_HEADS, TRAIN_D = 8, 64
ROUTE_A_B, ROUTE_A_S = 64, 256
ROUTE_B_B, ROUTE_B_S = 8, 2048


def phase_softmax():
    """The bias-softmax forward against its plain version: the serving
    prefill's causal planes ``[1, 2, T, T]`` in float32, and route A's
    scores ``[64, 8, 256, 256]`` with a ``[64, 256]`` row bias (encoder
    self and cross attention) and with the decoder's ``[1, 256, 256]``
    causal plane, each in bfloat16 (what AMP hands it) and float32."""
    import torch
    from paddle_tpu_torch.kernels.bias_softmax import (
        bias_softmax, bias_softmax_reference)
    g = torch.Generator().manual_seed(SEED)
    cases = {}
    for T in (8, 16, 32, 64, 128, 256):
        x = torch.randn(1, 2, T, T, generator=g).cuda()
        cases[f"serving [1,2,{T},{T}] causal float32"] = (
            x, None, prefill_bias(T, max(1, T - 3)).cuda())
    S = ROUTE_A_S
    shape = [ROUTE_A_B, TRAIN_HEADS, S, S]
    x = torch.randn(shape, generator=g).cuda()
    pad = torch.rand(ROUTE_A_B, S, generator=g) < 0.2
    pad[0] = True                           # a row with every key masked
    row = torch.where(pad, -1e9, 0.0).cuda()
    tri = torch.triu(torch.full((S, S), -1e9), 1).reshape(1, S, S).cuda()
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype)[6:]
        cases[f"route A {shape} row {tag}"] = (x.to(dtype), row, None)
        cases[f"route A {shape} causal {tag}"] = (x.to(dtype), None, tri)
    worst = 0.0
    for label, (x, rb, tb) in cases.items():
        got = bias_softmax(x, rb, tb)
        torch.cuda.synchronize()
        want = bias_softmax_reference(x, rb, tb)
        err = max_err(got, want)
        assert_matches(got, want, f"bias_softmax {label}")
        worst = max(worst, err)
        log(f"bias_softmax {label}: max_abs_err={err:.3e}")

    rows = {}
    for label, key in (
            ("serving", "serving [1,2,256,256] causal float32"),
            ("route A row", f"route A {shape} row bfloat16"),
            ("route A causal", f"route A {shape} causal bfloat16")):
        x, rb, tb = cases[key]
        bias = tb if tb is not None else rb
        bias4 = tb[:, None] if tb is not None else rb[:, None, None, :]
        bias4 = bias4.to(x.dtype)
        big = x.numel() > 1 << 20
        it = dict(iters=50, warmup=5) if big else {}
        ms = time_ms(lambda: bias_softmax(x, rb, tb), **it)
        plain = time_ms(lambda: bias_softmax_reference(x, rb, tb), **it)
        lib = time_ms(lambda: torch.softmax(x + bias4, dim=-1), **it)
        b, by = bound_ms(2 * _dtype_bytes(x) + _dtype_bytes(bias),
                         6 * x.numel())
        log(f"bias_softmax[{label}, {key}] kernel_ms={ms:.5f} "
            f"plain_ms={plain:.5f} library_ms={lib:.5f} "
            f"(softmax(x + bias) in x's dtype) bound_ms={b:.6f} ({by})")
        rows[label] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                           bound_ms=b, bound_by=by)
    return worst, rows


def _dtype_bytes(t):
    return t.element_size() * t.numel()


def phase_softmax_grad():
    """The bias-softmax backward at route A's scores [64, 8, 256, 256]:
    y and dy bf16 (what AMP hands it), bf16 y with a float32 dy, and
    float32."""
    import torch
    from paddle_tpu_torch.kernels.bias_softmax import (
        bias_softmax_grad, bias_softmax_grad_reference)
    g = torch.Generator().manual_seed(SEED + 1)
    shape = (ROUTE_A_B, TRAIN_HEADS, ROUTE_A_S, ROUTE_A_S)
    y = torch.softmax(torch.randn(shape, generator=g), -1).cuda()
    dy = torch.randn(shape, generator=g).cuda()
    worst = 0.0
    cases = [("bf16 y, bf16 dy", y.bfloat16(), dy.bfloat16()),
             ("bf16 y, f32 dy", y.bfloat16(), dy),
             ("f32 y, f32 dy", y, dy)]
    for label, yy, dd in cases:
        got = bias_softmax_grad(yy, dd)
        torch.cuda.synchronize()
        want = bias_softmax_grad_reference(yy, dd)
        err = max_err(got, want)
        assert_matches(got, want, f"bias_softmax_grad {label}")
        worst = max(worst, err)
        log(f"bias_softmax_grad {list(shape)} {label}: max_abs_err={err:.3e}")
    _, yy, dd = cases[0]                          # what route A runs
    ms = time_ms(lambda: bias_softmax_grad(yy, dd), iters=50, warmup=5)
    plain = time_ms(lambda: bias_softmax_grad_reference(yy, dd), iters=20,
                    warmup=3)
    lib = time_ms(lambda: torch.ops.aten._softmax_backward_data(
        dd, yy, -1, yy.dtype), iters=50, warmup=5)
    b, by = bound_ms(3 * _dtype_bytes(yy), 3 * yy.numel())
    log(f"bias_softmax_grad[route A, bf16] kernel_ms={ms:.5f} "
        f"plain_ms={plain:.5f} library_ms={lib:.5f} "
        f"(aten._softmax_backward_data) bound_ms={b:.6f} ({by})")
    return worst, dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b,
                       bound_by=by)


def _pairs(Sq, Sk, causal):
    """(query, key) pairs the masks leave to compute."""
    if not causal:
        return Sq * Sk
    return sum(min(r + 1, Sk) for r in range(Sq))


def phase_flash():
    """The three flash kernels against their plain versions: small ragged
    and cross-attention shapes, then route B's attention
    [8, 8, 2048, 2048, 64], causal (decoder self) and key-masked (encoder
    self, cross), each in f32 and bf16; then route B's bf16 times (the
    backward kernels' by device time, as the wrapper launches both).
    The bound counts the products the masks leave (causal: the lower
    triangle) at the bf16 tensor-core peak, and each input read and
    output written once."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_reference,
        flash_attention_dkdv_reference, flash_attention_dq_reference,
        flash_attention_fwd, flash_attention_fwd_reference)
    g = torch.Generator().manual_seed(SEED + 2)

    def case(B, H, Sq, Sk, D, Dv, dtype, masked):
        q = (torch.randn(B, H, Sq, D, generator=g) * 0.5).to(dtype).cuda()
        k = (torch.randn(B, H, Sk, D, generator=g) * 0.5).to(dtype).cuda()
        v = (torch.randn(B, H, Sk, Dv, generator=g) * 0.5).to(dtype).cuda()
        do = torch.randn(B, H, Sq, Dv, generator=g).to(dtype).cuda()
        mask = None
        if masked:
            mask = (torch.rand(B, Sk, generator=g) > 0.2).float()
            mask[0] = 0.0                 # a row with every key masked
            mask = mask.cuda()
        return q, k, v, mask, do

    worst = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkdv": 0.0}
    small = [((2, 2, 100, 100, 64, 64), True), ((1, 2, 96, 48, 16, 16), False),
             ((1, 1, 37, 130, 128, 96), False)]
    big = (ROUTE_B_B, TRAIN_HEADS, ROUTE_B_S, ROUTE_B_S, TRAIN_D, TRAIN_D)
    for shape, causal in small + [(big, True), (big, False)]:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, mask, do = case(*shape, dtype, masked=not causal)
            scale = shape[4] ** -0.5
            out, lse = flash_attention_fwd(q, k, v, mask, causal, scale)
            dq, dk, dv = flash_attention_bwd(q, k, v, mask, out, lse, do,
                                             causal, scale)
            torch.cuda.synchronize()
            ro, rl = flash_attention_fwd_reference(q, k, v, mask, causal,
                                                   scale)
            rq, rk, rv = flash_attention_bwd_reference(q, k, v, mask, out,
                                                       lse, do, causal,
                                                       scale)
            errs = {"flash_fwd": max(max_err(out, ro), max_err(lse, rl)),
                    "flash_dq": max_err(dq, rq),
                    "flash_dkdv": max(max_err(dk, rk), max_err(dv, rv))}
            what = (f"flash {list(shape)} {str(dtype)[6:]} "
                    f"{'causal' if causal else 'key-masked'}")
            for n, a, b in (("out", out, ro), ("dq", dq, rq), ("dk", dk, rk),
                            ("dv", dv, rv)):
                assert_matches(a, b, f"{what} {n}")
            torch.testing.assert_close(lse, rl, atol=F32_TOL, rtol=1e-6)
            for n, e in errs.items():
                worst[n] = max(worst[n], e)
            log(f"{what}: " + " ".join(f"{n}={e:.3e}"
                                      for n, e in errs.items()))
            del q, k, v, do, out, lse, dq, dk, dv, ro, rl, rq, rk, rv
            torch.cuda.empty_cache()

    rows = {}
    B, H, S, _, D, _ = big
    for label, causal in (("causal", True), ("key-masked", False)):
        q, k, v, mask, do = case(B, H, S, S, D, D, torch.bfloat16,
                                 masked=not causal)
        if mask is not None:
            mask.fill_(1.0)           # the encoder's all-ones fake_batch mask
        scale = D ** -0.5
        out, lse = flash_attention_fwd(q, k, v, mask, causal, scale)
        pairs = B * H * _pairs(S, S, causal)
        el = 2                                    # bf16 bytes
        mask_bytes = 0 if mask is None else 4 * B * S
        io_fwd = el * 4 * B * H * S * D + 4 * B * H * S * 2 + mask_bytes
        io_bwd = el * 4 * B * H * S * D + 4 * B * H * S * 3 + mask_bytes
        ops = {"flash_fwd": pairs * 2 * (D + D),
               "flash_dq": pairs * (4 * D + 2 * D),
               "flash_dkdv": pairs * (4 * D + 4 * D)}
        nbytes = {"flash_fwd": io_fwd, "flash_dq": io_bwd + el * B * H * S * D,
                  "flash_dkdv": io_bwd + 2 * el * B * H * S * D}
        t_fwd = time_ms(lambda: flash_attention_fwd(q, k, v, mask, causal,
                                                    scale), iters=10,
                        warmup=2)
        bwd_args = (q, k, v, mask, out, lse, do, causal, scale)
        t_bwd = time_ms(lambda: flash_attention_bwd(*bwd_args), iters=10,
                        warmup=2)
        # the wrapper launches both backward kernels: each one's device time
        dev = device_ms(lambda: flash_attention_bwd(*bwd_args),
                        ("flash_dq_kernel", "flash_dkdv_kernel"))
        t_dq, t_dkdv = dev["flash_dq_kernel"], dev["flash_dkdv_kernel"]
        p_fwd = time_ms(lambda: flash_attention_fwd_reference(
            q, k, v, mask, causal, scale), iters=3, warmup=1)
        p_dq = time_ms(lambda: flash_attention_dq_reference(*bwd_args),
                       iters=3, warmup=1)
        p_dkdv = time_ms(lambda: flash_attention_dkdv_reference(*bwd_args),
                         iters=3, warmup=1)
        attn_mask = None if mask is None else \
            (mask > 0.5)[:, None, None, :].expand(B, 1, S, S)
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, is_causal=causal, scale=scale),
            iters=10, warmup=2)
        ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
        ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=attn_mask,
                                            is_causal=causal, scale=scale)
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            ol, (ql, kl, vl), do, retain_graph=True), iters=10, warmup=2)
        for n, ms, pl, lib in (("flash_fwd", t_fwd, p_fwd, lib_fwd),
                               ("flash_dq", t_dq, p_dq, None),
                               ("flash_dkdv", t_dkdv, p_dkdv, None)):
            b, by = bound_ms(nbytes[n], ops[n], BF16_TC_OPS_PER_S)
            rows[(n, label)] = dict(ms=ms, plain_ms=pl, library_ms=lib,
                                    bound_ms=b, bound_by=by)
            log(f"{n}[route B {label}, bf16 {[B, H, S, S, D]}] "
                f"kernel_ms={ms:.5f} plain_ms={pl:.5f} library_ms="
                f"{'none' if lib is None else f'{lib:.5f}'} "
                f"bound_ms={b:.6f} ({by})")
        log(f"flash backward[route B {label}] wrapper (delta + dq + dkdv) "
            f"{t_bwd:.5f} ms by CUDA events, of which dq {t_dq:.5f} and dkdv "
            f"{t_dkdv:.5f} ms device time (torch.profiler); one PyTorch call "
            f"computing dq, dk and dv (SDPA's backward) {lib_bwd:.5f} ms")
        del q, k, v, do, out, lse, ql, kl, vl, ol
        torch.cuda.empty_cache()
    return worst, rows


# ---------------------------------------------------------------------------
# phase 4: training through the port's entry points
# ---------------------------------------------------------------------------

TRAIN_STEPS = 5
#: per route: (batch, sequence length, kernels that must launch 18 a step)
ROUTES = {"A": (ROUTE_A_B, ROUTE_A_S, ("bias_softmax", "bias_softmax_grad")),
          "B": (ROUTE_B_B, ROUTE_B_S, ("flash_fwd", "flash_dq",
                                       "flash_dkdv"))}


def _transformer_program(pt, T, hp, B, S, amp):
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = SEED
    with pt.program_guard(main, startup):
        cost, _ = T.transformer(B, S, S, hp)
        pt.optimizer.Adam(learning_rate=1e-4).minimize(cost)
    main.amp = amp
    return main, startup, cost


def phase_train(route):
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import ALL_KERNELS
    from paddle_tpu_torch.models import transformer as T

    B, S, kernels = ROUTES[route]
    hp = T.ModelHyperParams()          # Transformer-base, dropout 0.1
    hp.max_length = max(hp.max_length, S)
    main, startup, cost = _transformer_program(pt, T, hp, B, S, amp=True)
    types = [op.type for op in main.global_block().ops]
    log(f"train[{route}]: B={B} S={S} ops={len(types)} "
        f"sdpa={types.count('scaled_dot_product_attention')} "
        f"softmax={types.count('softmax')} params="
        f"{len(main.global_block().all_parameters())} "
        f"adam={types.count('adam')}")
    scope = pt.Scope()
    exe = pt.Executor()                # default place: cuda:0
    if exe.device.type != "cuda":
        raise AssertionError(f"Executor landed on {exe.device}")
    exe.run(startup, scope=scope)
    feed = T.fake_batch(B, S, S, hp, seed=SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for kern in ALL_KERNELS:
        kern.launches = 0
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        (loss,) = exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
        step_s.append(time.perf_counter() - t)   # the fetch synchronizes
        losses.append(float(np.asarray(loss).reshape(())))
    launches = {kern.name: kern.launches for kern in ALL_KERNELS}

    want = {kern.name: (18 * TRAIN_STEPS if kern.name in kernels else 0)
            for kern in ALL_KERNELS}
    if launches != want:
        raise AssertionError(f"train[{route}]: launches {launches} != "
                             f"{want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train[{route}]: losses {losses} not finite "
                             f"and falling")
    steady = float(np.mean(step_s[1:]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tokens = B * S
    log(f"train[{route}]: losses {[round(x, 5) for x in losses]}; step s "
        f"{[round(x, 4) for x in step_s]}; steady {1e3 * steady:.2f} ms a "
        f"step = {tokens / steady:.1f} tokens/s ({tokens} target tokens a "
        f"step); peak memory {peak:.2f} GiB; launches {launches}")
    del scope, exe
    torch.cuda.empty_cache()
    return launches, dict(step_ms=1e3 * steady, tokens_per_s=tokens / steady,
                          losses=losses, peak_gib=peak)


#: card against CPU, one float32 step at full width and depth 1 + 1: the
#: loss agrees to ``CARD_CPU_LOSS_RTOL`` (cuBLAS and the CPU sum float32
#: products in different orders; TF32 is off), and every parameter's
#: grad, read as its first Adam moment (``(1 - beta1) * grad`` after one
#: step), agrees leaf by leaf as ``|card - cpu| / |cpu|`` (2-norms).
#: Summation order alone leaves leaves a few 1e-6 apart, so they are held
#: to ``CARD_CPU_GRAD_RTOL``.  A ReLU input within rounding of 0 passes
#: its grad on one side only and moves every leaf below it: the phase
#: counts such inputs, and where there is one (route A's batch has one in
#: the decoder's FFN, its leaves then lie up to about 3e-4 apart on an
#: H100) holds leaves to ``CARD_CPU_KINK_GRAD_RTOL``.  An attention grad
#: 1% off in one attention moves leaves by more than 5e-3 (see
#: ``test_leaf_grad_check_sees_one_wrong_attention`` in
#: ``tests/test_torch_train.py``).  The parameters themselves are not
#: held: an early Adam step moves each by about lr whatever its grad's
#: size, so they are reported only.
CARD_CPU_LOSS_RTOL = 1e-5
CARD_CPU_GRAD_RTOL = 2e-5
CARD_CPU_KINK_GRAD_RTOL = 1e-3
CARD_CPU = {"A": (2, ROUTE_A_S), "B": (1, ROUTE_B_S)}


def phase_card_vs_cpu(route):
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.convert import (persistable_names,
                                          scope_from_numpy, to_numpy)
    from paddle_tpu_torch.kernels import ALL_KERNELS
    from paddle_tpu_torch.models import transformer as T

    B, S = CARD_CPU[route]
    hp = T.ModelHyperParams()
    hp.n_layer, hp.dropout = 1, 0.0
    hp.max_length = max(hp.max_length, S)
    main, startup, cost = _transformer_program(pt, T, hp, B, S, amp=False)
    cpu_scope = pt.Scope()
    cpu = pt.Executor(pt.CPUPlace())
    cpu.run(startup, scope=cpu_scope)
    names = persistable_names(main)
    state = {n: to_numpy(cpu_scope.find_var(n)) for n in names}
    card_scope = scope_from_numpy(state, None, main)
    feed = T.fake_batch(B, S, S, hp, seed=SEED + 3)
    feed["src_mask"][-1, S // 2:] = 0.0         # a padded source row
    relu_in = [op.input("X")[0] for op in main.global_block().ops
               if op.type == "relu"]
    t = time.perf_counter()
    cpu_loss, *cpu_relu = cpu.run(main, feed=feed,
                                  fetch_list=[cost] + relu_in,
                                  scope=cpu_scope)
    cpu_s = time.perf_counter() - t
    for kern in ALL_KERNELS:
        kern.launches = 0
    card_loss, *card_relu = pt.Executor().run(
        main, feed=feed, fetch_list=[cost] + relu_in, scope=card_scope)
    launches = {k.name: k.launches for k in ALL_KERNELS if k.launches}
    if sorted(launches) != sorted(ROUTES[route][2]) or \
            any(n != 3 for n in launches.values()):
        raise AssertionError(f"card-vs-cpu[{route}]: launches {launches}")
    a, b = float(card_loss.reshape(())), float(cpu_loss.reshape(()))
    if not abs(a - b) <= CARD_CPU_LOSS_RTOL * abs(b):
        raise AssertionError(f"card-vs-cpu[{route}]: loss {a} vs {b}")
    moment1 = {op.input("Param")[0]: op.input("Moment1")[0]
               for op in main.global_block().ops if op.type == "adam"}
    trainable = {p.name for p in main.global_block().all_parameters()
                 if p.trainable}
    if set(moment1) != trainable:
        raise AssertionError(f"card-vs-cpu[{route}]: {len(moment1)} Adam "
                             f"ops for {len(trainable)} parameters")
    rel, param_max = {}, 0.0
    for p, m in moment1.items():
        want = to_numpy(cpu_scope.find_var(m)).astype(np.float64)
        got = to_numpy(card_scope.find_var(m)).astype(np.float64)
        norm = float(np.linalg.norm(want))
        if not norm > 0:
            raise AssertionError(f"card-vs-cpu[{route}]: {p} got no grad")
        rel[p] = float(np.linalg.norm(got - want)) / norm
        param_max = max(param_max, float(np.abs(
            to_numpy(card_scope.find_var(p)).astype(np.float64)
            - to_numpy(cpu_scope.find_var(p))).max()))
    worst = max(rel, key=rel.get)
    kinks = sum(int(((x > 0) != (y > 0)).sum())
                for x, y in zip(cpu_relu, card_relu))
    log(f"card-vs-cpu[{route}]: {kinks} of "
        f"{sum(x.size for x in cpu_relu)} ReLU inputs lie on different "
        f"sides of 0 on the card and the CPU")
    log(f"card-vs-cpu[{route}] B={B} S={S} 1+1 layers f32: loss card {a!r} "
        f"cpu {b!r} (rel {abs(a - b) / abs(b):.2e}); grads (first moments) "
        f"|card - cpu| / |cpu| worst {rel[worst]:.3e} ({worst}), median "
        f"{float(np.median(list(rel.values()))):.3e} over {len(rel)} "
        f"parameters; parameters max abs diff {param_max:.3e}; launches "
        f"{launches}; cpu step {cpu_s:.2f}s")
    bound = CARD_CPU_KINK_GRAD_RTOL if kinks else CARD_CPU_GRAD_RTOL
    if rel[worst] > bound:
        raise AssertionError(f"card-vs-cpu[{route}]: grad of {worst} "
                             f"differs by {rel[worst]} relative (bound "
                             f"{bound}, {kinks} ReLU inputs straddle 0)")
    torch.cuda.empty_cache()
    return dict(loss_rel=abs(a - b) / abs(b), grad_rel=rel[worst],
                param_max=param_max, relu_kinks=kinks)


# ---------------------------------------------------------------------------
# phase 3: serving through the port's entry points
# ---------------------------------------------------------------------------

def phase_serving():
    import numpy as np
    import torch
    from paddle_tpu_torch.gen import GenPredictor, GenScheduler
    from paddle_tpu_torch.kernels import (ALL_KERNELS, BIAS_SOFTMAX,
                                          PAGED_DECODE)
    from paddle_tpu_torch.models import gen_lm
    from paddle_tpu_torch.models.gen_lm_long import GenLongConfig

    hp = GenLongConfig()
    bundle = os.path.join(OUT_DIR, "gen_lm_long_bundle")
    t0 = time.perf_counter()
    gen_lm.export_gen_model(bundle, hp, num_slots=NUM_SLOTS,
                            page_len=PAGE_LEN, seed=SEED)
    pred = GenPredictor(bundle)           # default place: cuda:0
    if pred.device.type != "cuda":
        raise AssertionError(f"GenPredictor landed on {pred.device}")
    log(f"serving: exported and loaded GenLongConfig bundle in "
        f"{time.perf_counter() - t0:.2f}s (max_len={hp.max_len}, "
        f"slots={NUM_SLOTS}, page_len={PAGE_LEN}, "
        f"pages={pred.num_pages}, buckets={pred.page_buckets})")

    # warm the path once (first CUDA calls, library handles), outside
    # the counted run
    sched = GenScheduler(pred, queue_size=64)
    list(sched.submit([1, 2, 3], max_new_tokens=2))

    step_s = []
    decode = pred.decode_step

    def timed_decode(*a, **kw):
        t = time.perf_counter()
        out = decode(*a, **kw)
        step_s.append(time.perf_counter() - t)
        return out

    pred.decode_step = timed_decode
    rng = np.random.RandomState(SEED)
    prompts = [[int(t) for t in rng.randint(0, hp.vocab_size, n)]
               for n in PROMPT_LENS]

    pre0, dec0 = pred.prefills, pred.decode_steps
    for kern in ALL_KERNELS:
        kern.launches = 0
    t0 = time.perf_counter()
    streams = [sched.submit(p, max_new_tokens=MAX_NEW_TOKENS)
               for p in prompts]
    deadline = time.monotonic() + 300
    outs = []
    for st in streams:
        toks = []
        while True:
            ev = st.next_event(timeout=max(0.0, deadline - time.monotonic()))
            if ev is None:
                raise AssertionError("serving: a stream timed out")
            kind, value = ev
            if kind == "token":
                toks.append(value)
            elif kind == "done":
                break
            else:
                raise AssertionError(f"serving: stream failed: {value!r}")
        outs.append(toks)
    wall = time.perf_counter() - t0
    launches = {"bias_softmax": BIAS_SOFTMAX.launches,
                "paged_decode": PAGED_DECODE.launches}
    others = {k.name: k.launches for k in ALL_KERNELS
              if k.name not in launches and k.launches}
    prefills = pred.prefills - pre0
    steps = pred.decode_steps - dec0
    pred.decode_step = decode
    failed, crashes = sched.failed, sched.crashes
    sched.close()

    if failed is not None or crashes:
        raise AssertionError(f"serving: scheduler failed={failed!r} "
                             f"crashes={crashes}")
    bad = [st.error for st in streams if st.error is not None]
    if bad:
        raise AssertionError(f"serving: failed streams {bad!r}")
    if any(len(o) != MAX_NEW_TOKENS for o in outs):
        raise AssertionError(f"serving: token counts "
                             f"{[len(o) for o in outs]}")
    n_layer = int(hp.n_layer)
    want = {"bias_softmax": n_layer * prefills,
            "paged_decode": n_layer * steps}
    if prefills != len(prompts) or steps <= 0 or launches != want or \
            others:
        raise AssertionError(
            f"serving: launches {launches} (and {others}) != expected {want} "
            f"(prefills={prefills}, decode steps={steps})")
    tokens = sum(len(o) for o in outs)
    log(f"serving: {len(prompts)} requests, prompt lens {list(PROMPT_LENS)},"
        f" {tokens} tokens in {wall:.3f}s = {tokens / wall:.1f} tokens/s; "
        f"{steps} decode steps, mean step {1e3 * np.mean(step_s):.3f} ms "
        f"(median {1e3 * np.median(step_s):.3f} ms); launches {launches}")

    # acceptance: greedy streams equal the cache-free re-prefill
    for prompt, out in zip(prompts, outs):
        seq = list(prompt)
        for i, tok in enumerate(out):
            logits, _ = pred.prefill(seq)
            if logits.shape != (hp.vocab_size,) or \
                    not np.all(np.isfinite(logits)):
                raise AssertionError("serving: bad prefill logits")
            ref = int(np.argmax(logits))
            if ref != tok:
                raise AssertionError(
                    f"serving: prompt of {len(prompt)} diverges from the "
                    f"cache-free re-prefill at token {i}: {tok} != {ref}")
            seq.append(tok)
    log(f"serving: all {len(prompts)} streams token-identical to the "
        f"cache-free re-prefill (max total length "
        f"{max(len(p) for p in prompts) + MAX_NEW_TOKENS} of "
        f"{hp.max_len})")
    torch.cuda.synchronize()
    return launches, dict(tokens_per_s=tokens / wall,
                          decode_step_ms=1e3 * float(np.mean(step_s)))


# ---------------------------------------------------------------------------

def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from paddle_tpu_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port (paddle_tpu_torch) is not beside this "
              f"script: {e}", file=sys.stderr)
        return 2
    os.makedirs(OUT_DIR, exist_ok=True)

    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"build: {sorted(logs) or 'cached'} in "
        f"{time.perf_counter() - t0:.2f}s with {build.find_nvcc()}")
    with open(os.path.join(OUT_DIR, "build.log"), "w") as f:
        for src, text in logs.items():
            f.write(f"--- {src}\n{text}\n")
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

    # the flash gate stays at its default (512): route A (S = 256) takes
    # the composed attention, route B (S = 2048) the flash kernels
    os.environ.pop("PADDLE_TPU_FLASH_MIN_S", None)
    from paddle_tpu_torch.kernels import ALL_KERNELS
    errs, rows = {}, {}
    errs["paged_decode"], paged_rows = phase_paged()
    rows["paged_decode"] = paged_rows["serving"]
    errs["bias_softmax"], sm_rows = phase_softmax()
    # route A runs 12 row-bias (encoder self, cross) bias softmaxes a step
    # for 6 causal ones, and 90 of its 110 launches here: that is the row
    rows["bias_softmax"] = sm_rows["route A row"]
    errs["bias_softmax_grad"], rows["bias_softmax_grad"] = \
        phase_softmax_grad()
    flash_err, flash_rows = phase_flash()
    for name in ("flash_fwd", "flash_dq", "flash_dkdv"):
        errs[name] = flash_err[name]
        # route B runs 12 key-masked (encoder self, cross) attentions a
        # step for 6 causal ones: the key-masked shape is the table's row
        rows[name] = flash_rows[(name, "key-masked")]

    by_path = {}
    by_path["serving"], serving = phase_serving()
    train = {}
    for route in ("A", "B"):
        by_path[f"train_{route}"], train[route] = phase_train(route)
    checks = {route: phase_card_vs_cpu(route) for route in ("A", "B")}

    kernels = []
    for k in ALL_KERNELS:
        r = rows[k.name]
        paths = {p: n[k.name] for p, n in by_path.items()
                 if n.get(k.name)}
        kernels.append({
            "name": k.name, "route": "cuda",
            "source": f"paddle_tpu_torch/kernels/csrc/{k.source}",
            "replaces": k.replaces, "launches": sum(paths.values()),
            "launches_by_path": paths,
            "max_abs_err": errs[k.name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on a main "
                                 f"path")
    log(f"serving: tokens_per_s={serving['tokens_per_s']:.1f} "
        f"decode_step_ms={serving['decode_step_ms']:.3f}")
    for route, t in train.items():
        log(f"train[{route}]: step_ms={t['step_ms']:.2f} "
            f"tokens_per_s={t['tokens_per_s']:.1f} "
            f"peak_gib={t['peak_gib']:.2f}")
    for route, c in checks.items():
        log(f"card-vs-cpu[{route}]: loss_rel={c['loss_rel']:.3e} "
            f"grad_rel={c['grad_rel']:.3e} param_max={c['param_max']:.3e} "
            f"relu_kinks={c['relu_kinks']}")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        code = 1
    sys.exit(code)
