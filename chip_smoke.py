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
   serving path's shapes (plus one larger shape each), float32 at
   ``atol = rtol = 1e-5`` (the two sum in different orders), with each
   kernel's time beside its plain version's, one PyTorch library call's
   and the least time the card could take (its bound).
3. Serving: export a seeded ``GenLongConfig`` bundle with the port, load
   ``GenPredictor`` on ``cuda:0`` and serve requests through
   ``GenScheduler`` (continuous batching, paged KV decode).  Every stream
   must complete, the scheduler must never crash, every greedy stream
   must be token-identical to the port's own cache-free re-prefill, and
   both kernels' launch counts over the run must equal what the run's
   prefills and decode steps imply.
4. Report: a ``{"kernels": [...]}`` line, the card's name and power
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
#: bfloat16 output: one bf16 rounding (2**-8 relative) either way
BF16_TOL = 8e-3
#: H100 SXM peaks from NVIDIA's data sheet: HBM bytes/s and float32
#: (non-tensor-core) operations/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

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


def bound_ms(nbytes, nops):
    """Least time for the work: bytes over HBM rate vs operations over
    the float32 rate, the larger; returns ``(ms, "bytes"|"operations")``."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = nops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def max_err(got, want):
    return float((got.float() - want.float()).abs().max().item())


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


def phase_softmax():
    import torch
    from paddle_tpu_torch.kernels.bias_softmax import (
        bias_softmax, bias_softmax_reference)
    g = torch.Generator().manual_seed(SEED)
    worst = 0.0
    cases = []
    for T in (8, 16, 32, 64, 128, 256):
        x = torch.randn(1, 2, T, T, generator=g).cuda()
        tri = prefill_bias(T, max(1, T - 3)).cuda()
        cases.append((f"[1,2,{T},{T}] causal", x, None, tri, F32_TOL))
    x = torch.randn(8, 8, 256, 256, generator=g).cuda()
    rb = torch.where(torch.rand(8, 256, generator=g) < 0.2,
                     torch.tensor(-1e9), torch.tensor(0.0)).cuda()
    cases.append(("[8,8,256,256] row", x, rb, None, F32_TOL))
    cases.append(("[8,8,256,256] row bf16", x.bfloat16(), rb, None,
                  BF16_TOL))
    for label, x, rb, tb, tol in cases:
        got = bias_softmax(x, rb, tb)
        torch.cuda.synchronize()
        want = bias_softmax_reference(x, rb, tb)
        err = max_err(got, want)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
        if tol == F32_TOL:
            worst = max(worst, err)
        log(f"bias_softmax {label}: max_abs_err={err:.3e}")

    rows = {}
    for label, x, rb, tb in (("serving", cases[5][1], None, cases[5][3]),
                             ("8x8x256x256", cases[6][1], cases[6][2],
                              None)):
        bias4 = (tb[:, None] if tb is not None else rb[:, None, None, :])
        ms = time_ms(lambda: bias_softmax(x, rb, tb))
        plain = time_ms(lambda: bias_softmax_reference(x, rb, tb))
        lib = time_ms(lambda: torch.softmax(x + bias4, dim=-1))
        bias = tb if tb is not None else rb
        b, by = bound_ms(4 * (2 * x.numel() + bias.numel()), 6 * x.numel())
        log(f"bias_softmax[{label}] kernel_ms={ms:.5f} plain_ms={plain:.5f}"
            f" library_ms={lib:.5f} bound_ms={b:.6f} ({by})")
        rows[label] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                           bound_ms=b, bound_by=by)
    return worst, rows


# ---------------------------------------------------------------------------
# phase 3: serving through the port's entry points
# ---------------------------------------------------------------------------

def phase_serving():
    import numpy as np
    import torch
    from paddle_tpu_torch.gen import GenPredictor, GenScheduler
    from paddle_tpu_torch.kernels import BIAS_SOFTMAX, PAGED_DECODE
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
    BIAS_SOFTMAX.launches = 0
    PAGED_DECODE.launches = 0
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
    if prefills != len(prompts) or steps <= 0 or launches != want:
        raise AssertionError(
            f"serving: launches {launches} != expected {want} "
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

    from paddle_tpu_torch.kernels import BIAS_SOFTMAX, PAGED_DECODE
    paged_err, paged_rows = phase_paged()
    sm_err, sm_rows = phase_softmax()
    launches, serving = phase_serving()

    kernels = []
    for k, err, rows in ((BIAS_SOFTMAX, sm_err, sm_rows),
                         (PAGED_DECODE, paged_err, paged_rows)):
        r = rows["serving"]
        kernels.append({
            "name": k.name, "route": "cuda",
            "source": f"paddle_tpu_torch/kernels/csrc/{k.source}",
            "replaces": k.replaces, "launches": launches[k.name],
            "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "phase": "ok"})
    log(f"serving: tokens_per_s={serving['tokens_per_s']:.1f} "
        f"decode_step_ms={serving['decode_step_ms']:.3f}")
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
