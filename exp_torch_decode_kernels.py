#!/usr/bin/env python3
"""Time the bias-softmax forward and the paged decode kernels alone on the
card, at ``chip_smoke.py``'s shapes:

    python3 exp_torch_decode_kernels.py [--rows-per-part 32 64 256]
        [--kernels softmax paged] [--out runs/decode_kernels.json]

Bias softmax: the serving prefill's ``[1, 2, 256, 256]`` float32 causal
plane, route A's ``[64, 8, 256, 256]`` bf16 scores with a row bias and
with a causal plane, a ragged ``[64, 8, 250, 250]`` bf16 row and route
B's ``[8, 8, 2048, 2048]`` bf16 causal scores.  Paged decode: serving
(8 slots, H 2, D 16, 16 pages of 16), 32 slots at H 8, D 128, and the
long cache (8 slots of 4096 rows, H 8, D 128), each with the
partitions of every ``--rows-per-part`` (default: the wrapper's).  Each
row prints CUDA-event milliseconds a wrapper call (back-to-back calls),
the kernels' device milliseconds (``torch.profiler``), the bound and the
body or partitions, and one PyTorch call's milliseconds where one
computes the same function.  Every output is checked against the plain
version first.

It runs in an older checkout too (copied there with ``chip_smoke.py``,
whose helpers it imports): a build without ``bias_softmax_body_of`` or
``ROWS_PER_PART`` times its one body.  Variants of a kernel's constants
are timed in patched copies of the tree."""

import argparse
import importlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def softmax_rows(torch, cs):
    bsm = importlib.import_module("paddle_tpu_torch.kernels.bias_softmax")
    g = torch.Generator().manual_seed(cs.SEED)
    body_of = getattr(bsm, "bias_softmax_body_of", None)
    cases = {}
    T = 256
    cases["serving [1,2,256,256] causal float32"] = (
        torch.randn(1, 2, T, T, generator=g).cuda(), None,
        cs.prefill_bias(T, T - 3).cuda())
    for Sk, form in ((256, "row"), (256, "causal"), (250, "row"),
                     (2048, "causal")):
        B = 8 if Sk == 2048 else 64
        x = torch.randn(B, 8, Sk, Sk, generator=g).to(torch.bfloat16).cuda()
        if form == "row":
            row = torch.where(torch.rand(B, Sk, generator=g) < 0.2, -1e9,
                              0.0).cuda()
            cases[f"[{B},8,{Sk},{Sk}] row bfloat16"] = (x, row, None)
        else:
            tri = torch.triu(torch.full((Sk, Sk), -1e9), 1)
            cases[f"[{B},8,{Sk},{Sk}] causal bfloat16"] = (
                x, None, tri.reshape(1, Sk, Sk).cuda())
    out = []
    for label, (x, rb, tb) in cases.items():
        cs.assert_matches(bsm.bias_softmax(x, rb, tb),
                          bsm.bias_softmax_reference(x, rb, tb), label)
        bias = tb if tb is not None else rb
        bias4 = (tb[:, None] if tb is not None
                 else rb[:, None, None, :]).to(x.dtype)
        it = dict(iters=50, warmup=5)
        call = (lambda x=x, rb=rb, tb=tb: bsm.bias_softmax(x, rb, tb))
        ms = cs.time_ms(call, **it)
        dev = cs.device_ms_sum(call, ("bias_softmax",))
        lib = cs.time_ms(lambda: torch.softmax(x + bias4, dim=-1), **it)
        b, by = cs.bound_ms(2 * cs._dtype_bytes(x) + cs._dtype_bytes(bias),
                            6 * x.numel())
        row = dict(kernel="bias_softmax", case=label, ms=ms, device_ms=dev,
                   library_ms=lib, bound_ms=b, bound_by=by,
                   body=list(body_of(x, rb, tb)) if body_of else None)
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def paged_rows(torch, cs, rows_per_part):
    pd = importlib.import_module("paddle_tpu_torch.kernels.paged_decode")
    takes_r = hasattr(pd, "ROWS_PER_PART")
    lc = cs.LONG_CACHE
    g = torch.Generator().manual_seed(cs.SEED)
    serving_lens = [0, 1, 16, 32, 256, 255, 17, 128]
    cases = {
        "serving S8_H2_D16": (dict(S=8, H=2, D=16, PL=16, P=16, NP=128),
                              serving_lens),
        "S32_H8_D128": (dict(S=32, H=8, D=128, PL=16, P=16, NP=512),
                        torch.randint(0, 257, (32,), generator=g).tolist()),
        "long_cache S8_H8_D128_T4096": (lc, [lc["P"] * lc["PL"]] * lc["S"]),
    }
    out = []
    for label, (c, lens) in cases.items():
        args = cs.paged_case(c["S"], c["H"], c["D"], c["PL"], c["P"],
                             c["NP"], lens, cs.SEED + c["P"])
        H, scale = c["H"], float(c["D"]) ** -0.5
        want = pd.paged_attention_reference(*args, H, scale)
        live = args[4].reshape(-1) > 0
        b, by = cs.paged_bound(args, H)
        lib = cs.time_ms(cs.paged_library(args, H, scale))
        for R in (rows_per_part if takes_r else [None]):
            if R is not None:
                # the wrapper reads its partition size at each call
                pd.ROWS_PER_PART = R
            got = pd.paged_attention(*args, H, scale)
            torch.testing.assert_close(got[live], want[live],
                                       atol=cs.F32_TOL, rtol=cs.F32_TOL)
            call = (lambda: pd.paged_attention(*args, H, scale))
            ms = cs.time_ms(call)
            dev = cs.device_ms_sum(call, ("paged_decode_kernel",
                                          "paged_merge_kernel"))
            row = dict(kernel="paged_decode", case=label, rows_per_part=R,
                       ms=ms, device_ms=dev, library_ms=lib, bound_ms=b,
                       bound_by=by)
            print(json.dumps(row), flush=True)
            out.append(row)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows-per-part", type=int, nargs="*", default=None,
                    help="paged decode partition sizes to time (default: "
                         "the wrapper's)")
    ap.add_argument("--kernels", nargs="*", default=["softmax", "paged"],
                    choices=["softmax", "paged"], help="what to time")
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("exp_torch_decode_kernels: CUDA is not available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import build
    pd = importlib.import_module("paddle_tpu_torch.kernels.paged_decode")
    print(f"card: {cs.card_line()}", flush=True)
    build.build_all(("bias_softmax.cu", "paged_decode.cu"))
    rpp = args.rows_per_part or [getattr(pd, "ROWS_PER_PART", None)]
    rows = []
    if "softmax" in args.kernels:
        rows += softmax_rows(torch, cs)
    if "paged" in args.kernels:
        rows += paged_rows(torch, cs, rpp)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": cs.card_line(), "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
