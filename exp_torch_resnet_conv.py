#!/usr/bin/env python3
"""Experiment: the hand-written 3x3 conv + folded batch norm + ReLU kernel
at ResNet-50's 3x3 shapes on an H100 (the port's counterpart of
``exp_resnet_conv.py``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 exp_torch_resnet_conv.py [--batch 256]
        [--save DIR | --compare DIR | --kernel-only]

First the numerics, as ``check_numerics`` of the original does: the
kernel (``kernels/conv3x3.py``) against its plain version and against
cuDNN's float32 ``F.conv2d`` (TF32 off) on two small cases (Co = 64 and
128, the bf16 body's two block tiles), float32 and bf16.  Then one JSON
row a shape of ``SHAPES_3X3`` at the given batch in bf16: milliseconds
by CUDA events of the kernel and of cuDNN's ``F.conv2d`` followed by
the same epilogue (scale, bias, ReLU, one cast) in NCHW and in
``channels_last``, and alone in ``channels_last`` (``cudnn_alone``: the
bare convolution), the bound (the products at the bf16 tensor-core
peak, or x, w and out moved once at the HBM rate, the larger) and each
one's TFLOP/s.  Last, the two ``SHAPES_1X1`` as one
``torch.matmul`` each, the original's own yardstick of what the card's
matrix units give.  The card's name and power limit are printed first:
compare rows of one run only.

Two builds side by side (copy this script into the older checkout):
``--save DIR`` writes the kernel's outputs at the four 3x3 shapes (N =
``COMPARE_N``, float32 and bf16, ReLU on and off, inputs from one seed)
to ``DIR/conv3x3_outputs.pt``; ``--compare DIR`` computes them with this
build and fails unless every float32 output is the same bits as the
saved one and every bf16 output lies within one bf16 rounding of it
(``rtol = 2**-7`` plus ``2**-8`` times its RMS: each build rounds its
float32 sums once, and the two sum in different orders).  Time the
builds in turns, old / new / new / old.  ``--kernel-only`` times the
kernel alone at the four 3x3 shapes after the numerics, and prints the
registers ``nvcc -Xptxas -v`` reports: the quick reading for variants of
one build in patched copies.

It imports neither JAX nor the JAX package and exits non-zero without
CUDA.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20260416
# (H, C_in, C_out) of ResNet-50's stage-2..5 3x3 bodies, and its 1x1
# expand convs (exp_resnet_conv.py:36-38)
SHAPES_3X3 = [(56, 64, 64), (28, 128, 128), (14, 256, 256), (7, 512, 512)]
SHAPES_1X1 = [(56, 64, 256), (14, 256, 1024)]
HBM_BYTES_PER_S = 3.35e12
BF16_TC_OPS_PER_S = 989e12
#: the batch of the saved and compared outputs
COMPARE_N = 8


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


def make_case(N, H, C, Co, dtype, g):
    import torch
    x = torch.randn(N, H, H, C, generator=g).to(dtype).cuda()
    w = torch.randn(3, 3, C, Co, generator=g) * (2.0 / (9 * C)) ** 0.5
    scale = (torch.rand(Co, generator=g) + 0.5).cuda()
    bias = (torch.randn(Co, generator=g) * 0.1).cuda()
    return x, w.to(dtype).cuda(), scale, bias


def cudnn_conv(x, w, scale, bias, memory_format):
    """``F.conv2d`` on the NCHW views of x and w in ``memory_format``,
    then the kernel's epilogue: a closure for timing, and its output
    back in NHWC."""
    import torch
    import torch.nn.functional as F
    xn = x.permute(0, 3, 1, 2).contiguous(memory_format=memory_format)
    wn = w.permute(3, 2, 0, 1).contiguous(memory_format=memory_format)

    def run():
        acc = F.conv2d(xn, wn, padding=1).float()
        return torch.relu(acc * scale[:, None, None]
                          + bias[:, None, None]).to(x.dtype)
    return run, lambda out: out.permute(0, 2, 3, 1)


def check_numerics(torch, g):
    from paddle_tpu_torch.kernels.conv3x3 import (
        conv3x3_bn_act, conv3x3_bn_act_reference, f32_tolerance)
    for (H, C, Co), dtype in ((s, d) for s in ((14, 64, 64), (7, 128, 128))
                              for d in (torch.float32, torch.bfloat16)):
        x, w, scale, bias = make_case(2, H, C, Co, dtype, g)
        got = conv3x3_bn_act(x, w, scale, bias)
        plain = conv3x3_bn_act_reference(x, w, scale, bias)
        run, to_nhwc = cudnn_conv(x, w, scale, bias, torch.contiguous_format)
        lib = to_nhwc(run())
        err_plain = float((got.float() - plain.float()).abs().max())
        err_lib = float((got.float() - lib.float()).abs().max())
        if dtype == torch.float32:
            tol = f32_tolerance(x, w, scale)
            ok = bool(((got - plain).abs() <= tol).all())
        else:
            rms = float(plain.float().square().mean().sqrt())
            ok = bool(((got.float() - plain.float()).abs()
                       <= 2.0 ** -8 * rms + 2.0 ** -7
                       * plain.float().abs()).all())
        print(f"# numerics [2, {H}, {H}, {C}] -> {Co} {str(dtype)[6:]}: "
              f"max |kernel - plain| {err_plain:.3e}, |kernel - cuDNN| "
              f"{err_lib:.3e}", file=sys.stderr)
        if not ok:
            raise AssertionError(f"conv3x3 {dtype}: the kernel disagrees "
                                 f"with its plain version")


def build_outputs(torch):
    """``{key: output}`` of this build's kernel at the four 3x3 shapes, N
    = ``COMPARE_N``, float32 and bf16, ReLU on and off, on the CPU."""
    from paddle_tpu_torch.kernels.conv3x3 import conv3x3_bn_act
    g = torch.Generator().manual_seed(SEED + 1)
    outs = {}
    for H, C, Co in SHAPES_3X3:
        for dtype in (torch.float32, torch.bfloat16):
            x, w, scale, bias = make_case(COMPARE_N, H, C, Co, dtype, g)
            for relu in (True, False):
                key = f"{H}x{H}x{C}->{Co} {str(dtype)[6:]} relu={relu}"
                outs[key] = conv3x3_bn_act(x, w, scale, bias, relu).cpu()
    return outs


def compare_outputs(torch, saved, outs):
    """Print each output's agreement with the saved build's; return the
    keys that break the rule (float32 the same bits, bf16 one
    rounding)."""
    bad = []
    for key, want in saved.items():
        got = outs[key]
        w = want.float()
        diff = float((got.float() - w).abs().max())
        if got.dtype == torch.float32:
            ok = torch.equal(got, want)
        else:
            rms = float(w.square().mean().sqrt())
            ok = bool(((got.float() - w).abs()
                       <= 2.0 ** -8 * rms + 2.0 ** -7 * w.abs()).all())
        same = torch.equal(got, want)
        print(f"# {key}: {'same bits' if same else 'differs'}, max "
              f"{diff:.3e}{'' if ok else ' BREAKS THE RULE'}",
              file=sys.stderr)
        if not ok:
            bad.append(key)
    print(json.dumps({"compared": len(saved), "breaking": bad}),
          flush=True)
    return bad


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--save", metavar="DIR",
                       help="save this build's outputs under DIR")
    group.add_argument("--compare", metavar="DIR",
                       help="hold this build's outputs against DIR's")
    group.add_argument("--kernel-only", action="store_true",
                       help="time the kernel alone")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("exp_torch_resnet_conv: CUDA is not available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from paddle_tpu_torch.kernels import build
    from paddle_tpu_torch.kernels.conv3x3 import conv3x3_bn_act
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"# card: {card}", file=sys.stderr)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    logs = build.build_all(("conv3x3.cu",))
    for line in "".join(logs.values()).splitlines():
        if "registers" in line or "spill" in line:
            print(f"# {line.strip()}", file=sys.stderr)
    g = torch.Generator().manual_seed(SEED)
    check_numerics(torch, g)
    bad = []
    if args.save or args.compare:
        outs = build_outputs(torch)
        if args.save:
            os.makedirs(args.save, exist_ok=True)
            torch.save(outs, os.path.join(args.save, "conv3x3_outputs.pt"))
        else:
            bad = compare_outputs(torch, torch.load(os.path.join(
                args.compare, "conv3x3_outputs.pt")), outs)
        del outs

    N = args.batch
    for H, C, Co in SHAPES_3X3:
        ops = 2 * N * H * H * C * Co * 9
        x, w, scale, bias = make_case(N, H, C, Co, torch.bfloat16, g)
        nbytes = 2 * (x.numel() + w.numel() + N * H * H * Co) + 8 * Co
        bound = max(ops / BF16_TC_OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
        row = {"shape": f"{H}x{H}x{C}->{Co} 3x3", "batch": N,
               "bound_ms": bound,
               "bound_by": "operations" if ops / BF16_TC_OPS_PER_S
               >= nbytes / HBM_BYTES_PER_S else "bytes"}
        row["kernel_ms"] = time_ms(lambda: conv3x3_bn_act(x, w, scale, bias),
                                   iters=10)
        if not args.kernel_only:
            for name, fmt in (("cudnn_nchw", torch.contiguous_format),
                              ("cudnn_channels_last", torch.channels_last)):
                run, _ = cudnn_conv(x, w, scale, bias, fmt)
                row[f"{name}_ms"] = time_ms(run, iters=20)
            xl, wl = (t.contiguous(memory_format=torch.channels_last)
                      for t in (x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)))
            row["cudnn_alone_ms"] = time_ms(
                lambda: torch.nn.functional.conv2d(xl, wl, padding=1),
                iters=20)
            del xl, wl
        for key in [k for k in row if k.endswith("_ms") and k != "bound_ms"]:
            row[f"{key[:-3]}_tflops"] = ops / row[key] / 1e9
        print(json.dumps(row), flush=True)
        del x, w
        torch.cuda.empty_cache()

    for H, C, Co in () if args.kernel_only else SHAPES_1X1:
        ops = 2 * N * H * H * C * Co
        a = torch.randn(N * H * H, C, generator=g).to(torch.bfloat16).cuda()
        b = (torch.randn(C, Co, generator=g) * 0.05).to(torch.bfloat16).cuda()
        ms = time_ms(lambda: torch.matmul(a, b), iters=20)
        print(json.dumps({"shape": f"{H}x{H}x{C}->{Co} 1x1", "batch": N,
                          "matmul_ms": ms,
                          "matmul_tflops": ops / ms / 1e9}), flush=True)
    print(card)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
