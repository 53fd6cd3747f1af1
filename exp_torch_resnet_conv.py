#!/usr/bin/env python3
"""Experiment: the hand-written 3x3 conv + folded batch norm + ReLU kernel
at ResNet-50's 3x3 shapes on an H100 (the port's counterpart of
``exp_resnet_conv.py``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 exp_torch_resnet_conv.py [--batch 256]

First the numerics, as ``check_numerics`` of the original does: the
kernel (``kernels/conv3x3.py``) against its plain version and against
cuDNN's float32 ``F.conv2d`` (TF32 off) on a small case, float32 and
bf16.  Then one JSON row a shape of ``SHAPES_3X3`` at the given batch in
bf16: milliseconds by CUDA events of the kernel and of cuDNN's
``F.conv2d`` followed by the same epilogue (scale, bias, ReLU, one cast)
in NCHW and in ``channels_last``, the bound (the products at the bf16
tensor-core peak, or x, w and out moved once at the HBM rate, the
larger) and each one's TFLOP/s.  Last, the two ``SHAPES_1X1`` as one
``torch.matmul`` each, the original's own yardstick of what the card's
matrix units give.  The card's name and power limit are printed first:
compare rows of one run only.

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
    for dtype in (torch.float32, torch.bfloat16):
        x, w, scale, bias = make_case(2, 14, 64, 64, dtype, g)
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
        print(f"# numerics [2, 14, 14, 64] -> 64 {str(dtype)[6:]}: "
              f"max |kernel - plain| {err_plain:.3e}, |kernel - cuDNN| "
              f"{err_lib:.3e}", file=sys.stderr)
        if not ok:
            raise AssertionError(f"conv3x3 {dtype}: the kernel disagrees "
                                 f"with its plain version")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=256)
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
    build.build_all(("conv3x3.cu",))
    g = torch.Generator().manual_seed(SEED)
    check_numerics(torch, g)

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
        for name, fmt in (("cudnn_nchw", torch.contiguous_format),
                          ("cudnn_channels_last", torch.channels_last)):
            run, _ = cudnn_conv(x, w, scale, bias, fmt)
            row[f"{name}_ms"] = time_ms(run, iters=20)
        for key in ("kernel", "cudnn_nchw", "cudnn_channels_last"):
            row[f"{key}_tflops"] = ops / row[f"{key}_ms"] / 1e9
        print(json.dumps(row), flush=True)
        del x, w
        torch.cuda.empty_cache()

    for H, C, Co in SHAPES_1X1:
        ops = 2 * N * H * H * C * Co
        a = torch.randn(N * H * H, C, generator=g).to(torch.bfloat16).cuda()
        b = (torch.randn(C, Co, generator=g) * 0.05).to(torch.bfloat16).cuda()
        ms = time_ms(lambda: torch.matmul(a, b), iters=20)
        print(json.dumps({"shape": f"{H}x{H}x{C}->{Co} 1x1", "batch": N,
                          "matmul_ms": ms,
                          "matmul_tflops": ops / ms / 1e9}), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
