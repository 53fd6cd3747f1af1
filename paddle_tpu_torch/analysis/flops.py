"""Matrix-product FLOPs of a program, read from its IR (the port's copy
of ``program_matmul_flops``, ``bench_resnet.py:32-51``): the convnet MFU
convention counts the convolutions and fully connected layers only."""

from __future__ import annotations

import numpy as np

__all__ = ["program_matmul_flops"]


def program_matmul_flops(block):
    """Forward FLOPs of one pass: sum over conv2d (2*N*Ho*Wo*Co*Ci*kh*kw)
    and mul/matmul (2*M*K*N) ops, from the IR's inferred var shapes.  A
    training step is about 3 times that (the filter and input grads each
    cost about one forward product)."""
    flops = 0
    for op in block.ops:
        if op.type in ("conv2d", "depthwise_conv2d"):
            filt = block.var(op.input("Filter")[0])
            out = block.var(op.output("Output")[0])
            # filter is [Co, Ci/groups, kh, kw]: ci is already the
            # per-group fan-in
            co, ci, kh, kw = filt.shape
            n, _, ho, wo = out.shape
            flops += 2 * n * ho * wo * co * ci * kh * kw
        elif op.type in ("mul", "matmul"):
            x = block.var(op.input("X")[0])
            y = block.var(op.input("Y")[0])
            k, n = y.shape[-2], y.shape[-1]
            m = int(np.prod(x.shape)) // k
            flops += 2 * m * k * n
    return flops
