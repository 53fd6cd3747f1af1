"""The port's 3x3 conv + batch norm + ReLU kernel (``kernels/conv3x3.py``)
on the CPU, where its wrapper runs the plain torch version.

- The plain version matches the JAX package's Pallas ``_conv3x3_kernel``
  (``exp_resnet_conv.py``) run in interpret mode (``pl.pallas_call`` with
  ``interpret=True``, inside the test only), with relu on and off, float32
  and bfloat16, and H, W that are no multiple of the CUDA kernel's 8x8
  tile: float32 within ``F32_TOL`` (both sum 9 * C products in float32 in
  different orders), bfloat16 within one rounding of the output
  (``rtol = 2**-7`` plus ``2**-8`` times the output's RMS).  Among the
  cases are the edges the card's tensor-core body guards: rows of x that
  are no 16-byte pieces (C = 20, C = 3), Co = 72 (no multiple of the
  channel tile) and N = 3 at 7x7 (147 pixel rows, which span images and
  end inside one pixel tile).
- One bf16 rounding covers another order of the sums: the tensor-core
  body's order (per tap, 16-channel steps summed, then accumulated),
  emulated in float32, against the plain version at ResNet-50's first
  width, with the tolerance ``chip_smoke.py`` holds the card to.
- On an inference program of ResNet-50 (small images), the walk finds
  the sixteen 3x3 ``conv2d -> batch_norm -> relu`` chains, and the kernel
  on each chain's NHWC input, with the batch norm folded, gives the
  program's own ReLU output, within ``f32_tolerance`` (the conv's sums
  in another order) plus ``F32_TOL`` of the output (the folded epilogue
  rounds otherwise than the batch norm).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import exp_resnet_conv
import paddle_tpu_torch as pt
from paddle_tpu_torch.kernels.conv3x3 import (
    conv3x3_bn_act, conv3x3_bn_act_reference, f32_tolerance,
    fold_batch_norm)
from paddle_tpu_torch.models import resnet

F32_TOL = 1e-5

CASES = {
    # (N, H, W, C, Co), dtype, relu
    "7x7 f32": ((2, 7, 7, 16, 8), "float32", False),
    "7x7 f32 relu": ((2, 7, 7, 16, 8), "float32", True),
    "14x7 f32 relu": ((1, 14, 7, 8, 24), "float32", True),
    "14x14 bf16 relu": ((1, 14, 14, 16, 24), "bfloat16", True),
    "7x7 bf16": ((2, 7, 7, 32, 16), "bfloat16", False),
    "9x9 C20 f32": ((2, 9, 9, 20, 40), "float32", False),
    "9x9 C20 bf16 relu": ((2, 9, 9, 20, 40), "bfloat16", True),
    "7x13 C3 f32 relu": ((2, 7, 13, 3, 8), "float32", True),
    "7x13 C3 bf16": ((2, 7, 13, 3, 8), "bfloat16", False),
    "5x6 Co72 f32 relu": ((1, 5, 6, 16, 72), "float32", True),
    "5x6 Co72 bf16": ((1, 5, 6, 16, 72), "bfloat16", False),
    "N3 7x7 f32": ((3, 7, 7, 24, 16), "float32", False),
    "N3 7x7 bf16 relu": ((3, 7, 7, 24, 16), "bfloat16", True),
}


def _case(shape, seed=0):
    N, H, W, C, Co = shape
    rng = np.random.RandomState(seed)
    return (rng.randn(N, H, W, C).astype("float32"),
            (rng.randn(3, 3, C, Co) * 0.2).astype("float32"),
            (rng.rand(Co) + 0.5).astype("float32"),
            rng.randn(Co).astype("float32"))


def _pallas(x, w, scale, bias, relu, monkeypatch):
    monkeypatch.setattr(exp_resnet_conv.pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=True))
    return np.asarray(exp_resnet_conv.pallas_conv3x3(
        x, w, jnp.asarray(scale), jnp.asarray(bias), relu=relu),
        np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_the_pallas_kernel(case, monkeypatch):
    shape, dtype, relu = CASES[case]
    x, w, scale, bias = _case(shape)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj, wj = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    want = _pallas(xj, wj, scale, bias, relu, monkeypatch)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    # the same (bf16-rounded) operands the Pallas kernel read
    xt = torch.from_numpy(np.asarray(xj, np.float32)).to(tdt)
    wt = torch.from_numpy(np.asarray(wj, np.float32)).to(tdt)
    got = conv3x3_bn_act(xt, wt, torch.from_numpy(scale),
                         torch.from_numpy(bias), relu)
    assert got.dtype == tdt and got.shape == shape[:3] + (shape[4],)
    got = got.float()
    want = torch.from_numpy(want)
    if dtype == "bfloat16":
        rms = float(want.square().mean().sqrt())
        torch.testing.assert_close(got, want, atol=2.0 ** -8 * rms,
                                   rtol=2.0 ** -7)
    else:
        torch.testing.assert_close(got, want, atol=F32_TOL, rtol=F32_TOL)
    if relu:
        assert float(got.min()) == 0.0


def _tensor_core_order(x, w, scale, bias, relu, step=16):
    """The tensor-core body's sums emulated in float32: tap by tap, each
    ``step`` channels summed on their own (one ``mma`` k-step), then added
    to the running float32 sum; the epilogue as the plain version's."""
    N, H, W, C = x.shape
    Co = w.shape[3]
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = w.float()
    acc = torch.zeros(N * H * W, Co, dtype=torch.float32)
    for ky in range(3):
        for kx in range(3):
            tap = xp[:, ky:ky + H, kx:kx + W, :].reshape(N * H * W, C)
            for c in range(0, C, step):
                acc = acc + tap[:, c:c + step] @ wf[ky, kx, c:c + step]
    out = acc * scale + bias
    if relu:
        out = torch.relu(out)
    return out.reshape(N, H, W, Co).to(x.dtype)


@pytest.mark.parametrize("relu", [True, False])
def test_one_rounding_covers_the_tensor_core_order(relu):
    """At C = Co = 64 (ResNet-50's first 3x3 body) the two orders of the
    K = 576 float32 sums give bf16 outputs within one rounding of each
    other (``chip_smoke.py``'s ``assert_matches``: ``rtol = 2**-7`` plus
    ``2**-8`` times the RMS); and the orders do differ somewhere in
    float32."""
    rng = np.random.RandomState(5)
    N, H, C, Co = 3, 8, 64, 64
    x = torch.from_numpy(rng.randn(N, H, H, C).astype("float32"))
    w = torch.from_numpy((rng.randn(3, 3, C, Co) * (2.0 / (9 * C)) ** 0.5)
                         .astype("float32"))
    scale = torch.from_numpy(rng.rand(Co).astype("float32") + 0.5)
    bias = torch.from_numpy(rng.randn(Co).astype("float32") * 0.1)
    xb, wb = x.bfloat16(), w.bfloat16()
    got = _tensor_core_order(xb, wb, scale, bias, relu)
    want = conv3x3_bn_act_reference(xb, wb, scale, bias, relu)
    assert got.dtype == torch.bfloat16
    rms = float(want.float().square().mean().sqrt())
    torch.testing.assert_close(got.float(), want.float(),
                               atol=2.0 ** -8 * rms, rtol=2.0 ** -7)
    f32 = _tensor_core_order(xb.float(), wb.float(), scale, bias, relu)
    plain = conv3x3_bn_act_reference(xb.float(), wb.float(), scale, bias,
                                     relu)
    assert not torch.equal(f32, plain)


def test_plain_version_is_the_nchw_conv():
    """The formulation against ``F.conv2d`` on the transposed tensors."""
    x, w, scale, bias = _case((2, 9, 5, 6, 7), seed=1)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = conv3x3_bn_act_reference(xt, wt, torch.from_numpy(scale),
                                   torch.from_numpy(bias), relu=False)
    conv = torch.nn.functional.conv2d(xt.permute(0, 3, 1, 2),
                                      wt.permute(3, 2, 0, 1), padding=1)
    want = conv * torch.from_numpy(scale)[:, None, None] + \
        torch.from_numpy(bias)[:, None, None]
    torch.testing.assert_close(got.permute(0, 3, 1, 2), want, atol=F32_TOL,
                               rtol=F32_TOL)


def test_wrapper_checks_its_inputs():
    x, w, scale, bias = (torch.from_numpy(a) for a in _case((1, 4, 4, 8, 4)))
    with pytest.raises(ValueError, match="no kernel for device"):
        conv3x3_bn_act(x.to("meta"), w.to("meta"), scale.to("meta"),
                       bias.to("meta"))
    out = conv3x3_bn_act(x, w, scale, bias)          # the CPU: plain
    torch.testing.assert_close(out, conv3x3_bn_act_reference(
        x, w, scale, bias))


def _resnet50_inference(image_hw=32, batch=2):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        image = pt.layers.data(name="image",
                               shape=[batch, 3, image_hw, image_hw],
                               dtype="float32", append_batch_size=False)
        predict = resnet.resnet_imagenet(image, 10, depth=50)
    return main.clone(for_test=True), startup, predict


def test_resnet50_chains_run_through_the_kernel():
    """Sixteen chains; on each, the kernel with the folded batch norm
    (random statistics) equals the program's ReLU output."""
    test, startup, predict = _resnet50_inference()
    chains = resnet.conv3x3_bn_relu_chains(test)
    assert len(chains) == 16
    assert resnet.conv3x3_bn_relu_chains(startup) == []
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(2)
    for _, bn, _ in chains:
        C = scope.find_var(bn.input("Scale")[0]).shape[0]
        for slot, value in (("Scale", rng.rand(C) + 0.5),
                            ("Bias", rng.randn(C) * 0.1),
                            ("Mean", rng.randn(C) * 0.1),
                            ("Variance", rng.rand(C) + 0.5)):
            scope.set_var(bn.input(slot)[0],
                          torch.tensor(value, dtype=torch.float32))
    feed = {"image": rng.rand(2, 3, 32, 32).astype("float32")}
    fetch = [predict.name]
    for conv, _, relu in chains:
        fetch += [conv.input("Input")[0], relu.output("Out")[0]]
    got = exe.run(test, feed=feed, fetch_list=fetch, scope=scope,
                  return_numpy=False)
    for i, (conv, bn, _) in enumerate(chains):
        x, want = got[1 + 2 * i], got[2 + 2 * i]
        scale, bias = fold_batch_norm(
            *(scope.find_var(bn.input(s)[0])
              for s in ("Scale", "Bias", "Mean", "Variance")),
            bn.attr("epsilon"))
        w = scope.find_var(conv.input("Filter")[0])       # [Co, C, 3, 3]
        x = x.permute(0, 2, 3, 1).contiguous()
        w = w.permute(2, 3, 1, 0).contiguous()
        out = conv3x3_bn_act(x, w, scale, bias, relu=True)
        want = want.permute(0, 2, 3, 1)
        tol = f32_tolerance(x, w, scale) + F32_TOL * want.abs()
        assert bool(((out - want).abs() <= tol).all()), i
        assert float((out - want).abs().max()) < 1e-3
