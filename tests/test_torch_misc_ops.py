"""The port's ``conv_shift``, ``pool3d``, ``pool2d_with_index`` and
``unpool``, ``spp`` and ``positive_negative_pair`` against the JAX
package through the same layers programs, mirroring
``tests/test_misc_ops.py``; the grad of ``pool2d_with_index`` (which the
JAX package cannot take) against the one its mask implies; and the
random ops ``uniform_random_batch_size_like``,
``gaussian_random_batch_size_like`` and ``sampling_id``, which differ
from the JAX package's bits by design, by range, moments and seeding.

Tolerance: float32 ``rtol = 1e-6`` for values that sum no terms in a
different order, ``atol = rtol = 1e-5`` otherwise; integers exact."""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu_torch.ops import registry as torch_registry
from test_torch_ops import _grad_program_dict, _op_dict

PACKAGES = (fluid, pt)


def _both(build, feed):
    """``build(pkg) -> fetch list`` in a fresh program of each package,
    run once on the CPU: ``[jax outputs, torch outputs]``."""
    results = []
    for pkg in PACKAGES:
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            fetch = build(pkg)
        exe = pkg.Executor(pkg.CPUPlace())
        scope = pkg.Scope()
        exe.run(startup, scope=scope)
        results.append([np.asarray(v) for v in
                        exe.run(main, feed=feed, fetch_list=fetch,
                                scope=scope)])
    return results


def _data(pkg, name, shape, dtype="float32"):
    return pkg.layers.data(name=name, shape=list(shape), dtype=dtype,
                           append_batch_size=False)


def test_conv_shift_circular():
    x = np.array([[1.0, 2.0, 3.0, 4.0], [0.5, -1.0, 2.0, 0.0]], np.float32)
    y = np.array([[1.0, 0.0, 2.0], [0.5, 0.25, -1.0]], np.float32)
    want, got = _both(lambda pkg: [pkg.layers.conv_shift(
        _data(pkg, "x", x.shape), _data(pkg, "y", y.shape))],
        {"x": x, "y": y})
    expect = np.zeros_like(x)
    for b in range(2):
        for j in range(4):
            for k in range(3):
                expect[b, j] += x[b, (j + k - 1) % 4] * y[b, k]
    np.testing.assert_allclose(got[0], expect, rtol=1e-6)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)


def test_pool3d_max_avg():
    x = np.random.RandomState(2).rand(1, 2, 4, 4, 4).astype(np.float32)

    def build(pkg):
        xv = _data(pkg, "x", x.shape)
        return [pkg.layers.pool3d(xv, pool_size=2, pool_type=t,
                                  pool_stride=2) for t in ("max", "avg")]
    want, got = _both(build, {"x": x})
    assert got[0].shape == (1, 2, 2, 2, 2)
    blk = x[0, 0, :2, :2, :2]
    np.testing.assert_allclose(got[0][0, 0, 0, 0, 0], blk.max(), rtol=1e-6)
    np.testing.assert_allclose(got[1][0, 0, 0, 0, 0], blk.mean(), rtol=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)


def test_unpool_roundtrip_with_pool_indices():
    """Each window's max returns to its own position, the rest zeros;
    the mask indexes the 4x4 plane in both packages."""
    x = np.random.RandomState(3).rand(2, 3, 4, 4).astype(np.float32)

    def build(pkg):
        pooled, indices = pkg.layers.pool2d_with_index(
            _data(pkg, "x", x.shape), pool_size=2, pool_stride=2)
        return [pooled, indices, pkg.layers.unpool(
            pooled, indices, unpool_size=2, unpool_stride=2)]
    want, got = _both(build, {"x": x})
    np.testing.assert_array_equal(got[1], want[1])
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        np.testing.assert_array_equal(g, w)
    restored = got[2]
    assert restored.shape == x.shape
    assert np.count_nonzero(restored) == 2 * 3 * 4
    for i in range(2):
        for j in range(2):
            blk = x[:, :, 2 * i:2 * i + 2, 2 * j:2 * j + 2].reshape(2, 3, 4)
            k = blk.argmax(-1)
            rows, cols = 2 * i + k // 2, 2 * j + k % 2
            np.testing.assert_array_equal(
                np.take_along_axis(restored.reshape(2, 3, 16),
                                   (rows * 4 + cols)[..., None], 2)[..., 0],
                blk.max(-1))


def test_pool2d_with_index_grad_follows_its_mask():
    """The JAX package's ``pool2d_with_index`` has no grad (its paired
    ``reduce_window`` cannot be differentiated: ``append_backward`` and a
    run raise there); the port's sends each window's cotangent to the
    element its ``Mask`` names, which ``unpool`` of the cotangent
    gives."""
    r = np.random.RandomState(7)
    x = r.randn(2, 3, 5, 5).astype(np.float32)
    attrs = {"ksize": [2, 2], "strides": [2, 2], "paddings": [0, 0]}
    d = _grad_program_dict("pool2d_with_index", {"X": x}, ["Out", "Mask"],
                           attrs)
    cot = r.randn(2, 3, 2, 2).astype(np.float32)
    prog = pt.Program.from_dict(d)
    pt.append_backward(prog.global_block().var("loss"))
    g, mask = pt.Executor(pt.CPUPlace()).run(
        prog, feed={"in_X": x, "cot": cot},
        fetch_list=["in_X@GRAD", "out_Mask"], scope=pt.Scope())
    want = np.zeros((2, 3, 25), np.float32)
    np.put_along_axis(want, mask.reshape(2, 3, 4), cot.reshape(2, 3, 4), 2)
    np.testing.assert_array_equal(g, want.reshape(x.shape))
    prog = fluid.Program.from_dict(d)
    with pytest.raises(Exception):
        fluid.append_backward(prog.global_block().var("loss"))
        fluid.Executor(fluid.CPUPlace()).run(
            prog, feed={"in_X": x, "cot": cot}, fetch_list=["in_X@GRAD"],
            scope=fluid.Scope())


def test_spp_feature_sizes():
    x = np.random.RandomState(4).rand(2, 3, 7, 5).astype(np.float32)

    def build(pkg):
        xv = _data(pkg, "x", x.shape)
        return [pkg.layers.spp(xv, pyramid_height=3),
                pkg.layers.spp(xv, pyramid_height=3, pool_type="avg")]
    want, got = _both(build, {"x": x})
    assert got[0].shape == (2, 3 * (1 + 4 + 16))
    np.testing.assert_allclose(got[0][:, :3], x.max(axis=(2, 3)),
                               rtol=1e-6)
    np.testing.assert_allclose(got[1][:, :3], x.mean(axis=(2, 3)),
                               rtol=1e-5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)


def test_positive_negative_pair():
    score = np.array([[0.9], [0.2], [0.5], [0.4], [0.4]], np.float32)
    label = np.array([[1.0], [0.0], [1.0], [0.0], [2.0]], np.float32)
    qid = np.array([[0], [0], [1], [1], [1]], np.int64)

    def build(pkg):
        helper = pkg.layer_helper.LayerHelper("positive_negative_pair")
        outs = [helper.create_tmp_variable("float32") for _ in range(3)]
        helper.append_op(
            type="positive_negative_pair",
            inputs={"Score": _data(pkg, "s", score.shape),
                    "Label": _data(pkg, "l", label.shape),
                    "QueryID": _data(pkg, "q", qid.shape, "int64")},
            outputs={"PositivePair": outs[0], "NegativePair": outs[1],
                     "NeutralPair": outs[2]})
        return outs
    want, got = _both(build, {"s": score, "l": label, "q": qid})
    # q0: (0.9 vs 0.2) right; q1: (0.5 vs 0.4) right, (0.4 of label 2
    # vs 0.5 of label 1) wrong, (0.4 of label 2 vs 0.4 of label 0) tied
    np.testing.assert_array_equal(np.concatenate(got), [2.0, 1.0, 1.0])
    np.testing.assert_array_equal(np.concatenate(got),
                                  np.concatenate(want))


# ---------------------------------------------------------------------------
# random ops: range, moments and seeding
# ---------------------------------------------------------------------------

def _run_rng(op_type, inputs, attrs, seed, op_index=0):
    d = _op_dict(op_type, inputs, ["Out"], attrs)
    prog = pt.Program.from_dict(d)
    block = prog.global_block()
    env = {f"in_{s}": torch.from_numpy(a) for s, a in inputs.items()}
    ctx = torch_registry.LowerContext(
        block.ops[0], env, block,
        aux={"device": torch.device("cpu"), "rng_seed": seed},
        op_index=op_index)
    torch_registry.resolve_lowering(op_type).lower(ctx)
    block._infer_shape(block.ops[0])
    return ctx.outputs["out_Out"], block.var("out_Out")


@pytest.mark.parametrize("op_type", ["uniform_random_batch_size_like",
                                     "gaussian_random_batch_size_like"])
def test_batch_size_like_draws(op_type):
    """Shape ``[Input's batch, 300]``, float32, in range (uniform) or at
    the asked moments (gaussian); the same seed and RNG slot repeat the
    draw, another seed or slot does not."""
    inputs = {"Input": np.zeros((40, 3), np.float32)}
    attrs = {"shape": [-1, 300], "input_dim_idx": 0, "output_dim_idx": 0,
             "dtype": "float32", "min": -0.5, "max": 0.25, "mean": 1.5,
             "std": 0.5}
    a, var = _run_rng(op_type, inputs, attrs, seed=3)
    assert tuple(a.shape) == (40, 300) == tuple(var.shape)
    assert a.dtype == torch.float32
    if op_type.startswith("uniform"):
        assert float(a.min()) >= -0.5 and float(a.max()) < 0.25
        assert abs(float(a.mean()) - (-0.125)) < 0.01
    else:
        assert abs(float(a.mean()) - 1.5) < 0.02
        assert abs(float(a.std()) - 0.5) < 0.02
    assert torch.equal(a, _run_rng(op_type, inputs, attrs, seed=3)[0])
    assert not torch.equal(a, _run_rng(op_type, inputs, attrs, seed=4)[0])
    assert not torch.equal(a, _run_rng(op_type, inputs, attrs, seed=3,
                                       op_index=1)[0])


def test_sampling_id_follows_the_distribution():
    """Each row's draws fall in ``[0, C)`` with the row's probabilities
    (a zero-probability class never), int64 ``[N, 1]``; seeded."""
    probs = np.array([0.1, 0.0, 0.6, 0.3], np.float32)
    x = np.tile(probs, (20000, 1))
    ids, var = _run_rng("sampling_id", {"X": x}, {}, seed=11)
    assert tuple(ids.shape) == (20000, 1) and ids.dtype == torch.int64
    assert var.dtype == "int64"
    counts = np.bincount(ids.numpy().reshape(-1), minlength=4) / 20000
    assert counts[1] == 0.0
    np.testing.assert_allclose(counts, probs, atol=0.015)
    assert torch.equal(ids, _run_rng("sampling_id", {"X": x}, {},
                                     seed=11)[0])
    assert not torch.equal(ids, _run_rng("sampling_id", {"X": x}, {},
                                         seed=12)[0])
