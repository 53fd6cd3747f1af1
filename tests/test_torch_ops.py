"""Each op lowering of the PyTorch port against the JAX package's
lowering of the same op (``registry.run_lowering``), and each grad op
(the auto-vjp and the explicit grads) through both packages'
``append_backward`` on the same one-op program, on the same seeded numpy
inputs, with the IR traps of the gen LM as cases:
``lookup_table``'s trailing-1 squeeze, ``reshape``'s 0 / -1,
``elementwise_*``'s ``axis`` broadcast, ``mul``'s flattening,
``matmul``'s ``transpose_Y`` / ``alpha`` / batched broadcast,
``scale``'s ``bias_after_scale`` and ``layer_norm``'s
``begin_norm_axis`` / ``epsilon``.

Tolerance: float32 ``atol = rtol = 1e-5`` (torch and XLA sum in
different orders); integer and data-movement outputs are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.ops import registry as jax_registry
from paddle_tpu_torch.convert import to_numpy
from paddle_tpu_torch.ops import registry as torch_registry

TOL = 1e-5


def _f(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _ids(rng, hi, *shape):
    return rng.randint(0, hi, shape).astype(np.int32)


def _causal(T, p):
    tri = np.triu(np.full((T, T), -1e9, np.float32), 1)
    mask = (np.arange(T) < p).astype(np.float32)
    return (tri + (mask * 1e9 - 1e9)[None, :]).reshape(1, 1, T, T)


def _paged_inputs(rng):
    S, H, D, PL, P, NP = 4, 2, 8, 8, 3, 16
    return {
        "Q": _f(rng, S, 1, H * D), "K": _f(rng, S, 1, H * D),
        "V": _f(rng, S, 1, H * D),
        "KCache": _f(rng, NP, PL, H * D), "VCache": _f(rng, NP, PL, H * D),
        "PageTable": rng.permutation(NP)[:S * P].reshape(S, P)
        .astype(np.int32),
        # spans a page boundary, ends a page, one row, and a dead slot
        "Lens": np.array([[20], [8], [1], [0]], np.int32),
    }


def _cases():
    """(id, op type, {slot: array}, output slots, attrs)."""
    r = np.random.RandomState(7)
    T = 12
    return [
        ("mul_flatten2", "mul", {"X": _f(r, 1, T, 32), "Y": _f(r, 32, 64)},
         ["Out"], {"x_num_col_dims": 2, "y_num_col_dims": 1}),
        ("mul_flatten1", "mul", {"X": _f(r, 3, 4, 5), "Y": _f(r, 20, 6)},
         ["Out"], {"x_num_col_dims": 1, "y_num_col_dims": 1}),
        ("matmul_transpose_y_alpha", "matmul",
         {"X": _f(r, 1, 2, T, 16), "Y": _f(r, 1, 2, T, 16)}, ["Out"],
         {"transpose_X": False, "transpose_Y": True, "alpha": 0.25}),
        ("matmul_batched_broadcast", "matmul",
         {"X": _f(r, 1, 1, T), "Y": _f(r, 1, T, 32)}, ["Out"],
         {"transpose_X": False, "transpose_Y": False, "alpha": 1.0}),
        ("matmul_weights_values", "matmul",
         {"X": _f(r, 1, 2, T, T), "Y": _f(r, 1, 2, T, 16)}, ["Out"],
         {"transpose_X": False, "transpose_Y": False, "alpha": 1.0}),
        ("elementwise_add_same", "elementwise_add",
         {"X": _f(r, 1, T, 32), "Y": _f(r, 1, T, 32)}, ["Out"],
         {"axis": -1}),
        ("elementwise_add_axis2_bias", "elementwise_add",
         {"X": _f(r, 1, T, 64), "Y": _f(r, 64)}, ["Out"], {"axis": 2}),
        ("elementwise_mul_axis0_mask", "elementwise_mul",
         {"X": _f(r, 1, T, 32),
          "Y": (np.arange(T) < 9).astype(np.float32).reshape(1, T)},
         ["Out"], {"axis": 0}),
        ("elementwise_mul_same", "elementwise_mul",
         {"X": _f(r, 3, 5), "Y": _f(r, 3, 5)}, ["Out"], {"axis": -1}),
        ("scale_bias_after", "scale", {"X": _f(r, 4, 32)}, ["Out"],
         {"scale": 5.656854249492381, "bias": 0.5,
          "bias_after_scale": True}),
        ("scale_bias_before", "scale", {"X": _f(r, 4, 32)}, ["Out"],
         {"scale": 1e9, "bias": -1.0, "bias_after_scale": False}),
        ("relu", "relu", {"X": _f(r, 1, T, 64)}, ["Out"], {}),
        ("reshape_heads_dynamic", "reshape", {"X": _f(r, 1, T, 32)},
         ["Out"], {"shape": [1, -1, 2, 16]}),
        ("reshape_zero_copies_dim", "reshape", {"X": _f(r, 2, 3, 4)},
         ["Out"], {"shape": [0, -1]}),
        ("reshape_merge", "reshape", {"X": _f(r, 1, 1, 32)}, ["Out"],
         {"shape": [-1, 32]}),
        ("transpose", "transpose", {"X": _f(r, 1, T, 2, 16)}, ["Out"],
         {"axis": [0, 2, 1, 3]}),
        ("layer_norm_last_axis", "layer_norm",
         {"X": _f(r, 1, T, 32), "Scale": _f(r, 32), "Bias": _f(r, 32)},
         ["Y", "Mean", "Variance"],
         {"epsilon": 1e-5, "begin_norm_axis": 2}),
        ("layer_norm_axis1_eps", "layer_norm", {"X": _f(r, 3, 4, 5)},
         ["Y", "Mean", "Variance"], {"epsilon": 1e-3, "begin_norm_axis": 1}),
        ("softmax_no_bias", "softmax", {"X": _f(r, 3, 7)}, ["Out"], {}),
        ("softmax_causal_plane", "softmax",
         {"X": _f(r, 1, 2, T, T), "Bias": _causal(T, 9)}, ["Out"], {}),
        ("softmax_row_bias", "softmax",
         {"X": _f(r, 2, 2, 5, 7),
          "Bias": np.where(r.rand(2, 1, 1, 7) < 0.3, -1e9, 0.0)
          .astype(np.float32)}, ["Out"], {}),
        ("softmax_other_bias", "softmax",
         {"X": _f(r, 1, 2, T, T), "Bias": _f(r, 1, 2, T, T)}, ["Out"], {}),
        ("lookup_table_squeeze", "lookup_table",
         {"W": _f(r, 64, 32), "Ids": _ids(r, 64, 8, 1)}, ["Out"],
         {"is_sparse": False, "is_distributed": False, "padding_idx": -1}),
        ("lookup_table_2d_ids", "lookup_table",
         {"W": _f(r, 64, 32), "Ids": _ids(r, 64, 1, T)}, ["Out"],
         {"is_sparse": False, "is_distributed": False, "padding_idx": -1}),
        ("lookup_table_padding_idx", "lookup_table",
         {"W": _f(r, 10, 4), "Ids": np.array([[0, 3, 3, 9]], np.int32)},
         ["Out"], {"padding_idx": 3}),
        ("elementwise_sub", "elementwise_sub",
         {"X": _f(r, 3, 5), "Y": _f(r, 5)}, ["Out"], {"axis": -1}),
        ("elementwise_div", "elementwise_div",
         {"X": _f(r, 3, 5), "Y": np.abs(_f(r, 3, 5)) + 0.5}, ["Out"],
         {"axis": -1}),
        ("elementwise_max", "elementwise_max",
         {"X": _f(r, 3, 5), "Y": _f(r, 3, 5)}, ["Out"], {"axis": -1}),
        ("elementwise_min", "elementwise_min",
         {"X": _f(r, 3, 5), "Y": _f(r, 3, 5)}, ["Out"], {"axis": -1}),
        ("elementwise_pow", "elementwise_pow",
         {"X": np.abs(_f(r, 3, 5)) + 0.1, "Y": _f(r, 3, 5)}, ["Out"],
         {"axis": -1}),
        ("sum", "sum", {"X": _f(r, 3, 5)}, ["Out"], {}),
        ("mean", "mean", {"X": _f(r, 3, 5)}, ["Out"], {}),
        ("sign", "sign", {"X": _f(r, 3, 5)}, ["Out"], {}),
        ("sqrt", "sqrt", {"X": np.abs(_f(r, 3, 5))}, ["Out"], {}),
        ("clip", "clip", {"X": _f(r, 3, 5)}, ["Out"],
         {"min": -0.5, "max": 0.7}),
        ("clip_by_norm", "clip_by_norm", {"X": _f(r, 3, 5)}, ["Out"],
         {"max_norm": 1.0}),
        ("squared_l2_norm", "squared_l2_norm", {"X": _f(r, 3, 5)}, ["Out"],
         {}),
        ("reduce_sum_all_keep", "reduce_sum", {"X": _f(r, 3, 4, 5)},
         ["Out"], {"dim": [0], "keep_dim": True, "reduce_all": True}),
        ("reduce_mean_dims", "reduce_mean", {"X": _f(r, 3, 4, 5)}, ["Out"],
         {"dim": [0, -1], "keep_dim": False, "reduce_all": False}),
        ("reduce_max_keep", "reduce_max", {"X": _f(r, 3, 4, 5)}, ["Out"],
         {"dim": [1], "keep_dim": True, "reduce_all": False}),
        ("reduce_min", "reduce_min", {"X": _f(r, 3, 4, 5)}, ["Out"],
         {"dim": [2], "keep_dim": False, "reduce_all": False}),
        ("reduce_prod", "reduce_prod", {"X": _f(r, 3, 4, 5)}, ["Out"],
         {"dim": [0, 2], "keep_dim": False, "reduce_all": False}),
        ("softmax_with_cross_entropy", "softmax_with_cross_entropy",
         {"Logits": _f(r, 6, 10), "Label": _ids(r, 10, 6, 1)},
         ["Loss", "Softmax"], {"soft_label": False}),
        ("dropout_is_test", "dropout", {"X": _f(r, 3, 5)}, ["Out", "Mask"],
         {"dropout_prob": 0.3, "is_test": True}),
        ("fill_constant", "fill_constant", {}, ["Out"],
         {"shape": [3, 2], "dtype": "float32", "value": 1.5}),
        ("fill_constant_int", "fill_constant", {}, ["Out"],
         {"shape": [4], "dtype": "int32", "value": 7}),
        ("assign_value", "assign_value", {}, ["Out"],
         {"shape": [2, 3], "dtype": "float32",
          "fp32_values": [0.5, -1.0, 2.0, 3.25, 0.0, 1e-3]}),
        ("paged_attention", "paged_attention", _paged_inputs(r),
         ["Out", "KCacheOut", "VCacheOut"],
         {"n_head": 2, "scale": 8.0 ** -0.5}),
    ]


def _op_dict(op_type, inputs, out_slots, attrs):
    """Program dict of one block: a var per input/output, one op."""
    vars_, ins, outs = [], {}, {}
    for slot, arr in inputs.items():
        name = f"in_{slot}"
        vars_.append({"name": name, "shape": list(arr.shape),
                      "dtype": str(arr.dtype), "persistable": False})
        ins[slot] = [name]
    for slot in out_slots:
        # stateful outputs alias their input, as in the gen LM programs
        name = {"KCacheOut": "in_KCache",
                "VCacheOut": "in_VCache"}.get(slot, f"out_{slot}")
        if name.startswith("out_"):
            vars_.append({"name": name, "shape": None, "dtype": "float32"})
        outs[slot] = [name]
    op = {"type": op_type, "inputs": ins, "outputs": outs, "attrs": attrs}
    return {"blocks": [{"idx": 0, "parent_idx": -1, "vars": vars_,
                        "ops": [op]}]}


def _run_jax(d, inputs):
    prog = fluid.Program.from_dict(d)
    block = prog.global_block()
    env = {f"in_{s}": jnp.asarray(a) for s, a in inputs.items()}
    op = block.ops[0]
    jax_registry.run_lowering(op, env, block, rng_key=None, training=False,
                              aux={})
    return {n: np.asarray(env[n]) for n in op.output_arg_names}


def _run_torch(d, inputs):
    prog = pt.Program.from_dict(d)
    block = prog.global_block()
    env = {f"in_{s}": torch.from_numpy(a.copy()) for s, a in inputs.items()}
    op = block.ops[0]
    torch_registry.run_lowering(
        op, env, block, aux={"device": torch.device("cpu"),
                             "generator": torch.Generator().manual_seed(0)})
    return {n: to_numpy(env[n]) for n in op.output_arg_names}


@pytest.mark.parametrize("case", _cases(), ids=lambda c: c[0])
def test_lowering_matches_reference(case):
    _, op_type, inputs, out_slots, attrs = case
    d = _op_dict(op_type, inputs, out_slots, attrs)
    want = _run_jax(d, inputs)
    got = _run_torch(d, inputs)
    assert set(got) == set(want)
    for name in want:
        w, g = want[name], got[name]
        assert g.shape == w.shape, name
        if op_type == "paged_attention" and name == "out_Out":
            # the dead slot (lens 0) is never read back: finite only
            live = inputs["Lens"][:, 0] > 0
            assert np.all(np.isfinite(g))
            w, g = w[live], g[live]
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_infer_shape_matches_reference():
    """Build-time shape inference of every case agrees (the IR dicts of
    the two packages depend on it)."""
    for _, op_type, inputs, out_slots, attrs in _cases():
        d = _op_dict(op_type, inputs, out_slots, attrs)
        shapes = []
        for pkg in (fluid, pt):
            prog = pkg.Program.from_dict(d)
            block = prog.global_block()
            op = block.ops[0]
            block._infer_shape(op)
            shapes.append({n: block.var(n).shape
                           for n in op.output_arg_names})
        assert shapes[0] == shapes[1], op_type


def test_uniform_random_is_seeded_and_in_range():
    """Random init differs from JAX's bits by design; the port's draw is
    in [min, max), has the declared shape/dtype, and repeats per seed."""
    d = _op_dict("uniform_random", {}, ["Out"],
                 {"shape": [64, 32], "dtype": "float32", "min": -0.3,
                  "max": 0.3, "seed": 0})
    outs = []
    for seed in (5, 5, 6):
        prog = pt.Program.from_dict(d)
        env = {}
        torch_registry.run_lowering(
            prog.global_block().ops[0], env, prog.global_block(),
            aux={"device": torch.device("cpu"),
                 "generator": torch.Generator().manual_seed(seed)})
        outs.append(env["out_Out"])
    assert outs[0].shape == (64, 32) and outs[0].dtype == torch.float32
    assert float(outs[0].min()) >= -0.3 and float(outs[0].max()) < 0.3
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


def test_persist_record_format_round_trips(tmp_path):
    """``save_combine`` of one package is read by ``load_combine`` of the
    other, bfloat16 included (raw uint16 words)."""
    from paddle_tpu.ops import persist_ops as jax_persist
    from paddle_tpu_torch.ops import persist_ops as torch_persist
    r = np.random.RandomState(3)
    f32 = _f(r, 3, 4)
    bf16 = jnp.asarray(_f(r, 5), jnp.bfloat16)
    path = str(tmp_path / "rec")
    with open(path, "wb") as f:
        jax_persist.write_tensor(f, f32, name="a")
        jax_persist.write_tensor(f, bf16, name="b")
    assert torch_persist.read_record_names(path) == ["a", "b"]
    with open(path, "rb") as f:
        a, _ = torch_persist.read_tensor(f)
        b, _ = torch_persist.read_tensor(f)
    np.testing.assert_array_equal(a.numpy(), f32)
    assert b.dtype == torch.bfloat16
    np.testing.assert_array_equal(b.float().numpy(),
                                  np.asarray(bf16, np.float32))
    back = str(tmp_path / "back")
    with open(back, "wb") as f:
        torch_persist.write_tensor(f, a, name="a")
        torch_persist.write_tensor(f, b, name="b")
    with open(back, "rb") as f:
        a2, _ = jax_persist.read_tensor(f)
        b2, _ = jax_persist.read_tensor(f)
    np.testing.assert_array_equal(a2, f32)
    np.testing.assert_array_equal(np.asarray(b2, np.float32),
                                  np.asarray(bf16, np.float32))


# ---------------------------------------------------------------------------
# grad ops: each package's append_backward on the same one-op program
# ---------------------------------------------------------------------------

def _grad_cases():
    """(id, op type, {slot: array}, output slots, attrs).  The first output
    slot carries the cotangent; every float input not in the op's
    no-grad slots gets a grad."""
    r = np.random.RandomState(17)
    mask = np.ones((2, 12), np.float32)
    mask[1, -4:] = 0.0
    return [
        ("mul", "mul", {"X": _f(r, 2, 6, 8), "Y": _f(r, 8, 5)}, ["Out"],
         {"x_num_col_dims": 2, "y_num_col_dims": 1}),
        ("matmul_transpose_y_alpha", "matmul",
         {"X": _f(r, 1, 2, 6, 8), "Y": _f(r, 1, 2, 6, 8)}, ["Out"],
         {"transpose_X": False, "transpose_Y": True, "alpha": 0.25}),
        ("matmul_batched", "matmul",
         {"X": _f(r, 1, 2, 6, 6), "Y": _f(r, 1, 2, 6, 8)}, ["Out"],
         {"transpose_X": False, "transpose_Y": False, "alpha": 1.0}),
        ("elementwise_add_bias", "elementwise_add",
         {"X": _f(r, 2, 6, 8), "Y": _f(r, 8)}, ["Out"], {"axis": 2}),
        ("elementwise_mul_axis0", "elementwise_mul",
         {"X": _f(r, 2, 6, 8), "Y": _f(r, 2, 6)}, ["Out"], {"axis": 0}),
        ("elementwise_div", "elementwise_div",
         {"X": _f(r, 3, 4), "Y": np.abs(_f(r, 3, 4)) + 0.5}, ["Out"],
         {"axis": -1}),
        ("scale", "scale", {"X": _f(r, 4, 8)}, ["Out"],
         {"scale": 2.5, "bias": 0.5, "bias_after_scale": True}),
        ("relu", "relu", {"X": _f(r, 3, 8)}, ["Out"], {}),
        ("reshape", "reshape", {"X": _f(r, 2, 6, 8)}, ["Out"],
         {"shape": [2, 6, 2, 4]}),
        ("transpose", "transpose", {"X": _f(r, 2, 6, 2, 4)}, ["Out"],
         {"axis": [0, 2, 1, 3]}),
        ("layer_norm", "layer_norm",
         {"X": _f(r, 2, 6, 8), "Scale": _f(r, 8), "Bias": _f(r, 8)},
         ["Y", "Mean", "Variance"], {"epsilon": 1e-5, "begin_norm_axis": 2}),
        ("softmax_no_bias", "softmax", {"X": _f(r, 3, 7)}, ["Out"], {}),
        ("softmax_row_bias", "softmax",
         {"X": _f(r, 2, 2, 5, 7),
          "Bias": np.where(r.rand(2, 1, 1, 7) < 0.3, -1e9, 0.0)
          .astype(np.float32)}, ["Out"], {}),
        ("softmax_causal_plane", "softmax",
         {"X": _f(r, 1, 2, 6, 6), "Bias": _causal(6, 5)}, ["Out"], {}),
        ("softmax_with_cross_entropy", "softmax_with_cross_entropy",
         {"Logits": _f(r, 6, 10), "Label": _ids(r, 10, 6, 1)},
         ["Loss", "Softmax"], {"soft_label": False}),
        ("reduce_sum_dim1", "reduce_sum", {"X": _f(r, 3, 4, 5)}, ["Out"],
         {"dim": [1], "keep_dim": False, "reduce_all": False}),
        ("mean", "mean", {"X": _f(r, 3, 4)}, ["Out"], {}),
        ("lookup_table", "lookup_table",
         {"W": _f(r, 10, 4), "Ids": _ids(r, 10, 2, 3)}, ["Out"],
         {"is_sparse": False, "is_distributed": False, "padding_idx": -1}),
        ("sdpa_cross_masked", "scaled_dot_product_attention",
         {"Q": _f(r, 2, 2, 10, 8, scale=0.5),
          "K": _f(r, 2, 2, 12, 8, scale=0.5),
          "V": _f(r, 2, 2, 12, 8, scale=0.5), "KMask": mask},
         ["Out", "Lse"], {"causal": False, "scale": 8 ** -0.5,
                          "use_flash": True}),
        ("sdpa_causal", "scaled_dot_product_attention",
         {"Q": _f(r, 2, 2, 10, 8, scale=0.5),
          "K": _f(r, 2, 2, 10, 8, scale=0.5),
          "V": _f(r, 2, 2, 10, 8, scale=0.5)},
         ["Out", "Lse"], {"causal": True, "scale": 8 ** -0.5,
                          "use_flash": True}),
    ]


def _grad_program_dict(op_type, inputs, out_slots, attrs):
    """One op, then ``loss = reduce_sum(out * cot)`` with the cotangent
    ``cot`` a feed: the input grads are the op's vjp at ``cot``."""
    d = _op_dict(op_type, inputs, out_slots, attrs)
    block = d["blocks"][0]
    for v in block["vars"]:
        v["is_data"] = True
        v["stop_gradient"] = not v["dtype"].startswith("float")
    first = f"out_{out_slots[0]}"
    block["vars"] += [
        {"name": "cot", "shape": None, "dtype": "float32", "is_data": True,
         "stop_gradient": True},
        {"name": "prod", "shape": None, "dtype": "float32"},
        {"name": "loss", "shape": [1], "dtype": "float32"}]
    block["ops"] += [
        {"type": "elementwise_mul", "inputs": {"X": [first], "Y": ["cot"]},
         "outputs": {"Out": ["prod"]}, "attrs": {"axis": -1}},
        {"type": "reduce_sum", "inputs": {"X": ["prod"]},
         "outputs": {"Out": ["loss"]},
         "attrs": {"dim": [0], "keep_dim": False, "reduce_all": True}}]
    return d


@pytest.mark.parametrize("case", _grad_cases(), ids=lambda c: c[0])
def test_grad_matches_reference(case):
    _, op_type, inputs, out_slots, attrs = case
    d = _grad_program_dict(op_type, inputs, out_slots, attrs)
    # the cotangent has the first output's shape: run the forward once
    out_shape = _run_torch(_op_dict(op_type, inputs, out_slots, attrs),
                           inputs)[f"out_{out_slots[0]}"].shape
    feed = {f"in_{s}": a for s, a in inputs.items()}
    feed["cot"] = _f(np.random.RandomState(5), *out_shape)
    results = []
    for pkg in (fluid, pt):
        prog = pkg.Program.from_dict(d)
        pkg.append_backward(prog.global_block().var("loss"))
        grads = sorted(n for n in prog.global_block().vars
                       if n.startswith("in_") and n.endswith("@GRAD"))
        exe = pkg.Executor(pkg.CPUPlace())
        vals = exe.run(prog, feed=feed, fetch_list=grads,
                       scope=pkg.Scope())
        results.append(dict(zip(grads, [np.asarray(v) for v in vals])))
    want, got = results
    assert set(got) == set(want) and want, sorted(want)
    assert f"in_{next(iter(inputs))}@GRAD" in want
    for name in want:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], atol=TOL,
                                   rtol=TOL, err_msg=name)
