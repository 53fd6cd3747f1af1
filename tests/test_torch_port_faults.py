"""Faults of the port against the JAX package, each pinned where the two
packages once differed: ``check_nan_inf``, bfloat16 fetches,
out-of-range indices in ``gather`` and ``lookup_table``, float -> int
``cast`` saturation, the grads of ``elementwise_pow`` and ``pow`` at
their poles, the grads of the max-like ops at a NaN (a group whose max is
NaN takes no cotangent, even a zero one), and integer inputs to
``mean``, ``reduce_mean``, ``sign`` and ``reduce_sum``.  Every case runs
the same program, inputs and state through both packages on the CPU."""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from test_torch_ops import _grad_program_dict, _op_dict, _run_jax, _run_torch

PACKAGES = {"jax": fluid, "torch": pt}


def _var(name, shape, dtype="float32", **kw):
    return dict({"name": name, "shape": list(shape), "dtype": dtype}, **kw)


def _program(pkg, vars_, ops):
    return pkg.Program.from_dict(
        {"blocks": [{"idx": 0, "parent_idx": -1, "vars": vars_,
                     "ops": ops}]})


def _run(pkg, prog, feed, fetch, scope=None):
    exe = pkg.Executor(pkg.CPUPlace())
    return exe.run(prog, feed=feed, fetch_list=fetch,
                   scope=scope if scope is not None else pkg.Scope())


# ---------------------------------------------------------------------------
# 1. check_nan_inf
# ---------------------------------------------------------------------------

def _log_program(pkg):
    return _program(pkg, [_var("x", [3], is_data=True),
                          _var("log_0.tmp_0", [3])],
                    [{"type": "log", "inputs": {"X": ["x"]},
                      "outputs": {"Out": ["log_0.tmp_0"]}, "attrs": {}}])


X_NEG = np.array([-1.0, 1.0, 2.0], np.float32)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_check_nan_inf_names_the_fetch(pkg):
    """``log(x)`` at x = -1 under ``Program.check_nan_inf`` raises
    naming ``log_0.tmp_0``; with the mode off the NaN comes back."""
    mod = PACKAGES[pkg]
    prog = _log_program(mod)
    prog.check_nan_inf = True
    with pytest.raises(RuntimeError, match=r"'log_0\.tmp_0' contains "
                                           r"NaN/Inf \(check_nan_inf mode\)"):
        _run(mod, prog, {"x": X_NEG}, ["log_0.tmp_0"])
    prog.check_nan_inf = False
    (out,) = _run(mod, prog, {"x": X_NEG}, ["log_0.tmp_0"])
    assert np.isnan(np.asarray(out, np.float32)[0])


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_check_nan_inf_env_flag_and_state(pkg, monkeypatch):
    """``PADDLE_TPU_CHECK_NAN_INF=1`` switches the mode on for a program
    that does not say; a non-finite persistable write is named too, and
    the scope keeps its value from before the step."""
    mod = PACKAGES[pkg]
    monkeypatch.setenv("PADDLE_TPU_CHECK_NAN_INF", "1")
    with pytest.raises(RuntimeError, match="log_0.tmp_0"):
        _run(mod, _log_program(mod), {"x": X_NEG}, ["log_0.tmp_0"])
    prog = _program(mod, [_var("x", [3], is_data=True),
                          _var("w", [3], persistable=True)],
                    [{"type": "log", "inputs": {"X": ["x"]},
                      "outputs": {"Out": ["w"]}, "attrs": {}}])
    scope = mod.Scope()
    scope.set_var("w", np.ones(3, np.float32))
    with pytest.raises(RuntimeError, match=r"Variable 'w' contains "
                                           r"NaN/Inf after the step"):
        _run(mod, prog, {"x": X_NEG}, [], scope=scope)
    np.testing.assert_array_equal(np.asarray(scope.find_var("w")),
                                  np.ones(3, np.float32))


# ---------------------------------------------------------------------------
# 2. bfloat16 fetches
# ---------------------------------------------------------------------------

def _bf16_program(pkg):
    return _program(pkg, [_var("x", [3], is_data=True),
                          _var("xb", [3], "bfloat16"),
                          _var("y", [3], "bfloat16")],
                    [{"type": "cast", "inputs": {"X": ["x"]},
                      "outputs": {"Out": ["xb"]},
                      "attrs": {"in_dtype": "float32",
                                "out_dtype": "bfloat16"}},
                     {"type": "scale", "inputs": {"X": ["xb"]},
                      "outputs": {"Out": ["y"]}, "attrs": {"scale": 2.0}}])


X_BF16 = np.array([1.5, -2.0, 3.25], np.float32)


def test_bf16_fetch_returns_values():
    """``scale(cast(x, bfloat16), 2)``: the JAX package hands out a
    bfloat16 array, the port the same values widened to float32 (the
    stated dtype deviation) — never the raw uint16 words."""
    (want,) = _run(fluid, _bf16_program(fluid), {"x": X_BF16}, ["y"])
    assert str(np.asarray(want).dtype) == "bfloat16"
    (got,) = _run(pt, _bf16_program(pt), {"x": X_BF16}, ["y"])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, [3.0, -4.0, 6.5])
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))


def test_bf16_values_through_run_steps_fetch_var_and_print(capsys):
    from paddle_tpu_torch.executor import fetch_var
    prog = _bf16_program(pt)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    (stacked,) = exe.run_steps(prog, feed={"x": X_BF16}, fetch_list=["y"],
                               steps=2, scope=scope)
    assert stacked.dtype == np.float32 and stacked.shape == (2, 3)
    np.testing.assert_array_equal(stacked[1], [3.0, -4.0, 6.5])
    scope.set_var("yb", torch.tensor([3.0, -4.0], dtype=torch.bfloat16))
    got = fetch_var("yb", scope)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, [3.0, -4.0])
    assert isinstance(fetch_var("yb", scope, return_numpy=False),
                      torch.Tensor)
    with pytest.raises(KeyError, match="nope"):
        fetch_var("nope", scope)
    d = _op_dict("print", {"In": np.zeros(3, np.float32)}, ["Out"],
                 {"message": "yb:", "print_phase": "BOTH"})
    p = pt.Program.from_dict(d)
    env = {"in_In": torch.tensor([3.0, -4.0, 6.5], dtype=torch.bfloat16)}
    from paddle_tpu_torch.ops import registry
    registry.run_lowering(p.global_block().ops[0], env, p.global_block(),
                          aux={"device": torch.device("cpu")})
    out = capsys.readouterr().out
    assert "yb: [ 3.  -4.   6.5]" in out, out


# ---------------------------------------------------------------------------
# 3. out-of-range indices: gather and lookup_table
# ---------------------------------------------------------------------------

ROWS = np.arange(12, dtype=np.float32).reshape(4, 3) + 1.0


def _index_cases():
    return [
        ("gather", {"X": ROWS, "Index": np.array([1, -1, 4, 0], np.int64)},
         {}),
        ("lookup_table",
         {"W": ROWS, "Ids": np.array([[2], [-1], [4], [-5]], np.int64)},
         {"padding_idx": -1}),
        ("lookup_table",
         {"W": ROWS, "Ids": np.array([[1], [-1], [4], [0]], np.int64)},
         {"padding_idx": 0}),
    ]


@pytest.mark.parametrize("case", _index_cases(),
                         ids=["gather", "lookup_table", "lookup_table_pad"])
def test_out_of_range_index_forward(case):
    """Index -1 is the last row and an index past either end a NaN row,
    as ``jnp.take`` gives them; no ``IndexError``."""
    op_type, inputs, attrs = case
    d = _op_dict(op_type, inputs, ["Out"], attrs)
    want = _run_jax(d, inputs)["out_Out"]
    got = _run_torch(d, inputs)["out_Out"]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1], ROWS[-1])
    assert np.isnan(got[2]).all()


@pytest.mark.parametrize("case", _index_cases(),
                         ids=["gather", "lookup_table", "lookup_table_pad"])
def test_out_of_range_index_grad(case):
    """The grad of the table drops the rows whose index was out of range
    and sends index -1's to the last row, in both packages."""
    op_type, inputs, attrs = case
    d = _grad_program_dict(op_type, inputs, ["Out"], attrs)
    feed = {f"in_{s}": a for s, a in inputs.items()}
    n_out = np.asarray(_run_jax(_op_dict(op_type, inputs, ["Out"], attrs),
                                inputs)["out_Out"]).shape
    feed["cot"] = np.random.RandomState(5).standard_normal(n_out).astype(
        np.float32)
    slot = next(iter(inputs))
    results = []
    for pkg in (fluid, pt):
        prog = pkg.Program.from_dict(d)
        pkg.append_backward(prog.global_block().var("loss"))
        (g,) = _run(pkg, prog, feed, [f"in_{slot}@GRAD"])
        results.append(np.asarray(g))
    want, got = results
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.isfinite(got).all()


def test_sparse_lookup_table_grad_drops_out_of_range_rows():
    """``is_sparse``: an id past the end gets the slot every sparse
    update drops (row ``height``, value 0) and -1 is the last row, so no
    update indexes past the table."""
    from paddle_tpu_torch.ops import registry
    d = _grad_program_dict("lookup_table",
                           {"W": ROWS, "Ids": np.array([[-1], [4]],
                                                       np.int64)},
                           ["Out"], {"is_sparse": True})
    prog = pt.Program.from_dict(d)
    pt.append_backward(prog.global_block().var("loss"))
    block = prog.global_block()
    grad_op = [op for op in block.ops if op.type == "lookup_table_grad"][0]
    env = {"in_W": torch.from_numpy(ROWS),
           "in_Ids": torch.tensor([[-1], [4]]),
           "out_Out": torch.zeros(2, 3),
           "out_Out@GRAD": torch.ones(2, 3)}
    outs = registry.run_lowering(grad_op, env, block,
                                 aux={"device": torch.device("cpu")})
    sr = outs["in_W@GRAD"]
    assert sr.rows.tolist() == [3, 4]
    np.testing.assert_array_equal(sr.value.numpy(), [[1, 1, 1], [0, 0, 0]])
    # the dead slot adds a zero at a clamped row: only row 3 moves
    rows, value = sr.clamped()
    assert rows.tolist() == [3, 3]
    np.testing.assert_array_equal(value.numpy(), [[1, 1, 1], [0, 0, 0]])
    np.testing.assert_array_equal(sr.to_dense().numpy(),
                                  [[0, 0, 0]] * 3 + [[1, 1, 1]])


# ---------------------------------------------------------------------------
# 4. saturating float -> int casts
# ---------------------------------------------------------------------------

CAST_CASES = [
    ("int32", np.array([np.nan, np.inf, -np.inf, 2.5e9, -2.5e9, 7.9],
                       np.float32),
     [0, 2147483647, -2147483648, 2147483647, -2147483648, 7]),
    ("uint8", np.array([-1.0, 300.0, 254.7, np.nan], np.float32),
     [0, 255, 254, 0]),
    ("int64", np.array([np.inf, -np.inf, np.nan, -3.5], np.float32),
     None),
]


@pytest.mark.parametrize("case", CAST_CASES, ids=lambda c: c[0])
def test_float_to_int_cast_saturates(case):
    """NaN gives 0 and a value past either end the end itself, as XLA's
    convert does (``.to()`` alone is undefined there)."""
    out_dtype, x, expected = case
    d = _op_dict("cast", {"X": x}, ["Out"],
                 {"in_dtype": "float32", "out_dtype": out_dtype})
    got = _run_torch(d, {"X": x})["out_Out"]
    assert str(got.dtype) == out_dtype
    if expected is None:
        # int64: the JAX package runs it as int32 (x64 off); the port
        # saturates at int64's own ends
        info = np.iinfo(np.int64)
        np.testing.assert_array_equal(got, [info.max, info.min, 0, -3])
        return
    want = _run_jax(d, {"X": x})["out_Out"]
    np.testing.assert_array_equal(got, expected)
    np.testing.assert_array_equal(got, want.astype(got.dtype))


# ---------------------------------------------------------------------------
# 5. grads at a pole
# ---------------------------------------------------------------------------

POLE_CASES = [
    ("elementwise_pow", {"X": np.array([0.0, 2.0, 0.0, 1.5], np.float32),
                         "Y": np.array([0.0, 3.0, -1.0, 0.5], np.float32)},
     {"axis": -1}),
    ("pow", {"X": np.array([-0.0, 0.0, 4.0], np.float32)},
     {"factor": 0.5}),
]


@pytest.mark.parametrize("case", POLE_CASES, ids=lambda c: c[0])
def test_pow_grads_at_the_pole(case):
    """``elementwise_pow``'s dX at x = y = 0 is NaN (0 * 0^-1) and
    ``pow(x, 0.5)``'s at x = -0.0 is +inf, in both packages."""
    op_type, inputs, attrs = case
    d = _grad_program_dict(op_type, inputs, ["Out"], attrs)
    shape = next(iter(inputs.values())).shape
    feed = {f"in_{s}": a for s, a in inputs.items()}
    feed["cot"] = np.ones(shape, np.float32)
    results = []
    for pkg in (fluid, pt):
        prog = pkg.Program.from_dict(d)
        pkg.append_backward(prog.global_block().var("loss"))
        names = sorted(n for n in prog.global_block().vars
                       if n.startswith("in_") and n.endswith("@GRAD"))
        vals = _run(pkg, prog, feed, names)
        results.append(dict(zip(names, [np.asarray(v) for v in vals])))
    want, got = results
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    gx = got["in_X@GRAD"]
    if op_type == "pow":
        assert gx[0] == np.inf and gx[1] == np.inf
    else:
        assert np.isnan(gx[0])
        assert np.isnan(got["in_Y@GRAD"][2])


# ---------------------------------------------------------------------------
# 6. max-like grads at a NaN
# ---------------------------------------------------------------------------

NAN_ROWS = np.array([[1, 3, 3, 2], [np.nan, 1, 2, 0]], np.float32)
NAN_PAIR = {"X": np.array([np.nan, 1, 2, 3], np.float32),
            "Y": np.array([1, np.nan, 2, 1], np.float32)}
NAN_ACT = np.array([np.nan, 0.5, -0.5, 0.0], np.float32)
#: (id, op type, inputs, attrs, zero-cotangent mask or None): the grads
#: run once at a cotangent of ones and once with the NaN group's
#: cotangent zero (the case the fault hit hardest: a masked-out NaN put
#: NaN into the whole group's grad)
NAN_CASES = [
    ("reduce_max_dim1", "reduce_max", {"X": NAN_ROWS},
     {"dim": [1], "keep_dim": False, "reduce_all": False}, [1.0, 0.0]),
    ("reduce_max_all", "reduce_max", {"X": NAN_ROWS},
     {"dim": [1], "keep_dim": False, "reduce_all": True}, [0.0]),
    ("reduce_min_keep", "reduce_min", {"X": NAN_ROWS},
     {"dim": [1], "keep_dim": True, "reduce_all": False}, [[1.0], [0.0]]),
    ("maxout", "maxout",
     {"X": np.array([1, np.nan, 2, 3], np.float32).reshape(1, 4, 1, 1)},
     {"groups": 2}, np.array([0.0, 1.0]).reshape(1, 2, 1, 1)),
    ("pool2d_max", "pool2d",
     {"X": np.array([1, np.nan, 2, 3, 5, 0, 7, 1, 9, 4, 4, 8, 2, 2, 6, 6],
                    np.float32).reshape(1, 1, 4, 4)},
     {"ksize": [2, 2], "strides": [2, 2], "pooling_type": "max"},
     np.array([0.0, 1.0, 1.0, 1.0]).reshape(1, 1, 2, 2)),
    ("elementwise_max", "elementwise_max", NAN_PAIR, {"axis": -1},
     [0.0, 0.0, 1.0, 1.0]),
    ("elementwise_min", "elementwise_min", NAN_PAIR, {"axis": -1},
     [0.0, 0.0, 1.0, 1.0]),
    ("relu", "relu", {"X": NAN_ACT}, {}, None),
    ("relu6", "relu6", {"X": NAN_ACT}, {"threshold": 6.0}, None),
    ("brelu", "brelu", {"X": NAN_ACT}, {"t_min": -1.0, "t_max": 0.0},
     None),
    ("clip", "clip", {"X": NAN_ACT}, {"min": -0.5, "max": 0.0}, None),
    ("hard_sigmoid", "hard_sigmoid", {"X": NAN_ACT},
     {"slope": 0.25, "offset": 0.5}, None),
]


def _both_grads(op_type, inputs, attrs, cot):
    d = _grad_program_dict(op_type, inputs, ["Out"], attrs)
    feed = {f"in_{s}": a for s, a in inputs.items()}
    feed["cot"] = np.asarray(cot, np.float32)
    results = []
    for pkg in (fluid, pt):
        prog = pkg.Program.from_dict(d)
        pkg.append_backward(prog.global_block().var("loss"))
        names = sorted(n for n in prog.global_block().vars
                       if n.startswith("in_") and n.endswith("@GRAD"))
        vals = _run(pkg, prog, feed, names)
        results.append(dict(zip(names, [np.asarray(v) for v in vals])))
    return results


@pytest.mark.parametrize("cot_kind", ["ones", "zero_on_nan"])
@pytest.mark.parametrize("case", NAN_CASES, ids=lambda c: c[0])
def test_max_like_grads_at_nan(case, cot_kind):
    """A NaN in a max-reduced group: the group takes no grad (the JAX
    package's vjp), under a cotangent of ones and under one that is zero
    on the NaN's group; ties elsewhere still split evenly.  The clips and
    ``relu`` pass no cotangent at x = NaN; ``elementwise_max`` / ``min``
    give neither operand one where either is NaN."""
    _, op_type, inputs, attrs, zero_mask = case
    out = _run_jax(_op_dict(op_type, inputs, ["Out"], attrs),
                   inputs)["out_Out"]
    cot = np.ones(out.shape, np.float32)
    if cot_kind == "zero_on_nan":
        if zero_mask is None:
            cot = np.where(np.isnan(inputs["X"]), 0.0, 1.0)
        else:
            cot = np.asarray(zero_mask, np.float32).reshape(out.shape)
    want, got = _both_grads(op_type, inputs, attrs, cot)
    assert set(got) == set(want) and want
    for name in want:
        assert np.isfinite(got[name]).all(), (name, got[name])
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


_NAN_COT_X = np.array([1.0, -2.0, 0.25, 7.0, -0.5, 3.0], np.float32)
#: (id, op type, inputs, attrs): a NaN cotangent in a third of the
#: places, where the chosen operand or the clipped side differs from the
#: one that takes the cotangent
NAN_COT_CASES = [
    ("elementwise_max", "elementwise_max",
     {"X": _NAN_COT_X, "Y": np.array([0, 0, 0.25, 9, 1, -1], np.float32)},
     {"axis": -1}),
    ("elementwise_min", "elementwise_min",
     {"X": _NAN_COT_X, "Y": np.array([0, 0, 0.25, 9, 1, -1], np.float32)},
     {"axis": -1}),
    ("clip", "clip", {"X": _NAN_COT_X}, {"min": -0.5, "max": 0.5}),
    ("relu6", "relu6", {"X": _NAN_COT_X * 2}, {"threshold": 6.0}),
    ("brelu", "brelu", {"X": _NAN_COT_X}, {"t_min": -1.0, "t_max": 2.0}),
    ("hard_sigmoid", "hard_sigmoid", {"X": _NAN_COT_X},
     {"slope": 0.25, "offset": 0.5}),
    ("soft_relu", "soft_relu", {"X": _NAN_COT_X * 10},
     {"threshold": 5.0}),
    ("margin_rank_loss", "margin_rank_loss",
     {"X1": _NAN_COT_X.reshape(6, 1),
      "X2": np.array([0, 0, 1, 9, 1, -1], np.float32).reshape(6, 1),
      "Label": np.array([1, -1, 1, 1, -1, -1], np.float32).reshape(6, 1)},
     {"margin": 0.1}),
    ("modified_huber_loss", "modified_huber_loss",
     {"X": _NAN_COT_X.reshape(6, 1),
      "Y": np.array([1, 0, 1, 1, 1, 0], np.float32).reshape(6, 1)}, {}),
]


@pytest.mark.parametrize("case", NAN_COT_CASES, ids=lambda c: c[0])
def test_nan_cotangent_reaches_both_operands(case):
    """A NaN cotangent goes through the 0 / ½ / 1 mask of the max-like
    ops as a product, as in the JAX package: the operand that was not
    chosen, and a clipped input, get NaN where the cotangent is NaN."""
    _, op_type, inputs, attrs = case
    out = _run_jax(_op_dict(op_type, inputs, ["Out"], attrs),
                   inputs)["out_Out"]
    cot = np.ones(out.shape, np.float32).reshape(-1)
    cot[::3] = np.nan
    want, got = _both_grads(op_type, inputs, attrs, cot.reshape(out.shape))
    assert set(got) == set(want) and want
    for name in want:
        assert np.isnan(want[name]).any(), name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_modified_huber_grad_at_a_nan_input():
    """At X = NaN ``modified_huber_loss``'s grad is NaN in the JAX package
    under a finite cotangent: the NaN reaches its max through the
    cotangent of ``m * m``, which the mask multiplies."""
    inputs = {"X": np.array([[np.nan], [0.5], [-3.0]], np.float32),
              "Y": np.array([[1.0], [0.0], [1.0]], np.float32)}
    want, got = _both_grads("modified_huber_loss", inputs, {},
                            np.ones((3, 1), np.float32))
    assert np.isnan(want["in_X@GRAD"][0, 0])
    np.testing.assert_array_equal(got["in_X@GRAD"], want["in_X@GRAD"])


def test_max_ties_still_split_evenly():
    """Ties share a group's cotangent evenly in both packages."""
    x = np.array([[1, 3, 3, 2], [4, 4, 4, 0]], np.float32)
    want, got = _both_grads("reduce_max", {"X": x},
                            {"dim": [1], "keep_dim": False,
                             "reduce_all": False}, [1.0, 3.0])
    np.testing.assert_array_equal(got["in_X@GRAD"], want["in_X@GRAD"])
    np.testing.assert_array_equal(got["in_X@GRAD"],
                                  [[0, .5, .5, 0], [1, 1, 1, 0]])


@pytest.mark.parametrize("pool", ["MAX", "MIN"])
@pytest.mark.parametrize("cot_kind", ["ones", "zero"])
def test_sequence_pool_grad_at_nan(pool, cot_kind):
    """``sequence_pool`` MAX / MIN over a sequence holding a NaN: the NaN
    column of that sequence takes no grad, in both packages, under a
    cotangent of ones and a zero one."""
    x = np.array([[1, 2], [np.nan, 0], [3, 3], [1, 3]], np.float32)
    lod = [[0, 2, 4]]
    outs = ["Out", "MaxIndex"] if pool == "MAX" else ["Out"]
    d = _grad_program_dict("sequence_pool", {"X": x}, outs,
                           {"pooltype": pool})
    feed = {"in_X": (x, lod),
            "cot": np.full((2, 2), 1.0 if cot_kind == "ones" else 0.0,
                           np.float32)}
    results = []
    for pkg in (fluid, pt):
        prog = pkg.Program.from_dict(d)
        pkg.append_backward(prog.global_block().var("loss"))
        (g,) = _run(pkg, prog, feed, ["in_X@GRAD"])
        results.append(np.asarray(g))
    want, got = results
    assert np.isfinite(got).all(), got
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# 7. integer inputs
# ---------------------------------------------------------------------------

INTS = np.array([1, 2, 4, 2147483647, 1, 0], np.int32)
INT_CASES = [
    ("mean", {}, np.float32),
    ("reduce_mean", {"dim": [0], "keep_dim": False, "reduce_all": False},
     np.float32),
    ("reduce_mean", {"dim": [0], "keep_dim": False, "reduce_all": True},
     np.float32),
    ("sign", {}, np.int32),
    ("reduce_sum", {"dim": [0], "keep_dim": False, "reduce_all": False},
     np.int32),
]


@pytest.mark.parametrize("case", INT_CASES,
                         ids=["mean", "reduce_mean", "reduce_mean_all",
                              "sign", "reduce_sum"])
def test_integer_inputs(case):
    """An int32 input: ``mean`` and ``reduce_mean`` compute in float32
    (357913952.0 for ``INTS``), ``sign`` stays int32 and ``reduce_sum``
    stays int32 and wraps at 2**31, as in the JAX package."""
    op_type, attrs, dtype = case
    x = INTS if op_type != "sign" else np.array([-7, 0, 3], np.int32)
    d = _op_dict(op_type, {"X": x}, ["Out"], attrs)
    want = _run_jax(d, {"X": x})["out_Out"]
    got = _run_torch(d, {"X": x})["out_Out"]
    assert got.dtype == want.dtype == dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)
    if op_type.endswith("mean"):
        np.testing.assert_array_equal(got, [357913952.0])


def test_layers_mean_of_int_runs():
    """``layers.mean`` of an int32 variable runs through
    ``Executor.run`` in both packages and gives the float32 mean."""
    results = []
    for pkg in (fluid, pt):
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            xv = pkg.layers.data("x", shape=[6], dtype="int32",
                                 append_batch_size=False)
            m = pkg.layers.mean(xv)
        (out,) = _run(pkg, main, {"x": INTS}, [m])
        results.append(np.asarray(out))
    np.testing.assert_array_equal(results[1], results[0])
    np.testing.assert_array_equal(results[1], [357913952.0])
