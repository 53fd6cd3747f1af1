"""The port's sparse-gradient subsystem against the JAX package's, on the
CPU: ``SelectedRows`` (``selected_rows.py``), the registry's densifying
of a SelectedRows read through a slot that does not declare it, the
``is_sparse`` grad of ``lookup_table``, the SelectedRows branches of
``sgd``, ``adam``, ``adagrad`` and ``sum``, the ops of
``ops/sparse_ops.py`` and ``sigmoid_cross_entropy_with_logits``.

Each op runs through both packages' lowerings on the same seeded numpy
inputs.  Tolerance: float32 ``rtol = atol = 1e-6`` (XLA and torch round
``sqrt`` and division in the last bit, and sum duplicate rows in
different orders); rows, heights and integer outputs exactly.  ``nce``
runs through both packages' programs and ``append_backward``: ``1e-5``
for its cost and grads (its products over ``D`` sum in different
orders, then ``log`` and a sum over samples).  The port's rows are
int64 where the reference's are int32 (values are compared, not
dtypes)."""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.framework import unique_name_scope as jax_names
from paddle_tpu.ops import registry as jax_registry
from paddle_tpu.selected_rows import SelectedRows as JaxRows
from paddle_tpu_torch.convert import (persistable_names, scope_from_numpy,
                                      to_numpy)
from paddle_tpu_torch.framework import unique_name_scope as torch_names
from paddle_tpu_torch.ops import registry as torch_registry
from paddle_tpu_torch.selected_rows import SelectedRows, to_dense

TOL = 1e-6
NCE_TOL = 1e-5
PKGS = ((fluid, jax_names), (pt, torch_names))

#: a SelectedRows as numpy: rows [N] int, value [N, ...], height
Rows = collections.namedtuple("Rows", "rows value height")


def _f(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _jax(v):
    if isinstance(v, Rows):
        return JaxRows(jnp.asarray(v.rows, jnp.int32), jnp.asarray(v.value),
                       v.height)
    return jnp.asarray(v)


def _torch(v):
    if isinstance(v, Rows):
        return SelectedRows(torch.from_numpy(np.asarray(v.rows, np.int64)),
                            torch.from_numpy(v.value.copy()), v.height)
    return torch.from_numpy(np.array(v))


def _numpy(v):
    if isinstance(v, (JaxRows, SelectedRows)):
        return Rows(np.asarray(v.rows).astype(np.int64),
                    np.asarray(v.value), v.height)
    return np.asarray(v) if not isinstance(v, torch.Tensor) else to_numpy(v)


def _assert_same(got, want, tol=TOL, what=""):
    if isinstance(want, Rows):
        assert isinstance(got, Rows), what
        assert got.height == want.height, what
        np.testing.assert_array_equal(got.rows, want.rows, err_msg=what)
        got, want = got.value, want.value
    assert got.shape == want.shape, what
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   err_msg=what)


def _run_jax(op, env, block, grad):
    if grad:
        ctx = jax_registry.LowerContext(op, env, block)
        jax_registry.lookup(op.type[:-len("_grad")]).grad_lower(ctx)
        env.update(ctx.outputs)
    else:
        jax_registry.run_lowering(op, env, block, aux={})


def _run_torch(op, env, block, grad):
    aux = {"device": torch.device("cpu"), "rng_seed": 0}
    ctx = torch_registry.LowerContext(op, env, block, aux=aux)
    torch_registry.resolve_lowering(op.type).lower(ctx)
    env.update(ctx.outputs)


def _run_both(op_type, ins, outs, attrs=None):
    """One op of both packages: ``ins`` slot -> {name: value}, ``outs``
    slot -> [names] (an output may name an input, as the optimizers'
    do).  Returns ``(want, got, port env)``, name -> numpy / Rows."""
    results, env = [], None
    for pkg, to, run in ((fluid, _jax, _run_jax), (pt, _torch, _run_torch)):
        block = pkg.Program().global_block()
        op = pkg.Operator(block, op_type,
                          {s: list(d) for s, d in ins.items()}, outs,
                          dict(attrs or {}))
        env = {n: to(v) for d in ins.values() for n, v in d.items()}
        run(op, env, block, op_type.endswith("_grad"))
        results.append({n: _numpy(env[n])
                        for names in outs.values() for n in names})
    return results[0], results[1], env


def _assert_outputs(want, got, tol=TOL):
    assert set(got) == set(want)
    for n in want:
        _assert_same(got[n], want[n], tol, n)


# ---------------------------------------------------------------------------
# SelectedRows
# ---------------------------------------------------------------------------

def _merged_with_tail(rng, height=10, dim=3):
    """A merged SelectedRows of the reference: unique rows first, then
    tail slots of row ``height`` and value 0."""
    rows = np.array([7, 2, 7, 7, 0, 2], np.int64)
    sr = JaxRows(jnp.asarray(rows, jnp.int32), jnp.asarray(_f(rng, 6, dim)),
                 height).merge_duplicates()
    return Rows(np.asarray(sr.rows).astype(np.int64), np.asarray(sr.value),
                height)


SR_CASES = {
    "duplicates": Rows(np.array([5, 1, 5, 1, 5, 0], np.int64),
                       _f(np.random.RandomState(1), 6, 4), 8),
    "one_row_repeated": Rows(np.full(9, 3, np.int64),
                             _f(np.random.RandomState(2), 9, 2), 5),
    "merged_with_tail": _merged_with_tail(np.random.RandomState(3)),
    "unsorted_unique": Rows(np.array([4, 0, 9, 2], np.int64),
                            _f(np.random.RandomState(4), 4, 3), 10),
}


@pytest.mark.parametrize("case", sorted(SR_CASES))
def test_to_dense_matches_reference(case):
    sr = SR_CASES[case]
    want = np.asarray(_jax(sr).to_dense())
    got = to_numpy(_torch(sr).to_dense())
    _assert_same(got, want)


@pytest.mark.parametrize("case", sorted(SR_CASES))
def test_merge_duplicates_matches_reference(case):
    """Rows and values slot for slot, the tail slots (row = height,
    value 0) included."""
    sr = SR_CASES[case]
    want = _numpy(_jax(sr).merge_duplicates())
    got = _numpy(_torch(sr).merge_duplicates())
    _assert_same(got, want)
    assert len(got.rows) == len(sr.rows)
    n_unique = len(np.unique(sr.rows))
    assert (got.rows[n_unique:] == sr.height).all()
    assert (got.value[n_unique:] == 0).all()


def test_to_dense_accumulates_duplicates_and_drops_tail_rows():
    sr = SelectedRows(torch.tensor([2, 0, 2, 4, 4]),
                      torch.tensor([[1.0], [2.0], [3.0], [5.0], [6.0]]), 4)
    np.testing.assert_array_equal(to_numpy(sr.to_dense()),
                                  [[2.0], [0.0], [4.0], [0.0]])
    # the slot count stays: the tail slots add a zero at a clamped row
    rows, value = sr.clamped()
    np.testing.assert_array_equal(to_numpy(rows), [2, 0, 2, 3, 3])
    np.testing.assert_array_equal(to_numpy(value),
                                  [[1.0], [2.0], [3.0], [0.0], [0.0]])


def test_astype_and_shape():
    sr = _torch(SR_CASES["duplicates"])
    assert sr.shape == (8, 4) == _jax(SR_CASES["duplicates"]).shape
    half = sr.astype(torch.bfloat16)
    assert half.dtype == torch.bfloat16 and half.shape == sr.shape
    assert half.rows is sr.rows and half.height == sr.height
    assert to_dense(half).dtype == torch.bfloat16
    x = torch.ones(2)
    assert to_dense(x) is x


# ---------------------------------------------------------------------------
# registry: densify where a slot does not declare SelectedRows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("amp", [False, True])
def test_undeclared_slot_reads_selected_rows_dense(amp):
    """``mul`` declares no SelectedRows slot: its X arrives dense (and,
    with AMP, then cast to bf16 as its ``amp_cast`` says); ``sgd``'s
    ``Grad`` declares one and arrives as the SelectedRows itself."""
    sr = _torch(SR_CASES["duplicates"])
    block = pt.Program().global_block()
    aux = {"device": torch.device("cpu"), "amp": amp}
    env = {"x": sr, "p": torch.zeros(8, 4)}
    mul = pt.Operator(block, "mul", {"X": ["x"], "Y": ["p"]}, {}, {})
    x = torch_registry.LowerContext(mul, env, block, aux=aux).input("X")
    assert isinstance(x, torch.Tensor)
    assert x.dtype == (torch.bfloat16 if amp else torch.float32)
    np.testing.assert_array_equal(to_numpy(x.float()),
                                  to_numpy(sr.to_dense().to(x.dtype).float()))
    scale = pt.Operator(block, "scale", {"X": ["x"]}, {}, {})
    assert isinstance(torch_registry.LowerContext(
        scale, env, block, aux=aux).inputs("X")[0], torch.Tensor)
    sgd = pt.Operator(block, "sgd", {"Param": ["p"], "Grad": ["x"]}, {}, {})
    assert torch_registry.LowerContext(sgd, env, block,
                                       aux=aux).input("Grad") is sr


def test_undeclared_slot_matches_reference_lowering():
    """A SelectedRows through ``scale``'s X: both packages densify."""
    sr = SR_CASES["merged_with_tail"]
    want, got, _ = _run_both("scale", {"X": {"x": sr}}, {"Out": ["out"]},
                             {"scale": 2.0, "bias": 0.5})
    _assert_outputs(want, got)


# ---------------------------------------------------------------------------
# lookup_table's sparse grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("padding_idx", [-1, 3])
def test_lookup_table_sparse_grad_matches_reference(padding_idx):
    r = np.random.RandomState(5)
    ids = np.array([[[3], [1]], [[3], [6]], [[0], [3]]], np.int64)
    w = _f(r, 7, 4)
    ins = {"W": {"w": w}, "Ids": {"ids": ids},
           "Out": {"out": w[ids[..., 0]]},
           "Out@GRAD": {"dout": _f(r, 3, 2, 4)}}
    want, got, _ = _run_both(
        "lookup_table_grad", ins, {"W@GRAD": ["dw"]},
        {"is_sparse": True, "padding_idx": padding_idx})
    _assert_outputs(want, got)
    assert isinstance(got["dw"], Rows) and len(got["dw"].rows) == 6
    if padding_idx >= 0:                 # the slots stay, value zero
        assert (got["dw"].value[got["dw"].rows == padding_idx] == 0).all()


def test_lookup_table_sparse_grad_densifies_to_the_dense_grad():
    """The SelectedRows grad, densified, is the dense (auto-vjp) grad."""
    r = np.random.RandomState(6)
    ids = r.randint(0, 5, (4, 3, 1)).astype(np.int64)
    w = _f(r, 5, 2)
    ins = {"W": {"w": w}, "Ids": {"ids": ids},
           "Out": {"out": w[ids[..., 0]]},
           "Out@GRAD": {"dout": _f(r, 4, 3, 2)}}
    outs = {}
    for sparse in (False, True):
        _, got, env = _run_both("lookup_table_grad", ins,
                                {"W@GRAD": ["dw"]},
                                {"is_sparse": sparse, "padding_idx": -1})
        outs[sparse] = to_dense(env["dw"])
    np.testing.assert_allclose(to_numpy(outs[True]), to_numpy(outs[False]),
                               rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# sgd / adam / adagrad sparse branches
# ---------------------------------------------------------------------------

def _grad_case(case, dim):
    """The SelectedRows grads of the update tests, at width ``dim``."""
    r = np.random.RandomState(8)
    H = 10
    if case == "duplicates":
        return Rows(np.array([4, 1, 4, 9, 1, 4], np.int64), _f(r, 6, dim), H)
    if case == "merged_with_tail":
        return _merged_with_tail(r, H, dim)
    return Rows(np.full(7, 6, np.int64), _f(r, 7, dim), H)  # one row x 7


UPDATE_CASES = ("duplicates", "merged_with_tail", "one_row_repeated")


def _update_inputs(op_type, g):
    r = np.random.RandomState(9)
    H, D = g.height, g.value.shape[1]
    lr = np.array([0.05], np.float32)
    if op_type == "sgd":
        ins = {"Param": {"p": _f(r, H, D)}, "Grad": {"g": g},
               "LearningRate": {"lr": lr}}
        return ins, {"ParamOut": ["p"]}, {}
    if op_type == "adagrad":
        ins = {"Param": {"p": _f(r, H, D)}, "Grad": {"g": g},
               "Moment": {"m": np.abs(_f(r, H, D))},
               "LearningRate": {"lr": lr}}
        return ins, {"ParamOut": ["p"], "MomentOut": ["m"]}, \
            {"epsilon": 1e-6}
    ins = {"Param": {"p": _f(r, H, D)}, "Grad": {"g": g},
           "Moment1": {"m1": _f(r, H, D) * 0.1},
           "Moment2": {"m2": np.abs(_f(r, H, D)) * 0.01},
           "Beta1Pow": {"b1": np.array([0.9 ** 3], np.float32)},
           "Beta2Pow": {"b2": np.array([0.999 ** 3], np.float32)},
           "LearningRate": {"lr": lr}}
    outs = {"ParamOut": ["p"], "Moment1Out": ["m1"], "Moment2Out": ["m2"],
            "Beta1PowOut": ["b1"], "Beta2PowOut": ["b2"]}
    return ins, outs, {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}


@pytest.mark.parametrize("case", UPDATE_CASES)
@pytest.mark.parametrize("op_type", ["sgd", "adam", "adagrad"])
def test_sparse_update_matches_reference(op_type, case):
    """Duplicate rows, an already merged grad with tail slots (row =
    height: dropped, no error) and one row repeated: every output of
    the port's in-place update equals the reference's functional one,
    and the rows the grad does not name keep their values."""
    g = _grad_case(case, 3)
    ins, outs, attrs = _update_inputs(op_type, g)
    before = {n: v.copy() for d in ins.values() for n, v in d.items()
              if not isinstance(v, Rows)}
    want, got, env = _run_both(op_type, ins, outs, attrs)
    _assert_outputs(want, got)
    untouched = np.setdiff1d(np.arange(g.height), g.rows)
    for slot, names in outs.items():
        if slot.startswith(("Param", "Moment")):
            np.testing.assert_array_equal(got[names[0]][untouched],
                                          before[names[0]][untouched])


@pytest.mark.parametrize("op_type", ["sgd", "adam", "adagrad"])
def test_sparse_update_is_in_place(op_type):
    """With the outputs bound to the inputs' names (as every optimizer
    binds them) the port updates the state tensors themselves; bound to
    other names, it leaves the inputs as they were."""
    ins, outs, attrs = _update_inputs(op_type, _grad_case("duplicates", 2))
    block = pt.Program().global_block()
    env = {n: _torch(v) for d in ins.values() for n, v in d.items()}
    state = {n: env[n] for names in outs.values() for n in names
             if not n.startswith("b")}
    op = pt.Operator(block, op_type, {s: list(d) for s, d in ins.items()},
                     outs, attrs)
    torch_registry.run_lowering(op, env, block,
                                aux={"device": torch.device("cpu")})
    for n, t in state.items():
        assert env[n] is t, n
    renamed = {s: [names[0] + "_new"] for s, names in outs.items()}
    env = {n: _torch(v) for d in ins.values() for n, v in d.items()}
    op = pt.Operator(block, op_type, {s: list(d) for s, d in ins.items()},
                     renamed, attrs)
    torch_registry.run_lowering(op, env, block,
                                aux={"device": torch.device("cpu")})
    for d in ins.values():
        for n, v in d.items():
            if not isinstance(v, Rows):
                np.testing.assert_array_equal(to_numpy(env[n]), v, n)
    want, _, _ = _run_both(op_type, ins, outs, attrs)
    for s, names in outs.items():
        _assert_same(to_numpy(env[renamed[s][0]]), want[names[0]])


# ---------------------------------------------------------------------------
# sum
# ---------------------------------------------------------------------------

def test_sum_of_selected_rows_concatenates():
    a, b = SR_CASES["duplicates"], Rows(np.array([0, 7], np.int64),
                                        _f(np.random.RandomState(10), 2, 4),
                                        8)
    want, got, env = _run_both("sum", {"X": {"a": a, "b": b}},
                               {"Out": ["out"]})
    _assert_outputs(want, got)
    assert isinstance(env["out"], SelectedRows)
    assert len(got["out"].rows) == len(a.rows) + len(b.rows)


def test_sum_of_mixed_inputs_densifies():
    r = np.random.RandomState(11)
    a = SR_CASES["duplicates"]
    ins = {"X": {"a": a, "d": _f(r, 8, 4),
                 "t": _merged_with_tail(r, 8, 4)}}
    want, got, env = _run_both("sum", ins, {"Out": ["out"]})
    _assert_outputs(want, got)
    assert isinstance(env["out"], torch.Tensor)


# ---------------------------------------------------------------------------
# ops/sparse_ops.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(SR_CASES))
def test_merge_selected_rows_matches_reference(case):
    want, got, _ = _run_both("merge_selected_rows",
                             {"X": {"x": SR_CASES[case]}}, {"Out": ["out"]})
    _assert_outputs(want, got)


def test_merge_selected_rows_passes_a_dense_input():
    x = _f(np.random.RandomState(12), 3, 2)
    want, got, _ = _run_both("merge_selected_rows", {"X": {"x": x}},
                             {"Out": ["out"]})
    _assert_outputs(want, got)


@pytest.mark.parametrize("case", sorted(SR_CASES))
def test_get_tensor_from_selected_rows_matches_reference(case):
    want, got, _ = _run_both("get_tensor_from_selected_rows",
                             {"X": {"x": SR_CASES[case]}}, {"Out": ["out"]})
    _assert_outputs(want, got)


SPLIT_CASES = {
    # rows in every section, and some outside each
    "sections": (Rows(np.array([0, 11, 4, 8, 3, 9, 4], np.int64),
                      _f(np.random.RandomState(13), 7, 2), 12), [4, 5, 3]),
    # a merged input: its tail rows (= 12) lie outside every section
    "merged_with_tail": (_merged_with_tail(np.random.RandomState(14), 12,
                                           2), [8, 4]),
    "dense": (_f(np.random.RandomState(15), 5, 3), [2, 3]),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_selected_rows_matches_reference(case):
    x, sections = SPLIT_CASES[case]
    outs = [f"out{i}" for i in range(len(sections))]
    want, got, env = _run_both("split_selected_rows", {"X": {"x": x}},
                               {"Out": outs}, {"height_sections": sections})
    _assert_outputs(want, got)
    # each section densifies (rows outside it dropped) to its block of X
    dense = to_numpy(to_dense(_torch(x)))
    offset = 0
    for name, h in zip(outs, sections):
        np.testing.assert_allclose(to_numpy(env[name].to_dense()),
                                   dense[offset:offset + h], rtol=TOL,
                                   atol=TOL)
        offset += h


@pytest.mark.parametrize("shards", [1, 3])
def test_split_ids_matches_reference(shards):
    ids = np.random.RandomState(16).randint(0, 50, (9, 1)).astype(np.int64)
    outs = [f"out{i}" for i in range(shards)]
    want, got, _ = _run_both("split_ids", {"Ids": {"ids": ids}},
                             {"Out": outs})
    _assert_outputs(want, got)


# ---------------------------------------------------------------------------
# nce
# ---------------------------------------------------------------------------

N, D, T, CLASSES, NEG = 6, 5, 2, 20, 3
CUSTOM_NEG = [17, 4, 9]


def _nce_program(pkg, names, bias, weighted, custom_neg=True):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with names("nce_"), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[N, D], dtype="float32",
                            append_batch_size=False)
        x.stop_gradient = False
        label = pkg.layers.data(name="label", shape=[N, T], dtype="int64",
                                append_batch_size=False)
        sw = pkg.layers.data(name="sw", shape=[N, 1], dtype="float32",
                             append_batch_size=False) if weighted else None
        cost = pkg.layers.nce(x, label, CLASSES, sample_weight=sw,
                              bias_attr=None if bias else False,
                              num_neg_samples=NEG)
        nce = next(op for op in main.global_block().ops
                   if op.type == "nce")
        if custom_neg:
            nce.attrs["custom_neg_classes"] = list(CUSTOM_NEG)
        loss = pkg.layers.mean(cost)
        pkg.append_backward(loss)
    return main, startup, cost, nce


def _nce_feed():
    r = np.random.RandomState(17)
    return {"x": _f(r, N, D),
            "label": r.randint(0, CLASSES, (N, T)).astype(np.int64),
            "sw": np.abs(_f(r, N, 1))}


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("weighted", [True, False])
def test_nce_matches_reference(bias, weighted):
    """Cost, sample logits and labels, and the grads of the input, the
    weight and the bias, with ``custom_neg_classes``."""
    (jm, js, jc, jop), (tm, ts, tc, top) = (
        _nce_program(pkg, names, bias, weighted) for pkg, names in PKGS)
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    jexe.run(js, scope=jscope)
    tscope = scope_from_numpy(
        {n: np.asarray(jscope.find_var(n)) for n in persistable_names(tm)},
        pt.CPUPlace(), tm)
    feed = _nce_feed()
    if not weighted:
        feed.pop("sw")
    fetch = [jc.name, jop.output("SampleLogits")[0],
             jop.output("SampleLabels")[0], "x@GRAD"]
    fetch += [n + "@GRAD" for n in persistable_names(tm)]
    assert len(fetch) == (6 if bias else 5)
    want = jexe.run(jm, feed=feed, fetch_list=fetch, scope=jscope)
    got = pt.Executor(pt.CPUPlace()).run(tm, feed=feed, fetch_list=fetch,
                                         scope=tscope)
    for name, w, g in zip(fetch, want, got):
        _assert_same(g.astype(np.asarray(w).dtype), np.asarray(w), NCE_TOL,
                     name)
    labels = got[2]
    np.testing.assert_array_equal(labels[:, T:],
                                  np.broadcast_to(CUSTOM_NEG, (N, NEG)))


def test_nce_draws_negatives_in_range_by_the_seed():
    """Without ``custom_neg_classes`` the port draws the negatives from
    its own generator: in ``[0, classes)``, the labels first, the same
    draws for the same seed and run, others for another seed."""
    def draws(seed):
        main, startup, cost, nce = _nce_program(pt, torch_names, True,
                                                False, custom_neg=False)
        main.random_seed = seed
        exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
        exe.run(startup, scope=scope)
        feed = _nce_feed()
        feed.pop("sw")
        (labels,) = exe.run(main, feed=feed,
                            fetch_list=[nce.output("SampleLabels")[0]],
                            scope=scope)
        return feed["label"], labels

    label, a = draws(1)
    _, b = draws(1)
    _, c = draws(2)
    assert a.shape == (N, T + NEG)
    np.testing.assert_array_equal(a[:, :T], label)
    assert ((a >= 0) & (a < CLASSES)).all()
    np.testing.assert_array_equal(a, b)
    assert (a[:, T:] != c[:, T:]).any()


def test_nce_rejects_a_custom_list_of_the_wrong_length():
    main, startup, cost, nce = _nce_program(pt, torch_names, True, False)
    nce.attrs["custom_neg_classes"] = [1, 2]
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    feed = _nce_feed()
    feed.pop("sw")
    with pytest.raises(ValueError, match="custom_neg_classes"):
        exe.run(main, feed=feed, fetch_list=[cost], scope=scope)


# ---------------------------------------------------------------------------
# sigmoid_cross_entropy_with_logits
# ---------------------------------------------------------------------------

def _sigmoid_ce(pkg, x, z):
    main = pkg.Program()
    with pkg.program_guard(main, pkg.Program()):
        xv = pkg.layers.data(name="x", shape=list(x.shape), dtype="float32",
                             append_batch_size=False)
        xv.stop_gradient = False
        zv = pkg.layers.data(name="z", shape=list(z.shape), dtype="float32",
                             append_batch_size=False)
        out = pkg.layers.sigmoid_cross_entropy_with_logits(xv, zv)
        loss = pkg.layers.reduce_sum(out * out)
        pkg.append_backward(loss)
    return [np.asarray(v) for v in pkg.Executor(pkg.CPUPlace()).run(
        main, feed={"x": x, "z": z}, fetch_list=[out, "x@GRAD"],
        scope=pkg.Scope())]


def test_sigmoid_cross_entropy_with_logits_matches_reference():
    r = np.random.RandomState(18)
    x = (_f(r, 6, 5) * 4).astype(np.float32)
    x[0, 0] = 30.0                       # exp(-|x|) underflows to 0
    x[0, 1] = -30.0
    z = r.rand(6, 5).astype(np.float32)
    z[1] = (z[1] > 0.5)                  # hard labels too
    want, got = _sigmoid_ce(fluid, x, z), _sigmoid_ce(pt, x, z)
    for w, g in zip(want, got):
        _assert_same(g, w)


def test_sigmoid_cross_entropy_with_logits_grad_at_zero():
    """At ``x = 0`` exactly the port's grad is ``sigmoid(0) - z``; the
    reference's auto-vjp takes ``abs``'s slope there as +1 and gives
    ``-z`` (ROADMAP, faults of the reference).  The forward agrees."""
    x = np.zeros((1, 3), np.float32)
    z = np.array([[0.0, 0.25, 1.0]], np.float32)
    (jout, jgrad), (tout, tgrad) = (_sigmoid_ce(pkg, x, z)
                                    for pkg in (fluid, pt))
    _assert_same(tout, jout)
    dloss = 2 * tout                      # d(out * out) / d out
    np.testing.assert_allclose(tgrad, dloss * (0.5 - z), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(jgrad, dloss * (-z), rtol=TOL, atol=TOL)
