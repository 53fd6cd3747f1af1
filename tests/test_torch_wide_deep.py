"""The Wide & Deep CTR model with sparse grads in the port against the JAX
package, on the CPU.

The same program is built in both packages inside ``unique_name_scope``
(equal IR dicts, ignoring ``creation_site``), the JAX startup program is
run, its scope is moved into a port scope (``scope_from_numpy``), and
both take three steps on the same seeded feeds, with duplicate ids in
every batch.  The losses of each step, every parameter and every
optimizer accumulator agree to ``rtol = atol = 1e-5`` (float32 products
summed in different orders, duplicate rows summed in different orders,
three steps of updates).  The reference runs with ``PADDLE_TPU_OPT``
unset (its optimized run diverges from its plain one: ROADMAP, faults of
the reference) and with its ``cross_entropy`` grad counted once, as the
port counts it (``reference_cross_entropy_grad_once``).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.embedding import tables as jax_tables
from paddle_tpu.framework import unique_name_scope as jax_names
from paddle_tpu.models import wide_and_deep as JW
from paddle_tpu_torch.convert import (persistable_names, scope_from_numpy,
                                      to_numpy, to_tensor)
from paddle_tpu_torch.embedding import tables as torch_tables
from paddle_tpu_torch.executor import lower_block
from paddle_tpu_torch.framework import unique_name_scope as torch_names
from paddle_tpu_torch.models import wide_and_deep as TW
from paddle_tpu_torch.selected_rows import SelectedRows
from test_torch_conv import reference_cross_entropy_grad_once  # noqa: F401

TOL = 1e-5
STEPS = 3
PKGS = ((fluid, jax_names, JW), (pt, torch_names, TW))
OPTIMIZERS = {
    "adam": lambda pkg: pkg.optimizer.Adam(learning_rate=0.05),
    "adagrad": lambda pkg: pkg.optimizer.Adagrad(learning_rate=0.2),
    "sgd": lambda pkg: pkg.optimizer.SGD(learning_rate=0.5),
}


@pytest.fixture
def reference(monkeypatch, reference_cross_entropy_grad_once):  # noqa: F811
    monkeypatch.delenv("PADDLE_TPU_OPT", raising=False)


def _strip(d):
    for block in d["blocks"]:
        for op in block["ops"]:
            op.pop("creation_site", None)
    return d


def _build(pkg, names, build, make_opt):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with names("wd_"), pkg.program_guard(main, startup):
        loss, fetch = build(pkg)
        make_opt(pkg).minimize(loss)
    return main, startup, [loss] + fetch


def _run_both(build, make_opt, feeds):
    """Both packages from one state on ``feeds`` (one dict a step); the
    fetches of each step and every persistable variable must agree.
    Returns the port's program, scope and fetches."""
    (jm, js, jf), (tm, ts, tf) = (_build(pkg, names, build, make_opt)
                                  for pkg, names, _ in PKGS)
    assert _strip(tm.to_dict()) == _strip(jm.to_dict())
    assert _strip(ts.to_dict()) == _strip(js.to_dict())
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    jexe.run(js, scope=jscope)
    names = persistable_names(tm)
    tscope = scope_from_numpy({n: np.asarray(jscope.find_var(n))
                               for n in names}, pt.CPUPlace(), tm)
    texe = pt.Executor(pt.CPUPlace())
    fetched = []
    for step, feed in enumerate(feeds):
        want = jexe.run(jm, feed=feed, fetch_list=jf, scope=jscope)
        got = texe.run(tm, feed=feed, fetch_list=tf, scope=tscope)
        for var, w, g in zip(tf, want, got):
            np.testing.assert_allclose(g, np.asarray(w), rtol=TOL, atol=TOL,
                                       err_msg=f"step {step}: {var.name}")
        fetched.append(got)
    for n in names:
        np.testing.assert_allclose(to_numpy(tscope.find_var(n)),
                                   np.asarray(jscope.find_var(n)), rtol=TOL,
                                   atol=TOL, err_msg=n)
    return tm, tscope, fetched


# ---------------------------------------------------------------------------
# the zoo model: wide_and_deep_train_program
# ---------------------------------------------------------------------------

B, SLOTS, VOCAB, DENSE = 8, 4, 64, 8


def _wd(pkg):
    """``wide_and_deep_train_program(8)`` of ``pkg``'s zoo."""
    model = {fluid: JW, pt: TW}[pkg]
    cost, acc, feeds = model.wide_and_deep_train_program(B)
    assert feeds == ["slot_ids", "dense", "label"]
    return cost, [acc]


def _wd_feeds(seed, steps=STEPS):
    """Ids from 12 of the 64 rows: 32 ids a batch, so rows repeat."""
    rng = np.random.RandomState(seed)
    return [{"slot_ids": rng.randint(0, 12, (B, SLOTS, 1)).astype("int64"),
             "dense": rng.rand(B, DENSE).astype("float32"),
             "label": rng.randint(0, 2, (B, 1)).astype("int64")}
            for _ in range(steps)]


def test_program_ir_matches_reference():
    progs = []
    for pkg, names, model in PKGS:
        main, startup = pkg.Program(), pkg.Program()
        with names("wd_"), pkg.program_guard(main, startup):
            cost, acc, feeds = model.wide_and_deep_train_program(
                16, vocab_size=128, num_slots=3, emb_dim=4, hidden=8)
        progs.append((_strip(main.to_dict()), _strip(startup.to_dict()),
                      feeds))
    assert progs[0] == progs[1]


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_wide_and_deep_trains_as_the_reference(reference, opt):
    """Three steps of ``wide_and_deep_train_program(8)``: the loss and
    accuracy of each step, both tables, the fc parameters and every
    accumulator (Adam's moments and beta powers, Adagrad's moments)."""
    tm, _, fetched = _run_both(_wd, OPTIMIZERS[opt], _wd_feeds(3))
    assert len({float(f[0].reshape(())) for f in fetched}) == STEPS
    updated = {op.input("Param")[0] for op in tm.global_block().ops
               if op.type == opt}
    assert {"wide_deep_emb", "wide_lr_w"} <= updated


def test_both_tables_get_selected_rows_grads():
    """The grads of both tables that reach ``adam`` are SelectedRows of
    B * slots slots and height vocab, never dense tensors."""
    main, startup, _ = _build(pt, torch_names, _wd, OPTIMIZERS["adam"])
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    env = {n: scope.find_var(n) for n in persistable_names(main)}
    env.update({k: to_tensor(v, "cpu", main.global_block().var(k).dtype)
                for k, v in _wd_feeds(4, 1)[0].items()})
    aux = {"device": torch.device("cpu"), "amp": False, "rng_seed": 0}
    lower_block(main.global_block(), env, aux)
    grads = {op.input("Param")[0]: env[op.input("Grad")[0]]
             for op in main.global_block().ops if op.type == "adam"}
    for table in ("wide_deep_emb", "wide_lr_w"):
        g = grads[table]
        assert isinstance(g, SelectedRows), table
        assert g.rows.shape == (B * SLOTS,) and g.height == VOCAB
    assert all(isinstance(g, torch.Tensor) for p, g in grads.items()
               if p not in ("wide_deep_emb", "wide_lr_w"))


# ---------------------------------------------------------------------------
# the book test's Wide & Deep (tests/test_book_wide_deep.py)
# ---------------------------------------------------------------------------

BOOK_VOCAB, BOOK_BATCH, N_SPARSE, N_DENSE = 8000, 16, 3, 8


def _book_wide_deep(pkg):
    """``_wide_deep(distributed=False)`` of the book test, in ``pkg``."""
    L = pkg.layers
    ids = L.data(name="ids", shape=[BOOK_BATCH, N_SPARSE],
                 append_batch_size=False, dtype="int64")
    dense = L.data(name="dense", shape=[BOOK_BATCH, N_DENSE],
                   append_batch_size=False)
    label = L.data(name="label", shape=[BOOK_BATCH, 1],
                   append_batch_size=False, dtype="int64")
    emb = L.embedding(ids, size=[BOOK_VOCAB, 16], is_sparse=True,
                      param_attr="emb_0")
    deep = L.reshape(x=emb, shape=[BOOK_BATCH, N_SPARSE * 16])
    deep = L.fc(input=deep, size=32, act="relu")
    deep = L.fc(input=deep, size=16, act="relu")
    wide = L.fc(input=dense, size=1)
    logit = L.fc(input=deep, size=1) + wide
    loss = L.mean(L.sigmoid_cross_entropy_with_logits(
        x=logit, label=L.cast(label, "float32")))
    return loss, []


def _book_feeds(seed):
    """``_synthetic_ctr`` of the book test, with a hot id in every batch."""
    rng = np.random.RandomState(seed)
    feeds = []
    for _ in range(STEPS):
        ids = rng.randint(0, BOOK_VOCAB, size=(BOOK_BATCH, N_SPARSE))
        ids[::3, 1] = 42
        dense = rng.rand(BOOK_BATCH, N_DENSE).astype("float32")
        logit = ((ids[:, 0] % 7) - 3) * 0.8 + (dense[:, 0] - 0.5) * 2.0
        click = (1.0 / (1.0 + np.exp(-logit)) > rng.rand(BOOK_BATCH))
        feeds.append({"ids": ids.astype("int64"), "dense": dense,
                      "label": click.astype("int64").reshape(-1, 1)})
    return feeds


def test_book_wide_deep_trains_as_the_reference(reference):
    _, _, fetched = _run_both(_book_wide_deep, OPTIMIZERS["adagrad"],
                              _book_feeds(0))
    assert all(np.isfinite(f[0]).all() for f in fetched)


# ---------------------------------------------------------------------------
# sum of SelectedRows: one table, two lookups; a regularized table
# ---------------------------------------------------------------------------

V2, D2 = 20, 4


def _two_lookups(pkg, regularized=False):
    """One table read by two lookups (the backward sums two SelectedRows
    grads) or, ``regularized``, one lookup of a table with an ``L2Decay``
    (the regularizer sums its dense decay into the SelectedRows grad)."""
    L = pkg.layers
    a = L.data(name="a", shape=[6, 2, 1], append_batch_size=False,
               dtype="int64")
    b = L.data(name="b", shape=[6, 3, 1], append_batch_size=False,
               dtype="int64")
    attr = pkg.ParamAttr(name="shared_emb", regularizer=(
        pkg.regularizer.L2Decay(0.1) if regularized else None))
    ea = L.embedding(a, size=[V2, D2], is_sparse=True, param_attr=attr)
    parts = [L.reshape(ea, [6, 2 * D2])]
    if not regularized:
        eb = L.embedding(b, size=[V2, D2], is_sparse=True, param_attr=attr)
        parts.append(L.reshape(eb, [6, 3 * D2]))
    out = L.fc(L.concat(parts, axis=1), 1)
    return L.mean(out * out), []


def _two_lookup_feeds(seed):
    rng = np.random.RandomState(seed)
    return [{"a": rng.randint(0, 6, (6, 2, 1)).astype("int64"),
             "b": rng.randint(3, 9, (6, 3, 1)).astype("int64")}
            for _ in range(STEPS)]


def _sum_inputs(program, table):
    """The inputs of the ``sum`` op that makes ``table``'s grad."""
    (op,) = [op for op in program.global_block().ops
             if op.type == "sum" and
             table + "@GRAD" in op.output("Out")[0]]
    return op.input("X")


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_one_table_two_lookups_trains_as_the_reference(reference, opt):
    tm, _, _ = _run_both(_two_lookups, OPTIMIZERS[opt],
                         _two_lookup_feeds(5))
    makers = {op.output("W@GRAD")[0] for op in tm.global_block().ops
              if op.type == "lookup_table_grad"}
    assert sorted(_sum_inputs(tm, "shared_emb")) == sorted(makers)
    assert len(makers) == 2


@pytest.mark.parametrize("opt", ["sgd", "adam", "adagrad"])
def test_regularized_sparse_table_trains_as_the_reference(reference, opt):
    tm, _, _ = _run_both(lambda pkg: _two_lookups(pkg, regularized=True),
                         OPTIMIZERS[opt], _two_lookup_feeds(6))
    assert len(_sum_inputs(tm, "shared_emb")) == 2      # grad + decay


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------

def _port_wd(sparse, make_opt=OPTIMIZERS["sgd"]):
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 11
    with torch_names("wd_"), pt.program_guard(main, startup):
        cost, _, _ = TW.wide_and_deep_train_program(B)
        for op in main.global_block().ops:
            if op.type == "lookup_table":
                op.attrs["is_sparse"] = sparse
        make_opt(pt).minimize(cost)
    return main, startup, cost


def test_sparse_and_dense_sgd_agree():
    """``is_sparse=True`` and ``False`` take the same SGD steps."""
    state, results = None, []
    for sparse in (True, False):
        main, startup, cost = _port_wd(sparse)
        grad_ops = [op for op in main.global_block().ops
                    if op.type == "lookup_table_grad"]
        assert {op.attr("is_sparse") for op in grad_ops} == {sparse}
        exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
        exe.run(startup, scope=scope)
        names = persistable_names(main)
        if state is None:
            state = {n: to_numpy(scope.find_var(n)) for n in names}
        scope = scope_from_numpy(state, pt.CPUPlace(), main)
        losses = [exe.run(main, feed=f, fetch_list=[cost], scope=scope)[0]
                  for f in _wd_feeds(8)]
        results.append((losses, {n: to_numpy(scope.find_var(n))
                                 for n in names}))
    (ls, ps), (ld, pd) = results
    np.testing.assert_allclose(ls, ld, rtol=1e-6, atol=1e-6)
    for n in ps:
        np.testing.assert_allclose(ps[n], pd[n], rtol=1e-6, atol=1e-6,
                                   err_msg=n)


def test_embedding_registers_its_tables_in_both_packages():
    metas = []
    for (pkg, names, _), tables in zip(PKGS, (jax_tables, torch_tables)):
        with names("reg_"), pkg.program_guard(pkg.Program(), pkg.Program()):
            ids = pkg.layers.data(name="ids", shape=[4, 1], dtype="int64",
                                  append_batch_size=False)
            w = pkg.layers.embedding(ids, size=[30, 6])
            name = pkg.default_main_program().global_block().ops[-1] \
                .input("W")[0]
        assert tables.is_table(name) and not tables.is_table(w.name)
        metas.append((name, tables.table_meta(name)))
    assert metas[0] == metas[1] == (metas[0][0], {"vocab": 30, "dim": 6})
    assert torch_tables.owner_of([0, 9, 10, 29], 30, 3).tolist() == \
        jax_tables.owner_of([0, 9, 10, 29], 30, 3).tolist() == [0, 0, 1, 2]
    assert torch_tables.local_row([0, 9, 10, 29], 30, 3).tolist() == \
        [0, 9, 0, 9]
    with pytest.raises(ValueError, match="divisible"):
        torch_tables.rows_per_shard(30, 4)


def test_sparse_step_leaves_the_callers_arrays_unchanged():
    """The sparse updates write the scope's tensors in place; a scope made
    from numpy arrays owns copies, and a fetched parameter is a copy."""
    main, startup, cost = _port_wd(True, OPTIMIZERS["adam"])
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    names = persistable_names(main)
    arrays = {n: to_numpy(scope.find_var(n)) for n in names}
    before = {n: a.copy() for n, a in arrays.items()}
    scope = scope_from_numpy(arrays, pt.CPUPlace(), main)
    feeds = _wd_feeds(9)
    (table,) = exe.run(main, feed=feeds[0], fetch_list=["wide_deep_emb"],
                       scope=scope)
    fetched = table.copy()
    exe.run(main, feed=feeds[1], fetch_list=[cost], scope=scope)
    for n in names:
        np.testing.assert_array_equal(arrays[n], before[n], err_msg=n)
    np.testing.assert_array_equal(table, fetched)
    moved = to_numpy(scope.find_var("wide_deep_emb"))
    assert (moved != before["wide_deep_emb"]).any()
    assert (moved != fetched).any()
