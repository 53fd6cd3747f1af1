"""The port's static-shape control flow and sparse grads on the CPU,
against the JAX package where it runs the same program: the bounded
``while`` (carries frozen after the condition falls, nested loops
gated by the outer mask, the exhausted bound's error), tensor arrays as
device buffers written in place in a loop, ``conditional_block`` with an
array write on both predicates, the beam decode under the buckets, and
SelectedRows updates with dead slots.  Then the capture rule: the
bucketed seq2seq's, W&D's and the bucketed beam decode's blocks hold no
op that keeps them eager, and their second steps read nothing on the
host under the ``TorchDispatchMode`` audit.

Float32 results agree to ``rtol = atol = 1e-6`` (as in
``tests/test_torch_control_flow.py``), the sparse updates to
``tests/test_torch_sparse.py``'s ``1e-6``; ids and sentences are
equal."""

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu_torch import executor as texecutor
from paddle_tpu_torch.analysis.opt import clone_program
from paddle_tpu_torch.convert import persistable_names, scope_from_numpy
from paddle_tpu_torch.framework import unique_name_scope as torch_names
from paddle_tpu_torch.models import seq2seq as TS
from paddle_tpu_torch.models import wide_and_deep as TW
from paddle_tpu_torch.ops import registry
from paddle_tpu_torch.ops.control_flow_ops import TensorArray
from test_torch_beam_search import build_decode
from test_torch_compiled import _Audit, recorded  # noqa: F401
from test_torch_control_flow import _f, _nested, _programs, _run_both
from test_torch_sparse import (Rows, _assert_outputs, _update_inputs)
from test_torch_sparse import _run_both as _run_op_both

CPU = pt.CPUPlace()


# ---------------------------------------------------------------------------
# bounded while
# ---------------------------------------------------------------------------

def _doubling(pkg, max_iters=8):
    """``acc = 2 acc + 1`` while ``i < 3``, bounded by ``max_iters``."""
    layers = pkg.layers
    x = layers.data(name="x", shape=[4], append_batch_size=False)
    i = layers.zeros(shape=[1], dtype="int64")
    i.stop_gradient = True
    n = layers.fill_constant(shape=[1], dtype="int64", value=3)
    n.stop_gradient = True
    acc = layers.scale(x, scale=1.0)
    cond = layers.less_than(x=i, y=n)
    w = layers.While(cond=cond)
    with w.block():
        layers.assign(layers.scale(acc, scale=2.0, bias=1.0), output=acc)
        layers.increment(x=i, in_place=True)
        layers.less_than(x=i, y=n, cond=cond)
    for blk in pkg.default_main_program().blocks:
        for op in blk.ops:
            if op.type == "while":
                op.attrs["max_iters"] = max_iters
    return [acc, i, cond]


def test_bounded_while_freezes_its_carries_after_the_condition_falls():
    """8 masked trips of a loop that is live for 3: the carries hold
    their values from the 3rd trip on (as the reference's done-mask
    keeps them), and no condition is read on the host."""
    xv = _f(0, 4)
    (acc, i, cond), exe = _run_both(_doubling, [{"x": xv}])
    np.testing.assert_allclose(acc, 8.0 * xv + 7.0, rtol=1e-6)
    assert int(i[0]) == 3 and not bool(cond.reshape(-1)[0])
    assert exe.last_run == {"while_trips": 8, "host_reads": 0}


def _nested_arrays(pkg):
    """Two outer trips of three inner ones, each inner trip writing
    ``k * x`` at its running index ``k`` into an array first written
    there; bounds 4 and 5 leave frozen trips at both levels."""
    layers = pkg.layers
    x = layers.data(name="x", shape=[2], append_batch_size=False)
    i = layers.zeros(shape=[1], dtype="int64")
    k = layers.zeros(shape=[1], dtype="int64")
    n_o = layers.fill_constant(shape=[1], dtype="int64", value=2)
    n_i = layers.fill_constant(shape=[1], dtype="int64", value=3)
    for v in (i, k, n_o, n_i):
        v.stop_gradient = True
    block = pkg.default_main_program().current_block()
    arr = block.create_var(name="nest_arr", dtype="float32")
    cond = layers.less_than(x=i, y=n_o)
    w = layers.While(cond=cond)
    with w.block():
        j = layers.zeros(shape=[1], dtype="int64")
        j.stop_gradient = True
        icond = layers.less_than(x=j, y=n_i)
        iw = layers.While(cond=icond)
        with iw.block():
            kx = layers.elementwise_mul(
                x, layers.cast(k, "float32"), axis=0)
            layers.array_write(kx, i=k, array=arr)
            layers.increment(x=k, in_place=True)
            layers.increment(x=j, in_place=True)
            layers.less_than(x=j, y=n_i, cond=icond)
        layers.increment(x=i, in_place=True)
        layers.less_than(x=i, y=n_o, cond=cond)
    prog = pkg.default_main_program()
    for blk in prog.blocks:
        for op in blk.ops:
            if op.type == "while":
                op.attrs["max_iters"] = 4 if blk.idx == 0 else 5
    six = layers.fill_constant(shape=[1], dtype="int64", value=6)
    five = layers.fill_constant(shape=[1], dtype="int64", value=5)
    return [layers.array_length(arr), layers.array_read(arr, five),
            layers.array_read(arr, six), k]


def test_nested_bounded_loops_gate_array_writes_by_the_outer_mask():
    """The array holds 6 steps: neither an inner trip past its condition
    nor a whole frozen outer trip (which re-derives a true inner
    condition) writes a row or grows the length, as in the reference."""
    xv = _f(1, 2)
    (length, five, six, k), exe = _run_both(_nested_arrays, [{"x": xv}])
    assert int(length[0]) == 6 and int(k[0]) == 6
    np.testing.assert_allclose(five, 5.0 * xv, rtol=1e-6)
    assert not six.any()
    assert exe.last_run == {"while_trips": 4 + 4 * 5, "host_reads": 0}


EXHAUSTED = ("while loop did not terminate within its static trip bound "
             "of 2 iterations (inferred from TensorArray capacity or the "
             "'max_iters' attr); raise 'max_iters' on the while op")


def test_exhausted_bound_raises_the_reference_text_before_the_write_back():
    """A loop still true after ``max_iters`` trips raises the reference's
    ``RuntimeError`` text, word for word, from the device fault word
    read after the step; the eager step raises before its state is
    written back (a persistable counter the block advances stays)."""
    (jm, js, jf), (tm, ts, tf) = _programs(
        lambda pkg: _nested(pkg, max_iters=2))
    with pytest.raises(Exception) as want:
        fluid.Executor(fluid.CPUPlace()).run(
            jm, fetch_list=[jf[0].name], scope=fluid.Scope())
    assert EXHAUSTED in str(want.value)
    with torch_names("cf_"), pt.program_guard(tm, ts):
        steps = pt.layers.create_global_var(
            shape=[1], value=0.0, dtype="float32", persistable=True,
            name="steps_done")
        pt.layers.assign(steps + 1.0, output=steps)
    exe, scope = pt.Executor(CPU), pt.Scope()
    exe.run(ts, scope=scope)
    with pytest.raises(RuntimeError) as got:
        exe.run(tm, fetch_list=[tf[0].name], scope=scope)
    assert str(got.value) == EXHAUSTED
    assert float(np.asarray(scope.find_var("steps_done"))[0]) == 0.0


def _short_input(pkg, walk):
    """Five trips over an input array of 2 steps read at index 0 (or,
    with ``walk``, at the loop's counter, which outruns it) beside a
    running array of the default capacity the body reads and writes."""
    layers = pkg.layers
    x = layers.data(name="x", shape=[3], append_batch_size=False)
    zero = layers.zeros(shape=[1], dtype="int64")
    i = layers.zeros(shape=[1], dtype="int64")
    n = layers.fill_constant(shape=[1], dtype="int64", value=5)
    for v in (zero, i, n):
        v.stop_gradient = True
    short = layers.array_write(x, zero, capacity=2)
    run = layers.array_write(layers.scale(x, scale=0.0), zero)
    cond = layers.less_than(x=i, y=n)
    w = layers.While(cond=cond)
    with w.block():
        step = layers.array_read(short, i if walk else zero)
        nxt = layers.sums(input=[layers.array_read(run, i), step])
        layers.increment(x=i, in_place=True)
        layers.array_write(nxt, i, array=run)
        layers.less_than(x=i, y=n, cond=cond)
    return [layers.array_read(run, n), i]


def test_trip_bound_is_the_references_unless_an_input_is_walked():
    """The bound is the JAX package's (the largest capacity the body
    reads: 128) for a loop reading a 2-step input at a fixed index, so
    its 5 trips run as in the reference.  Walked by the loop's counter,
    the same input bounds the loop at 2 trips, and the loop that needs 5
    raises its exhausted bound where the port's 128-trip loop would
    raise the read's ``IndexError`` (the reference clamps the read)."""
    xv = _f(5, 3)
    (out, i), exe = _run_both(lambda pkg: _short_input(pkg, False),
                              [{"x": xv}])
    np.testing.assert_allclose(out, 5.0 * xv, rtol=1e-6)
    assert int(i[0]) == 5
    assert exe.last_run == {"while_trips": 128, "host_reads": 0}
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        fetch = _short_input(pt, True)
    with pytest.raises(RuntimeError, match="static trip bound of 2 "):
        pt.Executor(CPU).run(main, feed={"x": xv}, fetch_list=fetch,
                             scope=pt.Scope())


def test_unbounded_while_stays_eager_and_reads_its_condition():
    """Without ``max_iters`` and without an array read in the body the
    loop has no bound: its op keeps the block eager and each trip's
    condition (and the last) is read on the host."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        (acc, i, _) = _doubling(pt, max_iters=None)
    (w,) = [op for op in main.global_block().ops if op.type == "while"]
    del w.attrs["max_iters"]
    assert registry.eager_only(w) and "while" in texecutor._host_ops(
        main.global_block())
    exe = pt.Executor(CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        acc_v, i_v = exe.run(main, feed={"x": np.zeros(4, "float32")},
                             fetch_list=[acc, i], scope=pt.Scope())
    assert int(i_v[0]) == 3 and np.all(acc_v == 7.0)
    assert exe.last_run == {"while_trips": 3, "host_reads": 4}


# ---------------------------------------------------------------------------
# arrays in a loop: one buffer, written in place
# ---------------------------------------------------------------------------

def test_arrays_written_in_a_loop_keep_one_buffer(monkeypatch):
    """A DynamicRNN's memory and output arrays are written in place: every
    write in the loop returns the buffer it was given (the same
    ``data_ptr``), one buffer an array for the whole loop; a write
    outside a loop copies the buffer it was given."""
    layers = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        sent = layers.data(name="sent", shape=[9, 2],
                           append_batch_size=False, lod_level=1)
        drnn = layers.DynamicRNN()
        with drnn.block():
            word = drnn.step_input(sent)
            prev = drnn.memory(shape=[2], value=0.0)
            s = layers.sums(input=[word, prev])
            drnn.update_memory(prev, s)
            drnn.output(s)
        out = layers.sequence_last_step(drnn())
    writes = []
    write = TensorArray.write

    def recording(self, index, value, aux, keep=None, in_place=False):
        new = write(self, index, value, aux, keep=keep, in_place=in_place)
        writes.append((in_place, None if self.data is None
                       else self.data.data_ptr(), new.data.data_ptr()))
        return new

    monkeypatch.setattr(TensorArray, "write", recording)
    data = np.arange(18, dtype="float32").reshape(9, 2)
    (last,) = pt.Executor(CPU).run(
        main, feed={"sent": (data, [[0, 3, 5, 9]])}, fetch_list=[out],
        scope=pt.Scope())
    np.testing.assert_allclose(last, [data[0:3].sum(0), data[3:5].sum(0),
                                      data[5:9].sum(0)], rtol=1e-6)
    in_loop = [w for w in writes if w[0]]
    outside = [w for w in writes if not w[0]]
    # 4 trips (the longest sentence) x 2 arrays
    assert len(in_loop) == 8
    assert all(old == new for _, old, new in in_loop if old is not None)
    assert len({new for _, _, new in in_loop}) == 2
    # the memory's first write before the loop allocates its buffer
    assert len(outside) == 1 and outside[0][1] is None


# ---------------------------------------------------------------------------
# conditional_block
# ---------------------------------------------------------------------------

def _branch_write(pkg):
    layers = pkg.layers
    x = layers.data(name="x", shape=[2, 3], append_batch_size=False)
    flag = layers.data(name="flag", shape=[1], append_batch_size=False)
    i0 = layers.zeros(shape=[1], dtype="int64")
    i1 = layers.fill_constant(shape=[1], dtype="int64", value=1)
    arr = layers.array_write(x, i0)
    kept = layers.scale(x, scale=1.0)
    cb = layers.ConditionalBlock(
        [layers.greater_than(flag, layers.fill_constant(
            shape=[1], dtype="float32", value=0.0))],
        is_scalar_condition=True)
    with cb.block():
        layers.array_write(layers.scale(x, scale=2.0), i1, array=arr)
        layers.assign(layers.scale(x, scale=3.0), output=kept)
    return [layers.array_read(arr, i1), layers.array_length(arr), kept]


@pytest.mark.parametrize("flag", [1.0, -1.0])
def test_conditional_block_gates_an_array_write(flag):
    """The branch always runs on the port; with a false predicate its
    array write leaves the row and the length as they were and its
    output keeps the old value, as the reference's ``lax.cond``."""
    xv = _f(2, 2, 3)
    (row, length, kept), exe = _run_both(
        _branch_write, [{"x": xv, "flag": np.float32([flag])}])
    taken = flag > 0
    np.testing.assert_allclose(row, 2.0 * xv if taken else 0.0 * xv,
                               rtol=1e-6)
    assert int(length[0]) == (2 if taken else 1)
    np.testing.assert_allclose(kept, (3.0 if taken else 1.0) * xv,
                               rtol=1e-6)
    assert exe.last_run["host_reads"] == 0


def _branch_print(pkg):
    layers = pkg.layers
    x = layers.data(name="x", shape=[2, 3], append_batch_size=False)
    flag = layers.data(name="flag", shape=[1], append_batch_size=False)
    kept = layers.scale(x, scale=1.0)
    cb = layers.ConditionalBlock(
        [layers.greater_than(flag, layers.fill_constant(
            shape=[1], dtype="float32", value=0.0))],
        is_scalar_condition=True)
    with cb.block():
        shown = layers.Print(layers.scale(x, scale=3.0),
                             message="BRANCH-TAKEN")
        layers.assign(shown, output=kept)
    return [kept]


@pytest.mark.parametrize("flag", [1.0, -1.0])
def test_print_in_a_branch_prints_only_when_taken(flag, capfd):
    """A branch holding ``Print`` must not run untaken: its op is
    ``eager_only`` and reads its predicate on the host; the port prints
    only when it is taken, and untaken neither package prints (the
    reference's ``lax.cond`` runs one branch).  The output equals the
    reference's either way."""
    import jax
    xv = _f(3, 2, 3)
    feed = {"x": xv, "flag": np.float32([flag])}
    (jm, js, jf), (tm, ts, tf) = _programs(_branch_print)
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    jexe.run(js, scope=jscope)
    (want,) = jexe.run(jm, feed=feed, fetch_list=[jf[0].name], scope=jscope)
    jax.effects_barrier()
    jax_printed = "BRANCH-TAKEN" in capfd.readouterr().out
    (cb,) = [op for op in tm.global_block().ops
             if op.type == "conditional_block"]
    assert registry.eager_only(cb)
    texe = pt.Executor(CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        (got,) = texe.run(tm, feed=feed, fetch_list=[tf[0].name],
                          scope=pt.Scope())
    port_printed = "BRANCH-TAKEN" in capfd.readouterr().out
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)
    assert port_printed == (flag > 0)
    if flag < 0:
        assert not jax_printed
    assert texe.last_run["host_reads"] == 1


def _cond_in_loop(pkg):
    """Four trips; a branch taken on all but the second writes
    ``(i + 1) x`` at row ``i`` of an array the body also reads back."""
    layers = pkg.layers
    x = layers.data(name="x", shape=[3], append_batch_size=False)
    i = layers.zeros(shape=[1], dtype="int64")
    n = layers.fill_constant(shape=[1], dtype="int64", value=4)
    two = layers.fill_constant(shape=[1], dtype="int64", value=2)
    zero = layers.zeros(shape=[1], dtype="int64")
    for v in (i, n, two, zero):
        v.stop_gradient = True
    arr = layers.array_write(layers.scale(x, scale=0.0), zero)
    total = layers.scale(x, scale=0.0)
    cond = layers.less_than(x=i, y=n)
    w = layers.While(cond=cond)
    with w.block():
        one = layers.fill_constant(shape=[1], dtype="int64", value=1)
        cb = layers.ConditionalBlock([layers.not_equal(i, one)],
                                     is_scalar_condition=True)
        with cb.block():
            scaled = layers.elementwise_mul(
                x, layers.cast(i + 1, "float32"), axis=0)
            layers.array_write(scaled, i, array=arr)
        layers.assign(layers.sums(
            input=[total, layers.array_read(arr, i)]), output=total)
        layers.increment(x=i, in_place=True)
        layers.less_than(x=i, y=n, cond=cond)
    first = layers.fill_constant(shape=[1], dtype="int64", value=1)
    return [total, layers.array_length(arr), layers.array_read(arr, two),
            layers.array_read(arr, first)]


def test_branch_in_a_loop_writes_the_loops_buffer(monkeypatch):
    """A ``conditional_block`` in a bounded loop writes its array row in
    place into the buffer the loop copied once at its entry: no copy a
    trip (one ``owned`` copy for the whole loop, not one a trip), and the
    rows, the length and the running sum equal the reference's."""
    copies = []
    owned = TensorArray.owned

    def counting(self):
        copies.append(self.capacity)
        return owned(self)

    monkeypatch.setattr(TensorArray, "owned", counting)
    xv = _f(4, 3)
    (total, length, row2, row1), exe = _run_both(_cond_in_loop,
                                                 [{"x": xv}])
    np.testing.assert_allclose(total, 8.0 * xv, rtol=1e-6)
    np.testing.assert_allclose(row2, 3.0 * xv, rtol=1e-6)
    assert int(length[0]) == 4 and not row1.any()
    assert copies == [TensorArray().capacity]
    assert exe.last_run == {"while_trips": 128, "host_reads": 0}


# ---------------------------------------------------------------------------
# the beam decode under the buckets
# ---------------------------------------------------------------------------

def test_beam_decode_bucketed_graphs_and_decodes_as_static():
    """The decode of ``build_decode`` keeps nothing eager under the
    buckets (its GRU encoder reads a static LoD's host tables otherwise)
    and decodes the same sentences and scores bucketed as static from
    one scope; ``beam_search_decode`` without ``max_len`` reads the
    arrays' length on the host and stays eager."""
    main, startup = pt.Program(), pt.Program()
    with torch_names("bs_"), pt.program_guard(main, startup):
        sent, scores = build_decode(pt)
    block = main.global_block()
    assert texecutor._host_ops(block, dyn=True) == []
    assert set(texecutor._host_ops(block)) == {"gru", "sequence_pool"}
    scope = pt.Scope()
    pt.Executor(CPU).run(startup, scope=scope)
    state = {n: np.asarray(scope.find_var(n)) for n in
             persistable_names(main)}
    state["dec_out_w"] = state["dec_out_w"] * np.float32(8.0)
    rng = np.random.RandomState(7)
    src = rng.randint(2, 64, size=(4 * 6, 1)).astype("int64")
    feed = {"src": (src, [list(range(0, 4 * 6 + 1, 6))])}
    bucketed = clone_program(main)
    bucketed.lod_buckets = True
    got = {}
    for name, program in (("static", main), ("bucketed", bucketed)):
        exe = pt.Executor(CPU)
        got[name] = exe.run(program, feed=feed, fetch_list=[sent, scores],
                            scope=scope_from_numpy(state, CPU, main))
        assert exe.last_run["host_reads"] == 0
    np.testing.assert_array_equal(got["bucketed"][0], got["static"][0])
    np.testing.assert_array_equal(got["bucketed"][1], got["static"][1])
    (dec,) = [op for op in block.ops if op.type == "beam_search_decode"]
    del dec.attrs["max_len"]
    assert registry.eager_only(dec)
    exe = pt.Executor(CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        again = exe.run(main, feed=feed, fetch_list=[sent, scores],
                        scope=scope_from_numpy(state, CPU, main))
    np.testing.assert_array_equal(again[0], got["static"][0])
    assert exe.last_run["host_reads"] == 1


# ---------------------------------------------------------------------------
# SelectedRows dead slots against the reference's drop semantics
# ---------------------------------------------------------------------------

DEAD_CASES = {
    # unmerged: the merge leaves rows 3 and 7 live and three dead slots,
    # redirected to row 3, which is live
    "redirect_target_live": Rows(np.array([10, 3, 10, 3, 7], np.int64),
                                 _f(3, 5, 3), 10),
    # every slot dead: the update changes no row
    "no_live_slot": Rows(np.full(4, 10, np.int64), _f(4, 4, 3), 10),
}


@pytest.mark.parametrize("case", sorted(DEAD_CASES))
@pytest.mark.parametrize("op_type", ["sgd", "adam", "adagrad"])
def test_sparse_update_with_dead_slots_matches_reference(op_type, case):
    """Dead slots (row = height) take no part in the update, as XLA drops
    their out-of-range scatter indices: every output equals the
    reference's, and the rows no live slot names keep their values."""
    g = DEAD_CASES[case]
    ins, outs, attrs = _update_inputs(op_type, g)
    before = {n: v.copy() for d in ins.values() for n, v in d.items()
              if not isinstance(v, Rows)}
    want, got, _ = _run_op_both(op_type, ins, outs, attrs)
    _assert_outputs(want, got)
    live = g.rows[g.rows < g.height]
    untouched = np.setdiff1d(np.arange(g.height), live)
    for slot, names in outs.items():
        if slot.startswith(("Param", "Moment")):
            np.testing.assert_array_equal(got[names[0]][untouched],
                                          before[names[0]][untouched])


@pytest.mark.parametrize("case", sorted(DEAD_CASES))
def test_merge_and_densify_with_dead_slots_match_reference(case):
    for op_type in ("merge_selected_rows", "get_tensor_from_selected_rows"):
        want, got, _ = _run_op_both(op_type, {"X": {"x": DEAD_CASES[case]}},
                                    {"Out": ["out"]})
        _assert_outputs(want, got)


# ---------------------------------------------------------------------------
# the capture rule: the three paths of this slice
# ---------------------------------------------------------------------------

def _s2s_bucketed():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        cost, _ = TS.seq_to_seq_net(20, 20, 8, 8, 8)
        pt.optimizer.Adam(1e-2).minimize(cost)
    main.lod_buckets = True
    return main, startup, cost


def _wide_deep():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        cost, _, _ = TW.wide_and_deep_train_program(8, vocab_size=64)
        pt.optimizer.Adam(1e-2).minimize(cost)
    return main, startup, cost


def test_capture_rule_lets_the_three_blocks_through():
    s2s, _, _ = _s2s_bucketed()
    assert texecutor._host_ops(s2s.global_block(), dyn=True) == []
    wd, _, _ = _wide_deep()
    assert texecutor._host_ops(wd.global_block()) == []


def _feeds(name, seed):
    if name == "seq2seq":
        return TS.fake_batch(3, 6, 6, 20, 20, seed=seed)
    return TW.fake_batch(8, seed=seed, vocab_size=64, num_slots=4,
                         dense_dim=8)


@pytest.mark.parametrize("name", ["seq2seq", "wide_and_deep"])
def test_second_step_does_no_host_work(name, recorded):  # noqa: F811
    """Under the ``TorchDispatchMode`` audit of the capture rule: the
    second step of the bucketed seq2seq and of W&D (what a capture sees)
    reads nothing on the host and copies nothing to the device, and its
    entry is not kept eager."""
    main, startup, cost = (_s2s_bucketed if name == "seq2seq"
                           else _wide_deep)()
    exe, scope = pt.Executor(CPU), pt.Scope()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        exe.run(startup, scope=scope)
    exe.run(main, feed=_feeds(name, 0), fetch_list=[cost], scope=scope)
    del recorded[:]
    with _Audit(recorded):
        (loss,) = exe.run(main, feed=_feeds(name, 1), fetch_list=[cost],
                          scope=scope)
    assert np.isfinite(loss).all()
    assert not exe._last_compiled.interpret
    assert not recorded, sorted(set(recorded))
    assert exe.last_run["host_reads"] == 0


@pytest.mark.parametrize("taken", [True, False])
def test_branch_with_an_in_place_update_reads_its_predicate(taken):
    """A ``conditional_block`` whose branch holds a sparse update (it
    changes the table in place, so it must not run untaken) reads its
    predicate on the host and is ``eager_only``; the table moves only
    when the predicate holds."""
    from paddle_tpu_torch.executor import lower_block
    from paddle_tpu_torch.selected_rows import SelectedRows
    main = pt.Program()
    block = main.global_block()
    for name, dtype in (("p", "float32"), ("g", "float32"),
                        ("lr", "float32"), ("c", "bool")):
        block.create_var(name=name, dtype=dtype)
    sub = main.create_block()
    sub.append_op(type="sgd", inputs={"Param": ["p"], "Grad": ["g"],
                                      "LearningRate": ["lr"]},
                  outputs={"ParamOut": ["p"]})
    main.rollback()
    op = block.append_op(type="conditional_block", inputs={"Cond": ["c"]},
                         outputs={"Out": ["p"], "Scope": []},
                         attrs={"sub_block": sub,
                                "is_scalar_condition": True})
    assert registry.eager_only(op)
    p = torch.ones(4, 2)
    env = {"p": p, "lr": torch.tensor([0.5]), "c": torch.tensor([taken]),
           "g": SelectedRows(torch.tensor([1, 4, 1]), torch.ones(3, 2), 4)}
    aux = {"device": torch.device("cpu"), "lower_block": lower_block}
    lower_block(block, env, aux)
    want = np.ones((4, 2), "float32")
    if taken:
        want[1] -= 1.0          # row 1 twice at lr 0.5; row 4 is dead
    np.testing.assert_array_equal(env["p"].numpy(), want)
    assert aux["host_reads"] == 1
