"""The port's 17 sequence (LoD) ops against the JAX package's lowerings,
on the CPU: each op's outputs and output LoD through both packages'
``lower_block`` on the same seeded inputs and LoD, and its input grads
through both packages' ``append_backward`` and ``Executor.run`` with the
ragged input fed as ``(value, lod)``.

Cases hold the reference's values where torch's defaults differ: a
zero-length sequence (MAX pooling -inf, MIN +inf, MaxIndex
``iinfo(int32).max``, FIRST and LAST reading a neighbour's row as a
clamped gather does), ties in MAX pooling (the grad split evenly, not
all to the first row) and an input without LoD (one row per sequence).

Tolerance: float32 ``atol = rtol = 1e-5`` (torch and XLA sum in
different orders); integer outputs and LoDs exact (values, not dtypes:
the port's integers are int64, the reference's int32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import executor as jax_executor
from paddle_tpu_torch import executor as torch_executor
from paddle_tpu_torch.convert import to_numpy
from test_torch_ops import _grad_program_dict, _op_dict

TOL = 1e-5

LOD = [[0, 3, 5, 9]]
LOD_EMPTY_MID = [[0, 3, 3, 7]]
LOD_EMPTY_FIRST = [[0, 0, 2, 5]]
LOD_EMPTY_LAST = [[0, 2, 5, 5]]


@pytest.fixture(autouse=True)
def _plain_reference(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_OPT", raising=False)


def _f(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _rows(lod):
    return lod[-1][-1]


def run_forward(op_type, inputs, out_slots, attrs):
    """Both packages' ``lower_block`` on the one-op program: ``inputs``
    is ``{slot: (array, lod or None)}`` (or a list of such pairs for a
    multi-input slot).  Returns ``(jax, torch)`` pairs of ``({output:
    numpy}, {output: its LoD})``."""
    arrays, lods = {}, {}
    for slot, v in inputs.items():
        for i, (a, lod) in enumerate(v if isinstance(v, list) else [v]):
            name = f"in_{slot}" if not isinstance(v, list) else \
                f"in_{slot}_{i}"
            arrays[name] = a
            if lod is not None:
                lods[name] = [list(level) for level in lod]
    d = _op_dict(op_type, {s: (v[0][0] if isinstance(v, list) else v[0])
                           for s, v in inputs.items()}, out_slots, attrs)
    block = d["blocks"][0]
    for slot, v in inputs.items():
        if isinstance(v, list):
            names = [f"in_{slot}_{i}" for i in range(len(v))]
            block["ops"][0]["inputs"][slot] = names
            block["vars"] = [x for x in block["vars"]
                             if x["name"] != f"in_{slot}"] + [
                {"name": n, "shape": list(arrays[n].shape),
                 "dtype": str(arrays[n].dtype), "persistable": False}
                for n in names]
    results = []
    for pkg in (fluid, pt):
        prog = pkg.Program.from_dict(d)
        blk = prog.global_block()
        if pkg is fluid:
            env = {n: jnp.asarray(a) for n, a in arrays.items()}
            aux = {"lod": {n: [list(l) for l in v] for n, v in lods.items()},
                   "rng_counter": 0}
            jax_executor.lower_block(blk, env, None, False, aux)
        else:
            env = {n: torch.from_numpy(a.copy()) for n, a in arrays.items()}
            aux = {"device": torch.device("cpu"),
                   "lod": {n: [list(l) for l in v] for n, v in lods.items()}}
            torch_executor.lower_block(blk, env, aux)
        op = blk.ops[0]
        outs = {n: np.asarray(env[n]) if pkg is fluid else to_numpy(env[n])
                for n in op.output_arg_names if n in env}
        out_lods = {n: _as_lists(aux["lod"].get(n)) for n in outs}
        results.append((outs, out_lods))
    return results


def _as_lists(lod):
    return None if lod is None else [[int(s) for s in level]
                                      for level in lod]


def assert_forward_matches(op_type, inputs, out_slots, attrs):
    (want, want_lod), (got, got_lod) = run_forward(op_type, inputs,
                                                   out_slots, attrs)
    assert set(got) == set(want) and want
    for n in want:
        w, g = want[n], got[n]
        assert g.shape == w.shape, n
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=n)
        else:
            np.testing.assert_array_equal(g, w, err_msg=n)
    assert got_lod == want_lod
    return got, got_lod


def run_grads(op_type, inputs, out_slots, attrs, cot_seed=5):
    """The grads of every float input through both packages'
    ``append_backward`` and ``Executor.run`` (ragged inputs fed as
    ``(value, lod)``), at a seeded cotangent of the first output."""
    flat = {s: v[0] for s, v in inputs.items()}
    d = _grad_program_dict(op_type, flat, out_slots, attrs)
    (want, _), _ = run_forward(op_type, inputs, out_slots, attrs)
    out_shape = want[f"out_{out_slots[0]}"].shape
    feed = {f"in_{s}": (a, lod) if lod is not None else a
            for s, (a, lod) in inputs.items()}
    feed["cot"] = _f(np.random.RandomState(cot_seed), *out_shape)
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
    return results


def assert_grads_match(op_type, inputs, out_slots, attrs):
    want, got = run_grads(op_type, inputs, out_slots, attrs)
    assert set(got) == set(want) and want, sorted(want)
    for n in want:
        assert got[n].shape == want[n].shape, n
        np.testing.assert_allclose(got[n], want[n], atol=TOL, rtol=TOL,
                                   err_msg=n)
    return got


# ---------------------------------------------------------------------------
# the cases: (id, op type, inputs, output slots, attrs)
# ---------------------------------------------------------------------------

_POOLS = ("SUM", "AVERAGE", "SQRT", "MAX", "MIN", "FIRST", "LAST")


def _pool_cases():
    r = np.random.RandomState(3)
    cases = []
    for lod, tag in ((LOD, ""), (LOD_EMPTY_MID, "_empty_mid"),
                     (LOD_EMPTY_FIRST, "_empty_first"),
                     (LOD_EMPTY_LAST, "_empty_last")):
        for pool in _POOLS:
            outs = ["Out", "MaxIndex"] if pool == "MAX" else ["Out"]
            cases.append((f"sequence_pool_{pool.lower()}{tag}",
                          "sequence_pool",
                          {"X": (_f(r, _rows(lod), 4), lod)}, outs,
                          {"pooltype": pool}))
    cases += [
        ("sequence_pool_max_ties", "sequence_pool",
         {"X": (np.array([[1, 5], [3, 5], [3, 5], [2, 4]], np.float32),
                [[0, 4]])}, ["Out", "MaxIndex"], {"pooltype": "MAX"}),
        ("sequence_pool_dense_fallback", "sequence_pool",
         {"X": (_f(r, 5, 3), None)}, ["Out"], {"pooltype": "SUM"}),
        ("sequence_pool_two_level", "sequence_pool",
         {"X": (_f(r, 9, 3), [[0, 2, 3], LOD[0]])}, ["Out", "MaxIndex"],
         {"pooltype": "MAX"}),
    ]
    return cases


def _cases():
    r = np.random.RandomState(11)
    ids = r.randint(0, 6, (9, 1)).astype(np.int64)
    return [
        *_pool_cases(),
        ("sequence_softmax", "sequence_softmax",
         {"X": (_f(r, 9, 1), LOD)}, ["Out"], {}),
        ("sequence_softmax_empty", "sequence_softmax",
         {"X": (_f(r, 7, 1), LOD_EMPTY_MID)}, ["Out"], {}),
        ("sequence_expand_dense_x", "sequence_expand",
         {"X": (_f(r, 3, 4), None), "Y": (_f(r, 9, 1), LOD)}, ["Out"], {}),
        ("sequence_expand_dense_x_zero_repeat", "sequence_expand",
         {"X": (_f(r, 3, 4), None), "Y": (_f(r, 7, 1), LOD_EMPTY_MID)},
         ["Out"], {}),
        ("sequence_expand_ragged_x", "sequence_expand",
         {"X": (_f(r, 4, 2), [[0, 1, 3, 4]]),
          "Y": (_f(r, 5, 1), [[0, 2, 2, 5]])}, ["Out"], {}),
        ("sequence_expand_ref_level0", "sequence_expand",
         {"X": (_f(r, 2, 3), None), "Y": (_f(r, 9, 1), [[0, 1, 3], LOD[0]])},
         ["Out"], {"ref_level": 0}),
        ("sequence_concat", "sequence_concat",
         {"X": [(_f(r, 5, 3), [[0, 2, 5]]), (_f(r, 4, 3), [[0, 1, 4]]),
                (_f(r, 3, 3), [[0, 3, 3]])]}, ["Out"], {}),
        ("sequence_concat_no_lod", "sequence_concat",
         {"X": [(_f(r, 5, 3), None), (_f(r, 4, 3), None)]}, ["Out"], {}),
        ("sequence_reverse", "sequence_reverse",
         {"X": (_f(r, 9, 3), LOD)}, ["Out"], {}),
        ("sequence_reverse_empty", "sequence_reverse",
         {"X": (_f(r, 7, 3), LOD_EMPTY_MID)}, ["Out"], {}),
        ("sequence_reverse_no_lod", "sequence_reverse",
         {"X": (_f(r, 4, 3), None)}, ["Out"], {}),
        ("sequence_reshape", "sequence_reshape",
         {"X": (_f(r, 6, 4), [[0, 2, 6]])}, ["Out"], {"new_dim": 8}),
        ("lod_reset_target", "lod_reset",
         {"X": (_f(r, 9, 2), LOD)}, ["Out"], {"target_lod": [0, 4, 9]}),
        ("lod_reset_y_lod", "lod_reset",
         {"X": (_f(r, 9, 2), LOD), "Y": (_f(r, 9, 1), [[0, 1, 9]])},
         ["Out"], {}),
        ("lod_reset_y_values", "lod_reset",
         {"X": (_f(r, 9, 2), LOD),
          "Y": (np.array([0, 6, 9], np.int64), None)}, ["Out"], {}),
        ("sequence_conv", "sequence_conv",
         {"X": (_f(r, 9, 4), LOD), "Filter": (_f(r, 12, 5), None)}, ["Out"],
         {"contextLength": 3, "contextStart": -1, "contextStride": 1}),
        ("sequence_conv_len4_empty", "sequence_conv",
         {"X": (_f(r, 7, 4), LOD_EMPTY_MID), "Filter": (_f(r, 16, 3), None)},
         ["Out"], {"contextLength": 4, "contextStart": -2,
                   "contextStride": 1}),
        ("sequence_context", "sequence_context",
         {"X": (_f(r, 9, 2), LOD)}, ["Out"],
         {"contextLength": 3, "contextStart": 0}),
        ("sequence_first_step", "sequence_first_step",
         {"X": (_f(r, 9, 3), LOD)}, ["Out"], {}),
        ("sequence_first_step_empty_last", "sequence_first_step",
         {"X": (_f(r, 5, 3), LOD_EMPTY_LAST)}, ["Out"], {}),
        ("sequence_last_step", "sequence_last_step",
         {"X": (_f(r, 9, 3), LOD)}, ["Out"], {}),
        ("sequence_last_step_empty_first", "sequence_last_step",
         {"X": (_f(r, 5, 3), LOD_EMPTY_FIRST)}, ["Out"], {}),
        ("im2sequence", "im2sequence",
         {"X": (_f(r, 2, 3, 5, 6), None)}, ["Out"],
         {"kernels": [2, 3], "strides": [1, 2], "paddings": [1, 0, 0, 1]}),
        ("row_conv", "row_conv",
         {"X": (_f(r, 9, 4), LOD), "Filter": (_f(r, 3, 4), None)}, ["Out"],
         {}),
        ("row_conv_empty", "row_conv",
         {"X": (_f(r, 7, 4), LOD_EMPTY_MID), "Filter": (_f(r, 2, 4), None)},
         ["Out"], {}),
        ("sub_nested_seq", "sub_nested_seq",
         {"X": (_f(r, 9, 2), [[0, 2, 3], LOD[0]]),
          "SelectedIndices": (np.array([[1, 0], [0, -1]], np.int64), None)},
         ["Out"], {}),
        # integer outputs or no grad: forward only (see _FORWARD_ONLY)
        ("sequence_slice", "sequence_slice",
         {"X": (_f(r, 9, 2), LOD),
          "Offset": (np.array([[1], [0], [2]], np.int64), None),
          "Length": (np.array([[2], [1], [1]], np.int64), None)},
         ["Out"], {}),
        ("sequence_erase", "sequence_erase",
         {"X": (ids, LOD)}, ["Out"], {"tokens": [2, 5]}),
        ("kmax_seq_score", "kmax_seq_score",
         {"X": (np.array([[1], [3], [3], [0], [2], [5], [5], [5], [4]],
                         np.float32), LOD)}, ["Out"], {"beam_size": 2}),
        ("kmax_seq_score_short", "kmax_seq_score",
         {"X": (_f(r, 7, 1), LOD_EMPTY_MID)}, ["Out"], {"beam_size": 4}),
    ]


#: no grad (``no_gradient`` ops, an integer output), and ``lod_reset``
#: with Y a tensor of splits, which the reference reads on the host and so
#: cannot run under its executor's jit (forward through ``lower_block``)
_FORWARD_ONLY = ("sequence_slice", "sequence_erase", "kmax_seq_score",
                 "lod_reset_y_values")


@pytest.mark.parametrize("case", _cases(), ids=lambda c: c[0])
def test_sequence_op_matches_reference(case):
    _, op_type, inputs, out_slots, attrs = case
    assert_forward_matches(op_type, inputs, out_slots, attrs)


@pytest.mark.parametrize(
    "case", [c for c in _cases() if not {c[0], c[1]} & set(_FORWARD_ONLY)
             and not isinstance(c[2].get("X"), list)], ids=lambda c: c[0])
def test_sequence_op_grad_matches_reference(case):
    _, op_type, inputs, out_slots, attrs = case
    assert_grads_match(op_type, inputs, out_slots, attrs)


def test_sequence_concat_grad_matches_reference():
    """The multi-input slot: each input's grad rows back in place."""
    r = np.random.RandomState(4)
    xs = [(_f(r, 5, 3), [[0, 2, 5]]), (_f(r, 4, 3), [[0, 1, 4]])]
    loss = []
    for pkg in (fluid, pt):
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            vs = []
            for i, (a, _) in enumerate(xs):
                v = pkg.layers.data(f"x{i}", shape=list(a.shape),
                                    append_batch_size=False, lod_level=1,
                                    stop_gradient=False)
                vs.append(v)
            out = pkg.layers.sequence_concat(vs)
            w = pkg.layers.data("w", shape=[9, 3], append_batch_size=False)
            s = pkg.layers.reduce_sum(pkg.layers.elementwise_mul(out, w))
            pkg.append_backward(s)
        feed = {f"x{i}": x for i, x in enumerate(xs)}
        feed["w"] = _f(np.random.RandomState(1), 9, 3)
        loss.append([np.asarray(v) for v in pkg.Executor(pkg.CPUPlace()).run(
            main, feed=feed, fetch_list=["x0@GRAD", "x1@GRAD"],
            scope=pkg.Scope())])
    for w, g in zip(*loss):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL)


def test_empty_sequences_take_the_reference_values():
    """A zero-length sequence: MAX pools to -inf and MIN to +inf (torch's
    ``scatter_reduce`` into zeros would leave 0), MaxIndex is
    ``iinfo(int32).max``, SUM and AVERAGE are 0; FIRST of a trailing empty
    sequence and LAST of a leading one read the clamped / wrapped row."""
    x = _f(np.random.RandomState(8), 7, 2)
    got = {}
    for pool in ("MAX", "MIN", "SUM", "AVERAGE"):
        outs = ["Out", "MaxIndex"] if pool == "MAX" else ["Out"]
        got[pool], _ = assert_forward_matches(
            "sequence_pool", {"X": (x, LOD_EMPTY_MID)}, outs,
            {"pooltype": pool})
    assert np.all(got["MAX"]["out_Out"][1] == -np.inf)
    assert np.all(got["MAX"]["out_MaxIndex"][1] == 2 ** 31 - 1)
    assert np.all(got["MIN"]["out_Out"][1] == np.inf)
    assert np.all(got["SUM"]["out_Out"][1] == 0)
    assert np.all(got["AVERAGE"]["out_Out"][1] == 0)
    np.testing.assert_array_equal(got["MAX"]["out_Out"][[0, 2]],
                                  np.stack([x[:3].max(0), x[3:].max(0)]))
    last, _ = assert_forward_matches(
        "sequence_last_step", {"X": (x[:5], LOD_EMPTY_FIRST)}, ["Out"], {})
    np.testing.assert_array_equal(last["out_Out"], x[[4, 1, 4]])
    first, _ = assert_forward_matches(
        "sequence_first_step", {"X": (x[:5], LOD_EMPTY_LAST)}, ["Out"], {})
    np.testing.assert_array_equal(first["out_Out"], x[[0, 2, 4]])


def test_max_pool_grad_splits_ties():
    """``[1, 3, 3, 2]`` pooled by MAX: the grad of the max is split
    evenly between the tied rows in both packages (``[0, .5, .5, 0]``), as
    ``jax.ops.segment_max``'s vjp does; a gather by MaxIndex would give
    all of it to the first."""
    x = np.array([[1.0], [3.0], [3.0], [2.0]], np.float32)
    want, got = run_grads("sequence_pool", {"X": (x, [[0, 4]])},
                          ["Out", "MaxIndex"], {"pooltype": "MAX"},
                          cot_seed=0)
    cot = _f(np.random.RandomState(0), 1, 1)[0, 0]
    np.testing.assert_allclose(got["in_X@GRAD"], want["in_X@GRAD"],
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got["in_X@GRAD"][:, 0],
                               [0.0, 0.5 * cot, 0.5 * cot, 0.0], rtol=TOL)


def test_sequence_tables_are_built_once_a_run(monkeypatch):
    """The segment table of one LoD is built once in a training step, for
    the forward op, its grad's recompute and the next op alike; a run
    with another LoD builds its own."""
    from paddle_tpu_torch import lod as torch_lod
    built = []
    real = torch_lod.SegmentTables.__init__

    def counting(self, lod, level, device):
        built.append(torch_lod.freeze(lod))
        real(self, lod, level, device)

    monkeypatch.setattr(torch_lod.SegmentTables, "__init__", counting)
    main = pt.Program()
    with pt.program_guard(main, pt.Program()):
        x = pt.layers.data("x", shape=[-1, 3], append_batch_size=False,
                           lod_level=1, stop_gradient=False)
        a = pt.layers.sequence_pool(x, "sum")
        b = pt.layers.sequence_pool(x, "max")
        loss = pt.layers.reduce_sum(pt.layers.elementwise_add(a, b))
        pt.append_backward(loss)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    x = _f(np.random.RandomState(2), 9, 3)
    exe.run(main, feed={"x": (x, LOD)}, fetch_list=["x@GRAD"], scope=scope)
    assert built == [torch_lod.freeze(LOD)]
    exe.run(main, feed={"x": (x[:7], LOD_EMPTY_MID)}, fetch_list=["x@GRAD"],
            scope=scope)
    assert built == [torch_lod.freeze(LOD), torch_lod.freeze(LOD_EMPTY_MID)]


def test_layers_sequence_matches_the_reference():
    """``layers.sequence`` has the reference's 16 functions with the same
    signatures."""
    import inspect
    from paddle_tpu.layers import sequence as jax_seq
    from paddle_tpu_torch.layers import sequence as torch_seq
    assert torch_seq.__all__ == jax_seq.__all__
    assert len(torch_seq.__all__) == 16
    for name in jax_seq.__all__:
        assert inspect.signature(getattr(torch_seq, name)) == \
            inspect.signature(getattr(jax_seq, name)), name
        assert getattr(pt.layers, name) is getattr(torch_seq, name)
