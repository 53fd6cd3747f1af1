"""The port's CRF and CTC ops and evaluators against the JAX package,
mirroring ``tests/test_crf_ctc.py``: ``linear_chain_crf`` against brute
force and the JAX package over a LoD (with sequences of length 1 and an
empty one), its grads, Viterbi decoding (with a tie), ``warpctc``
against brute force and the JAX package with its grads, ``ctc_align``
and ``edit_distance`` over LoDs, and the evaluators' accumulation over
two batches, on the CPU.

Tolerance: float32 ``atol = rtol = 1e-5`` (torch and XLA sum in
different orders), ``rtol = 1e-4`` against a float64 brute force;
integer outputs and LoDs exact (values, not dtypes: the port's integers
are int64)."""

import itertools

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from test_torch_sequence import (assert_forward_matches,
                                 assert_grads_match, run_forward)

TOL = 1e-5
K = 4
LOD = [[0, 3, 5, 9]]
#: a sequence of length 1 and an empty one
LOD_SHORT = [[0, 1, 1, 4]]


def _f(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _crf_inputs(seed, lod):
    r = np.random.RandomState(seed)
    n = lod[0][-1]
    return {"Emission": (_f(r, n, K), lod),
            "Transition": (_f(r, K + 2, K) * 0.5, None),
            "Label": (r.randint(0, K, (n, 1)).astype(np.int64), lod)}


def _paths(T):
    return itertools.product(range(K), repeat=T)


def _path_score(em, trans, path):
    start, stop, tr = trans[0], trans[1], trans[2:]
    sc = start[path[0]] + em[0, path[0]]
    for t in range(1, len(path)):
        sc += tr[path[t - 1], path[t]] + em[t, path[t]]
    return sc + stop[path[-1]]


def _crf_brute_force(em, trans, labels, lod):
    em, trans = em.astype(np.float64), trans.astype(np.float64)
    nlls = []
    for s, e in zip(lod[0][:-1], lod[0][1:]):
        if e == s:
            nlls.append(None)
            continue
        z = np.logaddexp.reduce([_path_score(em[s:e], trans, p)
                                 for p in _paths(e - s)])
        nlls.append(z - _path_score(em[s:e], trans, list(labels[s:e])))
    return nlls


CRF_OUTS = ["LogLikelihood", "Alpha", "EmissionExps", "TransitionExps"]


@pytest.mark.parametrize("lod", [LOD, LOD_SHORT], ids=["lod", "short"])
def test_linear_chain_crf_matches_reference_and_brute_force(lod):
    inputs = _crf_inputs(0, lod)
    got, _ = assert_forward_matches("linear_chain_crf", inputs, CRF_OUTS,
                                    {})
    want = _crf_brute_force(inputs["Emission"][0],
                            inputs["Transition"][0],
                            inputs["Label"][0].reshape(-1), lod)
    nll = got["out_LogLikelihood"].reshape(-1)
    for b, w in enumerate(want):
        if w is not None:
            np.testing.assert_allclose(nll[b], w, rtol=1e-4)


@pytest.mark.parametrize("lod", [LOD, LOD_SHORT], ids=["lod", "short"])
def test_linear_chain_crf_grads(lod):
    """Emission and Transition grads: autograd through the port's loop
    against ``jax.vjp`` of the reference's scan."""
    assert_grads_match("linear_chain_crf", _crf_inputs(1, lod), CRF_OUTS,
                       {})


def _viterbi_brute_force(em, trans, lod):
    best = []
    for s, e in zip(lod[0][:-1], lod[0][1:]):
        if e > s:
            scores = {p: _path_score(em[s:e], trans, p)
                      for p in _paths(e - s)}
            best.extend(max(scores, key=scores.get))
    return best


def test_crf_decoding_matches_reference_and_brute_force():
    inputs = _crf_inputs(2, LOD)
    del inputs["Label"]
    got, got_lod = assert_forward_matches("crf_decoding", inputs,
                                          ["ViterbiPath"], {})
    np.testing.assert_array_equal(
        got["out_ViterbiPath"].reshape(-1),
        _viterbi_brute_force(inputs["Emission"][0],
                             inputs["Transition"][0], LOD))
    assert got_lod["out_ViterbiPath"] == LOD


def test_crf_decoding_ties_take_the_first_tag():
    """Equal transition rows and equal emissions: every path ties, and
    both packages take tag 0 everywhere (the first of the maxima)."""
    em = np.ones((5, K), np.float32)
    trans = np.tile(np.arange(K, dtype=np.float32)[None] * 0.0, (K + 2, 1))
    inputs = {"Emission": (em, [[0, 2, 5]]), "Transition": (trans, None)}
    got, _ = assert_forward_matches("crf_decoding", inputs,
                                    ["ViterbiPath"], {})
    np.testing.assert_array_equal(got["out_ViterbiPath"].reshape(-1),
                                  [0] * 5)


@pytest.mark.parametrize("lod", [LOD, LOD_SHORT], ids=["lod", "short"])
def test_crf_decoding_with_label_is_an_indicator(lod):
    inputs = _crf_inputs(3, lod)
    got, _ = assert_forward_matches("crf_decoding", inputs,
                                    ["ViterbiPath"], {})
    assert set(np.unique(got["out_ViterbiPath"])) <= {0, 1}


# ---------------------------------------------------------------------------
# CTC
# ---------------------------------------------------------------------------

def _ctc_brute_force(logits, labels, C):
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    total = -np.inf
    T = len(logits)
    for path in itertools.product(range(C), repeat=T):
        merged = [v for i, v in enumerate(path)
                  if (i == 0 or v != path[i - 1]) and v != 0]
        if merged == list(labels):
            total = np.logaddexp(total, sum(logp[t, path[t]]
                                            for t in range(T)))
    return -total


def _ctc_inputs(seed, logit_lod, label_lod, C=4):
    r = np.random.RandomState(seed)
    return {"Logits": (_f(r, logit_lod[0][-1], C), logit_lod),
            "Label": (r.randint(1, C, (label_lod[0][-1], 1))
                      .astype(np.int64), label_lod)}


#: (logit LoD, label LoD): repeated labels (a blank must separate them),
#: a label as long as its sequence allows, one sequence of one frame
CTC_LODS = [([[0, 4, 9, 10]], [[0, 2, 4, 5]]),
            ([[0, 5, 8]], [[0, 3, 4]])]


@pytest.mark.parametrize("lods", CTC_LODS, ids=["three", "two"])
@pytest.mark.parametrize("norm", [False, True], ids=["sum", "norm_by_times"])
def test_warpctc_matches_reference_and_brute_force(lods, norm):
    logit_lod, label_lod = lods
    inputs = _ctc_inputs(4, logit_lod, label_lod)
    inputs["Label"][0][1] = inputs["Label"][0][0]    # a repeated label
    attrs = {"blank": 0, "norm_by_times": norm}
    got, _ = assert_forward_matches("warpctc", inputs, ["Loss"], attrs)
    logits, labels = inputs["Logits"][0], inputs["Label"][0].reshape(-1)
    for b, (s, e) in enumerate(zip(logit_lod[0][:-1], logit_lod[0][1:])):
        ls, le = label_lod[0][b], label_lod[0][b + 1]
        want = _ctc_brute_force(logits[s:e].astype(np.float64),
                                labels[ls:le], 4)
        if norm:
            want /= e - s
        np.testing.assert_allclose(got["out_Loss"][b, 0], want, rtol=1e-4)


@pytest.mark.parametrize("lods", CTC_LODS, ids=["three", "two"])
@pytest.mark.parametrize("norm", [False, True], ids=["sum", "norm_by_times"])
def test_warpctc_grads(lods, norm):
    assert_grads_match("warpctc", _ctc_inputs(5, *lods), ["Loss"],
                       {"blank": 0, "norm_by_times": norm})


def test_ctc_align_over_a_lod():
    ids = np.array([0, 1, 1, 0, 2, 2, 3, 0, 0, 4, 4, 1], np.int64)
    inputs = {"Input": (ids.reshape(-1, 1), [[0, 5, 5, 12]])}
    got, got_lod = assert_forward_matches("ctc_align", inputs, ["Output"],
                                          {"blank": 0})
    np.testing.assert_array_equal(got["out_Output"].reshape(-1),
                                  [1, 2, 2, 3, 4, 1])
    assert got_lod["out_Output"] == [[0, 2, 2, 6]]


@pytest.mark.parametrize("normalized", [False, True])
def test_edit_distance_over_lods(normalized):
    hyp = np.array([[1], [2], [3], [4], [5]], np.int64)
    ref = np.array([[1], [3], [3], [9]], np.int64)
    inputs = {"Hyps": (hyp, [[0, 3, 5]]), "Refs": (ref, [[0, 2, 4]])}
    got, _ = assert_forward_matches("edit_distance", inputs,
                                    ["Out", "SequenceNum"],
                                    {"normalized": normalized})
    want = [1.0, 2.0] if not normalized else [0.5, 1.0]
    np.testing.assert_allclose(got["out_Out"].reshape(-1), want)


# ---------------------------------------------------------------------------
# evaluators over two batches
# ---------------------------------------------------------------------------

CHUNK_BATCHES = [
    ((np.array([0, 1, 4, 2, 3, 3, 4, 0], np.int64),
      np.array([0, 1, 4, 2, 3, 4, 4, 0], np.int64)), [[0, 4, 8]]),
    ((np.array([0, 1, 2, 3, 0, 0], np.int64),
      np.array([0, 1, 4, 4, 0, 1], np.int64)), [[0, 3, 6]]),
]


def _chunk_evaluator(pkg):
    results = []
    main, startup = pkg.Program(), pkg.Program()
    with pkg.scope_guard(pkg.Scope()), pkg.program_guard(main, startup):
        inf = pkg.layers.data("inf", shape=[1], dtype="int64", lod_level=1)
        lab = pkg.layers.data("lab", shape=[1], dtype="int64", lod_level=1)
        ev = pkg.evaluator.ChunkEvaluator(input=inf, label=lab,
                                          chunk_scheme="IOB",
                                          num_chunk_types=2)
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup)
        ev.reset(exe)
        for (i, l), lod in CHUNK_BATCHES:
            out = exe.run(main, feed={"inf": (i.reshape(-1, 1), lod),
                                      "lab": (l.reshape(-1, 1), lod)},
                          fetch_list=ev.metrics)
            results.append([float(np.asarray(v).reshape(-1)[0])
                            for v in out])
        results.append([float(v[0]) for v in ev.eval(exe)])
    return results


def test_chunk_evaluator_accumulates_over_two_batches():
    want, got = _chunk_evaluator(fluid), _chunk_evaluator(pt)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # the streaming totals are not the mean of the batches'
    assert got[-1] != got[0]


def _edit_evaluators(pkg):
    results = []
    main, startup = pkg.Program(), pkg.Program()
    with pkg.scope_guard(pkg.Scope()), pkg.program_guard(main, startup):
        hyp = pkg.layers.data("hyp", shape=[1], dtype="int64", lod_level=1)
        ref = pkg.layers.data("ref", shape=[1], dtype="int64", lod_level=1)
        ids = pkg.layers.data("ids", shape=[1], dtype="int64", lod_level=1)
        ed = pkg.evaluator.EditDistance(input=hyp, label=ref)
        ctc = pkg.evaluator.CTCErrorEvaluator(input=ids, label=ref)
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup)
        ed.reset(exe)
        ctc.reset(exe)
        batches = [
            (np.array([1, 2, 3, 4, 5]), [[0, 3, 5]], np.array([1, 3, 3, 9]),
             [[0, 2, 4]], np.array([0, 1, 1, 0, 3, 3, 9, 0]),
             [[0, 4, 8]]),
            (np.array([7, 7]), [[0, 1, 2]], np.array([7, 6, 6]),
             [[0, 1, 3]], np.array([7, 0, 6, 0, 6]), [[0, 1, 5]])]
        for h, hl, r, rl, i, il in batches:
            out = exe.run(main, feed={
                "hyp": (h.reshape(-1, 1).astype(np.int64), hl),
                "ref": (r.reshape(-1, 1).astype(np.int64), rl),
                "ids": (i.reshape(-1, 1).astype(np.int64), il)},
                fetch_list=ed.metrics + ctc.metrics)
            results.append([float(np.asarray(v).reshape(-1)[0])
                            for v in out])
        results.append([float(v[0]) for v in ed.eval(exe)] +
                       [float(ctc.eval(exe)[0])])
    return results


def test_edit_distance_evaluators_accumulate_over_two_batches():
    want, got = _edit_evaluators(fluid), _edit_evaluators(pt)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6)


def test_detection_map_names_its_item():
    """Item 6 is ported: ``DetectionMAP`` builds its batch and streamed
    mAPs (tests/test_torch_detection.py runs them) where it raised
    naming the item."""
    main = pt.Program()
    with pt.program_guard(main, pt.Program()):
        L = pt.layers
        ev = pt.evaluator.DetectionMAP(
            L.data(name="det", shape=[6], lod_level=1),
            L.data(name="lab", shape=[1], lod_level=1),
            L.data(name="box", shape=[4], lod_level=1), class_num=3)
    assert len(ev.metrics) == 2
    assert [op.type for op in main.global_block().ops].count(
        "detection_map") == 2
