"""Beam search in the port against the JAX package, on the CPU: the op
cases of ``tests/test_beam_search.py`` (ties at -1e9 included),
``cross_entropy_over_beam`` and its grad, and the beam decode of
``_build_decode`` (an unrolled decode of the toy seq2seq: GRU encoder,
``expand`` / ``gather`` of the beams, ``topk``, ``beam_search``, step
arrays and ``beam_search_decode``) in both packages over one scope.

Ids, parents and sentences are equal; scores, costs and grads agree to
``rtol = atol = 1e-5`` (float32; the decode sums log-probabilities over
5 steps)."""

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.framework import unique_name_scope as jax_names
from paddle_tpu_torch.convert import persistable_names, scope_from_numpy
from paddle_tpu_torch.framework import unique_name_scope as torch_names

TOL = 1e-5
PKGS = ((fluid, jax_names), (pt, torch_names))


def _strip(d):
    for block in d["blocks"]:
        for op in block["ops"]:
            op.pop("creation_site", None)
    return d


def _run_both(net, feed):
    """Build ``net`` in both packages (equal IR dicts), run the JAX
    startup, move its scope over, run both on ``feed``; returns
    (reference fetches, port fetches)."""
    progs = []
    for pkg, names in PKGS:
        main, startup = pkg.Program(), pkg.Program()
        with names("bs_"), pkg.program_guard(main, startup):
            fetch = net(pkg)
        progs.append((main, startup, [f if isinstance(f, str) else f.name
                                      for f in fetch]))
    (jm, js, jf), (tm, ts, tf) = progs
    assert _strip(tm.to_dict()) == _strip(jm.to_dict())
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    jexe.run(js, scope=jscope)
    tscope = scope_from_numpy({n: np.asarray(jscope.find_var(n))
                               for n in persistable_names(tm)},
                              pt.CPUPlace(), tm)
    want = jexe.run(jm, feed=feed, fetch_list=jf, scope=jscope)
    got = pt.Executor(pt.CPUPlace()).run(tm, feed=feed, fetch_list=tf,
                                         scope=tscope)
    return [np.asarray(w) for w in want], got


def _assert_same(want, got):
    for i, (w, g) in enumerate(zip(want, got)):
        assert g.shape == w.shape, i
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                                       err_msg=str(i))
        else:
            np.testing.assert_array_equal(g, w, err_msg=str(i))


# ---------------------------------------------------------------------------
# beam_search / beam_search_decode
# ---------------------------------------------------------------------------

def _beam_search_net(arrays, K, end_id):
    def net(pkg):
        layers = pkg.layers
        ins = [layers.data(name=n, shape=list(a.shape), dtype=str(a.dtype),
                           append_batch_size=False)
               for n, a in arrays.items()]
        return list(layers.beam_search(*ins, K, end_id))
    return net


def _first_step_ties():
    """The first step's seeding: beam 0 scores 0, the others -1e9, so
    every candidate of beams 1 and 2 is exactly -1e9 in float32; with
    K > C the top K takes the lowest flat indices among those ties."""
    rng = np.random.RandomState(0)
    B, K, C = 2, 3, 2
    pre_scores = np.tile(np.float32([0.0, -1e9, -1e9]), (B, 1))
    logp = np.log(rng.rand(B, K, C).astype("float32") * 0.5 + 0.1)
    return {"p_i": np.ones((B, K), "int64"), "p_s": pre_scores,
            "c_i": rng.randint(2, 50, (B, K, C)).astype("int64"),
            "c_s": (pre_scores[:, :, None] + logp).astype("float32")}, K


def _finished_ties():
    """Two finished beams offer one (end_id, pre_score) candidate each
    and -1e9 in their other slots; the live beam's candidates are all
    -1e9 too: the ties fill the beam in flat-index order."""
    return {"p_i": np.array([[0, 7, 0]], "int64"),
            "p_s": np.array([[-0.5, -1e9, -2.0]], "float32"),
            "c_i": np.array([[[10, 11], [12, 13], [14, 15]]], "int64"),
            "c_s": np.full((1, 3, 2), -1e9, "float32")}, 3


@pytest.mark.parametrize("case", [
    ({"p_i": np.array([[5, 7]], "int64"),
      "p_s": np.array([[-1.0, -2.0]], "float32"),
      "c_i": np.array([[[10, 11], [12, 13]]], "int64"),
      "c_s": np.array([[[-1.5, -3.0], [-2.1, -9.0]]], "float32")}, 2),
    ({"p_i": np.array([[0, 7]], "int64"),
      "p_s": np.array([[-0.5, -2.0]], "float32"),
      "c_i": np.array([[[10, 11], [12, 13]]], "int64"),
      "c_s": np.array([[[-0.1, -0.2], [-2.5, -9.0]]], "float32")}, 2),
    _first_step_ties(), _finished_ties()],
    ids=["topk_across_beams", "finished_beam", "first_step_ties",
         "finished_ties"])
def test_beam_search_matches_reference(case):
    arrays, K = case
    want, got = _run_both(_beam_search_net(arrays, K, end_id=0), arrays)
    _assert_same(want, got)


def test_beam_search_tie_order():
    """Among exact ties the lowest flat index wins, as ``lax.top_k``: the
    third pick is beam 0's second slot (-1e9, end_id), not one of beam
    1's candidates."""
    arrays, K = _finished_ties()
    _, (ids, scores, parent) = _run_both(
        _beam_search_net(arrays, K, end_id=0), arrays)
    np.testing.assert_array_equal(ids, [[0, 0, 0]])
    np.testing.assert_array_equal(parent, [[0, 2, 0]])
    np.testing.assert_array_equal(scores, [[-0.5, -2.0, -1e9]])


def test_beam_search_decode_backtrack():
    steps_ids = [np.array([[4, 5]], "int64"), np.array([[6, 7]], "int64"),
                 np.array([[8, 9]], "int64")]
    steps_par = [np.array([[0, 1]], "int64"), np.array([[1, 0]], "int64"),
                 np.array([[0, 1]], "int64")]

    def net(pkg):
        layers = pkg.layers
        i0 = layers.zeros(shape=[1], dtype="int64")
        ids_arr = layers.array_write(layers.assign(steps_ids[0]), i=i0)
        par_arr = layers.array_write(layers.assign(steps_par[0]), i=i0)
        for t in (1, 2):
            it = layers.fill_constant(shape=[1], dtype="int64", value=t)
            layers.array_write(layers.assign(steps_ids[t]), i=it,
                               array=ids_arr)
            layers.array_write(layers.assign(steps_par[t]), i=it,
                               array=par_arr)
        final = layers.assign(np.array([[-1.0, -2.0]], "float32"))
        return list(layers.beam_search_decode(ids_arr, par_arr, final,
                                              max_len=3))

    want, got = _run_both(net, {})
    _assert_same(want, got)
    np.testing.assert_array_equal(got[0][0], [[5, 6, 8], [4, 7, 9]])


# ---------------------------------------------------------------------------
# cross_entropy_over_beam (the cases of TestCrossEntropyOverBeam)
# ---------------------------------------------------------------------------

def _ceob_net(n_expansions, lod_levels):
    def net(pkg):
        layers = pkg.layers
        scores, ids, golds = [], [], []
        for i in range(n_expansions):
            sc = layers.data(f"sc{i}", shape=[-1, 1], dtype="float32",
                             append_batch_size=False,
                             lod_level=lod_levels[i])
            sc.stop_gradient = False
            scores.append(sc)
            ids.append(layers.data(f"ids{i}", shape=[-1, -1], dtype="int64",
                                   append_batch_size=False))
            golds.append(layers.data(f"g{i}", shape=[-1], dtype="int64",
                                     append_batch_size=False))
        block = pkg.default_main_program().current_block()
        cost = block.create_var(name="ceob_cost", dtype="float32")
        block.append_op(type="cross_entropy_over_beam",
                        inputs={"Scores": scores, "Ids": ids, "Gold": golds},
                        outputs={"Out": [cost]}, attrs={})
        pkg.append_backward(layers.reduce_sum(cost))
        return [cost] + [f"sc{i}@GRAD" for i in range(n_expansions)]
    return net


SC4 = np.array([[0.1], [0.9], [0.4], [0.3]], "float32")
SC0 = np.array([[0.5], [1.0], [0.2]], "float32")
SC1 = np.array([[0.3], [0.7], [0.9], [0.1]], "float32")


@pytest.mark.parametrize("feeds,n,levels", [
    ({"sc0": (SC4, [[0, 4]]), "ids0": np.array([[2, 0]], "int64"),
      "g0": np.array([2], "int64")}, 1, [1]),
    ({"sc0": (SC4, [[0, 4]]), "ids0": np.array([[2, 0]], "int64"),
      "g0": np.array([3], "int64")}, 1, [1]),
    ({"sc0": (SC0, [[0, 3]]), "ids0": np.array([[1, 0]], "int64"),
      "g0": np.array([1], "int64"), "sc1": (SC1, [[0, 2], [0, 2, 4]]),
      "ids1": np.array([[0, 1], [1, -1]], "int64"),
      "g1": np.array([0], "int64")}, 2, [1, 2]),
    ({"sc0": (SC0, [[0, 3]]), "ids0": np.array([[2, -1, 1]], "int64"),
      "g0": np.array([1], "int64"), "sc1": (SC1, [[0, 2], [0, 2, 4]]),
      "ids1": np.array([[0, -1, -1], [1, 0, -1]], "int64"),
      "g1": np.array([1], "int64")}, 2, [1, 2]),
    ({"sc0": (np.concatenate([SC4, SC0]), [[0, 4, 7]]),
      "ids0": np.array([[2, 0, 1], [1, 2, -1]], "int64"),
      "g0": np.array([0, 0], "int64")}, 1, [1])],
    ids=["single_expansion", "gold_off_beam", "two_expansions",
         "padded_row", "two_sequences"])
def test_cross_entropy_over_beam_and_grad(feeds, n, levels):
    want, got = _run_both(_ceob_net(n, levels), feeds)
    _assert_same(want, got)
    assert all(np.abs(g).sum() > 0 for g in got[1:])


# ---------------------------------------------------------------------------
# the decode program of tests/test_beam_search.py
# ---------------------------------------------------------------------------

DICT, EMB, HID = 64, 16, 32
B, K, SRC_LEN, TRG_LEN = 4, 3, 6, 5
START = 1


def build_decode(pkg, dict_size=DICT, emb=EMB, hid=HID, batch=B, beam=K,
                 steps=TRG_LEN):
    """``tests/test_beam_search.py``'s ``_build_decode`` in ``pkg``, at its
    widths by default; returns ``(sentence ids, sentence scores)``."""
    layers, attr = pkg.layers, pkg.ParamAttr
    src = layers.data(name="src", shape=[-1, 1], dtype="int64",
                      append_batch_size=False, lod_level=1)
    src_emb = layers.embedding(input=src, size=[dict_size, emb],
                               param_attr=attr("src_emb_w"))
    enc_proj = layers.fc(input=src_emb, size=hid * 3,
                         param_attr=attr("enc_proj_w"), bias_attr=False)
    enc = layers.dynamic_gru(input=enc_proj, size=hid, is_reverse=True,
                             param_attr=attr("enc_gru_w"),
                             bias_attr=attr("enc_gru_b"))
    enc_last = layers.sequence_first_step(enc)
    mem = layers.reshape(
        layers.expand(layers.reshape(enc_last, shape=[batch, 1, hid]),
                      expand_times=[1, beam, 1]),
        shape=[batch * beam, hid])
    pre_ids = layers.assign(np.full((batch, beam), START, "int64"))
    pre_scores = layers.assign(np.tile(
        np.array([[0.0] + [-1e9] * (beam - 1)], "float32"), (batch, 1)))
    beam_offset = layers.assign(
        (np.arange(batch, dtype="int64")[:, None] * beam).repeat(beam, 1))
    layers.zeros(shape=[1], dtype="int64")
    ids_arr = par_arr = None
    for t in range(steps):
        cur = layers.embedding(
            input=layers.reshape(pre_ids, shape=[batch * beam, 1]),
            size=[dict_size, emb], param_attr=attr("trg_emb_w"))
        dec_h = layers.fc(input=[cur, mem], size=hid, act="tanh",
                          param_attr=[attr("dec_fc_w_x"),
                                      attr("dec_fc_w_h")],
                          bias_attr=attr("dec_fc_b"))
        out = layers.fc(input=dec_h, size=dict_size, act="softmax",
                        param_attr=attr("dec_out_w"),
                        bias_attr=attr("dec_out_b"))
        probs = layers.reshape(out, shape=[batch, beam, dict_size])
        topk_scores, topk_idx = layers.topk(probs, k=beam)
        acc = layers.ops.log(topk_scores) + layers.reshape(
            pre_scores, shape=[batch, beam, 1])
        sel_ids, sel_scores, parent = layers.beam_search(
            pre_ids, pre_scores, topk_idx, acc, beam, end_id=0)
        mem = layers.gather(dec_h, layers.reshape(parent + beam_offset,
                                                  shape=[batch * beam]))
        it = layers.fill_constant(shape=[1], dtype="int64", value=t)
        if ids_arr is None:
            ids_arr = layers.array_write(sel_ids, i=it)
            par_arr = layers.array_write(parent, i=it)
        else:
            layers.array_write(sel_ids, i=it, array=ids_arr)
            layers.array_write(parent, i=it, array=par_arr)
        pre_ids, pre_scores = sel_ids, sel_scores
    return layers.beam_search_decode(ids_arr, par_arr, pre_scores,
                                     max_len=steps)


def decode_probes(program):
    """The names to fetch for :func:`beam_margins`: each step's ``top_k``
    input (the probabilities) and ``beam_search`` inputs."""
    ops = program.global_block().ops
    return ([op.input("X")[0] for op in ops if op.type == "top_k"],
            [[op.input(s)[0] for s in ("pre_ids", "pre_scores", "ids",
                                       "scores")]
             for op in ops if op.type == "beam_search"])


def beam_margins(probs, searches, k, end_id=0):
    """The least gap, over the steps, between the k-th and (k+1)-th
    largest log-probability of a row (``top_k``'s choice) and between
    the k-th and (k+1)-th candidate score of a batch row as
    ``beam_search`` ranks them (log-probabilities summed; a finished beam
    offers its score once); exact -1e9 ties do not count (both packages
    break them by index)."""
    gap = np.inf
    for p in probs:
        top = np.log(-np.sort(-p.reshape(-1, p.shape[-1]), axis=1))
        gap = min(gap, float((top[:, k - 1] - top[:, k]).min()))
    for pre_ids, pre_scores, _, scores in searches:
        cand = scores.astype(np.float64).copy()
        done = pre_ids == end_id
        cand[done] = -1e9
        cand[done, 0] = pre_scores[done]
        flat = -np.sort(-cand.reshape(cand.shape[0], -1), axis=1)
        a, b = flat[:, k - 1], flat[:, k]
        real = a > -1e8
        if real.any():
            gap = min(gap, float((a - b)[real].min()))
    return gap


def test_decode_program_matches_reference_and_decodes_the_same():
    """The transcription's IR equals the reference's ``_build_decode``;
    from one startup-initialised scope both decode the same sentences
    (the output layer's weights scaled so that no near tie between the
    k-th and (k+1)-th candidate decides them, checked on the
    reference's run), with scores within 1e-5."""
    from tests.test_beam_search import _build_decode

    with jax_names("bs_"):
        jm, js, jsent, jscores = _build_decode()
    tm, ts = pt.Program(), pt.Program()
    with torch_names("bs_"), pt.program_guard(tm, ts):
        tsent, tscores = build_decode(pt)
    assert _strip(tm.to_dict()) == _strip(jm.to_dict())
    assert _strip(ts.to_dict()) == _strip(js.to_dict())

    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    jexe.run(js, scope=jscope)
    state = {n: np.asarray(jscope.find_var(n))
             for n in persistable_names(tm)}
    state["dec_out_w"] = state["dec_out_w"] * np.float32(8.0)
    jscope.set_var("dec_out_w", state["dec_out_w"])
    tscope = scope_from_numpy(state, pt.CPUPlace(), tm)
    rng = np.random.RandomState(7)
    src = rng.randint(2, DICT, size=(B * SRC_LEN, 1)).astype("int64")
    feed = {"src": (src, [list(range(0, B * SRC_LEN + 1, SRC_LEN))])}
    probs, searches = decode_probes(tm)
    fetch = [jsent.name, jscores.name] + probs + sum(searches, [])
    want = [np.asarray(w) for w in jexe.run(jm, feed=feed, fetch_list=fetch,
                                            scope=jscope)]
    n = len(probs)
    gap = beam_margins(want[2:2 + n], [want[2 + n + 4 * i:6 + n + 4 * i]
                                       for i in range(len(searches))], K)
    assert gap > 1e-4, gap
    got = pt.Executor(pt.CPUPlace()).run(tm, feed=feed, fetch_list=fetch[:2],
                                         scope=tscope)
    _assert_same(want[:2], got)
    assert got[0].shape == (B, K, TRG_LEN)
    assert len({tuple(r) for r in got[0][:, 0]}) > 1
    assert np.all(np.diff(got[1], axis=1) <= 0)
