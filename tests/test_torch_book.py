"""Two chapters of the Fluid book in the port against the JAX package,
on the CPU: semantic role labeling (``tests/test_book_label_semantic_roles.py``:
db_lstm, ``linear_chain_crf``, ``crf_decoding`` and the streaming
``ChunkEvaluator``) and the recommender system
(``tests/test_book_recommender_system.py``: ``cos_sim``).

The SRL net is ``chip_smoke.srl_net``, which builds the net of the card's
full-width phase: at the JAX test's widths it must give the JAX test's
own program (equal IR dicts, ignoring ``creation_site``), and its
8-feature, depth-8 book structure (fixed word embedding, sparse
predicate and mark embeddings, ``tanh``, decayed SGD) at hidden 16 must
give the JAX package's.  Each net then takes three steps in both
packages from one state (the JAX startup's scope moved with
``scope_from_numpy``; the book structure two, for time): losses and every parameter within ``rtol = atol
= 1e-5`` (``tests/test_torch_stacked_lstm.py``'s tolerance: float32
products summed in different orders through the recurrences), decoded
paths and chunk counts equal."""

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from chip_smoke import SRL_BOOK, iob_chunks, srl_batches, srl_final_scores
from chip_smoke import srl_net
from paddle_tpu.dataset import conll05 as jax_conll05
from paddle_tpu.framework import unique_name_scope as jax_names
from paddle_tpu_torch.convert import persistable_names, scope_from_numpy
from paddle_tpu_torch.convert import to_numpy
from paddle_tpu_torch.framework import unique_name_scope as torch_names
from paddle_tpu_torch.ops.metric_ops import chunk_segments
import test_book_label_semantic_roles as jax_srl

TOL = 1e-5
STEPS = 3
PKGS = {fluid: jax_names, pt: torch_names}

#: the JAX test's widths (tests/test_book_label_semantic_roles.py:13-21)
SRL_TEST = dict(SRL_BOOK, word_dict=jax_srl.WORD_DICT,
                pred_dict=jax_srl.PRED_DICT, label_dict=jax_srl.LABEL_DICT,
                mark_dict=jax_srl.MARK_DICT, word_dim=jax_srl.WORD_DIM,
                mark_dim=jax_srl.MARK_DIM, hidden=jax_srl.HIDDEN * 4,
                depth=2, words=("word", "ctx_n1", "ctx_p1"),
                rows=jax_srl.BATCH * jax_srl.CLIP_LEN, book=False,
                chunk_types=(jax_srl.LABEL_DICT - 2) // 2)
#: the book's structure (8 features, depth 8) at hidden 16
SRL_SMALL_BOOK = dict(SRL_BOOK, word_dict=200, pred_dict=50, label_dict=12,
                      word_dim=16, mark_dim=4, hidden=64, chunk_types=6,
                      batch=3)


@pytest.fixture(autouse=True)
def _plain_reference(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_OPT", raising=False)


def _strip(d):
    for block in d["blocks"]:
        for op in block["ops"]:
            op.pop("creation_site", None)
    return d


def _reference_test_program():
    """The JAX test's own program: its data layers and ``_db_lstm``, then
    its CRF, mean, SGD, decoding and evaluator."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with jax_names("srl_"), fluid.program_guard(main, startup):
        def seq_data(name):
            return layers.data(name=name, shape=[SRL_TEST["rows"], 1],
                               append_batch_size=False, dtype="int64",
                               lod_level=1)
        word, ctx_n1, ctx_p1, verb, mark, target = (
            seq_data(n) for n in ("word", "ctx_n1", "ctx_p1", "verb",
                                  "mark", "target"))
        feature_out = jax_srl._db_lstm(word, verb, ctx_n1, ctx_p1, mark)
        crf_cost = layers.linear_chain_crf(
            input=feature_out, label=target,
            param_attr=fluid.ParamAttr(name="crfw"))
        avg_cost = layers.mean(crf_cost)
        fluid.optimizer.SGD(learning_rate=0.01).minimize(avg_cost)
        decode = layers.crf_decoding(
            input=feature_out, param_attr=fluid.ParamAttr(name="crfw"))
        ev = fluid.evaluator.ChunkEvaluator(
            input=decode, label=target, chunk_scheme="IOB",
            num_chunk_types=SRL_TEST["chunk_types"])
    return main, startup, avg_cost, decode, ev


def _srl_program(pkg, cfg):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with PKGS[pkg]("srl_"), pkg.program_guard(main, startup):
        _, cost, decode, ev = srl_net(pkg, cfg)
    return main, startup, cost, decode, ev


def test_srl_net_is_the_reference_test_program():
    """``srl_net`` at the JAX test's widths builds the JAX test's
    program, in either package."""
    jm, js, *_ = _reference_test_program()
    for pkg in (fluid, pt):
        m, s, *_ = _srl_program(pkg, SRL_TEST)
        assert _strip(m.to_dict()) == _strip(jm.to_dict()), pkg.__name__
        assert _strip(s.to_dict()) == _strip(js.to_dict()), pkg.__name__


def _train_both(cfg, feeds, setup=None):
    """Both packages' ``srl_net`` programs (equal IR) from the JAX
    startup's state, one step a feed: the losses, paths and evaluator
    outputs of every step and every parameter at the end agree.  Returns
    the port's losses and evaluator state."""
    (jm, js, jc, jd, jev), (tm, ts, tc, td, tev) = (
        _srl_program(pkg, cfg) for pkg in (fluid, pt))
    assert _strip(tm.to_dict()) == _strip(jm.to_dict())
    assert _strip(ts.to_dict()) == _strip(js.to_dict())
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    texe = pt.Executor(pt.CPUPlace())
    with fluid.scope_guard(jscope):
        jexe.run(js)
        if setup:
            setup(jscope)
        jev.reset(jexe)
    names = persistable_names(tm)
    tscope = scope_from_numpy({n: np.asarray(jscope.find_var(n))
                               for n in names}, pt.CPUPlace(), tm)
    losses = []
    for step, feed in enumerate(feeds):
        with fluid.scope_guard(jscope):
            want = jexe.run(jm, feed=feed,
                            fetch_list=[jc, jd] + jev.metrics)
        with pt.scope_guard(tscope):
            got = texe.run(tm, feed=feed, fetch_list=[tc, td] + tev.metrics)
        np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=TOL,
                                   atol=TOL, err_msg=f"step {step} loss")
        np.testing.assert_array_equal(got[1].reshape(-1),
                                      np.asarray(want[1]).reshape(-1),
                                      err_msg=f"step {step} path")
        for g, w in zip(got[2:], want[2:]):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6)
        losses.append(float(got[0].reshape(())))
    for n in names:
        np.testing.assert_allclose(to_numpy(tscope.find_var(n)),
                                   np.asarray(jscope.find_var(n)),
                                   rtol=TOL, atol=TOL, err_msg=n)
    with fluid.scope_guard(jscope):
        want = [float(v[0]) for v in jev.eval(jexe)]
    with pt.scope_guard(tscope):
        got = [float(v[0]) for v in tev.eval(texe)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    counts = [int(to_numpy(tscope.find_var(v.name)).reshape(-1)[0])
              for v in tev.states]
    assert counts == [int(np.asarray(jscope.find_var(v.name)).reshape(-1)[0])
                      for v in jev.states]
    return losses, counts


def test_srl_trains_as_the_reference_at_its_test_widths():
    """The JAX test's widths and batches (5 features, depth 2, hidden
    16, sequences clipped to 10), three SGD steps."""
    batches = [jax_srl._stack(b)[0] for b in jax_srl._chunks(
        jax_srl._batches(STEPS * jax_srl.BATCH), jax_srl.BATCH)]
    feeds = [dict(zip(("word", "ctx_n1", "ctx_p1", "verb", "mark",
                       "target"), cols)) for cols in batches]
    losses, counts = _train_both(SRL_TEST, feeds)
    assert len(set(losses)) == STEPS and counts[1] > 0


def _small_book_feed():
    """One batch of 3 unclipped ``conll05`` sequences at
    ``SRL_SMALL_BOOK``'s dictionaries (its ids taken modulo them)."""
    cfg = SRL_SMALL_BOOK

    def cut(sample):
        mods = [cfg["word_dict"]] * 6 + [cfg["pred_dict"], 2,
                                         cfg["label_dict"]]
        return tuple([int(v) % m for v in field]
                     for field, m in zip(sample, mods))
    samples = (cut(s) for s in jax_conll05.train()())
    (feed,) = srl_batches(samples, cfg, 1)
    return feed


def test_srl_book_structure_trains_as_the_reference():
    """The card's 8-feature, depth-8 net at hidden 16: fixed word
    embedding, sparse predicate and mark embeddings, ``tanh``, SGD with
    exponential decay; two steps on one batch of unclipped sequences
    (one LoD: one JAX compile; the JAX package runs this block op by op,
    ~10 s a step here)."""
    feed = _small_book_feed()
    emb = np.random.RandomState(3).normal(
        0, 0.1, (SRL_SMALL_BOOK["word_dict"], 16)).astype(np.float32)
    losses, _ = _train_both(SRL_SMALL_BOOK, [feed] * 2,
                            setup=lambda scope: scope.set_var("emb", emb))
    assert losses[-1] < losses[0]


def test_iob_recount_matches_chunk_segments():
    """``chip_smoke.iob_chunks``, the card phase's plain recount, finds
    the chunks the port's ``chunk_eval`` finds, on random tag runs."""
    r = np.random.RandomState(0)
    for _ in range(200):
        tags = r.randint(0, 7, r.randint(0, 12))
        want = set(chunk_segments(tags, 3, "IOB"))
        assert iob_chunks(tags, 3) == want, tags


def test_final_scores_name_the_decoded_path():
    """``chip_smoke.srl_final_scores`` (the near-tie check of the card
    phase): per sequence the best final score is that of the decoded
    path, and the second is no higher."""
    from paddle_tpu_torch.dataset import conll05
    cfg = dict(SRL_SMALL_BOOK, depth=2)
    main, startup, cost, decode, ev = _srl_program(pt, cfg)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    feed = _small_book_feed()
    with pt.scope_guard(scope):
        exe.run(startup)
        ev.reset(exe)
    state = {n: to_numpy(scope.find_var(n)) for n in persistable_names(main)}
    scores = srl_final_scores(pt, main, state, feed)
    block = main.global_block()
    decode_op = next(op for op in block.ops if op.type == "crf_decoding")
    with pt.scope_guard(scope):
        em, path = exe.run(main, feed=feed,
                           fetch_list=[decode_op.input("Emission")[0],
                                       decode])
    trans = state["crfw"].astype(np.float64)
    splits = feed["target"][1][0]
    assert scores.shape == (len(splits) - 1, 2)
    for b, (lo, hi) in enumerate(zip(splits[:-1], splits[1:])):
        p = path.reshape(-1)[lo:hi]
        e = em[lo:hi].astype(np.float64)
        sc = trans[0, p[0]] + e[0, p[0]] + sum(
            trans[2 + p[t - 1], p[t]] + e[t, p[t]] for t in range(1, len(p)))
        sc += trans[1, p[-1]]
        np.testing.assert_allclose(scores[b, 0], sc, rtol=1e-5)
        assert scores[b, 1] <= scores[b, 0]
    assert conll05.word_dict_len == 44068


# ---------------------------------------------------------------------------
# the recommender system (cos_sim)
# ---------------------------------------------------------------------------

def _recommender(pkg):
    layers = pkg.layers
    ml = pkg.dataset.movielens
    uid = layers.data(name="user_id", shape=[1], dtype="int64")
    gender = layers.data(name="gender_id", shape=[1], dtype="int64")
    age = layers.data(name="age_id", shape=[1], dtype="int64")
    job = layers.data(name="job_id", shape=[1], dtype="int64")
    mid = layers.data(name="movie_id", shape=[1], dtype="int64")
    label = layers.data(name="score", shape=[1], dtype="float32")
    usr = layers.fc(input=[
        layers.embedding(input=uid, size=[ml.max_user_id() + 1, 32]),
        layers.embedding(input=gender, size=[2, 8]),
        layers.embedding(input=age, size=[len(ml.age_table), 8]),
        layers.embedding(input=job, size=[ml.max_job_id() + 1, 8])],
        size=64, act="tanh")
    mov = layers.fc(input=layers.embedding(
        input=mid, size=[ml.max_movie_id() + 1, 32]), size=64, act="tanh")
    inference = layers.cos_sim(X=usr, Y=mov)
    cost = layers.square_error_cost(
        input=layers.scale(x=inference, scale=5.0), label=label)
    avg_cost = layers.mean(cost)
    pkg.optimizer.Adam(learning_rate=5e-3).minimize(avg_cost)
    return avg_cost, inference


def test_recommender_system_trains_as_the_reference():
    """The book test's net (``cos_sim`` of the user and movie towers)
    at its widths, three Adam steps of 64 ratings from one state."""
    progs = []
    for pkg, names in PKGS.items():
        main, startup = pkg.Program(), pkg.Program()
        with names("rec_"), pkg.program_guard(main, startup):
            fetch = _recommender(pkg)
        progs.append((main, startup, fetch))
    (jm, js, jf), (tm, ts, tf) = progs
    assert _strip(tm.to_dict()) == _strip(jm.to_dict())
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    jexe.run(js, scope=jscope)
    tscope = scope_from_numpy(
        {n: np.asarray(jscope.find_var(n)) for n in persistable_names(tm)},
        pt.CPUPlace(), tm)
    texe = pt.Executor(pt.CPUPlace())
    samples = pt.dataset.movielens.train()()
    for step in range(STEPS):
        batch = [next(samples) for _ in range(64)]
        feed = {name: np.asarray([[b[i]] for b in batch],
                                 "float32" if name == "score" else "int64")
                for i, name in ((0, "user_id"), (1, "gender_id"),
                                (2, "age_id"), (3, "job_id"),
                                (4, "movie_id"), (7, "score"))}
        want = jexe.run(jm, feed=feed, fetch_list=jf, scope=jscope)
        got = texe.run(tm, feed=feed, fetch_list=tf, scope=tscope)
        for g, w, what in zip(got, want, ("loss", "cos_sim")):
            np.testing.assert_allclose(g, np.asarray(w), rtol=TOL, atol=TOL,
                                       err_msg=f"step {step} {what}")
    for n in persistable_names(tm):
        np.testing.assert_allclose(to_numpy(tscope.find_var(n)),
                                   np.asarray(jscope.find_var(n)),
                                   rtol=TOL, atol=TOL, err_msg=n)
