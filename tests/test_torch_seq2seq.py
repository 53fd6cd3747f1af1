"""The attention seq2seq NMT model (``models.seq2seq``) and the machine
translation book's GRU + DynamicRNN net
(``tests/test_book_machine_translation.py``) in the port against the JAX
package, on the CPU.

Each program is built in both packages inside ``unique_name_scope``
(equal IR dicts, ``while_grad`` and its sub-block included, ignoring
``creation_site``), the JAX startup program is run, its scope is moved
into a port scope (``scope_from_numpy``), and both take three Adam steps
on seeded ragged batches, each with a new LoD.  The losses of each step,
every parameter and every Adam accumulator agree to ``rtol = atol =
1e-5`` (float32 products summed in different orders through up to 8
decoder steps, three updates).  The reference runs with
``PADDLE_TPU_OPT`` unset and with its ``cross_entropy`` grad counted
once, as the port counts it (``reference_cross_entropy_grad_once``)."""

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.framework import unique_name_scope as jax_names
from paddle_tpu.models import seq2seq as JS
from paddle_tpu_torch.convert import persistable_names, scope_from_numpy
from paddle_tpu_torch.convert import to_numpy
from paddle_tpu_torch.framework import unique_name_scope as torch_names
from paddle_tpu_torch.models import seq2seq as TS
from test_torch_conv import reference_cross_entropy_grad_once  # noqa: F401

TOL = 1e-5
STEPS = 3
DICT, WIDTH, B, MAX_LEN = 16, 16, 4, 8
PKGS = ((fluid, jax_names), (pt, torch_names))


@pytest.fixture
def reference(monkeypatch, reference_cross_entropy_grad_once):  # noqa: F811
    monkeypatch.delenv("PADDLE_TPU_OPT", raising=False)


def _strip(d):
    for block in d["blocks"]:
        for op in block["ops"]:
            op.pop("creation_site", None)
    return d


def _build(pkg, names, net, lr):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with names("s2s_"), pkg.program_guard(main, startup):
        cost = net(pkg)
        pkg.optimizer.Adam(learning_rate=lr).minimize(cost)
    return main, startup, cost


def _train_both(net, feeds, lr=1e-2):
    """Both packages from one state; every step's loss and every
    persistable variable agree.  Returns the losses and the port's
    executor."""
    (jm, js, jc), (tm, ts, tc) = (_build(pkg, names, net, lr)
                                  for pkg, names in PKGS)
    assert _strip(tm.to_dict()) == _strip(jm.to_dict())
    assert _strip(ts.to_dict()) == _strip(js.to_dict())
    jexe, jscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    jexe.run(js, scope=jscope)
    names = persistable_names(tm)
    tscope = scope_from_numpy({n: np.asarray(jscope.find_var(n))
                               for n in names}, pt.CPUPlace(), tm)
    texe = pt.Executor(pt.CPUPlace())
    losses = []
    for step, feed in enumerate(feeds):
        (want,) = jexe.run(jm, feed=feed, fetch_list=[jc], scope=jscope)
        (got,) = texe.run(tm, feed=feed, fetch_list=[tc], scope=tscope)
        np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL,
                                   err_msg=f"step {step} loss")
        losses.append(float(got.reshape(())))
    for n in names:
        np.testing.assert_allclose(to_numpy(tscope.find_var(n)),
                                   np.asarray(jscope.find_var(n)), rtol=TOL,
                                   atol=TOL, err_msg=n)
    return losses, texe


def test_fake_batch_matches_the_reference():
    for seed in (0, 5):
        want = JS.fake_batch(16, 50, 50, 30000, 30000, seed=seed)
        got = TS.fake_batch(16, 50, 50, 30000, 30000, seed=seed)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k][0], want[k][0])
            assert got[k][0].dtype == want[k][0].dtype
            assert got[k][1] == want[k][1]


def test_program_ir_matches_reference():
    """At the benchmark's widths: the training program (forward, the
    decoder's sub-block, ``while_grad`` and Adam) and the startup."""
    cfg = TS.SEQ2SEQ_NMT_512
    progs = []
    for pkg, names in PKGS:
        model = {fluid: JS, pt: TS}[pkg]
        main, startup = pkg.Program(), pkg.Program()
        with names("s2s_"), pkg.program_guard(main, startup):
            cost, _ = model.seq_to_seq_net(
                cfg["src_dict_size"], cfg["trg_dict_size"], cfg["emb_dim"],
                cfg["encoder_size"], cfg["decoder_size"])
            pkg.optimizer.Adam(learning_rate=cfg["lr"]).minimize(cost)
        progs.append((_strip(main.to_dict()), _strip(startup.to_dict())))
    assert progs[0] == progs[1]
    blocks = progs[1][0]["blocks"]
    assert len(blocks) == 2
    types = [op["type"] for op in blocks[0]["ops"]]
    assert types.count("while") == 1 and types.count("while_grad") == 1


def _seq2seq(pkg):
    model = {fluid: JS, pt: TS}[pkg]
    cost, _ = model.seq_to_seq_net(DICT, DICT, WIDTH, WIDTH, WIDTH)
    return cost


def test_seq2seq_trains_as_the_reference(reference):
    feeds = [TS.fake_batch(B, MAX_LEN, MAX_LEN, DICT, DICT, seed=s)
             for s in range(STEPS)]
    assert len({tuple(f["trg_word"][1][0]) for f in feeds}) == STEPS
    losses, exe = _train_both(_seq2seq, feeds)
    assert len(set(losses)) == STEPS
    # T decoder trips and T more in while_grad's re-run, 5 host reads a
    # trip (2 array reads, 2 writes, the condition), each loop's last
    # condition, the boot memory's write and its grad
    T = int(max(np.diff(feeds[-1]["trg_word"][1][0])))
    assert exe.last_run == {"while_trips": 2 * T, "host_reads": 10 * T + 4}


# ---------------------------------------------------------------------------
# tests/test_book_machine_translation.py's net
# ---------------------------------------------------------------------------

BOOK_DICT, BOOK_EMB, BOOK_HID = 64, 16, 32


def _book_net(pkg):
    layers = pkg.layers
    src = layers.data(name="src", shape=[-1, 1], dtype="int64",
                      append_batch_size=False, lod_level=1)
    trg = layers.data(name="trg", shape=[-1, 1], dtype="int64",
                      append_batch_size=False, lod_level=1)
    label = layers.data(name="label", shape=[-1, 1], dtype="int64",
                        append_batch_size=False, lod_level=1)
    src_emb = layers.embedding(input=src, size=[BOOK_DICT, BOOK_EMB])
    enc_proj = layers.fc(input=src_emb, size=BOOK_HID * 3)
    enc = layers.dynamic_gru(input=enc_proj, size=BOOK_HID)
    enc_last = layers.sequence_last_step(enc)
    trg_emb = layers.embedding(input=trg, size=[BOOK_DICT, BOOK_EMB])
    drnn = layers.DynamicRNN()
    with drnn.block():
        cur = drnn.step_input(trg_emb)
        mem = drnn.memory(init=enc_last)
        dec_h = layers.fc(input=[cur, mem], size=BOOK_HID, act="tanh")
        drnn.update_memory(mem, dec_h)
        out = layers.fc(input=dec_h, size=BOOK_DICT, act="softmax")
        drnn.output(out)
    cost = layers.cross_entropy(input=drnn(), label=label)
    return layers.mean(cost)


def _book_feeds():
    """Ragged copies of the book's batches: new lengths each step."""
    rng = np.random.RandomState(11)
    feeds = []
    for _ in range(STEPS):
        s_lens, t_lens = rng.randint(2, 7, B), rng.randint(2, 6, B)
        src = rng.randint(2, BOOK_DICT, (s_lens.sum(), 1)).astype("int64")
        trg = rng.randint(2, BOOK_DICT, (t_lens.sum(), 1)).astype("int64")
        lab = (trg * 3 + 1) % BOOK_DICT
        s_lod = [[0] + np.cumsum(s_lens).tolist()]
        t_lod = [[0] + np.cumsum(t_lens).tolist()]
        feeds.append({"src": (src, s_lod), "trg": (trg, t_lod),
                      "label": (lab, t_lod)})
    return feeds


def test_book_machine_translation_trains_as_the_reference(reference):
    losses, _ = _train_both(_book_net, _book_feeds(), lr=5e-3)
    assert len(set(losses)) == STEPS
