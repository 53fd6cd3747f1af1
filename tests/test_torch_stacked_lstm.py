"""The stacked dynamic-LSTM classifier (``models.stacked_lstm``) and the
IMDB sentiment book's two nets (``tests/test_book_understand_sentiment.py``:
the convolution net over ``nets.sequence_conv_pool`` and the 3-layer
stacked LSTM) in the port against the JAX package, on the CPU.

Each program is built in both packages inside ``unique_name_scope``
(equal IR dicts, ignoring ``creation_site``), the JAX startup program is
run, its scope is moved into a port scope (``scope_from_numpy``), and
both take three Adam steps on seeded ragged batches (``fake_batch``:
lengths 2 … 12).  The losses of each step, every parameter and every
Adam accumulator agree to ``rtol = atol = 1e-5`` (float32 products
summed in different orders through up to 12 steps of recurrence, three
updates).  The reference runs with ``PADDLE_TPU_OPT`` unset and with its
``cross_entropy`` grad counted once, as the port counts it
(``reference_cross_entropy_grad_once``)."""

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.framework import unique_name_scope as jax_names
from paddle_tpu.models import stacked_lstm as JS
from paddle_tpu_torch.convert import persistable_names, scope_from_numpy
from paddle_tpu_torch.convert import to_numpy
from paddle_tpu_torch.framework import unique_name_scope as torch_names
from paddle_tpu_torch.models import stacked_lstm as TS
from test_torch_conv import reference_cross_entropy_grad_once  # noqa: F401

TOL = 1e-5
STEPS = 3
DICT, B, MAX_LEN = 50, 4, 12
PKGS = ((fluid, jax_names), (pt, torch_names))


@pytest.fixture
def reference(monkeypatch, reference_cross_entropy_grad_once):  # noqa: F811
    monkeypatch.delenv("PADDLE_TPU_OPT", raising=False)


def _strip(d):
    for block in d["blocks"]:
        for op in block["ops"]:
            op.pop("creation_site", None)
    return d


def _build(pkg, names, net):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with names("sl_"), pkg.program_guard(main, startup):
        cost, acc = net(pkg)
        pkg.optimizer.Adam(learning_rate=1e-2).minimize(cost)
    return main, startup, [cost, acc]


def _train_both(net, feeds):
    """Both packages from one state; the fetches of every step and every
    persistable variable agree.  Returns the losses."""
    (jm, js, jf), (tm, ts, tf) = (_build(pkg, names, net)
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
        want = jexe.run(jm, feed=feed, fetch_list=jf, scope=jscope)
        got = texe.run(tm, feed=feed, fetch_list=tf, scope=tscope)
        for var, w, g in zip(tf, want, got):
            np.testing.assert_allclose(g, np.asarray(w), rtol=TOL, atol=TOL,
                                       err_msg=f"step {step}: {var.name}")
        losses.append(float(got[0].reshape(())))
    for n in names:
        np.testing.assert_allclose(to_numpy(tscope.find_var(n)),
                                   np.asarray(jscope.find_var(n)), rtol=TOL,
                                   atol=TOL, err_msg=n)
    return losses


def _feeds(steps=STEPS):
    return [TS.fake_batch(B, MAX_LEN, DICT, seed=s) for s in range(steps)]


def _stacked_lstm(pkg):
    model = {fluid: JS, pt: TS}[pkg]
    cost, acc, _ = model.stacked_lstm_net(DICT, emb_dim=16, hidden_dim=16)
    return cost, acc


def test_fake_batch_matches_the_reference():
    for seed in (0, 5):
        want = JS.fake_batch(8, 100, 30000, seed=seed)
        got = TS.fake_batch(8, 100, 30000, seed=seed)
        np.testing.assert_array_equal(got["words"][0], want["words"][0])
        assert got["words"][1] == want["words"][1]
        np.testing.assert_array_equal(got["label"], want["label"])


def test_program_ir_matches_reference():
    progs = []
    for pkg, names in PKGS:
        main, startup = pkg.Program(), pkg.Program()
        model = {fluid: JS, pt: TS}[pkg]
        with names("sl_"), pkg.program_guard(main, startup):
            model.stacked_lstm_net(
                **{k: v for k, v in TS.BENCHMARK_LSTM.items()
                   if k in ("dict_size", "emb_dim", "hidden_dim",
                            "n_layers", "class_num")})
        progs.append((_strip(main.to_dict()), _strip(startup.to_dict())))
    assert progs[0] == progs[1]


def test_stacked_lstm_trains_as_the_reference(reference):
    losses = _train_both(_stacked_lstm, _feeds())
    assert len(set(losses)) == STEPS


# ---------------------------------------------------------------------------
# the book's two nets (tests/test_book_understand_sentiment.py)
# ---------------------------------------------------------------------------

EMB = HID = 8


def _book_data(pkg):
    data = pkg.layers.data(name="words", shape=[-1, 1], dtype="int64",
                           append_batch_size=False, lod_level=1)
    label = pkg.layers.data(name="label", shape=[-1, 1], dtype="int64",
                            append_batch_size=False)
    return data, label


def _convolution_net(pkg):
    layers = pkg.layers
    data, label = _book_data(pkg)
    emb = layers.embedding(input=data, size=[DICT, EMB])
    conv3 = pkg.nets.sequence_conv_pool(
        input=emb, num_filters=HID, filter_size=3, act="tanh",
        pool_type="sqrt")
    conv4 = pkg.nets.sequence_conv_pool(
        input=emb, num_filters=HID, filter_size=4, act="tanh",
        pool_type="sqrt")
    prediction = layers.fc(input=[conv3, conv4], size=2, act="softmax")
    cost = layers.cross_entropy(input=prediction, label=label)
    return layers.mean(cost), layers.accuracy(input=prediction, label=label)


def _book_stacked_lstm_net(pkg, stacked_num=3):
    layers = pkg.layers
    data, label = _book_data(pkg)
    emb = layers.embedding(input=data, size=[DICT, EMB])
    fc1 = layers.fc(input=emb, size=HID * 4)
    lstm1, _ = layers.dynamic_lstm(input=fc1, size=HID * 4,
                                   use_peepholes=False)
    inputs = [fc1, lstm1]
    for i in range(2, stacked_num + 1):
        fc = layers.fc(input=inputs, size=HID * 4)
        lstm, _ = layers.dynamic_lstm(input=fc, size=HID * 4,
                                      is_reverse=(i % 2) == 0,
                                      use_peepholes=False)
        inputs = [fc, lstm]
    fc_last = layers.sequence_pool(input=inputs[0], pool_type="max")
    lstm_last = layers.sequence_pool(input=inputs[1], pool_type="max")
    prediction = layers.fc(input=[fc_last, lstm_last], size=2,
                           act="softmax")
    cost = layers.cross_entropy(input=prediction, label=label)
    return layers.mean(cost), layers.accuracy(input=prediction, label=label)


@pytest.mark.parametrize("net", [_convolution_net, _book_stacked_lstm_net],
                         ids=["conv", "stacked_lstm"])
def test_book_sentiment_net_trains_as_the_reference(reference, net):
    losses = _train_both(net, _feeds())
    assert len(set(losses)) == STEPS
