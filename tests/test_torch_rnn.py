"""The port's recurrent ops (``lstm``, ``gru``, ``lstmp``, ``lstm_unit``,
``gru_unit``) against the JAX package's lowerings, on the CPU: outputs
and output LoD through both packages' ``lower_block``, input grads
through both packages' ``append_backward`` and ``Executor.run`` (the
ragged input fed as ``(value, lod)``), on the same seeded inputs.

The ragged cases run short sequences (T <= 12: float32 differences grow
along the recurrence) with one empty sequence among them, in both
directions (``is_reverse`` walks each sequence backwards inside its own
length), with and without peepholes and initial states.

Tolerance: float32 ``atol = rtol = 1e-5`` (products summed in different
orders, a few steps of recurrence)."""

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu_torch.lod import pad_tables
from test_torch_sequence import (assert_forward_matches, assert_grads_match,
                                 run_forward)

LOD = [[0, 5, 7, 12]]
LOD_EMPTY = [[0, 3, 3, 10]]
H = 4


@pytest.fixture(autouse=True)
def _plain_reference(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_OPT", raising=False)


def _f(rng, *shape, scale=0.5):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _lstm_case(name, lod, peep=True, reverse=False, init=False,
               acts=("sigmoid", "tanh", "tanh"), seed=0):
    r = np.random.RandomState(seed)
    n, B = lod[-1][-1], len(lod[-1]) - 1
    inputs = {"Input": (_f(r, n, 4 * H), lod),
              "Weight": (_f(r, H, 4 * H), None),
              "Bias": (_f(r, 1, (7 if peep else 4) * H), None)}
    if init:
        inputs["H0"] = (_f(r, B, H), None)
        inputs["C0"] = (_f(r, B, H), None)
    return (name, "lstm", inputs, ["Hidden", "Cell"],
            {"use_peepholes": peep, "is_reverse": reverse,
             "gate_activation": acts[0], "cell_activation": acts[1],
             "candidate_activation": acts[2]})


def _gru_case(name, lod, reverse=False, init=False, seed=1):
    r = np.random.RandomState(seed)
    n, B = lod[-1][-1], len(lod[-1]) - 1
    inputs = {"Input": (_f(r, n, 3 * H), lod),
              "Weight": (_f(r, H, 3 * H), None),
              "Bias": (_f(r, 1, 3 * H), None)}
    if init:
        inputs["H0"] = (_f(r, B, H), None)
    return (name, "gru", inputs, ["Hidden"],
            {"is_reverse": reverse, "gate_activation": "sigmoid",
             "activation": "tanh"})


def _lstmp_case(name, lod, peep=True, reverse=False, seed=2):
    r = np.random.RandomState(seed)
    P = 3
    return (name, "lstmp",
            {"Input": (_f(r, lod[-1][-1], 4 * H), lod),
             "Weight": (_f(r, P, 4 * H), None),
             "ProjWeight": (_f(r, H, P), None),
             "Bias": (_f(r, 1, (7 if peep else 4) * H), None)},
            ["Projection", "Cell"],
            {"use_peepholes": peep, "is_reverse": reverse,
             "gate_activation": "sigmoid", "cell_activation": "tanh",
             "candidate_activation": "tanh", "proj_activation": "tanh"})


def _cases():
    r = np.random.RandomState(9)
    return [
        _lstm_case("lstm_peepholes", LOD),
        _lstm_case("lstm_no_peepholes", LOD, peep=False),
        _lstm_case("lstm_reverse", LOD, reverse=True),
        _lstm_case("lstm_reverse_no_peepholes_empty", LOD_EMPTY, peep=False,
                   reverse=True),
        _lstm_case("lstm_h0_c0_empty", LOD_EMPTY, init=True),
        _lstm_case("lstm_relu_identity", LOD,
                   acts=("sigmoid", "relu", "identity")),
        _gru_case("gru", LOD),
        _gru_case("gru_reverse_h0_empty", LOD_EMPTY, reverse=True,
                  init=True),
        _lstmp_case("lstmp", LOD),
        _lstmp_case("lstmp_reverse_no_peepholes", LOD_EMPTY, peep=False,
                    reverse=True),
        ("lstm_unit", "lstm_unit",
         {"X": (_f(r, 3, 4 * H), None), "C_prev": (_f(r, 3, H), None)},
         ["C", "H"], {"forget_bias": 0.5}),
        ("gru_unit", "gru_unit",
         {"Input": (_f(r, 3, 3 * H), None),
          "HiddenPrev": (_f(r, 3, H), None),
          "Weight": (_f(r, H, 3 * H), None), "Bias": (_f(r, 1, 3 * H), None)},
         ["Gate", "ResetHiddenPrev", "Hidden"],
         {"activation": "tanh", "gate_activation": "sigmoid"}),
        ("gru_unit_int_codes", "gru_unit",
         {"Input": (_f(r, 3, 3 * H), None),
          "HiddenPrev": (_f(r, 3, H), None),
          "Weight": (_f(r, H, 3 * H), None)},
         ["Gate", "ResetHiddenPrev", "Hidden"],
         {"activation": 3, "gate_activation": 1}),
    ]


@pytest.mark.parametrize("case", _cases(), ids=lambda c: c[0])
def test_rnn_op_matches_reference(case):
    _, op_type, inputs, out_slots, attrs = case
    got, got_lod = assert_forward_matches(op_type, inputs, out_slots, attrs)
    lod = inputs.get("Input", (None, None))[1]
    if lod is not None:       # the ragged ops keep their input's LoD
        assert all(got_lod[f"out_{s}"] == lod for s in out_slots)


@pytest.mark.parametrize("case", _cases(), ids=lambda c: c[0])
def test_rnn_op_grad_matches_reference(case):
    _, op_type, inputs, out_slots, attrs = case
    assert_grads_match(op_type, inputs, out_slots, attrs)


@pytest.mark.parametrize("reverse", [False, True])
def test_pad_tables_match_the_reference(reverse):
    """The flat <-> padded tables against the JAX package's
    ``_lod_pad_tables`` (``[B, T]``, slot ``b * T + t``; the port's are
    time-major), an empty sequence included."""
    from paddle_tpu.ops.rnn_ops import _lod_pad_tables
    lod = [[0, 3, 3, 7, 8]]
    gather, scatter, lengths, B, T = _lod_pad_tables(lod, reverse)
    pad = pad_tables({}, lod, "cpu", reverse)
    assert (pad.B, pad.T) == (B, T)
    np.testing.assert_array_equal(pad.gather.numpy().T, gather)
    t, b = np.divmod(pad.scatter.numpy(), B)
    np.testing.assert_array_equal(b * T + t, scatter)
    np.testing.assert_array_equal(pad.live.numpy()[:, :, 0].T,
                                  np.arange(T)[None, :] < lengths[:, None])


def test_reverse_walks_each_sequence_inside_its_length():
    """``is_reverse``: a sequence's last row sees its own first step, so
    the reversed LSTM equals the forward one on each sequence reversed
    in place (not a reversal of the padded ``[T, B]``)."""
    _, _, inputs, outs, attrs = _lstm_case("r", LOD_EMPTY, reverse=True)
    (_, _), (rev, _) = run_forward("lstm", inputs, outs, attrs)
    x, lod = inputs["Input"]
    sp = lod[0]
    order = np.concatenate([np.arange(sp[i + 1] - 1, sp[i] - 1, -1)
                            for i in range(len(sp) - 1)])
    fwd_inputs = dict(inputs, Input=(x[order], lod))
    (_, _), (fwd, _) = run_forward("lstm", fwd_inputs, outs,
                                   dict(attrs, is_reverse=False))
    np.testing.assert_allclose(rev["out_Hidden"][order], fwd["out_Hidden"],
                               atol=1e-6, rtol=1e-6)


def test_lstm_needs_lod():
    """A dense feed to ``dynamic_lstm`` fails in both packages."""
    x = _f(np.random.RandomState(0), 6, 4 * H)
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            xv = pkg.layers.data("x", shape=[-1, 4 * H],
                                 append_batch_size=False)
            h, _ = pkg.layers.dynamic_lstm(xv, 4 * H)
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        exe.run(startup, scope=scope)
        with pytest.raises(ValueError, match="requires LoD"):
            exe.run(main, feed={"x": x}, fetch_list=[h], scope=scope)
