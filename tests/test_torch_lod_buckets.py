"""The bucketed dynamic-LoD mode (``program.lod_buckets`` /
``PADDLE_TPU_LOD_BUCKETS``) in the port against the JAX package's, on
the CPU, class by class as ``tests/test_lod_buckets.py`` holds the JAX
package to its static mode.

Each case builds one program in both packages (the same parameter
names), runs the JAX startup program, moves its scope into the port's
(``convert.scope_from_numpy``) and feeds both the same seeded ragged
batches: the JAX package in bucketed mode, the port in bucketed mode
and, on a second copy of the state, in its static mode.  Fetches,
losses and parameters agree to float32 ``atol = rtol = 1e-5`` (sums in
other orders; the bucketed rows are padded, the real rows' values the
same).  A bucketed fetch of ragged rows is held on its real rows, and
its padding rows must be zero.  The reference runs with
``PADDLE_TPU_OPT`` unset and its ``cross_entropy`` grad counted once, as
the port counts it (``reference_cross_entropy_grad_once``).

Beside the parity: the step cache stays bounded over a stream of
distinct LoDs (``jit_cache.misses``), ``run_steps`` windows of ragged
batches equal per-batch runs, the capture rule lets a bucketed LSTM
training block into a CUDA graph (``_host_ops(..., dyn=True)`` empty,
its second step audited for host work) and keeps a seq2seq block, whose
``while`` reads the device, eager."""

import copy
import warnings

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.framework import unique_name_scope as jax_names
from paddle_tpu.models import seq2seq as JS
from paddle_tpu.models import stacked_lstm as JL
from paddle_tpu_torch import executor as texecutor
from paddle_tpu_torch import profiler as tprofiler
from paddle_tpu_torch.convert import persistable_names, scope_from_numpy
from paddle_tpu_torch.convert import to_numpy
from paddle_tpu_torch.framework import unique_name_scope as torch_names
from paddle_tpu_torch.lod import DynLoD, next_bucket
from paddle_tpu_torch.models import seq2seq as TS
from paddle_tpu_torch.models import stacked_lstm as TL
from test_torch_compiled import _Audit, recorded  # noqa: F401
from test_torch_conv import reference_cross_entropy_grad_once  # noqa: F401

TOL = 1e-5
CPU = pt.CPUPlace()
PKGS = ((fluid, jax_names), (pt, torch_names))


@pytest.fixture(autouse=True)
def reference(monkeypatch, reference_cross_entropy_grad_once):  # noqa: F811
    monkeypatch.delenv("PADDLE_TPU_OPT", raising=False)
    monkeypatch.delenv("PADDLE_TPU_LOD_BUCKETS", raising=False)


def _rand_lod(rng, batch, max_len):
    lengths = rng.randint(1, max_len + 1, size=batch)
    splits = np.concatenate([[0], np.cumsum(lengths)])
    return [[int(s) for s in splits]]


def _misses():
    return tprofiler.runtime_metrics.counter("jit_cache.misses")


class _Pair:
    """One program in both packages from one state: the JAX package's
    executor and scope, and the port's executor over a bucketed and a
    static copy of the scope."""

    def __init__(self, build, seed=11, optimizer=None):
        progs = []
        for pkg, names in PKGS:
            main, startup = pkg.Program(), pkg.Program()
            main.random_seed = startup.random_seed = seed
            with names("lb_"), pkg.program_guard(main, startup):
                fetch = build(pkg)
                if optimizer is not None:
                    optimizer(pkg).minimize(fetch[-1])
            progs.append((main, startup, fetch))
        (self.jm, js, self.jf), (self.tm, _, self.tf) = progs
        self.jexe, self.jscope = fluid.Executor(fluid.CPUPlace()), \
            fluid.Scope()
        self.jexe.run(js, scope=self.jscope)
        arrays = {n: np.asarray(self.jscope.find_var(n))
                  for n in persistable_names(self.tm)}
        self.texe = pt.Executor(CPU)
        self.tscope = scope_from_numpy(arrays, CPU, self.tm)
        self.sexe = pt.Executor(CPU)
        self.sscope = scope_from_numpy(arrays, CPU, self.tm)
        self.static = copy.copy(self.tm)
        self.jm.lod_buckets = self.tm.lod_buckets = True
        self.static.lod_buckets = False

    def run(self, feed, fetch_idx=None):
        """One step of all three: ``(jax, port bucketed, port static)``
        fetches as numpy arrays."""
        idx = range(len(self.jf)) if fetch_idx is None else fetch_idx
        jf = [self.jf[i] for i in idx]
        tf = [self.tf[i] for i in idx]
        j = self.jexe.run(self.jm, feed=feed, fetch_list=jf,
                          scope=self.jscope)
        t = self.texe.run(self.tm, feed=feed, fetch_list=tf,
                          scope=self.tscope)
        s = self.sexe.run(self.static, feed=feed, fetch_list=tf,
                          scope=self.sscope)
        return ([np.asarray(v) for v in j], [np.asarray(v) for v in t],
                [np.asarray(v) for v in s])

    def assert_state(self):
        for n in persistable_names(self.tm):
            want = np.asarray(self.jscope.find_var(n))
            for scope in (self.tscope, self.sscope):
                np.testing.assert_allclose(to_numpy(scope.find_var(n)), want,
                                           rtol=TOL, atol=TOL, err_msg=n)


def _assert_rows(got, want, what):
    """A bucketed fetch against an exact one: equal on the real rows,
    zero on the padding rows past them."""
    n = want.shape[0]
    np.testing.assert_allclose(got[:n], want, rtol=TOL, atol=TOL,
                               err_msg=what)
    assert not np.abs(got[n:]).any(), f"{what}: padding rows not zero"


def _assert_three(j, t, s, what=""):
    for i, (a, b, c) in enumerate(zip(j, t, s)):
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL,
                                   err_msg=f"{what} fetch {i} port bucketed")
        _assert_rows(a, c, f"{what} fetch {i} jax bucketed vs port static")


# ---------------------------------------------------------------------------
# test_lod_buckets.py:67-118: five model kinds, forward and training
# ---------------------------------------------------------------------------

def _seq_model(kind, dim=8):
    def build(pkg):
        layers = pkg.layers
        x = layers.data(name="x", shape=[64, dim], append_batch_size=False,
                        lod_level=1)
        x.stop_gradient = False
        if kind == "pool_chain":
            h = layers.sequence_softmax(layers.fc(input=x, size=1,
                                                  bias_attr=False,
                                                  param_attr="w_sm"))
            weighted = layers.elementwise_mul(x, h, axis=0)
            pooled = layers.sequence_pool(weighted, "sum")
            avg = layers.sequence_pool(x, "average")
            out = layers.fc(input=layers.concat([pooled, avg], axis=1),
                            size=1, param_attr="w_out")
        elif kind == "lstm":
            proj = layers.fc(input=x, size=4 * dim, bias_attr=False,
                             param_attr="w_proj")
            hidden, _ = layers.dynamic_lstm(proj, size=4 * dim,
                                            param_attr="w_lstm",
                                            bias_attr="b_lstm",
                                            use_peepholes=False)
            out = layers.fc(input=layers.sequence_pool(hidden, "last"),
                            size=1, param_attr="w_out")
        elif kind == "gru":
            proj = layers.fc(input=x, size=3 * dim, bias_attr=False,
                             param_attr="w_proj")
            hidden = layers.dynamic_gru(proj, size=dim, param_attr="w_gru",
                                        bias_attr="b_gru")
            out = layers.fc(input=layers.sequence_pool(hidden, "max"),
                            size=1, param_attr="w_out")
        elif kind == "expand":
            pooled = layers.sequence_pool(x, "average")
            ctx_feat = layers.fc(input=pooled, size=dim, param_attr="w_ctx")
            expanded = layers.sequence_expand(x=ctx_feat, y=x)
            mixed = layers.elementwise_add(x, expanded)
            reshaped = layers.sequence_reshape(mixed, new_dim=dim // 2)
            out = layers.fc(input=layers.sequence_pool(reshaped, "sum"),
                            size=1, param_attr="w_out")
        elif kind == "conv":
            h = layers.sequence_conv(x, num_filters=6, filter_size=3,
                                     param_attr="w_sc", bias_attr="b_sc")
            out = layers.fc(input=layers.sequence_pool(h, "sum"), size=1,
                            param_attr="w_out")
        return out, layers.reduce_mean(out)
    return build


KINDS = ["pool_chain", "lstm", "gru", "conv", "expand"]


class TestBucketedEqualsStatic:
    @pytest.mark.parametrize("kind", KINDS)
    def test_forward_parity(self, kind):
        rng = np.random.RandomState(0)
        lod = _rand_lod(rng, 4, 9)
        data = rng.rand(lod[0][-1], 8).astype("float32")
        pair = _Pair(_seq_model(kind))
        j, t, s = pair.run({"x": (data, lod)})
        for a, b, c in zip(j, t, s):
            np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)
            np.testing.assert_allclose(c, a, rtol=TOL, atol=TOL)

    @pytest.mark.parametrize("kind", KINDS)
    def test_training_parity(self, kind):
        """Three SGD steps (fwd + bwd + update) on one ragged batch: the
        losses and every parameter agree across the three runs."""
        rng = np.random.RandomState(1)
        lod = _rand_lod(rng, 4, 7)
        data = rng.rand(lod[0][-1], 8).astype("float32")
        pair = _Pair(_seq_model(kind),
                     optimizer=lambda pkg: pkg.optimizer.SGD(0.1))
        for step in range(3):
            j, t, s = pair.run({"x": (data, lod)}, fetch_idx=[1])
            np.testing.assert_allclose(t[0], j[0], rtol=TOL, atol=TOL,
                                       err_msg=f"step {step}")
            np.testing.assert_allclose(s[0], j[0], rtol=TOL, atol=TOL,
                                       err_msg=f"step {step}")
        pair.assert_state()


# ---------------------------------------------------------------------------
# test_lod_buckets.py:120-144: bounded cache entries over 100 LoDs
# ---------------------------------------------------------------------------

class TestBoundedCompiles:
    def test_100_distinct_lods_few_cache_entries(self):
        """100 batches of distinct LoDs: at most 8 step-cache entries
        (``jit_cache.misses``), every loss the JAX package's."""
        rng = np.random.RandomState(2)
        pair = _Pair(_seq_model("pool_chain"),
                     optimizer=lambda pkg: pkg.optimizer.SGD(0.01))
        seen, misses0 = set(), _misses()
        for _ in range(100):
            lod = _rand_lod(rng, 4, 16)
            seen.add(tuple(lod[0]))
            data = rng.rand(lod[0][-1], 8).astype("float32")
            j = pair.jexe.run(pair.jm, feed={"x": (data, lod)},
                              fetch_list=[pair.jf[1]], scope=pair.jscope)
            t = pair.texe.run(pair.tm, feed={"x": (data, lod)},
                              fetch_list=[pair.tf[1]], scope=pair.tscope)
            np.testing.assert_allclose(t[0], np.asarray(j[0]), rtol=TOL,
                                       atol=TOL)
        assert len(seen) > 60
        assert _misses() - misses0 <= 8, _misses() - misses0
        assert len(pair.texe._cache) <= 8


# ---------------------------------------------------------------------------
# test_lod_buckets.py:146-309: slice, concat, reset, erase
# ---------------------------------------------------------------------------

def _ones(pkg, name):
    return pkg.ParamAttr(name, initializer=pkg.initializer.Constant(1.0))


class TestBucketedNewOps:
    def test_slice_concat_reset_parity(self):
        rng = np.random.RandomState(3)
        lod, lod2 = [[0, 3, 5, 9]], [[0, 2, 4, 6]]
        feed = {"x": (rng.rand(9, 4).astype("float32"), lod),
                "x2": (rng.rand(6, 4).astype("float32"), lod2),
                "o": np.array([0, 1, 2], "int64"),
                "l": np.array([2, 1, 2], "int64")}

        def build(pkg):
            layers = pkg.layers
            x = layers.data(name="x", shape=[-1, 4],
                            append_batch_size=False, lod_level=1)
            x2 = layers.data(name="x2", shape=[-1, 4],
                             append_batch_size=False, lod_level=1)
            o = layers.data(name="o", shape=[3], dtype="int64",
                            append_batch_size=False)
            ln = layers.data(name="l", shape=[3], dtype="int64",
                             append_batch_size=False)
            sl = layers.sequence_slice(x, o, ln)
            cc = layers.sequence_concat([sl, x2])
            pooled = layers.sequence_pool(cc, "sum")
            return sl, cc, layers.fc(input=pooled, size=1, bias_attr=False,
                                     param_attr=_ones(pkg, "w_p"))

        pair = _Pair(build)
        j, t, s = pair.run(feed)
        _assert_three(j, t, s, "slice/concat")
        np.testing.assert_allclose(t[2], s[2], rtol=TOL, atol=TOL)

    def test_lod_reset_parity(self):
        rng = np.random.RandomState(4)
        feed = {"x": (rng.rand(6, 4).astype("float32"), [[0, 2, 6]])}

        def build(pkg):
            layers = pkg.layers
            x = layers.data(name="x", shape=[-1, 4],
                            append_batch_size=False, lod_level=1)
            rs = layers.lod_reset(x, target_lod=[0, 3, 6])
            pooled = layers.sequence_pool(rs, "average")
            return rs, layers.fc(input=pooled, size=1, bias_attr=False,
                                 param_attr=_ones(pkg, "w_q"))

        pair = _Pair(build)
        j, t, s = pair.run(feed)
        _assert_three(j, t, s, "lod_reset")

    def test_erase_parity(self):
        ids = np.array([[1], [0], [3], [0], [2], [5], [0], [4]], "int64")

        def build(pkg):
            layers = pkg.layers
            x = layers.data(name="ids", shape=[-1, 1], dtype="int64",
                            append_batch_size=False, lod_level=1)
            er = layers.sequence_erase(x, tokens=[0])
            return er, layers.sequence_pool(layers.cast(er, "float32"),
                                            "sum")

        pair = _Pair(build)
        j, t, s = pair.run({"ids": (ids, [[0, 3, 8]])})
        _assert_three(j, t, s, "erase")
        np.testing.assert_allclose(t[1].reshape(-1), [4.0, 11.0])

    @pytest.mark.parametrize("op", ["sequence_erase", "sequence_slice"])
    def test_host_op_over_a_static_lod_in_a_traced_block(self, op):
        """A dense X (one row a sequence: a static LoD) in a bucketed
        block the JAX package traces: both packages run the op's bucketed
        branch over constant splits, the output padded to X's rows."""
        feed = {"x": np.array([[1], [0], [3], [0], [2]], "int64"),
                "o": np.zeros(5, "int64"),
                "l": np.array([1, 0, 1, 1, 0], "int64")}

        def build(pkg):
            layers = pkg.layers
            x = layers.data(name="x", shape=[-1, 1], dtype="int64",
                            append_batch_size=False)
            if op == "sequence_erase":
                return (layers.sequence_erase(x, tokens=[0]),)
            o = layers.data(name="o", shape=[-1], dtype="int64",
                            append_batch_size=False)
            ln = layers.data(name="l", shape=[-1], dtype="int64",
                             append_batch_size=False)
            return (layers.sequence_slice(x, o, ln),)

        pair = _Pair(build)
        pair.static.expect_host_ops = True
        j, t, s = pair.run(feed if op == "sequence_slice"
                           else {"x": feed["x"]})
        _assert_three(j, t, s, op)
        assert t[0].shape[0] == 5

    def test_streaming_bounded_cache_through_new_ops(self):
        """100 distinct LoDs through slice + concat + the pool, trained:
        every loss the JAX package's, a handful of cache entries."""
        rng = np.random.RandomState(5)

        def build(pkg):
            layers = pkg.layers
            x = layers.data(name="x", shape=[-1, 4],
                            append_batch_size=False, lod_level=1)
            o = layers.data(name="o", shape=[4], dtype="int64",
                            append_batch_size=False)
            ln = layers.data(name="l", shape=[4], dtype="int64",
                             append_batch_size=False)
            cc = layers.sequence_concat([layers.sequence_slice(x, o, ln), x])
            out = layers.fc(input=layers.sequence_pool(cc, "sum"), size=1,
                            param_attr="w_s")
            return (layers.reduce_mean(out),)

        pair = _Pair(build, optimizer=lambda pkg: pkg.optimizer.SGD(0.01))
        misses0 = _misses()
        for _ in range(100):
            lod = _rand_lod(rng, 4, 12)
            lengths = np.diff(np.asarray(lod[0]))
            feed = {"x": (rng.rand(lod[0][-1], 4).astype("float32"), lod),
                    "o": np.zeros(4, "int64"),
                    "l": np.maximum(lengths - 1, 1).astype("int64")}
            j = pair.jexe.run(pair.jm, feed=feed, fetch_list=list(pair.jf),
                              scope=pair.jscope)
            t = pair.texe.run(pair.tm, feed=feed, fetch_list=list(pair.tf),
                              scope=pair.tscope)
            np.testing.assert_allclose(t[0], np.asarray(j[0]), rtol=TOL,
                                       atol=TOL)
        assert _misses() - misses0 <= 8


# ---------------------------------------------------------------------------
# test_lod_buckets.py:311-369: the DynamicRNN decoder
# ---------------------------------------------------------------------------

def _nmt_decoder(pkg, dict_size=16, emb=8, hid=8):
    layers = pkg.layers
    src = layers.data(name="src", shape=[-1, 1], dtype="int64",
                      append_batch_size=False, lod_level=1)
    trg = layers.data(name="trg", shape=[-1, 1], dtype="int64",
                      append_batch_size=False, lod_level=1)
    label = layers.data(name="label", shape=[-1, 1], dtype="int64",
                        append_batch_size=False, lod_level=1)
    src_emb = layers.embedding(input=src, size=[dict_size, emb],
                               param_attr="nmt_semb")
    enc_proj = layers.fc(input=src_emb, size=hid * 3, param_attr="nmt_ep")
    enc = layers.dynamic_gru(input=enc_proj, size=hid,
                             param_attr="nmt_gru", bias_attr="nmt_grub")
    enc_last = layers.sequence_last_step(enc)
    trg_emb = layers.embedding(input=trg, size=[dict_size, emb],
                               param_attr="nmt_temb")
    drnn = layers.DynamicRNN()
    with drnn.block():
        cur = drnn.step_input(trg_emb)
        mem = drnn.memory(init=enc_last)
        dec_h = layers.fc(input=[cur, mem], size=hid, act="tanh",
                          param_attr="nmt_dec")
        drnn.update_memory(mem, dec_h)
        out = layers.fc(input=dec_h, size=dict_size, act="softmax",
                        param_attr="nmt_out")
        drnn.output(out)
    cost = layers.cross_entropy(input=drnn(), label=label)
    return (layers.mean(cost),)


def _nmt_batch(rng, batch, src_max, trg_max, dict_size=16):
    s_lod = _rand_lod(rng, batch, src_max)
    t_lod = _rand_lod(rng, batch, trg_max)
    src = rng.randint(0, dict_size, (s_lod[0][-1], 1)).astype("int64")
    trg = rng.randint(0, dict_size, (t_lod[0][-1], 1)).astype("int64")
    lab = rng.randint(0, dict_size, (t_lod[0][-1], 1)).astype("int64")
    return {"src": (src, s_lod), "trg": (trg, t_lod),
            "label": (lab, t_lod)}


class TestStreamingDecodeUnderBuckets:
    def test_decoder_parity_bucketed_vs_static(self):
        rng = np.random.RandomState(7)
        feed = _nmt_batch(rng, 4, 6, 5)
        pair = _Pair(_nmt_decoder, seed=3,
                     optimizer=lambda pkg: pkg.optimizer.SGD(0.1))
        for step in range(3):
            j, t, s = pair.run(feed)
            np.testing.assert_allclose(t[0], j[0], rtol=TOL, atol=TOL,
                                       err_msg=f"step {step}")
            np.testing.assert_allclose(s[0], j[0], rtol=TOL, atol=TOL,
                                       err_msg=f"step {step}")
        pair.assert_state()
        # the loop and the re-run of its grad, each as many masked trips
        # as the step array holds: the length bucket of the longest
        # target under the buckets, the longest target static
        longest = int(np.diff(feed["trg"][1][0]).max())
        assert pair.texe.last_run == {
            "while_trips": 2 * next_bucket(longest), "host_reads": 0}
        assert pair.sexe.last_run == {"while_trips": 2 * longest,
                                      "host_reads": 0}

    def test_decoder_100_distinct_lods_bounded_cache(self):
        """Two independent ragged feeds: the entries are bounded by their
        bucket pairs, not by the 100 LoDs."""
        rng = np.random.RandomState(8)
        pair = _Pair(_nmt_decoder, seed=3,
                     optimizer=lambda pkg: pkg.optimizer.SGD(0.05))
        seen, losses, misses0 = set(), [], _misses()
        for i in range(100):
            feed = _nmt_batch(rng, 4, 14, 11)
            seen.add((tuple(feed["src"][1][0]), tuple(feed["trg"][1][0])))
            (t,) = pair.texe.run(pair.tm, feed=feed, fetch_list=list(pair.tf),
                                 scope=pair.tscope)
            losses.append(float(t.reshape(())))
            if i < 10:
                (j,) = pair.jexe.run(pair.jm, feed=feed,
                                     fetch_list=list(pair.jf),
                                     scope=pair.jscope)
                np.testing.assert_allclose(t, np.asarray(j), rtol=TOL,
                                           atol=TOL, err_msg=f"step {i}")
        assert len(seen) > 80
        assert np.isfinite(losses).all()
        assert _misses() - misses0 <= 24, _misses() - misses0


# ---------------------------------------------------------------------------
# test_lod_buckets.py:371-406: sequence_expand with a ragged X
# ---------------------------------------------------------------------------

class TestRaggedXSequenceExpand:
    def test_parity_with_static(self):
        rng = np.random.RandomState(11)
        feed = {"x": (rng.rand(5, 2).astype("f"), [[0, 2, 5]]),
                "y": (rng.rand(4, 1).astype("f"), [[0, 3, 4]])}

        def build(pkg):
            layers = pkg.layers
            x = layers.data(name="x", shape=[-1, 2], dtype="float32",
                            append_batch_size=False, lod_level=1)
            y = layers.data(name="y", shape=[-1, 1], dtype="float32",
                            append_batch_size=False, lod_level=1)
            ex = layers.sequence_expand(x=x, y=y)
            return ex, layers.reduce_sum(ex)

        pair = _Pair(build)
        j, t, s = pair.run(feed)
        assert s[0].shape[0] == 9            # 2 * 3 + 3 * 1 rows
        _assert_three(j[:1], t[:1], s[:1], "expand")
        np.testing.assert_allclose(t[1], s[1], rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# test_lod_buckets.py:408-519: the streaming beam decode
# ---------------------------------------------------------------------------

class TestBeamDecodeStream:
    DICT, EMB, HID, B, K, T = 40, 12, 16, 4, 3, 5

    def _build(self, pkg):
        D, layers, attr = self, pkg.layers, pkg.ParamAttr
        src = layers.data(name="src", shape=[-1, 1], dtype="int64",
                          append_batch_size=False, lod_level=1)
        emb = layers.embedding(input=src, size=[D.DICT, D.EMB],
                               param_attr=attr("bs_emb"))
        proj = layers.fc(input=emb, size=D.HID * 3, bias_attr=False,
                         param_attr=attr("bs_proj"))
        proj.lod_level = 1
        enc = layers.dynamic_gru(input=proj, size=D.HID,
                                 param_attr=attr("bs_gru"),
                                 bias_attr=attr("bs_grub"))
        enc_last = layers.sequence_last_step(enc)
        mem = layers.reshape(
            layers.expand(layers.reshape(enc_last, shape=[D.B, 1, D.HID]),
                          expand_times=[1, D.K, 1]),
            shape=[D.B * D.K, D.HID])
        pre_ids = layers.assign(np.full((D.B, D.K), 1, "int64"))
        pre_scores = layers.assign(np.tile(
            np.array([[0.0] + [-1e9] * (D.K - 1)], "f"), (D.B, 1)))
        beam_offset = layers.assign(
            (np.arange(D.B, dtype="int64")[:, None] * D.K).repeat(D.K, 1))
        ids_arr = par_arr = None
        for t in range(D.T):
            cur = layers.embedding(
                input=layers.reshape(pre_ids, shape=[D.B * D.K, 1]),
                size=[D.DICT, D.EMB], param_attr=attr("bs_temb"))
            dec_h = layers.fc(input=[cur, mem], size=D.HID, act="tanh",
                              param_attr=[attr("bs_fcx"), attr("bs_fch")],
                              bias_attr=attr("bs_fcb"))
            out = layers.fc(input=dec_h, size=D.DICT, act="softmax",
                            param_attr=attr("bs_out"),
                            bias_attr=attr("bs_outb"))
            probs = layers.reshape(out, shape=[D.B, D.K, D.DICT])
            topk_scores, topk_idx = layers.topk(probs, k=D.K)
            acc = layers.ops.log(topk_scores) + layers.reshape(
                pre_scores, shape=[D.B, D.K, 1])
            sel_ids, sel_scores, parent = layers.beam_search(
                pre_ids, pre_scores, topk_idx, acc, D.K, end_id=0)
            mem = layers.gather(dec_h, layers.reshape(parent + beam_offset,
                                                      shape=[D.B * D.K]))
            it = layers.fill_constant(shape=[1], dtype="int64", value=t)
            if ids_arr is None:
                ids_arr = layers.array_write(sel_ids, i=it)
                par_arr = layers.array_write(parent, i=it)
            else:
                layers.array_write(sel_ids, i=it, array=ids_arr)
                layers.array_write(parent, i=it, array=par_arr)
            pre_ids, pre_scores = sel_ids, sel_scores
        return layers.beam_search_decode(ids_arr, par_arr, pre_scores,
                                         max_len=D.T)

    def test_streaming_decode_bounded_and_matches(self):
        rng = np.random.RandomState(5)
        batches = []
        for _ in range(30):
            lod = _rand_lod(rng, self.B, 12)
            batches.append({"src": (rng.randint(
                2, self.DICT, (lod[0][-1], 1)).astype("int64"), lod)})
        pair = _Pair(self._build, seed=3)
        misses0 = _misses()
        for b in batches:
            j, t, s = pair.run(b)
            np.testing.assert_array_equal(t[0], j[0])
            np.testing.assert_array_equal(s[0], j[0])
            np.testing.assert_allclose(t[1], j[1], rtol=TOL, atol=TOL)
            np.testing.assert_allclose(s[1], j[1], rtol=TOL, atol=TOL)
        assert len({tuple(b["src"][1][0]) for b in batches}) >= 20
        # the bucketed entries (the static run's counted apart)
        assert len(pair.texe._cache) <= 6, len(pair.texe._cache)
        assert _misses() - misses0 > len(pair.texe._cache)


# ---------------------------------------------------------------------------
# test_lod_buckets.py:521-574: the nested-LoD beam training ops
# ---------------------------------------------------------------------------

def _sub_nested_seq(pkg, x, sel):
    """A ``sub_nested_seq`` op (the trainer_config_helpers layer's, which
    the port does not carry) appended to the current block."""
    block = pkg.default_main_program().current_block()
    out = block.create_var(name=x.name + ".picked", dtype="float32",
                           lod_level=1)
    block.append_op(type="sub_nested_seq",
                    inputs={"X": [x], "SelectedIndices": [sel]},
                    outputs={"Out": [out]})
    return out


class TestBeamTrainingDisposition:
    """A 2-level LoD is not bucketed (the switch pads single-level feeds
    only): ``sub_nested_seq`` keeps its host path, its block eager (no
    CUDA graph), every batch's rows the selection's, the JAX package's;
    under a bucketed LoD the op raises the recipe."""

    def _build(self, pkg):
        layers = pkg.layers
        x = layers.data(name="x", shape=[-1, 4], dtype="float32",
                        append_batch_size=False, lod_level=2)
        sel = layers.data(name="sel", shape=[-1, 2], dtype="int64",
                          append_batch_size=False)
        picked = _sub_nested_seq(pkg, x, sel)
        return picked, layers.sequence_pool(picked, "sum")

    def test_stream_eager_and_equal(self):
        pair = _Pair(self._build)
        pair.jm.expect_host_ops = pair.tm.expect_host_ops = True
        rng = np.random.RandomState(8)
        for _ in range(12):
            inner, outer = [0], [0]
            for _ in range(2):
                n_sub = rng.randint(2, 5)
                for _ in range(n_sub):
                    inner.append(inner[-1] + rng.randint(1, 4))
                outer.append(outer[-1] + n_sub)
            xv = rng.rand(inner[-1], 4).astype("f")
            sel = np.array([[rng.randint(0, outer[b + 1] - outer[b]), -1]
                            for b in range(2)], "int64")
            j, t, s = pair.run({"x": (xv, [outer, inner]), "sel": sel})
            rows = []
            for b in range(2):
                k = int(sel[b, 0]) + outer[b]
                rows.extend(range(inner[k], inner[k + 1]))
            for got in (t, s):
                np.testing.assert_allclose(got[0], xv[rows], rtol=TOL)
                np.testing.assert_allclose(got[1], j[1], rtol=TOL, atol=TOL)
        assert all(c.interpret for c in pair.texe._cache.values())

    def test_bucketed_lod_raises_the_recipe(self):
        main = pt.Program()
        with pt.program_guard(main, pt.Program()):
            x = pt.layers.data(name="x", shape=[-1, 4],
                               append_batch_size=False, lod_level=1)
            sel = pt.layers.data(name="sel", shape=[-1, 2], dtype="int64",
                                 append_batch_size=False)
            out = _sub_nested_seq(pt, x, sel)
        main.lod_buckets = True
        main.expect_host_ops = True
        with pytest.raises(NotImplementedError, match="bucketed dynamic"):
            pt.Executor(CPU).run(
                main, feed={"x": (np.ones((5, 4), "f"), [[0, 2, 5]]),
                            "sel": np.zeros((2, 2), "int64")},
                fetch_list=[out], scope=pt.Scope())


# ---------------------------------------------------------------------------
# test_lod_buckets.py:576-620 and the benchmarks' windows: run_steps
# ---------------------------------------------------------------------------

def _window_vs_runs(build, optimizer, windows, feed_of, seed=5):
    """Per-batch bucketed ``run``s of the JAX package and of the port,
    and ``run_steps`` windows of both, from one state: four equal loss
    sequences.  Returns the port's window losses."""
    got = {}
    for mode in ("runs", "window"):
        pair = _Pair(build, seed=seed, optimizer=optimizer)
        jl, tl = [], []
        for w in windows:
            if mode == "runs":
                for feed in w:
                    jl.append(float(np.asarray(pair.jexe.run(
                        pair.jm, feed=feed, fetch_list=[pair.jf[-1]],
                        scope=pair.jscope)[0]).reshape(())))
                    tl.append(float(pair.texe.run(
                        pair.tm, feed=feed, fetch_list=[pair.tf[-1]],
                        scope=pair.tscope)[0].reshape(())))
            else:
                feed = feed_of(w)
                jl += list(np.asarray(pair.jexe.run_steps(
                    pair.jm, feed=feed, fetch_list=[pair.jf[-1]],
                    steps=len(w), scope=pair.jscope)[0]).reshape(-1))
                tl += list(pair.texe.run_steps(
                    pair.tm, feed=feed, fetch_list=[pair.tf[-1]],
                    steps=len(w), scope=pair.tscope)[0].reshape(-1))
        np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL,
                                   err_msg=mode)
        got[mode] = tl
    np.testing.assert_allclose(got["window"], got["runs"], rtol=TOL,
                               atol=TOL)
    return got["window"]


class TestRunStepsRaggedWindow:
    def test_window_matches_per_batch_runs(self):
        rng = np.random.RandomState(4)
        batches = []
        for _ in range(4):
            lod = _rand_lod(rng, 4, 9)
            batches.append({"x": (rng.rand(lod[0][-1], 8).astype("f"),
                                  lod)})
        _window_vs_runs(_seq_model("lstm"),
                        lambda pkg: pkg.optimizer.SGD(0.05), [batches],
                        lambda w: {"x": [b["x"] for b in w]})

    def test_stacked_lstm_net_windows(self):
        """``bench_lstm.py``'s path at a small width: windows of fresh
        ``fake_batch``es, one ``run_steps`` each, dense labels stacked."""
        windows = [[JL.fake_batch(4, 10, 50, seed=10 * w + i)
                    for i in range(3)] for w in range(2)]

        def build(pkg):
            net = (JL if pkg is fluid else TL).stacked_lstm_net
            cost, _, _ = net(50, emb_dim=16, hidden_dim=16)
            return (cost,)

        losses = _window_vs_runs(
            build, lambda pkg: pkg.optimizer.Adam(1e-2), windows,
            lambda w: {"words": [b["words"] for b in w],
                       "label": np.stack([b["label"] for b in w])})
        assert np.isfinite(losses).all()

    def test_seq_to_seq_net_windows(self):
        """``bench_seq2seq.py``'s path at a small width: ragged windows
        of the three LoD feeds."""
        windows = [[JS.fake_batch(3, 6, 6, 20, 20, seed=10 * w + i)
                    for i in range(2)] for w in range(2)]

        def build(pkg):
            net = (JS if pkg is fluid else TS).seq_to_seq_net
            cost, _ = net(20, 20, 8, 8, 8)
            return (cost,)

        losses = _window_vs_runs(
            build, lambda pkg: pkg.optimizer.Adam(1e-2), windows,
            lambda w: {k: [b[k] for b in w]
                       for k in ("src_word", "trg_word", "label")})
        assert np.isfinite(losses).all()


# ---------------------------------------------------------------------------
# the capture rule under the switch
# ---------------------------------------------------------------------------

def _port_program(net):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        cost = net()
        pt.optimizer.Adam(1e-2).minimize(cost)
    main.lod_buckets = True
    return main, startup, cost


def test_capture_rule_bucketed_lstm_graphs_and_seq2seq_stays_eager():
    """Under the buckets both blocks may be captured: the LSTM's, and the
    seq2seq's, whose ``while`` is bounded by its step array (it reads
    nothing on the host); with a static LoD both stay eager."""
    lstm, _, _ = _port_program(
        lambda: TL.stacked_lstm_net(50, emb_dim=8, hidden_dim=8)[0])
    s2s, _, _ = _port_program(lambda: TS.seq_to_seq_net(20, 20, 8, 8, 8)[0])
    block = lstm.global_block()
    assert texecutor._host_ops(block, dyn=True) == []
    assert "lstm" in texecutor._host_ops(block)
    assert texecutor._host_ops(s2s.global_block(), dyn=True) == []
    static = texecutor._host_ops(s2s.global_block())
    assert "lstm" in static and "while" not in static


def test_second_bucketed_lstm_step_does_no_host_work(recorded):  # noqa: F811
    """Under the ``TorchDispatchMode`` audit of the capture rule: the
    second bucketed step of the LSTM (what a capture sees) reads nothing
    on the host and copies nothing to the device, and its entry is not
    kept eager."""
    main, startup, cost = _port_program(
        lambda: TL.stacked_lstm_net(50, emb_dim=8, hidden_dim=8)[0])
    exe, scope = pt.Executor(CPU), pt.Scope()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        exe.run(startup, scope=scope)
    feed = TL.fake_batch(4, 12, 50, seed=0)
    exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
    del recorded[:]
    with _Audit(recorded):
        exe.run(main, feed=TL.fake_batch(4, 12, 50, seed=1),
                fetch_list=[cost], scope=scope)
    assert not exe._last_compiled.interpret
    assert not recorded, sorted(set(recorded))


def test_bucketed_scope_meta_and_signature():
    """A bucketed feed: the scope holds the meta ("dyn", B, T_bucket),
    the signature holds the meta and the padded shapes (not the splits),
    so two batches of one bucket share one entry; a DynLoD read as a
    nested list raises the recipe."""
    main, startup, cost = _port_program(
        lambda: TL.stacked_lstm_net(50, emb_dim=8, hidden_dim=8)[0])
    exe, scope = pt.Executor(CPU), pt.Scope()
    exe.run(startup, scope=scope)
    misses0 = _misses()
    rng = np.random.RandomState(0)
    for lod in ([[0, 10, 20, 30, 40]], [[0, 9, 21, 30, 39]]):
        feed = {"words": (rng.randint(0, 50, (lod[0][-1], 1)), lod),
                "label": rng.randint(0, 2, (4, 1))}
        exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
        assert scope.find_lod("words") == ("dyn", 4, 16)
    assert _misses() - misses0 == 1
    (sig,) = [s for s in exe._cache if s[0] == id(main)]
    assert ("words", ("dyn", 4, 16)) in sig[7]
    assert ("words", "torch.int64", (64, 1)) in sig[6]
    assert ("words@lod0", "torch.int32", (5,)) in sig[6]
    d = DynLoD("words@lod0", 4, 16)
    assert d.key() == ("dyn", "words@lod0", 4, 16)
    with pytest.raises(NotImplementedError, match="bucketed dynamic"):
        len(d)
