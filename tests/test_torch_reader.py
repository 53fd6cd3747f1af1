"""The port's input pipeline against the JAX package's: recordio, the
reader creators and decorators, the reader ops through the executor,
``DataFeeder`` and the reader layers.

Everything but the last test is host code, compared exactly: recordio
files byte for byte (same records, codec and compressor), batches
element for element and in order (shuffles draw from ``numpy.random``
or ``random`` seeded alike in both packages), feed dicts and program
dicts equal.  ``open_files`` with two threads interleaves its files
nondeterministically in both packages: its batches are compared as a
multiset.  The last test trains bench.py's smoke Transformer (d_model 64,
2 layers, vocab 1000, B 4, S 32) four steps reader-fed in both
packages, from one transplanted scope at dropout 0, float32: losses
within ``1e-5`` (``tests/test_torch_train.py``'s float32 tolerance)."""

import os
import pickle
import random
import threading
import time

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import data_feeder as jax_feeder
from paddle_tpu import native as jax_native
from paddle_tpu import recordio_writer as jax_rio
from paddle_tpu.framework import unique_name_scope as jax_names
from paddle_tpu.models import transformer as JT
from paddle_tpu.reader import creator as jax_creator
from paddle_tpu.reader import decorator as jax_dec
from paddle_tpu_torch import data_feeder as torch_feeder
from paddle_tpu_torch import native as torch_native
from paddle_tpu_torch import recordio_writer as torch_rio
from paddle_tpu_torch.framework import unique_name_scope as torch_names
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.reader import creator as torch_creator
from paddle_tpu_torch.reader import decorator as torch_dec

F32_TOL = 1e-5
PKGS = {"jax": (fluid, jax_native, jax_rio), "torch": (pt, torch_native,
                                                       torch_rio)}


def _records(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.bytes(int(n)) for n in (0, 1, 10, 1000, 65536, 7)] + \
        [b"abc" * 100]


@pytest.fixture
def force_codec(monkeypatch):
    """``force_codec(name, native_module)``: make that package's recordio
    run the named codec."""

    def force(name, native):
        if name == "python":
            monkeypatch.setattr(native, "_lib", None)
            monkeypatch.setattr(native, "_build_error",
                                RuntimeError("forced"))
        else:
            monkeypatch.setattr(native, "_build_error", None)
            assert native.load() is not None
    return force


def _write(rio, path, records, compressor, max_num_records=3):
    with rio.RecordIOWriter(path, compressor=compressor,
                            max_num_records=max_num_records) as w:
        for r in records:
            w.write(r)
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# recordio
# ---------------------------------------------------------------------------

def test_native_codec_builds_and_is_reported(force_codec):
    assert torch_native.codec() == "native"
    force_codec("python", torch_native)
    assert torch_native.codec() == "python"


@pytest.mark.parametrize("compressor", [0, 1])
@pytest.mark.parametrize("codec", ["native", "python"])
def test_recordio_bytes_match_reference(tmp_path, force_codec, codec,
                                        compressor):
    records = _records()
    force_codec(codec, jax_native)
    force_codec(codec, torch_native)
    want = _write(jax_rio, str(tmp_path / "ref.rio"), records, compressor)
    got = _write(torch_rio, str(tmp_path / "port.rio"), records, compressor)
    assert got == want
    # each package reads the other's file, with the other codec too
    other = "python" if codec == "native" else "native"
    force_codec(other, jax_native)
    force_codec(other, torch_native)
    assert list(jax_rio.RecordIOScanner(str(tmp_path / "port.rio"))) == \
        records
    assert list(torch_rio.RecordIOScanner(str(tmp_path / "ref.rio"))) == \
        records


def test_codecs_write_the_same_bytes(tmp_path, force_codec):
    records = _records(1)
    force_codec("native", torch_native)
    native = _write(torch_rio, str(tmp_path / "n.rio"), records, 1)
    force_codec("python", torch_native)
    python = _write(torch_rio, str(tmp_path / "p.rio"), records, 1)
    assert native == python


def test_corrupt_chunk_raises(tmp_path):
    p = str(tmp_path / "c.rio")
    raw = bytearray(_write(torch_rio, p, _records(), 1))
    raw[30] ^= 0xFF
    with open(p, "wb") as f:
        f.write(bytes(raw))
    with pytest.raises(IOError):
        list(torch_rio.RecordIOScanner(p))


def test_threaded_loader_reads_every_record(tmp_path):
    paths, want = [], set()
    for i in range(4):
        p = str(tmp_path / f"f{i}.rio")
        recs = [f"file{i}-rec{j}".encode() for j in range(100)]
        _write(torch_rio, p, recs, 1, max_num_records=10)
        want.update(recs)
        paths.append(p)
    loader = torch_rio.RecordIOLoader(paths, n_threads=3, capacity=16)
    got = list(loader)
    loader.close()
    assert len(got) == 400 and set(got) == want


def test_convert_reader_bytes_match_reference(tmp_path):
    rng = np.random.RandomState(0)
    samples = [(rng.rand(4).astype("float32"), np.int64(i))
               for i in range(25)]
    n = {}
    for name, (_, _, rio) in PKGS.items():
        n[name] = rio.convert_reader_to_recordio_file(
            str(tmp_path / f"{name}.rio"), lambda: iter(samples),
            max_num_records=7)
    assert n == {"jax": 25, "torch": 25}
    with open(tmp_path / "jax.rio", "rb") as a, \
            open(tmp_path / "torch.rio", "rb") as b:
        assert a.read() == b.read()
    back = [pickle.loads(r) for r in
            torch_rio.RecordIOScanner(str(tmp_path / "jax.rio"))]
    for (a, i), (b, j) in zip(samples, back):
        np.testing.assert_array_equal(a, b)
        assert i == j


# ---------------------------------------------------------------------------
# creators and decorators: each case through both packages
# ---------------------------------------------------------------------------

def r10():
    return lambda: iter(range(10))


def _seeded(fn):
    random.seed(5)
    return list(fn())


DECORATOR_CASES = {
    "map_readers": lambda d: list(d.map_readers(lambda a, b: a + b, r10(),
                                                r10())()),
    "shuffle": lambda d: _seeded(d.shuffle(r10(), 4)),
    "chain": lambda d: list(d.chain(r10(), r10())()),
    "compose_aligned": lambda d: list(d.compose(r10(), r10())()),
    "compose_unchecked": lambda d: list(d.compose(
        r10(), lambda: iter(range(5)), check_alignment=False)()),
    "firstn": lambda d: list(d.firstn(r10(), 3)()),
    "buffered": lambda d: list(d.buffered(r10(), 3)()),
    "xmap_unordered": lambda d: sorted(d.xmap_readers(
        lambda x: x * 2, r10(), 3, 4)()),
    "xmap_ordered": lambda d: list(d.xmap_readers(
        lambda x: x * 2, r10(), 3, 4, order=True)()),
    "xmap_ordered_long": lambda d: list(d.xmap_readers(
        lambda x: x * 2, lambda: iter(range(500)), 4, 4, order=True)()),
    "xmap_ordered_numpy": lambda d: [a.tolist() for a in d.xmap_readers(
        lambda x: x + 1, lambda: (np.full((3,), i) for i in range(20)),
        4, 2, order=True)()],
}


@pytest.mark.parametrize("case", sorted(DECORATOR_CASES))
def test_decorators_match_reference(case):
    assert DECORATOR_CASES[case](torch_dec) == \
        DECORATOR_CASES[case](jax_dec)


def test_compose_misaligned_raises():
    with pytest.raises(torch_dec.ComposeNotAligned):
        list(torch_dec.compose(r10(), lambda: iter(range(5)))())


def test_cache_replays_only_a_full_pass():
    calls = [0]

    def counting():
        calls[0] += 1
        return iter(range(5))

    c = torch_dec.cache(counting)
    next(c())                  # abandoned midway: not cached
    assert list(c()) == list(range(5)) and calls[0] == 2
    assert list(c()) == list(range(5)) and calls[0] == 2


def _wait_threads(baseline, timeout=5.0):
    deadline = time.time() + timeout
    while threading.active_count() > baseline and time.time() < deadline:
        time.sleep(0.01)
    return threading.active_count()


def test_abandoned_threaded_readers_release_their_threads():
    baseline = threading.active_count()

    def endless():
        i = 0
        while True:
            yield i
            i += 1

    it = torch_dec.buffered(endless, 2)()
    assert next(it) == 0
    it.close()
    for order in (False, True):
        it = torch_dec.xmap_readers(lambda x: x * 2, endless, 3, 2,
                                    order=order)()
        assert next(it) is not None
        it.close()
    assert _wait_threads(baseline) <= baseline


@pytest.mark.parametrize("which", ["buffered", "xmap", "xmap_ordered"])
def test_threaded_readers_reraise(which):
    def bad():
        yield 1
        raise IOError("truncated stream")

    def mapper(x):
        if x == 3:
            raise ValueError("boom")
        return x

    if which == "buffered":
        it, exc = torch_dec.buffered(bad, 4)(), IOError
    else:
        it, exc = torch_dec.xmap_readers(
            mapper, lambda: iter(range(10)), 2, 2,
            order=which == "xmap_ordered")(), ValueError
    with pytest.raises(exc):
        list(it)


def test_creators_match_reference(tmp_path):
    x = np.arange(12).reshape(4, 3)
    assert [a.tolist() for a in torch_creator.np_array(x)()] == \
        [a.tolist() for a in jax_creator.np_array(x)()]
    p = tmp_path / "lines.txt"
    p.write_text("a\nbb\n\nccc\n")
    assert list(torch_creator.text_file(str(p))()) == \
        list(jax_creator.text_file(str(p))())
    paths = []
    for i in range(2):
        q = str(tmp_path / f"s{i}.rio")
        jax_rio.convert_reader_to_recordio_file(
            q, lambda: iter([(np.float32(i), j) for j in range(3)]))
        paths.append(q)
    assert list(torch_creator.recordio(",".join(paths))()) == \
        list(jax_creator.recordio(paths)())
    # cloud_reader over the port's master: every record of every leased
    # file, each task finished; the JAX package's reader over the same
    # master (its client speaks the same wire format) reads the same
    from paddle_tpu_torch.parallel.master import (MasterServer,
                                                  MasterService,
                                                  partition_files)
    want = sorted(jax_creator.recordio(paths)())
    for creator in (torch_creator, jax_creator):
        svc = MasterService(partition_files(paths), timeout=30.0)
        server = MasterServer(svc, port=0)
        server.start_background()
        try:
            addr = f"{server.addr[0]}:{server.addr[1]}"
            assert sorted(creator.cloud_reader(addr)()) == want
            assert svc.stats()["done"] == len(paths)
        finally:
            server.shutdown()


# ---------------------------------------------------------------------------
# reader ops through the executor
# ---------------------------------------------------------------------------

def _samples(path, n=64, dim=8, seed=0):
    rng = np.random.RandomState(seed)
    xs = rng.rand(n, dim).astype("float32")
    ys = (xs.sum(1, keepdims=True) + 0.1).astype("float32")
    jax_rio.convert_reader_to_recordio_file(
        str(path), lambda: ((xs[i], ys[i]) for i in range(n)))
    return xs, ys


def _reader_program(pkg, names, build):
    main, startup = pkg.Program(), pkg.Program()
    with names("rd_"), pkg.program_guard(main, startup):
        outs = build(pkg.layers)
    return main, startup, outs


def _executor(pkg):
    return pkg.Executor(pkg.CPUPlace())


def _pull(pkg, names, build, steps):
    """``steps`` runs of the program ``build`` makes, fetching its read
    outputs: a list of per-run fetched arrays (stopping at EOF)."""
    main, startup, outs = _reader_program(pkg, names, build)
    exe, scope = _executor(pkg), pkg.Scope()
    exe.run(startup, scope=scope)
    got = []
    for _ in range(steps):
        try:
            got.append([np.asarray(v) for v in exe.run(
                main, fetch_list=list(outs), scope=scope)])
        except pkg.EOFException:
            break
    return got


def _both(build, steps):
    return (_pull(fluid, jax_names, build, steps),
            _pull(pt, torch_names, build, steps))


def _assert_same_batches(want, got):
    assert len(got) == len(want)
    for w, g in zip(want, got):
        for a, b in zip(w, g):
            np.testing.assert_array_equal(b, a)


def test_shuffled_batched_multi_pass_chain_matches_reference(tmp_path):
    p = tmp_path / "d.rio"
    _samples(p, n=40)

    def build(layers):
        r = layers.open_recordio_file(
            filename=str(p), shapes=[(8,), (1,)], lod_levels=[0, 0],
            dtypes=["float32", "float32"])
        r = layers.batch(r, batch_size=6)
        r = layers.shuffle(r, buffer_size=4, seed=11)
        r = layers.multi_pass(r, pass_num=3)
        return layers.read_file(r)

    want, got = _both(build, 30)
    assert len(want) == 18           # 6 full batches a pass, tail dropped
    _assert_same_batches(want, got)


def test_shuffle_of_samples_then_double_buffer_matches_reference(tmp_path):
    p = tmp_path / "d.rio"
    _samples(p, n=48)

    def build(layers):
        r = layers.open_recordio_file(
            filename=str(p), shapes=[(8,), (1,)], lod_levels=[0, 0],
            dtypes=["float32", "float32"], pass_num=2)
        r = layers.shuffle(r, buffer_size=16, seed=3)
        r = layers.batch(r, batch_size=8)
        r = layers.double_buffer(r, capacity=3)
        return layers.read_file(r)

    want, got = _both(build, 20)
    assert len(want) == 12
    _assert_same_batches(want, got)


def test_random_data_generator_matches_reference():
    def build(layers):
        r = layers.random_data_generator(low=-1.0, high=2.0,
                                         shapes=[(4, 3), (2,)],
                                         lod_levels=[0, 0], seed=7)
        return layers.read_file(r)

    want, got = _both(build, 3)
    _assert_same_batches(want, got)
    assert not np.array_equal(got[0][0], got[1][0])


@pytest.mark.parametrize("threads", [1, 2])
def test_open_files_matches_reference(tmp_path, threads):
    paths = []
    for i in range(3):
        p = tmp_path / f"f{i}.rio"
        _samples(p, n=16, seed=i)
        paths.append(str(p))

    def build(layers):
        r = layers.open_files(filenames=paths, shapes=[(8,), (1,)],
                              lod_levels=[0, 0],
                              dtypes=["float32", "float32"],
                              thread_num=threads)
        r = layers.batch(r, batch_size=8)
        return layers.read_file(r)

    want, got = _both(build, 10)
    assert len(want) == len(got) == 6
    if threads == 1:                 # one reader thread: file order
        _assert_same_batches(want, got)
    else:                            # interleaved: the same rows
        def rows(batches):
            return sorted(map(tuple, np.concatenate(
                [b[0] for b in batches]).tolist()))
        assert rows(got) == rows(want)


def _regression(layers, path, pass_num=1, batch_size=16, double=False):
    r = layers.open_recordio_file(
        filename=str(path), shapes=[(8,), (1,)], lod_levels=[0, 0],
        dtypes=["float32", "float32"], pass_num=pass_num)
    r = layers.batch(r, batch_size=batch_size)
    if double:
        r = layers.double_buffer(r)
    x, y = layers.read_file(r)
    pred = layers.fc(input=x, size=1, param_attr="rd_w", bias_attr="rd_b")
    loss = layers.mean(layers.square_error_cost(input=pred, label=y))
    return r, x, loss


def test_eof_and_reset_rewind(tmp_path):
    p = tmp_path / "d.rio"
    xs, _ = _samples(p)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        r, x, _ = _regression(pt.layers, p, double=True)
    exe, scope = _executor(pt), pt.Scope()
    exe.run(startup, scope=scope)
    for i in range(4):
        (xv,) = exe.run(main, fetch_list=[x], scope=scope)
        np.testing.assert_array_equal(xv, xs[i * 16:(i + 1) * 16])
    with pytest.raises(pt.EOFException):
        exe.run(main, fetch_list=[x], scope=scope)
    r.reset()
    (xv,) = exe.run(main, fetch_list=[x], scope=scope)
    np.testing.assert_array_equal(xv, xs[:16])
    # the reader variables are persistable but hold no tensor: saving
    # the program's persistables skips them
    with pt.scope_guard(scope):
        pt.io.save_persistables(exe, str(tmp_path / "vars"), main)
    assert sorted(os.listdir(tmp_path / "vars")) == ["rd_b", "rd_w"]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_run_steps_mid_window_eof_ungets_in_order(tmp_path, pkg):
    """A window that hits EOF part-way returns its batches to the reader:
    the next ``run`` serves them in order (the JAX package's
    ``executor.py:75-95``), and ``reset`` rewinds behind them."""
    p = tmp_path / "d.rio"
    xs, _ = _samples(p)
    mod = PKGS[pkg][0]
    main, startup = mod.Program(), mod.Program()
    with mod.program_guard(main, startup):
        r, x, loss = _regression(mod.layers, p)
        mod.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe, scope = _executor(mod), mod.Scope()
    exe.run(startup, scope=scope)
    out = exe.run_steps(main, fetch_list=[loss], steps=3, scope=scope)
    assert np.asarray(out[0]).shape[0] == 3
    with pytest.raises(mod.EOFException):
        exe.run_steps(main, fetch_list=[loss], steps=3, scope=scope)
    (xv,) = exe.run(main, fetch_list=[x], scope=scope)
    np.testing.assert_array_equal(np.asarray(xv), xs[48:64])
    r.reset()
    (xv,) = exe.run(main, fetch_list=[x], scope=scope)
    np.testing.assert_array_equal(np.asarray(xv), xs[:16])


def test_run_steps_reader_window_matches_reference_and_caches(tmp_path):
    """Two reader-fed windows of like batches: the JAX package's losses
    (float32 within 1e-5), one step-cache entry for both windows."""
    from paddle_tpu_torch import profiler
    p = tmp_path / "d.rio"
    _samples(p, n=128)
    losses = {}
    for name, (mod, _, _) in PKGS.items():
        names = jax_names if name == "jax" else torch_names
        main, startup = mod.Program(), mod.Program()
        main.random_seed = startup.random_seed = 5
        with names("rs_"), mod.program_guard(main, startup):
            _, _, loss = _regression(mod.layers, p, pass_num=50,
                                     batch_size=32, double=True)
            mod.optimizer.SGD(learning_rate=0.1).minimize(loss)
        exe, scope = _executor(mod), mod.Scope()
        exe.run(startup, scope=scope)
        if name == "torch":
            scope.set_var("rd_w", pt_w)
            scope.set_var("rd_b", pt_b)
            misses = profiler.runtime_metrics.counter("jit_cache.misses")
        else:
            import torch
            pt_w = torch.from_numpy(np.array(scope.find_var("rd_w")))
            pt_b = torch.from_numpy(np.array(scope.find_var("rd_b")))
        windows = [np.asarray(exe.run_steps(
            main, fetch_list=[loss], steps=8, scope=scope)[0]).reshape(-1)
            for _ in range(2)]
        losses[name] = np.concatenate(windows)
        if name == "torch":
            assert profiler.runtime_metrics.counter(
                "jit_cache.misses") - misses == 1
    np.testing.assert_allclose(losses["torch"], losses["jax"],
                               rtol=F32_TOL, atol=F32_TOL)
    assert losses["torch"][-1] < losses["torch"][0]


def test_reader_pre_pass_walks_a_block_once_a_version(tmp_path):
    """The executor finds a block's reader ops once a program version:
    a block without any gives none, and an edit of the block is seen."""
    from paddle_tpu_torch.executor import _reader_ops
    from paddle_tpu_torch.ops.reader_ops import READER_OPS
    p = tmp_path / "d.rio"
    _samples(p)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        _regression(pt.layers, p)
    block = main.global_block()
    got = _reader_ops(block)
    assert list(got) == [op for op in block.ops if op.type in READER_OPS]
    assert "read" in [op.type for op in got]
    assert _reader_ops(block) is got
    block.remove_op([op.type for op in block.ops].index("read"))
    assert "read" not in [op.type for op in _reader_ops(block)]
    plain = pt.Program()
    with pt.program_guard(plain, pt.Program()):
        x = pt.layers.data(name="x", shape=[4])
        pt.layers.scale(x, 2.0)
    assert _reader_ops(plain.global_block()) == ()


def test_double_buffer_on_the_cpu_is_a_plain_prefetch(tmp_path):
    from paddle_tpu_torch.ops import reader_ops
    p = tmp_path / "d.rio"
    xs, ys = _samples(p, n=8)
    base = reader_ops.RecordIOReader(str(p), [(8,), (1,)],
                                     ["float32", "float32"])
    db = reader_ops.DoubleBufferReader(base, device=None, capacity=2)
    got = [db.next() for _ in range(8)]
    assert all(isinstance(a, np.ndarray) for b in got for a in b)
    np.testing.assert_array_equal(np.stack([b[0] for b in got]), xs)
    with pytest.raises(StopIteration):
        db.next()
    with pytest.raises(StopIteration):    # sticky EOF
        db.next()
    db.reset()
    np.testing.assert_array_equal(db.next()[1], ys[0])


def test_read_without_startup_state_raises():
    main = pt.Program()
    with pt.program_guard(main, pt.Program()):
        r = pt.layers.random_data_generator(0.0, 1.0, shapes=[(2,)],
                                            lod_levels=[0])
        pt.layers.read_file(r)
    block = main.global_block()
    # a read whose reader creation op is gone
    block.ops = [op for op in block.ops if op.type == "read"]
    with pytest.raises(RuntimeError, match="not created"):
        _executor(pt).run(main, scope=pt.Scope())


# ---------------------------------------------------------------------------
# DataFeeder
# ---------------------------------------------------------------------------

def _feeder(pkg, names):
    main = pkg.Program()
    with names("df_"), pkg.program_guard(main, pkg.Program()):
        img = pkg.layers.data("img", shape=[2, 3], dtype="float32")
        lbl = pkg.layers.data("lbl", shape=[1], dtype="int64")
        words = pkg.layers.data("words", shape=[1], dtype="int64",
                                lod_level=1)
        nested = pkg.layers.data("nested", shape=[2], dtype="float32",
                                 lod_level=2)
    return pkg.DataFeeder([img, lbl, "words", nested], pkg.CPUPlace(),
                          program=main)


def _feed_batch(seed):
    rng = np.random.RandomState(seed)
    return [(rng.rand(6).astype("float32").tolist(), [int(i)],
             rng.randint(0, 9, size=int(n)).tolist(),
             [rng.rand(int(m), 2).tolist() for m in (1, n)])
            for i, n in enumerate((3, 1, 4))]


def test_data_feeder_matches_reference():
    jf, tf = _feeder(fluid, jax_names), _feeder(pt, torch_names)
    for seed in (0, 1):                   # converters reused across calls
        batch = _feed_batch(seed)
        want, got = jf.feed(batch), tf.feed(batch)
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            g = got[name]
            if isinstance(w, tuple):
                # the JAX package's lengths, as the offsets its executor
                # (and the port's) reads a LoD as
                assert isinstance(g, tuple), name
                assert g[1] == [np.concatenate([[0], np.cumsum(level)])
                                .tolist() for level in w[1]], name
                w, g = w[0], g[0]
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_array_equal(g, w)


def test_data_feeder_feed_runs_through_the_executor():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", shape=[3], dtype="float32")
        words = pt.layers.data("w", shape=[1], dtype="int64", lod_level=1)
        s = pt.layers.reduce_sum(x)
    feeder = pt.DataFeeder([x, words], pt.CPUPlace(), program=main)
    feed = feeder.feed([([1.0, 2.0, 3.0], [4, 5]), ([1.0, 1.0, 1.0], [6])])
    (got,) = _executor(pt).run(main, feed=feed, fetch_list=[s],
                               scope=pt.Scope())
    assert float(np.asarray(got).reshape(())) == 9.0


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_data_feeder_refuses_bad_feeds(pkg):
    mod = PKGS[pkg][0]
    feeder_mod = jax_feeder if pkg == "jax" else torch_feeder
    main = mod.Program()
    with mod.program_guard(main, mod.Program()):
        a = mod.layers.data("a", shape=[2, 2], dtype="float32")
        lbl = mod.layers.data("lbl", shape=[1], dtype="int64")
    feeder = mod.DataFeeder([a, lbl], mod.CPUPlace(), program=main)
    with pytest.raises(feeder_mod.FeedShapeError, match="'a'"):
        feeder.feed([([1.0, 2.0, 3.0], [1])])
    with pytest.raises(feeder_mod.FeedShapeError, match="truncat"):
        feeder.feed([([1.0] * 4, [0.5])])


# ---------------------------------------------------------------------------
# the reader layers build the JAX package's programs
# ---------------------------------------------------------------------------

def _strip(d):
    for block in d["blocks"]:
        for op in block["ops"]:
            op.pop("creation_site", None)
    return d


def _all_reader_layers(layers):
    shapes = [(4, 8), (4, 1)]
    kw = dict(shapes=shapes, lod_levels=[0, 0],
              dtypes=["float32", "int64"])
    a = layers.open_recordio_file("a.rio", pass_num=2, for_parallel=True,
                                  **kw)
    b = layers.open_files(["b.rio", "c.rio"], thread_num=3, pass_num=2,
                          **kw)
    c = layers.random_data_generator(0.0, 1.0, shapes=shapes,
                                     lod_levels=[0, 0], seed=3)
    outs = []
    for r in (a, b, c):
        r = layers.shuffle(r, buffer_size=8, seed=2)
        r = layers.batch(r, batch_size=2)
        r = layers.double_buffer(r, capacity=5)
        outs += list(layers.read_file(r))
    return outs


def test_reader_layers_build_the_reference_programs():
    jm, js, jo = _reader_program(fluid, jax_names, _all_reader_layers)
    tm, ts, to = _reader_program(pt, torch_names, _all_reader_layers)
    assert [v.name for v in to] == [v.name for v in jo]
    assert [tuple(v.shape) for v in to] == [tuple(v.shape) for v in jo]
    assert _strip(tm.to_dict()) == _strip(jm.to_dict())
    assert _strip(ts.to_dict()) == _strip(js.to_dict())
    types = [op.type for op in tm.global_block().ops]
    assert types.count("read") == 3 and len(set(types)) == 9


def test_registry_has_the_reader_and_io_ops():
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.ops.reader_ops import READER_OPS
    ops = set(registry.all_ops())
    assert len(READER_OPS) == 9 and READER_OPS <= ops
    assert {"feed", "fetch", "assign_from_scope", "save", "load"} <= ops


# ---------------------------------------------------------------------------
# the smoke Transformer, reader-fed in both packages
# ---------------------------------------------------------------------------

SMOKE_B, SMOKE_S, SMOKE_STEPS = 4, 32, 4
SMOKE_KEYS = ["src_word", "trg_word", "src_mask", "lbl_word", "lbl_weight"]


def _smoke_hp(mod):
    hp = mod.ModelHyperParams()
    hp.d_model, hp.d_inner_hid, hp.n_layer = 64, 128, 2
    hp.n_head, hp.d_key, hp.d_value = 4, 16, 16
    hp.src_vocab_size = hp.trg_vocab_size = 1000
    hp.dropout = 0.0
    return hp


def _smoke_program(mod, names, path):
    main, startup = mod.Program(), mod.Program()
    with names("sm_"), mod.program_guard(main, startup):
        reader = mod.layers.open_recordio_file(
            filename=path, shapes=[(SMOKE_B, SMOKE_S)] * 5,
            lod_levels=[0] * 5,
            dtypes=["int32", "int32", "float32", "int32", "float32"],
            pass_num=10 ** 6)
        reader = mod.layers.double_buffer(reader, capacity=SMOKE_STEPS + 2)
        inputs = mod.layers.read_file(reader)
        hp = _smoke_hp(JT if mod is fluid else TT)
        cost, _ = (JT if mod is fluid else TT).transformer(
            SMOKE_B, SMOKE_S, SMOKE_S, hp, input_vars=inputs)
        mod.optimizer.Adam(learning_rate=1e-3).minimize(cost)
    return main, startup, cost


def test_smoke_transformer_trains_reader_fed_like_reference(tmp_path):
    path = str(tmp_path / "bench.rio")
    hp = _smoke_hp(JT)
    batches = [JT.fake_batch(SMOKE_B, SMOKE_S, SMOKE_S, hp, seed=s)
               for s in range(SMOKE_STEPS)]
    torch_rio.convert_reader_to_recordio_file(
        path, lambda: (tuple(b[k] for k in SMOKE_KEYS) for b in batches),
        compressor=0)
    jm, js, jc = _smoke_program(fluid, jax_names, path)
    tm, _, tc = _smoke_program(pt, torch_names, path)
    jexe, jscope = _executor(fluid), fluid.Scope()
    jexe.run(js, scope=jscope)
    import torch
    tscope = pt.Scope()
    for n in pt.convert.persistable_names(tm):
        v = jscope.find_var(n)
        if hasattr(v, "dtype"):          # readers are built by the run
            tscope.set_var(n, torch.from_numpy(np.array(v)))
    want = np.asarray(jexe.run_steps(jm, fetch_list=[jc],
                                     steps=SMOKE_STEPS,
                                     scope=jscope)[0]).reshape(-1)
    got = np.asarray(_executor(pt).run_steps(
        tm, fetch_list=[tc], steps=SMOKE_STEPS,
        scope=tscope)[0]).reshape(-1)
    assert np.all(np.isfinite(got)) and got[-1] < got[0], got
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
