"""The port's C inference ABI (``paddle_tpu_torch/native/capi.cpp``),
built with ``g++`` and called through ``ctypes`` on the CPU.  A bundle
exported by the JAX package (two fetch targets) runs through the ABI on
``pd_tpu_create_on(dir, "cpu")``: one result a fetch, equal to the
port's ``Executor.run`` and to the JAX package's of the same bundle;
errors come back through ``pd_tpu_last_error``; ``pd_tpu_create`` (no
place: ``cuda:0``) fails where CUDA is absent.  The JAX package's ABI
(the same symbol names, loaded ``RTLD_GLOBAL``) works beside it in the
same process."""

import ctypes

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu_torch import native


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """An fc net's inference bundle from the JAX package: feed ``x``
    [4, 6], fetches the softmax and the hidden layer."""
    d = str(tmp_path_factory.mktemp("capi_bundle"))
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[6], dtype="float32")
        hidden = fluid.layers.fc(input=x, size=5, act="tanh")
        prob = fluid.layers.fc(input=hidden, size=3, act="softmax")
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(d, ["x"], [prob, hidden], exe,
                                      main_program=main)
    feed = np.random.RandomState(0).randn(4, 6).astype(np.float32)
    return d, feed


@pytest.fixture(scope="module")
def lib():
    lib = native.load_capi()
    assert lib.pd_tpu_init() == 0, lib.pd_tpu_last_error()
    return lib


def _run(lib, handle, feed):
    """``pd_tpu_run`` of one float32 feed ``x``: the results as arrays."""
    data = np.ascontiguousarray(feed)
    names = (ctypes.c_char_p * 1)(b"x")
    bufs = (ctypes.c_void_p * 1)(data.ctypes.data_as(ctypes.c_void_p))
    lens = (ctypes.c_longlong * 1)(data.nbytes)
    shape = (ctypes.c_longlong * data.ndim)(*data.shape)
    shapes = (ctypes.POINTER(ctypes.c_longlong) * 1)(shape)
    ranks = (ctypes.c_int * 1)(data.ndim)
    dtypes = (ctypes.c_char_p * 1)(str(data.dtype).encode())
    res = lib.pd_tpu_run(handle, 1, names, bufs, lens, shapes, ranks, dtypes)
    if not res:
        return None
    try:
        out = []
        for i in range(lib.pd_tpu_result_count(res)):
            dims = tuple(lib.pd_tpu_result_dim(res, i, d)
                         for d in range(lib.pd_tpu_result_rank(res, i)))
            blen = ctypes.c_longlong()
            ptr = lib.pd_tpu_result_data(res, i, ctypes.byref(blen))
            raw = ctypes.string_at(ptr, blen.value)
            out.append(np.frombuffer(
                raw, lib.pd_tpu_result_dtype(res, i).decode()).reshape(dims))
        return out
    finally:
        lib.pd_tpu_free_result(res)


def test_abi_matches_both_executors(lib, bundle):
    d, feed = bundle
    h = lib.pd_tpu_create_on(d.encode(), b"cpu")
    assert h, lib.pd_tpu_last_error()
    try:
        assert lib.pd_tpu_num_feeds(h) == 1
        assert lib.pd_tpu_feed_name(h, 0) == b"x"
        assert lib.pd_tpu_feed_name(h, 1) is None
        got = _run(lib, h, feed)
    finally:
        lib.pd_tpu_destroy(h)
    assert len(got) == 2 and got[0].shape == (4, 3) and \
        got[1].shape == (4, 5)
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        prog, feeds, fetches = pt.io.load_inference_model(d, exe)
        want = exe.run(prog, feed={"x": feed}, fetch_list=fetches)
    jexe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        jprog, _, jfetches = fluid.io.load_inference_model(d, jexe)
        ref = jexe.run(jprog, feed={"x": feed}, fetch_list=jfetches)
    for g, w, r in zip(got, want, ref):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-6, atol=1e-7)


def test_errors_come_back_through_last_error(lib, bundle, tmp_path):
    assert not lib.pd_tpu_create_on(str(tmp_path / "none").encode(), b"cpu")
    assert lib.pd_tpu_last_error()
    assert not lib.pd_tpu_create_on(bundle[0].encode(), b"tpu")
    assert b"--place" in lib.pd_tpu_last_error()
    h = lib.pd_tpu_create_on(bundle[0].encode(), b"cpu")
    assert h, lib.pd_tpu_last_error()
    try:
        assert _run(lib, h, np.zeros((4, 7), np.float32)) is None
        assert lib.pd_tpu_last_error()
    finally:
        lib.pd_tpu_destroy(h)


def test_no_place_means_the_card(lib, bundle):
    """``pd_tpu_create`` without a place runs on ``cuda:0``: where CUDA
    is absent it fails, naming the cause."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: pd_tpu_create succeeds there")
    assert not lib.pd_tpu_create(bundle[0].encode())
    assert b"CUDA" in lib.pd_tpu_last_error()


def test_beside_the_reference_library(lib, bundle, tmp_path, monkeypatch):
    """The JAX package's ABI, loaded RTLD_GLOBAL with the same names,
    and the port's answer each from their own package: the reference's
    ``pd_tpu_create`` runs on the JAX CPU, the port's needs a place.
    (The reference's library is built into this test's own directory,
    so that no other test's build of it races this one.)"""
    from paddle_tpu import native as jax_native
    monkeypatch.setattr(jax_native, "_CAPI_LIB",
                        str(tmp_path / "libpaddletpu_capi.so"))
    monkeypatch.setattr(jax_native, "_capi_lib", None)
    monkeypatch.setattr(jax_native, "_capi_error", None)
    ref = jax_native.load_capi()
    assert ref is not None and not hasattr(ref, "pd_tpu_create_on")
    d, feed = bundle
    assert ref.pd_tpu_init() == 0
    h = ref.pd_tpu_create(d.encode())
    assert h, ref.pd_tpu_last_error()
    try:
        want = [np.asarray(v) for v in _run(ref, h, feed)]
    finally:
        ref.pd_tpu_destroy(h)
    h = lib.pd_tpu_create_on(d.encode(), b"cpu")
    try:
        got = _run(lib, h, feed)
    finally:
        lib.pd_tpu_destroy(h)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
    if not torch.cuda.is_available():
        assert not lib.pd_tpu_create(d.encode())
