"""The PyTorch port's generation runtime against the JAX package's, on
the CPU: the same bundle (exported by either package) gives the same
prefill logits and K/V, the same decode logits step after step, and the
same greedy tokens through the continuous-batching scheduler.

Tolerance: float32 ``atol = rtol = 1e-5`` (torch and XLA sum in
different orders); greedy tokens are compared exactly."""

import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.gen import GenPredictor as JaxPredictor
from paddle_tpu.gen import GenScheduler as JaxScheduler
from paddle_tpu.models import gen_lm as jax_gen_lm
from paddle_tpu_torch import CPUPlace
from paddle_tpu_torch.convert import scope_from_numpy, to_numpy
from paddle_tpu_torch.gen import GenPredictor, GenScheduler
from paddle_tpu_torch.models import gen_lm as torch_gen_lm

TOL = 1e-5
NUM_SLOTS = 4
# page_len 16: lengths that end a page, cross into the next, and span
# several pages once decoding starts
PROMPTS_LENS = (15, 16, 17, 33)


@pytest.fixture(scope="module")
def jax_bundle(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_gen") / "jax_bundle")
    jax_gen_lm.export_gen_model(d, jax_gen_lm.GenConfig(),
                                num_slots=NUM_SLOTS)
    return d


@pytest.fixture(scope="module")
def torch_bundle(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_gen") / "torch_bundle")
    torch_gen_lm.export_gen_model(d, torch_gen_lm.GenConfig(),
                                  num_slots=NUM_SLOTS, place=CPUPlace(),
                                  seed=3)
    return d


@pytest.fixture(scope="module")
def pair(jax_bundle):
    return JaxPredictor(jax_bundle), GenPredictor(jax_bundle,
                                                  place=CPUPlace())


def _prompts(seed=0, lens=PROMPTS_LENS):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(0, 64, n)] for n in lens]


def _close(got, want, what):
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL, err_msg=what)


def test_prefill_logits_and_kv_match(pair):
    jp, tp = pair
    for prompt in _prompts(1, (1, 7, 16, 17, 40)):
        jl, jkv = jp.prefill(prompt)
        tl, tkv = tp.prefill(prompt)
        _close(tl, jl, f"logits, prompt of {len(prompt)}")
        assert len(tkv) == len(jkv)
        for i, (t, j) in enumerate(zip(tkv, jkv)):
            _close(to_numpy(t), np.asarray(j), f"kv[{i}]")


def test_decode_logits_match_over_steps(pair):
    """Seed three slots (one left free) with each package's own prefill,
    then decode five steps on both, feeding the JAX greedy token to
    both; logits and the paged pools agree at every step."""
    jp, tp = pair
    prompts = _prompts(2, (16, 9, 31))
    slots = [0, 1, 3]
    tokens = np.zeros(NUM_SLOTS, np.int32)
    pos = np.zeros(NUM_SLOTS, np.int32)
    try:
        for slot, prompt in zip(slots, prompts):
            for p in (jp, tp):
                p.alloc_slot_pages(slot, p.pages_needed(len(prompt), 8))
                _, kv = p.prefill(prompt)
                p.write_slot(slot, kv, len(prompt))
            tokens[slot] = int(np.argmax(jp.prefill(prompt)[0]))
            pos[slot] = len(prompt)
        for step in range(5):
            lens = np.where(np.isin(np.arange(NUM_SLOTS), slots), pos + 1,
                            0).astype(np.int32)
            jl = jp.decode_step(tokens, pos, lens=lens)
            tl = tp.decode_step(tokens, pos, lens=lens)
            _close(tl[slots], np.asarray(jl)[slots], f"logits step {step}")
            for name in jp.cache_vars:
                _close(to_numpy(tp.cache(name)),
                       np.asarray(jp._scope.find_var(name)),
                       f"{name} step {step}")
            tokens[slots] = np.argmax(np.asarray(jl)[slots], axis=1)
            pos[slots] += 1
    finally:
        for p in (jp, tp):
            p.free_all_pages()


def _greedy(scheduler, prompts, n):
    streams = [scheduler.submit(p, max_new_tokens=n) for p in prompts]
    outs = [list(s) for s in streams]
    scheduler.close()
    return outs


def test_scheduler_tokens_identical_to_jax(pair):
    jp, tp = pair
    prompts = _prompts(3)
    want = _greedy(JaxScheduler(jp), prompts, 24)
    got = _greedy(GenScheduler(tp), prompts, 24)
    assert got == want
    assert all(len(o) == 24 for o in got)


def test_port_bundle_serves_identically_in_jax(torch_bundle):
    """A bundle exported by the port loads in the JAX package and gives
    the same logits and greedy tokens as in the port."""
    jp = JaxPredictor(torch_bundle)
    tp = GenPredictor(torch_bundle, place=CPUPlace())
    prompt = _prompts(4, (20,))[0]
    _close(tp.prefill(prompt)[0], jp.prefill(prompt)[0], "logits")
    prompts = _prompts(5)
    want = _greedy(JaxScheduler(jp), prompts, 20)
    got = _greedy(GenScheduler(tp), prompts, 20)
    assert got == want


def test_dense_bundle_serves_identically_in_both(tmp_path):
    """The dense-decode export ([num_slots, max_len] cache, one-hot
    writes, row-bias softmax) gives the same greedy tokens in both
    packages."""
    d = str(tmp_path / "dense")
    torch_gen_lm.export_gen_model(d, torch_gen_lm.GenConfig(),
                                  num_slots=NUM_SLOTS, paged=False,
                                  place=CPUPlace(), seed=2)
    jp = JaxPredictor(d)
    tp = GenPredictor(d, place=CPUPlace())
    assert not tp.paged
    prompts = _prompts(7)
    want = _greedy(JaxScheduler(jp), prompts, 16)
    got = _greedy(GenScheduler(tp), prompts, 16)
    assert got == want


def test_port_greedy_matches_cache_free_reprefill(pair):
    """The port's acceptance on its own: every KV-cached greedy token
    equals the argmax of a cache-free re-prefill of the sequence."""
    _, tp = pair
    prompts = _prompts(6, (15, 17, 32))
    outs = _greedy(GenScheduler(tp), prompts, 12)
    for prompt, out in zip(prompts, outs):
        seq = list(prompt)
        for tok in out:
            assert int(np.argmax(tp.prefill(seq)[0])) == tok
            seq.append(tok)


def test_scheduler_crash_fails_streams_and_is_counted(torch_bundle):
    """A fault inside a decode step (what a kernel error looks like to
    the scheduler) fails the live streams with BatcherCrashed and is
    counted; past the restart budget the scheduler reports ``failed``
    and refuses new work — it never finishes a stream silently."""
    from paddle_tpu_torch.gen import BatcherCrashed
    tp = GenPredictor(torch_bundle, place=CPUPlace())

    def broken(*a, **kw):
        raise RuntimeError("injected decode fault")

    tp.decode_step = broken
    sched = GenScheduler(tp, max_restarts=1)
    try:
        for crash in (1, 2):
            stream = sched.submit([1, 2, 3], max_new_tokens=4)
            with pytest.raises(BatcherCrashed):
                list(stream)
            assert isinstance(stream.error.__cause__, RuntimeError)
            assert sched.crashes == crash
        assert sched.failed is not None
        with pytest.raises(BatcherCrashed):
            sched.submit([1], max_new_tokens=2)
        assert tp.free_pages == tp.num_pages  # the crash reset the pool
    finally:
        sched.close()


def test_scope_from_numpy_round_trips_a_jax_scope():
    """Parameters initialized by the JAX package (plus a bfloat16 tensor)
    cross into a port Scope on the CPU bit for bit."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        jax_gen_lm.build_prefill_program(jax_gen_lm.GenConfig())
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor(fluid.CPUPlace()).run(startup)
    arrays = {n: np.asarray(v) for n, v in scope.items()
              if v is not None}
    arrays["bf16"] = np.asarray(jnp.asarray([1.5, -2.25, 3e-3],
                                            jnp.bfloat16))
    assert len(arrays) > 10
    tscope = scope_from_numpy(arrays, CPUPlace())
    for name, arr in arrays.items():
        back = to_numpy(tscope.find_var(name))
        if name == "bf16":
            np.testing.assert_array_equal(back, arr.view(np.uint16))
        else:
            assert back.dtype == arr.dtype
            np.testing.assert_array_equal(back, arr)
