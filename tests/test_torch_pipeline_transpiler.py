"""The port's pipeline transpiler (``paddle_tpu_torch.parallel.
pipeline_transpiler``) against the JAX package's (mirror of
``tests/test_pipeline_transpiler.py``), and the multi-rank cases of its
``gpipe`` primitive (``tests/test_pipeline.py``; the in-process ones are
in ``tests/test_torch_pipeline.py``).

In this process: ``split_program`` and the lane layouts equal the JAX
package's on the tiny Transformer of ``tests/test_pipeline_transpiler.py``
(stage op lists, stage parameters, boundaries, lanes, offsets, lengths
and the packed parameters), the tensor-array rejection, and the i32
lane's range guard on numpy arrays, numpy scalars and int64 tensors
(its CUDA case, and a one-stage pipeline on the card, are in
``tests/test_torch_cuda.py``, which imports no JAX).

In one 4-rank gloo world (``torch_worlds.multi``, a module fixture): the
pipelined Transformer at 4 stages (float32 over 16 microbatches, losses
and parameter grads; AMP over 4, losses), at dp x pp 2 x 2 (grads), the
i32 lane, a sub-block op, a fetched feed, and ``gpipe``.  Meanwhile this
process and one more run the JAX package's pipelined references on its
virtual CPU devices, from the same state, and this one the port's own
``Executor`` on the unsplit program.

Tolerances (the JAX package's own, pipeline against unsplit): losses
``rtol 2e-4, atol 1e-5``, grads ``rtol 2e-3, atol 2e-5``, float32; AMP
losses at bf16 level (``rtol 2e-2, atol 2e-3``), since a cut sends a
value that is bf16 at run time through the f32 lane and the next stage's
elementwise ops then run in float32.  The parity Transformer has one
encoder and one decoder layer (the JAX package's pipelined grads of two
take a minute to trace); the split parity uses two.
"""

import concurrent.futures
import multiprocessing
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.models import transformer as T
from paddle_tpu.parallel.mesh import make_mesh
from paddle_tpu.parallel import pipeline_transpiler as JP

import torch_worlds
import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import persistable_names, scope_from_numpy
from paddle_tpu_torch.parallel import pipeline_transpiler as TP

P_STAGES, M_MB, MB, SEQ = 4, 4, 4, 8
LOSS_TOL = dict(rtol=2e-4, atol=1e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)
AMP_TOL = dict(rtol=2e-2, atol=2e-3)
WORLD = 4


def _tiny_hp(n_layer=2):
    hp = T.ModelHyperParams()
    hp.d_model, hp.d_inner_hid, hp.n_layer = 32, 64, n_layer
    hp.n_head, hp.d_key, hp.d_value = 2, 16, 16
    hp.src_vocab_size = hp.trg_vocab_size = 64
    hp.max_length = SEQ * 2
    hp.dropout = 0.0
    return hp


def _transformer(n_layer=2, amp=None):
    hp = _tiny_hp(n_layer)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        avg_cost, feeds = T.transformer(MB, SEQ, SEQ, hp)
    main.amp = amp
    return hp, main, startup, avg_cost.name, list(feeds)


def _state(main, startup):
    """The JAX startup program's state of ``main``'s persistables."""
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    names = persistable_names(pt.Program.from_dict(main.to_dict()))
    return {n: np.array(np.asarray(scope.find_var(n))) for n in names}


def _jax_mesh(shape, names):
    return make_mesh(shape, names, devices=jax.devices()[:int(
        np.prod(shape))])


def _jax_pipelined(main, state, batches, feeds, fetch, stages, mesh,
                   data_axis=None, grads=False):
    """The JAX package's pipelined fetches ``{name: [M, ...]}`` and, with
    ``grads``, ``unpack_grads`` of d sum(first fetch)."""
    scope = fluid.Scope()
    for n, a in state.items():
        scope.set_var(n, jnp.asarray(a))
    pp = JP.pipeline_transpiler(main, stages, feeds, fetch, mesh)
    pp.build(scope, batches[0])
    xs = pp.stack_microbatches(batches)
    run = pp.run_fn(data_axis=data_axis)

    def total(packed):
        outs = run(packed, xs)
        return jnp.sum(pp.select_fetch(outs, fetch[0])), outs

    if grads:
        (_, outs), g = jax.jit(jax.value_and_grad(total, has_aux=True))(
            pp.packed_params)
        g = pp.unpack_grads(g)
    else:
        outs, g = jax.jit(run)(pp.packed_params, xs), None
    return {n: np.asarray(pp.select_fetch(outs, n)) for n in fetch}, g, pp


def _port_unsplit(main, state, batches, fetch, grad_names=()):
    """The port's ``Executor`` on the unsplit program, a microbatch at a
    time: the fetches stacked, and the parameter grads of the first
    fetch summed over the microbatches (``append_backward``)."""
    prog = pt.Program.from_dict(main.to_dict())
    scope = scope_from_numpy(state, pt.CPUPlace())
    exe = pt.Executor(pt.CPUPlace())
    fetches = [exe.run(prog, feed=b, fetch_list=fetch, scope=scope)
               for b in batches]
    out = {n: np.stack([np.asarray(f[i]) for f in fetches])
           for i, n in enumerate(fetch)}
    grads = {}
    if grad_names:
        gprog = prog.clone()
        with pt.program_guard(gprog):
            pt.append_backward(gprog.global_block().var(fetch[0]))
        for b in batches:
            vals = exe.run(gprog, feed=b, scope=scope,
                           fetch_list=[n + "@GRAD" for n in grad_names])
            for n, g in zip(grad_names, vals):
                grads[n] = grads.get(n, 0) + np.asarray(g, np.float64)
    return out, grads


def _grad_names(main, case):
    """The parameters of a case whose grads are compared: every
    parameter with a grad in the unsplit program (none where the case
    takes no grads)."""
    if not case.get("grads"):
        return ()
    grad_main = main.clone()
    with fluid.program_guard(grad_main):
        fluid.append_backward(grad_main.global_block().var(
            case["fetch"][0]))
    block = grad_main.global_block()
    return sorted(p.name for p in block.all_parameters()
                  if block.has_var(p.name + "@GRAD"))


# ---------------------------------------------------------------------------
# the cases of the world
# ---------------------------------------------------------------------------

def _case_transformer(n_stages, mesh, amp=None, data_axis=None, rows=1,
                      seed=97, grads=True, microbatches=M_MB):
    hp, main, startup, cost, feeds = _transformer(1, amp)
    batches = [T.fake_batch(MB, SEQ, SEQ, hp, seed=seed + i)
               for i in range(microbatches * rows)]
    return main, {"program": main.to_dict(), "state": _state(main, startup),
                  "batches": batches, "feeds": feeds, "fetch": [cost],
                  "stages": n_stages, "mesh": mesh,
                  "data_axis": data_axis, "grads": grads}


def _case_i32_lane():
    big = (1 << 24) + 1
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = L.data(name="x", shape=[4, 16], append_batch_size=False)
        ids = L.data(name="ids", shape=[4, 1], dtype="int32",
                     append_batch_size=False)
        h = L.fc(x, size=16)      # stage-0 weight
        h2 = L.fc(h, size=16)     # pushes the cut after fc #1
        s = L.reduce_sum(h2)
        idf = L.cast(ids, dtype="float32")  # last stage
        out = s + L.reduce_sum(idf)
    rng = np.random.RandomState(0)
    batches = [{"x": rng.rand(4, 16).astype("f"),
                "ids": np.full((4, 1), big, np.int32)} for _ in range(2)]
    return main, {"program": main.to_dict(), "state": _state(main, startup),
                  "batches": batches, "feeds": ["x", "ids"],
                  "fetch": [out.name, ids.name], "stages": 2,
                  "mesh": ((2, 2), ("data", "pipe"))}


def _case_sub_block():
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = L.data(name="x", shape=[4, 8], append_batch_size=False)
        h = L.fc(x, size=8)
        h2 = L.fc(h, size=8)
        i = L.zeros(shape=[1], dtype="int32")
        i.stop_gradient = True
        n = L.fill_constant(shape=[1], dtype="int32", value=3)
        n.stop_gradient = True
        acc = L.zeros(shape=[4, 8], dtype="float32")
        arr = L.array_write(x=acc, i=i)
        cond = L.less_than(x=i, y=n)
        w = L.While(cond=cond)
        with w.block():
            prev = L.array_read(array=arr, i=i)
            nxt = prev + h2               # consumes the carrier
            i2 = L.increment(x=i, in_place=True)
            L.array_write(nxt, i=i2, array=arr)
            L.less_than(x=i2, y=n, cond=cond)
        final = L.array_read(array=arr, i=n)
        out = L.reduce_sum(final)
    rng = np.random.RandomState(1)
    batches = [{"x": rng.rand(4, 8).astype("f")} for _ in range(2)]
    return main, {"program": main.to_dict(), "state": _state(main, startup),
                  "batches": batches, "feeds": ["x"], "fetch": [out.name],
                  "stages": 2, "mesh": ((2, 2), ("data", "pipe"))}


def _case_fetched_feed():
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = L.data(name="x", shape=[4, 16], append_batch_size=False)
        ids = L.data(name="ids", shape=[4, 1], dtype="int32",
                     append_batch_size=False)
        idf = L.cast(ids, dtype="float32")  # stage 0
        h = L.fc(x, size=16)
        h2 = L.fc(h + idf, size=16)
        out = L.reduce_sum(h2)
    rng = np.random.RandomState(2)
    batches = [{"x": rng.rand(4, 16).astype("f"),
                "ids": np.arange(4, dtype=np.int32).reshape(4, 1)}
               for _ in range(2)]
    return main, {"program": main.to_dict(), "state": _state(main, startup),
                  "batches": batches, "feeds": ["x", "ids"],
                  "fetch": [out.name, ids.name], "stages": 2,
                  "mesh": ((2, 2), ("data", "pipe"))}


def _gpipe_params(n_stages, d=8, m=6, mb=4, seed=0):
    rng = np.random.RandomState(seed)
    per_stage = [{"w": rng.randn(d, d).astype("f") * 0.3,
                  "b": rng.randn(d).astype("f") * 0.1}
                 for _ in range(n_stages)]
    return per_stage, rng.randn(m, mb, d).astype("f")


def _gpipe_sequential(per_stage):
    """The JAX sequential composition of the stages, and its grads of
    ``sum(out ** 2)`` (w, b and the microbatches)."""
    def stage_fn(p, x):
        return x + jnp.tanh(x @ p["w"] + p["b"])

    def loss(params, xs):
        out = xs.reshape(-1, xs.shape[-1])
        for p in params:
            out = stage_fn(p, out)
        return jnp.sum(out ** 2), out.reshape(xs.shape)

    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))


def _encoder_case():
    """A Transformer encoder layer as the stage function: the program and
    four independently initialized copies of its parameters."""
    hp = T.ModelHyperParams()
    hp.d_model, hp.d_inner_hid = 16, 32
    hp.n_head, hp.d_key, hp.d_value = 2, 8, 8
    hp.dropout = hp.attention_dropout = 0.0
    hp.use_flash = False
    mb, S = 2, 8
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[mb, S, hp.d_model],
                              dtype="float32", append_batch_size=False)
        out = T.encoder_layer(x, None, hp, idx=0)
    block = main.global_block()
    names = sorted(n for n, v in block.vars.items()
                   if getattr(v, "persistable", False))
    per_stage = []
    for s in range(P_STAGES):
        scope = fluid.Scope()
        startup.random_seed = 100 + s
        fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
        per_stage.append({n: np.array(np.asarray(scope.find_var(n)))
                          for n in names})
    xs = (np.random.RandomState(7).randn(6, mb, S, hp.d_model) * 0.3
          ).astype("f")

    from paddle_tpu.executor import lower_block

    def stage_fn(params, xv):
        env = {n: jnp.asarray(a) for n, a in params.items()}
        env["x"] = xv
        lower_block(block, env, None, False,
                    {"rng_counter": 0, "lower_block": lower_block})
        return env[out.name]

    want = jnp.asarray(xs)
    for p in per_stage:
        want = jnp.stack([stage_fn(p, want[i])
                          for i in range(want.shape[0])])
    return {"kind": "encoder", "program": main.to_dict(),
            "per_stage": per_stage, "xs": xs, "out": out.name,
            "mesh": ((P_STAGES,), ("pipe",))}, np.asarray(want)


def _jax_references(cases):
    """``{case: {"jax", "jax_grads", "grad_names"}}``: the JAX package's
    pipelined fetches (and grads) of each case, on its virtual CPU
    devices."""
    refs = {}
    for name, case in cases.items():
        main = fluid.Program.from_dict(case["program"])
        got, grads, _ = _jax_pipelined(
            main, case["state"], case["batches"], case["feeds"],
            case["fetch"], case["stages"], _jax_mesh(*case["mesh"]),
            case.get("data_axis"), case.get("grads", False))
        refs[name] = {"jax": got, "jax_grads": grads,
                      "grad_names": _grad_names(main, case)}
    return refs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One 4-rank world runs every port case while this process runs the
    JAX package's pipelined references and the port's unsplit runs."""
    send, result = torch_worlds.spawn_world(
        torch_worlds.multi, WORLD, tmp_path_factory.mktemp("ppworld"))
    pipe4 = ((P_STAGES,), ("pipe",))
    grid = ((2, 2), ("data", "pipe"))
    cases = {
        "fp32": _case_transformer(P_STAGES, pipe4, microbatches=16),
        "amp": _case_transformer(P_STAGES, pipe4, amp=True, seed=51,
                                 grads=False),
        "dp_pp": _case_transformer(2, grid, data_axis="data", rows=2,
                                   seed=11),
        "i32_lane": _case_i32_lane(),
        "sub_block": _case_sub_block(),
        "fetched_feed": _case_fetched_feed(),
    }
    g_stages, g_xs = _gpipe_params(P_STAGES, seed=1)
    t_stages, t_xs = _gpipe_params(2, d=6, m=4, mb=8, seed=2)
    target = np.random.RandomState(3).randn(*t_xs.shape).astype("f")
    encoder, encoder_want = _encoder_case()
    gpipe = [{"kind": "grads", "per_stage": g_stages, "xs": g_xs,
              "mesh": pipe4},
             {"kind": "train", "per_stage": t_stages, "xs": t_xs,
              "target": target, "steps": 15, "mesh": grid},
             encoder]
    send([("pipeline_cases", [c for _, c in cases.values()]),
          ("gpipe_cases", gpipe)])
    # the JAX package's references: the float32 one here, the others in
    # a second process meanwhile (tracing them is most of this file's
    # time)
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        there = pool.submit(_jax_references, {
            name: case for name, (_, case) in cases.items()
            if name != "fp32"})
        refs = _jax_references({"fp32": cases["fp32"][1]})
        unsplit = {name: _port_unsplit(main, case["state"],
                                       case["batches"], case["fetch"],
                                       _grad_names(main, case))
                   for name, (main, case) in cases.items()}
        refs.update(there.result())
    for name, ref in refs.items():
        ref["unsplit"], ref["unsplit_grads"] = unsplit[name]
    (seq_loss, seq_out), (gw, gx) = _gpipe_sequential(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in g_stages])(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in g_stages],
        jnp.asarray(g_xs))
    gref = {"out": np.asarray(seq_out),
            "w": np.stack([np.asarray(g["w"]) for g in gw]),
            "b": np.stack([np.asarray(g["b"]) for g in gw]),
            "xs": np.asarray(gx), "encoder": encoder_want}
    pipes, gpipes = result()
    return dict(zip(cases, pipes)), refs, gpipes, gref


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_stages", [2, P_STAGES])
def test_split_equals_the_reference(n_stages):
    """The same stage op lists, stage parameters and boundaries as the
    JAX package's, on the same IR; balanced and covering."""
    _, main, _, cost, feeds = _transformer()
    jb, jops, jparams, jbounds = JP.split_program(main, n_stages, feeds,
                                                  [cost])
    tmain = pt.Program.from_dict(main.to_dict())
    tb, tops, tparams, tbounds = TP.split_program(tmain, n_stages, feeds,
                                                  [cost])
    assert [[(o.type, o.inputs, o.outputs) for o in s] for s in tops] == \
        [[(o.type, o.inputs, o.outputs) for o in s] for s in jops]
    assert tparams == jparams and tbounds == jbounds
    assert sum(len(s) for s in tops) == sum(
        1 for op in tb.ops if op.type not in ("feed", "fetch"))
    assert all(tops) and set(tbounds[0]) <= set(feeds)
    assert tbounds[-1] == [cost]


def test_layouts_and_packed_params_equal_the_reference():
    """``build`` from the same state gives the JAX package's lanes,
    offsets and lengths, and its packed parameters value for value."""
    hp, main, startup, cost, feeds = _transformer()
    state = _state(main, startup)
    batch = T.fake_batch(MB, SEQ, SEQ, hp, seed=97)
    jscope = fluid.Scope()
    for n, a in state.items():
        jscope.set_var(n, jnp.asarray(a))
    jpp = JP.pipeline_transpiler(main, P_STAGES, feeds, [cost],
                                 _jax_mesh((P_STAGES,), ("pipe",)))
    jpp.build(jscope, batch)
    mesh = SimpleNamespace(device_type="cpu")  # build reads the device
    tpp = TP.pipeline_transpiler(pt.Program.from_dict(main.to_dict()),
                                 P_STAGES, feeds, [cost], mesh)
    tpp.build(scope_from_numpy(state, pt.CPUPlace()), batch)
    assert tpp.carrier_lanes == jpp.carrier_lanes
    assert tpp.param_lanes == jpp.param_lanes
    assert tpp.carrier_len == jpp.carrier_len
    assert tpp.param_len == jpp.param_len
    for tl, jl in zip(tpp._carrier_layouts + tpp._param_layouts,
                      jpp._carrier_layouts + jpp._param_layouts):
        assert (tl.names, tl.shapes, tl.lanes, tl.offsets, tl.lengths) == \
            (jl.names, jl.shapes, jl.lanes, jl.offsets, jl.lengths)
    for lane in jpp.param_lanes:
        np.testing.assert_array_equal(tpp.packed_params[lane].numpy(),
                                      np.asarray(jpp.packed_params[lane]))
    xs = tpp.stack_microbatches([batch])
    jxs = jpp.stack_microbatches([batch])
    for lane in jpp.carrier_lanes:
        np.testing.assert_array_equal(xs[lane].numpy(),
                                      np.asarray(jxs[lane]))


def test_tensor_array_across_cut_rejected_loudly():
    """A TensorArray created before the cut and read after it cannot
    ride a flat carrier: both packages reject it, naming it."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = L.data(name="x", shape=[4, 8], append_batch_size=False)
        i = L.zeros(shape=[1], dtype="int32")
        i.stop_gradient = True
        arr = L.array_write(x=x, i=i)       # array BEFORE the cut
        h = L.fc(x, size=8)
        h2 = L.fc(h, size=8)                # cut lands here
        back = L.array_read(array=arr, i=i)  # array AFTER the cut
        out = L.reduce_sum(h2) + L.reduce_sum(back)
    with pytest.raises(ValueError, match="tensor_array") as want:
        JP.pipeline_transpiler(main, 2, ["x"], [out.name],
                               _jax_mesh((2,), ("pipe",)))
    with pytest.raises(ValueError, match="tensor_array") as got:
        TP.pipeline_transpiler(pt.Program.from_dict(main.to_dict()), 2,
                               ["x"], [out.name])
    assert str(got.value) == str(want.value)


class TestI32LaneRangeGuard:
    """The i32 lane's int64 range guard keys on the value's dtype: numpy
    arrays and scalars, and int64 tensors on any device.  An int64 value
    outside int32 range raises; it never wraps."""

    def _layout(self):
        return TP._Layout(["ids"], [(1,)], [np.int64])

    @pytest.mark.parametrize("value", [
        np.array([2 ** 31], np.int64), np.int64(2 ** 31),
        np.asarray([-(2 ** 40)]), torch.tensor([2 ** 31]),
        torch.tensor([-(2 ** 31) - 1])],
        ids=["ndarray", "numpy_scalar", "list", "tensor", "tensor_low"])
    def test_out_of_range_rejected(self, value):
        with pytest.raises(ValueError, match="int32 range"):
            self._layout().pack({"ids": value}, ["i32"])

    @pytest.mark.parametrize("value", [
        np.array([2 ** 31 - 1], np.int64), torch.tensor([2 ** 31 - 1])],
        ids=["ndarray", "tensor"])
    def test_in_range_int64_packs_exactly(self, value):
        vecs = self._layout().pack({"ids": value}, ["i32"])
        assert vecs["i32"].dtype == torch.int32
        assert int(vecs["i32"][0]) == 2 ** 31 - 1

    def test_in_schedule_check_is_one_flag_read_after(self):
        """Inside the schedule a tensor's check joins the fault records
        and raises only where they are read."""
        from paddle_tpu_torch.ops import registry
        faults = {}
        vecs = self._layout().pack({"ids": torch.tensor([2 ** 33])},
                                   ["i32"], faults=faults)
        assert int(vecs["i32"][0]) == 0          # wrapped, not yet read
        with pytest.raises(ValueError, match="int32 range"):
            registry.raise_fault(*registry.fault_word(
                {"fault_flags": faults}))

    def test_jax_package_guard_agrees(self):
        lay = JP._Layout(["ids"], [(1,)], [np.int64])
        with pytest.raises(ValueError, match="int32 range"):
            lay.pack({"ids": np.int64(2 ** 31)}, ["i32"])

    def test_a_stage_value_out_of_range_raises_after_the_schedule(self):
        """An int64 value computed inside a stage and fetched: the
        one-stage schedule raises once it is done."""
        L = pt.layers
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            x = L.data(name="x", shape=[2, 3], append_batch_size=False)
            y = L.cast(L.scale(x, scale=1e10), dtype="int64")
        mesh = SimpleNamespace(device_type="cpu", mesh_dim_names=("pipe",),
                               shape=(1,))
        pp = TP.pipeline_transpiler(main, 1, ["x"], [y.name], mesh)
        feed = {"x": np.ones((2, 3), np.float32)}
        pp.build(pt.Scope(), feed)
        xs = pp.stack_microbatches([feed])
        with pytest.raises(ValueError, match="int32 range"):
            pp.run_fn()(pp.packed_params, xs)
        ok = {"x": np.full((2, 3), 1e-10, np.float32)}
        out = pp.run_fn()(pp.packed_params, pp.stack_microbatches([ok]))
        assert pp.select_fetch(out, y.name).dtype == torch.int64


# ---------------------------------------------------------------------------
# in the world
# ---------------------------------------------------------------------------

def _losses(fetch):
    return np.asarray(fetch, np.float64).reshape(-1)


@pytest.mark.parametrize("case", ["fp32", "dp_pp"])
def test_pipelined_loss_and_grads_match_the_reference(world, case):
    """Losses and parameter grads of the port's pipeline in the gloo
    world: the JAX package's pipelined run's, and the port's own
    ``Executor`` on the unsplit program's; the same on every rank."""
    got, refs, _, _ = world
    got, ref = got[case], refs[case]
    assert got["same_on_every_rank"]
    (cost,) = [n for n in got["fetches"]]
    np.testing.assert_allclose(_losses(got["fetches"][cost]),
                               _losses(ref["jax"][cost]), **LOSS_TOL)
    np.testing.assert_allclose(_losses(got["fetches"][cost]),
                               _losses(ref["unsplit"][cost]), **LOSS_TOL)
    names = ref["grad_names"]
    assert len(names) >= 10 and set(names) <= set(got["grads"])
    for n in names:
        np.testing.assert_allclose(got["grads"][n], ref["jax_grads"][n],
                                   **GRAD_TOL, err_msg=f"{n} (jax)")
        np.testing.assert_allclose(got["grads"][n], ref["unsplit_grads"][n],
                                   **GRAD_TOL, err_msg=f"{n} (unsplit)")


def test_amp_pipelined_matches_unsplit_amp(world):
    got, refs, _, _ = world
    got, ref = got["amp"], refs["amp"]
    (cost,) = [n for n in got["fetches"]]
    np.testing.assert_allclose(_losses(got["fetches"][cost]),
                               _losses(ref["jax"][cost]), **AMP_TOL)
    np.testing.assert_allclose(_losses(got["fetches"][cost]),
                               _losses(ref["unsplit"][cost]), **AMP_TOL)


def test_integer_feed_rides_i32_lane_exactly(world):
    """ids >= 2**24 (not exact in float32) cross the cut on the i32
    lane exactly."""
    got, refs, _, _ = world
    got, ref = got["i32_lane"], refs["i32_lane"]
    assert "i32" in got["carrier_lanes"]
    out, ids = list(got["fetches"])
    assert got["fetches"][ids].dtype == np.int32
    np.testing.assert_array_equal(got["fetches"][ids],
                                  np.full((2, 4, 1), (1 << 24) + 1))
    np.testing.assert_array_equal(got["fetches"][ids], ref["jax"][ids])
    np.testing.assert_allclose(_losses(got["fetches"][out]),
                               _losses(ref["jax"][out]), rtol=1e-5)
    np.testing.assert_allclose(_losses(got["fetches"][out]),
                               _losses(ref["unsplit"][out]), rtol=1e-5)


def test_sub_block_op_is_atomic_and_runs(world):
    got, refs, _, _ = world
    got, ref = got["sub_block"], refs["sub_block"]
    (out,) = list(got["fetches"])
    np.testing.assert_allclose(_losses(got["fetches"][out]),
                               _losses(ref["jax"][out]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(_losses(got["fetches"][out]),
                               _losses(ref["unsplit"][out]), rtol=1e-5,
                               atol=1e-6)


def test_fetched_feed_rides_every_boundary(world):
    got, refs, _, _ = world
    got, ref = got["fetched_feed"], refs["fetched_feed"]
    out, ids = list(got["fetches"])
    np.testing.assert_array_equal(got["fetches"][ids], ref["jax"][ids])
    np.testing.assert_allclose(_losses(got["fetches"][out]),
                               _losses(ref["unsplit"][out]), rtol=1e-5)


def test_gpipe_forward_and_grads_match_sequential(world):
    """``gpipe`` over 4 ranks: the outputs of the sequential composition
    and its grads (stacked w, b and the microbatches), as JAX
    differentiates it."""
    _, _, gpipes, gref = world
    got = gpipes[0]
    np.testing.assert_allclose(got["out"], gref["out"], rtol=2e-5,
                               atol=1e-6)
    for k in ("w", "b", "xs"):
        np.testing.assert_allclose(got[k], gref[k], rtol=5e-4, atol=1e-5,
                                   err_msg=k)


def test_gpipe_training_converges(world):
    """SGD over the pipelined MSE at 2 stages trains."""
    losses = world[2][1]["losses"]
    assert losses[-1] < losses[0] * 0.9, losses


def test_gpipe_over_a_lowered_encoder_layer(world):
    """The stage function is a Transformer encoder layer's op lowerings;
    four independently initialized copies, pipelined, equal the JAX
    package's layers applied in sequence."""
    _, _, gpipes, gref = world
    np.testing.assert_allclose(gpipes[2]["out"], gref["encoder"],
                               rtol=2e-4, atol=1e-5)
