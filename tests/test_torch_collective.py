"""The port's collective helpers and ``c_*`` IR ops (``parallel/
collective.py``, ``ops/collective_ops.py``) against the JAX package's
(mirror of ``tests/test_distributed_aux.py``'s collectives).

The port runs in one spawned 4-rank gloo world (``torch_worlds``); the
JAX package runs the same helpers inside ``shard_map`` over 4 of the 8
virtual devices of ``tests/conftest.py``, each device holding what the
port's rank of that index holds.  Exact (``atol = rtol = 0``) for the
gathers, scatters, broadcast and max; the sums of 4 float32 values of
integers are exact too; ``c_allreduce_prod``'s ``exp(psum(log x))`` is
held to 1e-6 and, at non-positive inputs, to the JAX package's NaN and
zero pattern; the ``c_*`` sums of non-integer values to 1e-6 (another
order of the same 4 float32 terms).
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as JP

import paddle_tpu as fluid
import paddle_tpu.layers as layers
from paddle_tpu.layer_helper import LayerHelper
from paddle_tpu.parallel import collective as jcol
from paddle_tpu.parallel.mesh import make_mesh as jmesh

import torch_worlds
import paddle_tpu_torch as pt

WORLD = 4
C_OPS = ("c_allreduce_sum", "c_allreduce_max", "c_allreduce_min",
         "c_allreduce_prod", "c_broadcast", "c_allgather", "c_reducescatter",
         "c_alltoall")


def _op_program(x_shape, axis="data"):
    """One ``x`` feed through every ``c_*`` op (pinned to ``axis`` when
    given), built by the JAX package."""
    main, startup = fluid.Program(), fluid.Program()
    outs = []
    with fluid.program_guard(main, startup):
        x = layers.data(name="x", shape=list(x_shape),
                        append_batch_size=False)
        for t in C_OPS:
            helper = LayerHelper(t)
            out = helper.create_tmp_variable("float32")
            attrs = {"axis": axis} if axis else {}
            helper.append_op(type=t, inputs={"X": [x]},
                             outputs={"Out": [out]}, attrs=attrs)
            outs.append(out.name)
    return main, outs


def _jax_shard_map(fn, x):
    """``fn`` over 4 virtual devices on axis ``x``, each holding a
    quarter of ``x``'s dim 0; the per-device results concatenated."""
    mesh = jmesh((WORLD,), ("x",), devices=jax.devices()[:WORLD])
    return np.asarray(shard_map(fn, mesh=mesh, in_specs=(JP("x"),),
                                out_specs=JP("x"), check_rep=False)(
        jnp.asarray(x)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.RandomState(0)
    x = rng.randint(-4, 5, (16, 3)).astype("float32")
    pos = rng.uniform(0.5, 2.0, (16, 3)).astype("float32")
    neg = pos.copy()
    neg[0, 0], neg[5, 1], neg[10, 2] = -1.0, 0.0, -2.5
    main, outs = _op_program((16, 3))
    cases = [{"program": main.to_dict(), "fetch": outs,
              "feeds": [{"x": v}] * WORLD} for v in (x, pos, neg)]
    got = torch_worlds.run_world(
        torch_worlds.multi, WORLD, tmp_path_factory.mktemp("cworld"),
        [("collective_cases", None), ("collective_op_cases", cases)])
    return {"helpers": got[0], "ops": got[1], "x": x, "pos": pos,
            "neg": neg}


def test_helpers_equal_the_reference(world):
    """Rank r holds ``arange(8) + 8 r``; the JAX package's device r the
    same."""
    x = np.arange(8.0 * WORLD, dtype="float32")
    want = {
        "all_reduce": _jax_shard_map(lambda v: jcol.all_reduce(v, "x"), x),
        "all_reduce_max": _jax_shard_map(
            lambda v: jcol.all_reduce(v, "x", "max"), x),
        "all_gather": _jax_shard_map(lambda v: jcol.all_gather(v, "x"), x),
        "reduce_scatter": _jax_shard_map(
            lambda v: jcol.reduce_scatter(v, "x"), x),
        "broadcast": _jax_shard_map(
            lambda v: jcol.broadcast(v, "x", root=3), x),
        "all_to_all": _jax_shard_map(
            lambda v: jcol.all_to_all(v.reshape(WORLD, -1), "x", 0, 1)
            .reshape(-1), x),
    }
    for name, w in want.items():
        got = np.concatenate([r[name].reshape(-1)
                              for r in world["helpers"]])
        np.testing.assert_array_equal(got, w.reshape(-1), err_msg=name)


def test_helper_grads_are_the_transposed_collectives(world):
    """``psum``'s transpose is ``psum``: d/dx_r of sum_r' (r'+1) psum(x)
    is 1 + 2 + 3 + 4; ``all_gather``'s is a reduce-scatter of the
    cotangent (rank r gets sum over ranks of its slice's weights)."""
    cot = np.arange(8.0 * WORLD, dtype="float32")
    for rank, r in enumerate(world["helpers"]):
        np.testing.assert_array_equal(r["all_reduce_grad"],
                                      np.full(8, 10.0, "float32"))
        np.testing.assert_array_equal(
            r["all_gather_grad"], WORLD * cot[8 * rank:8 * rank + 8])


@pytest.mark.parametrize("which", ["x", "pos"])
def test_c_ops_on_a_data_mesh_equal_the_reference(world, which):
    """Each ``c_*`` op pinned to ``data``: the port splits the fed ``x``
    over the 4 ranks and the op acts on each rank's rows, as the JAX
    package's lowering acts on a device's shard in ``shard_map``."""
    x = world[which]
    lower = {
        "c_allreduce_sum": lambda v: jax.lax.psum(v, "x"),
        "c_allreduce_max": lambda v: jax.lax.pmax(v, "x"),
        "c_allreduce_min": lambda v: jax.lax.pmin(v, "x"),
        "c_allreduce_prod": lambda v: jnp.exp(jax.lax.psum(jnp.log(v),
                                                           "x")),
        "c_broadcast": lambda v: jcol.broadcast(v, "x", 0),
        "c_allgather": lambda v: jcol.all_gather(v, "x"),
        "c_reducescatter": lambda v: jcol.reduce_scatter(v, "x"),
        "c_alltoall": lambda v: jcol.all_to_all(v, "x", 0, 0),
    }
    per_rank = world["ops"][["x", "pos"].index(which)]
    for i, op in enumerate(C_OPS):
        got = np.concatenate([r[i] for r in per_rank])
        want = _jax_shard_map(lower[op], x)
        if op == "c_allreduce_prod" and which == "x":
            continue        # log of a negative: the next test
        # sums of 4 non-integer float32 values differ in their order
        tol = 1e-6 if op in ("c_allreduce_sum", "c_allreduce_prod",
                             "c_reducescatter") else 0
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   err_msg=op)


def test_allreduce_prod_at_non_positive_inputs(world):
    """``exp(psum(log x))`` as the JAX package computes it: a negative
    factor gives NaN, a zero 0, in the same places."""
    per_rank = world["ops"][2]
    i = C_OPS.index("c_allreduce_prod")
    got = np.concatenate([r[i] for r in per_rank])
    want = _jax_shard_map(lambda v: jnp.exp(jax.lax.psum(jnp.log(v), "x")),
                          world["neg"])
    assert np.isnan(want).any() and (want == 0).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got == 0, want == 0)
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-6, atol=1e-6)


def test_c_ops_are_the_identity_outside_an_axis():
    """Without an ``axis`` (and no axis context) every ``c_*`` op is the
    identity in both packages (one logical device)."""
    main, outs = _op_program((4,), axis=None)
    xv = np.asarray([1.0, 2.0, 3.0, 4.0], "float32")
    want = fluid.Executor(fluid.CPUPlace()).run(
        main, feed={"x": xv}, fetch_list=outs, scope=fluid.Scope())
    got = pt.Executor(pt.CPUPlace()).run(
        pt.Program.from_dict(main.to_dict()), feed={"x": xv},
        fetch_list=outs, scope=pt.Scope())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, xv)
        np.testing.assert_array_equal(g, np.asarray(w))


def test_a_pinned_c_op_without_a_mesh_raises():
    main, outs = _op_program((4,))
    with pytest.raises(RuntimeError, match="no mesh"):
        pt.Executor(pt.CPUPlace()).run(
            pt.Program.from_dict(main.to_dict()),
            feed={"x": np.ones(4, "float32")}, fetch_list=outs[:1],
            scope=pt.Scope())


def test_the_registry_equals_the_reference():
    """249 op types in both packages, the 8 ``c_*`` ops and
    ``ring_attention`` among them, as the packages register them: in a
    fresh interpreter (tests in this process register entries of their
    own, a ``*_grad`` lowering or a test-only op)."""
    import subprocess
    import sys
    code = ("import json, paddle_tpu, paddle_tpu_torch\n"
            "from paddle_tpu.ops import registry as j\n"
            "from paddle_tpu_torch.ops import registry as t\n"
            "print(json.dumps([sorted(j.all_ops()), sorted(t.all_ops())]))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env=dict(os.environ, PYTHONPATH=root,
                                  JAX_PLATFORMS="cpu"),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    jops, tops = json.loads(out.stdout.strip().splitlines()[-1])
    assert tops == jops and len(tops) == 249
    assert set(C_OPS) | {"ring_attention"} <= set(tops)
