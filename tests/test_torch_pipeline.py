"""The port's GPipe primitive (``paddle_tpu_torch.parallel.pipeline``)
against the JAX package's (mirror of ``tests/test_pipeline.py``), in this
process: the stage checks, and a one-stage pipeline (an axis of size 1
has nothing to send or sum, so it runs without a process group) against
the JAX package's sequential composition, outputs and grads.

The multi-rank cases (4 stages forward and grads, 2-stage training, a
lowered encoder layer a stage) run in the 4-rank world of
``tests/test_torch_pipeline_transpiler.py``, which serves both files.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.parallel.pipeline import (gpipe as jgpipe,
                                          stack_stage_params as jstack)
from paddle_tpu.parallel.mesh import make_mesh

from paddle_tpu_torch.parallel.pipeline import gpipe, stack_stage_params


def _mesh(size, names=("pipe",)):
    """The mesh facts ``gpipe`` reads (axis names and sizes); at an axis
    of size 1 it asks for no process group."""
    return SimpleNamespace(mesh_dim_names=names, shape=(size,))


def _make(n_stages, d=8, m=6, mb=4, seed=0):
    rng = np.random.RandomState(seed)
    per_stage = [{"w": rng.randn(d, d).astype("f") * 0.3,
                  "b": rng.randn(d).astype("f") * 0.1}
                 for _ in range(n_stages)]
    return per_stage, rng.randn(m, mb, d).astype("f")


def _torch_stage(p, x):
    return x + torch.tanh(x @ p["w"] + p["b"])


def _jax_stage(p, x):
    return x + jnp.tanh(x @ p["w"] + p["b"])


def test_stack_equals_the_reference():
    per_stage, _ = _make(3)
    got = stack_stage_params([{k: torch.from_numpy(v) for k, v in p.items()}
                              for p in per_stage])
    want = jstack([{k: jnp.asarray(v) for k, v in p.items()}
                   for p in per_stage])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("stages", [
    [{"w": torch.zeros(2, 2)}, {"v": torch.zeros(2, 2)}],
    [{"w": torch.zeros(2, 2)}, {"w": torch.zeros(2, 3)}]],
    ids=["names", "shapes"])
def test_stage_homogeneity_enforced(stages):
    with pytest.raises(ValueError, match="homogeneous"):
        stack_stage_params(stages)
    with pytest.raises(ValueError, match="homogeneous"):
        jstack([{k: jnp.asarray(v.numpy()) for k, v in s.items()}
                for s in stages])


def test_stage_count_must_match_mesh():
    """8 stacked stages on a 4-rank axis: one stage a rank, or it
    raises (the JAX package's check, before anything is sent)."""
    per_stage, xs = _make(8)
    stacked = stack_stage_params([{k: torch.from_numpy(v)
                                   for k, v in p.items()}
                                  for p in per_stage])
    with pytest.raises(ValueError, match="one stage per"):
        gpipe(_torch_stage, stacked, torch.from_numpy(xs), _mesh(4))
    jmesh = make_mesh((4,), ("pipe",), devices=jax.devices()[:4])
    with pytest.raises(ValueError, match="one stage per"):
        jgpipe(_jax_stage, jstack([{k: jnp.asarray(v) for k, v in p.items()}
                                   for p in per_stage]),
               jnp.asarray(xs), jmesh)


def test_missing_axis_raises():
    per_stage, xs = _make(1)
    stacked = stack_stage_params([{k: torch.from_numpy(v)
                                   for k, v in p.items()}
                                  for p in per_stage])
    with pytest.raises(ValueError, match="no axis 'pipe'"):
        gpipe(_torch_stage, stacked, torch.from_numpy(xs),
              _mesh(1, ("data",)))


def test_one_stage_forward_and_grads_match_sequential():
    """At one stage the schedule still runs its ticks, ingest and bank:
    the outputs of the JAX package's sequential stage, and the grads of
    ``sum(out ** 2)`` for w, b and the microbatches."""
    per_stage, xs = _make(1, seed=1)
    params = {k: v.requires_grad_() for k, v in stack_stage_params(
        [{k: torch.from_numpy(v) for k, v in per_stage[0].items()}]).items()}
    x = torch.from_numpy(xs).requires_grad_()
    out = gpipe(_torch_stage, params, x, _mesh(1))
    (out ** 2).sum().backward()

    def loss(p, xv):
        y = _jax_stage(p, xv)
        return jnp.sum(y ** 2), y

    (_, want), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in per_stage[0].items()},
        jnp.asarray(xs))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=1e-6)
    for k in ("w", "b"):
        np.testing.assert_allclose(params[k].grad.numpy()[0],
                                   np.asarray(gp[k]), rtol=5e-4, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx), rtol=5e-4,
                               atol=1e-5)
