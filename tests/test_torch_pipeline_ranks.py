"""``pipeline_spmd`` on meshes over several processes (gloo ranks on the
CPU) against the JAX package's.

Each mesh spans a gloo world of spawned processes formed by the port's
Train backend: pp=2 and pp=4 with one stage a rank, and pp=4 on two ranks
(two stages a rank, handed on inside the rank). Every rank passes the
same stacked tanh weights and input (drawn by ``jax.random`` in the
parent, carried across as numpy) and runs its stages' ticks; the last
stage's rank gets the output, the others a tensor of no size, and every
rank calls backward on the sum of its output's squares. The parent runs
JAX's ``pipeline_spmd`` and ``jax.grad`` on a pp mesh of the conftest's
CPU devices. f32 throughout, at the bounds of
``tests/test_torch_pipeline.py``: outputs within 1e-5, gradients within
1e-4 (each rank's weight gradient nonzero only on its stages' layers,
their sum JAX's; the input's gradient on the first stage's rank).

The spawned ranks import this module, so it imports JAX and the JAX
package only inside fixtures.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.parallel import (MeshSpec, build_mesh, pipeline_spmd,
                                    split_stages)
from test_torch_collective import spawn_ranks

# name: (pp, world, microbatches)
RUNS = {"pp2": (2, 2, 4), "pp4": (4, 4, 6), "pp4-2ranks": (4, 2, 4)}
NAMES = list(RUNS)
L, D, B = 8, 16, 12


def _stage(stage_w, x):
    for w in stage_w:
        x = torch.tanh(x @ w)
    return x


def _ranks(rank, world, jobs):
    """Each job (name, weights, x): this rank's output and the gradients
    of the weights and of x."""
    out = {}
    for name, ws, x in jobs:
        pp, _, mb = RUNS[name]
        mesh = build_mesh(MeshSpec(pp=pp))
        tw = torch.from_numpy(ws).requires_grad_()
        tx = torch.from_numpy(x).requires_grad_()
        y = pipeline_spmd(_stage, split_stages(tw, pp), tx, mesh=mesh,
                          num_microbatches=mb)
        (y ** 2).sum().backward()
        out[name] = dict(
            out=y.detach().numpy(), w_grad=tw.grad.numpy(),
            x_grad=None if tx.grad is None else tx.grad.numpy())
    return out


@pytest.fixture(scope="module")
def jax_side():
    """{name: (weights, x, out, weight grad, x grad)} from JAX's
    pipeline_spmd on pp meshes of the conftest's CPU devices."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.parallel import MeshSpec as JaxMeshSpec
    from ray_tpu.parallel import build_mesh as jax_build_mesh
    from ray_tpu.parallel.pipeline import merge_stages, split_stages as jss
    from ray_tpu.parallel.pipeline import pipeline_spmd as jax_pipeline
    from test_torch_pipeline import _jax_stage
    ws = jax.random.normal(jax.random.key(0), (L, D, D)) * 0.1
    x = jax.random.normal(jax.random.key(1), (B, D))
    out = {}
    for name, (pp, _, mb) in RUNS.items():
        jmesh = jax_build_mesh(JaxMeshSpec(pp=pp), devices=jax.devices()[:pp])

        def run(sp, x, jmesh=jmesh, pp=pp, mb=mb):
            return jax_pipeline(_jax_stage, sp, x, mesh=jmesh,
                                num_microbatches=mb)
        y = jax.jit(run)(jss(ws, pp), x)
        gw, gx = jax.jit(jax.grad(lambda sp, x: jnp.sum(run(sp, x) ** 2),
                                  argnums=(0, 1)))(jss(ws, pp), x)
        out[name] = tuple(np.asarray(a) for a in (
            ws, x, y, merge_stages(gw), gx))
    return out


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    """{world: every rank's results}, one spawn per world."""
    out = {}
    for world in sorted({w for _, w, _ in RUNS.values()}):
        jobs = [(n, *jax_side[n][:2]) for n in NAMES if RUNS[n][1] == world]
        out[world] = spawn_ranks(_ranks, world,
                                 tmp_path_factory.mktemp(f"world{world}"),
                                 jobs)
    return out


def _holders(name):
    """The rank of each stage: stage s on rank s * world // pp."""
    pp, world, _ = RUNS[name]
    return [s * world // pp for s in range(pp)]


@pytest.mark.parametrize("name", NAMES)
def test_output_lands_on_the_last_stage_and_matches_jax(name, ranks,
                                                        jax_side):
    pp, world, _ = RUNS[name]
    want = jax_side[name][2]
    last = _holders(name)[-1]
    for r, got in enumerate(ranks[world]):
        y = got[name]["out"]
        if r == last:
            np.testing.assert_allclose(y, want, atol=1e-5)
        else:
            assert y.shape == (0,)


@pytest.mark.parametrize("name", NAMES)
def test_gradients_match_jax(name, ranks, jax_side):
    """Each rank's weight gradient is its stages' layers' (zero on the
    others), their sum JAX's; x's gradient is on the first stage's
    rank."""
    pp, world, _ = RUNS[name]
    _, _, _, gw, gx = jax_side[name]
    got = [r[name] for r in ranks[world]]
    np.testing.assert_allclose(sum(g["w_grad"] for g in got), gw, atol=1e-4)
    per = L // pp
    for s, r in enumerate(_holders(name)):
        np.testing.assert_allclose(got[r]["w_grad"][s * per:(s + 1) * per],
                                   gw[s * per:(s + 1) * per], atol=1e-4)
    for r, g in enumerate(got):
        mine = [s for s, h in enumerate(_holders(name)) if h == r]
        off = np.delete(g["w_grad"], np.concatenate(
            [np.arange(s * per, (s + 1) * per) for s in mine]), axis=0)
        assert not off.any()
        if r == 0:
            np.testing.assert_allclose(g["x_grad"], gx, atol=1e-4)
        else:
            assert g["x_grad"] is None or not g["x_grad"].any()
