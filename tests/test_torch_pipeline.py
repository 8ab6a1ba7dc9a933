"""Parity of ray_tpu_torch's pipeline (``parallel/pipeline.py``) with the
JAX package's ``pipeline_spmd`` on the CPU.

The ports of ``tests/test_parallel_advanced.py``'s pipeline tests: the
same stacked tanh weights (drawn by ``jax.random``, carried across as
numpy) through JAX's ``pipeline_spmd`` on a pp=4 mesh of the conftest's
virtual CPU devices and through the port's on a pp=4 mesh that names the
CPU 4 times. f32 throughout: the outputs within 1e-5 of JAX's, the
gradients within 1e-4 of ``jax.grad``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.parallel import MeshSpec as JaxMeshSpec
from ray_tpu.parallel import build_mesh as jax_build_mesh
from ray_tpu.parallel.pipeline import merge_stages as jax_merge_stages
from ray_tpu.parallel.pipeline import pipeline_spmd as jax_pipeline_spmd
from ray_tpu.parallel.pipeline import split_stages as jax_split_stages
from ray_tpu_torch.parallel import (MeshSpec, build_mesh, merge_stages,
                                    pipeline_spmd, split_stages)
from ray_tpu_torch.parallel.pipeline import gpipe_ticks

PP = 4


def _meshes():
    return (jax_build_mesh(JaxMeshSpec(pp=PP), devices=jax.devices()[:PP]),
            build_mesh(MeshSpec(pp=PP), devices=["cpu"] * PP))


def _jax_stage(stage_w, x):
    def body(x, w):
        return jnp.tanh(x @ w), None
    x, _ = jax.lax.scan(body, x, stage_w)
    return x


def _stage(stage_w, x):
    for w in stage_w:
        x = torch.tanh(x @ w)
    return x


def _weights(L, D, B):
    Ws = jax.random.normal(jax.random.key(0), (L, D, D)) * 0.1
    x = jax.random.normal(jax.random.key(1), (B, D))
    return Ws, x


def test_pipeline_matches_jax_and_sequential():
    """pp=4 with 6 microbatches: the port's pipeline against JAX's and
    against the stages applied in sequence."""
    jmesh, mesh = _meshes()
    Ws, x = _weights(8, 16, 12)
    want = np.asarray(jax.jit(lambda sp, x: jax_pipeline_spmd(
        _jax_stage, sp, x, mesh=jmesh, num_microbatches=6))(
            jax_split_stages(Ws, PP), x))
    tw, tx = torch.from_numpy(np.array(Ws)), torch.from_numpy(np.array(x))
    got = pipeline_spmd(_stage, split_stages(tw, PP), tx, mesh=mesh,
                        num_microbatches=6)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), _stage(tw, tx).numpy(),
                               atol=1e-5)


def test_pipeline_gradients_match_jax():
    """pp=4 with 4 microbatches: autograd through the pipeline against
    jax.grad through JAX's."""
    jmesh, mesh = _meshes()
    Ws, x = _weights(4, 8, 8)

    def jloss(sp):
        return jnp.sum(jax_pipeline_spmd(_jax_stage, sp, x, mesh=jmesh,
                                         num_microbatches=4) ** 2)
    want = np.asarray(jax_merge_stages(
        jax.jit(jax.grad(jloss))(jax_split_stages(Ws, PP))))
    tw = torch.from_numpy(np.array(Ws)).requires_grad_()
    out = pipeline_spmd(_stage, split_stages(tw, PP),
                        torch.from_numpy(np.array(x)), mesh=mesh,
                        num_microbatches=4)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(tw.grad.numpy(), want, atol=1e-4)


def test_split_and_merge_stages_round_trip_as_views():
    Ws, _ = _weights(8, 4, 1)
    tw = torch.from_numpy(np.array(Ws))
    stages = {"w": split_stages(tw, PP)}
    assert stages["w"].shape == (PP, 2, 4, 4)
    assert stages["w"].data_ptr() == tw.data_ptr()
    np.testing.assert_array_equal(
        stages["w"].numpy(), np.asarray(jax_split_stages(Ws, PP)))
    back = merge_stages(stages)["w"]
    assert torch.equal(back, tw) and back.data_ptr() == tw.data_ptr()
    with pytest.raises(ValueError, match="not divisible by pp=3"):
        split_stages(tw, 3)


def test_pipeline_rejects_bad_microbatching():
    """JAX's two checks, in its words."""
    _, mesh = _meshes()
    Ws = split_stages(torch.zeros(4, 4, 4), PP)

    def apply_stage(w, x):
        return x
    with pytest.raises(ValueError, match="must be >= pp"):
        pipeline_spmd(apply_stage, Ws, torch.zeros(8, 4), mesh=mesh,
                      num_microbatches=2)
    with pytest.raises(ValueError, match="not divisible"):
        pipeline_spmd(apply_stage, Ws, torch.zeros(9, 4), mesh=mesh,
                      num_microbatches=4)


def test_gpipe_schedule_and_pp1():
    """T = mb + pp - 1 ticks, stage s on microbatch t - s, every (stage,
    microbatch) once; at pp=1 the stage is applied directly."""
    ticks = list(gpipe_ticks(3, 2))
    assert ticks == [(0, 0, 0), (1, 0, 1), (1, 1, 0), (2, 0, 2), (2, 1, 1),
                     (3, 1, 2)]
    one = build_mesh(MeshSpec(), devices=["cpu"])
    w = torch.randn(1, 2, 3, 3, generator=torch.Generator().manual_seed(0))
    x = torch.randn(5, 3, generator=torch.Generator().manual_seed(1))
    assert torch.equal(pipeline_spmd(_stage, w, x, mesh=one,
                                     num_microbatches=7), _stage(w[0], x))
