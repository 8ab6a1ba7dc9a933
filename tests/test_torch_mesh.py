"""Parity of ray_tpu_torch's device meshes with the JAX package's.

``MeshSpec`` is a copy: its resolution and its ``ValueError`` messages must
be equal word for word. The port's ``Mesh`` is a grid of ``torch.device``
that may name one device more than once; its shape and ``mesh_info`` must
equal JAX's mesh of the same spec on the conftest's 8 CPU devices.
"""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.llm.sequence_parallel import sp_mesh as jax_sp_mesh
from ray_tpu.parallel import AXES as JAX_AXES
from ray_tpu.parallel import MeshSpec as JaxMeshSpec
from ray_tpu.parallel import build_mesh as jax_build_mesh
from ray_tpu.parallel import mesh_info as jax_mesh_info
from ray_tpu.parallel.mesh import EP_AXES as JAX_EP_AXES
from ray_tpu_torch.llm.sequence_parallel import sp_mesh
from ray_tpu_torch.parallel import (AXES, EP_AXES, Mesh, MeshSpec,
                                    build_mesh, host_local_mesh, mesh_info,
                                    single_device_mesh)

CPU = torch.device("cpu")


def _raised(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value), str(info.value)


def test_axes_match_jax():
    assert AXES == JAX_AXES
    assert EP_AXES == JAX_EP_AXES


@pytest.mark.parametrize("spec,n", [
    (dict(dp=-1), 8), (dict(dp=-1, tp=4), 32), (dict(sp=4, dp=2), 8),
    (dict(fsdp=-1, sp=2), 8), (dict(), 1), (dict(pp=2, tp=-1), 6)])
def test_meshspec_resolves_as_jax(spec, n):
    got = MeshSpec(**spec).resolve(n)
    want = JaxMeshSpec(**spec).resolve(n)
    assert got.sizes() == want.sizes()
    assert got.n_devices == want.n_devices == n


@pytest.mark.parametrize("spec,n", [
    (dict(dp=-1, tp=-1), 8),          # two wildcards
    (dict(dp=-1, tp=3), 8),           # not divisible
    (dict(sp=4), 8),                  # wrong total
    (dict(sp=2, tp=2), 3)])
def test_meshspec_errors_match_jax_word_for_word(spec, n):
    got = _raised(lambda: MeshSpec(**spec).resolve(n))
    want = _raised(lambda: JaxMeshSpec(**spec).resolve(n))
    assert got[0] is want[0] is ValueError
    assert got[1] == want[1]


@pytest.mark.parametrize("spec", [dict(dp=-1), dict(sp=4, dp=2),
                                  dict(sp=8), dict(pp=2, fsdp=2, tp=2)])
def test_build_mesh_shape_and_info_match_jax(spec):
    jmesh = jax_build_mesh(JaxMeshSpec(**spec))
    mesh = build_mesh(MeshSpec(**spec), devices=[CPU] * 8)
    assert isinstance(mesh, Mesh)
    assert mesh.shape == dict(jmesh.shape)
    assert list(mesh.shape) == list(jmesh.axis_names) == list(AXES)
    assert mesh_info(mesh) == jax_mesh_info(jmesh)
    assert mesh.devices.shape == jmesh.devices.shape


def test_repeated_devices_are_shard_positions():
    """One device named four times is a 4-way sp mesh over one device."""
    mesh = build_mesh(MeshSpec(sp=4), devices=["cpu"] * 4)
    assert mesh.shape["sp"] == 4
    assert mesh.axis_devices("sp") == [CPU] * 4
    assert mesh.distinct_devices() == [CPU]
    one = single_device_mesh("cpu")
    assert mesh_info(one) == dict.fromkeys(AXES, 1)
    assert one.axis_devices("sp") == [CPU]


@pytest.mark.parametrize("spec", [dict(dp=2, sp=4), dict(tp=2), dict(pp=2),
                                  dict(fsdp=2, sp=2)])
def test_other_axes_than_sp_raise_not_implemented(spec):
    mesh = build_mesh(MeshSpec(**spec),
                      devices=[CPU] * MeshSpec(**spec).n_devices)
    with pytest.raises(NotImplementedError, match="item 4"):
        mesh.axis_devices("sp")


def test_sp_mesh_matches_jax_and_its_error_word_for_word():
    mesh = sp_mesh(4, devices=[CPU] * 8)
    assert mesh_info(mesh) == jax_mesh_info(jax_sp_mesh(4))
    got = _raised(lambda: sp_mesh(16, devices=[CPU] * 8))
    want = _raised(lambda: jax_sp_mesh(16))
    assert got[0] is want[0] is ValueError
    assert got[1] == want[1]


def test_default_devices_are_cuda_and_there_is_no_fallback():
    """Without devices a mesh is over the visible CUDA devices: none here,
    so build_mesh, host_local_mesh, single_device_mesh and sp_mesh raise
    instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_mesh(MeshSpec(sp=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        host_local_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        single_device_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sp_mesh(2)


def test_sp_mesh_with_one_gpu_raises_the_reference_error(monkeypatch):
    """sp_degree=2 on a machine with one GPU: sp_mesh's ValueError, the
    message JAX gives for one visible device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    got = _raised(lambda: sp_mesh(2))
    want = _raised(lambda: jax_sp_mesh(2, devices=jax.devices()[:1]))
    assert got[0] is want[0] is ValueError
    assert got[1] == want[1]


def test_meshes_of_one_shape_are_numpy_grids():
    mesh = build_mesh(MeshSpec(sp=2, dp=2), devices=[CPU] * 4)
    assert isinstance(mesh.devices, np.ndarray)
    assert mesh.devices.dtype == object
    assert all(d == CPU for d in mesh.devices.flat)
