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
    assert [mesh.devices.flat[i] for i in mesh.sp_positions()] == [CPU] * 4
    assert mesh.distinct_devices() == [CPU]
    one = single_device_mesh("cpu")
    assert mesh_info(one) == dict.fromkeys(AXES, 1)
    assert one.sp_positions() == [0] and one.serve_axes() == ()
    sptp = build_mesh(MeshSpec(sp=2, tp=2), devices=[CPU] * 4)
    assert sptp.serve_axes() == ("sp", "tp")
    assert sptp.sp_positions(tp=1) == [1, 3]


@pytest.mark.parametrize("spec", [dict(dp=2, sp=4), dict(sp=2, tp=2),
                                  dict(pp=2), dict(fsdp=2, sp=2)])
def test_other_axes_than_sp_raise_not_implemented(spec):
    """sp beside another split axis is a training layout: its batch
    groups, and each (group, tp) coordinate's sp positions in sp order.
    For serving every one of these is a layout of the engine (dp or fsdp
    beside sp: replicas of an sp group)."""
    mesh = build_mesh(MeshSpec(**spec),
                      devices=[CPU] * MeshSpec(**spec).n_devices)
    split = tuple(a for a in AXES if spec.get(a, 1) > 1)
    assert mesh.train_axes() == split
    assert mesh.serve_axes() == split
    if "pp" in spec:
        assert mesh.batch_groups() == [(0, 0)]
        assert [mesh.stage_positions(s) for s in range(2)] == [[0], [1]]
        assert mesh.group_positions(0, 0, stage=1) == [1]
        assert mesh.fsdp_positions(0, 0, stage=1) == [1]
        assert mesh.sp_positions(stage=1) == [1]
        return
    coords = mesh.coords()
    sp = spec["sp"]
    assert [mesh.devices.flat[i] for i in mesh.sp_positions()] == [CPU] * sp
    for d, f in mesh.batch_groups():
        for t in range(spec.get("tp", 1)):
            got = [coords[i] for i in mesh.sp_positions(d, f, t)]
            assert got == [(0, d, f, j, t) for j in range(sp)]
            for j in range(sp):
                assert [coords[i] for i in mesh.group_positions(
                    d, f, sp=j)][t] == (0, d, f, j, t)
    assert len(mesh.batch_groups()) == (spec.get("dp", 1)
                                        * spec.get("fsdp", 1))


@pytest.mark.parametrize("spec,axis", [(dict(sp=4), "sp"),
                                       (dict(tp=2), "tp"), (dict(), None)])
def test_a_mesh_splits_sp_or_tp_alone(spec, axis):
    """For serving, a tp mesh's positions are its devices, as an sp mesh's
    are; dp alone is a serving layout too (replicas, one per distinct
    device). dp is also a training axis: its positions are batch groups.
    sp and tp together serve, and dp beside tp (replicas of a tp
    group)."""
    n = MeshSpec(**spec).n_devices
    mesh = build_mesh(MeshSpec(**spec), devices=[CPU] * n)
    assert mesh.serve_axes() == ((axis,) if axis else ())
    assert list(mesh.devices.flat) == [CPU] * n
    assert mesh.sp_positions() == (list(range(n)) if axis == "sp" else [0])
    dp2 = build_mesh(MeshSpec(dp=2), devices=[CPU] * 2)
    assert dp2.distinct_devices() == [CPU]
    assert dp2.serve_axes() == ("dp",)
    assert dp2.train_axes() == ("dp",)
    assert dp2.batch_groups() == [(0, 0), (1, 0)]
    assert build_mesh(MeshSpec(sp=2, tp=2),
                      devices=[CPU] * 4).serve_axes() == ("sp", "tp")
    assert build_mesh(MeshSpec(dp=2, tp=2),
                      devices=[CPU] * 4).serve_axes() == ("dp", "tp")


@pytest.mark.parametrize("spec", [dict(dp=2, fsdp=2, tp=2), dict(fsdp=8),
                                  dict(dp=2, tp=4), dict(fsdp=2, tp=4),
                                  dict(dp=2, sp=2, tp=2),
                                  dict(fsdp=2, sp=2, tp=2)])
def test_training_layout_follows_jax_device_order(spec):
    """A position's coordinate is that of JAX's device at the same place of
    the same mesh; batch groups follow JAX's ("dp", "fsdp") batch axis, the
    order in which shard_batch hands out the leading dim; a group's tp
    positions and a (dp, tp) slice's fsdp positions are the grid's."""
    jmesh = jax_build_mesh(JaxMeshSpec(**spec))
    mesh = build_mesh(MeshSpec(**spec), devices=[CPU] * 8)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    coords = mesh.coords()
    assert len(coords) == 8
    for i, c in enumerate(coords):
        assert ids[c] == ids.flat[i]
    s = mesh.shape
    assert mesh.batch_groups() == [(d, f) for d in range(s["dp"])
                                   for f in range(s["fsdp"])]
    for d, f in mesh.batch_groups():
        got = [coords[i] for i in mesh.group_positions(d, f)]
        assert got == [(0, d, f, 0, t) for t in range(s["tp"])]
        for t in range(s["tp"]):
            got = [coords[i] for i in mesh.fsdp_positions(d, t)]
            assert got == [(0, d, g, 0, t) for g in range(s["fsdp"])]
            got = [coords[i] for i in mesh.sp_positions(d, f, t)]
            assert got == [(0, d, f, j, t) for j in range(s["sp"])]


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
