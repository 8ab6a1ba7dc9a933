"""Device meshes with the canonical axis names, for one controlling process.

Port of ray_tpu/parallel/mesh.py. ``AXES``, ``EP_AXES`` and ``MeshSpec``
are copies. ``Mesh`` is the port's own: where JAX's ``Mesh`` is a grid of
devices that one process drives through ``shard_map``, this one is a grid
of ``torch.device``s that one process drives by launching each shard's
work on that shard's device (the JAX engine's single-controller model), so
a K/V rotation between shards is a ``.to(next_device)``. It is not
``torch.distributed.DeviceMesh``, which needs one process per GPU; that
comes with FSDP/TP training (ROADMAP Queue 1 item 4), built from the same
``MeshSpec``.

A grid may name one device more than once: a shard is a position in the
mesh, not a device. ``build_mesh(MeshSpec(sp=4), devices=[cuda:0] * 4)``
runs a 4-way sequence-parallel pass whose shards take turns on one card,
and ``[cpu] * 4`` does the same on the CPU, where torch has one device
(JAX's tests get eight virtual CPU devices instead).

``build_mesh``'s ``allow_split_physical_axes`` has no counterpart: it
places logical axes on a TPU's interconnect topology.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .._device import resolve_device

AXES = ("pp", "dp", "fsdp", "sp", "tp")
# Expert parallelism reuses the fsdp x sp submesh in MoE layers (same
# devices, another logical view).
EP_AXES: Tuple[str, str] = ("fsdp", "sp")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape.  -1 at most once = "fill with what's left".

    Example: MeshSpec(dp=-1, tp=4) on 32 chips → pp=1 dp=8 fsdp=1 sp=1 tp=4.
    """
    pp: int = 1
    dp: int = 1
    fsdp: int = 1
    sp: int = 1
    tp: int = 1

    def sizes(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in AXES}

    def resolve(self, n_devices: int) -> "MeshSpec":
        sizes = self.sizes()
        wild = [a for a, s in sizes.items() if s == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one axis may be -1, got {wild}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wild:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"product {fixed}")
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {fixed} devices, have {n_devices}")
        return MeshSpec(**sizes)

    @property
    def n_devices(self) -> int:
        return math.prod(self.sizes().values())


class Mesh:
    """An ``np.ndarray`` of ``torch.device`` shaped by ``AXES``.

    ``shape`` maps each axis name to its size, in ``AXES`` order, as JAX's
    ``Mesh.shape`` does; ``devices`` is the grid."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != len(AXES):
            raise ValueError(f"a mesh grid has {len(AXES)} axes {AXES}, "
                             f"got shape {devices.shape}")
        self.devices = devices

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXES, self.devices.shape))

    def distinct_devices(self) -> List[torch.device]:
        """Each device of the grid once, in grid order."""
        return list(dict.fromkeys(self.devices.flat))

    def axis_devices(self, axis_name: str = "sp") -> List[torch.device]:
        """The devices of ``axis_name``'s positions, in order. Every other
        axis must be 1: the port splits only that axis, and placing batch
        or heads over another axis (dp/fsdp/tp, ROADMAP Queue 1 item 4) or
        layers over pp (item 7) is not ported. A value-preserving layout
        that left those devices idle would hide it, so it raises."""
        other = {a: s for a, s in self.shape.items()
                 if a != axis_name and s > 1}
        if other:
            raise NotImplementedError(
                f"mesh axes {other} are not ported: the port splits only "
                f"the {axis_name!r} axis (dp/fsdp/tp meshes are ROADMAP "
                f"Queue 1 item 4, pp item 7)")
        return list(self.devices.reshape(-1))


def _device(d: Union[str, torch.device]) -> torch.device:
    """``d`` as a torch.device; a CUDA device without an index gets the
    current one, so that a grid of ``"cuda"`` and ``"cuda:0"`` is one
    device."""
    d = resolve_device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _cuda_devices() -> List[torch.device]:
    """The visible CUDA devices; raises where there is none."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def build_mesh(spec: Optional[MeshSpec] = None, *,
               devices: Optional[Sequence[Union[str, torch.device]]] = None
               ) -> Mesh:
    """A ``Mesh`` over ``devices`` (default: every visible CUDA device,
    raising where there is none) in ``AXES`` order, the grid a plain
    reshape of the list.

    ``devices`` may repeat a device. The mesh is driven by one process
    that launches each shard's work on that shard's device, so several
    positions can share one device and take turns on it: that is how the
    CPU tests run a 4-way mesh on torch's one CPU device, and how a
    machine with one GPU runs a sequence-parallel engine."""
    devices = [_device(d) for d in (devices if devices is not None
                                    else _cuda_devices())]
    spec = (spec or MeshSpec(dp=-1)).resolve(len(devices))
    shape = tuple(spec.sizes()[a] for a in AXES)
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape))


def single_device_mesh(device: Union[str, torch.device] = "cuda") -> Mesh:
    """1-device mesh: every axis size 1."""
    return build_mesh(MeshSpec(), devices=[device])


def host_local_mesh(spec: Optional[MeshSpec] = None) -> Mesh:
    """Mesh over this host's visible CUDA devices."""
    return build_mesh(spec, devices=_cuda_devices())


def mesh_info(mesh: Mesh) -> Dict[str, int]:
    return {name: size for name, size in mesh.shape.items()}
