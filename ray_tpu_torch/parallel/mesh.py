"""Device meshes with the canonical axis names, driven by one process or by
one process per GPU.

Port of ray_tpu/parallel/mesh.py. ``AXES``, ``EP_AXES`` and ``MeshSpec``
are copies. ``Mesh`` is the port's own: where JAX's ``Mesh`` is a grid of
devices that one process drives through ``shard_map`` and GSPMD, this one
is a grid of ``torch.device``s that one process drives by launching each
position's work on that position's device (the JAX engine's
single-controller model), so a K/V rotation between shards is a
``.to(next_device)``, a tensor-parallel all-reduce a ``.to()`` of each
partial and a sum, and an fsdp gather a ``.to()`` and a ``cat``.

Training splits any of ``pp``, ``dp``, ``fsdp``, ``sp`` and ``tp`` at once
(``models.train_step``): ``coords``, ``stage_positions``,
``batch_groups``, ``group_positions``, ``fsdp_positions`` and
``sp_positions`` give its layout, each stage (the positions with one pp
coordinate) a dp x fsdp x sp x tp layout of its own. Serving
(``serve_axes``) takes any layout too: tp splits the weights and the pool
over heads, pp over the layer stack, sp the prefills' sequence, and the
engine replicates the whole split layout once per distinct placement of
its dp x fsdp coordinates, as the JAX engine's rules replicate the weights
over those axes. It is not ``torch.distributed.DeviceMesh``.

A mesh built where a ``torch.distributed`` world is formed (the Train
backend, ``train.backend``, forms one) covers every rank's positions:
position i belongs to rank ``i // (n / world)`` (``process_index``), the
counterpart of JAX's global ``jax.devices()`` with their
``process_index``. Each rank holds only its own positions
(``local_positions``) on its own card; the grid names no device for
another rank's positions (None). Training takes every axis across ranks:
a dp or fsdp group, and a tp, sp or pp group too, whose exchanges (the
in-layer all-reduce, the ring or the gathered sequence, the stage
hand-off) then run over ``torch.distributed`` between the ranks that hold
its positions (``axis_positions``, ``axis_group``), as do the
free-standing ring and Ulysses attention, ``pipeline_spmd`` and the
expert-parallel MoE layer. Serving stays single-controller, as the JAX
engine is.

A grid may name one device more than once: a shard is a position in the
mesh, not a device. ``build_mesh(MeshSpec(sp=4), devices=[cuda:0] * 4)``
runs a 4-way sequence-parallel pass whose shards take turns on one card,
and ``[cpu] * 4`` does the same on the CPU, where torch has one device
(JAX's tests get eight virtual CPU devices instead).

``build_mesh``'s ``allow_split_physical_axes`` has no counterpart: it
places logical axes on a TPU's interconnect topology.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

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
    ``Mesh.shape`` does; ``devices`` is the grid. Over a formed world of
    ``world`` processes this process is ``rank``, the grid holds None at
    the other ranks' positions, and ``group`` gives the process group of
    a set of ranks (every set that the positions along some axes span is
    made when the mesh is built, in the same order on every rank, as
    ``torch.distributed.new_group`` requires)."""

    def __init__(self, devices: np.ndarray, world: int = 1, rank: int = 0,
                 formed: bool = False):
        if devices.ndim != len(AXES):
            raise ValueError(f"a mesh grid has {len(AXES)} axes {AXES}, "
                             f"got shape {devices.shape}")
        if devices.size % world:
            raise ValueError(f"{devices.size} positions do not split over "
                             f"{world} processes")
        self.devices = devices
        self.world, self.rank = world, rank
        # None: driven by one process with no world formed, so nothing
        # runs a collective.
        self._groups: Optional[Dict[Tuple[int, ...], object]] = None
        if formed:
            self._groups = {}
            lines = set()
            for fixed in itertools.product((False, True), repeat=len(AXES)):
                by_key: Dict[tuple, set] = {}
                for i, c in enumerate(np.ndindex(devices.shape)):
                    key = tuple(x for x, f in zip(c, fixed) if f)
                    by_key.setdefault(key, set()).add(self.process_index(i))
                lines.update(tuple(sorted(r)) for r in by_key.values()
                             if 1 < len(r) < world)
            for ranks in sorted(lines):
                self._groups[ranks] = dist.new_group(list(ranks))

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXES, self.devices.shape))

    def distinct_devices(self) -> List[torch.device]:
        """Each device of the grid once, in grid order."""
        return list(dict.fromkeys(self.devices.flat))

    # -- processes --------------------------------------------------------

    def process_index(self, i: int) -> int:
        """The rank that holds position ``i``: the positions split into
        ``world`` equal runs in grid order."""
        return i // (self.devices.size // self.world)

    def local_positions(self) -> List[int]:
        """The flat indices of this process's positions, in grid order."""
        per = self.devices.size // self.world
        return list(range(self.rank * per, (self.rank + 1) * per))

    def is_local(self, i: int) -> bool:
        return self.process_index(i) == self.rank

    def ranks(self, positions) -> Tuple[int, ...]:
        """The ranks that hold ``positions``, sorted."""
        return tuple(sorted({self.process_index(i) for i in positions}))

    def group(self, ranks: Tuple[int, ...]):
        """The process group of ``ranks`` (sorted, this rank among them):
        None where there is nothing to reduce over (one rank, or no
        world), the world's group where it is every rank."""
        if self._groups is None or len(ranks) < 2:
            return None
        if len(ranks) == self.world:
            return dist.group.WORLD
        return self._groups[ranks]

    def covering(self, ranks) -> Tuple[int, ...]:
        """The fewest ranks, among the sets the mesh made a process group
        for and the whole world, that include ``ranks``."""
        want = set(ranks)
        sets = list(self._groups or ()) + [tuple(range(self.world))]
        return min((s for s in sets if want <= set(s)), key=len)

    def world_group(self):
        """The world's group where the mesh spans a formed world (a world
        of one too), else None: the group over which a step sums its loss
        and its gradients' squares."""
        return dist.group.WORLD if self._groups is not None else None

    def axis_positions(self, i: int, axis: str) -> List[int]:
        """The flat indices of the positions that share position ``i``'s
        coordinate on every axis but ``axis``, in ``axis`` order: ``i``'s
        tp, sp or stage neighbours, ``i`` among them."""
        at = list(np.unravel_index(i, self.devices.shape))
        k = AXES.index(axis)
        out = []
        for x in range(self.devices.shape[k]):
            at[k] = x
            out.append(int(np.ravel_multi_index(at, self.devices.shape)))
        return out

    def axis_group(self, i: int, axis: str):
        """The process group of the ranks that hold ``i``'s neighbours
        along ``axis`` (``group``: None where one rank holds them all)."""
        return self.group(self.ranks(self.axis_positions(i, axis)))

    def serve_axes(self) -> Tuple[str, ...]:
        """The axes larger than 1 of a serving layout, in ``AXES`` order:
        any of them (see the module docstring). A mesh over several
        processes raises NotImplementedError: the engine runs every
        position from one process, as the JAX engine's single controller
        does."""
        if self.world > 1:
            raise NotImplementedError(
                f"serving on a mesh over {self.world} processes is not "
                f"ported: it runs every position from one process")
        return tuple(a for a, s in self.shape.items() if s > 1)

    # -- the training layout ---------------------------------------------

    def train_axes(self) -> Tuple[str, ...]:
        """The axes larger than 1 of a training layout, in ``AXES`` order:
        any of pp, dp, fsdp, sp and tp. Over several processes any of
        them may span ranks, under three rules, each a ValueError:

        - every rank that holds positions of a pp, fsdp, sp or tp group
          holds as many of them as each other rank that does;
        - a rank that holds whole batch groups (their sp x tp positions)
          holds a whole number of fsdp groups' batch groups, or an fsdp
          group's are a whole number of ranks' (so the ranks that gather
          one weight run their groups in step);
        - where a tp, sp or pp group spans ranks, a rank's positions share
          one device (its card): the group's exchanges run between ranks,
          one copy of each activation a rank."""
        split = tuple(a for a, s in self.shape.items() if s > 1)
        if self.world > 1:
            sz = self.shape
            crossed = False
            for axis in ("pp", "fsdp", "sp", "tp"):
                for line in self._lines(axis):
                    held = collections.Counter(self.process_index(i)
                                               for i in line)
                    if len(set(held.values())) > 1:
                        raise ValueError(
                            f"a {axis} group of {sz[axis]} positions "
                            f"splits unevenly over ranks (positions a "
                            f"rank: {dict(held)})")
                    crossed |= axis != "fsdp" and len(held) > 1
            per = self.devices.size // self.world
            groups = per // (sz["sp"] * sz["tp"])
            if groups and groups % sz["fsdp"] and sz["fsdp"] % groups:
                raise ValueError(
                    f"{groups} batch groups a rank split an fsdp group of "
                    f"{sz['fsdp']} unevenly over ranks")
            local = {self.devices.flat[i] for i in self.local_positions()}
            if crossed and len(local) > 1:
                raise ValueError(
                    f"a tp, sp or pp group spans ranks, and this rank's "
                    f"positions lie on {len(local)} devices: a rank's "
                    f"positions must share one")
        return split

    def _lines(self, axis: str) -> List[List[int]]:
        """Every group of positions along ``axis`` (``axis_positions`` of
        each position at coordinate 0 there)."""
        k = AXES.index(axis)
        return [self.axis_positions(i, axis)
                for i, c in enumerate(np.ndindex(self.devices.shape))
                if c[k] == 0]

    def coords(self) -> List[Tuple[int, ...]]:
        """Each position's coordinate over ``AXES``, in grid order (the
        order of ``devices.flat``)."""
        return list(np.ndindex(self.devices.shape))

    def _index(self, **coord: int) -> int:
        at = tuple(coord.get(a, 0) for a in AXES)
        return int(np.ravel_multi_index(at, self.devices.shape))

    def stage_positions(self, stage: int) -> List[int]:
        """The flat indices of pipeline stage ``stage``'s positions (those
        with pp == stage), in grid order: a dp x fsdp x sp x tp layout of
        their own, which holds the stage's layers."""
        return [i for i, c in enumerate(self.coords()) if c[0] == stage]

    def batch_axes(self, rules=None) -> Tuple[str, ...]:
        """The axes among dp and fsdp over which ``rules`` (a
        ``sharding.LogicalAxisRules``; default its ``default()``,
        ``("dp", "fsdp")``) split the batch's leading dim, in the table's
        order. An axis of the batch's spec other than dp and fsdp splits
        no batch group of the sharded model: it carries that model's
        sequence shards, heads or stages."""
        if rules is None:
            return ("dp", "fsdp")
        spec = rules.spec(("batch",), self)
        axes = spec[0] if spec else None
        axes = (() if axes is None else (axes,) if isinstance(axes, str)
                else tuple(axes))
        return tuple(a for a in axes if a in ("dp", "fsdp"))

    def batch_groups(self, rules=None) -> List[Tuple[int, int]]:
        """One (dp, fsdp) pair per batch group, in the order of the batch
        axis that ``rules`` give the batch (``batch_axes``; by default
        JAX's ``("dp", "fsdp")``): group g holds the g-th equal slice of
        the batch's leading dim. An axis of dp and fsdp that the table
        does not split the batch over has coordinate 0 in every pair: its
        other positions would compute the same groups again, so they only
        hold their slices of the params (``("batch", "dp")`` gives dp
        groups, each a whole fsdp group's batch). Every stage has the same
        groups. Over several processes a rank may hold no group (the
        fsdp > 0 ranks under ``("batch", "dp")`` one position a rank): it
        still takes part in the collectives that read its slices
        (``models.transformer._Layout``)."""
        self.train_axes()
        axes = self.batch_axes(rules)
        out = []
        for at in itertools.product(*(range(self.shape[a]) for a in axes)):
            c = dict(zip(axes, at))
            out.append((c.get("dp", 0), c.get("fsdp", 0)))
        return out

    def sequence_shards(self, rules=None) -> int:
        """How many sequence shards a batch group splits into: the sp
        axis where ``rules`` (default: the default table's ``("seq",
        "sp")``) split the sequence over sp, else 1, the sp positions
        past the first then holding only their slices of the params (over
        several processes, a rank of them computes nothing)."""
        if rules is not None:
            spec = rules.spec(("seq",), self)
            axes = spec[0] if spec else None
            if axes != "sp" and "sp" not in (axes or ()):
                return 1
        return self.shape["sp"]

    def group_positions(self, dp: int, fsdp: int, stage: int = 0,
                        sp: int = 0) -> List[int]:
        """The flat indices of a batch group's tp positions in pipeline
        stage ``stage`` at sequence shard ``sp``, in tp order."""
        return [self._index(pp=stage, dp=dp, fsdp=fsdp, sp=sp, tp=t)
                for t in range(self.shape["tp"])]

    def fsdp_positions(self, dp: int, tp: int, stage: int = 0,
                       sp: int = 0) -> List[int]:
        """The flat indices of the positions of pipeline stage ``stage``
        that share a (dp, sp, tp) coordinate, in fsdp order: between them
        they hold every embed-dim slice of that tp slice."""
        return [self._index(pp=stage, dp=dp, fsdp=f, sp=sp, tp=tp)
                for f in range(self.shape["fsdp"])]

    def sp_positions(self, dp: int = 0, fsdp: int = 0, tp: int = 0,
                     stage: int = 0) -> List[int]:
        """The flat indices of the positions that share a (stage, dp,
        fsdp, tp) coordinate, in sp order: between them they hold every
        sequence shard of that batch group's tp slice."""
        return [self._index(pp=stage, dp=dp, fsdp=fsdp, sp=j, tp=tp)
                for j in range(self.shape["sp"])]


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
    machine with one GPU runs a sequence-parallel engine.

    Where a ``torch.distributed`` world is formed, the mesh spans every
    rank (see the module docstring) and ``devices`` lists this rank's
    positions' devices, the same count on every rank (default: this
    rank's current CUDA device under an NCCL world, the CPU under a gloo
    one, once per position the rank holds, and once where ``spec`` has a
    -1 axis)."""
    spec = spec or MeshSpec(dp=-1)
    if not (dist.is_available() and dist.is_initialized()):
        devices = [_device(d) for d in (devices if devices is not None
                                        else _cuda_devices())]
        spec = spec.resolve(len(devices))
        return Mesh(_grid(devices, spec))
    world, rank = dist.get_world_size(), dist.get_rank()
    if devices is None:
        wild = any(s == -1 for s in spec.sizes().values())
        per = 1 if wild else spec.n_devices // world
        devices = [_rank_device()] * per
    devices = [_device(d) for d in devices]
    spec = spec.resolve(len(devices) * world)
    per = len(devices)
    everyone = [None] * (per * world)
    everyone[rank * per:(rank + 1) * per] = devices
    return Mesh(_grid(everyone, spec), world=world, rank=rank, formed=True)


def _grid(devices, spec: MeshSpec) -> np.ndarray:
    shape = tuple(spec.sizes()[a] for a in AXES)
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return grid.reshape(shape)


def _rank_device() -> torch.device:
    """This rank's device in a formed world: its current CUDA device
    under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return _device("cuda")
    return torch.device("cpu")


def single_device_mesh(device: Union[str, torch.device] = "cuda") -> Mesh:
    """1-device mesh: every axis size 1."""
    return build_mesh(MeshSpec(), devices=[device])


def host_local_mesh(spec: Optional[MeshSpec] = None) -> Mesh:
    """Mesh over this host's visible CUDA devices."""
    return build_mesh(spec, devices=_cuda_devices())


def mesh_info(mesh: Mesh) -> Dict[str, int]:
    return {name: size for name, size in mesh.shape.items()}
