"""Logical-axis sharding rules, and the explicit split of params and
batches over a mesh's positions.

Port of ray_tpu/parallel/sharding.py. ``LogicalAxisRules`` is a copy: the
same rule table, the same first-match lookup and the same "a mesh axis
shards only one dim of a spec" rule. ``spec`` returns the port's own
``PartitionSpec``, a plain tuple, so a port spec and a JAX spec compare as
tuples. ``tree_specs`` is the counterpart of ``tree_shardings`` and
``replicated`` of the reference's: the port has no ``NamedSharding``, a
spec is applied by ``shard_params`` and ``shard_batch``.

JAX hands a pytree of shardings to ``jax.device_put`` and GSPMD inserts the
collectives; the port's mesh is a single controller
(``parallel.mesh.Mesh``: one process launches each position's work on that
position's device), so the split is explicit. ``shard_params`` gives each
position JAX's addressable shard of every tensor: along each dim its spec
splits, the slice that the position's coordinate picks. The model runs
each position's share and moves the partials itself
(``models.transformer``: the tp all-reduce, the fsdp gather, the
vocabulary-parallel cross-entropy). ``gather_params`` is the inverse.

On a mesh over several processes (``Mesh.world`` > 1, one process per GPU,
any axis across ranks) each rank builds only its own positions' shards:
the per-position lists hold None at other ranks' positions, and a rank
never allocates another rank's shard, a tp, sp or pp group's included.
``gather_params`` then all-gathers the full tensors.

``with_logical_constraint`` is not ported: it is a layout hint to GSPMD
inside a jitted program, and here every tensor already lives where its
position's work runs.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from .mesh import EP_AXES, Mesh

MeshAxes = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """Per-dim mesh axes of a tensor (None = not split), trailing Nones
    trimmed: a tuple, as JAX's ``PartitionSpec`` is."""

    def __new__(cls, *axes: MeshAxes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


class LogicalAxisRules:
    """Ordered mapping logical-axis-name → mesh axis (or tuple, or None).

    First matching rule wins; a mesh axis already consumed by an earlier
    dimension of the same spec is skipped (an axis can shard only one dim).
    """

    def __init__(self, rules: Sequence[Tuple[str, MeshAxes]]):
        self.rules: List[Tuple[str, MeshAxes]] = list(rules)

    @classmethod
    def default(cls) -> "LogicalAxisRules":
        """Llama-style decoder rules for a pp×dp×fsdp×sp×tp mesh.

        batch       → dp+fsdp   (data parallel over both DP-ish axes)
        seq         → sp        (sequence/context parallel)
        embed       → fsdp      (ZeRO-3 style weight sharding)
        mlp/heads/kv_heads/vocab → tp  (megatron-style tensor parallel)
        layer/stage → pp        (layer-stack dim stage-sharded)
        expert      → fsdp+sp   (MoE expert parallel submesh)
        """
        return cls([
            ("batch", ("dp", "fsdp")),
            ("layer", "pp"),
            ("seq", "sp"),
            ("embed", "fsdp"),
            ("mlp", "tp"),
            ("heads", "tp"),
            ("kv_heads", "tp"),
            ("qkv", "tp"),
            ("vocab", "tp"),
            ("expert", EP_AXES),
            ("stage", "pp"),
            ("kv", None),
            ("head_dim", None),
            ("norm", None),
        ])

    def with_overrides(self, *overrides: Tuple[str, MeshAxes]):
        return LogicalAxisRules(list(overrides) + self.rules)

    def _lookup(self, name: Optional[str]) -> MeshAxes:
        if name is None:
            return None
        for key, axes in self.rules:
            if key == name:
                return axes
        return None

    def spec(self, logical_axes: Sequence[Optional[str]],
             mesh: Optional[Mesh] = None) -> PartitionSpec:
        used: set = set()
        out: List[MeshAxes] = []
        mesh_sizes = dict(mesh.shape) if mesh is not None else None
        for name in logical_axes:
            axes = self._lookup(name)
            if axes is None:
                out.append(None)
                continue
            if isinstance(axes, str):
                axes = (axes,)
            picked = []
            for ax in axes:
                if ax in used:
                    continue
                # Trivial axes (size 1) are kept — they're no-ops but keep
                # specs stable across mesh shapes.
                if mesh_sizes is not None and ax not in mesh_sizes:
                    continue
                picked.append(ax)
                used.add(ax)
            out.append(tuple(picked) if len(picked) > 1
                       else (picked[0] if picked else None))
        # Trim trailing Nones (canonical PartitionSpec form).
        while out and out[-1] is None:
            out.pop()
        return PartitionSpec(*out)


def _is_axes(v) -> bool:
    """A logical-axis tuple: the leaves of a logical tree."""
    return isinstance(v, tuple) and all(a is None or isinstance(a, str)
                                        for a in v)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_specs(logical_tree, mesh: Mesh,
               rules: Optional[LogicalAxisRules] = None):
    """Map a tree of logical-axis tuples to a tree of PartitionSpecs."""
    rules = rules or LogicalAxisRules.default()

    def spec(axes):
        if not _is_axes(axes):
            raise TypeError(f"not a logical-axis tuple: {axes!r}")
        return rules.spec(axes, mesh)
    return _tree_map(spec, logical_tree)


def replicated(mesh: Mesh) -> PartitionSpec:
    return PartitionSpec()


def axis_dim(spec: PartitionSpec, axis: str) -> Optional[int]:
    """The dim ``spec`` splits over the mesh axis ``axis``, or None."""
    for i, axes in enumerate(spec):
        if axes == axis or (isinstance(axes, tuple) and axis in axes):
            return i
    return None


def _zip_trees(a, b, fn):
    if isinstance(a, dict):
        if not isinstance(b, dict) or a.keys() != b.keys():
            raise ValueError(f"params and specs differ in structure: "
                             f"{sorted(a)} vs {b!r}")
        return {k: _zip_trees(a[k], b[k], fn) for k in a}
    return fn(a, b)


def _dim_axes(spec: PartitionSpec, d: int) -> Tuple[str, ...]:
    axes = spec[d] if d < len(spec) else None
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def shard_slices(spec: PartitionSpec, shape: Sequence[int], mesh: Mesh,
                 coord: Tuple[int, ...]) -> Tuple[slice, ...]:
    """The slice of a tensor of ``shape`` that the position at ``coord``
    (over ``AXES``) holds under ``spec``: along each dim, the piece that
    the coordinate's row-major index over the dim's mesh axes picks, as
    JAX's ``addressable_shards`` place it. A dim that does not divide
    raises ValueError."""
    sizes = mesh.shape
    at = dict(zip(sizes, coord))
    out = []
    for d, dim in enumerate(shape):
        axes = _dim_axes(spec, d)
        n = math.prod(sizes[a] for a in axes)
        if dim % n:
            raise ValueError(f"a dim of size {dim} does not split over "
                             f"{' x '.join(axes)}={n}")
        i = 0
        for a in axes:
            i = i * sizes[a] + at[a]
        size = dim // n
        out.append(slice(i * size, (i + 1) * size))
    return tuple(out)


def shard_tensor(t: torch.Tensor, spec: PartitionSpec,
                 mesh: Mesh) -> List[Optional[torch.Tensor]]:
    """Each position's shard of ``t`` under ``spec``, in grid order (None
    at another process's positions). A shard is held once per distinct
    device: positions that hold the same slice on one device (dp
    replicas, or a dim that is not split) share one tensor. A slice that
    is the whole tensor is ``t.to(device)``, which is ``t`` itself on its
    own device; any other is a contiguous tensor of its own."""
    held: Dict[Any, torch.Tensor] = {}
    out: List[Optional[torch.Tensor]] = []
    for i, (coord, dev) in enumerate(zip(mesh.coords(), mesh.devices.flat)):
        if not mesh.is_local(i):
            out.append(None)
            continue
        sl = shard_slices(spec, t.shape, mesh, coord)
        key = (tuple((s.start, s.stop) for s in sl), dev)
        if key not in held:
            part = t[sl]
            held[key] = (t.to(dev) if part.shape == t.shape else
                         torch.empty(part.shape, dtype=t.dtype,
                                     device=dev).copy_(part))
        out.append(held[key])
    return out


def gather_tensor(parts: Sequence[torch.Tensor], spec: PartitionSpec,
                  mesh: Mesh, device=None) -> torch.Tensor:
    """The inverse of ``shard_tensor``: the full tensor, on ``device``
    (default: the first position's), from each position's shard, each
    element copied once from the first position that holds it."""
    coords = mesh.coords()
    shape = [dim * math.prod(mesh.shape[a] for a in _dim_axes(spec, d))
             for d, dim in enumerate(parts[0].shape)]
    full = torch.empty(shape, dtype=parts[0].dtype,
                       device=device if device is not None
                       else parts[0].device)
    done = set()
    for part, coord in zip(parts, coords):
        sl = shard_slices(spec, shape, mesh, coord)
        key = tuple((s.start, s.stop) for s in sl)
        if key not in done:
            done.add(key)
            full[sl].copy_(part)
    return full


def _specs(mesh, rules, logical_axes):
    if logical_axes is None:
        from ..models.transformer import param_logical_axes
        logical_axes = param_logical_axes(None)
    return tree_specs(logical_axes, mesh, rules)


def _per_position(per_leaf, mesh: Mesh) -> List[Optional[Dict[str, Any]]]:
    def pick(tree, i):
        if isinstance(tree, dict):
            return {k: pick(v, i) for k, v in tree.items()}
        return tree[i]
    return [pick(per_leaf, i) if mesh.is_local(i) else None
            for i in range(mesh.devices.size)]


def shard_params(params: Dict[str, Any], mesh: Mesh,
                 rules: Optional[LogicalAxisRules] = None,
                 logical_axes=None) -> List[Dict[str, Any]]:
    """Each position's params, in grid order (``mesh.coords()``; None at
    another process's positions).

    ``logical_axes`` is the params' tree of logical-axis tuples (default:
    the transformer's, ``models.transformer.param_logical_axes``), mapped
    to specs by ``rules`` (default ``LogicalAxisRules.default()``). Each
    tensor is cut by ``shard_tensor``: a position gets the slice its
    coordinate picks along every dim the spec splits, bit-equal to JAX's
    addressable shard on that position's device, and a shard that several
    positions hold on one device is one tensor (no second copy)."""
    specs = _specs(mesh, rules, logical_axes)
    per_leaf = _zip_trees(params, specs,
                          lambda t, spec: shard_tensor(t, spec, mesh))
    return _per_position(per_leaf, mesh)


def gather_params(shards: Sequence[Dict[str, Any]], mesh: Mesh,
                  rules: Optional[LogicalAxisRules] = None,
                  logical_axes=None, device=None) -> Dict[str, Any]:
    """The inverse of ``shard_params``: full tensors on ``device``
    (default: the first position's), bit for bit. For the tests and for
    checkpoints; a trainer never builds them. On a mesh over several
    processes every rank calls it (a collective) and gets the full
    tensors, gathered leaf by leaf: each rank's positions' parts are
    all-gathered, every part once per position."""
    specs = _specs(mesh, rules, logical_axes)

    def walk(spec, path):
        if isinstance(spec, dict):
            return {k: walk(v, path + (k,)) for k, v in spec.items()}
        parts = []
        for tree in shards:
            for k in path:
                tree = None if tree is None else tree[k]
            parts.append(tree)
        if mesh.world > 1:
            parts = all_gather_parts(parts, mesh)
        return gather_tensor(parts, spec, mesh, device)
    return walk(specs, ())


def all_gather_parts(parts: Sequence[Optional[torch.Tensor]],
                     mesh: Mesh) -> List[torch.Tensor]:
    """Every position's part of one leaf, on this rank's device, from
    each rank's own (``parts`` holds None at other ranks' positions; all
    parts have one shape)."""
    mine = torch.stack([parts[i] for i in mesh.local_positions()])
    out = mine.new_empty((mesh.world * mine.shape[0],) + mine.shape[1:])
    all_gather_single(out, mine, group=mesh.world_group())
    return list(out.unbind(0))


# Named ``*_single`` where torch deprecates the ``*_tensor`` names; older
# torch has only those (the same arguments).
all_gather_single = (getattr(dist, "all_gather_single", None)
                     or dist.all_gather_into_tensor)
reduce_scatter_single = (getattr(dist, "reduce_scatter_single", None)
                         or dist.reduce_scatter_tensor)


def shard_batch(batch, mesh: Mesh,
                rules: Optional[LogicalAxisRules] = None) -> List[Any]:
    """Each position's batch, in grid order: every array's leading dim
    split under ``("batch", None, ...)`` (the default rules: over the dp x
    fsdp batch groups, in the order of JAX's ``("dp", "fsdp")`` axis) and
    0-d values replicated, each on its position's device (one tensor per
    distinct device and slice)."""
    rules = rules or LogicalAxisRules.default()

    def split(x):
        t = torch.as_tensor(x)
        axes = ("batch",) + (None,) * (t.dim() - 1) if t.dim() else ()
        return shard_tensor(t, rules.spec(axes, mesh), mesh)
    if isinstance(batch, dict):
        per_leaf = {k: split(v) for k, v in batch.items()}
        return _per_position(per_leaf, mesh)
    return split(batch)
