"""Logical-axis sharding rules, and the tensor-parallel split of params.

Port of ray_tpu/parallel/sharding.py. ``LogicalAxisRules`` is a copy: the
same rule table, the same first-match lookup and the same "a mesh axis
shards only one dim of a spec" rule. ``spec`` returns the port's own
``PartitionSpec``, a plain tuple, so a port spec and a JAX spec compare as
tuples. ``tree_specs`` is the counterpart of ``tree_shardings`` and
``replicated`` of the reference's: the port has no ``NamedSharding``, a
spec is applied by ``shard_params``.

``shard_params`` is the port's own. JAX hands a pytree of shardings to
``jax.device_put`` and GSPMD inserts the collectives; the port's mesh is a
single controller (``parallel.mesh.Mesh``: one process launches each
position's work on that position's device), so the split is explicit: each
``tp`` position gets its slice of every tensor whose spec names ``tp``, and
the model runs each position's share of a layer and all-reduces the
partials (``models.transformer.tp_layer``).

Not ported: ``with_logical_constraint`` (a GSPMD layout hint inside a
jitted program, which has no meaning when every tensor already lives where
its position's work runs) and ``shard_batch`` (a dp/fsdp split of the
batch; one controller with only ``tp`` has no batch axis to split). Both
wait for FSDP/TP training on ``torch.distributed.DeviceMesh`` (ROADMAP
Queue 1 item 4).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

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


def tp_dim(spec: PartitionSpec) -> Optional[int]:
    """The dim a spec splits over ``tp``, or None."""
    for i, axes in enumerate(spec):
        if axes == "tp" or (isinstance(axes, tuple) and "tp" in axes):
            return i
    return None


def _zip_trees(a, b, fn):
    if isinstance(a, dict):
        if not isinstance(b, dict) or a.keys() != b.keys():
            raise ValueError(f"params and specs differ in structure: "
                             f"{sorted(a)} vs {b!r}")
        return {k: _zip_trees(a[k], b[k], fn) for k in a}
    return fn(a, b)


def shard_params(params: Dict[str, Any], mesh: Mesh,
                 rules: Optional[LogicalAxisRules] = None,
                 logical_axes=None) -> List[Dict[str, Any]]:
    """Each ``tp`` position's params, in position order.

    ``logical_axes`` is the params' tree of logical-axis tuples (default:
    the transformer's, ``models.transformer.param_logical_axes``). A tensor
    whose spec names ``tp`` on dim d is cut into n equal slices on d, and
    position i gets slice i as a contiguous tensor of its own on its
    device. A tensor whose spec does not name ``tp`` is replicated: held
    once per distinct device (``.to`` returns the tensor itself where it
    already lives, so a device that holds ``params``, or that the mesh
    names several times, holds no copy). Only ``tp`` may be larger than 1
    (``Mesh.axis_devices``)."""
    devices = mesh.axis_devices("tp")
    n = len(devices)
    if logical_axes is None:
        from ..models.transformer import param_logical_axes
        logical_axes = param_logical_axes(None)
    specs = tree_specs(logical_axes, mesh, rules)

    def split(t: torch.Tensor, spec: PartitionSpec) -> List[torch.Tensor]:
        d = tp_dim(spec)
        if d is None or n == 1:
            on = {dev: t.to(dev) for dev in dict.fromkeys(devices)}
            return [on[dev] for dev in devices]
        if t.shape[d] % n:
            raise ValueError(f"a dim of size {t.shape[d]} does not split "
                             f"over tp={n}")
        return [torch.empty(s.shape, dtype=s.dtype, device=dev).copy_(s)
                for s, dev in zip(torch.chunk(t, n, dim=d), devices)]

    per_leaf = _zip_trees(params, specs, split)

    def pick(tree, i):
        if isinstance(tree, dict):
            return {k: pick(v, i) for k, v in tree.items()}
        return tree[i]
    return [pick(per_leaf, i) for i in range(n)]
