"""Training step: loss, backward, clipped AdamW, in place, on one device or
on a mesh's positions.

Port of ray_tpu/models/train_step.py. ``make_optimizer`` is the port's own
copy of the optax chain the reference builds (no optax import):
clip-by-global-norm, then AdamW with weight decay on every param, scaled by
a warmup-cosine schedule whose count starts at 0, so the first update has
learning rate 0.

The train state is ``{"params", "opt_state": {"count", "mu", "nu",
"schedule_count"}, "step"}`` with params, ``mu`` and ``nu`` in the JAX
layouts and dtypes, so ``from_jax_state`` is a plain copy. Where JAX
donates the state to its jitted step, the step here updates it in place.

Two things keep an 8B model's state (params, grads, mu, nu: 64 GB in bf16)
inside one 80 GB card:

- autograd sees one leaf per layer: ``stack[i].detach().requires_grad_()``
  views share the stacked (L, ...) storage, so each layer's gradient is
  its own tensor. Indexing a stacked leaf would give every layer's
  backward a zero tensor the size of the whole stack.
- the optimizer runs tensor by tensor with in-place ops, so its
  temporaries are the size of one tensor, not of the model.

Under a mesh (``parallel.mesh.Mesh``, any of pp, dp, fsdp, sp and tp)
params, ``mu`` and ``nu`` are lists of per-position trees
(``parallel.sharding.shard_params`` under ``rules``; ``state_specs`` holds
their specs), each shard held once per distinct device. A step runs the
batch groups' forward and backward in turn
(``transformer.mesh_group_losses``), the single-controller counterpart of
each data-parallel rank's own backward. A shard's gradients from its
replicas (the positions that hold the same slice: dp replicas, and the
sp positions, each of which runs its own sequence shard with its own
copy) meet in its one tensor, where autograd's accumulation sums them in
batch-group and shard order, or, for replicas on distinct devices, in an
explicit all-reduce in position order. The global norm counts each element of the logical array once,
and the clip and AdamW run once per distinct shard, whose replicas then
take its values.

Under a pp axis a position's layer tensors hold its stage's L/pp layers
(the default rules split the layer stack over pp), and a group's forward
runs its ``num_microbatches`` through the pipeline's stages
(``transformer.mesh_group_losses``). The top-level tensors are replicas
across the stages: stage 0 takes the embedding's gradient and the last
stage ``ln_f``'s and ``lm_head``'s, and the replicas that took none get
the sum like any other replica. As in the JAX package,
``num_microbatches`` is ignored without a pp axis.

On a mesh over several processes (one per GPU; any axis across ranks,
``parallel.mesh``) each rank calls the same step with the whole batch and
holds only its own positions' shards (None at the others'). It runs its
own positions; a weight's fsdp slices on other ranks come through the
model's all-gather, whose backward reduce-scatters their gradients, and
a tp, sp or pp group's exchanges run between its ranks
(``models.transformer``). A replica class (one slice) that other ranks
also hold is summed locally first, then all-reduced over the process
group of the ranks that hold it: dp and sp copies, a tensor replicated
over tp (each rank's partial gradient), the top-level tensors of the
stages. The global norm counts each slice once, on the lowest rank that holds
it, its squares summed over the world; the loss is summed over the world,
so every rank reports the same loss and grad norm. Each rank updates its
own shards: replicas on other ranks take identical updates from identical
gradients.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from ..parallel.sharding import (LogicalAxisRules, PartitionSpec,
                                 shard_params, shard_slices, tree_specs)
from .transformer import (TransformerConfig, from_jax_params, init_params,
                          loss_fn, mesh_group_losses, mesh_rules,
                          param_logical_axes, param_shapes, world_sum)

_TOP = ("embed", "ln_f", "lm_head")
# optax.adamw's default eps, which the reference's make_optimizer keeps (its
# eps_root is 0, so the root of the second moment takes no offset).
_EPS = 1e-8


def _layer_paths(node, prefix=()) -> List[Tuple[str, ...]]:
    if isinstance(node, dict):
        return [p for k in sorted(node) for p in _layer_paths(node[k],
                                                              prefix + (k,))]
    return [prefix]


def _get(node, path):
    for k in path:
        node = node[k]
    return node


def _pieces(tree, num_layers: int) -> List[torch.Tensor]:
    """The tensors of a params-shaped tree (params, mu, nu), with each
    stacked (L, ...) layer tensor cut into its L per-layer views, in a
    fixed order."""
    layers = tree["layers"]
    paths = _layer_paths(layers)
    return ([tree[k] for k in _TOP]
            + [_get(layers, p)[i] for i in range(num_layers) for p in paths])


def _assemble(pieces: List[torch.Tensor], like: Dict[str, Any],
              num_layers: int) -> Dict[str, Any]:
    """The inverse of ``_pieces``: a params tree whose "layers" is a list
    of per-layer dicts, which ``transformer.layer_params`` accepts."""
    out = dict(zip(_TOP, pieces))
    paths = _layer_paths(like["layers"])
    rest = iter(pieces[len(_TOP):])
    layers = []
    for _ in range(num_layers):
        layer: Dict[str, Any] = {}
        for p in paths:
            node = layer
            for k in p[:-1]:
                node = node.setdefault(k, {})
            node[p[-1]] = next(rest)
        layers.append(layer)
    out["layers"] = layers
    return out


def _leaves(tree):
    if isinstance(tree, (dict, list, tuple)):
        for node in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(node)
    else:
        yield tree


def global_norm(tree, group=None, device=None) -> torch.Tensor:
    """optax.global_norm: the square root of the sum of squares of every
    element of every tensor in ``tree`` (nested dicts and lists), an f32
    0-d tensor on the first tensor's device (the tensors may lie on
    several). ``group``: ``tree`` is this rank's share of the tensors
    (maybe none, then on ``device``), and the squares are summed over the
    ranks of ``group``."""
    norms = [torch.linalg.vector_norm(t, dtype=torch.float32)
             for t in _leaves(tree)]
    total = (torch.linalg.vector_norm(torch.stack(
        [n.to(norms[0].device) for n in norms])) if norms
        else torch.zeros((), device=device))
    if group is None:
        return total
    square = total.square()
    dist.all_reduce(square, group=group)
    return square.sqrt()


def _backward(params, batch, cfg: TransformerConfig, device):
    """(loss, leaves): the loss, and one leaf per tensor of ``_pieces``
    sharing its storage, each holding its gradient in ``.grad``."""
    leaves = [p.detach().requires_grad_()
              for p in _pieces(params, cfg.num_layers)]
    loss = loss_fn(_assemble(leaves, params, cfg.num_layers), batch, cfg,
                   device=device)
    loss.backward()
    return loss.detach(), leaves


class _MeshLayout:
    """A sharded state's layout on ``mesh`` under ``rules``: per stacked
    tensor of the params (``_paths``), its replica classes, one per
    distinct slice, each the positions that hold that slice on distinct
    devices, the first of each device in position order (positions that
    share a device share the tensor), and the ranks that hold the slice.
    Over several processes only the classes this rank holds, with its
    own positions, in the same order on every rank."""

    def __init__(self, cfg: TransformerConfig, mesh, rules):
        self.mesh, self.rules = mesh, rules
        self.specs = tree_specs(param_logical_axes(cfg), mesh, rules)
        shapes = param_shapes(cfg)
        self.classes: List[Tuple[Tuple[str, ...], List[int],
                                 Tuple[int, ...]]] = []
        for path in _paths(shapes):
            spec, (shape, _) = _get(self.specs, path), _get(shapes, path)
            by_slice: Dict[Any, List[int]] = {}
            for i, coord in enumerate(mesh.coords()):
                key = tuple((s.start, s.stop) for s in
                            shard_slices(spec, shape, mesh, coord))
                by_slice.setdefault(key, []).append(i)
            for held in by_slice.values():
                devs: Dict[Any, int] = {}
                for i in held:
                    if mesh.is_local(i):
                        devs.setdefault(mesh.devices.flat[i], i)
                if devs:
                    self.classes.append((path, list(devs.values()),
                                         mesh.ranks(held)))


def _paths(tree) -> List[Tuple[str, ...]]:
    """The stacked tensors' paths of a params-shaped tree, in ``_pieces``'
    order of kinds."""
    return [(k,) for k in _TOP] + [("layers",) + p
                                   for p in _layer_paths(tree["layers"])]


def _views(t: torch.Tensor, path):
    """The per-layer views of a stacked layer tensor (a position's own
    layers: L/pp of them under pp); a top-level tensor itself, in a list
    of one."""
    return ([t[i] for i in range(t.shape[0])] if path[0] == "layers"
            else [t])


def _mesh_leaves(trees):
    """(per-position trees for the forward, {id(stacked tensor): leaves}):
    one autograd leaf per distinct stored tensor (per layer for layer
    tensors, see the module docstring), shared by every position that
    holds the tensor."""
    made: Dict[int, List[torch.Tensor]] = {}
    out = []
    for tree in trees:
        if tree is None:
            out.append(None)
            continue
        per_path = {}
        for path in _paths(tree):
            t = _get(tree, path)
            if id(t) not in made:
                made[id(t)] = [v.detach().requires_grad_()
                               for v in _views(t, path)]
            per_path[path] = made[id(t)]
        L = len(per_path[_paths(tree)[-1]])
        pieces = ([per_path[(k,)][0] for k in _TOP]
                  + [per_path[("layers",) + p][i] for i in range(L)
                     for p in _layer_paths(tree["layers"])])
        out.append(_assemble(pieces, tree, L))
    return out, made


@torch.no_grad()
def _all_reduce_replicas(lay: _MeshLayout, trees, made) -> None:
    """Sum each shard's gradient over its replicas on distinct devices
    (dp replicas and sp positions alike), in position order, in the
    gradient's dtype, on the first replica's device, then over the
    other ranks that hold the shard (an all-reduce over their process
    group), and give every replica the sum. A replica that took no
    gradient (a tensor its position did not use) adds nothing."""
    for path, reps, ranks in lay.classes:
        group = lay.mesh.group(ranks)
        if len(reps) == 1 and group is None:
            continue
        leaves = [made[id(_get(trees[i], path))] for i in reps]
        for per_layer in zip(*leaves):
            grads = [leaf.grad for leaf in per_layer if leaf.grad is not None]
            if not grads and group is None:
                continue
            # The other ranks issue this all-reduce whether or not this
            # rank's replicas took a gradient.
            total = (grads[0].clone() if grads
                     else torch.zeros_like(per_layer[0]))
            for g in grads[1:]:
                total += g.to(total.device)
            if group is not None:
                dist.all_reduce(total, group=group)
            for leaf in per_layer:
                leaf.grad = (total if leaf.device == total.device
                             else total.to(leaf.device))


def _mesh_backward(trees, batch, cfg: TransformerConfig, lay: _MeshLayout,
                   device, num_microbatches=None):
    """(loss, leaf trees, made): each batch group's forward and backward in
    turn, the replicas' gradients all-reduced; the leaf trees and ``made``
    as ``_mesh_leaves`` gives them."""
    fwd_trees, made = _mesh_leaves(trees)
    loss = None
    for part in mesh_group_losses(fwd_trees, batch, cfg, lay.mesh,
                                  lay.rules, device, num_microbatches):
        part.backward()
        part = part.detach().to(device)
        loss = part if loss is None else loss + part
    _all_reduce_replicas(lay, trees, made)
    return world_sum(loss, lay.mesh), fwd_trees, made


def _canonical(lay: _MeshLayout, trees):
    """Per replica class and layer, the first replica's tensor of
    ``trees`` (params, mu or nu), in a fixed order."""
    return [v for path, reps, _ in lay.classes
            for v in _views(_get(trees[reps[0]], path), path)]


def _replicas(lay: _MeshLayout, trees):
    """(first replica's tensor, another replica's) pairs of ``trees``."""
    return [(v0, v) for path, reps, _ in lay.classes for i in reps[1:]
            for v0, v in zip(_views(_get(trees[reps[0]], path), path),
                             _views(_get(trees[i], path), path))]


def value_and_grad(params, batch: Dict[str, Any], cfg: TransformerConfig,
                   device: Union[str, torch.device] = "cuda", mesh=None,
                   rules: Optional[LogicalAxisRules] = None,
                   num_microbatches: Optional[int] = None):
    """(loss, grads): the grads as a params tree whose "layers" is a list of
    per-layer dicts (one gradient tensor per layer, see the module
    docstring); under ``mesh`` ``params`` and the grads are lists of
    per-position trees (the state's layout, each replica holding the
    all-reduced sum; under pp a position's list holds its stage's
    layers). ``num_microbatches`` as in ``make_train_step``. ``params``
    are not changed."""
    if mesh is None:
        loss, leaves = _backward(params, batch, cfg, device)
        return loss, _assemble([leaf.grad for leaf in leaves], params,
                               cfg.num_layers)
    lay = _MeshLayout(cfg, mesh, mesh_rules(mesh, rules))
    loss, leaves, _ = _mesh_backward(params, batch, cfg, lay,
                                     resolve_device(device),
                                     num_microbatches)
    return loss, _map(lambda leaf: leaf.grad, leaves)


@dataclasses.dataclass(frozen=True)
class AdamW:
    """The optax chain ``clip_by_global_norm(grad_clip)`` then
    ``adamw(warmup_cosine_decay_schedule(0, learning_rate, warmup_steps,
    decay_steps), b1, b2, weight_decay=weight_decay)``, updating in
    place."""
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    decay_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0

    def schedule(self, count: int) -> float:
        """optax.warmup_cosine_decay_schedule(0, lr, warmup, decay)(count):
        linear from 0 over the warmup, then cosine to 0 at decay_steps."""
        lr, warm = self.learning_rate, self.warmup_steps
        if count < warm:
            return lr * count / warm
        span = self.decay_steps - warm
        t = min(count - warm, span)
        return lr * 0.5 * (1.0 + math.cos(math.pi * t / span))

    def init(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Zero moments in each param's dtype, as optax keeps them."""
        return {"count": 0, "mu": _map(torch.zeros_like, params),
                "nu": _map(torch.zeros_like, params), "schedule_count": 0}

    @torch.no_grad()
    def update_(self, params: List[torch.Tensor], grads: List[torch.Tensor],
                mu: List[torch.Tensor], nu: List[torch.Tensor],
                opt_state: Dict[str, Any], gnorm: Optional[float] = None
                ) -> Tuple[Dict[str, Any], float]:
        """Apply one update to ``params``, ``mu`` and ``nu`` in place
        (``grads`` are clipped in place). Returns the new opt_state and the
        global norm of the unclipped grads (``gnorm`` where the caller
        took it: a rank's grads are not every distinct tensor)."""
        if gnorm is None:
            gnorm = float(global_norm(grads))
        clip = not gnorm < self.grad_clip      # optax's strict trigger
        count = opt_state["count"] + 1
        bc1 = 1.0 - self.b1 ** count
        bc2 = 1.0 - self.b2 ** count
        lr = self.schedule(opt_state["schedule_count"])
        for p, g, m, v in zip(params, grads, mu, nu):
            if clip:
                g.div_(gnorm).mul_(self.grad_clip)
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            den = (v / bc2).sqrt_().add_(_EPS)
            u = (m / bc1).div_(den)
            del den
            u.add_(p, alpha=self.weight_decay).mul_(-lr)
            p.add_(u)
        return {"count": count, "mu": opt_state["mu"], "nu": opt_state["nu"],
                "schedule_count": opt_state["schedule_count"] + 1}, gnorm


def _map(fn, tree, memo=None):
    """``fn`` over every tensor of nested dicts and lists, once per
    distinct tensor: a tensor that several positions share maps to one
    result that they share. None (another process's position) stays."""
    memo = {} if memo is None else memo
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v, memo) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v, memo) for v in tree]
    if id(tree) not in memo:
        memo[id(tree)] = fn(tree)
    return memo[id(tree)]


def make_optimizer(learning_rate: float = 3e-4, weight_decay: float = 0.1,
                   warmup_steps: int = 100, decay_steps: int = 10000,
                   b1: float = 0.9, b2: float = 0.95,
                   grad_clip: float = 1.0) -> AdamW:
    return AdamW(learning_rate=learning_rate, weight_decay=weight_decay,
                 warmup_steps=warmup_steps,
                 decay_steps=max(decay_steps, warmup_steps + 1), b1=b1,
                 b2=b2, grad_clip=grad_clip)


@dataclasses.dataclass
class TrainStepBundle:
    """What a trainer needs to run steps on one device or a mesh.
    ``state_specs`` (under a mesh) is the counterpart of JAX's
    ``state_shardings``: the state's tree with a ``PartitionSpec`` per
    params, mu and nu leaf and ``PartitionSpec()`` for the counts."""
    cfg: TransformerConfig
    init: Callable[..., Dict[str, Any]]         # generator -> state
    step: Callable[[Dict[str, Any], Dict[str, Any]],
                   Tuple[Dict[str, Any], Dict[str, Any]]]
    optimizer: AdamW
    device: torch.device
    mesh: Any = None
    rules: Optional[LogicalAxisRules] = None
    state_specs: Any = None


def make_train_step(cfg: TransformerConfig, mesh=None,
                    optimizer: Optional[AdamW] = None,
                    rules: Optional[LogicalAxisRules] = None,
                    donate_state: bool = True,
                    num_microbatches: Optional[int] = None,
                    device: Union[str, torch.device] = "cuda"
                    ) -> TrainStepBundle:
    """``step(state, batch) -> (state, {"loss", "grad_norm", "step"})``,
    ``grad_norm`` being the norm of the unclipped grads. With
    ``donate_state`` the step updates ``state``'s tensors in place (the
    port of JAX's donation); otherwise it works on a copy. ``mesh``: the
    state is sharded over its positions under ``rules`` (default
    ``LogicalAxisRules.default()``, or ``megatron_rules()``; see the
    module docstring); batches and metrics live on ``device``.
    ``num_microbatches`` only matters under a pp > 1 mesh axis: it sets
    the pipeline schedule's depth (default pp)."""
    if mesh is not None:
        mesh.train_axes()
    dev = resolve_device(device)
    tx = optimizer or make_optimizer()
    L = cfg.num_layers
    lay = specs = None
    if mesh is not None:
        rules = mesh_rules(mesh, rules)
        lay = _MeshLayout(cfg, mesh, rules)
        scalar = PartitionSpec()
        specs = {"params": lay.specs,
                 "opt_state": {"count": scalar, "mu": lay.specs,
                               "nu": lay.specs, "schedule_count": scalar},
                 "step": scalar}

    def init(generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        params = init_params(cfg, generator, dev)
        if mesh is not None:
            params = shard_params(params, mesh, rules)
        return {"params": params, "opt_state": tx.init(params), "step": 0}

    def step(state, batch):
        if not donate_state:
            state = _copy_state(state)
        params, opt = state["params"], state["opt_state"]
        if mesh is None:
            loss, leaves = _backward(params, batch, cfg, dev)
            grads = [leaf.grad for leaf in leaves]
            mu, nu = _pieces(opt["mu"], L), _pieces(opt["nu"], L)
            gnorm = None
        else:
            loss, _, made = _mesh_backward(params, batch, cfg, lay, dev,
                                           num_microbatches)
            leaves, owned = [], []
            for path, reps, ranks in lay.classes:
                views = made[id(_get(params[reps[0]], path))]
                leaves += views
                if ranks[0] == mesh.rank:
                    owned += [leaf.grad for leaf in views]
            grads = [leaf.grad for leaf in leaves]
            gnorm = float(global_norm(owned, mesh.world_group(), dev))
            mu, nu = (_canonical(lay, opt[k]) for k in ("mu", "nu"))
            del made, owned
        for leaf in leaves:
            leaf.grad = None
        # The leaves share the params' storage: updating them in place
        # updates state["params"].
        new_opt, gnorm = tx.update_(leaves, grads, mu, nu, opt, gnorm)
        del grads
        if mesh is not None:
            with torch.no_grad():
                for tree in (params, opt["mu"], opt["nu"]):
                    for src, dst in _replicas(lay, tree):
                        dst.copy_(src)
        new_state = {"params": params, "opt_state": new_opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss.item(), "grad_norm": gnorm,
                           "step": new_state["step"]}

    return TrainStepBundle(cfg=cfg, init=init, step=step, optimizer=tx,
                           device=dev, mesh=mesh, rules=rules,
                           state_specs=specs)


def _copy_state(state):
    opt = state["opt_state"]
    return {"params": _map(torch.clone, state["params"]),
            "opt_state": {**opt, "mu": _map(torch.clone, opt["mu"]),
                          "nu": _map(torch.clone, opt["nu"])},
            "step": state["step"]}


def make_eval_step(cfg: TransformerConfig, mesh=None,
                   rules: Optional[LogicalAxisRules] = None,
                   device: Union[str, torch.device] = "cuda"):
    """``eval(params, batch) -> loss`` (0-d f32 tensor on ``device``),
    without grads; under ``mesh`` ``params`` are the state's per-position
    trees (or a full tree, which it shards)."""
    dev = resolve_device(device)
    if mesh is not None:
        mesh.train_axes()
        rules = mesh_rules(mesh, rules)

    @torch.no_grad()
    def _eval(params, batch):
        return loss_fn(params, batch, cfg, mesh, device=dev, rules=rules)

    return _eval


def _find(node, pred):
    """The first node of a nested tuple (optax's chained states) that
    ``pred`` accepts, depth first."""
    if pred(node):
        return node
    if isinstance(node, tuple):
        for child in node:
            found = _find(child, pred)
            if found is not None:
                return found
    return None


def from_jax_state(np_state, cfg: TransformerConfig,
                   device: Union[str, torch.device] = "cuda", mesh=None,
                   rules: Optional[LogicalAxisRules] = None
                   ) -> Dict[str, Any]:
    """Carry a JAX train state across: ``np_state`` is the state of the
    reference's ``make_train_step`` as numpy arrays
    (``jax.tree.map(np.asarray, state)``). Its params and the Adam mu, nu
    and count, and the schedule's count, are copied bit-exactly onto
    ``device``, so training continues where JAX left off; under ``mesh``
    params, mu and nu are then sharded over its positions under ``rules``
    (the layout of ``make_train_step(cfg, mesh, rules=rules)``)."""
    opt = np_state["opt_state"]
    adam = _find(opt, lambda n: hasattr(n, "mu") and hasattr(n, "nu"))
    sched = _find(opt, lambda n: getattr(n, "_fields", None) == ("count",))
    if adam is None or sched is None:
        raise ValueError("opt_state holds no Adam moments and schedule "
                         "count: not the state of make_optimizer's chain")
    if mesh is not None:
        mesh.train_axes()
        rules = mesh_rules(mesh, rules)

    def carry(tree):
        if mesh is None:
            return from_jax_params(tree, cfg, device)
        # Each position's slice goes to its device from the host: no
        # device holds the whole tree, nor a rank another rank's shard.
        return shard_params(from_jax_params(tree, cfg, "cpu"), mesh, rules)
    return {"params": carry(np_state["params"]),
            "opt_state": {"count": int(np.asarray(adam.count)),
                          "mu": carry(adam.mu), "nu": carry(adam.nu),
                          "schedule_count": int(np.asarray(sched.count))},
            "step": int(np.asarray(np_state["step"]))}
