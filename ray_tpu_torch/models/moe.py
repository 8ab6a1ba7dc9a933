"""Mixture-of-Experts layer with expert parallelism over the ``ep`` axes.

Port of ray_tpu/models/moe.py: capacity-based top-k routing with DENSE
one-hot dispatch and combine einsums (the Switch/GShard recipe), the same
params, the same capacity rule and the same aux losses. JAX computes the
layer as XLA einsums outside any Pallas kernel, so here it stays
``torch.einsum``.

Expert parallelism: JAX shards the expert dim over ``EP_AXES`` = fsdp x sp
(``LogicalAxisRules.default()``'s "expert" rule) and lets XLA insert the
all-to-alls. ``moe_layer(..., mesh=)`` moves the tokens itself. Routing
runs over all N tokens, as in the unsharded layer: the capacity slot of a
choice is a cumsum over all N*K choices in token order, global by nature.
The router is gathered across the positions that split it (fsdp, on its
embed dim), not summed from partial products, so ``expert_idx`` and
``keep`` are bit-equal to the unsharded layer's on the same device and a
near-tie cannot flip a token's expert. Each position computes its experts
over its slice of the MLP units (split over the axes among fsdp, sp and
tp that do not split the experts: tp under the default table), and the
w_down partials of one expert group are summed in f32 and rounded once,
as ``transformer.all_reduce`` does.

- One process (``parallel.mesh.Mesh``, the single controller), under
  any rule table: each expert group's dispatched slots, (E/ep, C, D), go
  ``.to()`` the devices of the positions that compute those experts
  (each building its experts' weights over its MLP units from the
  table's slices, ``_EPLayout``), and the outputs come back to
  ``x``'s device for the combine. The positions whose coordinates off the
  expert and MLP axes (dp, pp) are 0 do the work; where other positions
  hold the same slices they are replicas, which a trainer would
  all-reduce as ``models.train_step`` does.
- A mesh over several processes, under any rule table: each rank
  computes its positions' expert groups at their MLP units, built from
  the stored slices (those other ranks hold through one all-gather over
  the ranks that read and hold them, ``_EPLayout.fetch``, whose backward
  reduce-scatters the gradient back), and every position of a (pp, dp)
  replica takes an equal run of the N tokens (``moe_rows``). A rank
  routes all N tokens (N x E logits, small beside the experts) and
  dispatches its run's; one
  ``all_to_all_single`` over the replica's ranks takes each expert
  group's slots to the ranks that compute it, where the sources'
  disjoint slots are added; the MLP partials are summed over the
  group's ranks in f32 (``transformer._AllReduce``); a second
  all-to-all brings every group's outputs to every rank, which combines
  its run. Both exchanges have equal splits (C is static) and run back
  in the backward.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..parallel.mesh import Mesh
from ..parallel.sharding import (LogicalAxisRules, PartitionSpec,
                                 _dim_axes, exchange, exchange_slots,
                                 from_runs, gather_tensor, prefer_rank,
                                 reshard, reshard_plan, shard_params,
                                 shard_slices, tie, tree_specs)
from ..ops.ring_attention import all_to_all
from .transformer import _AllReduce, _to_tensor


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int
    num_experts: int = 8
    num_experts_per_token: int = 2
    capacity_factor: float = 1.25
    router_z_loss_coef: float = 1e-3
    load_balance_coef: float = 1e-2
    dtype: torch.dtype = torch.bfloat16

    def capacity(self, num_tokens: int) -> int:
        """Slots per expert for ``num_tokens`` tokens."""
        return max(1, int(self.capacity_factor * num_tokens
                           * self.num_experts_per_token / self.num_experts))


def init_moe_params(cfg: MoEConfig,
                    generator: Optional[torch.Generator] = None,
                    device: Union[str, torch.device] = "cuda"
                    ) -> Dict[str, torch.Tensor]:
    """f32 params in the JAX layouts (as ``jax.random.normal`` makes them),
    drawn from ``generator`` (default: seeded 0) on ``device``. The draws
    differ from JAX's; tests that compare with the JAX package carry its
    params over (``moe_params_from_jax``)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    E, D, Fd = cfg.num_experts, cfg.d_model, cfg.d_ff

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=dev).mul_(scale)
    return {
        "router": normal((D, E), D ** -0.5),
        "w_gate": normal((E, D, Fd), D ** -0.5),
        "w_up": normal((E, D, Fd), D ** -0.5),
        "w_down": normal((E, Fd, D), Fd ** -0.5),
    }


def moe_params_from_jax(np_tree, device: Union[str, torch.device] = "cuda"
                        ) -> Dict[str, torch.Tensor]:
    """Carry JAX MoE params across (``jax.tree.map(np.asarray, params)``):
    the layouts match, so this is a bit-exact copy onto ``device``."""
    dev = resolve_device(device)
    return {k: _to_tensor(v, dev) for k, v in np_tree.items()}


def moe_logical_axes() -> Dict[str, tuple]:
    """Logical axis names per param (feed into LogicalAxisRules)."""
    return {
        "router": ("embed", "expert_unsharded"),
        "w_gate": ("expert", "embed", "mlp"),
        "w_up": ("expert", "embed", "mlp"),
        "w_down": ("expert", "mlp", "embed"),
    }


def route(router: torch.Tensor, xf: torch.Tensor, cfg: MoEConfig,
          rows: slice = slice(None)):
    """The routing of (N, D) tokens ``xf``: (router logits (N, E) f32,
    probs, expert_idx (N, K), keep (N, K) bool, dispatch (n, E, C) in
    ``cfg.dtype``, combine (n, E, C) f32), the dispatch and combine of
    the tokens ``rows`` only (default: all N)."""
    N = xf.shape[0]
    E, K = cfg.num_experts, cfg.num_experts_per_token
    C = cfg.capacity(N)
    router_logits = xf.float() @ router.float()                    # [N, E]
    probs = torch.softmax(router_logits, dim=-1)
    # Top-k expert choice per token.
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)           # [N, K]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    # Capacity assignment: position of each (token, k) within its
    # expert's queue, dropped if beyond capacity (Switch
    # position-in-expert).
    onehot = F.one_hot(expert_idx, E).to(torch.int32)              # [N, K, E]
    flat = onehot.reshape(N * K, E)
    pos = torch.cumsum(flat, dim=0, dtype=torch.int32) - flat
    pos_in_expert = (pos * flat).sum(-1).reshape(N, K)
    keep = pos_in_expert < C
    gate_vals = gate_vals * keep
    # Dispatch [N, E, C]: token n -> expert e at slot c. A dropped choice
    # takes the one-hot of C, which JAX's one_hot makes all zeros.
    slot = F.one_hot(torch.where(keep, pos_in_expert, C)[rows].long(),
                     C + 1)[..., :C]                               # [n, K, C]
    onehot = onehot[rows]
    disp = torch.einsum("nke,nkc->nec", onehot.to(cfg.dtype),
                        slot.to(cfg.dtype))
    comb = torch.einsum("nke,nkc,nk->nec", onehot.float(), slot.float(),
                        gate_vals[rows].float())
    return router_logits, probs, expert_idx, keep, disp, comb


def _experts(xe, w_gate, w_up, w_down, dtype):
    """SwiGLU of every expert's slots: (E', C, D) -> (E', C, D), over the
    MLP units the weights hold (a partial sum where they hold a slice)."""
    g = torch.einsum("ecd,edf->ecf", xe, w_gate.to(dtype))
    u = torch.einsum("ecd,edf->ecf", xe, w_up.to(dtype))
    return torch.einsum("ecf,efd->ecd", F.silu(g) * u, w_down.to(dtype))


def _aux(router_logits, probs, expert_idx, keep, cfg: MoEConfig):
    E, K = cfg.num_experts, cfg.num_experts_per_token
    N = probs.shape[0]
    me = probs.mean(dim=0)                                         # [E]
    ce = F.one_hot(expert_idx, E).sum(dim=1).float().mean(dim=0)   # [E]
    load_balance = E * torch.sum(me * ce) / K
    z_loss = torch.mean(torch.logsumexp(router_logits, dim=-1) ** 2)
    return {
        "moe_load_balance_loss": cfg.load_balance_coef * load_balance,
        "moe_router_z_loss": cfg.router_z_loss_coef * z_loss,
        "moe_fraction_dropped": 1.0 - keep.sum() / (N * K),
    }


class _EPLayout:
    """Who computes what on ``mesh`` under ``rules``: the params' specs;
    the compute layout of w_gate, w_up and w_down (the experts split as
    the table splits them, the MLP units over the axes among fsdp, sp and
    tp that do not split the experts, the embed dim whole), so that the
    positions of a (pp, dp) replica each compute a distinct part; per
    expert group (a slice of the expert dim, in expert order), the first
    position of each distinct MLP-unit slice, in position order.

    Each computing position builds its experts' weights over its MLP
    units from the stored slices at use (``parallel.sharding.reshard``),
    under any table, and the gradient goes back to them. Over several
    processes a block another rank holds comes through one all-gather of
    each rank's slices over the ranks that read and hold it (``fetch``,
    ``sharding.exchange``), whose backward reduce-scatters the gradient
    back: the embed dim split over fsdp where ``("expert", None)`` leaves
    the experts whole, or w_gate, w_up and w_down split unalike."""

    def __init__(self, cfg: MoEConfig, mesh, rules: LogicalAxisRules):
        self.mesh = mesh
        self.specs = tree_specs(moe_logical_axes(), mesh, rules)
        E, D, Fd = cfg.num_experts, cfg.d_model, cfg.d_ff
        self.shapes = {"w_gate": (E, D, Fd), "w_up": (E, D, Fd),
                       "w_down": (E, Fd, D)}
        # A (pp, dp) replica computes every expert: the compute layout
        # splits the experts over the table's expert axes among fsdp, sp
        # and tp, the MLP units over the others.
        experts = tuple(a for a in _dim_axes(self.specs["w_gate"], 0)
                        if a in ("fsdp", "sp", "tp"))
        mlp = tuple(a for a in ("fsdp", "sp", "tp") if a not in experts)
        ex = experts or None
        mp = mlp or None
        self.compute = {"w_gate": PartitionSpec(ex, None, mp),
                        "w_up": PartitionSpec(ex, None, mp),
                        "w_down": PartitionSpec(ex, mp, None)}
        groups: Dict[Tuple[int, int], Dict[Tuple[int, int], int]] = {}
        for i in range(mesh.devices.size):
            e, f = self.region(i)
            groups.setdefault(e, {}).setdefault(f, i)
        self.groups: List[Tuple[Tuple[int, int], List[int]]] = [
            (e, list(groups[e].values())) for e in sorted(groups)]
        self.devices = list(mesh.devices.flat)
        self._plans: Dict[int, Dict[str, tuple]] = {}

    def region(self, i: int):
        """Position ``i``'s compute region: its (first, end) expert and
        MLP unit."""
        r = shard_slices(self.compute["w_gate"], self.shapes["w_gate"],
                         self.mesh, self.mesh.coords()[i])
        return (r[0].start, r[0].stop), (r[2].start, r[2].stop)

    def plans(self, i: int) -> Dict[str, tuple]:
        """Position ``i``'s reshard plan per weight (a block that its
        rank holds read there)."""
        if i not in self._plans:
            mesh, coord = self.mesh, self.mesh.coords()[i]
            self._plans[i] = {}
            for k, shape in self.shapes.items():
                plan = reshard_plan(self.specs[k], shape, mesh,
                                    shard_slices(self.compute[k], shape,
                                                 mesh, coord), coord)
                if mesh.world > 1:
                    keys = [shard_slices(self.specs[k], shape, mesh, c)
                            for c in mesh.coords()]
                    plan = prefer_rank(plan, keys, mesh,
                                       mesh.process_index(i))
                self._plans[i][k] = plan
        return self._plans[i]

    def fetch(self, trees):
        """(link, got), every rank calling it: per weight that some
        position reads from another rank, this rank's positions' slices
        all-gathered over the fewest ranks of a process group that cover
        every such read (``Mesh.covering``, ``sharding.exchange``); got
        {weight: (runs, {other rank's position: its slot})} for
        ``weights``."""
        mesh = self.mesh
        rank_of = mesh.process_index
        every = range(mesh.devices.size)
        names, ranks = [], set()
        for k in self.shapes:
            far = {(rank_of(p), rank_of(i)) for p in every
                   for i, _ in self.plans(p)[k][1] if rank_of(i) != rank_of(p)}
            if far:
                names.append(k)
                ranks.update(r for pair in far for r in pair)
        if not names:
            return None, None
        cover = mesh.covering(ranks)
        if mesh.rank not in cover:
            return None, None
        loc = mesh.local_positions()
        home = self.devices[loc[0]]
        parts = [torch.stack([trees[i][k].to(home) for i in loc])
                 for k in names]
        link, got = exchange(parts, [mesh.group(cover)] * len(names))
        return link, {k: (runs, exchange_slots(mesh, cover, [
            i for p in loc for i, _ in self.plans(p)[k][1]
            if rank_of(i) in cover])) for k, runs in zip(names, got)}

    def weights(self, trees, i: int, got=None):
        """Computing position ``i``'s w_gate, w_up and w_down over its
        experts and MLP units, on its device (its own slices where they
        are those; across ranks, as ``fetch`` gives them in ``got``, a
        block in an exchange from its runs, ``from_runs`` where whole)."""
        out = []
        for k in ("w_gate", "w_up", "w_down"):
            runs, slots = (got or {}).get(k, (None, {}))
            whole = (None if runs is None
                     else from_runs(self.plans(i)[k], slots, runs))
            out.append(whole.to(self.devices[i]) if whole is not None
                       else reshard(lambda j, k=k, runs=runs, slots=slots:
                                    runs[slots[j]] if j in slots
                                    else trees[j][k], self.plans(i)[k],
                                    self.devices[i]))
        return out


def _ep_forward(trees, lay: _EPLayout, mesh, xf, cfg: MoEConfig):
    """The routing on ``xf``'s device from the gathered router, each expert
    group on its positions' devices, the outputs combined on ``xf``'s
    device: (y (N, D) f32, routing)."""
    home = xf.device
    router = gather_tensor([t["router"] for t in trees], lay.specs["router"],
                           mesh, device=home)
    routing = route(router, xf, cfg)
    disp, comb = routing[4], routing[5]
    xe = torch.einsum("nd,nec->ecd", xf.to(cfg.dtype), disp)       # [E, C, D]
    ye = []
    for (e0, e1), positions in lay.groups:
        sent: Dict[torch.device, torch.Tensor] = {}
        total = None
        for i in positions:
            dev = lay.devices[i]
            if dev not in sent:
                sent[dev] = xe[e0:e1].to(dev)
            part = _experts(sent[dev], *lay.weights(trees, i), cfg.dtype)
            total = (part.to(home, torch.float32, copy=True) if total is None
                     else total + part.to(home))
        ye.append(total.to(cfg.dtype))
    y = torch.einsum("ecd,nec->nd", torch.cat(ye).float(), comb)
    return y, routing


def moe_rows(mesh, num_tokens: int) -> Tuple[int, int]:
    """This rank's run [a, b) of the N = B*S flattened tokens on a mesh over
    several processes: the tokens split into equal runs, one per position
    of a (pp, dp) replica in grid order, and a rank takes its positions'
    runs."""
    coords = mesh.coords()
    loc = mesh.local_positions()
    reps = {coords[i][:2] for i in loc}
    if len(reps) > 1:
        raise ValueError(f"this rank's positions lie in {len(reps)} (pp, "
                         f"dp) replicas: the expert-parallel layer takes "
                         f"a rank's positions from one")
    members = [i for i, c in enumerate(coords) if c[:2] in reps]
    if num_tokens % len(members):
        raise ValueError(f"{num_tokens} tokens do not split over the "
                         f"{len(members)} positions of a replica")
    run = num_tokens // len(members)
    k = members.index(loc[0])
    return k * run, (k + len(loc)) * run


def _ep_ranks(trees, lay: _EPLayout, mesh, xf, cfg: MoEConfig):
    """``_ep_forward`` on a mesh over several processes (see the module
    docstring): (y of this rank's run of tokens (n, D) f32, routing)."""
    specs = lay.specs
    coords = mesh.coords()
    loc = mesh.local_positions()
    a, b = moe_rows(mesh, xf.shape[0])
    members = [i for i, c in enumerate(coords) if c[:2] == coords[loc[0]][:2]]
    ranks = mesh.ranks(members)
    group = mesh.group(ranks)
    rep = Mesh(mesh.devices[coords[loc[0]][0]:coords[loc[0]][0] + 1,
                            coords[loc[0]][1]:coords[loc[0]][1] + 1])
    # Each rank's positions' router parts (all one shape), to every rank.
    mine = torch.stack([trees[i]["router"] for i in loc])
    parts = [p for chunk in all_to_all([mine] * len(ranks), group)
             for p in chunk]
    router = gather_tensor(parts, specs["router"], rep, device=xf.device)
    routing = route(router, xf, cfg, slice(a, b))
    disp, comb = routing[4], routing[5]
    xe = torch.einsum("nd,nec->ecd", xf[a:b].to(cfg.dtype), disp)  # [E,C,D]

    held = {r: set() for r in ranks}
    for i in members:
        held[mesh.process_index(i)].add(lay.region(i)[0])
    spans = {r: (min(e[0] for e in g), max(e[1] for e in g))
             for r, g in held.items()}
    ranges = set(spans.values())
    if (len({y - x for x, y in ranges}) > 1
            or any(sum(y - x for x, y in held[r]) != y1 - x1
                   for r, (x1, y1) in spans.items())
            or any(u != w and u[0] < w[1] and w[0] < u[1]
                   for u in ranges for w in ranges)):
        raise ValueError(f"the ranks hold experts {held}: the "
                         f"expert-parallel layer needs each rank one run, "
                         f"the runs equal or apart, of one length")
    e0, e1 = spans[mesh.rank]
    # Dispatch: each rank's slots for each rank's experts, added up.
    xe = torch.stack(all_to_all([xe[s0:s1] for s0, s1 in
                                 (spans[r] for r in ranks)], group)).sum(0)
    # This rank's experts over its MLP units, built from the stored
    # slices (other ranks' through the exchange), summed in f32 over its
    # positions, then over the ranks that hold the others.
    link, got = lay.fetch(trees)
    xe = tie(xe, link)
    total = None
    for i in dict.fromkeys(loc):
        (g0, g1), _ = lay.region(i)
        part = _experts(xe[g0 - e0:g1 - e0], *lay.weights(trees, i, got),
                        cfg.dtype).float()
        part = F.pad(part, (0, 0, 0, 0, g0 - e0, e1 - g1))
        total = part if total is None else total + part
    holders = mesh.ranks([i for i in members if spans[
        mesh.process_index(i)] == (e0, e1)])
    if len(holders) > 1:
        total = _AllReduce.apply(total, mesh.group(holders))
    ye = total.to(cfg.dtype)
    # Combine: every rank's outputs to every rank, each expert range taken
    # from the first rank that holds it.
    got = all_to_all([ye] * len(ranks), group)
    first = {}
    for r, chunk in zip(ranks, got):
        first.setdefault(spans[r], chunk)
    ye = torch.cat([first[k] for k in sorted(first)])
    y = torch.einsum("ecd,nec->nd", ye.float(), comb)
    return y, routing


def moe_layer(params, x: torch.Tensor, cfg: MoEConfig, mesh=None,
              rules: Optional[LogicalAxisRules] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, S, D] -> ([B, S, D], aux_losses dict); ``mesh`` and ``rules``
    as in ``moe_layer_routed``."""
    y, aux, _ = moe_layer_routed(params, x, cfg, mesh, rules)
    return y, aux


def moe_layer_routed(params, x: torch.Tensor, cfg: MoEConfig, mesh=None,
                     rules: Optional[LogicalAxisRules] = None):
    """``moe_layer``, and its routing: (y [B, S, D], aux_losses dict,
    (expert_idx (N, K), keep (N, K) bool)), N = B * S.

    Dispatch: tokens -> per-expert capacity slots via one-hot einsum
    (dense dispatch, static shapes); combine symmetric. Aux losses follow
    Switch Transformer (load-balance) + ST-MoE (router z-loss).

    ``mesh``: expert parallelism over its positions under ``rules``
    (default ``LogicalAxisRules.default()``: experts over fsdp x sp, MLP
    units over tp, the router's embed dim over fsdp; any table, on a mesh
    that one process drives or over several processes, whose stored
    slices each computing position gathers at use, see ``_EPLayout``);
    ``params`` is then the
    full tree, which is split, or the per-position list that
    ``shard_params(params, mesh, rules, moe_logical_axes())`` gives. See
    the module docstring. On a mesh over several processes every rank
    passes the whole ``x`` and gets back y of its run of the flattened
    tokens only (``moe_rows``), as (b - a, D); the aux losses and the
    routing are over all N tokens, on every rank."""
    B, S, D = x.shape
    xf = x.reshape(B * S, D)
    shape = x.shape
    if mesh is None:
        routing = route(params["router"], xf, cfg)
        disp, comb = routing[4], routing[5]
        xe = torch.einsum("nd,nec->ecd", xf.to(cfg.dtype), disp)
        ye = _experts(xe, params["w_gate"], params["w_up"], params["w_down"],
                      cfg.dtype)
        y = torch.einsum("ecd,nec->nd", ye.float(), comb)
    else:
        rules = rules or LogicalAxisRules.default()
        trees = (params if isinstance(params, (list, tuple))
                 else shard_params(params, mesh, rules, moe_logical_axes()))
        if len(trees) != mesh.devices.size:
            raise ValueError(f"{len(trees)} position trees for a mesh of "
                             f"{mesh.devices.size} positions")
        lay = _EPLayout(cfg, mesh, rules)
        if mesh.world > 1:
            y, routing = _ep_ranks(trees, lay, mesh, xf, cfg)
            shape = y.shape                 # this rank's run of the tokens
        else:
            y, routing = _ep_forward(trees, lay, mesh, xf, cfg)
    y = y.reshape(shape).to(x.dtype)
    aux = _aux(routing[0], routing[1], routing[2], routing[3], cfg)
    return y, aux, (routing[2], routing[3])
