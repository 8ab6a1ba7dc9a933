"""Mixture-of-Experts layer with expert parallelism over the ``ep`` axes.

Port of ray_tpu/models/moe.py: capacity-based top-k routing with DENSE
one-hot dispatch and combine einsums (the Switch/GShard recipe), the same
params, the same capacity rule and the same aux losses. JAX computes the
layer as XLA einsums outside any Pallas kernel, so here it stays
``torch.einsum``.

Expert parallelism: JAX shards the expert dim over ``EP_AXES`` = fsdp x sp
(``LogicalAxisRules.default()``'s "expert" rule) and lets XLA insert the
all-to-alls. The port's mesh is a single controller
(``parallel.mesh.Mesh``), so ``moe_layer(..., mesh=)`` moves the tokens
itself:

- routing runs once, over all N tokens, on ``x``'s device, as in the
  unsharded layer. The capacity slot of a choice is a cumsum over all N*K
  choices, global by nature. The router is gathered across the positions
  that split it (fsdp, on its embed dim), not summed from partial
  products, so ``expert_idx`` and ``keep`` are bit-equal to the unsharded
  layer's on the same device and a near-tie cannot flip a token's expert;
- each expert group's dispatched slots, (E/ep, C, D), go ``.to()`` the
  devices of the positions that hold those experts;
- each position computes its experts over its slice of the MLP units
  (tp), and the w_down partials of one expert group are summed in f32 in
  position order and rounded once, as ``transformer.all_reduce`` does;
- the expert outputs come back to ``x``'s device for the combine: the
  single-controller counterpart of the all-to-alls.

The positions whose coordinates off the expert and MLP axes (dp, pp) are
0 do the work; where other positions hold the same slices they are
replicas, which a trainer would all-reduce as ``models.train_step`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..parallel.sharding import (LogicalAxisRules, gather_tensor,
                                 shard_params, shard_slices, tree_specs)
from .transformer import _to_tensor


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


def route(router: torch.Tensor, xf: torch.Tensor, cfg: MoEConfig):
    """The routing of (N, D) tokens ``xf``: (router logits (N, E) f32,
    probs, expert_idx (N, K), keep (N, K) bool, dispatch (N, E, C) in
    ``cfg.dtype``, combine (N, E, C) f32)."""
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
    slot = F.one_hot(torch.where(keep, pos_in_expert, C).long(),
                     C + 1)[..., :C]                               # [N, K, C]
    disp = torch.einsum("nke,nkc->nec", onehot.to(cfg.dtype),
                        slot.to(cfg.dtype))
    comb = torch.einsum("nke,nkc,nk->nec", onehot.float(), slot.float(),
                        gate_vals.float())
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
    """Who computes what on ``mesh`` under ``rules``: per expert group (a
    slice of the expert dim, in expert order), the first position of each
    distinct MLP-unit slice, in position order; the params' specs."""

    def __init__(self, cfg: MoEConfig, mesh, rules: LogicalAxisRules):
        self.specs = tree_specs(moe_logical_axes(), mesh, rules)
        E, D, Fd = cfg.num_experts, cfg.d_model, cfg.d_ff
        shapes = {"w_gate": (E, D, Fd), "w_up": (E, D, Fd),
                  "w_down": (E, Fd, D)}
        groups: Dict[Tuple[int, int], Dict[Tuple[int, int], int]] = {}
        for i, coord in enumerate(mesh.coords()):
            sl = {k: shard_slices(self.specs[k], shapes[k], mesh, coord)
                  for k in shapes}
            e = (sl["w_gate"][0].start, sl["w_gate"][0].stop)
            f = (sl["w_gate"][2].start, sl["w_gate"][2].stop)
            if (sl["w_gate"][1] != slice(0, D) or sl["w_up"] != sl["w_gate"]
                    or sl["w_down"] != (sl["w_gate"][0], sl["w_gate"][2],
                                        slice(0, D))):
                raise NotImplementedError(
                    f"rules that split the experts' embed dim, or w_gate, "
                    f"w_up and w_down otherwise than over experts and MLP "
                    f"units alike, are not ported: {self.specs}")
            groups.setdefault(e, {}).setdefault(f, i)
        self.groups: List[Tuple[Tuple[int, int], List[int]]] = [
            (e, list(groups[e].values())) for e in sorted(groups)]
        self.devices = list(mesh.devices.flat)


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
            t = trees[i]
            part = _experts(sent[dev], t["w_gate"], t["w_up"], t["w_down"],
                            cfg.dtype)
            total = (part.to(home, torch.float32, copy=True) if total is None
                     else total + part.to(home))
        ye.append(total.to(cfg.dtype))
    y = torch.einsum("ecd,nec->nd", torch.cat(ye).float(), comb)
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
    units over tp, the router's embed dim over fsdp); ``params`` is then
    the full tree, which is split, or the per-position list that
    ``shard_params(params, mesh, rules, moe_logical_axes())`` gives. See
    the module docstring."""
    B, S, D = x.shape
    xf = x.reshape(B * S, D)
    if mesh is None:
        routing = route(params["router"], xf, cfg)
        disp, comb = routing[4], routing[5]
        xe = torch.einsum("nd,nec->ecd", xf.to(cfg.dtype), disp)
        ye = _experts(xe, params["w_gate"], params["w_up"], params["w_down"],
                      cfg.dtype)
        y = torch.einsum("ecd,nec->nd", ye.float(), comb)
    else:
        mesh.check_one_process("the expert-parallel MoE layer", "16")
        rules = rules or LogicalAxisRules.default()
        trees = (params if isinstance(params, (list, tuple))
                 else shard_params(params, mesh, rules, moe_logical_axes()))
        if len(trees) != mesh.devices.size:
            raise ValueError(f"{len(trees)} position trees for a mesh of "
                             f"{mesh.devices.size} positions")
        y, routing = _ep_forward(trees, _EPLayout(cfg, mesh, rules), mesh,
                                 xf, cfg)
    y = y.reshape(B, S, D).to(x.dtype)
    aux = _aux(routing[0], routing[1], routing[2], routing[3], cfg)
    return y, aux, (routing[2], routing[3])
