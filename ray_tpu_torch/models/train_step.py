"""Training step on one device: loss, backward, clipped AdamW, in place.

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

Meshes and pipeline microbatches are not ported: both raise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .._device import resolve_device
from .transformer import (TransformerConfig, from_jax_params, init_params,
                          loss_fn)

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


def global_norm(tree) -> torch.Tensor:
    """optax.global_norm: the square root of the sum of squares of every
    element of every tensor in ``tree`` (nested dicts and lists), an f32
    0-d tensor."""
    norms = [torch.linalg.vector_norm(t, dtype=torch.float32)
             for t in _leaves(tree)]
    return torch.linalg.vector_norm(torch.stack(norms))


def _backward(params, batch, cfg: TransformerConfig, device):
    """(loss, leaves): the loss, and one leaf per tensor of ``_pieces``
    sharing its storage, each holding its gradient in ``.grad``."""
    leaves = [p.detach().requires_grad_()
              for p in _pieces(params, cfg.num_layers)]
    loss = loss_fn(_assemble(leaves, params, cfg.num_layers), batch, cfg,
                   device=device)
    loss.backward()
    return loss.detach(), leaves


def value_and_grad(params: Dict[str, Any], batch: Dict[str, Any],
                   cfg: TransformerConfig,
                   device: Union[str, torch.device] = "cuda"
                   ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """(loss, grads): the grads as a params tree whose "layers" is a list of
    per-layer dicts (one gradient tensor per layer, see the module
    docstring). ``params`` are not changed."""
    loss, leaves = _backward(params, batch, cfg, device)
    return loss, _assemble([leaf.grad for leaf in leaves], params,
                           cfg.num_layers)


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
                opt_state: Dict[str, Any]) -> Tuple[Dict[str, Any], float]:
        """Apply one update to ``params``, ``mu`` and ``nu`` in place
        (``grads`` are clipped in place). Returns the new opt_state and the
        global norm of the unclipped grads."""
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


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


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
    """What a trainer needs to run steps on one device."""
    cfg: TransformerConfig
    init: Callable[..., Dict[str, Any]]         # generator -> state
    step: Callable[[Dict[str, Any], Dict[str, Any]],
                   Tuple[Dict[str, Any], Dict[str, Any]]]
    optimizer: AdamW
    device: torch.device
    mesh: Any = None


def make_train_step(cfg: TransformerConfig, mesh=None,
                    optimizer: Optional[AdamW] = None,
                    donate_state: bool = True,
                    num_microbatches: Optional[int] = None,
                    device: Union[str, torch.device] = "cuda"
                    ) -> TrainStepBundle:
    """``step(state, batch) -> (state, {"loss", "grad_norm", "step"})``,
    ``grad_norm`` being the norm of the unclipped grads. With
    ``donate_state`` the step updates ``state``'s tensors in place (the
    port of JAX's donation); otherwise it works on a copy."""
    if mesh is not None:
        raise NotImplementedError("meshes are not ported yet: the train "
                                  "step runs on one device")
    if num_microbatches is not None:
        raise NotImplementedError("pipeline microbatches need a pp mesh, "
                                  "which is not ported yet")
    dev = resolve_device(device)
    tx = optimizer or make_optimizer()

    def init(generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        params = init_params(cfg, generator, dev)
        return {"params": params, "opt_state": tx.init(params), "step": 0}

    def step(state, batch):
        if not donate_state:
            state = _copy_state(state)
        L = cfg.num_layers
        params, opt = state["params"], state["opt_state"]
        loss, leaves = _backward(params, batch, cfg, dev)
        grads = [leaf.grad for leaf in leaves]
        for leaf in leaves:
            leaf.grad = None
        # The leaves share the params' storage: updating them in place
        # updates state["params"].
        new_opt, gnorm = tx.update_(leaves, grads, _pieces(opt["mu"], L),
                                    _pieces(opt["nu"], L), opt)
        del grads
        new_state = {"params": params, "opt_state": new_opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss.item(), "grad_norm": gnorm,
                           "step": new_state["step"]}

    return TrainStepBundle(cfg=cfg, init=init, step=step, optimizer=tx,
                           device=dev)


def _copy_state(state):
    opt = state["opt_state"]
    return {"params": _map(torch.clone, state["params"]),
            "opt_state": {**opt, "mu": _map(torch.clone, opt["mu"]),
                          "nu": _map(torch.clone, opt["nu"])},
            "step": state["step"]}


def make_eval_step(cfg: TransformerConfig, mesh=None,
                   device: Union[str, torch.device] = "cuda"):
    """``eval(params, batch) -> loss`` (0-d f32 tensor), without grads."""
    if mesh is not None:
        raise NotImplementedError("meshes are not ported yet")
    dev = resolve_device(device)

    @torch.no_grad()
    def _eval(params, batch):
        return loss_fn(params, batch, cfg, device=dev)

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
                   device: Union[str, torch.device] = "cuda"
                   ) -> Dict[str, Any]:
    """Carry a JAX train state across: ``np_state`` is the state of the
    reference's ``make_train_step`` as numpy arrays
    (``jax.tree.map(np.asarray, state)``). Its params and the Adam mu, nu
    and count, and the schedule's count, are copied bit-exactly onto
    ``device``, so training continues where JAX left off."""
    opt = np_state["opt_state"]
    adam = _find(opt, lambda n: hasattr(n, "mu") and hasattr(n, "nu"))
    sched = _find(opt, lambda n: getattr(n, "_fields", None) == ("count",))
    if adam is None or sched is None:
        raise ValueError("opt_state holds no Adam moments and schedule "
                         "count: not the state of make_optimizer's chain")
    return {"params": from_jax_params(np_state["params"], cfg, device),
            "opt_state": {"count": int(np.asarray(adam.count)),
                          "mu": from_jax_params(adam.mu, cfg, device),
                          "nu": from_jax_params(adam.nu, cfg, device),
                          "schedule_count": int(np.asarray(sched.count))},
            "step": int(np.asarray(np_state["step"]))}
