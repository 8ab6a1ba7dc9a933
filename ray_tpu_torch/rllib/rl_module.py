"""RLModule: the policy/value network, as a torch module.

Port of ray_tpu/rllib/rl_module.py (reference surface:
python/ray/rllib/core/rl_module/rl_module.py — an RLModule bundles the
neural net plus forward_exploration / forward_inference / forward_train
views over it). The reference keeps params as a pytree beside pure
functions; here the module owns them as ``nn.Linear`` layers, layer ``i``
of ``pi`` or ``vf`` holding the reference's ``params["pi"][i]`` with its
``w`` of ``(in, out)`` stored transposed as ``weight``.

Weights cross between learner and runners as a state dict snapshot
(``get_weights`` / ``set_weights``), never as the learner's tensors.
Sampling takes an explicit ``torch.Generator`` in place of a JAX key: the
distribution is the reference's, the stream is not.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device


class RLModuleSpec:
    """Builds concrete modules from (obs_dim, num_actions, hiddens)
    (reference: core/rl_module/rl_module.py RLModuleSpec.build)."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hiddens: Sequence[int] = (64, 64)):
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hiddens = tuple(hiddens)

    def build(self, seed: int = 0,
              device: Union[str, torch.device] = "cuda") -> "RLModule":
        return RLModule(self, seed, device)


class MLP(nn.ModuleList):
    """``nn.Linear`` layers with tanh between them and none after the last
    (the reference's ``_mlp``)."""

    def __init__(self, sizes: Sequence[int]):
        super().__init__(nn.Linear(i, o) for i, o in zip(sizes[:-1],
                                                         sizes[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self):
            x = layer(x)
            if i < len(self) - 1:
                x = torch.tanh(x)
        return x


@torch.no_grad()
def init_mlp_(mlp: MLP, gen: torch.Generator) -> None:
    """The reference's ``_init_mlp``: weights normal x sqrt(2 / fan_in),
    biases zero, drawn on the host from ``gen`` (so a seed gives the same
    values on every device)."""
    for layer in mlp:
        fan_out, fan_in = layer.weight.shape
        w = torch.randn((fan_out, fan_in), generator=gen) * np.sqrt(
            2.0 / fan_in)
        layer.weight.copy_(w)
        layer.bias.zero_()


def log_softmax_pick(logits: torch.Tensor, actions: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log_softmax(logits), its entry at each row's action)."""
    logp_all = F.log_softmax(logits, dim=-1)
    return logp_all, logp_all.gather(-1, actions.long()[..., None])[..., 0]


def sample_categorical(logits: torch.Tensor,
                       gen: torch.Generator) -> torch.Tensor:
    """One draw per row: argmax(logits + Gumbel noise), the algorithm of
    ``jax.random.categorical``, with the noise from ``gen``."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device,
                   dtype=logits.dtype)
    tiny = torch.finfo(logits.dtype).tiny
    return torch.argmax(logits - torch.log(-torch.log(u.clamp_min(tiny))),
                        dim=-1)


class RLModule(nn.Module):
    """Actor-critic module with a categorical policy head.

    forward_* mirror the reference's forward views
    (rl_module.py forward_exploration/_inference/_train) on a batch of
    observations [N, obs_dim] on the module's device.
    """

    def __init__(self, spec: RLModuleSpec, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.spec = spec
        sizes = (spec.obs_dim,) + spec.hiddens
        self.pi = MLP(sizes + (spec.num_actions,))
        self.vf = MLP(sizes + (1,))
        gen = torch.Generator().manual_seed(seed)
        init_mlp_(self.pi, gen)
        init_mlp_(self.vf, gen)
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.pi[0].weight.device

    def logits_and_value(self, obs: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.pi(obs), self.vf(obs)[..., 0]

    def forward_exploration(self, obs: torch.Tensor, gen: torch.Generator):
        """Sample actions; returns (actions, logp, value)."""
        logits, value = self.logits_and_value(obs)
        actions = sample_categorical(logits, gen)
        return actions, log_softmax_pick(logits, actions)[1], value

    def forward_inference(self, obs: torch.Tensor) -> torch.Tensor:
        """Greedy actions (deterministic serving path)."""
        return torch.argmax(self.pi(obs), dim=-1)

    def forward_sample(self, obs: torch.Tensor,
                       gen: torch.Generator) -> torch.Tensor:
        """Sample from the policy head ONLY (no value readout): the
        exploration view for off-policy stochastic-policy algorithms
        (SAC), whose learner carries Q networks instead of `vf`."""
        return sample_categorical(self.pi(obs), gen)

    def forward_train(self, obs: torch.Tensor, actions: torch.Tensor):
        """(logp(actions), entropy, value) for the PPO loss."""
        logits, value = self.logits_and_value(obs)
        logp_all, logp = log_softmax_pick(logits, actions)
        entropy = -torch.sum(torch.exp(logp_all) * logp_all, dim=-1)
        return logp, entropy, value

    def set_weights(self, weights: Mapping[str, torch.Tensor]) -> None:
        """Copy ``weights`` (a state dict, maybe of the ``pi`` head alone,
        as SAC's learner sends) into this module's own tensors."""
        own = self.state_dict()
        unknown = set(weights) - set(own)
        missing = {k for k in own if k.startswith("pi.")} - set(weights)
        if unknown or missing:
            raise KeyError(f"weights do not fit this module: unknown "
                           f"{sorted(unknown)}, missing {sorted(missing)}")
        self.load_state_dict(weights, strict=False)


def snapshot(module: nn.Module) -> Dict[str, torch.Tensor]:
    """A copy of ``module``'s state dict on its device, sharing no storage
    with it."""
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def state_dict_from_jax(tree: Mapping[str, Any], prefix: str = ""
                        ) -> Dict[str, torch.Tensor]:
    """A reference param tree (``{"pi": [{"w", "b"}, ...], ...}``, numpy
    leaves; a scalar leaf such as SAC's ``log_alpha`` included) as the
    state dict of the module holding it: ``pi.{i}.weight`` is layer i's
    ``w`` transposed, ``pi.{i}.bias`` its ``b``."""
    out: Dict[str, torch.Tensor] = {}
    for name, node in tree.items():
        if isinstance(node, (list, tuple)):
            for i, layer in enumerate(node):
                out[f"{prefix}{name}.{i}.weight"] = torch.from_numpy(
                    np.array(np.asarray(layer["w"]).T))
                out[f"{prefix}{name}.{i}.bias"] = torch.from_numpy(
                    np.array(layer["b"]))
        elif isinstance(node, Mapping):
            out.update(state_dict_from_jax(node, f"{prefix}{name}."))
        else:
            out[f"{prefix}{name}"] = torch.from_numpy(np.array(node))
    return out


def from_jax_params(np_tree: Mapping[str, Any], spec: RLModuleSpec,
                    device: Union[str, torch.device] = "cuda") -> RLModule:
    """An RLModule holding the reference's params ``np_tree`` (numpy
    leaves) on ``device``. A ``pi``-only tree, as SAC's learner sends its
    runners, loads the policy head alone (``vf`` keeps its seed-0
    init)."""
    module = RLModule(spec, 0, device)
    module.set_weights(state_dict_from_jax(np_tree))
    return module
