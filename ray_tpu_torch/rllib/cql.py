"""CQL: Conservative Q-Learning over a recorded transition corpus.

Port of ray_tpu/rllib/cql.py (reference surface:
python/ray/rllib/algorithms/cql/cql.py, with cql_torch_learner.py — SAC
backbone plus the conservative regularizer
``alpha * (logsumexp_a Q(s,a) - Q(s, a_data))``). As in the reference, the
env family is discrete, so the learner is the discrete CQL(H)
instantiation: the conservative penalty is exact (the logsumexp runs over
the action axis instead of sampled actions) on a twin-Q TD backbone.

One update (TD loss, conservative penalty, one optimizer step, then the
polyak target on the new params) runs on the learner's device
(``offline.TransitionUpdatesMixin``).
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from .algorithm import AlgorithmConfig
from .learner import Learner
from .offline import (OfflineConfigMixin, OfflineTransitionAlgorithm,
                      TransitionUpdatesMixin)
from .rl_module import MLP, RLModuleSpec, init_mlp_

__all__ = ["CQL", "CQLConfig"]


class CQLNet(nn.Module):
    """The learner's params: the twin per-action Q heads ``q1``/``q2``."""

    def __init__(self, spec: RLModuleSpec, seed: int = 0):
        super().__init__()
        sizes = (spec.obs_dim,) + spec.hiddens + (spec.num_actions,)
        gen = torch.Generator().manual_seed(seed)
        for name in ("q1", "q2"):
            setattr(self, name, MLP(sizes))
            init_mlp_(getattr(self, name), gen)


class CQLLearner(TransitionUpdatesMixin, Learner):
    """Twin-Q TD learner with the CQL(H) conservative penalty
    (reference: cql_torch_learner.py compute_loss_for_module)."""

    net_class = CQLNet

    def _loss(self, batch):
        net, target = self.net, self.target
        obs, next_obs = batch["obs"], batch["next_obs"]
        actions = batch["actions"].long()[:, None]

        # TD backbone: bootstrap from the target twins' min under the
        # greedy action of the ONLINE net (double-Q, as in the
        # reference's SAC target without the entropy term).
        with torch.no_grad():
            next_a = torch.argmax(net.q1(next_obs), dim=-1, keepdim=True)
            q_next = torch.minimum(
                target["q1"](next_obs).gather(1, next_a),
                target["q2"](next_obs).gather(1, next_a))[:, 0]
            y = (batch["rewards"] + self.cfg.get("gamma", 0.99)
                 * (1.0 - batch["dones"].float()) * q_next)

        q1_all, q2_all = net.q1(obs), net.q2(obs)
        q1_sel = q1_all.gather(1, actions)[:, 0]
        q2_sel = q2_all.gather(1, actions)[:, 0]
        td_loss = 0.5 * (((q1_sel - y) ** 2).mean()
                         + ((q2_sel - y) ** 2).mean())

        # Conservative penalty, exact for discrete actions: push down the
        # soft-max over all actions, push up the data action (reference:
        # cql_torch_learner.py's logsumexp term; CQL(H) in Kumar et al.).
        gap1 = (torch.logsumexp(q1_all, dim=-1) - q1_sel).mean()
        gap2 = (torch.logsumexp(q2_all, dim=-1) - q2_sel).mean()
        cql_loss = self.cfg.get("cql_alpha", 1.0) * 0.5 * (gap1 + gap2)

        total = td_loss + cql_loss
        return total, {"td_loss": td_loss, "cql_loss": cql_loss,
                       "q_data_mean": q1_sel.mean(),
                       "conservative_gap": 0.5 * (gap1 + gap2)}

    @staticmethod
    def greedy_fn():
        """(net, obs) -> actions for evaluation: argmax of q1."""
        def greedy(net, obs):
            return torch.argmax(net.q1(obs), dim=-1)
        return greedy


class CQL(OfflineTransitionAlgorithm):
    learner_class = CQLLearner


class CQLConfig(OfflineConfigMixin, AlgorithmConfig):
    algo_class = CQL

    def __init__(self):
        super().__init__()
        self.offline_data: Any = None
        self.lr = 3e-4
        self.train_config.update({
            "cql_alpha": 1.0, "tau": 0.005,
            "train_batch_size": 256, "num_updates_per_iteration": 64,
        })
