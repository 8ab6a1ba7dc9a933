"""IQL: Implicit Q-Learning over a recorded transition corpus.

Port of ray_tpu/rllib/iql.py (reference surface:
python/ray/rllib/algorithms/iql — expectile value learning +
advantage-weighted policy extraction; Kostrikov et al. 2021). Three heads
train jointly in one optimizer step on the learner's device:

- V via expectile regression toward Q_target(s, a_data): the tau-expectile
  of the data's Q implicitly performs the max over in-support actions
  without ever querying out-of-distribution ones.
- Q via TD toward r + gamma * V(s') (no argmax over actions anywhere —
  the defining IQL property).
- pi via advantage-weighted regression: -exp(beta * A) * log pi(a|s),
  A = Q_target(s,a) - V(s), weights clipped for stability.

The polyak target covers q1 and q2 only (``offline.TransitionUpdatesMixin``).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from .algorithm import AlgorithmConfig
from .learner import Learner
from .offline import (OfflineConfigMixin, OfflineTransitionAlgorithm,
                      TransitionUpdatesMixin)
from .rl_module import MLP, RLModuleSpec, init_mlp_

__all__ = ["IQL", "IQLConfig"]


class IQLNet(nn.Module):
    """The learner's params: per-action Q heads ``q1``/``q2``, the state
    value ``v`` and the policy logits ``pi``."""

    def __init__(self, spec: RLModuleSpec, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        for name, out in (("q1", spec.num_actions), ("q2", spec.num_actions),
                          ("v", 1), ("pi", spec.num_actions)):
            setattr(self, name,
                    MLP((spec.obs_dim,) + spec.hiddens + (out,)))
            init_mlp_(getattr(self, name), gen)


class IQLLearner(TransitionUpdatesMixin, Learner):
    """Expectile-value learner (reference: iql learner losses)."""

    net_class = IQLNet

    def _loss(self, batch):
        net, target = self.net, self.target
        obs, next_obs = batch["obs"], batch["next_obs"]
        actions = batch["actions"].long()[:, None]
        tau = self.cfg.get("expectile", 0.7)
        beta = self.cfg.get("beta", 3.0)

        with torch.no_grad():
            # Q of the DATA action under the frozen target twins: the only
            # Q readout that feeds V and the policy (never an argmax).
            q_data = torch.minimum(target["q1"](obs).gather(1, actions),
                                   target["q2"](obs).gather(1, actions))[:, 0]
            # The TD target r + gamma * V(s'), V frozen here.
            v_next = net.v(next_obs)[..., 0]
            y = (batch["rewards"] + self.cfg.get("gamma", 0.99)
                 * (1.0 - batch["dones"].float()) * v_next)

        # --- V: expectile regression of q_data - V(s).
        v = net.v(obs)[..., 0]
        diff = q_data - v
        w_exp = torch.where(diff > 0, tau, 1.0 - tau)
        v_loss = (w_exp * diff ** 2).mean()

        # --- Q: one-step TD toward y.
        q1_sel = net.q1(obs).gather(1, actions)[:, 0]
        q2_sel = net.q2(obs).gather(1, actions)[:, 0]
        q_loss = 0.5 * (((q1_sel - y) ** 2).mean()
                        + ((q2_sel - y) ** 2).mean())

        # --- pi: advantage-weighted regression (detached weights).
        adv = (q_data - v).detach()
        w = torch.clamp(torch.exp(beta * adv),
                        max=self.cfg.get("max_weight", 100.0))
        logp = F.log_softmax(net.pi(obs), dim=-1).gather(1, actions)[:, 0]
        pi_loss = -(w * logp).mean()

        total = v_loss + q_loss + pi_loss
        return total, {"v_loss": v_loss, "q_loss": q_loss,
                       "pi_loss": pi_loss, "adv_mean": adv.mean(),
                       "v_mean": v.mean()}

    @staticmethod
    def greedy_fn():
        """(net, obs) -> actions: the extracted policy's argmax."""
        def greedy(net, obs):
            return torch.argmax(net.pi(obs), dim=-1)
        return greedy


class IQL(OfflineTransitionAlgorithm):
    learner_class = IQLLearner


class IQLConfig(OfflineConfigMixin, AlgorithmConfig):
    algo_class = IQL

    def __init__(self):
        super().__init__()
        self.offline_data: Any = None
        self.lr = 3e-4
        self.train_config.update({
            "expectile": 0.7, "beta": 3.0, "tau": 0.005,
            "train_batch_size": 256, "num_updates_per_iteration": 64,
        })
