"""SAC (discrete): soft actor-critic with twin Q networks and learned
entropy temperature.

Port of ray_tpu/rllib/sac.py (reference surface:
python/ray/rllib/algorithms/sac/sac.py — SACConfig / training_step:
sample -> store -> replay -> train -> polyak target sync — and
algorithms/sac/torch/sac_torch_learner.py, the critic/actor/alpha losses).
As in the reference, all three losses are one objective: detached inputs
isolate each loss's parameters, so a single optimizer step updates pi, q1,
q2 and log_alpha together, and the polyak target update is part of the
same step.

Discrete-action formulation (the policy head emits categorical logits, so
expectations over actions are exact sums instead of reparameterized
samples): soft state value V(s') = E_{a~pi}[min Q_target(s',a) - alpha
log pi(a|s')]; actor loss E_s[ pi(s)^T (alpha log pi(s) - min Q(s)) ];
temperature loss  log_alpha * (H(pi(s)) - H_target).
"""

from __future__ import annotations

import copy
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from .algorithm import Algorithm, AlgorithmConfig
from .dqn import fold_nstep
from .learner import Learner, floats, polyak_, to_device
from .replay_buffers import PrioritizedReplayBuffer, ReplayBuffer
from .rl_module import MLP, RLModuleSpec, init_mlp_, snapshot


class SACNet(nn.Module):
    """The learner's params: ``pi`` (policy logits), ``q1``/``q2``
    (per-action Q heads) and the scalar ``log_alpha`` (temperature)."""

    def __init__(self, spec: RLModuleSpec, initial_alpha: float,
                 seed: int = 0):
        super().__init__()
        sizes = (spec.obs_dim,) + spec.hiddens + (spec.num_actions,)
        gen = torch.Generator().manual_seed(seed)
        for name in ("pi", "q1", "q2"):
            setattr(self, name, MLP(sizes))
            init_mlp_(getattr(self, name), gen)
        self.log_alpha = nn.Parameter(torch.tensor(
            np.log(initial_alpha), dtype=torch.float32))


class SACLearner(Learner):
    """Twin-Q soft actor-critic learner (reference:
    sac_torch_learner.py). ``self.net`` is the SACNet; ``self.target``
    holds polyak-averaged copies of q1/q2, refreshed inside the step."""

    def __init__(self, spec_kwargs, config, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.spec = RLModuleSpec(**spec_kwargs)
        self.cfg = dict(config)
        self.net = SACNet(self.spec, self.cfg.get("initial_alpha", 1.0),
                          seed).to(self.device)
        self.target = copy.deepcopy(nn.ModuleDict(
            {"q1": self.net.q1, "q2": self.net.q2})).requires_grad_(False)
        # One optimizer over every param: the loss wiring (detached
        # inputs) decides which loss reaches which tensor, matching the
        # reference's per-component optimizers without three passes.
        self._init_optimizer(default_clip=40.0)
        self.target_entropy = float(self.cfg.get(
            "target_entropy", 0.5 * np.log(self.spec.num_actions)))
        self._updates = 0

    # ----------------------------------------------------------- losses ---
    def _losses(self, batch):
        net = self.net
        obs, next_obs = batch["obs"], batch["next_obs"]
        actions = batch["actions"].long()[:, None]
        alpha = torch.exp(net.log_alpha).detach()

        # --- critic loss: soft Bellman target from the target twins.
        with torch.no_grad():
            logp_next = F.log_softmax(net.pi(next_obs), dim=-1)
            pi_next = torch.exp(logp_next)
            q_next = torch.minimum(self.target["q1"](next_obs),
                                   self.target["q2"](next_obs))
            v_next = torch.sum(pi_next * (q_next - alpha * logp_next),
                               dim=-1)
            y = (batch["rewards"] + batch["discounts"]
                 * (1.0 - batch["dones"].float()) * v_next)
        q1_all, q2_all = net.q1(obs), net.q2(obs)
        q1_sel = q1_all.gather(1, actions)[:, 0]
        q2_sel = q2_all.gather(1, actions)[:, 0]
        w = batch["weights"]
        critic_loss = (w * ((q1_sel - y) ** 2 + (q2_sel - y) ** 2)).mean()

        # --- actor loss: exact expectation over the discrete simplex.
        logp = F.log_softmax(net.pi(obs), dim=-1)
        pi = torch.exp(logp)
        q_min = torch.minimum(q1_all, q2_all).detach()
        actor_loss = (w * torch.sum(pi * (alpha * logp - q_min),
                                    dim=-1)).mean()

        # --- temperature: drive policy entropy toward the target.
        entropy = -torch.sum(pi * logp, dim=-1)
        alpha_loss = (net.log_alpha * (
            entropy - self.target_entropy).detach()).mean()

        total = critic_loss + actor_loss + alpha_loss
        td = (q1_sel - y).detach()
        return total, {"critic_loss": critic_loss,
                       "actor_loss": actor_loss,
                       "alpha_loss": alpha_loss,
                       "alpha": alpha,
                       "entropy": entropy.mean()}, td

    # ----------------------------------------------------------- update ---
    def update(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        batch = self._apply_learner_connectors(batch)
        n = len(batch["rewards"])
        tb = to_device({
            "obs": batch["obs"], "next_obs": batch["next_obs"],
            "actions": batch["actions"], "rewards": batch["rewards"],
            "dones": batch["dones"],
            "discounts": batch.get(
                "discounts",
                np.full(n, self.cfg.get("gamma", 0.99), np.float32)),
            "weights": batch.get("weights", np.ones(n, np.float32)),
        }, self.device)
        loss, metrics, td = self._losses(tb)
        self._apply(loss)
        polyak_(self.target, self.net, self.cfg.get("tau", 0.005))
        self._updates += 1
        out: Dict[str, Any] = floats(metrics)
        out.update({"td_errors": td.cpu().numpy(),
                    "num_updates": self._updates})
        return out

    def get_weights(self):
        # Runners only sample from pi (forward_sample); Q nets stay home.
        return {f"pi.{k}": v.detach().clone()
                for k, v in self.net.pi.state_dict().items()}

    def get_state(self) -> Dict[str, Any]:
        s = super().get_state()
        s.update({"target": snapshot(self.target),
                  "updates": self._updates})
        return s

    def set_state(self, state: Dict[str, Any]):
        super().set_state(state)
        self.target.load_state_dict(state["target"])
        self._updates = state.get("updates", 0)


class SAC(Algorithm):
    """sample (from pi) -> replay-store -> k x (replay-sample -> soft
    update) (reference: sac.py training_step)."""

    learner_class = SACLearner

    def __init__(self, config: "SACConfig", runtime=None):
        super().__init__(config, runtime)
        tc = config.train_config
        if tc.get("prioritized_replay", False):
            self.replay = PrioritizedReplayBuffer(
                tc.get("buffer_size", 50_000),
                alpha=tc.get("prioritized_replay_alpha", 0.6),
                seed=config.seed)
        else:
            self.replay = ReplayBuffer(tc.get("buffer_size", 50_000),
                                       seed=config.seed)
        self._timesteps = 0

    def training_step(self) -> Dict[str, Any]:
        tc = self.config.train_config
        weights_ref = self._rt.put(self.learner_group.get_weights())
        t0 = time.monotonic()
        samples = self._rt.get(
            [r.sample_transitions.remote(
                weights_ref, self.config.rollout_fragment_length,
                -1.0)                      # <0: sample from pi (see runner)
             for r in self.env_runner_group.runners], timeout=300)
        sample_s = time.monotonic() - t0
        for s in samples:
            self._episode_returns.extend(s.pop("episode_returns"))
            self._timesteps += s["rewards"].size
            self.replay.add(fold_nstep(s, tc.get("n_step", 1),
                                       self.config.gamma))
        metrics: Dict[str, Any] = {"num_env_steps": self._timesteps,
                                   "sample_time_s": sample_s}
        if self._timesteps < tc.get("learning_starts", 1_000):
            return metrics
        t1 = time.monotonic()
        prioritized = tc.get("prioritized_replay", False)
        for _ in range(tc.get("num_updates_per_iteration", 16)):
            if prioritized:
                batch = self.replay.sample(
                    tc.get("train_batch_size", 64),
                    beta=tc.get("prioritized_replay_beta", 0.4))
            else:
                batch = self.replay.sample(tc.get("train_batch_size", 64))
            out = self.learner_group.update(batch)
            td = out.pop("td_errors", None)
            if prioritized and td is not None:
                self.replay.update_priorities(batch["batch_indexes"], td)
            metrics.update(out)
        metrics["learn_time_s"] = time.monotonic() - t1
        return metrics


class SACConfig(AlgorithmConfig):
    algo_class = SAC

    def __init__(self):
        super().__init__()
        self.lr = 3e-4
        self.rollout_fragment_length = 16
        self.train_config.update({
            "n_step": 1,
            "buffer_size": 50_000,
            "train_batch_size": 64,
            "learning_starts": 1_000,
            "num_updates_per_iteration": 16,
            "tau": 0.005,
            "initial_alpha": 1.0,
            "prioritized_replay": False,
            "grad_clip": 40.0,
        })

    def training(self, *, tau: Optional[float] = None,
                 initial_alpha: Optional[float] = None,
                 target_entropy: Optional[float] = None,
                 n_step: Optional[int] = None,
                 buffer_size: Optional[int] = None,
                 train_batch_size: Optional[int] = None,
                 learning_starts: Optional[int] = None,
                 num_updates_per_iteration: Optional[int] = None,
                 prioritized_replay: Optional[bool] = None,
                 **kwargs) -> "SACConfig":
        for k, v in (("tau", tau),
                     ("initial_alpha", initial_alpha),
                     ("target_entropy", target_entropy),
                     ("n_step", n_step),
                     ("buffer_size", buffer_size),
                     ("train_batch_size", train_batch_size),
                     ("learning_starts", learning_starts),
                     ("num_updates_per_iteration",
                      num_updates_per_iteration),
                     ("prioritized_replay", prioritized_replay)):
            if v is not None:
                self.train_config[k] = v
        super().training(**kwargs)
        return self
