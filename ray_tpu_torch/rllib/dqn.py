"""DQN: double Q-learning with (optionally prioritized) replay.

Port of ray_tpu/rllib/dqn.py (reference surface:
python/ray/rllib/algorithms/dqn/dqn.py — DQNConfig / DQN training_step:
sample -> store -> replay -> train -> target sync — and
algorithms/dqn/torch/dqn_torch_learner.py, the double-Q TD loss). The TD
update (online and target forward, Huber loss, grads, the optax chain)
runs on the learner's device; the target network is a second RLModule
there.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .algorithm import Algorithm, AlgorithmConfig
from .learner import Learner, to_device
from .replay_buffers import PrioritizedReplayBuffer, ReplayBuffer
from .rl_module import snapshot


class DQNLearner(Learner):
    """TD learner with a target network (reference: dqn_torch_learner.py).

    update(batch) runs one double-DQN step; the target module refreshes
    every `target_network_update_freq` updates (counted here so remote
    learner placement needs no extra round-trips)."""

    def __init__(self, spec_kwargs, config, seed: int = 0, device="cuda"):
        super().__init__(spec_kwargs, config, seed, device)
        self.target = copy.deepcopy(self.module).requires_grad_(False)
        self._updates = 0

    # Q-values reuse the policy head: the categorical logits ARE the
    # action values for a value-based module (reference: DQN RLModule's
    # qf branch). The value head gets no gradient: zeros, as in JAX.
    def _dqn_loss(self, batch):
        q_all = self.module.pi(batch["obs"])
        actions = batch["actions"].long()[:, None]
        q_sel = q_all.gather(1, actions)[:, 0]
        with torch.no_grad():
            q_target = self.target.pi(batch["next_obs"])
            if self.cfg.get("double_q", True):
                # Double DQN: online net picks a*, target net evaluates it.
                next_a = torch.argmax(self.module.pi(batch["next_obs"]), -1)
                q_next = q_target.gather(1, next_a[:, None])[:, 0]
            else:
                q_next = torch.max(q_target, -1).values
            # Per-transition discount: gamma^k from n-step folding (k = the
            # actual horizon reached before an episode boundary).
            target = (batch["rewards"] + batch["discounts"]
                      * (1.0 - batch["dones"].float()) * q_next)
        td = q_sel - target
        # Huber on TD error, importance-weighted under PER.
        huber = torch.where(torch.abs(td) < 1.0, 0.5 * td * td,
                            torch.abs(td) - 0.5)
        loss = (batch["weights"] * huber).mean()
        return loss, td.detach()

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
        loss, td = self._dqn_loss(tb)
        self._apply(loss)
        self._updates += 1
        if self._updates % self.cfg.get(
                "target_network_update_freq", 200) == 0:
            self.target.load_state_dict(self.module.state_dict())
        out = torch.cat([loss.detach()[None], td]).cpu().numpy()
        return {"total_loss": float(out[0]),
                "td_errors": out[1:],
                "num_updates": self._updates}

    def get_state(self) -> Dict[str, Any]:
        s = super().get_state()
        s["target_params"] = snapshot(self.target)
        s["updates"] = self._updates
        return s

    def set_state(self, state: Dict[str, Any]):
        super().set_state(state)
        self.target.load_state_dict(
            state.get("target_params", state["params"]))
        self._updates = state.get("updates", 0)


def fold_nstep(sample: Dict[str, np.ndarray], n_step: int,
               gamma: float) -> Dict[str, np.ndarray]:
    """Fold time-major [T, N] rollout columns into flat n-step
    transitions: R = sum_k gamma^k r_{t+k} up to (and including) the
    first episode boundary in the window; the Q target bootstraps from
    the window's last next_obs with the matching gamma^k discount
    (reference: rllib n_step handling in
    utils/replay_buffers + dqn loss)."""
    T, N = sample["rewards"].shape
    rewards = sample["rewards"]
    resets = sample["resets"]
    out_rew = np.zeros((T, N), np.float32)
    out_disc = np.zeros((T, N), np.float32)
    out_next = np.empty_like(sample["next_obs"])
    out_done = np.zeros((T, N), bool)
    for i in range(N):
        for t in range(T):
            r_acc, disc = 0.0, 1.0
            j = t
            for k in range(n_step):
                j = t + k
                if j >= T:
                    j -= 1
                    break
                r_acc += disc * rewards[j, i]
                disc *= gamma
                if resets[j, i]:
                    break
            out_rew[t, i] = r_acc
            out_disc[t, i] = disc
            out_next[t, i] = sample["next_obs"][j, i]
            out_done[t, i] = sample["dones"][j, i]
    flat = lambda a: a.reshape((T * N,) + a.shape[2:])  # noqa: E731
    return {
        "obs": flat(sample["obs"]),
        "actions": flat(sample["actions"]),
        "rewards": flat(out_rew),
        "next_obs": flat(out_next),
        "dones": flat(out_done),
        "discounts": flat(out_disc),
    }


class DQN(Algorithm):
    """sample -> replay-store -> k x (replay-sample -> TD update)
    (reference: dqn.py training_step)."""

    learner_class = DQNLearner

    def __init__(self, config: "DQNConfig", runtime=None):
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

    def _epsilon(self) -> float:
        tc = self.config.train_config
        start = tc.get("epsilon_start", 1.0)
        end = tc.get("epsilon_end", 0.05)
        horizon = tc.get("epsilon_timesteps", 10_000)
        frac = min(1.0, self._timesteps / horizon)
        return start + frac * (end - start)

    def training_step(self) -> Dict[str, Any]:
        tc = self.config.train_config
        weights_ref = self._rt.put(self.learner_group.get_weights())
        eps = self._epsilon()
        t0 = time.monotonic()
        samples = self._rt.get(
            [r.sample_transitions.remote(
                weights_ref, self.config.rollout_fragment_length, eps)
             for r in self.env_runner_group.runners], timeout=300)
        sample_s = time.monotonic() - t0
        n_step = tc.get("n_step", 1)
        for s in samples:
            self._episode_returns.extend(s.pop("episode_returns"))
            self._timesteps += s["rewards"].size
            self.replay.add(fold_nstep(s, n_step,
                                       self.config.gamma))

        metrics: Dict[str, Any] = {"epsilon": eps,
                                   "num_env_steps": self._timesteps,
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


class DQNConfig(AlgorithmConfig):
    algo_class = DQN

    def __init__(self):
        super().__init__()
        self.lr = 5e-4
        self.rollout_fragment_length = 16
        self.train_config.update({
            "double_q": True,
            "n_step": 3,
            "buffer_size": 50_000,
            "train_batch_size": 64,
            "learning_starts": 1_000,
            "target_network_update_freq": 200,
            "num_updates_per_iteration": 16,
            "epsilon_start": 1.0,
            "epsilon_end": 0.05,
            "epsilon_timesteps": 10_000,
            "prioritized_replay": False,
            "grad_clip": 10.0,
        })

    def training(self, *, double_q: Optional[bool] = None,
                 n_step: Optional[int] = None,
                 buffer_size: Optional[int] = None,
                 train_batch_size: Optional[int] = None,
                 learning_starts: Optional[int] = None,
                 target_network_update_freq: Optional[int] = None,
                 num_updates_per_iteration: Optional[int] = None,
                 epsilon_timesteps: Optional[int] = None,
                 prioritized_replay: Optional[bool] = None,
                 **kwargs) -> "DQNConfig":
        for k, v in (("double_q", double_q),
                     ("n_step", n_step),
                     ("buffer_size", buffer_size),
                     ("train_batch_size", train_batch_size),
                     ("learning_starts", learning_starts),
                     ("target_network_update_freq",
                      target_network_update_freq),
                     ("num_updates_per_iteration",
                      num_updates_per_iteration),
                     ("epsilon_timesteps", epsilon_timesteps),
                     ("prioritized_replay", prioritized_replay)):
            if v is not None:
                self.train_config[k] = v
        super().training(**kwargs)
        return self
