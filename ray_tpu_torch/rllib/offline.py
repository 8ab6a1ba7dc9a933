"""Offline RL: behavior cloning (BC) and advantage-weighted imitation
(MARWIL) over recorded episodes, and the training loop of the
transition learners (CQL, IQL).

Port of ray_tpu/rllib/offline.py (reference surface:
python/ray/rllib/algorithms/bc/bc.py and algorithms/marwil/marwil.py, with
offline/offline_data.py feeding recorded episodes through learner
connectors). The data pipeline is host-side numpy, copied as it is
(episodes -> flat arrays with Monte-Carlo returns computed once at load).
A learner call uploads the corpus to its device once and indexes it there
with the numpy generator's minibatch indices, so a seed draws the same
minibatches in both packages. A dataset is any object with ``take_all``.

Episode format: a dict with "obs" [T, D] float, "actions" [T] int, and
(MARWIL, CQL, IQL) "rewards" [T] float; "terminated" (default True) marks
an episode that ended in a real terminal.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List

import numpy as np
import torch
from torch import nn

from .._device import resolve_device
from . import envs
from ._runtime import LocalRuntime
from .algorithm import Algorithm, AlgorithmConfig
from .learner import Learner, LearnerGroup, floats, polyak_, to_device
from .rl_module import RLModule, RLModuleSpec, snapshot


def episodes_to_batch(episodes: List[Dict[str, np.ndarray]],
                      gamma: float) -> Dict[str, np.ndarray]:
    """Flatten episodes into one supervised batch with per-step
    Monte-Carlo returns-to-go (the MARWIL advantage baseline target)."""
    obs, actions, returns = [], [], []
    for ep in episodes:
        T = len(ep["actions"])
        obs.append(np.asarray(ep["obs"], np.float32))
        actions.append(np.asarray(ep["actions"], np.int64))
        rew = np.asarray(ep.get("rewards", np.zeros(T)), np.float32)
        rtg = np.zeros(T, np.float32)
        acc = 0.0
        for t in range(T - 1, -1, -1):
            acc = rew[t] + gamma * acc
            rtg[t] = acc
        returns.append(rtg)
    return {"obs": np.concatenate(obs),
            "actions": np.concatenate(actions),
            "returns": np.concatenate(returns)}


def episodes_to_transitions(episodes: List[Dict[str, np.ndarray]]
                            ) -> Dict[str, np.ndarray]:
    """Flatten episodes into one-step transition arrays (obs, actions,
    rewards, next_obs, dones) for TD-style offline learners (CQL/IQL).

    Terminal episodes (`terminated` truthy, the default) keep every step;
    the last one self-pads next_obs, which the done mask zeroes out of the
    TD target.  Truncated episodes (`terminated=False`: the recorder hit
    its horizon) DROP the final step — its true next_obs was never
    observed, and self-padding it with done=0 would train Q toward a
    bootstrapped self-loop (fixed point r/(1-gamma))."""
    obs, actions, rewards, next_obs, dones = [], [], [], [], []
    for ep in episodes:
        o = np.asarray(ep["obs"], np.float32)
        a = np.asarray(ep["actions"], np.int64)
        r = np.asarray(ep.get("rewards", np.zeros(len(a))), np.float32)
        T = len(a)
        terminated = bool(ep.get("terminated", True))
        if not terminated:
            if T < 2:
                continue     # a single truncated step carries no target
            obs.append(o[:-1])
            actions.append(a[:-1])
            rewards.append(r[:-1])
            next_obs.append(o[1:])
            dones.append(np.zeros(T - 1, np.float32))
            continue
        obs.append(o)
        actions.append(a)
        rewards.append(r)
        next_obs.append(np.concatenate([o[1:], o[-1:]]))
        d = np.zeros(T, np.float32)
        d[-1] = 1.0
        dones.append(d)
    if not obs:
        raise ValueError(
            "offline corpus contains no usable transitions (empty corpus, "
            "or every episode is truncated with fewer than 2 steps)")
    return {"obs": np.concatenate(obs),
            "actions": np.concatenate(actions),
            "rewards": np.concatenate(rewards),
            "next_obs": np.concatenate(next_obs),
            "dones": np.concatenate(dones)}


class OfflineConfigMixin:
    """The fluent offline-data section shared by every offline config
    (reference: AlgorithmConfig.offline_data())."""

    def offline(self, data):
        if not hasattr(data, "take_all") and not isinstance(data, list):
            # Materialize one-shot iterables NOW: build_algo() deepcopies
            # the config, and generators can't be copied (or re-read).
            data = list(data)
        self.offline_data = data
        return self


def greedy_rollout(env_name: str, greedy: Callable, params: nn.Module,
                   num_episodes: int) -> Dict[str, float]:
    """Roll ``greedy(params, obs[1, D]) -> actions`` greedily in a fresh
    ``envs.make(env_name)``, episode ``ep`` reset with seed ``1000 + ep``;
    the observations go to the device of ``params`` (the module holding
    the learned weights). The evaluation loop every offline algorithm
    shares."""
    device = next(params.parameters()).device
    env = envs.make(env_name)
    returns = []
    with torch.no_grad():
        for ep in range(num_episodes):
            obs, _ = env.reset(seed=1000 + ep)
            total, done = 0.0, False
            while not done:
                a = int(greedy(params, torch.from_numpy(
                    np.asarray(obs[None], np.float32)).to(device))[0])
                obs, r, term, trunc, _ = env.step(a)
                total += float(r)
                done = term or trunc
            returns.append(total)
    env.close()
    return {"episode_return_mean": float(np.mean(returns)),
            "num_episodes": num_episodes}


class BCLearner(Learner):
    """Negative-log-likelihood imitation (reference: bc_torch_learner);
    beta > 0 turns it into MARWIL's exp(beta * advantage) weighting with
    the value head as the learned baseline (reference:
    marwil_torch_learner.py loss)."""

    def _loss(self, batch):
        logp, entropy, value = self.module.forward_train(
            batch["obs"], batch["actions"])
        beta = self.cfg.get("beta", 0.0)
        if beta > 0.0:
            adv = batch["returns"] - value
            # MARWIL: vf regresses MC returns; the policy imitates with
            # exp(beta * normalized advantage) weights (detached: the
            # weight is data, not a gradient path).
            w = torch.exp(beta * (adv / (adv.abs().mean() + 1e-8)).detach())
            w = torch.clamp(w, max=self.cfg.get("max_weight", 20.0))
            pol = -(w * logp).mean()
            vf = 0.5 * (adv ** 2).mean()
        else:
            pol = -logp.mean()
            # Keeps the vf head in the graph: its gradients are zeros,
            # as JAX's are, so Adam decays its moments the same way.
            vf = 0.0 * value.mean()
        ent = entropy.mean()
        total = (pol + self.cfg.get("vf_loss_coeff", 1.0) * vf
                 - self.cfg.get("entropy_coeff", 0.0) * ent)
        return total, {"policy_loss": pol, "vf_loss": vf, "entropy": ent}

    def update_offline(self, batch: Dict[str, np.ndarray]
                       ) -> Dict[str, float]:
        """``num_epochs`` passes over the corpus in full minibatches, each
        pass in the order of one numpy permutation."""
        batch = self._apply_learner_connectors(batch)
        n = len(batch["actions"])
        mb = min(self.cfg.get("minibatch_size", 256), n)
        corpus = to_device({k: batch[k] for k in ("obs", "actions",
                                                  "returns")}, self.device)
        last: Dict[str, Any] = {}
        for _ in range(self.cfg.get("num_epochs", 1)):
            perm = torch.from_numpy(self._rng.permutation(n)).to(self.device)
            for start in range(0, n - mb + 1, mb):
                idx = perm[start:start + mb]
                last = self._minibatch_step(
                    {k: v[idx] for k, v in corpus.items()})
        return floats(last) if last else {}


def _offline_episodes(algo: Algorithm, config: AlgorithmConfig, runtime
                      ) -> List[Dict[str, Any]]:
    """The set-up every offline algorithm shares (reference: BC and
    OfflineTransitionAlgorithm skip ``Algorithm.__init__``: no env-runner
    group; the env is probed only for module shapes). Returns the corpus's
    episodes, materialized once."""
    algo.config = config
    algo._rt = runtime or LocalRuntime()
    algo.device = resolve_device(config.device)
    algo.iteration = 0
    algo._episode_returns = []
    algo._spec_kwargs = algo._module_spec_kwargs(config)
    algo.learner_group = LearnerGroup(
        algo._spec_kwargs, config.learner_config_dict(),
        num_learners=config.num_learners,
        learner_resources=config.learner_resources, seed=config.seed,
        learner_cls=algo.learner_class, device=algo.device,
        runtime=algo._rt)
    algo.env_runner_group = None
    data = config.offline_data
    if data is None:
        raise ValueError("config.offline(...) is required")
    if hasattr(data, "take_all"):
        # A dataset of episode rows (reference: OfflineData reads through
        # ray_tpu.data): materialize it.
        data = data.take_all()
    return list(data)       # generators iterate once


class BC(Algorithm):
    """Offline imitation: no env runners; iterations draw minibatches
    from the recorded corpus (reference: bc.py training_step over
    OfflineData)."""

    learner_class = BCLearner

    def __init__(self, config: "BCConfig", runtime=None):
        data = _offline_episodes(self, config, runtime)
        self._batch = episodes_to_batch(data, config.gamma)
        # MC return of each recorded episode, for reporting parity.
        self._episode_returns = [
            float(np.sum(np.asarray(ep.get("rewards", [0.0]))))
            for ep in data]

    def training_step(self) -> Dict[str, Any]:
        learner = self.learner_group.learner
        if self.config.num_learners > 0:
            return self._rt.get(learner.update_offline.remote(self._batch),
                                timeout=600)
        return learner.update_offline(self._batch)

    def evaluate(self, num_episodes: int = 10) -> Dict[str, float]:
        """Greedy rollout of the learned policy in the probe env
        (reference: Algorithm.evaluate with evaluation workers)."""
        module = RLModuleSpec(**self._spec_kwargs).build(device=self.device)
        module.set_weights(self.learner_group.get_weights())
        return greedy_rollout(self.config.env, RLModule.forward_inference,
                              module, num_episodes)

    def stop(self):
        self.learner_group.stop()


class BCConfig(OfflineConfigMixin, AlgorithmConfig):
    algo_class = BC

    def __init__(self):
        super().__init__()
        self.offline_data: Any = None
        self.lr = 1e-3
        self.train_config.update({"num_epochs": 1, "minibatch_size": 256,
                                  "beta": 0.0})


class MARWILConfig(BCConfig):
    """MARWIL = BC with exponential advantage weighting (reference:
    marwil.py; beta=1 default, beta=0 degrades to plain BC)."""

    def __init__(self):
        super().__init__()
        self.train_config.update({"beta": 1.0, "vf_loss_coeff": 1.0,
                                  "num_epochs": 1})


MARWIL = BC      # same training loop; the loss switches on beta


class TransitionUpdatesMixin:
    """The learner side of the transition algorithms (CQL, IQL).

    ``self.net`` is the subclass's ``net_class(spec, seed)`` on the
    learner's device and ``self.target`` frozen copies of its ``q1`` and
    ``q2``. One update is the subclass's ``_loss``, one Adam step (clip 40
    by default) and then the polyak target at ``tau`` on the new params.
    The corpus ships ONCE (by reference for remote learners) and goes to
    the device once per ``run_updates`` call; every update gathers its
    minibatch there, with no round-trip to the algorithm."""

    net_class: type = None

    def __init__(self, spec_kwargs, config, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.spec = RLModuleSpec(**spec_kwargs)
        self.cfg = dict(config)
        self.net = self.net_class(self.spec, seed).to(self.device)
        self.target = copy.deepcopy(nn.ModuleDict(
            {"q1": self.net.q1, "q2": self.net.q2})).requires_grad_(False)
        self._init_optimizer(default_clip=40.0)
        self._updates = 0
        self._rng = np.random.default_rng(seed)

    def run_updates(self, transitions: Dict[str, np.ndarray],
                    num_updates: int, batch_size: int) -> Dict[str, float]:
        n = len(transitions["actions"])
        corpus = to_device(transitions, self.device)
        last: Dict[str, float] = {}
        for _ in range(num_updates):
            idx = torch.from_numpy(self._rng.integers(
                0, n, min(batch_size, n))).to(self.device)
            last = self.update_transitions(
                {k: v[idx] for k, v in corpus.items()})
        return last

    def update_transitions(self, batch: Dict[str, torch.Tensor]
                           ) -> Dict[str, float]:
        """One update on a minibatch already on the learner's device."""
        metrics = self._minibatch_step(batch)
        polyak_(self.target, self.net, self.cfg.get("tau", 0.005))
        self._updates += 1
        out = floats(metrics)
        out["num_updates"] = self._updates
        return out

    def get_weights(self) -> Dict[str, torch.Tensor]:
        return snapshot(self.net)

    def get_state(self) -> Dict[str, Any]:
        s = super().get_state()
        s.update({"target": snapshot(self.target),
                  "updates": self._updates})
        return s

    def set_state(self, state: Dict[str, Any]):
        super().set_state(state)
        self.target.load_state_dict(state["target"])
        self._updates = state.get("updates", 0)


class OfflineTransitionAlgorithm(Algorithm):
    """Training loop shared by transition-based offline algorithms
    (CQL/IQL): no env runners; each iteration runs
    `num_updates_per_iteration` learner-side minibatch updates over the
    recorded transition corpus (reference: cql.py / iql.py training_step
    over OfflineData sample batches)."""

    learner_class: type = None

    def __init__(self, config: AlgorithmConfig, runtime=None):
        self._transitions = episodes_to_transitions(
            _offline_episodes(self, config, runtime))
        self._corpus_ref = None     # put once for a remote learner

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config.train_config
        bs = cfg.get("train_batch_size", 256)
        n_upd = cfg.get("num_updates_per_iteration", 64)
        learner = self.learner_group.learner
        if self.config.num_learners > 0:
            if self._corpus_ref is None:
                self._corpus_ref = self._rt.put(self._transitions)
            return self._rt.get(
                learner.run_updates.remote(self._corpus_ref, n_upd, bs),
                timeout=600)
        return learner.run_updates(self._transitions, n_upd, bs)

    def evaluate(self, num_episodes: int = 10) -> Dict[str, float]:
        """Greedy rollout of the learned policy in the probe env."""
        net = self.learner_class.net_class(RLModuleSpec(**self._spec_kwargs))
        net.load_state_dict(self.learner_group.get_weights())
        return greedy_rollout(self.config.env,
                              self.learner_class.greedy_fn(),
                              net.to(self.device), num_episodes)

    def stop(self):
        self.learner_group.stop()
