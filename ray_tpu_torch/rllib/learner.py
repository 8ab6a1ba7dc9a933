"""Learner: gradient computation/application for PPO-family losses.

Port of ray_tpu/rllib/learner.py (reference surface:
python/ray/rllib/core/learner/learner.py:112 — compute_gradients,
apply_gradients, update). A minibatch step is the loss, ``autograd.grad``
and the optax chain ``clip_by_global_norm`` then ``adam``
(``models.train_step.Adam``) on the learner's device; the batch goes to
the device once per update and is indexed there. GAE, advantage
normalisation and the minibatch permutation are numpy, as in the
reference, so a seed gives the same minibatches in both packages.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Union

import numpy as np
import torch

from .._device import resolve_device
from ..models.train_step import Adam, _find
from ._runtime import LocalRuntime
from .rl_module import RLModule, RLModuleSpec, snapshot, state_dict_from_jax


def compute_gae(rewards, values, dones, bootstrap_value, gamma, lam):
    """Generalized advantage estimation over a [T, N] rollout (time-major).
    Pure numpy on purpose: runs on the learner's host once per batch;
    the hot math (loss/grads) is the device part."""
    T, N = rewards.shape
    adv = np.zeros((T, N), np.float32)
    last = np.zeros(N, np.float32)
    next_value = bootstrap_value
    for t in range(T - 1, -1, -1):
        nonterminal = 1.0 - dones[t].astype(np.float32)
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        last = delta + gamma * lam * nonterminal * last
        adv[t] = last
        next_value = values[t]
    returns = adv + values
    return adv, returns


def to_device(arrays: Mapping[str, Any], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in arrays.items()}


def floats(metrics: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """0-d tensors as Python floats, in one copy to the host."""
    values = torch.stack([v.detach().float() for v in metrics.values()])
    return dict(zip(metrics, values.tolist()))


@torch.no_grad()
def polyak_(target: torch.nn.ModuleDict, net: torch.nn.Module,
            tau: float) -> None:
    """target <- (1 - tau) * target + tau * net, head by head: each of
    ``target``'s heads against the net's head of the same name."""
    for name, head in target.items():
        for t, o in zip(head.parameters(), getattr(net, name).parameters()):
            t.mul_(1 - tau).add_(o, alpha=tau)


def state_from_jax(np_state: Mapping[str, Any]) -> Dict[str, Any]:
    """A reference learner's ``get_state()`` (numpy leaves, optax's state
    as its named tuples) in the port's layout: every param tree
    (``params``, ``target_params``, ``target``) as a state dict, the
    chained optax state ``(clip's EmptyState, (ScaleByAdamState(count, mu,
    nu), EmptyState))`` as ``{"count", "mu", "nu"}``, counts as ints."""
    out: Dict[str, Any] = {}
    for key, node in np_state.items():
        if key == "opt_state":
            adam = _find(node, lambda n: hasattr(n, "mu")
                         and hasattr(n, "nu"))
            if adam is None:
                raise ValueError("opt_state holds no Adam moments")
            out[key] = {"count": int(np.asarray(adam.count)),
                        "mu": state_dict_from_jax(adam.mu),
                        "nu": state_dict_from_jax(adam.nu)}
        elif isinstance(node, Mapping):
            out[key] = state_dict_from_jax(node)
        else:
            out[key] = int(np.asarray(node))
    return out


class Learner:
    """Single-process learner holding the module and optimizer state on
    one device.

    update(batches) -> metrics; get_weights() ships a state dict snapshot
    (reference: Learner.update / get_state). ``self.net`` is
    the module whose parameters the optimizer updates (the RLModule here;
    SAC's twin-Q net)."""

    def __init__(self, spec_kwargs: Dict[str, Any], config: Dict[str, Any],
                 seed: int = 0, device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.module: RLModule = RLModuleSpec(**spec_kwargs).build(
            seed, self.device)
        self.net = self.module
        self.cfg = dict(config)
        self._init_optimizer(default_clip=0.5)
        self._rng = np.random.default_rng(seed)

    @classmethod
    def from_jax_state(cls, np_state: Mapping[str, Any],
                       spec_kwargs: Dict[str, Any], config: Dict[str, Any],
                       device: Union[str, torch.device] = "cuda",
                       seed: int = 0) -> "Learner":
        """A learner continuing from the reference learner's state
        (``jax.tree.map(np.asarray, learner.get_state())``), bit-exactly:
        params, targets, Adam's count and moments, update counts.
        ``seed`` seeds the numpy generator as the reference's seed
        did."""
        learner = cls(spec_kwargs, config, seed, device)
        learner.set_state(state_from_jax(np_state))
        return learner

    def _init_optimizer(self, default_clip: float) -> None:
        self.opt = Adam(learning_rate=self.cfg.get("lr", 3e-4),
                        grad_clip=self.cfg.get("grad_clip", default_clip))
        self._params = dict(self.net.named_parameters())
        self.opt_state = self.opt.init(self._params)

    def _apply(self, loss: torch.Tensor) -> None:
        """One optimizer step on the gradients of ``loss``."""
        grads = torch.autograd.grad(loss, list(self._params.values()),
                                    allow_unused=True)
        self.opt_state, _ = self.opt.update_(
            self._params, dict(zip(self._params, grads)), self.opt_state)

    # The PPO clipped-surrogate loss (reference: ppo.py loss).
    def _loss(self, batch):
        logp, entropy, value = self.module.forward_train(
            batch["obs"], batch["actions"])
        ratio = torch.exp(logp - batch["logp_old"])
        clip = self.cfg.get("clip_param", 0.2)
        adv = batch["advantages"]
        pg = -torch.minimum(
            ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv).mean()
        vf_loss = 0.5 * ((value - batch["returns"]) ** 2).mean()
        ent = entropy.mean()
        total = (pg + self.cfg.get("vf_loss_coeff", 0.5) * vf_loss
                 - self.cfg.get("entropy_coeff", 0.0) * ent)
        return total, {"policy_loss": pg, "vf_loss": vf_loss, "entropy": ent}

    def _minibatch_step(self, batch):
        loss, metrics = self._loss(batch)
        self._apply(loss)
        metrics["total_loss"] = loss
        return metrics

    def _apply_learner_connectors(self, data: Dict[str, Any]
                                  ) -> Dict[str, Any]:
        """Learner-side connector pipeline (reference: ConnectorV2 learner
        pipelines — e.g. reward clipping) applied to each batch before the
        update."""
        for c in self.cfg.get("learner_connectors") or []:
            data = c(data, None)
        return data

    def update(self, samples: List[Dict[str, Any]]) -> Dict[str, float]:
        """One PPO update over the collected rollouts: GAE -> flatten ->
        num_epochs x minibatch SGD (reference: Learner.update driving
        minibatch iteration)."""
        gamma = self.cfg.get("gamma", 0.99)
        lam = self.cfg.get("lambda_", 0.95)
        obs, actions, logp_old, advs, rets = [], [], [], [], []
        samples = [self._apply_learner_connectors(s) for s in samples]
        for s in samples:
            rewards = s["rewards"]
            if "trunc_bonus" in s:
                # Truncation bootstrap re-added AFTER connectors so e.g.
                # reward clipping never clips the gamma*V(s_T) term.
                rewards = rewards + s["trunc_bonus"]
            adv, ret = compute_gae(rewards, s["vf"], s["dones"],
                                   s["bootstrap_value"], gamma, lam)
            obs.append(s["obs"].reshape(-1, s["obs"].shape[-1]))
            actions.append(s["actions"].reshape(-1))
            logp_old.append(s["logp"].reshape(-1))
            advs.append(adv.reshape(-1))
            rets.append(ret.reshape(-1))
        obs = np.concatenate(obs)
        advs = np.concatenate(advs)
        advs = (advs - advs.mean()) / (advs.std() + 1e-8)
        flat = to_device({"obs": obs, "actions": np.concatenate(actions),
                          "logp_old": np.concatenate(logp_old),
                          "advantages": advs,
                          "returns": np.concatenate(rets)}, self.device)

        n = obs.shape[0]
        mb = min(self.cfg.get("minibatch_size", 256), n)
        last: Dict[str, Any] = {}
        for _ in range(self.cfg.get("num_epochs", 4)):
            perm = torch.from_numpy(self._rng.permutation(n)).to(self.device)
            for start in range(0, n - mb + 1, mb):
                idx = perm[start:start + mb]
                last = self._minibatch_step(
                    {k: v[idx] for k, v in flat.items()})
        metrics = floats(last) if last else {}
        metrics["num_samples"] = float(n)
        return metrics

    def get_weights(self) -> Dict[str, torch.Tensor]:
        return snapshot(self.module)

    def get_state(self) -> Dict[str, Any]:
        """Copies on the learner's device: params, Adam's count and
        moments."""
        opt = self.opt_state
        return {"params": snapshot(self.net),
                "opt_state": {"count": opt["count"],
                              "mu": {k: v.clone() for k, v in
                                     opt["mu"].items()},
                              "nu": {k: v.clone() for k, v in
                                     opt["nu"].items()}}}

    @torch.no_grad()
    def set_state(self, state: Dict[str, Any]) -> None:
        """Copy ``state`` (of ``get_state``'s layout, tensors on any
        device) into the learner's own tensors."""
        self.net.load_state_dict(state["params"])
        opt = state["opt_state"]
        for k in self._params:
            self.opt_state["mu"][k].copy_(opt["mu"][k])
            self.opt_state["nu"][k].copy_(opt["nu"][k])
        self.opt_state["count"] = int(opt["count"])


class LearnerGroup:
    """Local or remote learner placement (reference:
    core/learner/learner_group.py:101). num_learners=0 runs in-process
    (the training loop's); 1 runs the learner as an actor of ``runtime``.
    learner_cls selects the loss family (PPO default, DQN/IMPALA
    subclasses)."""

    def __init__(self, spec_kwargs, config, *, num_learners: int = 0,
                 learner_resources=None, seed: int = 0,
                 learner_cls: type = None,
                 device: Union[str, torch.device] = "cuda", runtime=None):
        learner_cls = learner_cls or Learner
        self._rt = runtime or LocalRuntime()
        self.is_remote = num_learners > 0
        if self.is_remote:
            res = dict(learner_resources or {})
            self.learner = self._rt.remote(
                learner_cls, num_cpus=res.get("num_cpus", 1),
                resources=res.get("resources"))(
                spec_kwargs, config, seed, device)
        else:
            self.learner = learner_cls(spec_kwargs, config, seed, device)

    def update(self, samples):
        """samples may contain references; the remote path passes them
        through unresolved (the learner actor pulls the data, the loop
        never materializes it — reference: LearnerGroup async updates)."""
        res = self.update_async(samples)
        if self.is_remote:
            return self._rt.get(res, timeout=600)
        return res

    def update_async(self, samples):
        """Non-blocking variant: returns a reference for remote learner
        groups or the finished metrics dict for in-process groups."""
        if self.is_remote:
            return self.learner.update.remote(samples)
        return self.learner.update(samples)

    def get_weights(self):
        if self.is_remote:
            return self._rt.get(self.learner.get_weights.remote(),
                                timeout=120)
        return self.learner.get_weights()

    def get_state(self):
        if self.is_remote:
            return self._rt.get(self.learner.get_state.remote(), timeout=120)
        return self.learner.get_state()

    def set_state(self, state):
        if self.is_remote:
            self._rt.get(self.learner.set_state.remote(state), timeout=120)
        else:
            self.learner.set_state(state)

    def stop(self):
        if self.is_remote:
            self._rt.kill(self.learner)
