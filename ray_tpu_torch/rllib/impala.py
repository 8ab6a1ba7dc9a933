"""IMPALA: async actor-learner training with V-trace correction.

Port of ray_tpu/rllib/impala.py (reference surface:
python/ray/rllib/algorithms/impala/impala.py — IMPALAConfig/IMPALA
(:521), stateless AggregatorActor s between env-runners and learners
(:768, :916), async sample/update loops — and the V-trace returns of
Espeholt et al. 2018). V-trace is a loop over T on the learner's device
without gradient, in place of the reference's reverse ``lax.scan``; the
async plumbing is the runtime's references, as in the reference.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .algorithm import Algorithm, AlgorithmConfig
from .learner import Learner, floats, to_device
from .rl_module import log_softmax_pick


@torch.no_grad()
def vtrace(values, bootstrap, rewards, dones, rhos, gamma,
           rho_bar: float = 1.0, c_bar: float = 1.0):
    """V-trace targets + pg advantages over a [T, B] rollout (Espeholt
    et al. 2018, eqs. 1-2; reference impl: rllib vtrace in the IMPALA
    learner). Tensors on one device; no gradient flows through either
    output, as the reference's stop_gradient on both."""
    rho_c = torch.clamp(rhos, max=rho_bar)
    cs = torch.clamp(rhos, max=c_bar)
    next_values = torch.cat([values[1:], bootstrap[None]], dim=0)
    discounts = gamma * (1.0 - dones.float())
    deltas = rho_c * (rewards + discounts * next_values - values)
    corrections = torch.empty_like(deltas)
    acc = torch.zeros_like(bootstrap)
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + discounts[t] * cs[t] * acc
        corrections[t] = acc
    vs = values + corrections
    vs_next = torch.cat([vs[1:], bootstrap[None]], dim=0)
    pg_adv = rho_c * (rewards + discounts * vs_next - values)
    return vs, pg_adv


class ImpalaLearner(Learner):
    """One V-trace update per aggregated batch."""

    def _impala_loss(self, batch):
        T, B = batch["rewards"].shape
        flat_obs = batch["obs"].reshape(T * B, -1)
        logits, values = self.module.logits_and_value(flat_obs)
        logp_all, logp = log_softmax_pick(logits,
                                          batch["actions"].reshape(T * B))
        logp = logp.reshape(T, B)
        entropy = -torch.sum(torch.exp(logp_all) * logp_all, dim=-1).mean()
        values = values.reshape(T, B)
        with torch.no_grad():
            bootstrap = self.module.logits_and_value(batch["final_obs"])[1]

        rhos = torch.exp(logp - batch["logp_mu"])
        vs, pg_adv = vtrace(
            values, bootstrap, batch["rewards"], batch["dones"], rhos,
            self.cfg.get("gamma", 0.99),
            self.cfg.get("vtrace_clip_rho_threshold", 1.0),
            self.cfg.get("vtrace_clip_c_threshold", 1.0))
        pg_loss = self._pg_loss(rhos, pg_adv, logp)
        vf_loss = 0.5 * ((vs - values) ** 2).mean()
        total = (pg_loss + self.cfg.get("vf_loss_coeff", 0.5) * vf_loss
                 - self.cfg.get("entropy_coeff", 0.01) * entropy)
        return total, {"policy_loss": pg_loss, "vf_loss": vf_loss,
                       "entropy": entropy}

    def _pg_loss(self, rhos, pg_adv, logp):
        """Policy-gradient term: plain V-trace PG here; APPO overrides
        with the PPO clipped surrogate (the only difference between the
        two learners)."""
        return -(pg_adv * logp).mean()

    def update(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        episode_returns = list(batch.pop("episode_returns", []))
        batch = self._apply_learner_connectors(batch)
        rewards = batch["rewards"]
        if "trunc_bonus" in batch:
            # Re-add the truncation bootstrap AFTER connectors (reward
            # clipping must never clip the gamma*V(s_T) term).
            rewards = rewards + batch["trunc_bonus"]
        tb = to_device({"obs": batch["obs"], "actions": batch["actions"],
                        "logp_mu": batch["logp"], "rewards": rewards,
                        "dones": batch["dones"],
                        "final_obs": batch["final_obs"]}, self.device)
        loss, metrics = self._impala_loss(tb)
        self._apply(loss)
        metrics["total_loss"] = loss
        out: Dict[str, Any] = floats(metrics)
        out["num_samples"] = float(np.asarray(rewards).size)
        out["episode_returns"] = episode_returns
        return out


class AggregatorActor:
    """Stateless batch concatenator between env-runners and the learner
    (reference: impala.py:768 AggregatorActor — moves the concat cost OFF
    the learner and the training loop; made an actor by the runtime)."""

    def aggregate(self, *samples) -> Dict[str, Any]:
        episode_returns: List[float] = []
        for s in samples:
            episode_returns.extend(s.get("episode_returns", []))
        keys = ("obs", "actions", "logp", "rewards", "trunc_bonus",
                "dones")
        out = {k: np.concatenate([s[k] for s in samples], axis=1)
               for k in keys}                      # [T, sum(B), ...]
        out["final_obs"] = np.concatenate(
            [s["final_obs"] for s in samples], axis=0)
        out["episode_returns"] = episode_returns
        return out


class IMPALA(Algorithm):
    """Async training_step: every runner keeps one rollout in flight;
    ready rollouts flow through an aggregator to the learner while the
    rest keep sampling (reference: impala.py async update loops). Under
    ``LocalRuntime`` a rollout is sampled when it is launched, so each
    update trains on rollouts of the previous iteration's weights."""

    learner_class = ImpalaLearner

    def __init__(self, config: "IMPALAConfig", runtime=None):
        super().__init__(config, runtime)
        n_agg = config.train_config.get("num_aggregator_actors", 1)
        self.aggregators = [self._rt.remote(AggregatorActor, num_cpus=0)()
                            for _ in range(n_agg)]
        self._agg_rr = 0
        self._inflight: Dict[Any, Any] = {}   # sample ref -> runner
        self._weights_ref = None

    def _launch(self, runner) -> None:
        ref = runner.sample.remote(self._weights_ref,
                                   self.config.rollout_fragment_length)
        self._inflight[ref] = runner

    def training_step(self) -> Dict[str, Any]:
        self._weights_ref = self._rt.put(self.learner_group.get_weights())
        if not self._inflight:
            for r in self.env_runner_group.runners:
                self._launch(r)
        t0 = time.monotonic()
        # Take whatever is ready (at least one rollout), leave the rest
        # in flight — the async core of IMPALA.
        ready, _ = self._rt.wait(list(self._inflight),
                                 num_returns=1, timeout=300)
        if not ready:
            raise RuntimeError(
                "IMPALA: no env-runner produced a rollout within 300s "
                f"({len(self._inflight)} in flight) — runners are stalled "
                "or starved of resources")
        pending = [r for r in self._inflight if r not in ready]
        extra, _ = self._rt.wait(pending, num_returns=len(pending),
                                 timeout=0)
        ready += extra
        runners = [self._inflight.pop(ref) for ref in ready]
        sample_s = time.monotonic() - t0

        agg = self.aggregators[self._agg_rr % len(self.aggregators)]
        self._agg_rr += 1
        batch_ref = agg.aggregate.remote(*ready)
        # Relaunch sampling immediately with the freshest weights: the
        # learner update below overlaps with the next rollouts.
        for r in runners:
            self._launch(r)

        if self.learner_group.is_remote:
            metrics = self._rt.get(
                self.learner_group.learner.update.remote(batch_ref),
                timeout=600)
        else:
            metrics = self.learner_group.update(self._rt.get(batch_ref))
        self._episode_returns.extend(metrics.pop("episode_returns", []))
        metrics["sample_time_s"] = sample_s
        metrics["num_rollouts"] = float(len(ready))
        return metrics

    def stop(self):
        super().stop()
        for a in self.aggregators:
            self._rt.kill(a)


class IMPALAConfig(AlgorithmConfig):
    algo_class = IMPALA

    def __init__(self):
        super().__init__()
        self.lr = 6e-4
        self.train_config.update({
            "vf_loss_coeff": 0.5,
            "entropy_coeff": 0.01,
            "vtrace_clip_rho_threshold": 1.0,
            "vtrace_clip_c_threshold": 1.0,
            "num_aggregator_actors": 1,
            "grad_clip": 40.0,
        })

    def training(self, *, vf_loss_coeff: Optional[float] = None,
                 entropy_coeff: Optional[float] = None,
                 vtrace_clip_rho_threshold: Optional[float] = None,
                 num_aggregator_actors: Optional[int] = None,
                 **kwargs) -> "IMPALAConfig":
        for k, v in (("vf_loss_coeff", vf_loss_coeff),
                     ("entropy_coeff", entropy_coeff),
                     ("vtrace_clip_rho_threshold",
                      vtrace_clip_rho_threshold),
                     ("num_aggregator_actors", num_aggregator_actors)):
            if v is not None:
                self.train_config[k] = v
        super().training(**kwargs)
        return self

