"""APPO: asynchronous PPO — the IMPALA architecture with a clipped
surrogate loss on V-trace advantages. Port of ray_tpu/rllib/appo.py.

Reference surface: python/ray/rllib/algorithms/appo/appo.py (APPO extends
IMPALA: same async env-runner/aggregator plumbing, PPO-clip loss over
V-trace-corrected targets, plus a target network updated periodically for
the KL/clip baseline).
"""

from __future__ import annotations

from typing import Optional

import torch

from .impala import IMPALA, IMPALAConfig, ImpalaLearner


class AppoLearner(ImpalaLearner):
    """V-trace targets + PPO clipped surrogate: only the policy-gradient
    term differs from IMPALA (reference: appo_learner.py — the decoupled
    clip on the behavior-policy importance ratio)."""

    def _pg_loss(self, rhos, pg_adv, logp):
        clip = self.cfg.get("clip_param", 0.2)
        return -torch.minimum(
            rhos * pg_adv,
            torch.clamp(rhos, 1.0 - clip, 1.0 + clip) * pg_adv).mean()


class APPO(IMPALA):
    learner_class = AppoLearner


class APPOConfig(IMPALAConfig):
    algo_class = APPO

    def __init__(self):
        super().__init__()
        self.lr = 3e-4
        self.train_config.update({"clip_param": 0.2})

    def training(self, *, clip_param: Optional[float] = None,
                 **kwargs) -> "APPOConfig":
        if clip_param is not None:
            self.train_config["clip_param"] = clip_param
        super().training(**kwargs)
        return self
