"""PPO: Proximal Policy Optimization. Port of ray_tpu/rllib/ppo.py.

Reference surface: python/ray/rllib/algorithms/ppo/ppo.py (PPOConfig /
PPO). The loss lives in learner.py (clipped surrogate + value + entropy);
this module binds the config defaults that make it PPO.
"""

from __future__ import annotations

from typing import Optional

from .algorithm import Algorithm, AlgorithmConfig


class PPO(Algorithm):
    pass


class PPOConfig(AlgorithmConfig):
    algo_class = PPO

    def __init__(self):
        super().__init__()
        self.train_config.update({
            "clip_param": 0.2,
            "vf_loss_coeff": 0.5,
            "entropy_coeff": 0.0,
            "num_epochs": 6,
            "minibatch_size": 256,
            "lambda_": 0.95,
            "grad_clip": 0.5,
        })

    def training(self, *, clip_param: Optional[float] = None,
                 vf_loss_coeff: Optional[float] = None,
                 entropy_coeff: Optional[float] = None,
                 num_epochs: Optional[int] = None,
                 minibatch_size: Optional[int] = None,
                 lambda_: Optional[float] = None,
                 **kwargs) -> "PPOConfig":
        for k, v in (("clip_param", clip_param),
                     ("vf_loss_coeff", vf_loss_coeff),
                     ("entropy_coeff", entropy_coeff),
                     ("num_epochs", num_epochs),
                     ("minibatch_size", minibatch_size),
                     ("lambda_", lambda_)):
            if v is not None:
                self.train_config[k] = v
        super().training(**kwargs)
        return self
